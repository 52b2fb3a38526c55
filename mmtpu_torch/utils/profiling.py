"""Profiling and step timing (port of :mod:`mmtpu.utils.profiling`).

The reference's only instrumentation is wall-clock deltas in its training
logs (``simplesif.py:64,144``) and the ``--time_test`` timing
(``simplesif.py:873-880``).  The port adds:

- :func:`trace`, a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) naming the host ops and, on
  the card, the device kernels (K1's and K2's among them);
- :func:`region`, a named host range of the program (``mmtpu.<layer>.<what>``)
  in the trace of an active profiler session, and nothing without one
  (:func:`in_region`: a function's whole call as such a range); the parts
  of a fit's training step are the ranges :data:`STEP` names;
- :class:`StepTimer`, steady-state step timing with warm-up calls left out;
  the card's queued work is waited for (``torch.cuda.synchronize()``)
  before a step's clock stops, in the ``with`` form and in ``time_fn``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import List

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def trace(log_dir: str = "mmtpu_torch_trace"):
    """Profile the block under ``torch.profiler`` (the CPU, and CUDA where a
    card is present) and write ``<log_dir>/trace[_rank<r>].json``, one file
    per rank of a process group.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    suffix = f"_rank{dist.get_rank()}" if dist.is_initialized() else ""
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace{suffix}.json"))


# a function-scope range: a user range (``torch.profiler.record_function``)
# also puts a span on the device's rows over the kernels launched inside it,
# which a reader of the trace would count as device work
_Range = torch._C._profiler._RecordFunctionFast


def region(name: str):
    """A host range ``name`` in the trace of an active ``torch.profiler``
    session, on the profiler's clock (so that the device's idle gaps can be
    placed in a phase of the program); without a session, a no-op that
    costs one check."""
    if torch.autograd._profiler_enabled():
        return _Range(name)
    return contextlib.nullcontext()


# the parts of a training step of the fits (train/latents.py, train/e2e.py,
# train/fused.py), each the region "mmtpu.step.<part>" around the code that
# computes it; no two nest.  gather: the batch's rows of the data, labels
# and mask, and the leaves the backward differentiates; decoder: the norm
# and the heads' linears; heads: the Gaussian log-probabilities and the
# weighted joint; word: the word likelihood (K1, the per-token term); senti:
# the e2e sentiment error; loss: the per-sample weighting and the batch
# mean; backward: torch.autograd.grad (the operations it runs are tied to
# the parts of their forward operations by sequence number); optimizer: the
# decoder's and the sentiment head's updates (K2 in the fused step) and the
# embedding table's (lazy Adam's catch-up and touch); epoch: the table's
# permutation in and out, and lazy Adam's coefficients and epilogue
STEP_PARTS = ("gather", "decoder", "heads", "word", "senti", "loss", "backward", "optimizer",
              "epoch")
STEP = {part: f"mmtpu.step.{part}" for part in STEP_PARTS}


def in_region(name: str):
    """Decorator: each call of the function is the :func:`region` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with region(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _wait(out) -> None:
    """Wait for every tensor of ``out`` (nested dicts, lists, tuples)."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            _wait(o)
    elif isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


class StepTimer:
    """Accumulates per-step wall times and reports steady-state statistics."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)
        return False

    def time_fn(self, fn, *args, iters: int = 5):
        """Run ``fn(*args)`` ``warmup + iters`` times, waiting for the
        output each time; the warm-up calls are not recorded.  Returns the
        last call's result."""
        out = None
        for i in range(self.warmup + iters):
            t0 = time.perf_counter()
            out = fn(*args)
            _wait(out)
            if i >= self.warmup:
                self.times.append(time.perf_counter() - t0)
        return out

    @property
    def steady(self) -> List[float]:
        """The recorded times less the first ``warmup`` of a ``with`` block's
        (``time_fn`` records none of its warm-up calls)."""
        return self.times[self.warmup:] if self._t0 is not None else self.times

    def summary(self) -> dict:
        arr = np.asarray(self.steady or self.times)
        if arr.size == 0:
            return {}
        return {"mean_s": float(arr.mean()), "median_s": float(np.median(arr)),
                "min_s": float(arr.min()), "max_s": float(arr.max()), "n": int(arr.size)}
