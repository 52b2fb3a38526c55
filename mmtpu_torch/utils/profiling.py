"""Profiling and step timing (port of :mod:`mmtpu.utils.profiling`).

The reference's only instrumentation is wall-clock deltas in its training
logs (``simplesif.py:64,144``) and the ``--time_test`` timing
(``simplesif.py:873-880``).  The port adds:

- :func:`trace`, a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) naming the host ops and, on
  the card, the device kernels (K1's and K2's among them);
- :class:`StepTimer`, steady-state step timing with warm-up calls left out;
  the card's queued work is waited for (``torch.cuda.synchronize()``)
  before a step's clock stops, in the ``with`` form and in ``time_fn``.
"""

from __future__ import annotations

import contextlib
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
