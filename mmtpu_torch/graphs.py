"""CUDA graphs for the port's one-program units: the counterpart of mmtpu's
``jit`` around a scan body.

mmtpu compiles a whole fit into one device program (``train/latents.py``,
``train/e2e.py``) and serving into one program per ladder size
(``serve.py``).  The port sends each small op from Python, so on the card
the host sets the pace.  Here each unit that mmtpu compiles (one epoch of a
fit, one request of a ladder size) is captured once as a CUDA graph and
replayed: one launch from the host per epoch or per request.

:class:`Graphs` holds the captured bodies of one owner (a fit, a server):

- A body is a function of tensors (and hashable Python values) that reads
  nothing back to the host; it closes over what stays fixed for its owner
  (the data, the vocabulary, the hyperparameters).  The cache key is the
  caller's key plus every argument's structure, tensor shapes, dtypes and
  devices and Python values: a Python ``active`` flag or a ladder size
  picks its own graph.
- The first call of a key runs the body eagerly on a side stream (the
  warm-up that capture needs: lazy initialisation, cuBLAS handles, the
  kernels' occupancy queries and ticket buffers, autograd's streams).  The
  second call copies its arguments into static buffers, captures the body
  on that stream and replays it; later calls copy their arguments in and
  replay.  A key called once is never captured.
- With ``carry=True`` the first argument is the carry: the body returns
  ``(carry, out)``, and the graph copies the new carry into the static
  carry buffers, so that a loop passing the returned carry back in copies
  nothing; ``out`` comes back as a copy.  Without a carry the outputs that
  a replay returns are the graph's own: the next replay of the key
  overwrites them.
- The kernels' launch counters count in Python, which does not run on
  replay.  Each kernel module registers its counter here
  (:func:`launch_counter`); the launches a capture records are taken off
  again and added on every replay, so the counters equal the kernels the
  card ran.
- A capture that fails raises :class:`GraphCaptureError`, naming the line
  that broke it.  Nothing falls back to eager.

:func:`use_graphs` resolves the one argument that picks the mode:
``graphs=True`` (the default) captures where the device is CUDA (a fit
only from :data:`MIN_EPOCHS` epochs, where the capture pays) and runs the
bodies eagerly on the CPU; ``False`` runs them eagerly on the card as well.
"""

from __future__ import annotations

import time
import traceback

import torch

_SIDE_STREAMS: dict = {}
_COUNTERS: list = []


def launch_counter(counts: dict) -> dict:
    """Registers ``counts`` (name -> launches, added to in Python where a
    kernel module's wrapper launches its kernel) and returns it; each
    replay adds the launches its capture recorded."""
    _COUNTERS.append(counts)
    return counts


# the fewest epochs for which a fit is captured; a shorter fit runs eagerly on
# the card as well.  A captured fit's first epoch runs eagerly (the warm-up)
# and its second pays the capture, which a short fit does not earn back: the
# sweep chunk's inference fits (one or two steps per epoch for 32 configs,
# where a replay saves about half of an eager epoch) earn it back slowest.
# chip_smoke.py phase 20 measures them eager against captured on either side;
# their break-even moves between runs, and 20 stays above it with a margin.
MIN_EPOCHS = 20


def use_graphs(graphs: bool, device, epochs: int | None = None) -> bool:
    """Whether a unit on ``device`` runs as CUDA graph replays: ``graphs``,
    a CUDA device and, for a fit of ``epochs`` epochs, at least
    :data:`MIN_EPOCHS` of them."""
    return (bool(graphs) and torch.device(device).type == "cuda"
            and (epochs is None or epochs >= MIN_EPOCHS))


class GraphCaptureError(RuntimeError):
    """A body could not be captured as a CUDA graph."""


def side_stream(device: torch.device):
    """The stream that warms up and captures every body on ``device``: K1's
    and K2's ticket buffers are kept per stream, so one stream keeps them
    allocated and zeroed before any capture reads them."""
    s = _SIDE_STREAMS.get(device.index)
    if s is None:
        s = _SIDE_STREAMS[device.index] = torch.cuda.Stream(device)
    return s


def _flatten(tree, leaves: list):
    """A hashable description of ``tree`` with its tensors appended to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("T", tuple(tree.shape), tree.dtype, str(tree.device))
    if isinstance(tree, dict):
        return ("D", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("N", type(tree), tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return ("L" if isinstance(tree, list) else "U", tuple(_flatten(v, leaves) for v in tree))
    hash(tree)  # a Python value is part of the key
    return ("V", tree)


def _unflatten(spec, it):
    tag, body = spec[0], spec[1:]
    if tag == "T":
        return next(it)
    if tag == "D":
        return {k: _unflatten(v, it) for k, v in body[0]}
    if tag == "N":
        return body[0](*(_unflatten(v, it) for v in body[1]))
    if tag in ("L", "U"):
        out = [_unflatten(v, it) for v in body[0]]
        return out if tag == "L" else tuple(out)
    return body[0]


def _where(exc: BaseException) -> str:
    """The innermost frame of ``exc``'s traceback outside torch and this
    module (the body's line that broke the capture), as file:line."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename != __file__ and "/torch/" not in f.filename]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


class _Captured:
    def __init__(self, graph, static: list, outputs, launches: list):
        self.graph, self.static, self.outputs, self.launches = graph, static, outputs, launches


class Graphs:
    """The captured bodies of one owner on ``device``; ``enabled`` False
    (:func:`use_graphs`) runs every body directly.  ``capture_s``,
    ``captures`` and ``replays`` count what the owner's graphs cost and ran."""

    def __init__(self, device, enabled: bool):
        self.device = torch.device(device)
        self.enabled = enabled
        self._seen: set = set()
        self._captured: dict = {}
        self.capture_s, self.captures, self.replays = 0.0, 0, 0

    def __call__(self, key, body, *args, carry: bool = False):
        """``body(*args)``, warmed up, captured or replayed for ``key``."""
        if not self.enabled:
            return body(*args)
        leaves: list = []
        full_key = (key, _flatten(args, leaves))
        entry = self._captured.get(full_key)
        if entry is None and full_key not in self._seen:
            self._seen.add(full_key)
            return self._on_side_stream(body, args)
        if entry is None:
            entry = self._captured[full_key] = self._capture(full_key, body, leaves, carry)
        else:
            for dst, src in zip(entry.static, leaves):
                if dst is not src:
                    dst.copy_(src)
        entry.graph.replay()
        self.replays += 1
        for counter, delta in zip(_COUNTERS, entry.launches):
            for k, n in delta.items():
                counter[k] += n
        if not carry:
            return entry.outputs
        new_carry, rest = entry.outputs
        out: list = []
        return new_carry, _unflatten(_flatten(rest, out), iter([t.clone() for t in out]))

    def _on_side_stream(self, fn, args):
        cur, side = torch.cuda.current_stream(self.device), side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args)
        cur.wait_stream(side)
        return out

    def _capture(self, full_key, body, leaves: list, carry: bool) -> _Captured:
        t0 = time.perf_counter()
        static = [t.clone() for t in leaves]
        static_args = _unflatten(full_key[1], iter(static))
        carry_leaves: list = []
        if carry:
            _flatten(static_args[0], carry_leaves)
        storages = {t.untyped_storage().data_ptr() for t in static}

        def captured():
            out = body(*static_args)
            if not carry:
                return out
            new_carry, rest = out
            new_leaves: list = []
            if _flatten(new_carry, new_leaves) != _flatten(static_args[0], []):
                raise GraphCaptureError(f"{full_key[0]!r}: the body's carry changed "
                                        "structure, shape or dtype")
            # a new leaf that aliases another static buffer is read before any is written
            srcs = [src if src is dst or src.untyped_storage().data_ptr() not in storages
                    else src.clone() for dst, src in zip(carry_leaves, new_leaves)]
            for dst, src in zip(carry_leaves, srcs):
                if src is not dst:
                    dst.copy_(src)
            return static_args[0], rest

        before = [dict(c) for c in _COUNTERS]
        first: list = []

        def traced():
            try:
                return captured()
            except BaseException as exc:
                first.append(exc)
                raise

        try:
            graph, outputs = self._record(traced)
        except Exception as exc:
            cause = first[0] if first else exc
            raise GraphCaptureError(
                f"capturing {full_key[0]!r} failed at {_where(cause)}: "
                f"{type(cause).__name__}: {cause}") from cause
        finally:
            after = [dict(c) for c in _COUNTERS]
            for counter, b in zip(_COUNTERS, before):
                counter.update(b)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        launches = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
        return _Captured(graph, static, outputs, launches)

    def _record(self, fn) -> tuple:
        """``(graph, outputs)``: ``fn`` captured on the side stream; the
        graph's replay recomputes ``outputs`` in place."""
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        try:
            with torch.cuda.graph(graph, stream=side_stream(self.device)):
                outputs = fn()
        finally:  # a capture_end that raises leaves the capture stream current
            torch.cuda.set_stream(cur)
        return graph, outputs
