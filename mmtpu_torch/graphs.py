"""CUDA graphs for the port's one-program units: the counterpart of mmtpu's
``jit`` around a scan body.

mmtpu compiles a whole fit into one device program (``train/latents.py``,
``train/e2e.py``) and serving into one program per ladder size
(``serve.py``).  The port sends each small op from Python, so on the card
the host sets the pace.  Here each unit that mmtpu compiles (one epoch of a
fit, one request of a ladder size) is captured once as a CUDA graph and
replayed: one launch from the host per epoch or per request.

:class:`Graphs` holds captured bodies: those of one fit or server, or,
as a store that a caller makes and passes to several fits, those of every
fit run through it (the sweep keeps one per bucket, so that each chunk of
a bucket replays what its first chunk captured, as mmtpu reuses one
compiled program per bucket):

- A body is a function of tensors (and hashable Python values) that reads
  nothing back to the host and writes none of its arguments in place but
  the carry.  Every tensor it reads is an argument; it closes over Python
  values only, and the key names them (a fit's key holds its spec).  The
  cache key is the caller's key plus every argument's structure, tensor
  shapes, dtypes and devices and Python values: a Python ``active`` flag
  or a ladder size picks its own graph.
- The first call of a key runs the body eagerly on a side stream (the
  warm-up that capture needs: lazy initialisation, cuBLAS handles, the
  kernels' occupancy queries and ticket buffers, autograd's streams).  The
  second call copies its arguments into static buffers, captures the body
  on that stream and replays it; later calls copy their arguments in and
  replay.  A key called once is never captured.  An argument passed again
  as the same tensor, unchanged since it was copied in (its version
  counter), is not copied again: a fit's data costs one copy per fit, and
  data uploaded once per sweep none after the first.  A replay's writes do
  not move a version counter, so a tensor that a replay of the store
  writes (a carry buffer, an output) is always copied, and a tensor that
  a graph of another store writes is passed to this one only as a carry.
- With ``carry=True`` the first argument is the carry: the body returns
  ``(carry, out)``, and the graph copies the new carry into the static
  carry buffers, so that a loop passing the returned carry back in copies
  nothing; ``out`` comes back as a copy.  The next call of the key with
  another carry overwrites those buffers, so a fit on a shared store
  returns copies of its final carry (:func:`fit_result`).  Without a carry
  the outputs that a replay returns are the graph's own: the next replay
  of the key overwrites them.
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
:func:`fit_graphs` applies it to a fit, whose ``graphs`` may also be a
caller's store.
"""

from __future__ import annotations

import time
import traceback
import weakref

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


def _run_eagerly(key, body, *args, carry: bool = False):
    """``body(*args)``: what a fit runs where its store does not capture it."""
    return body(*args)


def fit_graphs(graphs, device, shard, epochs: int):
    """The runner of a fit's epochs (``run(key, body, *args, carry=...)``)
    for a fit of ``epochs`` epochs on ``device``.  ``graphs`` True or False
    gives the fit a :class:`Graphs` of its own, enabled where
    :func:`use_graphs` says so; a caller's :class:`Graphs` store is shared
    with every other fit run through it, and captures this fit where it is
    enabled and the fit runs :data:`MIN_EPOCHS` epochs or more (else the
    fit runs eagerly).  A batch-sharded fit (``shard``) runs eagerly: its
    steps hold collectives, and capturing them waits for NCCL capture and a
    four-card measurement."""
    if isinstance(graphs, bool):
        return Graphs(device, shard is None and use_graphs(graphs, device, epochs))
    if shard is None and graphs.enabled and epochs >= MIN_EPOCHS:
        return graphs
    return _run_eagerly


def fit_result(run, graphs, tree):
    """``tree``, read from a fit's final carry, as the fit returns it: where
    the fit ran on the caller's store ``graphs`` (``run is graphs``), one
    device-side clone per tensor, queued on the stream, since the next fit
    of the same key overwrites the static buffers that hold the carry."""
    if run is not graphs:
        return tree
    leaves: list = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([t.clone() for t in leaves]))


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
    def __init__(self, graph, static: list, outputs, launches: list, leaves: list,
                 n_carry: int):
        self.graph, self.static, self.outputs, self.launches = graph, static, outputs, launches
        self.n_carry = n_carry
        # each argument's last source (a weak reference and its version), past the carry
        self.sources = [None] * n_carry + [(weakref.ref(t), t._version) for t in leaves[n_carry:]]

    def copy_in(self, leaves: list, written: set) -> None:
        """Copies each argument into its static buffer, but the buffer
        itself and an argument that is the tensor last copied in, unchanged
        since (its version counter, which a replay's writes do not move: the
        carry and a tensor in ``written``, the storages that the store's
        replays write, are always copied)."""
        for i, (dst, src) in enumerate(zip(self.static, leaves)):
            if dst is src:
                continue
            if i >= self.n_carry:
                last = self.sources[i]
                if (last[0]() is src and last[1] == src._version
                        and src.untyped_storage().data_ptr() not in written):
                    continue
                self.sources[i] = (weakref.ref(src), src._version)
            dst.copy_(src)


class Graphs:
    """The captured bodies of one owner, or of the fits a caller runs
    through it, on ``device``; ``enabled`` False (:func:`use_graphs`) runs
    every body directly.  ``capture_s``, ``warmups``, ``captures`` and
    ``replays`` count what its graphs cost and ran."""

    def __init__(self, device, enabled: bool):
        self.device = torch.device(device)
        if enabled and self.device.type == "cuda" and self.device.index is None:
            # "cuda" is the current card, where its tensors land
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.enabled = enabled
        self._seen: set = set()
        self._captured: dict = {}
        self._written: set = set()  # storages that replays write: carries and outputs
        self.capture_s, self.warmups, self.captures, self.replays = 0.0, 0, 0, 0

    def __call__(self, key, body, *args, carry: bool = False):
        """``body(*args)``, warmed up, captured or replayed for ``key``."""
        if not self.enabled:
            return body(*args)
        leaves: list = []
        full_key = (key, _flatten(args, leaves))
        entry = self._captured.get(full_key)
        if entry is None and full_key not in self._seen:
            self._seen.add(full_key)
            self.warmups += 1
            return self._on_side_stream(body, args)
        if entry is None:
            entry = self._captured[full_key] = self._capture(full_key, body, leaves, carry)
            written: list = []
            _flatten(entry.outputs[0] if carry else entry.outputs, written)
            self._written.update(t.untyped_storage().data_ptr() for t in written)
        else:
            entry.copy_in(leaves, self._written)
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
        return _Captured(graph, static, outputs, launches, leaves, len(carry_leaves))

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
