"""A captured step's split by part: each kernel that a CUDA graph replay ran,
tied to the part of the fit's step whose range held its launch when the
graph was captured, read from one profiler session.

The program enters a range ``mmtpu.step.<part>`` around each part of a
training step (``mmtpu_torch/utils/profiling.py::STEP``).  A replay runs no
Python, so its kernels come with no range; but the capture of its graph
ran the body on the host, launch by launch in the order of the graph's
nodes, inside those ranges.  So, for each capture (``mmtpu.graphs.capture``)
in a harness span (``span:<name>``, ``benchmark/trace.py``):

1. its launches: the host's launch calls (every ``cu*Launch*Kernel*``,
   ``*Memcpy*`` and ``*Memset*`` call) inside the capture that put no row
   on the device (the eager calls around the capture did);
2. each launch's part: the innermost step range around the host operation
   that made the call (the profiler links the two), on that operation's
   thread; a call inside an autograd node (``autograd::engine::evaluate_function``,
   on the engine's thread on the card) takes the part of the forward
   operation that made the node: the last operation that recorded the node's
   sequence number on the forward thread (an operation records the number
   that the next node will take);
3. each replay (a ``cudaGraphLaunch`` after the capture, its rows matched by
   correlation id) maps its k-th row, by device start, to the k-th launch.

A replay is split only where its rows stand one for one with the capture's
launches (as many, each copy row where a copy was launched) and its
kernels are those that most replays of its graph ran; the profiler now and
then records a row out of place, and such a replay is left out.  Where half
of a graph's replays or more are left out, or fewer than 99 % of the
kernels' names agree, in order, with the warm-up's (``mmtpu.graphs.warmup``,
the key's first call, run eagerly, whose first K1 call zeroes its ticket
buffer: one kernel more), counted against the longer of the two, the
span's split is ``None``: never a guess.

``python3 benchmark/step_split.py --workload <cell> --seed <n>`` runs the
cell's traced piece (``benchmark/drivers/grid_sweep.py``: one chunk at the
piece's epochs, inside the harness's spans) under one profiler session and
prints the split and each part's device ms per train step.
"""

from __future__ import annotations

import bisect
import re
from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Optional

PREFIX = "mmtpu.step."
CAPTURE, WARMUP = "mmtpu.graphs.capture", "mmtpu.graphs.warmup"
EVALUATE = "autograd::engine::evaluate_function: "
SPAN = "span:"
SPANS = ("sweep.train", "sweep.infer")
CALL = re.compile(r"cu(da)?[A-Z]")  # a CUDA runtime or driver call, by its API's name
LAUNCH = re.compile(r"Launch\w*Kernel|Memcpy|Memset")
COPY = ("Memcpy", "Memset")  # device rows that are no kernel (benchmark/trace.py's rule)
UNATTRIBUTED = "unattributed"
# the word term's hand kernels (K1 and the per-token term's), by name
WORD_KERNELS = ("angular_fwd_kernel", "angular_bwd_kernel", "angular_bwd_reduce",
                "token_dots_fwd_kernel", "token_dots_bwd_kernel")
AGREE = 0.99

# the per-layer readings: device ms per train step of these parts (None: of
# every other part, the unattributed kernels included)
METRICS = {"step.decoder_ms": ("decoder",), "step.heads_ms": ("heads",),
           "step.word_ms": ("word",), "step.optimizer_ms": ("optimizer",),
           "step.rest_ms": None}


class Event(NamedTuple):
    """One event of the trace.  ``kind``: ``"op"`` (a host operation or
    range), ``"call"`` (a CUDA runtime or driver call) or ``"row"`` (a
    kernel, copy or set on the device).  ``corr``: an op's id; a call's and
    a row's correlation id (a replay's rows carry its ``cudaGraphLaunch``'s).
    ``link``: a call's op (0: none).  ``thread``, ``seq`` and ``fwd_thread``:
    an op's thread, autograd sequence number (-1: none) and, for an autograd
    node, the thread of its forward operation."""

    name: str
    kind: str
    start: int
    end: int
    corr: int
    link: int = 0
    thread: int = 0
    seq: int = -1
    fwd_thread: int = 0


def events_of(prof) -> List[Event]:
    """The events of a finished ``torch.profiler`` session."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN):
                out.append(Event(name, "row", start, end, ev.correlation_id()))
        elif CALL.match(name):
            out.append(Event(name, "call", start, end, ev.correlation_id(),
                             ev.linked_correlation_id()))
        else:
            out.append(Event(name, "op", start, end, ev.correlation_id(), 0,
                             ev.start_thread_id(), ev.sequence_nr(), ev.fwd_thread_id()))
    return out


class _Markers:
    """The step ranges and autograd nodes of each thread (ranges of one
    thread nest), for the innermost one around a time."""

    def __init__(self):
        self.by_thread: Dict[int, list] = defaultdict(list)

    def add(self, e: Event, what) -> None:
        self.by_thread[e.thread].append((e.start, e.end, what))

    def done(self) -> None:
        self.starts, self.parent = {}, {}
        for th, marks in self.by_thread.items():
            marks.sort(key=lambda m: m[0])
            self.starts[th] = [m[0] for m in marks]
            parent, open_ = [], []
            for i, (s, _, _) in enumerate(marks):
                while open_ and marks[open_[-1]][1] < s:
                    open_.pop()
                parent.append(open_[-1] if open_ else -1)
                open_.append(i)
            self.parent[th] = parent

    def innermost(self, t: int, thread: int):
        """What the innermost marker around time ``t`` on ``thread`` marks,
        or None: the latest to start before ``t``, or the nearest of the
        markers around that one that still holds ``t``."""
        marks, parent = self.by_thread.get(thread, []), self.parent.get(thread, [])
        j = bisect.bisect_right(self.starts.get(thread, []), t) - 1
        while j >= 0 and marks[j][1] < t:
            j = parent[j]
        return marks[j][2] if j >= 0 else None


def _within(ranges: list, t: int) -> bool:
    return any(a <= t <= b for a, b in ranges)


def _is_copy(name: str) -> bool:
    return name.startswith(COPY)


def step_split(events: List[Event], spans=SPANS) -> Dict[str, Optional[dict]]:
    """The split of each harness span's replays: per part ``{"s",
    "kernels", "names"}`` (kernel seconds and count over the replays split,
    and per kernel name ``[kernels, s]``), with ``"unattributed"`` for
    kernels whose launch no part held; ``replays`` (those split),
    ``left_out`` (those whose rows could not be tied), ``kernels``, ``s``, ``copies``
    (the rows that are no kernel: ``{"n", "s"}``), ``unattributed_pct`` (of
    the kernel seconds), ``gap_s`` (each replay's first-to-last span less
    the union of its rows, summed) and ``agree_pct`` (the replays' kernel
    names against the warm-ups', the least).  A span whose replays cannot be
    tied is ``None``; one without replays is absent."""
    ops, calls, rows = {}, [], defaultdict(list)
    spans_at = defaultdict(list)
    graphs = {CAPTURE: [], WARMUP: []}
    markers, forward = _Markers(), {}
    for e in events:
        if e.kind == "row":
            rows[e.corr].append(e)
        elif e.kind == "call":
            calls.append(e)
        else:
            ops[e.corr] = e
            if e.name.startswith(PREFIX):
                markers.add(e, e.name[len(PREFIX):])
            elif e.name.startswith(EVALUATE):
                markers.add(e, (e.fwd_thread, e.seq))
            elif e.name in graphs:
                graphs[e.name].append((e.start, e.end))
            elif e.name.startswith(SPAN):
                spans_at[e.name[len(SPAN):]].append((e.start, e.end))
    markers.done()
    for e in sorted(ops.values(), key=lambda e: e.start):
        if e.seq >= 0 and not e.name.startswith((PREFIX, EVALUATE)):
            inner = markers.innermost(e.start, e.thread)
            if not isinstance(inner, tuple):  # a forward op
                forward[(e.thread, e.seq)] = inner
    calls.sort(key=lambda c: c.start)

    def time_of(c: Event) -> int:
        """A call's time on the clock of the host's ranges: its op's start."""
        op = ops.get(c.link)
        return c.start if op is None else op.start

    def part_of(c: Event) -> str:
        op = ops.get(c.link)
        inner = None if op is None else markers.innermost(op.start, op.thread)
        if inner is None:
            return UNATTRIBUTED
        if isinstance(inner, str):
            return inner
        return forward.get(inner) or "backward"  # an autograd node

    out = {}
    for span in spans:
        where = spans_at.get(span, [])
        inside = lambda t: _within(where, t)  # noqa: E731
        captures = sorted(r for r in graphs[CAPTURE] if inside(r[0]))
        warmups = sorted(r for r in graphs[WARMUP] if inside(r[0]))
        replays = [c for c in calls if c.name.startswith("cudaGraphLaunch") and inside(c.start)]
        if not replays:
            continue
        out[span] = _split_span(captures, warmups, replays, calls, rows, time_of, part_of)
    return out


def _matched(a: list, b: list, skip: int = 8) -> int:
    """How many names of ``a`` agree in order with ``b``'s: a walk along both
    that, where they differ, steps over up to ``skip`` names of ``b`` to meet
    again (a warm-up's one-off kernels), else over one of each."""
    i = j = n = 0
    while i < len(a) and j < len(b):
        if a[i] == b[j]:
            i, j, n = i + 1, j + 1, n + 1
            continue
        k = next((k for k in range(1, skip + 1) if b[j + k:j + k + 1] == [a[i]]), None)
        i, j = (i, j + k) if k is not None else (i + 1, j + 1)
    return n


def _split_span(captures, warmups, replays, calls, rows, time_of, part_of) -> Optional[dict]:
    # per capture: its launches' parts and whether each is a copy, its
    # warm-up's kernel names, and its replays' rows in device order
    launches, copy_at, names, done = {}, {}, {}, defaultdict(list)
    for cap in captures:
        inside = [c for c in calls if LAUNCH.search(c.name) and not c.name.startswith(
            "cudaGraphLaunch") and cap[0] <= time_of(c) <= cap[1] and c.corr not in rows]
        launches[cap] = [part_of(c) for c in inside]
        copy_at[cap] = ["Memcpy" in c.name or "Memset" in c.name for c in inside]
        warm = [w for w in warmups if w[0] < cap[0]]
        if warm:
            w = warm[-1]
            eager = [c for c in calls if LAUNCH.search(c.name)
                     and w[0] <= time_of(c) <= w[1]]
            names[cap] = [r.name for c in eager for r in rows.get(c.corr, [])
                          if not _is_copy(r.name)]
    for g in replays:
        cap = max((c for c in captures if c[0] < g.start), default=None)
        if cap is None or cap not in names:
            return None
        done[cap].append(sorted(rows.get(g.corr, []), key=lambda r: r.start))
    parts: Dict[str, dict] = {}
    copies = {"n": 0, "s": 0.0}
    gap, agree, kept = 0.0, 1.0, 0
    for cap, runs in done.items():
        # a replay whose rows stand one for one with the capture's launches
        # (a copy where it launched a copy) and run the kernels that most
        # of its graph's replays ran; the profiler now and then records a
        # row out of place: that replay is left out, a graph whose replays
        # mostly fail gives no split
        fits = [r for r in runs if [_is_copy(x.name) for x in r] == copy_at[cap]]
        common = Counter(tuple(x.name for x in r) for r in fits).most_common(1)
        good = [r for r in fits if common and tuple(x.name for x in r) == common[0][0]]
        if 2 * len(good) <= len(runs):
            return None
        kernels = [n for n in common[0][0] if not _is_copy(n)]
        most = max(len(kernels), len(names[cap]))
        agree = min(agree, _matched(kernels, names[cap]) / most if most else 1.0)
        kept += len(good)
        for run in good:
            busy, last = 0, None
            for r in run:
                lo = r.start if last is None else max(r.start, last)
                busy += max(0, r.end - lo)
                last = r.end if last is None else max(last, r.end)
            if run:
                gap += (max(r.end for r in run) - run[0].start - busy) / 1e9
            for r, part in zip(run, launches[cap]):
                secs = (r.end - r.start) / 1e9
                if _is_copy(r.name):
                    copies["n"] += 1
                    copies["s"] += secs
                    continue
                p = parts.setdefault(part, {"s": 0.0, "kernels": 0, "names": {}})
                p["s"] += secs
                p["kernels"] += 1
                n = p["names"].setdefault(r.name, [0, 0.0])
                n[0] += 1
                n[1] += secs
    if agree < AGREE:
        return None
    total = sum(p["s"] for p in parts.values())
    return {"replays": kept, "left_out": len(replays) - kept, "parts": parts,
            "kernels": sum(p["kernels"] for p in parts.values()), "s": total,
            "copies": copies, "gap_s": gap, "agree_pct": 100.0 * agree,
            "unattributed_pct": (100.0 * parts.get(UNATTRIBUTED, {"s": 0.0})["s"] / total
                                 if total > 0 else 0.0)}


def part_ms(record: dict, metric: str) -> Optional[float]:
    """The reading of ``metric`` (a key of :data:`METRICS`): the parts'
    kernel seconds in the piece's ``sweep.train`` replays over those replays'
    steps (as ``step.kernels_per_train_step`` divides), in ms; None where the
    record has no split of that span."""
    split = (record.get("split") or {}).get("sweep.train")
    if not split:
        return None
    named = METRICS[metric]
    if named is None:
        taken = {p for ps in METRICS.values() if ps for p in ps}
        named = [p for p in split["parts"] if p not in taken]
    secs = sum(split["parts"][p]["s"] for p in named if p in split["parts"])
    return 1e3 * secs / (split["replays"] * record["piece"]["train_steps"])


def profile_piece(workload: str, seed: int, root: str):
    """The cell's set-up, then its traced piece (one chunk at the piece's
    epochs, inside the harness's spans) under one profiler session:
    ``(events, steps)``, ``steps`` the piece's train steps per epoch and
    its inference steps per pair of valid and test epochs."""
    import torch
    import mmtpu_torch.sweep.runner as runner
    from torch.profiler import ProfilerActivity, profile

    from benchmark.run import cell_spec, load_module

    spec = cell_spec(workload, root)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    drivers = load_module(spec["driver"], "benchmark_driver")
    driver = drivers.Driver(spec["config"], spec["traffic"], seed, "cuda")
    driver.setup()
    piece = driver.piece()
    build = runner.build_sweep_parts
    runner.build_sweep_parts = drivers._spanned_parts(build)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            driver._sweep(piece, call=drivers.PIECE_CALL)
            torch.cuda.synchronize()
    finally:
        runner.build_sweep_parts = build
    rows, bsz = driver.tokens(), spec["config"]["batch_size"]
    steps = {"sweep.train": -(-len(rows["train"]) // bsz),
             "sweep.infer": sum(-(-len(rows[s]) // (8 * bsz)) for s in ("valid", "test"))}
    return events_of(prof), steps


def graph_kernels(events: List[Event], span: str) -> int:
    """The kernels of the graph replays launched inside ``span``, counted as
    ``benchmark/trace.py`` counts them, apart from the split."""
    where = [(e.start, e.end) for e in events if e.kind == "op" and e.name == SPAN + span]
    launched = {e.corr for e in events if e.kind == "call" and e.name.startswith(
        "cudaGraphLaunch") and _within(where, e.start)}
    return sum(1 for e in events if e.kind == "row" and e.corr in launched
               and not _is_copy(e.name))


def summary(split: dict, steps: dict) -> dict:
    """Each span's split per step: ms and kernels of each part (its top
    kernels by name), the unattributed share, the gaps inside replays, and
    the word term's hand kernels that landed outside ``word``.  A
    train replay is an epoch of ``steps["sweep.train"]`` steps; inference
    replays come in pairs of a valid and a test epoch."""
    out = {}
    for span, s in split.items():
        if s is None:
            out[span] = None
            continue
        n = s["replays"] * steps[span] / (1 if span == "sweep.train" else 2)
        out[span] = {
            "replays": s["replays"], "left_out": s["left_out"], "steps": n,
            "kernels_per_step": s["kernels"] / n,
            "ms_per_step": 1e3 * s["s"] / n, "gap_ms_per_step": 1e3 * s["gap_s"] / n,
            "unattributed_pct": s["unattributed_pct"], "agree_pct": s["agree_pct"],
            "copies_per_step": s["copies"]["n"] / n,
            "word_kernels_elsewhere": sum(x[0] for p, v in s["parts"].items() if p != "word"
                                          for k, x in v["names"].items()
                                          if any(w in k for w in WORD_KERNELS)),
            "parts": {p: {"ms": 1e3 * v["s"] / n, "kernels": v["kernels"] / n,
                          "top": sorted(([k[:100], 1e3 * x[1] / n, x[0] / n]
                                         for k, x in v["names"].items()),
                                        key=lambda x: -x[1])[:6]}
                      for p, v in sorted(s["parts"].items(), key=lambda kv: -kv[1]["s"])}}
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--out", default="", help="also write the whole split (JSON) here")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("step_split: no CUDA device", file=sys.stderr)
        return 2
    events, steps = profile_piece(args.workload, args.seed, root)
    split = step_split(events)
    record = {"split": split, "piece": {"train_steps": steps["sweep.train"]}}
    train = split.get("sweep.train")
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "readings": {m: part_ms(record, m) for m in METRICS},
           "graph_kernels_train": graph_kernels(events, "sweep.train"),
           "split_kernels_train": None if train is None else train["kernels"],
           **summary(split, steps)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": out, "split": split}, f)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
