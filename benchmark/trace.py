"""The traced piece: one profiler session over a piece of the cell's work,
read in one pass into what the per-layer readers need.

A process's second ``torch.profiler`` session records no device event on
the card, so a run profiles once.  The harness's spans (``span:<name>``,
``torch.profiler.record_function`` around the calls into the program's
layers) place the device's work: a graph replay's kernels belong to the
span in which the host launched the replay (``cudaGraphLaunch``, matched
by correlation id), since the device clock's offset can move a kernel
across a span's edge.

The trace is never written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

SPAN = "span:"
K1_FWD = ("angular_fwd_kernel",)
K1_BWD = ("angular_bwd_kernel", "angular_bwd_reduce")


@contextlib.contextmanager
def span(name: str):
    """A host span of the harness (a no-op outside a profiler session)."""
    with torch.profiler.record_function(SPAN + name):
        yield


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host: list, starts: list, t: int, limit: int = 20000):
    """The name of the latest-starting host event that holds time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - limit, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host: between ops"


def profile(fn: Callable[[], object], top: int = 10) -> Dict:
    """Run ``fn`` under the profiler and read the trace: the device's busy
    seconds (the union of its kernels, copies and sets), the traced wall,
    the device time and count of K1's kernels, the kernels launched by the
    graph replays inside each span, the top device operations and the
    longest idle gaps by what the host was doing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, host, device = {}, [], []
    graph_launch = {}
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN):
                device.append((start, end, name, ev.correlation_id()))
            continue
        if name.startswith(SPAN):
            spans.setdefault(name[len(SPAN):], []).append((start, end))
        elif name.startswith("cudaGraphLaunch"):
            graph_launch[ev.correlation_id()] = start
        host.append((start, end, name))
    host.sort()
    starts = [h[0] for h in host]

    per_op = defaultdict(float)
    k1 = {"fwd_s": 0.0, "fwd_n": 0, "bwd_s": 0.0, "bwd_n": 0}
    in_graph = defaultdict(int)  # span -> kernels launched by its graph replays
    span_of = {}
    for name, ranges in spans.items():
        for a, b in ranges:
            for c, t in graph_launch.items():
                if a <= t <= b:
                    span_of[c] = name
    replays = defaultdict(int)
    for c, name in span_of.items():
        replays[name] += 1
    for s, e, name, corr in device:
        secs = (e - s) / 1e9
        per_op[name] += secs
        if any(k in name for k in K1_FWD):
            k1["fwd_s"] += secs
            k1["fwd_n"] += 1
        elif any(k in name for k in K1_BWD):
            k1["bwd_s"] += secs
            k1["bwd_n"] += "angular_bwd_kernel" in name
        if corr in span_of and not name.startswith(("Memcpy", "Memset")):
            in_graph[span_of[corr]] += 1

    busy = _union([(s, e) for s, e, _, _ in device])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    by_host = defaultdict(float)
    for length, a, b in gaps[:2000]:
        by_host[_innermost(host, starts, (a + b) // 2)] += length / 1e9
    return {
        "wall_s": wall,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "k1": k1,
        "graph_kernels": dict(in_graph),
        "graph_replays": dict(replays),
        "device_ops": sorted(([n[:200], s] for n, s in per_op.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n[:200], s] for n, s in by_host.items()),
                            key=lambda x: -x[1])[:top],
    }
