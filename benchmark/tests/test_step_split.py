"""A captured step's split (``benchmark/step_split.py``) on hand-made event
lists: a capture whose launches lie under the step's ranges, one made on
the autograd engine's thread inside a node tied by its sequence number, a
copy, a launch outside every range; three replays, one of which a
profiler may record with a row out of place (left out); and the cases that
give no split: replays whose rows are not as many as the capture's
launches, a copy row where the capture launched a kernel, and kernel names
that disagree with the warm-up's.  Then the per-step readings of each
part."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.step_split import (EVALUATE, METRICS, PREFIX, UNATTRIBUTED, Event,  # noqa: E402
                                  _matched, events_of, part_ms, step_split)

MAIN, ENGINE = 1, 2
# the body's kernels in the order of the graph's nodes, the copy apart
KERNELS = ["gemm_decoder", "angular_fwd_kernel", "angular_bwd_kernel", "adam_elementwise",
           "fill_unranged"]
# each replay's rows: (name, start, end) in ns after the replay's first row
REPLAY = [("gemm_decoder", 0, 10), ("angular_fwd_kernel", 12, 42),
          ("angular_bwd_kernel", 45, 105), ("adam_elementwise", 105, 110),
          ("Memcpy DtoD (Device -> Device)", 111, 113), ("fill_unranged", 120, 121)]


def op(name, start, end, corr, thread=MAIN, seq=-1, fwd_thread=0):
    return Event(name, "op", start, end, corr, 0, thread, seq, fwd_thread)


def call(name, start, corr, link=0):
    return Event(name, "call", start, start + 1, corr, link)


def row(name, start, end, corr):
    return Event(name, "row", start, end, corr)


def _events(warm_names=KERNELS, replays=(REPLAY,) * 3):
    ev = [op("span:sweep.train", 0, 10_000, 1)]
    # the warm-up: the same body run eagerly, each launch with its row
    ev.append(op("mmtpu.graphs.warmup", 100, 200, 2))
    for i, name in enumerate(warm_names):
        ev += [op("aten::op", 101 + 10 * i, 105 + 10 * i, 10 + i),
               call("cudaLaunchKernel", 102 + 10 * i, 100 + i, 10 + i),
               row(name, 150 + 10 * i, 155 + 10 * i, 100 + i)]
    ev += [call("cudaMemcpyAsync", 180, 110, 0), row("Memcpy DtoD (Device -> Device)", 181,
                                                     182, 110)]
    # the capture: an eager copy of an argument first (it has a row), then
    # the body, whose launches put no row on the device
    ev.append(op("mmtpu.graphs.capture", 300, 500, 3))
    ev += [op("aten::clone", 301, 303, 20), call("cudaMemcpyAsync", 302, 200, 20),
           row("Memcpy DtoD (Device -> Device)", 304, 305, 200)]
    ev += [op(PREFIX + "gather", 305, 309, 21),
           op("aten::detach", 306, 307, 22, seq=7),  # records the next node's number
           op(PREFIX + "decoder", 310, 320, 23),
           op("aten::mm", 311, 315, 24, seq=6), call("cuLaunchKernel", 312, 201, 24),
           op(PREFIX + "word", 321, 330, 25),
           op("AngularPartitionFn", 322, 326, 26, seq=7), call("cudaLaunchKernel", 323, 202, 26),
           op(PREFIX + "backward", 331, 360, 27),
           op(EVALUATE + "AngularPartitionFnBackward", 333, 340, 28, ENGINE, 7, MAIN),
           op("AngularPartitionFnBackward", 334, 339, 29, ENGINE, 7, MAIN),
           call("cudaLaunchKernel", 335, 203, 29),
           op(PREFIX + "optimizer", 361, 380, 30),
           op("aten::add_", 362, 363, 33), call("cudaLaunchKernel", 362, 204, 33),
           op("aten::copy_", 364, 366, 31), call("cudaMemcpyAsync", 365, 205, 31),
           op("aten::fill_", 385, 388, 32), call("cudaLaunchKernel", 386, 206, 32)]
    for k, rows in enumerate(replays):
        base, corr = 1_000 + 1_000 * k, 300 + k
        ev.append(call("cudaGraphLaunch", 600 + 100 * k, corr))
        ev += [row(name, base + a, base + b, corr) for name, a, b in rows]
    return ev


def test_replays_are_split_by_the_part_that_held_each_launch():
    split = step_split(_events())
    assert set(split) == {"sweep.train"}
    s = split["sweep.train"]
    assert s["replays"] == 3 and s["left_out"] == 0 and s["kernels"] == 15
    parts = {p: v["kernels"] for p, v in s["parts"].items()}
    assert parts == {"decoder": 3, "word": 6, "optimizer": 3, UNATTRIBUTED: 3}
    assert s["parts"]["word"]["names"] == {"angular_fwd_kernel": [3, pytest.approx(90e-9)],
                                           "angular_bwd_kernel": [3, pytest.approx(180e-9)]}
    assert s["parts"]["decoder"]["s"] == pytest.approx(30e-9)
    assert s["s"] == pytest.approx(3 * (10 + 30 + 60 + 5 + 1) * 1e-9)
    assert s["copies"] == {"n": 3, "s": pytest.approx(6e-9)}
    assert s["unattributed_pct"] == pytest.approx(100 / 106)
    # gaps inside a replay: 10-12, 42-45, 110-111, 113-120
    assert s["gap_s"] == pytest.approx(3 * 13e-9)
    assert s["agree_pct"] == 100.0


def test_a_node_that_no_forward_op_ties_stays_backward():
    ev = [e._replace(seq=8) if e.name == EVALUATE + "AngularPartitionFnBackward" else e
          for e in _events()]
    parts = step_split(ev)["sweep.train"]["parts"]
    assert parts["backward"]["names"] == {"angular_bwd_kernel": [3, pytest.approx(180e-9)]}


# a replay that runs its copy before the kernel that came before it; one
# whose first kernel's row came out of place, after the second
SWAPPED = REPLAY[:3] + [("Memcpy DtoD (Device -> Device)", 105, 107),
                        ("adam_elementwise", 108, 113)] + REPLAY[5:]
LATE = [("gemm_decoder", 43, 44)] + REPLAY[1:]


@pytest.mark.parametrize("bad", [REPLAY[:-1], SWAPPED, LATE],
                         ids=["rows_short", "copy_misplaced", "row_out_of_place"])
def test_a_replay_with_rows_out_of_place_is_left_out(bad):
    s = step_split(_events(replays=(REPLAY, bad, REPLAY)))["sweep.train"]
    assert (s["replays"], s["left_out"], s["kernels"]) == (2, 1, 10)
    assert s["parts"]["word"]["kernels"] == 4
    assert step_split(_events(replays=(REPLAY, bad, bad))) == {"sweep.train": None}


def test_no_split_where_the_names_disagree_with_the_warm_up():
    ev = _events(warm_names=KERNELS[:3] + ["other", "other"])  # 3 of 5 agree
    assert step_split(ev) == {"sweep.train": None}


def test_names_agree_past_a_warm_up_s_one_off_kernels():
    body = [f"k{i % 7}_{i}" for i in range(300)]
    warm = body[:40] + ["fill_tickets"] + body[40:]  # K1's first call zeroes its tickets
    assert _matched(body, warm) == 300
    assert _matched(body, body[:100] + ["x"] * 3 + body[103:]) == 297
    ev = _events(warm_names=["fill_tickets"] + KERNELS)
    assert step_split(ev) == {"sweep.train": None}  # 5 of 6 agree: too few


def test_part_readings_per_train_step():
    split = step_split(_events(replays=(REPLAY, LATE, REPLAY)))
    record = {"split": split, "piece": {"train_steps": 3}}
    ms = {m: part_ms(record, m) for m in METRICS}
    per_step = lambda s: 1e3 * s / (2 * 3)  # noqa: E731  (the two replays split)
    assert ms["step.word_ms"] == pytest.approx(per_step(180e-9))
    assert ms["step.decoder_ms"] == pytest.approx(per_step(20e-9))
    assert ms["step.heads_ms"] == 0.0
    assert ms["step.optimizer_ms"] == pytest.approx(per_step(10e-9))
    assert ms["step.rest_ms"] == pytest.approx(per_step(2e-9))
    assert sum(ms.values()) == pytest.approx(per_step(split["sweep.train"]["s"]))


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("record", [{"piece": {"train_steps": 3}},
                                    {"split": {}, "piece": {"train_steps": 3}},
                                    {"split": {"sweep.train": None},
                                     "piece": {"train_steps": 3}}],
                         ids=["no_split", "no_replays", "split_none"])
def test_part_readings_without_a_split_are_none(metric, record):
    assert part_ms(record, metric) is None


def test_parts_are_the_programs():
    from mmtpu_torch.utils.profiling import STEP, STEP_PARTS

    assert all(STEP[p] == PREFIX + p for p in STEP_PARTS)
    assert {p for ps in METRICS.values() if ps for p in ps} < set(STEP_PARTS)


def test_events_of_a_cpu_session():
    """The profiler's own events: ranges and operations on one thread, an
    autograd node with its forward operation's number and thread."""
    import torch

    from mmtpu_torch.utils.profiling import STEP, region

    x = torch.randn(4, 3, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with region(STEP["decoder"]):
            y = torch.exp(x * 3.0).sum()
        with region(STEP["backward"]):
            torch.autograd.grad(y, [x])
    ev = events_of(prof)
    assert {e.kind for e in ev} == {"op"}
    node = next(e for e in ev if e.name == EVALUATE + "ExpBackward0")
    exp = next(e for e in ev if e.name == "aten::exp")
    assert (node.fwd_thread, node.seq) == (exp.thread, exp.seq)
    assert step_split(ev) == {}
