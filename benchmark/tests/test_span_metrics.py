"""The readers of the sweep's timeline (``run_sweep``'s ``chunk_stats``:
``device_s``, ``device_warmup_s``, ``device_start_at_s``,
``device_end_at_s``, ``host_s``, ``alloc``) on hand-made records: each reads its known value, and each
reads nothing from a record of a program that has no timeline."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.run import cell_spec, load_module  # noqa: E402

NAMES = ("sweep.first_chunk_extra_device_s", "sweep.stream_idle_pct", "sweep.allocator_calls",
         "chunk.prepare_s", "chunk.device_train_s", "chunk.device_infer_s", "graphs.warmup_s",
         "graphs.capture_s", "chunk.host_wait_s", "chunk.drain_s", "chunk.device_sent_s")


def _reader(name: str):
    return load_module(os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"),
                       f"benchmark_metric.{name}").read


def _chunk(start, end, train, infer, captures=0, prepare=0.5, warmup=0.0, capture=0.0,
           allocs=0, frees=0, wait=0.1, drain=0.01, sent=1.0):
    return {"chunk": "adam100_0", "done_at_s": end + 1.0,
            "graphs": {"warmups": captures, "captures": captures, "replays": 100},
            "device_s": {"train": train, "valid_infer": infer / 2, "test_infer": infer / 2,
                         "sentiment": sent, "metrics": 0.01},
            "device_warmup_s": warmup, "device_start_at_s": start, "device_end_at_s": end,
            "host_s": {"prepare": prepare, "capture": capture, "wait": wait, "drain": drain},
            "alloc": {"device_allocs": allocs, "device_frees": frees}}


def _record() -> dict:
    """Two calls of two chunks each: the first chunk of a call captures."""
    calls = [
        {"configs": 64, "wall_s": 50.0, "chunk_stats": [
            _chunk(2.0, 24.0, 18.0, 2.0, captures=5, prepare=1.0, warmup=1.5, capture=0.5,
                   allocs=10, frees=4),
            _chunk(24.0, 44.0, 16.0, 2.4, prepare=0.6, allocs=2, wait=18.0, sent=1.2)]},
        {"configs": 64, "wall_s": 40.0, "chunk_stats": [
            # the second chunk's interval overlaps the first's: counted once
            _chunk(1.0, 22.0, 17.0, 2.0, captures=5, prepare=0.9, warmup=1.3, capture=0.7),
            _chunk(21.0, 38.0, 14.0, 2.0, prepare=0.5, frees=6, drain=0.05)]}]
    return {"calls": calls}


WANT = {
    # per call: 24 - 20 = 4 and 22 - 16 = 6; their median
    "sweep.first_chunk_extra_device_s": 5.0,
    # busy 42 + 37 of 90 s
    "sweep.stream_idle_pct": 100.0 * (1 - 79.0 / 90.0),
    "sweep.allocator_calls": (14 + 2 + 0 + 6) / 2,
    "chunk.prepare_s": (1.0 + 0.6 + 0.9 + 0.5) / 4,
    "chunk.device_train_s": (16.0 + 14.0) / 2,
    "chunk.device_infer_s": (2.4 + 2.0) / 2,
    "graphs.warmup_s": (1.5 + 1.3) / 2,
    "graphs.capture_s": (0.5 + 0.7) / 2,
    "chunk.host_wait_s": (0.1 + 18.0 + 0.1 + 0.1) / 4,
    "chunk.drain_s": (0.01 + 0.01 + 0.01 + 0.05) / 4,
    # the chunks that captured nothing: sentiment and scoring
    "chunk.device_sent_s": ((1.2 + 0.01) + (1.0 + 0.01)) / 2,
}


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_reads_its_value(name):
    assert _reader(name)(_record()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_reads_nothing_without_a_timeline(name):
    """A record of a program whose ``chunk_stats`` have ``done_at_s`` and
    ``graphs`` only, as before the timeline."""
    keep = ("chunk", "done_at_s", "graphs")
    record = _record()
    for call in record["calls"]:
        call["chunk_stats"] = [{k: c[k] for k in keep} for c in call["chunk_stats"]]
    assert _reader(name)(record) is None


def test_every_cell_lists_the_readers():
    for cell in ("mosi_mmb2.grid_adam100", "pom_mmb2.grid_adam100"):
        metrics = {m["name"]: m for m in cell_spec(cell)["per_layer"]}
        assert set(NAMES) <= set(metrics)
        assert {metrics[n]["moves"] for n in NAMES} == {"sweep_configs_per_h"}
