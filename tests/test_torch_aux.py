"""The port's aux modules against mmtpu's: ``utils.guards``,
``utils.logging``, ``utils.profiling`` and the ``make_configs`` CLI; and
the run CLI's ``--profile`` and ``--mesh`` on the CPU."""

import json
import logging
import os
import warnings

import numpy as np
import pytest
import torch

import mmtpu.make_configs as jmake
import mmtpu.utils.guards as jguards
import mmtpu.utils.logging as jlogging
import mmtpu_torch.make_configs as tmake
import mmtpu_torch.utils.guards as tguards
import mmtpu_torch.utils.logging as tlogging
import mmtpu_torch.utils.profiling as tprof
from mmtpu_torch import run as tcli
from mmtpu_torch import runner as trunner
from tests.test_torch_runner import _cfg_file, _tiny_prep


def test_check_finite_names_what_mmtpu_names():
    tree = {"a": np.ones(3, np.float32), "b": {"c": np.array([1.0, np.nan, np.inf])},
            "ids": np.arange(3)}
    with pytest.raises(jguards.FiniteError) as jerr:
        jguards.check_finite(tree, "fit")
    with pytest.raises(tguards.FiniteError) as terr:
        tguards.check_finite({k: (torch.as_tensor(v) if not isinstance(v, dict) else
                                  {"c": torch.as_tensor(v["c"])}) for k, v in tree.items()},
                             "fit")
    assert "2/3 non-finite" in str(jerr.value) and "2/3 non-finite" in str(terr.value)
    assert str(terr.value).startswith("fit: ") and "['b']['c']" in str(terr.value)
    tguards.check_finite({"a": torch.ones(2), "n": [torch.zeros(1)]})  # finite: no raise


def test_debug_assert_finite_warns_and_returns():
    x = torch.tensor([1.0, float("nan")])
    with pytest.warns(RuntimeWarning, match="lat non-finite"):
        assert tguards.debug_assert_finite(x, "lat") is x
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tguards.debug_assert_finite(torch.ones(2))


def test_metrics_logger_and_get_logger(tmp_path):
    path = tmp_path / "m" / "metrics.jsonl"
    with tlogging.MetricsLogger(str(path)) as sink:
        rec = sink.log(step=1, loss=0.5)
        sink.log(step=2, loss=0.25, ts=7.0)
    j = jlogging.MetricsLogger(str(tmp_path / "j.jsonl"))
    j.log(step=1, loss=0.5)
    j.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2] and rows[1]["ts"] == 7.0 and "ts" in rec
    jrow = json.loads((tmp_path / "j.jsonl").read_text())
    assert rows[0].keys() == jrow.keys()
    assert tlogging.MetricsLogger().log(x=1)["x"] == 1  # no path: records only
    log = tlogging.get_logger("mmtpu_torch.test")
    assert log is tlogging.get_logger("mmtpu_torch.test") and len(log.handlers) == 1
    assert log.level == logging.INFO and not log.propagate


def test_step_timer():
    timer = tprof.StepTimer(warmup=2)
    calls = []
    out = timer.time_fn(lambda x: calls.append(x) or {"y": torch.ones(2) * x}, 3.0, iters=4)
    assert len(calls) == 6 and len(timer.times) == 4
    assert torch.equal(out["y"], torch.full((2,), 3.0))
    s = timer.summary()
    assert s["n"] == 4 and s["min_s"] <= s["median_s"] <= s["max_s"]
    ctx = tprof.StepTimer(warmup=1)
    for _ in range(3):
        with ctx:
            torch.ones(4).sum()
    assert len(ctx.steady) == 2 and tprof.StepTimer().summary() == {}


def test_step_timer_with_block_waits_for_the_card(monkeypatch):
    """The ``with`` form waits for the card's queued work before its clock
    stops, as ``time_fn`` does (here a stand-in for the card records it)."""
    events = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: events.append("sync"))
    monkeypatch.setattr(tprof.time, "perf_counter",
                        lambda: events.append("clock") or float(len(events)))
    with tprof.StepTimer(warmup=0) as timer:
        events.append("work")
    assert events == ["clock", "work", "sync", "clock"] and timer.times == [3.0]


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_make_configs_writes_mmtpu_files(tmp_path):
    assert jmake.main([str(tmp_path / "j")]) == 0
    assert tmake.main([str(tmp_path / "t")]) == 0
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j"))
    assert sum(f.startswith("config_") for f in files) == 512
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


@pytest.mark.parametrize("flags", [["--profile"], ["--mesh", "data,vocab"]])
def test_cli_profile_and_mesh_on_cpu(tmp_path, monkeypatch, flags):
    """``--profile DIR`` writes a trace; ``--mesh`` without torchrun's
    environment runs a world of one (its collectives over one-rank groups)
    and ends its group.  Both write the plain run's embeddings."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(trunner, "prepare", lambda cfg, data_dir: _tiny_prep())
    base = [_cfg_file(tmp_path, norm="batch_norm"), "mosi", "--e2e", "y", "--device", "cpu",
            "--config_name", "cli"]
    if flags[0] == "--profile":
        flags = ["--profile", str(tmp_path / "trace")]
    assert tcli.main(base + ["--out_root", str(tmp_path / "plain")]) == 0
    assert tcli.main(base + ["--out_root", str(tmp_path / "flag")] + flags) == 0
    assert not torch.distributed.is_initialized()
    post = [np.load(tmp_path / d / "cli" / "config_5_run_0" / "post" / "embed.npy")
            for d in ("flag", "plain")]
    np.testing.assert_array_equal(*post)
    if flags[0] == "--profile":
        assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
