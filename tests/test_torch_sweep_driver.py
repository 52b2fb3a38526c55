"""The port's whole sweep against mmtpu's: ``mmtpu_torch.sweep.run_sweep``
against ``mmtpu.sweep.run_sweep`` on JAX-CPU, fed the draws mmtpu makes from
its keys (``config_num * 1024 + run_idx`` folded into the run's roots), and
the sweep's own mechanisms (resume, the fingerprint, the CLI).

Two mmtpu references, each module-scoped and run once:

- ``buckets``: an SGD bucket (2 epochs) and an Adam bucket (3 epochs), so
  the grid's two epoch counts split it into (optimizer, n_epochs) buckets,
  ``n_runs=2``, ``chunk_size=3`` so that the Adam bucket's four (config,
  run) pairs run as a chunk of 3 and a ragged chunk of 1, a
  semi-supervised ``senti_mask``, ``return_embeddings`` and dense Adam
  (``--exact_adam``; the lazy default is held to mmtpu's sweep by
  tests/test_torch_sweep.py, and each dense Adam program compiles faster);
- ``options``: ``validation_curve``, ``infer_epochs_cap`` (below the epoch
  count) and ``infer_batch_clamp``, on a non-e2e SGD chunk.

The fused decoder update's reference is in tests/test_torch_sweep_fused.py.
Tolerances: final loss rtol 2e-4; embeddings, metrics and curves atol 2e-4
(the parity tests': float32 summed in another order).  The port against
itself (resume, configs alone): bit for bit, or rtol 1e-5 where the config
axis changes the float order.
"""

import csv
import json

import numpy as np
import pytest
import torch

from mmtpu.sweep import run_sweep as j_run_sweep
import mmtpu_torch.data.registry as treg
import mmtpu_torch.sweep.runner as runner
from mmtpu_torch.sweep.__main__ import CONFIG_COLUMNS, main as cli_main
from mmtpu_torch.sweep.runner import chunk_statics, metric_schema, run_sweep
from tests.test_torch_runner import _perms
from tests.test_torch_sweep import (  # noqa: F401
    BATCH, N_TRAIN, SEED, JaxSweepDraws, grid, one_torch_thread, tiny_prep)

SENTI_MASK = (np.arange(N_TRAIN) % 3 != 0).astype(np.float32)


class JaxCurveDraws(JaxSweepDraws):
    """mmtpu's draws under ``validation_curve``: each training epoch splits
    the run key once more (mmtpu/train/latents.py:696); the sentiment fit's
    permutations do not."""

    def train_permutations(self, n, n_epochs):
        return [torch.as_tensor(p) for p in _perms(self.k_run, n, n_epochs, True)]

    def sentiment_permutations(self, n, n_epochs):
        return [torch.as_tensor(p) for p in _perms(self.k_run, n, n_epochs)]


def bucket_configs():
    """Config 0 SGD / 2 epochs, 1 and 2 Adam / 3 (mixing norms, positional
    dims and hidden sizes)."""
    base = grid("adam", k=3, n_epochs=(2, 3, 3))
    return [dict(base[0], optimizer="sgd")] + base[1:]


CASES = {
    "buckets": dict(configs=bucket_configs(),
                    kw=dict(n_runs=2, chunk_size=3, senti_mask=SENTI_MASK,
                            return_embeddings=True, lazy_adam=False),
                    draws=JaxSweepDraws),
    "options": dict(configs=grid("sgd", e2e=False, k=3, n_epochs=(3, 3, 3)),
                    kw=dict(validation_curve=True, infer_epochs_cap=2, infer_batch_clamp=True,
                            return_embeddings=True),
                    draws=JaxCurveDraws),
}


@pytest.fixture(scope="module")
def prep():
    return tiny_prep()


@pytest.fixture(scope="module")
def references(prep):
    """Each case's mmtpu result, computed at first use, once."""
    cache = {}

    def get(name):
        if name not in cache:
            case = CASES[name]
            cache[name] = j_run_sweep(case["configs"], prep, batch_size=BATCH, seed=SEED,
                                      verbose=False, **case["kw"])
        return cache[name]

    return get


def port_sweep(name, prep, **kw):
    case = CASES[name]
    draws = case["draws"]
    return run_sweep(case["configs"], prep, batch_size=BATCH, seed=SEED, verbose=False,
                     device="cpu", draws=lambda num, run: draws(SEED, num, run),
                     **dict(case["kw"], **kw))


@pytest.mark.parametrize("name", list(CASES))
def test_run_sweep_matches_mmtpu(name, prep, references):
    """Per config and run: final loss, metrics (the curve with them),
    embeddings; the same config numbers, run indices, record keys and chunk
    ids."""
    want, got = references(name), port_sweep(name, prep)
    assert got.n_configs == want.n_configs
    np.testing.assert_array_equal(got.config_nums, want.config_nums)
    np.testing.assert_array_equal(got.run_idxs, want.run_idxs)
    assert [c["chunk"] for c in got.chunk_stats] == [c["chunk"] for c in want.chunk_stats]
    assert [c["configs"] for c in got.chunk_stats] == [c["configs"] for c in want.chunk_stats]
    assert [r.keys() for r in got.to_records()] == [r.keys() for r in want.to_records()]
    assert np.isfinite(want.final_train_loss).all() and not got.diverged.any()
    np.testing.assert_allclose(got.final_train_loss, want.final_train_loss, rtol=2e-4)
    assert set(got.metrics) == set(want.metrics)
    for m in want.metrics:
        assert got.metrics[m].shape == want.metrics[m].shape, m
        np.testing.assert_allclose(got.metrics[m], want.metrics[m], atol=2e-4, err_msg=m)
    for split in ("train", "valid", "test"):
        np.testing.assert_allclose(got.embeddings[split], want.embeddings[split], atol=2e-4,
                                   err_msg=split)
    if name == "options":  # samples at epoch 0 and after the last, NaN between
        assert np.isfinite(want.metrics["valid_curve"]).tolist() == [[True, False, False,
                                                                      True]] * 3


def _sweep(prep, **kw):
    kw = dict(dict(configs=bucket_configs(), n_runs=2, chunk_size=3, return_embeddings=True),
              **kw)
    return run_sweep(kw.pop("configs"), prep, batch_size=BATCH, verbose=False, device="cpu",
                     **kw)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.final_train_loss, b.final_train_loss)
    np.testing.assert_array_equal(a.diverged, b.diverged)
    assert a.metrics.keys() == b.metrics.keys()
    for m in a.metrics:
        np.testing.assert_array_equal(a.metrics[m], b.metrics[m], err_msg=m)
    for s in a.embeddings:
        np.testing.assert_array_equal(a.embeddings[s], b.embeddings[s], err_msg=s)


def test_interrupted_sweep_resumes_bit_for_bit(prep, tmp_path, monkeypatch):
    """A sweep that fails in its second chunk, rerun with the same
    checkpoint_dir, computes only the chunks it lacks and ends equal to the
    uninterrupted sweep bit for bit."""
    whole = _sweep(prep)
    queue, calls = runner._queue, []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("planted failure in chunk 2")
        return queue(*args, **kw)

    monkeypatch.setattr(runner, "_queue", failing)
    with pytest.raises(RuntimeError, match="planted"):
        _sweep(prep, checkpoint_dir=str(tmp_path))
    monkeypatch.setattr(runner, "_queue", queue)
    with open(tmp_path / "sweep_state.json") as f:
        assert json.load(f)["chunks"] == [whole.chunk_stats[0]["chunk"]]
    resumed = _sweep(prep, checkpoint_dir=str(tmp_path))
    assert [c["chunk"] for c in resumed.chunk_stats] == [
        c["chunk"] for c in whole.chunk_stats[1:]]
    _assert_same(resumed, whole)
    again = _sweep(prep, checkpoint_dir=str(tmp_path))  # every chunk from the files
    assert again.chunk_stats == []
    _assert_same(again, whole)


def test_other_sweep_in_the_same_dir_starts_fresh(prep, tmp_path, capsys):
    """A changed seed in the same checkpoint_dir is another sweep: its state
    is ignored, with mmtpu's message, and every chunk is computed."""
    first = _sweep(prep, checkpoint_dir=str(tmp_path), return_embeddings=False)
    capsys.readouterr()
    other = run_sweep(bucket_configs(), prep, batch_size=BATCH, seed=SEED + 1, n_runs=2,
                      chunk_size=3, device="cpu", checkpoint_dir=str(tmp_path))
    assert "fingerprint mismatch" in capsys.readouterr().out
    assert len(other.chunk_stats) == len(first.chunk_stats) == 3
    assert not np.array_equal(other.final_train_loss, first.final_train_loss)


@pytest.mark.parametrize("e2e", [True, False])
def test_options_chunk_equals_configs_alone(prep, e2e):
    """Each config of a chunk with every option on (validation curve,
    senti_mask, inference epoch cap and batch clamp) ends where it ends run
    alone through the single-config fits with the same options and draws."""
    configs = grid("adam", e2e=e2e, k=3, n_epochs=(2, 3, 3))
    opts = dict(validation_curve=True, infer_epochs_cap=2, infer_batch_clamp=True)
    chunk = runner.run_chunk(configs, prep, batch_size=BATCH, device="cpu",
                             return_embeddings=True, senti_mask=SENTI_MASK, **opts)
    assert chunk.metrics["valid_curve"].shape == (3, 4)
    for i, c in enumerate(configs):
        statics = chunk_statics([c], prep, batch_size=BATCH, unimodal=False, lazy_adam=True,
                                **opts)
        alone = runner._execute([c], prep, statics, runner._draws_for([c], None, 0),
                                torch.device("cpu"), True, config_axis=False,
                                senti_mask=SENTI_MASK)
        # the chunk runs 3 epochs: a 2-epoch config reads NaN at its epoch 2,
        # and its final sample is the chunk's last entry
        ne, curve = c["n_epochs"], alone.metrics["valid_curve"][0]
        want_curve = np.full(4, np.nan, np.float32)
        want_curve[:ne], want_curve[-1] = curve[:ne], curve[-1]
        assert np.isfinite(want_curve).tolist() == [True, False, False, True]
        np.testing.assert_allclose(chunk.metrics["valid_curve"][i], want_curve, rtol=1e-5)
        np.testing.assert_allclose(chunk.final_train_loss[i], alone.final_train_loss[0],
                                   rtol=1e-5)
        for s in ("train", "valid", "test"):
            np.testing.assert_allclose(chunk.embeddings[s][i], alone.embeddings[s][0],
                                       rtol=1e-5, atol=1e-6, err_msg=s)
        np.testing.assert_allclose(chunk.predictions[i], alone.predictions[0], rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture
def tiny_registry(monkeypatch):
    """The CLI's dataset: mmtpu's tests/test_fused_update.py CLI sizes."""
    orig = treg.synthesize_dataset
    monkeypatch.setattr(treg, "synthesize_dataset", lambda name, seed=0: orig(
        name, n_train=24, n_valid=8, n_test=10, vocab_size=50, embed_dim=12, audio_dim=5,
        visual_dim=4, seed=seed))


def test_cli_writes_mmtpu_columns(tmp_path, tiny_registry, references):
    """``python -m mmtpu_torch.sweep`` on the CPU: the CSV's columns are
    mmtpu's record keys plus the config columns, one row per (config, run);
    the summary has mmtpu's keys; a rerun from its resume_dir computes
    nothing and writes the same CSV.  The grid's first four configs, cut to
    2 epochs and 3 sentiment epochs, from ``--configs_dir``."""
    from mmtpu_torch.config import make_grid

    (tmp_path / "cfgs").mkdir()
    for c in make_grid()[:4]:
        with open(tmp_path / "cfgs" / f"config_{c['config_num']}.json", "w") as f:
            json.dump(dict(c, n_epochs=2, n_sentiment_epochs=3), f)
    argv = ["mosi", "--configs_dir", str(tmp_path / "cfgs"), "--limit", "3", "--chunk_size",
            "2", "--batch_size", "8", "--n_runs", "2",
            "--device", "cpu", "--data_dir", str(tmp_path / "nodata"), "--out",
            str(tmp_path / "results"), "--name", "cli", "--resume_dir", str(tmp_path / "ck"),
            "--semi_sup_idxes", "0.5", "--fused_dec", "--phase_timing"]
    assert cli_main(argv) == 0
    with open(tmp_path / "results" / "cli.csv") as f:
        rows = list(csv.DictReader(f))
    want_keys = set(references("buckets").to_records()[0]) | set(CONFIG_COLUMNS)
    assert set(rows[0]) == want_keys and len(rows) == 6
    with open(tmp_path / "results" / "cli_summary.json") as f:
        summary = json.load(f)
    assert set(summary) == {"n_configs", "wall_time_s", "compile_time_s", "exec_time_s",
                            "configs_per_hour", "configs_per_hour_exec", "dataset",
                            "chunk_size", "out_of_memory_widths", "chunks"}
    assert summary["n_configs"] == 6 and all("phases" in c for c in summary["chunks"])
    assert (summary["chunk_size"], summary["out_of_memory_widths"]) == (2, [])
    assert all({"device_s", "device_warmup_s", "device_start_at_s", "device_end_at_s",
                "host_s", "alloc"} <= set(c) for c in summary["chunks"])
    first = (tmp_path / "results" / "cli.csv").read_bytes()
    assert cli_main(argv) == 0
    with open(tmp_path / "results" / "cli_summary.json") as f:
        assert json.load(f)["chunks"] == []
    assert (tmp_path / "results" / "cli.csv").read_bytes() == first


def test_cli_profile_writes_the_sweep_ranges(tmp_path, tiny_registry, capsys):
    """``--profile DIR``: the sweep runs under ``torch.profiler`` and its
    Chrome trace holds the sweep's ranges."""
    argv = ["mosi", "--limit", "1", "--batch_size", "8", "--device", "cpu", "--data_dir",
            str(tmp_path / "nodata"), "--out", str(tmp_path / "results"), "--name", "prof",
            "--profile", str(tmp_path / "trace")]
    import mmtpu_torch.config as tconfig

    grid = tconfig.make_grid
    with pytest.MonkeyPatch.context() as mp:  # one config of 2 epochs
        mp.setattr(tconfig, "make_grid", lambda: [dict(c, n_epochs=2, n_sentiment_epochs=2)
                                                  for c in grid()[:1]])
        assert cli_main(argv) == 0
    assert f"profiler trace written to {tmp_path / 'trace'}" in capsys.readouterr().out
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"mmtpu.sweep.call", "mmtpu.chunk.prepare", "mmtpu.chunk.train",
            "mmtpu.chunk.drain"} <= names


@pytest.mark.parametrize("flags,error,match", [
    (["--pallas"], SystemExit, "always runs in the port's kernel K1"),
    (["--no_pallas"], SystemExit, "always runs in the port's kernel K1"),
    (["--unroll", "2"], SystemExit, "not scans"),
])
def test_cli_refuses_what_the_port_has_not(flags, error, match, tmp_path, tiny_registry,
                                           capsys):
    """The TPU flags (``--mesh`` and ``--multihost`` run since the parallel
    package was ported: tests/test_torch_multihost.py)."""
    argv = ["mosi", "--limit", "1", "--batch_size", "8", "--device", "cpu", "--data_dir",
            str(tmp_path), "--out", str(tmp_path / "results")] + flags
    with pytest.raises(error) as exc:
        cli_main(argv)
    text = capsys.readouterr().err if error is SystemExit else str(exc.value)
    assert match in text
    assert not (tmp_path / "results").exists()


def test_cli_infer_warm_start(tmp_path, tiny_registry):
    """``--infer_warm_start --infer_epochs 1`` (refused before the closed
    form was ported) runs the grid's first two configs, cut to 2 epochs,
    to finite rows."""
    from mmtpu_torch.config import make_grid

    (tmp_path / "cfgs").mkdir()
    for c in make_grid()[:2]:
        with open(tmp_path / "cfgs" / f"config_{c['config_num']}.json", "w") as f:
            json.dump(dict(c, n_epochs=2, n_sentiment_epochs=2), f)
    argv = ["mosi", "--configs_dir", str(tmp_path / "cfgs"), "--batch_size", "8", "--device",
            "cpu", "--data_dir", str(tmp_path / "nodata"), "--out", str(tmp_path / "results"),
            "--name", "warm", "--infer_warm_start", "--infer_epochs", "1"]
    assert cli_main(argv) == 0
    with open(tmp_path / "results" / "warm.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    assert all(np.isfinite(float(r[m])) for r in rows for m in ("final_train_loss", "mae"))


def test_metric_schema_and_bucket_ids(prep):
    """The work list is mmtpu's: buckets by (optimizer, n_epochs) in sorted
    order when the grid has 2-4 epoch counts, ids ``<kind><ne>_<i>``, ragged
    last chunks; one epoch bucket at the longest count otherwise."""
    configs = [dict(c, _run_idx=r) for c in bucket_configs() for r in range(2)]
    work = runner._buckets(configs, 3, 3)
    assert [(cid, len(pos)) for cid, _, _, pos in work] == [
        ("adam3_0", 3), ("adam3_1", 1), ("sgd2_0", 2)]
    assert [configs[p]["_run_idx"] for p in work[0][3]] == [0, 1, 0]
    mixed = [dict(c, n_epochs=ne) for c, ne in zip(grid("adam"), (2, 3, 3, 2))]
    assert [cid for cid, *_ in runner._buckets(mixed, 3, 3)] == ["adam2_0", "adam3_0"]
    many = [dict(c, n_epochs=ne) for c, ne in zip(grid("sgd") * 2, range(1, 9))]
    assert [cid for cid, *_ in runner._buckets(many, 8, 5)] == ["sgd8_0", "sgd8_1"]
    assert set(metric_schema(prep)) == {"mae", "corr", "mult_acc", "f_score", "accuracy"}
