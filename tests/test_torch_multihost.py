"""The port's multi-process sweep and the sweep's config axis over ranks, on
the CPU: a two-rank gloo world (tests/_torch_parallel_worker.py, one spawn
for every case) against the single-process runs of the same configs.

- ``run_sweep_multihost`` (strided shards ``configs[p::2]``, one gather)
  bit-equal to ``run_sweep`` on four grid configs of two epoch counts;
- ``run_chunk(mesh=...)`` (each rank a contiguous block of the chunk: 2 + 2
  configs, and 2 + 1) bit for bit ``run_chunk`` alone, embeddings and
  predictions included;
- one config over two processes: the empty shard takes part in the gather,
  with and without the validation curve (whose width is the grid's);
- ``shard_configs`` against mmtpu's, ``init_multihost`` as a no-op without
  torchrun's environment, and the CLI's ``--multihost`` and ``--mesh`` in
  one process.

Bit for bit: on the CPU a config's arithmetic does not depend on how many
configs share its chunk (the chunk against its configs alone,
tests/test_torch_sweep_mech.py), and the draws are per config.
"""

import csv

import numpy as np
import pytest

import mmtpu.parallel.multihost as jmh
from mmtpu_torch.data.pipeline import prepare_device_data
from mmtpu_torch.data.synthetic import synthesize_dataset
from mmtpu_torch.parallel import multihost as tmh
from mmtpu_torch.sweep.runner import run_chunk, run_sweep
from tests.test_torch_parallel import finish_world, start_world
from tests.test_torch_sweep import (  # noqa: F401
    BATCH, N_TEST, N_TRAIN, N_VALID, grid, one_torch_thread)
from tests.test_torch_sweep_driver import cli_main, tiny_registry  # noqa: F401

PREP = {"dataset": dict(name="mosi", n_train=N_TRAIN, n_valid=N_VALID, n_test=N_TEST,
                        vocab_size=50, embed_dim=12, audio_dim=5, visual_dim=4),
        "prepare": dict(pos_mode="shared", pos_dims=(2, 4))}
ONE = [{k: v for k, v in grid("sgd", k=1, n_epochs=(2,))[0].items() if k != "config_num"}]
CASES = [
    dict(name="sweep", op="multihost", configs=grid("adam"), kw=dict(batch_size=BATCH)),
    dict(name="chunk", op="chunk", configs=grid("sgd", n_epochs=(2, 2, 2, 2)),
         kw=dict(batch_size=BATCH, return_embeddings=True)),
    dict(name="chunk_uneven", op="chunk", configs=grid("adam", k=3, n_epochs=(2, 3, 3)),
         kw=dict(batch_size=BATCH, return_embeddings=True)),
    dict(name="empty", op="multihost", configs=ONE, kw=dict(batch_size=BATCH)),
    dict(name="empty_curve", op="multihost", configs=ONE,
         kw=dict(batch_size=BATCH, validation_curve=True)),
    # run_sweep over the config mesh, rank 1's half of each chunk of 4
    # failing; compared with the sweep at width 2 in one process
    dict(name="mesh_oom", op="mesh_sweep", configs=grid("adam", n_epochs=(2, 2, 2, 2)),
         kw=dict(batch_size=BATCH, chunk_size=4), want_kw=dict(chunk_size=2),
         fail_rank=1, fail_above=1, error="oom"),
    dict(name="mesh_broken", op="mesh_sweep", configs=grid("adam", n_epochs=(2, 2, 2, 2)),
         kw=dict(batch_size=BATCH, chunk_size=4), fail_rank=1, fail_above=1, error="value"),
]


def _prep():
    return prepare_device_data(synthesize_dataset(**PREP["dataset"]), **PREP["prepare"])


def _columns(res) -> dict:
    out = {"config_nums": res.config_nums, "run_idxs": res.run_idxs,
           "final_train_loss": res.final_train_loss, "diverged": res.diverged,
           **{f"m:{k}": v for k, v in res.metrics.items()}}
    if res.embeddings is not None:
        out.update({f"emb_{s}": e for s, e in res.embeddings.items()})
        out["predictions"] = res.predictions
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every case on a two-rank world, and the single-process runs, made
    while the world runs."""
    running = start_world(2, [dict(c, prep=PREP) for c in CASES],
                          tmp_path_factory.mktemp("world2"))
    prep = _prep()
    want = {}
    for c in CASES:
        if c["op"] == "chunk":
            want[c["name"]] = run_chunk(c["configs"], prep, device="cpu", **c["kw"])
        else:
            want[c["name"]] = run_sweep(c["configs"], prep, device="cpu", verbose=False,
                                        **dict(c["kw"], **c.get("want_kw", {})))
    return finish_world(running), want


@pytest.mark.parametrize("name", ["sweep", "chunk", "chunk_uneven", "empty", "empty_curve"])
def test_two_ranks_equal_one_process(world2, name):
    outs, want = world2
    got = outs[name]
    for r in range(1, len(got)):  # every rank holds the whole result
        assert got[r].keys() == got[0].keys()
        for k in got[0]:
            np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=k)
    expect = _columns(want[name])
    assert got[0].keys() == expect.keys()
    for k, v in expect.items():
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)
    if name.startswith("empty"):  # the GLOBAL index, though rank 1 ran nothing
        assert got[0]["config_nums"].tolist() == [0]
    if name == "empty_curve":
        assert got[0]["m:valid_curve"].shape == (1, 3)  # n_epochs + 1


def test_mesh_ranks_retry_together_when_one_rank_runs_out_of_memory(world2):
    """Rank 1 alone runs out of memory in the chunk of 4: the gather tells
    rank 0, both ranks print mmtpu's message and rerun the sweep at width
    2 (blocks of 1), and both hold the width-2 sweep of one process, bit
    for bit."""
    outs, want = world2
    expect = _columns(want["mesh_oom"])
    for got in outs["mesh_oom"]:
        assert got["raised"] == ""
        assert got["tried"].tolist() == [2, 1, 1]
        assert got["retries"].tolist() == [
            "[sweep] chunk width 4 failed on device — retrying the sweep at width 2"]
        assert got["width"].tolist() == [2]
        assert got["out_of_memory_widths"].tolist() == [4]
        for k, v in expect.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_mesh_ranks_raise_together_when_one_rank_fails(world2):
    """An error on rank 1 that is not the card's memory: every rank raises
    (a RuntimeError naming it), none retries and none waits in a gather
    that the failed rank never enters."""
    outs, _ = world2
    for got in outs["mesh_broken"]:
        assert got["raised"] == "RuntimeError"
        assert got["tried"].tolist() == [2]
        assert got["retries"].tolist() == []


def test_shard_configs_matches_mmtpu():
    configs = grid("adam")
    for n in (1, 2, 3, 5):
        for p in range(n):
            got, idx = tmh.shard_configs(configs, p, n)
            want, jidx = jmh.shard_configs(configs, process_id=p, num_processes=n)
            assert got == want and idx.tolist() == jidx.tolist()


def test_init_multihost_without_torchrun_env_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.init_multihost("cpu") is False
    assert not tmh.dist.is_initialized()
    assert tmh.world() == (0, 1)
    local, idx = tmh.shard_configs(grid("adam"))
    assert len(local) == 4 and idx.tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("flag", ["--multihost", "--mesh"])
def test_cli_multihost_and_mesh_in_one_process(flag, tmp_path, tiny_registry, monkeypatch):
    """``python -m mmtpu_torch.sweep mosi --multihost`` without torchrun's
    environment is one process, and ``--mesh`` a world of one (its gather
    runs); both write the CSV of the plain command, byte for byte."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    argv = ["mosi", "--limit", "2", "--batch_size", "8", "--device", "cpu", "--data_dir",
            str(tmp_path / "nodata")]
    cut = lambda c: dict(c, n_epochs=1, n_sentiment_epochs=2)  # noqa: E731
    monkeypatch.setattr("mmtpu_torch.sweep.__main__._load_configs",
                        lambda args: [cut(c) for c in grid("sgd", k=2, n_epochs=(1, 1))])
    assert cli_main(argv + ["--out", str(tmp_path / "plain")]) == 0
    assert cli_main(argv + [flag, "--out", str(tmp_path / "flag")]) == 0
    assert not tmh.dist.is_initialized()  # the group it started ended with it
    read = lambda d: (tmp_path / d / "sweep.csv").read_bytes()  # noqa: E731
    assert read("flag") == read("plain")
    with open(tmp_path / "flag" / "sweep.csv") as f:
        assert [r["config_num"] for r in csv.DictReader(f)] == ["0", "1"]
