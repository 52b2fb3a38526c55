"""The sweep's execution model on the CPU: captured graphs shared by the
fits of a bucket, and the one-chunk-deep pipeline of ``run_sweep``.

The card's graphs are stood in for by tests/test_torch_graphs.py's
:class:`ReplayOnCpu` (its "replay" reruns the function the first capture
recorded, under :class:`NoHostReads`), patched in as the
:class:`mmtpu_torch.graphs.Graphs` that fits and the sweep make, with
``MIN_EPOCHS`` lowered so that these tiny fits capture.  A body that
closed over a fit's tensors would replay the first fit's values in a
later one: each case below holds a later fit or chunk, run through a
shared store, to the same fit or chunk run with a store of its own, bit
for bit.

- Shared graphs: a bucket of three chunks whose configs differ in lr,
  loss weights, norm, positional dim and sentiment lr, through one store
  that captures each key once (in the first chunk); each chunk equals
  ``run_chunk`` of its configs.
- Results that survive: a fit's returned tensors are unchanged by the next
  fit of the same key, and that fit equals itself on a fresh store.
- The pipeline against ``phase_timing`` (each chunk to its end), with
  ``return_embeddings``, the validation curve, two buckets, a ragged chunk
  and a resume.
- A failure while chunk k+1 is queued leaves chunk k saved.
- Each chunk's timeline in ``chunk_stats`` (its phases' seconds, its
  interval on the call's clock, the host's seconds and the allocator's
  calls), pipelined and phase-timed, and the program's ranges, which only
  a profiler session enters.
"""

import collections
import contextlib
import json

import numpy as np
import pytest
import torch

import mmtpu_torch.graphs as tg
import mmtpu_torch.train.latents as tl
import mmtpu_torch.train.sentiment as ts
from mmtpu_torch.sweep.runner import SweepDraws, run_chunk, run_sweep
from mmtpu_torch.train import e2e as te2e
from mmtpu_torch.utils import profiling
from mmtpu_torch.utils.profiling import STEP
from tests.test_torch_graphs import (ReplayOnCpu, _assert_bit_equal, _config_axis_inputs,
                                     _e2e_inputs, _hp, _sentiment_inputs)
from tests.test_torch_sweep import BATCH, one_torch_thread, tiny_prep  # noqa: F401

# train and sentiment epochs: every key of a chunk is called twice or more
# (a sentiment fit validates at epochs 0 and 10), so its first chunk captures it
EPOCHS, SENT_EPOCHS = 3, 12


@pytest.fixture(scope="module")
def prep():
    return tiny_prep()


@pytest.fixture
def shared(monkeypatch):
    """Stores and fits made in the test are :class:`ReplayOnCpu`, capturing
    from 2 epochs; yields the instances made."""
    ReplayOnCpu.made = []
    monkeypatch.setattr(tg, "Graphs", ReplayOnCpu)
    monkeypatch.setattr(tg, "MIN_EPOCHS", 2)
    yield ReplayOnCpu.made


def bucket_configs(k=6, optimizer="adam", first=0):
    """``k`` configs of one (optimizer, epochs) bucket: lr, word and
    likelihood weights, norm, positional dim, hidden size and sentiment lr
    differ from config to config; each pair holds both hidden sizes."""
    rows = [(1e-3, "layer_norm", 2, 8, 1e-3, 1e-4, 1e-2),
            (3e-3, "batch_norm", 4, 12, 2e-3, 0.3, 3e-2),
            (1e-4, "batch_norm", 2, 12, 0.0, 1e-4, 5e-3),
            (2e-3, "layer_norm", 4, 8, 1e-2, 0.5, 2e-2),
            (5e-4, "layer_norm", 4, 12, 5e-3, 0.1, 1e-1),
            (1e-3, "batch_norm", 2, 8, 1e-3, 0.9, 1e-3)]
    return [dict(seq_len=20, word_sim_metric="angular", freeze_weights=False, e2e=True,
                 optimizer=optimizer, n_epochs=EPOCHS, n_sentiment_epochs=SENT_EPOCHS, lr=lr,
                 norm=norm, pos_embed_dim=pos, sentiment_hidden_size=hid, word_loss_weight=wlw,
                 likelihood_weight=lw, sentiment_lr=slr, config_num=first + i)
            for i, (lr, norm, pos, hid, wlw, lw, slr) in enumerate(rows[:k])]


def _sweep(prep, configs, **kw):
    return run_sweep(configs, prep, batch_size=BATCH, chunk_size=2, verbose=False, device="cpu",
                     return_embeddings=True, **kw)


def _assert_same(a, b):
    """Two results bit for bit (NaN where NaN)."""
    _assert_bit_equal([torch.as_tensor(a.final_train_loss), torch.as_tensor(a.diverged)]
                      + [torch.as_tensor(a.metrics[m]) for m in sorted(a.metrics)]
                      + [torch.as_tensor(a.embeddings[s]) for s in ("train", "valid", "test")],
                      [torch.as_tensor(b.final_train_loss), torch.as_tensor(b.diverged)]
                      + [torch.as_tensor(b.metrics[m]) for m in sorted(b.metrics)]
                      + [torch.as_tensor(b.embeddings[s]) for s in ("train", "valid", "test")])
    assert a.metrics.keys() == b.metrics.keys()


def test_bucket_chunks_share_one_store(prep, shared):
    """Three chunks of one bucket through its one store: the first chunk
    warms up and captures every key, the later ones only replay, and each
    chunk equals its configs run by ``run_chunk`` with stores of their own."""
    configs = bucket_configs()
    got = _sweep(prep, configs)
    assert len(shared) == 1  # the bucket's store; its fits made none
    store = shared[0]
    fresh, fresh_captures = [], []
    for i in range(3):
        n_made = len(shared)
        fresh.append(run_chunk(configs[2 * i:2 * i + 2], prep, batch_size=BATCH, device="cpu",
                               return_embeddings=True))
        fresh_captures.append(sum(g.captures for g in shared[n_made:]))
    keys = store.captures
    # the train fit, the valid and test inference fits, two sentiment keys
    assert keys == 5 and fresh_captures == [keys] * 3
    assert [c["graphs"]["captures"] for c in got.chunk_stats] == [keys, 0, 0]
    assert [c["graphs"]["warmups"] for c in got.chunk_stats] == [keys, 0, 0]
    replays = [c["graphs"]["replays"] for c in got.chunk_stats]
    assert replays[1] == replays[2] == replays[0] + keys
    for i, want in enumerate(fresh):
        rows = slice(2 * i, 2 * i + 2)
        np.testing.assert_array_equal(got.final_train_loss[rows], want.final_train_loss)
        for m in want.metrics:
            np.testing.assert_array_equal(got.metrics[m][rows], want.metrics[m], err_msg=m)
        for s in ("train", "valid", "test"):
            np.testing.assert_array_equal(got.embeddings[s][rows], want.embeddings[s],
                                          err_msg=s)


def _latent(store, seed):
    init, dec, data, vocab, hp, perms = _config_axis_inputs(seed=seed)
    hp = dict(hp, lr=hp["lr"] * (1 + seed), word_loss_weight=hp["word_loss_weight"] * seed)
    spec = tl.LatentFitSpec(n_epochs_max=3, batch_size=5, train_decoder=True, unimodal=False,
                            opt_kind="adam", lazy_adam=True)
    return tl.fit_latents(init, dec, data, vocab, hp, spec, perms=perms, graphs=store)


def _e2e(store, seed):
    init, dec, sen, data, labels, vocab, smask, perms = _e2e_inputs(seed=seed)
    hp = dict(_hp(lr=5e-3 * seed), likelihood_weight=torch.tensor(0.2 * seed),
              train_heads=torch.tensor(1.0))
    spec = te2e.E2EFitSpec(n_epochs_max=3, batch_size=8, unimodal=False, opt_kind="sgd")
    return te2e.fit_e2e(init, dec, sen, data, labels * seed, vocab, hp, spec,
                        senti_mask=smask, perms=perms, graphs=store)


def _sentiment(store, seed):
    (params, x, y, xv, yv), hp, spec, perms = _sentiment_inputs("config_axis")
    hp = dict(hp, lr=hp["lr"] * seed, lr_decay=hp["lr_decay"] / seed)
    return ts.fit_sentiment(params, x * seed, y, xv * seed, yv, hp, spec, perms=perms,
                            graphs=store)


@pytest.mark.parametrize("fit", [_latent, _e2e, _sentiment], ids=["latent", "e2e", "sentiment"])
def test_fit_results_survive_the_next_fit(fit, shared):
    """Two fits of one key on a shared store, with other hyperparameters,
    inputs and (sentiment) lr decay: the first fit's results are unchanged
    by the second, which equals itself run on a store of its own."""
    store = ReplayOnCpu("cpu")
    first = fit(store, 1)
    kept = [t.clone() for t in _leaves(first)]
    second = fit(store, 2)
    _assert_bit_equal(_leaves(first), kept)
    _assert_bit_equal(second, fit(ReplayOnCpu("cpu"), 2))
    assert store.warmups == store.captures and store.replays > 2 * store.captures


def _leaves(tree) -> list:
    out = []
    tg._flatten(tree, out)
    return out


def _two_buckets():
    """An Adam bucket of three configs (a chunk of 2 and a ragged chunk of
    1) and an SGD bucket of two."""
    return bucket_configs(3) + bucket_configs(2, optimizer="sgd", first=3)


def test_pipeline_equals_phase_timing(prep, shared, tmp_path):
    """The pipelined sweep (chunk k drained while chunk k+1 runs) and the
    sweep that runs each chunk to its end under ``phase_timing``: the same
    results bit for bit, the validation curve and embeddings included; a
    resume of the pipelined sweep that lacks one chunk computes that chunk
    alone and ends the same."""
    configs = _two_buckets()
    kw = dict(validation_curve=True)
    timed = _sweep(prep, configs, phase_timing=True, **kw)
    piped = _sweep(prep, configs, checkpoint_dir=str(tmp_path), **kw)
    _assert_same(piped, timed)
    assert [c["chunk"] for c in piped.chunk_stats] == ["adam3_0", "adam3_1", "sgd3_0"]
    assert set(timed.phase_s) == {"train", "valid_infer", "test_infer", "sentiment", "metrics"}
    assert piped.phase_s == {} and all("phases" not in c for c in piped.chunk_stats)
    assert [c["graphs"]["captures"] > 0 for c in piped.chunk_stats] == [True, True, True]
    state = tmp_path / "sweep_state.json"
    st = json.loads(state.read_text())
    st["chunks"].remove("adam3_1")
    state.write_text(json.dumps(st))
    resumed = _sweep(prep, configs, checkpoint_dir=str(tmp_path), **kw)
    assert [c["chunk"] for c in resumed.chunk_stats] == ["adam3_1"]
    _assert_same(resumed, timed)


class _FailingDraws(SweepDraws):
    """Draws that fail in the host preparation of their config's chunk."""

    def init_decoder(self, *args):
        raise RuntimeError("planted failure in the next chunk's draws")


def test_failure_while_queueing_saves_the_chunk_before(prep, shared, tmp_path):
    """Chunk 2's draws raise while chunk 1 is still pending: chunk 1 is
    finished and saved before the error propagates, equal to the
    uninterrupted sweep's, and a rerun computes the rest."""
    configs = bucket_configs(4)
    whole = _sweep(prep, configs)
    fail_at = {c["config_num"] for c in configs[2:]}
    draws = lambda num, run: (_FailingDraws if num in fail_at else SweepDraws)(0, num, run)  # noqa
    with pytest.raises(RuntimeError, match="planted"):
        _sweep(prep, configs, checkpoint_dir=str(tmp_path), draws=draws)
    assert json.loads((tmp_path / "sweep_state.json").read_text())["chunks"] == ["adam3_0"]
    resumed = _sweep(prep, configs, checkpoint_dir=str(tmp_path))
    assert [c["chunk"] for c in resumed.chunk_stats] == ["adam3_1"]
    _assert_same(resumed, whole)


PHASES = ("train", "valid_infer", "test_infer", "sentiment", "metrics")


@pytest.mark.parametrize("phase_timing", [False, True], ids=["pipelined", "phase_timing"])
def test_chunk_timeline(prep, shared, phase_timing):
    """Two buckets (chunks adam3_0, adam3_1, sgd3_0), pipelined or each chunk
    to its end: every chunk's record holds its five phases' seconds, its
    interval on the call's clock, which the phases fill and which starts
    no earlier than the chunk before ends, the warm-ups' stream seconds and
    the host's seconds (warm-ups and captures inside the phases, none where
    the chunk made none) and the allocator's calls (none on the CPU), all
    read before the record's ``done_at_s``."""
    res = _sweep(prep, bucket_configs(4) + bucket_configs(2, optimizer="sgd", first=4),
                 phase_timing=phase_timing)
    stats = res.chunk_stats
    assert [c["chunk"] for c in stats] == ["adam3_0", "adam3_1", "sgd3_0"]
    for c in stats:
        assert tuple(c["device_s"]) == PHASES
        assert list(c["host_s"]) == ["prepare", "capture", "wait", "drain"]
        assert c["alloc"] == {"device_allocs": 0, "device_frees": 0}
        assert min(c["device_s"].values()) >= 0 and min(c["host_s"].values()) >= 0
        start, end = c["device_start_at_s"], c["device_end_at_s"]
        assert 0 <= start <= end <= c["done_at_s"] + 0.005
        assert sum(c["device_s"].values()) <= end - start + 5e-6
        assert sum(c["device_s"].values()) >= c["device_warmup_s"] + c["host_s"]["capture"]
        assert (c["device_warmup_s"] > 0) == (c["graphs"]["warmups"] > 0), c["chunk"]
        assert (c["host_s"]["capture"] > 0) == (c["graphs"]["captures"] > 0), c["chunk"]
        assert ("phases" in c) == phase_timing
    assert [c["graphs"]["captures"] > 0 for c in stats] == [True, False, True]
    for before, after in zip(stats, stats[1:]):
        assert after["device_start_at_s"] >= before["device_end_at_s"]
    assert res.chunk_size == 2 and res.out_of_memory_widths == []


@pytest.mark.parametrize("profiled", [False, True], ids=["no_profiler", "profiler"])
def test_ranges_only_under_a_profiler(prep, shared, monkeypatch, profiled):
    """Without a profiler session the sweep enters no range; under one, the
    call, each chunk's preparation, phases and drain and each warm-up and
    capture are ranges named ``mmtpu.*`` (none ``span:*``, the benchmark's
    own), each nested in the call, the graphs' inside a phase, and the fits'
    steps enter every part's range ``mmtpu.step.*`` inside the train and
    inference phases.  One chunk of two epochs (the first warms each key up,
    the second captures it)."""
    entered = []

    def counting(name):
        entered.append(name)
        return real(name)

    real = profiling._Range
    monkeypatch.setattr(profiling, "_Range", counting)
    session = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
               if profiled else contextlib.nullcontext())
    with session as prof:
        res = _sweep(prep, [dict(c, n_epochs=2, n_sentiment_epochs=2)
                            for c in bucket_configs(2)])
    if not profiled:
        assert entered == []
        return
    ours = [e for e in prof.events() if e.name.startswith("mmtpu.")]
    names = collections.Counter(e.name for e in ours)
    assert names == collections.Counter(entered)
    made = res.chunk_stats[0]["graphs"]
    assert made["captures"] > 0
    steps = collections.Counter({n: k for n, k in names.items() if n in STEP.values()})
    assert set(steps) == set(STEP.values())
    assert names - steps == collections.Counter(
        {"mmtpu.sweep.call": 1, "mmtpu.chunk.prepare": 1, "mmtpu.chunk.drain": 1,
         **{f"mmtpu.chunk.{p}": 1 for p in PHASES},
         "mmtpu.graphs.warmup": made["warmups"], "mmtpu.graphs.capture": made["captures"]})
    assert not any(e.name.startswith("span:") for e in prof.events())
    for e in ours:
        chain = [e.name]
        while e.cpu_parent is not None:
            e = e.cpu_parent
            chain.append(e.name)
        assert chain[-1] == "mmtpu.sweep.call", chain
        if chain[0].startswith("mmtpu.graphs."):
            assert {f"mmtpu.chunk.{p}" for p in PHASES} & set(chain), chain
        if chain[0] in steps:
            assert {f"mmtpu.chunk.{p}" for p in PHASES[:3]} & set(chain), chain
