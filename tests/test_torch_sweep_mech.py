"""The sweep chunk's own mechanisms, on the CPU: the chunk against its
configs run alone through the single-config fits, isolation of a diverging
config, inert padding (masked positional channels, padded hidden units), the
options that are not ported, and the pieces the chunk adds to the
single-config path (the shared positional table, the device metrics, the
padded sentiment init) against mmtpu.

Tolerances: the chunk against configs run alone rtol 1e-5 (the same float32
arithmetic with a leading axis); an isolated or padded config bit for bit
where the arithmetic is the same, else mmtpu's padding tests' 1e-6; against
mmtpu the repo's parity tolerances (losses rtol 2e-4, embeddings atol 2e-4,
metrics rtol 1e-6 on the same predictions).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmtpu.eval.metrics as jmetrics
from mmtpu.models.decoder import NORM_CODES, init_decoder as j_init_decoder
from mmtpu.train.latents import LatentFitSpec as JSpec, fit_latents as j_fit_latents
from mmtpu.train.latents import train_view as j_train_view
from mmtpu.train.optim import OPT_CODES
import mmtpu_torch.eval.metrics as tmetrics
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.models.sentiment import apply_sentiment, init_sentiment
from mmtpu.sweep import run_sweep as j_run_sweep
from mmtpu_torch.sweep.runner import (SweepDraws, _draws_for, _execute, chunk_statics, run_chunk,
                                      run_config_alone)
from mmtpu_torch.train import latents as tl
from mmtpu_torch.train.sentiment import SentimentFitSpec, fit_sentiment
from mmtpu_torch.parallel.mesh import Mesh, make_mesh
from tests.test_torch_parallel import world_of_one  # noqa: F401
from tests.test_torch_runner import REPO, _perms
from tests.test_torch_sweep import (  # noqa: F401
    BATCH, grid, jax_draws, one_torch_thread, tiny_prep)


@pytest.fixture(scope="module")
def prep():
    return tiny_prep()


def _chunk(configs, prep, **kw):
    return run_chunk(configs, prep, batch_size=BATCH, device="cpu", return_embeddings=True, **kw)


def _assert_config(got, i, want, j=0, rtol=0.0):
    """Config ``i`` of result ``got`` against config ``j`` of ``want``: equal
    (``rtol`` 0) or within ``rtol``."""
    pairs = [(got.final_train_loss[i], want.final_train_loss[j]),
             (got.predictions[i], want.predictions[j])]
    pairs += [(got.embeddings[s][i], want.embeddings[s][j]) for s in ("train", "valid", "test")]
    pairs += [(got.metrics[m][i], want.metrics[m][j]) for m in want.metrics]
    for a, b in pairs:
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("optimizer,e2e,lazy_adam,suff_stats", [
    ("adam", True, True, True), ("adam", True, False, True), ("sgd", True, True, True),
    ("sgd", False, True, True), ("adam", False, True, True), ("sgd", True, True, False),
])
def test_chunk_equals_configs_alone(prep, optimizer, e2e, lazy_adam, suff_stats):
    """Each config of a chunk ends where it ends run alone, with no config
    axis, through the single-config fits and the same draws (on sufficient
    statistics, and on the raw streams with the positional table)."""
    if not suff_stats:
        prep = tiny_prep(suff_stats=False)
    configs = grid(optimizer, e2e=e2e)
    chunk = _chunk(configs, prep, lazy_adam=lazy_adam)
    assert chunk.n_configs == 4 and not chunk.diverged.any()
    assert set(chunk.phase_s) == {"train", "valid_infer", "test_infer", "sentiment", "metrics"}
    for i, c in enumerate(configs):
        alone = run_config_alone(c, prep, batch_size=BATCH, lazy_adam=lazy_adam, device="cpu")
        _assert_config(chunk, i, alone, rtol=1e-5)


def test_config_result_does_not_depend_on_its_chunk(prep):
    """Default draws are per (seed, config, run): a config's result is the
    same in any chunk, in any position."""
    configs = grid("adam")
    whole = _chunk(configs, prep)
    part = _chunk(configs[2:][::-1], prep)
    for i, j in ((2, 1), (3, 0)):
        _assert_config(part, j, whole, i, rtol=1e-5)
    assert part.config_nums.tolist() == [3, 2]


class _Poisoned(SweepDraws):
    """Default draws with the decoder's ``w_mu`` of ``head`` overwritten at
    ``cols`` by ``value``."""

    def __init__(self, seed, config_num, head, cols, value):
        super().__init__(seed, config_num)
        self.head, self.cols, self.value = head, cols, value

    def init_decoder(self, *a):
        dec = super().init_decoder(*a)
        dec["heads"][self.head]["w_mu"][:, self.cols] = self.value
        return dec


def test_diverging_config_leaves_the_others_bit_equal(prep):
    """A config whose decoder is NaN is reported diverged; every other
    config's results are bit for bit those of the clean chunk."""
    configs = grid("adam")
    clean = _chunk(configs, prep)
    draws = [SweepDraws(0, c["config_num"]) for c in configs]
    draws[1] = _Poisoned(0, 1, "audio", slice(None), float("nan"))
    bad = _chunk(configs, prep, draws=draws)
    assert bad.diverged.tolist() == [False, True, False, False]
    assert np.isnan(bad.final_train_loss[1])
    for i in (0, 2, 3):
        _assert_config(bad, i, clean, i)


def test_masked_pos_channels_are_inert(prep):
    """Garbage in the decoder weights of a positional block that no config
    of the chunk selects changes nothing (mmtpu's
    test_masked_pos_channels_are_inert): its channels give zero
    log-probability and zero gradients."""
    configs = [dict(c, pos_embed_dim=2) for c in grid("adam")[:2]]
    clean = _chunk(configs, prep)
    # audio head columns: audio (5) then the table's blocks (2, 4); the last
    # two are the tail of the dim-4 block, masked for both configs
    draws = [_Poisoned(0, c["config_num"], "audio", slice(-2, None), 1e3) for c in configs]
    poisoned = _chunk(configs, prep, draws=draws)
    for i in range(2):
        _assert_config(poisoned, i, clean, i)


class _PaddedGarbage(SweepDraws):
    """Default draws with garbage in the padded hidden units' output weights."""

    def init_sentiment(self, embed_dim, hidden_dim, n_out, hidden_pad):
        p = super().init_sentiment(embed_dim, hidden_dim, n_out, hidden_pad)
        p["w2"][hidden_dim:] = 7.0
        return p


def test_padded_hidden_units_are_inert(prep):
    """A padded hidden unit's activation is 0, so its output weights
    neither act nor train: garbage there changes nothing."""
    configs = grid("sgd")  # hidden sizes 8 and 12: the 8-unit configs are padded
    clean = _chunk(configs, prep)
    garbage = _chunk(configs, prep, draws=[_PaddedGarbage(0, c["config_num"]) for c in configs])
    for i in range(4):
        _assert_config(garbage, i, clean, i)


def test_hidden_padding_equivalence():
    """A zero-padded MLP trains as the unpadded one (mmtpu's
    test_hidden_padding_equivalence, early stopping on)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((20, 6)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal(20).astype(np.float32))
    small = init_sentiment(torch.Generator().manual_seed(3), 6, 5, 1)
    padded = init_sentiment(torch.Generator().manual_seed(3), 6, 5, 1, hidden_pad=9)
    assert padded["w1"].shape == (6, 9) and padded["w2"].shape == (9, 1)
    for k, real, pad in (("w1", np.s_[:, :5], np.s_[:, 5:]), ("b1", np.s_[:5], np.s_[5:]),
                         ("w2", np.s_[:5], np.s_[5:])):
        np.testing.assert_array_equal(padded[k][real], small[k])
        assert (padded[k][pad] == 0).all()
    np.testing.assert_array_equal(padded["b2"], small["b2"])
    hp = {"lr": 0.05, "lr_decay": 0.5, "n_epochs": 6}
    spec = SentimentFitSpec(n_epochs_max=6, early_stopping=True)
    perms = [torch.randperm(20, generator=torch.Generator().manual_seed(e)) for e in range(6)]
    last_s, _, tl_s, _ = fit_sentiment(small, x, y, x, y, hp, spec, perms=perms)
    last_p, _, tl_p, _ = fit_sentiment(padded, x, y, x, y, hp, spec, perms=perms)
    np.testing.assert_allclose(tl_p, tl_s, atol=1e-6)
    np.testing.assert_allclose(apply_sentiment(last_p, x), apply_sentiment(last_s, x), atol=1e-6)


def test_mixed_optimizers_raise(prep):
    configs = grid("adam")
    configs[2] = dict(configs[2], optimizer="sgd")
    with pytest.raises(ValueError, match="one optimizer"):
        _chunk(configs, prep)


@pytest.mark.parametrize("kw", [{"mesh": Mesh(("data", "vocab"), np.zeros((1, 1), int), (0, 0),
                                                {})}])
def test_unported_options_raise(prep, kw, world_of_one):
    """``mesh`` runs (it raised before the parallel package was ported): a
    chunk over a config mesh of one rank is the chunk without it, bit for
    bit (two ranks: tests/test_torch_multihost.py); a mesh without a
    "config" axis is refused."""
    with pytest.raises(ValueError, match="'config' axis"):
        _chunk(grid("adam"), prep, **kw)
    configs = grid("adam")
    got, want = _chunk(configs, prep, mesh=make_mesh()), _chunk(configs, prep)
    for i in range(len(configs)):
        _assert_config(got, i, want, i)


def test_warm_started_chunk_matches_mmtpu(prep):
    """``infer_warm_start`` with an epoch cap (it raised before the closed
    form was ported): an e2e lazy-Adam MMB2 chunk against
    ``mmtpu.sweep.run_sweep`` with mmtpu's draws."""
    configs = grid("adam", k=3, n_epochs=(3, 3, 3))
    opts = dict(infer_warm_start=True, infer_epochs_cap=1)
    want = j_run_sweep(configs, prep, batch_size=BATCH, seed=0, verbose=False,
                       return_embeddings=True, **opts)
    got = _chunk(configs, prep, draws=jax_draws(configs), **opts)
    assert not got.diverged.any() and np.isfinite(want.final_train_loss).all()
    np.testing.assert_allclose(got.final_train_loss, want.final_train_loss, rtol=2e-4)
    for split in ("train", "valid", "test"):
        np.testing.assert_allclose(got.embeddings[split], want.embeddings[split], atol=2e-4,
                                   err_msg=split)
    for name in want.metrics:
        np.testing.assert_allclose(got.metrics[name], want.metrics[name], atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("unimodal", [False, True], ids=["mmb2", "mmb1"])
def test_warm_started_chunk_equals_configs_alone(prep, unimodal):
    """Each config's inference fits start from the closed form of its own
    trained decoder: under the config axis as in a single-config run, and
    not from the SIF init (the valid and test embeddings move)."""
    configs = grid("sgd", k=3, n_epochs=(2, 2, 2))
    opts = dict(infer_warm_start=True, infer_epochs_cap=1)
    chunk = _chunk(configs, prep, unimodal=unimodal, **opts)
    cold = _chunk(configs, prep, unimodal=unimodal, infer_epochs_cap=1)
    assert not np.allclose(chunk.embeddings["test"], cold.embeddings["test"], atol=1e-3)
    np.testing.assert_array_equal(chunk.embeddings["train"], cold.embeddings["train"])
    for i, c in enumerate(configs):
        statics = chunk_statics([c], prep, batch_size=BATCH, unimodal=unimodal,
                                lazy_adam=True, **opts)
        alone = _execute([c], prep, statics, _draws_for([c], None, 0), torch.device("cpu"),
                         True, config_axis=False)
        _assert_config(chunk, i, alone, rtol=1e-5)


def test_runs_on_cuda_by_default(prep):
    if torch.cuda.is_available():
        pytest.skip("this case needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        run_chunk(grid("adam"), prep, batch_size=BATCH)


@pytest.mark.parametrize("suff_stats", [True, False])
def test_shared_table_fit_matches_mmtpu(suff_stats):
    """One config (no config axis) on the sweep's shared-table data, its
    channel mask selecting the dim-4 block: the port's fit_latents against
    mmtpu's, sufficient statistics and raw streams."""
    from mmtpu.data.pipeline import prepare_device_data
    from mmtpu.data.synthetic import synthesize_dataset

    ds = synthesize_dataset("mosi", n_train=24, n_valid=8, n_test=10, vocab_size=50,
                            embed_dim=12, audio_dim=5, visual_dim=4)
    p = prepare_device_data(ds, pos_mode="shared", pos_dims=(2, 4), suff_stats=suff_stats)
    data = j_train_view(p.splits["train"])
    data["pos_mask"] = np.array([0, 0, 1, 1, 1, 1], np.float32)
    key = jax.random.key(4)
    dec = j_init_decoder(key, 12, 5 + 6, 4 + 6)
    hp = {"lr": jnp.float32(1e-3), "word_loss_weight": jnp.float32(0.001),
          "opt_code": jnp.int32(OPT_CODES["adam"]), "norm_code": jnp.int32(NORM_CODES[
              "batch_norm"]), "n_epochs": jnp.int32(2)}
    spec = JSpec(n_epochs_max=2, batch_size=8, train_decoder=True, unimodal=False,
                 opt_kind="adam")
    rng = jax.random.key(5)
    e_w, dec_w, l_w = j_fit_latents(rng, jnp.asarray(p.sif_init["train"]), dec,
                                    {k: jnp.asarray(v) for k, v in data.items()},
                                    jnp.asarray(p.vocab_embeddings), hp, spec)
    thp = {"lr": torch.tensor(1e-3), "word_loss_weight": torch.tensor(0.001), "opt_code": 1,
           "norm_code": torch.tensor(NORM_CODES["batch_norm"]), "n_epochs": 2}
    tspec = tl.LatentFitSpec(n_epochs_max=2, batch_size=8, train_decoder=True, unimodal=False,
                             opt_kind="adam")
    e_g, dec_g, l_g = tl.fit_latents(to_torch(p.sif_init["train"]), to_torch(dec),
                                     to_torch(tl.train_view(data)),
                                     to_torch(p.vocab_embeddings), thp, tspec,
                                     perms=_perms(rng, 24, 2))
    np.testing.assert_allclose(to_numpy(l_g), np.asarray(l_w), rtol=2e-4)
    np.testing.assert_allclose(to_numpy(e_g), np.asarray(e_w), atol=2e-4)
    np.testing.assert_allclose(to_numpy(dec_g["heads"]["audio"]["w_mu"]),
                               np.asarray(dec_w["heads"]["audio"]["w_mu"]), atol=2e-4)


@pytest.mark.parametrize("name", ["mosi", "pom", "iemocap"])
def test_device_metrics_match_mmtpu(name):
    """The score phase's metrics over a config axis against mmtpu's, config
    by config, on the same predictions (NaN predictions included)."""
    rng = np.random.default_rng(1)
    shape = {"mosi": (30,), "pom": (30, 4), "iemocap": (30, 3)}[name]
    y = (rng.standard_normal(shape) * 2).astype(np.float32)
    pred = (rng.standard_normal((3, *shape)) * 2).astype(np.float32)
    pred[2, 0] = np.nan
    got = getattr(tmetrics, f"{name}_metrics")(torch.as_tensor(pred), torch.as_tensor(y))
    # mmtpu's score phase: its metric function vmapped over the configs
    want = jax.jit(jax.vmap(getattr(jmetrics, f"{name}_metrics"), in_axes=(0, None)))(
        jnp.asarray(pred), jnp.asarray(y))
    assert set(want) == set(got)
    for m in want:
        np.testing.assert_allclose(to_numpy(got[m]), np.asarray(want[m]), rtol=1e-6,
                                   atol=1e-6, err_msg=m)


def test_sweep_runs_without_jax(tmp_path):
    """With jax and mmtpu blocked, the sweep imports and runs a tiny chunk."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["mmtpu"] = None
from mmtpu_torch.data.pipeline import prepare_device_data
from mmtpu_torch.data.synthetic import synthesize_dataset
from mmtpu_torch.sweep import run_chunk
ds = synthesize_dataset("mosi", n_train=12, n_valid=5, n_test=6, vocab_size=30,
                        embed_dim=8, audio_dim=4, visual_dim=3)
prep = prepare_device_data(ds, pos_mode="shared", pos_dims=(2, 4))
cfgs = [dict(optimizer="adam", n_epochs=1, n_sentiment_epochs=1, pos_embed_dim=p,
             config_num=i) for i, p in enumerate((2, 4))]
res = run_chunk(cfgs, prep, batch_size=5, device="cpu")
assert res.n_configs == 2 and not res.diverged.any()
assert sys.modules["jax"] is None and sys.modules["mmtpu"] is None
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
