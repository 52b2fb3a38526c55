"""The recursive validation curve, checkpoints and the resumable fit in the
port, and the runner and CLI with ``validation_curve``, ``lazy_adam`` and
``resume_dir``.

Against mmtpu: the validation curves of the latent and e2e fits (NaN
positions included) and whole ``run_experiment`` runs with the curve and lazy
Adam, at the repo's tolerances (losses rtol 2e-4, embeddings and predictions
atol 2e-4).  The port's chunked and resumed fits are held to its monolithic
fit bit for bit, as mmtpu's own are (tests/test_aux.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import mmtpu.runner as jrunner
from mmtpu.config import ExperimentConfig
from mmtpu.models.decoder import NORM_CODES, init_decoder
from mmtpu.train.optim import OPT_CODES
from mmtpu_torch import run as tcli
from mmtpu_torch import runner as trunner
from mmtpu_torch.convert import to_torch
from mmtpu_torch.io.checkpoint import Checkpointer, load_pytree, save_pytree
from mmtpu_torch.train import latents as tl
from mmtpu_torch.train.chunked import fit_latents_checkpointed
from mmtpu_torch.tree import tree_leaves
from tests.test_torch_e2e import _assert_fit_close, _e2e_both
from tests.test_torch_fit import A, D, N, VIS, _data
from tests.test_torch_lazy import assert_latent_fits_close, fit_latents_both
from tests.test_torch_runner import JaxDraws, _cfg_file, _predict, _tiny_prep


def _assert_curve(got, want, sampled):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (len(sampled) + 1,)
    assert (np.isfinite(got[:-1]) == np.array(sampled)).all() and np.isfinite(got[-1])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)  # NaN where NaN


def test_fit_latents_validation_curve_matches_mmtpu(rng):
    """Samples at epochs 0 and 2 (valid_every 2), NaN at 1 and 3 and at the
    inactive epoch 4, the final sample last; the inner refit runs two blocks
    of 10 (batch 5 x 2) over the 13 valid rows."""
    inp, valid = _data(rng, stats=True), _data(rng, stats=True)
    want, got = fit_latents_both(inp, n_epochs=4, valid=valid, n_epochs_max=5, batch_size=5,
                                 train_decoder=True, unimodal=False, opt_kind="sgd",
                                 valid_every=2, valid_batch_mult=2)
    assert len(got) == 4
    assert_latent_fits_close(want, got)
    _assert_curve(got[3], want[3], [True, False, True, False, False])


def test_fit_e2e_validation_curve_matches_mmtpu(rng):
    """valid_every 1: samples at the active epochs 0 and 1, NaN at the
    inactive epoch 2, the final sample last."""
    _, want, got = _e2e_both(rng, "sgd", False, n_epochs=2, n_epochs_max=3,
                             spec_extra={"valid_every": 1, "valid_batch_mult": 1})
    assert len(got) == 5
    _assert_fit_close(want, got)
    _assert_curve(got[4], want[4], [True, True, False])


def test_checkpoint_round_trip(tmp_path):
    """A tree of float32, int32 and uint8 tensors comes back bit for bit, in
    its dtypes; the checkpointer keeps the newest two steps and its manifest."""
    tree = {"embed": torch.randn(5, 3), "dec": {"w": torch.randn(3, 2), "b": torch.randn(2)},
            "opt": {"count": torch.tensor(4, dtype=torch.int32)},
            "generator": torch.Generator().manual_seed(3).get_state()}
    like = {"embed": torch.zeros(5, 3), "dec": {"w": torch.zeros(3, 2), "b": torch.zeros(2)},
            "opt": {"count": torch.zeros((), dtype=torch.int32)},
            "generator": torch.zeros_like(tree["generator"])}
    save_pytree(str(tmp_path / "t.npz"), tree)
    back = load_pytree(str(tmp_path / "t.npz"), like)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert json.load(open(tmp_path / "t.npz.tree"))["opt"] == {"count": "torch.int32 []"}
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "t.npz"), {"embed": like["embed"]})

    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.restore(like) == (None, None, None) and ck.latest_step() is None
    for step in (1, 2, 3):
        ck.save(step, tree, extra={"step": step})
    assert sorted(ck.steps()) == [2, 3] and ck.latest_step() == 3
    back, step, extra = ck.restore(like)
    assert step == 3 and extra == {"step": 3}
    assert torch.equal(back["dec"]["w"], tree["dec"]["w"])
    assert torch.equal(ck.restore(like, step=2)[0]["embed"], tree["embed"])


def _latent_fit_args(rng):
    inp = _data(rng, stats=True)
    dec = to_torch(init_decoder(jax.random.key(1), D, A, VIS, unimodal=False))
    hp = {"lr": torch.tensor(1e-3), "word_loss_weight": torch.tensor(0.002),
          "opt_code": OPT_CODES["adam"], "norm_code": NORM_CODES["layer_norm"], "n_epochs": 7}
    spec = tl.LatentFitSpec(n_epochs_max=7, batch_size=5, train_decoder=True, unimodal=False,
                            opt_kind="adam")
    return (torch.tensor(inp["init"]), dec, tl.train_view(to_torch(inp["data"])),
            torch.tensor(inp["vocab"])), hp, spec


def _assert_same_fit(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])))


@pytest.mark.parametrize("draws", ["perms", "generator"])
def test_chunked_fit_matches_monolithic_and_resumes(rng, tmp_path, capsys, draws):
    """Segments of 3 epochs (and a tail of 1) equal the monolithic fit bit for
    bit; a run killed after its first checkpoint resumes at epoch 3 (with the
    generator's state restored when it draws the shuffles) and still equals
    it; a checkpoint of another fit (another lr) is refused and that fit
    starts at epoch 0."""
    args, hp, spec = _latent_fit_args(rng)
    perms = [np.random.default_rng(e).permutation(N) for e in range(7)]

    def shuffles():
        if draws == "perms":
            return {"perms": perms}
        return {"generator": torch.Generator().manual_seed(5)}

    mono = tl.fit_latents(*args, hp, spec, **shuffles())
    _assert_same_fit(fit_latents_checkpointed(*args, hp, spec, segment_epochs=3, **shuffles()),
                     mono)

    ck = Checkpointer(str(tmp_path / "ck"))
    save = ck.save

    def save_then_die(step, tree, extra=None):
        save(step, tree, extra)
        raise KeyboardInterrupt

    ck.save = save_then_die
    with pytest.raises(KeyboardInterrupt):
        fit_latents_checkpointed(*args, hp, spec, checkpointer=ck, segment_epochs=3,
                                 **shuffles())
    ck.save = save
    assert ck.latest_step() == 3
    resumed = fit_latents_checkpointed(*args, hp, spec, checkpointer=ck, segment_epochs=3,
                                       verbose=True, **shuffles())
    assert "resuming at epoch 3/7" in capsys.readouterr().out
    _assert_same_fit(resumed, mono)

    hp2 = dict(hp, lr=torch.tensor(5e-4))
    other = fit_latents_checkpointed(*args, hp2, spec, checkpointer=ck, segment_epochs=3,
                                     verbose=True, **shuffles())
    assert "fingerprint mismatch" in capsys.readouterr().out
    _assert_same_fit(other, tl.fit_latents(*args, hp2, spec, **shuffles()))


def test_chunked_fit_refuses_the_validation_curve(rng):
    args, hp, spec = _latent_fit_args(rng)
    with pytest.raises(ValueError, match="monolithic"):
        fit_latents_checkpointed(*args, hp, tl.LatentFitSpec(
            n_epochs_max=2, batch_size=5, train_decoder=True, unimodal=False, valid_every=1))


@pytest.mark.parametrize("e2e", [False, True])
def test_run_experiment_curve_and_lazy_adam_match_mmtpu(tmp_path, e2e):
    """``validation_curve=True, lazy_adam=True`` on an Adam config: the curve
    (a sample at epoch 0 and the final one) is ``embed_valid_loss``; the
    port is fed JAX's validation-curve draws."""
    cfg = ExperimentConfig(dataset="mosi", n_epochs=2, n_sentiment_epochs=3, batch_size=8,
                           e2e=e2e, norm="layer_norm", optimizer="adam", lr=1e-3,
                           sentiment_lr=1e-2, likelihood_weight=0.3, config_name="opt", seed=5)
    prep = _tiny_prep()
    kw = dict(prep=prep, verbose=False, validation_curve=True, lazy_adam=True)
    want = jrunner.run_experiment(cfg, out_root=str(tmp_path / "jax"), **kw)
    got = trunner.run_experiment(cfg, out_root=str(tmp_path / "torch"), device="cpu",
                                 draws=JaxDraws(cfg.seed, validation_curve=True), **kw)
    assert np.isfinite(want["final_train_loss"]) and not got["diverged"]
    np.testing.assert_allclose(got["final_train_loss"], want["final_train_loss"], rtol=2e-4)
    fj = tmp_path / "jax" / "opt" / "config_0_run_0"
    ft = tmp_path / "torch" / "opt" / "config_0_run_0"
    for name in ("embed_loss.txt", "embed_valid_loss.txt", "embed_test_loss.txt"):
        np.testing.assert_allclose(np.loadtxt(ft / name), np.loadtxt(fj / name), rtol=2e-4)
    assert np.loadtxt(ft / "embed_valid_loss.txt").shape == (2,)
    np.testing.assert_allclose(np.load(ft / "post" / "embed.npy"),
                               np.load(fj / "post" / "embed.npy"), atol=2e-4)
    np.testing.assert_allclose(_predict(ft, 12), _predict(fj, 12), atol=2e-4)


def test_run_experiment_resume_dir(tmp_path):
    """``resume_dir`` runs the checkpointed training fit: the run equals one
    without it bit for bit and leaves its checkpoint; an e2e config refuses
    it, as mmtpu's runner does."""
    cfg = trunner.ExperimentConfig(dataset="mosi", n_epochs=2, n_sentiment_epochs=2,
                                   batch_size=8, e2e=False, optimizer="adam", lr=1e-3,
                                   config_name="res")
    prep = _tiny_prep()
    run = lambda root, **kw: trunner.run_experiment(cfg, out_root=str(tmp_path / root),
                                                    prep=prep, verbose=False, device="cpu", **kw)
    plain, resumable = run("a"), run("b", resume_dir=str(tmp_path / "ck"))
    assert plain["final_train_loss"] == resumable["final_train_loss"]
    post = lambda root: np.load(tmp_path / root / "res" / "config_0_run_0" / "post" / "embed.npy")
    np.testing.assert_array_equal(post("a"), post("b"))
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 2
    with pytest.raises(ValueError, match="non-e2e"):
        trunner.run_experiment(trunner.ExperimentConfig(dataset="mosi", e2e=True), prep=prep,
                               device="cpu", resume_dir=str(tmp_path / "ck2"))


@pytest.mark.parametrize("flags", [["--lazy_adam", "--validation_curve"],
                                   ["--resume_dir", "CK", "--n_runs", "2"]])
def test_cli_fit_options_on_cpu(tmp_path, monkeypatch, flags):
    """The CLI's fit options on tiny data: the curve's two samples are
    written; ``--resume_dir`` with two runs checkpoints ``CK_run0`` and
    ``CK_run1``."""
    monkeypatch.setattr(trunner, "prepare", lambda cfg, data_dir: _tiny_prep())
    flags = [str(tmp_path / f) if f == "CK" else f for f in flags]
    rc = tcli.main([_cfg_file(tmp_path, optimizer="adam"), "mosi", "--e2e", "n", "--device",
                    "cpu", "--out_root", str(tmp_path / "out"), "--config_name", "cli", *flags])
    assert rc == 0
    folder = tmp_path / "out" / "cli" / "config_5_run_0"
    curve = np.loadtxt(folder / "embed_valid_loss.txt")
    assert np.isfinite(curve).all()
    if "--validation_curve" in flags:
        assert curve.shape == (2,)
    else:
        for r in (0, 1):
            assert json.load(open(tmp_path / f"CK_run{r}" / "manifest.json"))["latest_step"] == 2
        assert not os.path.exists(tmp_path / "CK")
