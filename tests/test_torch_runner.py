"""The port's slice as a whole against mmtpu's: ``run_experiment`` (non-e2e)
on tiny synthetic MOSI (MMB2 and MMB1), POM and IEMOCAP, fed the draws mmtpu
makes from its JAX keys; the artifact contract; the CLI; and the proof that
the port imports neither jax nor mmtpu.  (The e2e runs:
tests/test_torch_e2e.py.)

Tolerances: final loss rtol 2e-4, post embeddings and test predictions
atol 2e-4 (tests/test_train_parity.py's, for float32 in another order).
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import mmtpu.runner as jrunner
from mmtpu.config import ExperimentConfig
from mmtpu.data.pipeline import prepare_device_data
from mmtpu.data.synthetic import synthesize_dataset
from mmtpu.io.artifacts import ArtifactStore as JStore
from mmtpu.models.decoder import init_decoder as j_init_decoder
from mmtpu.models.sentiment import init_sentiment as j_init_sentiment
from mmtpu_torch import run as tcli
from mmtpu_torch import runner as trunner
from mmtpu_torch.convert import to_torch
from mmtpu_torch.io.artifacts import ArtifactStore as TStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_prep(dataset="mosi"):
    ds = synthesize_dataset(dataset, n_train=30, n_valid=10, n_test=12, vocab_size=60,
                            embed_dim=16, audio_dim=6, visual_dim=5)
    return prepare_device_data(ds, pos_embed_dim=2, pos_mode="baked")


def _perms(key, n, n_epochs, validation_curve=False):
    """The permutations a JAX fit draws from ``key``; under the validation
    curve each epoch splits the key once more (mmtpu/train/latents.py:696)."""
    out = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.permutation(sub, n)))
        if validation_curve:
            key, _ = jax.random.split(key)
    return out


class JaxDraws:
    """The draws of ``mmtpu.runner.run_experiment`` from its JAX key splits
    (runner.py:220-221; the e2e sentiment init at runner.py:246-248; the
    sentiment split at train/sentiment.py:103-104); ``validation_curve``
    as the run's flag."""

    def __init__(self, seed, validation_curve=False):
        self.validation_curve = validation_curve
        k_dec, k_e2e, k_fit, _, _, k_sent = jax.random.split(jax.random.key(seed), 6)
        self.k_dec, self.k_e2e, self.k_fit = k_dec, k_e2e, k_fit
        self.k_sinit, self.k_sfit = jax.random.split(k_sent)

    def init_decoder(self, embed_dim, audio_dim, visual_dim, unimodal, text_dim):
        return to_torch(j_init_decoder(self.k_dec, embed_dim, audio_dim, visual_dim,
                                       unimodal=unimodal, text_dim=text_dim))

    def init_e2e_sentiment(self, embed_dim, hidden_dim, n_out):
        return to_torch(j_init_sentiment(self.k_e2e, embed_dim, hidden_dim, n_out))

    def train_permutations(self, n, n_epochs):
        return _perms(self.k_fit, n, n_epochs, self.validation_curve)

    def init_sentiment(self, embed_dim, hidden_dim, n_out):
        return to_torch(j_init_sentiment(self.k_sinit, embed_dim, hidden_dim, n_out))

    def sentiment_permutations(self, n, n_epochs):
        return _perms(self.k_sfit, n, n_epochs)


def _predict(folder, n_test):
    """Test-set predictions of a run: its saved sentiment MLP on its post
    test embeddings (numpy)."""
    p = np.load(os.path.join(folder, "post", "senti.npz"))  # b1, b2, w1, w2
    x = np.load(os.path.join(folder, "post", "embed.npy"))[-n_test:]
    return np.maximum(x @ p["p2"] + p["p0"], 0) @ p["p3"] + p["p1"]


@pytest.mark.parametrize("dataset,opt,norm,extra", [
    ("mosi", "sgd", "batch_norm", {"semi_sup_idxes": "0.5"}),
    ("mosi", "adam", "layer_norm", {"early_stopping": True}),
    ("mosi", "sgd", "batch_norm", {"unimodal": True}),  # MMB1
    ("pom", "adam", "layer_norm", {}),
    ("iemocap", "sgd", "layer_norm", {}),
])
def test_run_experiment_matches_mmtpu(tmp_path, dataset, opt, norm, extra):
    cfg = ExperimentConfig(dataset=dataset, n_epochs=2, n_sentiment_epochs=3, batch_size=8,
                           e2e=False, norm=norm, optimizer=opt, lr=1e-3, sentiment_lr=1e-2,
                           config_name="slice", seed=3, **extra)
    prep = _tiny_prep(dataset)
    want = jrunner.run_experiment(cfg, out_root=str(tmp_path / "jax"), prep=prep,
                                  verbose=False)
    got = trunner.run_experiment(cfg, out_root=str(tmp_path / "torch"), prep=prep,
                                 verbose=False, device="cpu", draws=JaxDraws(cfg.seed))
    assert np.isfinite(want["final_train_loss"]) and not got["diverged"]
    np.testing.assert_allclose(got["final_train_loss"], want["final_train_loss"], rtol=2e-4)
    fj = tmp_path / "jax" / "slice" / "config_0_run_0"
    ft = tmp_path / "torch" / "slice" / "config_0_run_0"
    files = lambda f: sorted(str(p.relative_to(f)) for p in f.rglob("*") if p.is_file())
    assert files(ft) == files(fj)  # the accuracy files are written for MOSI only
    for rel in ("config.json", "embed_loss.txt", "embed_valid_loss.txt", "embed_test_loss.txt",
                "pre/embed.npy", "post/embed.npy", "post/senti.npz",
                "post/senti_train_loss.txt", "post/senti_valid_loss.txt",
                "post/test_results_before.json", "post/test_results_after.json") + (
                    ("post/test_acc_before.txt", "post/acc_after.txt")
                    if dataset == "mosi" else ()):
        assert (ft / rel).is_file(), rel
    np.testing.assert_allclose(np.load(ft / "post" / "embed.npy"),
                               np.load(fj / "post" / "embed.npy"), atol=2e-4)
    np.testing.assert_allclose(_predict(ft, 12), _predict(fj, 12), atol=2e-4)
    assert json.load(open(ft / "config.json")) == json.load(open(fj / "config.json"))
    assert set(got["sentiment"]["after"]) == set(want["sentiment"]["after"])
    if dataset == "mosi":
        assert set(got["sentiment"]["after"]) == {"mae", "accuracy", "corr", "mult_acc",
                                                  "f_score", "confusion_matrix", "class_report"}


def test_sentiment_params_load_across_packages(tmp_path):
    """senti.npz written by either package loads in the other."""
    like = j_init_sentiment(jax.random.key(0), 16, 8, 1)
    t_params = trunner.Draws(0).init_sentiment(16, 8, 1)
    TStore(str(tmp_path), "t", 0).save_sentiment_model("post", t_params)
    loaded = JStore(str(tmp_path), "t", 0).load_sentiment_model("post", like)
    for k in like:
        np.testing.assert_array_equal(np.asarray(loaded[k]), t_params[k].numpy())

    JStore(str(tmp_path), "j", 0).save_sentiment_model("post", like)
    back = TStore(str(tmp_path), "j", 0).load_sentiment_model("post", t_params)
    for k in like:
        np.testing.assert_array_equal(back[k], np.asarray(like[k]))


def test_default_draws_reproduce(tmp_path):
    cfg = ExperimentConfig(dataset="mosi", n_epochs=2, n_sentiment_epochs=2, batch_size=8,
                           e2e=False, optimizer="adam", lr=1e-3, config_name="d")
    prep = _tiny_prep()
    run = lambda: trunner.run_experiment(cfg, prep=prep, verbose=False, device="cpu",
                                         save_artifacts=False)
    a, b = run(), run()
    assert a["final_train_loss"] == b["final_train_loss"]
    assert a["sentiment"]["after"] == b["sentiment"]["after"]


def test_divergence_is_recorded(tmp_path):
    cfg = ExperimentConfig(dataset="mosi", n_epochs=2, n_sentiment_epochs=2, batch_size=8,
                           e2e=False, optimizer="sgd", lr=1e3, config_name="div")
    res = trunner.run_experiment(cfg, out_root=str(tmp_path), prep=_tiny_prep(),
                                 verbose=False, device="cpu")
    assert res["diverged"]
    assert (tmp_path / "div" / "config_0_run_0" / "post" / "test_results_after.json").is_file()


@pytest.mark.parametrize("kw", [{"time_test": True}, {"mesh": object()}])
def test_unported_options_raise(kw):
    cfg = ExperimentConfig(dataset="mosi", e2e=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trunner.run_experiment(cfg, prep=_tiny_prep(), device="cpu", **kw)


def _cfg_file(tmp_path, **kw):
    path = tmp_path / "config_5.json"
    json.dump(dict({"sentiment_hidden_size": 10, "lr": 1e-3, "sentiment_lr": 1e-2,
                    "n_epochs": 2, "n_sentiment_epochs": 2, "pos_embed_dim": 2,
                    "e2e": True, "norm": "layer_norm", "optimizer": "sgd",
                    "config_num": 5}, **kw), open(path, "w"))
    return str(path)


def test_cli_main_on_cpu(tmp_path, monkeypatch):
    """The CLI path end to end (tiny data in place of the synthetic MOSI)."""
    monkeypatch.setattr(trunner, "prepare", lambda cfg, data_dir: _tiny_prep())
    rc = tcli.main([_cfg_file(tmp_path), "mosi", "--e2e", "n", "--device", "cpu",
                    "--out_root", str(tmp_path / "out"), "--config_name", "cli", "--pallas"])
    assert rc == 0
    post = np.load(tmp_path / "out" / "cli" / "config_5_run_0" / "post" / "embed.npy")
    assert post.shape == (30 + 10 + 12, 16) and np.isfinite(post).all()


@pytest.mark.parametrize("argv,exc", [
    (["--device", "cuda", "--e2e", "n"], RuntimeError),
    (["--device", "cpu", "--mesh"], NotImplementedError),
    (["--device", "cpu", "--e2e", "n", "--profile"], NotImplementedError),
])
def test_cli_refuses(tmp_path, monkeypatch, argv, exc):
    if argv[1] == "cuda" and torch.cuda.is_available():
        pytest.skip("this case needs a machine without CUDA")
    monkeypatch.setattr(trunner, "prepare", lambda cfg, data_dir: _tiny_prep())
    with pytest.raises(exc):
        tcli.main([_cfg_file(tmp_path), "mosi", "--out_root", str(tmp_path), *argv])


def test_port_runs_without_jax(tmp_path):
    """In a process where neither jax nor mmtpu can be imported, the port
    imports and runs a tiny experiment, non-e2e and e2e."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["mmtpu"] = None
import mmtpu_torch, mmtpu_torch.runner, mmtpu_torch.run, mmtpu_torch.kernels.angular
import mmtpu_torch.kernels.decoder_update, mmtpu_torch.train.fused, mmtpu_torch.ops.joint
from mmtpu_torch.config import ExperimentConfig
from mmtpu_torch.data.pipeline import prepare_device_data
from mmtpu_torch.data.synthetic import synthesize_dataset
ds = synthesize_dataset("mosi", n_train=12, n_valid=5, n_test=6, vocab_size=30,
                        embed_dim=8, audio_dim=4, visual_dim=3)
prep = prepare_device_data(ds, pos_embed_dim=2)
for e2e in (False, True):
    cfg = ExperimentConfig(dataset="mosi", n_epochs=1, n_sentiment_epochs=1, batch_size=5,
                           e2e=e2e, config_name="nojax")
    res = mmtpu_torch.runner.run_experiment(cfg, out_root={str(tmp_path)!r}, prep=prep,
                                            verbose=False, device="cpu")
    assert res["final_train_loss"] == res["final_train_loss"]
assert sys.modules["jax"] is None and sys.modules["mmtpu"] is None
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _imported_modules(path):
    """Top-level module names of every import statement in a source file."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_sources_import_neither_jax_nor_mmtpu():
    """Every module of the port and chip_smoke.py, parsed: no import of jax
    or mmtpu anywhere, at top level or inside a function."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mmtpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 25
    bad = {p: n & {"jax", "jaxlib", "mmtpu"} for p in paths if (n := _imported_modules(p))
           & {"jax", "jaxlib", "mmtpu"}}
    assert not bad, bad
