"""The port's e2e slice against mmtpu's: its own config/data copies, the e2e
fit (dense and fused, SGD and Adam, semi-supervised), ``run_experiment``
with ``e2e=True`` fed mmtpu's draws (MOSI MMB2 and MMB1, POM, IEMOCAP), and
the CLI with ``--e2e y``.

Tolerances are the repo's: losses rtol 2e-4; embeddings, decoder, sentiment
parameters and predictions atol 2e-4 (float32 summed in another order,
compounded over the fit's steps).  The data copies must agree bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmtpu.config as jconfig
import mmtpu.data as jdata
import mmtpu.runner as jrunner
import mmtpu_torch.config as tconfig
import mmtpu_torch.data as tdata
from mmtpu.models.decoder import NORM_CODES, init_decoder
from mmtpu.models.sentiment import init_sentiment
from mmtpu.train import e2e as je2e
from mmtpu.train.optim import OPT_CODES
from mmtpu_torch import run as tcli
from mmtpu_torch import runner as trunner
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.train import e2e as te2e
from mmtpu_torch.train import latents as tl
from tests.test_torch_runner import JaxDraws, _cfg_file, _perms, _predict, _tiny_prep


def test_grid_matches_mmtpu(tmp_path):
    assert tconfig.GRID_PARAMS == jconfig.GRID_PARAMS
    for seed in (0, 3, None):
        assert tconfig.make_grid(seed) == jconfig.make_grid(seed)
    assert tconfig.write_grid(str(tmp_path / "t")) == jconfig.write_grid(str(tmp_path / "j"))
    for name in ("index.csv", "config_0.json", "config_511.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    raw = dict(jconfig.make_grid()[7], sentiment_epochs=3)
    assert (tconfig.ExperimentConfig.from_dict(raw, e2e="n", batch_size=16).to_dict()
            == jconfig.ExperimentConfig.from_dict(raw, e2e="n", batch_size=16).to_dict())


def _assert_same_prep(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, dict):
            assert g.keys() == w.keys(), f.name
            for k in w:
                if isinstance(w[k], dict):
                    assert g[k].keys() == w[k].keys()
                    for a in w[k]:
                        assert g[k][a].dtype == w[k][a].dtype, (f.name, k, a)
                        np.testing.assert_array_equal(g[k][a], w[k][a], err_msg=f"{k}/{a}")
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{f.name}/{k}")
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("name,kw", [
    ("mosi", dict(pos_embed_dim=2)),
    ("mosi", dict(pos_embed_dim=4, pos_bug_parity=True, suff_stats=False)),
    ("mosi", dict(word_sim_metric="dot_prod", pos_mode="shared", pos_dims=(2, 4))),
    ("pom", dict(pos_embed_dim=2)),
    ("iemocap", dict(pos_embed_dim=0, max_text_len=4)),
])
def test_prepared_data_matches_mmtpu(name, kw):
    """synthesize_dataset and prepare_device_data give mmtpu's arrays bit for bit."""
    size = dict(n_train=14, n_valid=5, n_test=6, vocab_size=40, embed_dim=8, audio_dim=5,
                visual_dim=4, seq_len=7, seed=2)
    want = jdata.prepare_device_data(jdata.synthesize_dataset(name, **size), **kw)
    got = tdata.prepare_device_data(tdata.synthesize_dataset(name, **size), **kw)
    _assert_same_prep(got, want)


def test_load_dataset_fallback_matches_mmtpu(tmp_path):
    """Without the data blobs both registries fall back to the same
    full-size synthetic MOSI (1284/229/686, vocab 3016 x 300)."""
    want = jdata.load_dataset("mosi", data_dir=str(tmp_path))
    got = tdata.load_dataset("mosi", data_dir=str(tmp_path))
    assert got["synthetic"] and want["synthetic"]
    assert got["fallback_reason"] == want["fallback_reason"]
    _assert_same_prep(tdata.prepare_device_data(got, pos_embed_dim=2),
                      jdata.prepare_device_data(want, pos_embed_dim=2))


def _e2e_both(rng, kind, fused, hp_extra=None, n_epochs=3, n_epochs_max=None,
              spec_extra=None):
    """mmtpu's fit_e2e and the port's on the same inputs and draws.
    ``spec_extra`` with ``valid_every`` also passes the valid split (and
    builds JAX's validation-curve key chain for the permutations)."""
    n_epochs_max = n_epochs_max or n_epochs
    ds = jdata.synthesize_dataset("mosi", n_train=22, n_valid=6, n_test=6, vocab_size=60,
                                  embed_dim=16, audio_dim=7, visual_dim=5, seq_len=6,
                                  seed=int(rng.integers(1e6)))
    prep = jdata.prepare_device_data(ds, pos_embed_dim=2)
    dec = init_decoder(jax.random.key(3), prep.embed_dim, prep.audio_dim, prep.visual_dim,
                       unimodal=False)
    sen = init_sentiment(jax.random.key(5), prep.embed_dim, 12, 1)
    n = prep.sif_init["train"].shape[0]
    labels = rng.standard_normal(n).astype(np.float32)
    smask = (rng.random(n) > 0.4).astype(np.float32)
    hp = {"lr": 5e-3, "word_loss_weight": 0.002, "likelihood_weight": 0.7,
          "opt_code": OPT_CODES[kind], "norm_code": NORM_CODES["layer_norm"],
          "n_epochs": n_epochs, **(hp_extra or {})}
    j_hp = {k: jnp.asarray(v, jnp.int32 if isinstance(v, int) else jnp.float32)
            for k, v in hp.items()}
    t_hp = {k: (v if isinstance(v, int) else torch.tensor(v)) for k, v in hp.items()}
    args = dict(n_epochs_max=n_epochs_max, batch_size=8, unimodal=False, opt_kind=kind,
                fused_dec_update=fused, **(spec_extra or {}))
    curve = args.get("valid_every", 0) > 0
    j_valid = t_valid = None
    if curve:
        j_valid = (jnp.asarray(prep.sif_init["valid"]),
                   {k: jnp.asarray(v) for k, v in prep.splits["valid"].items()})
        t_valid = (torch.tensor(prep.sif_init["valid"]),
                   tl.train_view(to_torch(prep.splits["valid"])))
    key = jax.random.key(0)
    data = {k: jnp.asarray(v) for k, v in prep.splits["train"].items()}
    want = jax.jit(lambda: je2e.fit_e2e(
        key, jnp.asarray(prep.sif_init["train"]), dec, sen, data, jnp.asarray(labels),
        jnp.asarray(prep.vocab_embeddings), j_hp, je2e.E2EFitSpec(**args),
        senti_mask=jnp.asarray(smask), validation=j_valid))()
    got = te2e.fit_e2e(torch.tensor(prep.sif_init["train"]), to_torch(dec), to_torch(sen),
                       tl.train_view(to_torch(prep.splits["train"])), torch.tensor(labels),
                       torch.tensor(prep.vocab_embeddings), t_hp, te2e.E2EFitSpec(**args),
                       senti_mask=torch.tensor(smask),
                       perms=_perms(key, n, n_epochs_max, validation_curve=curve),
                       validation=t_valid)
    return dec, want, got


def _assert_fit_close(want, got):
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    for g, w in ((got[1], want[1]), (got[2], want[2])):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-4),
                     to_numpy(g), w)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_fit_e2e_matches_mmtpu(rng, kind, fused):
    """Dense and fused (K2's plain version here, mmtpu's kernel in interpret
    mode there) joint fits with a semi-supervised mask."""
    _, want, got = _e2e_both(rng, kind, fused)
    _assert_fit_close(want, got)


@pytest.mark.parametrize("fused", [False, True])
def test_fit_e2e_train_heads_gate(rng, fused):
    """train_heads = 0 freezes the heads bit for bit while the norm, the
    embeddings and the sentiment MLP train, as in mmtpu."""
    dec, want, got = _e2e_both(rng, "adam", fused, hp_extra={"train_heads": 0.0}, n_epochs=2)
    _assert_fit_close(want, got)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                 to_numpy(got[1]["heads"]), dec["heads"])
    assert not np.array_equal(got[1]["norm"]["scale"].numpy(), np.asarray(dec["norm"]["scale"]))


@pytest.mark.parametrize("kw", [{"batch_shard_axis": "data"}])
def test_fit_e2e_unported_options_raise(kw):
    spec = te2e.E2EFitSpec(n_epochs_max=1, batch_size=4, unimodal=False, opt_kind="sgd", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te2e.fit_e2e(torch.zeros(4, 3), {}, {}, {}, torch.zeros(4), torch.zeros(5, 3), {}, spec)


@pytest.mark.parametrize("dataset,opt,norm,extra", [
    ("mosi", "sgd", "batch_norm", {"semi_sup_idxes": "0.5"}),
    ("mosi", "adam", "layer_norm", {"freeze_weights": True}),
    ("mosi", "adam", "layer_norm", {"unimodal": True}),  # MMB1
    ("pom", "sgd", "batch_norm", {}),
    ("iemocap", "adam", "layer_norm", {}),
])
def test_run_experiment_e2e_matches_mmtpu(tmp_path, dataset, opt, norm, extra):
    cfg = jconfig.ExperimentConfig(dataset=dataset, n_epochs=2, n_sentiment_epochs=3,
                                   batch_size=8, e2e=True, norm=norm, optimizer=opt, lr=1e-3,
                                   sentiment_lr=1e-2, likelihood_weight=0.3,
                                   config_name="e2e", seed=4, **extra)
    prep = _tiny_prep(dataset)
    want = jrunner.run_experiment(cfg, out_root=str(tmp_path / "jax"), prep=prep,
                                  verbose=False)
    got = trunner.run_experiment(tconfig.ExperimentConfig(**cfg.to_dict()),
                                 out_root=str(tmp_path / "torch"), prep=prep, verbose=False,
                                 device="cpu", draws=JaxDraws(cfg.seed))
    assert np.isfinite(want["final_train_loss"]) and not got["diverged"]
    np.testing.assert_allclose(got["final_train_loss"], want["final_train_loss"], rtol=2e-4)
    fj = tmp_path / "jax" / "e2e" / "config_0_run_0"
    ft = tmp_path / "torch" / "e2e" / "config_0_run_0"
    np.testing.assert_allclose(np.loadtxt(ft / "embed_loss.txt"),
                               np.loadtxt(fj / "embed_loss.txt"), rtol=2e-4)
    np.testing.assert_allclose(np.load(ft / "post" / "embed.npy"),
                               np.load(fj / "post" / "embed.npy"), atol=2e-4)
    np.testing.assert_allclose(_predict(ft, 12), _predict(fj, 12), atol=2e-4)


def test_cli_e2e_on_cpu(tmp_path, monkeypatch):
    """``--e2e y`` runs through the CLI (tiny data in place of the synthetic MOSI)."""
    monkeypatch.setattr(trunner, "prepare", lambda cfg, data_dir: _tiny_prep())
    rc = tcli.main([_cfg_file(tmp_path), "mosi", "--e2e", "y", "--device", "cpu",
                    "--out_root", str(tmp_path / "out"), "--config_name", "cli"])
    assert rc == 0
    folder = tmp_path / "out" / "cli" / "config_5_run_0"
    post = np.load(folder / "post" / "embed.npy")
    assert post.shape == (30 + 10 + 12, 16) and np.isfinite(post).all()
    assert np.isfinite(np.loadtxt(folder / "embed_loss.txt")).all()
    assert (folder / "post" / "test_results_after.json").is_file()


@pytest.mark.parametrize("word_loss_weight", [None, 0.3])
def test_joint_log_prob_matches_mmtpu(rng, word_loss_weight):
    from mmtpu.ops.joint import joint_log_prob as j_joint
    from mmtpu_torch.ops.joint import joint_log_prob as t_joint

    b, l = 4, 5
    heads, data, masks = {}, {}, {}
    for name, f in (("audio", 3), ("textvisual", 6)):
        heads[name] = {"mu": rng.standard_normal((b, f)).astype(np.float32),
                       "sigma": np.exp(0.3 * rng.standard_normal((b, f))).astype(np.float32)}
        data[name] = rng.standard_normal((b, l, f)).astype(np.float32)
        masks[name] = (rng.random((b, l, f)) < 0.8).astype(np.float32)
    word = rng.standard_normal(b).astype(np.float32)
    want = j_joint(jax.tree.map(jnp.asarray, heads), jax.tree.map(jnp.asarray, data),
                   jax.tree.map(jnp.asarray, masks), jnp.asarray(word), word_loss_weight)
    got = t_joint(to_torch(heads), to_torch(data), to_torch(masks), torch.tensor(word),
                  word_loss_weight)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
