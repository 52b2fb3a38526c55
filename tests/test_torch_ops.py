"""Parity of the port's ops, models, optimizer and reports with mmtpu.

Inputs are numpy arrays from a seed; mmtpu runs on JAX-CPU and mmtpu_torch on
torch-CPU; results are compared at the stated tolerances (float32 math in a
different summation order: rtol 1e-5 for likelihoods, atol 1e-5 for the
decoder, rtol 1e-6 for one optimizer step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmtpu.eval import report as jreport
from mmtpu.models import decoder as jdec
from mmtpu.ops import gaussian as jgauss
from mmtpu.ops import wordprob as jwp
from mmtpu.train import optim as jopt
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.eval import report as treport
from mmtpu_torch.models import decoder as tdec
from mmtpu_torch.models import sentiment as tsent
from mmtpu_torch.ops import gaussian as tgauss
from mmtpu_torch.ops import wordprob as twp
from mmtpu_torch.train import optim as topt


def _t(x):
    return torch.tensor(np.array(x))


def _word_inputs(rng, b=6, L=7, V=40, D=12):
    lat = rng.standard_normal((b, D)).astype(np.float32)
    vocab = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=(b, L))
    ww = rng.random((b, L)).astype(np.float32)
    mask = (rng.random((b, L)) < 0.8).astype(np.float32)
    return lat, vocab, ww, vocab[ids], mask


def test_angular_partition_matches_mmtpu(rng):
    lat, vocab, *_ = _word_inputs(rng)
    want = jwp.angular_partition(jnp.asarray(lat), jnp.asarray(vocab))
    got = twp.angular_partition(_t(lat), _t(vocab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("metric", ["angular", "dot_prod"])
def test_word_logprob_matches_mmtpu(rng, metric):
    lat, vocab, ww, se, mask = _word_inputs(rng)
    if metric == "dot_prod":  # the reference normalizes the vocab for dot_prod
        vocab = vocab / np.linalg.norm(vocab, axis=-1, keepdims=True)
        se = se / np.linalg.norm(se, axis=-1, keepdims=True)
    jfn = jwp.word_logprob_angular if metric == "angular" else jwp.word_logprob_dot_prod
    tfn = twp.word_logprob_angular if metric == "angular" else twp.word_logprob_dot_prod
    want = jfn(*(jnp.asarray(x) for x in (lat, vocab, ww, se, mask)))
    got = tfn(*(_t(x) for x in (lat, vocab, ww, se, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_word_logprob_default_partition_is_kernel_wrapper(rng, monkeypatch):
    """partition_fn=None goes through the K1 wrapper (its plain twin on CPU)."""
    import mmtpu_torch.kernels.angular as K

    calls = []
    monkeypatch.setattr(K, "angular_partition",
                        lambda l, v: calls.append(l.shape) or twp.angular_partition(l, v))
    lat, vocab, ww, se, mask = _word_inputs(rng)
    twp.word_logprob_angular(*(_t(x) for x in (lat, vocab, ww, se, mask)))
    assert calls == [torch.Size(lat.shape)]


@pytest.mark.parametrize("mask_kind", ["token", "feature"])
def test_gaussian_forms_match_mmtpu(rng, mask_kind):
    b, L, F = 5, 6, 4
    mu = rng.standard_normal((b, F)).astype(np.float32)
    sigma = np.exp(0.3 * rng.standard_normal((b, F))).astype(np.float32)
    x = rng.standard_normal((b, L, F)).astype(np.float32)
    shape = (b, L) if mask_kind == "token" else (b, L, F)
    mask = (rng.random(shape) < 0.8).astype(np.float32)

    want = jgauss.gaussian_logpdf_masked(*(jnp.asarray(a) for a in (mu, sigma, x, mask)))
    got = tgauss.gaussian_logpdf_masked(*(_t(a) for a in (mu, sigma, x, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    j_stats = jgauss.gaussian_suff_stats(jnp.asarray(x), jnp.asarray(mask))
    t_stats = tgauss.gaussian_suff_stats(_t(x), _t(mask))
    for js, ts in zip(j_stats, t_stats):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    want_s = jgauss.gaussian_logpdf_suffstats(jnp.asarray(mu), jnp.asarray(sigma), *j_stats)
    got_s = tgauss.gaussian_logpdf_suffstats(_t(mu), _t(sigma), *t_stats)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), got.numpy(), rtol=1e-5)


@pytest.mark.parametrize("norm", [None, "layer_norm", "batch_norm"])
@pytest.mark.parametrize("unimodal", [False, True])
def test_apply_decoder_matches_mmtpu(rng, norm, unimodal):
    D, A, Vi, b = 8, 5, 3, 7
    params_j = jdec.init_decoder(jax.random.key(3), D, A, Vi, unimodal=unimodal)
    params_j["norm"] = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(D), jnp.float32),
                        "bias": jnp.asarray(0.1 * rng.standard_normal(D), jnp.float32)}
    lat = rng.standard_normal((b, D)).astype(np.float32)
    row_valid = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)
    code = jdec.NORM_CODES[norm]
    want = jdec.apply_decoder(params_j, jnp.asarray(lat), code, jnp.asarray(row_valid))
    got = tdec.apply_decoder(to_torch(params_j), _t(lat), tdec.NORM_CODES[norm], _t(row_valid))
    assert list(got) == list(want)
    for h in want:
        for k in ("mu", "sigma"):
            np.testing.assert_allclose(got[h][k].numpy(), np.asarray(want[h][k]), atol=1e-5)


def test_init_shapes_and_law():
    """The port's init draws mmtpu's shapes, with the torch-Linear bound."""
    gen = torch.Generator().manual_seed(0)
    dec = tdec.init_decoder(gen, 300, 74, 47)
    want = jdec.init_decoder(jax.random.key(0), 300, 74, 47)
    assert jax.tree.structure(to_numpy(dec)) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for h, p in dec["heads"].items():
        assert p["w_mu"].shape == want["heads"][h]["w_mu"].shape
        assert float(p["w_mu"].abs().max()) <= 1 / np.sqrt(300)
    senti = tsent.init_sentiment(gen, 300, 150, 1)
    assert {k: tuple(v.shape) for k, v in senti.items()} == {
        "w1": (300, 150), "b1": (150,), "w2": (150, 1), "b2": (1,)}
    assert tsent.apply_sentiment(senti, torch.zeros(4, 300)).shape == (4,)


def _opt_inputs(rng):
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2)}}
    draw = lambda f: jax.tree.map(lambda s: f(s).astype(np.float32), shapes,
                                  is_leaf=lambda x: isinstance(x, tuple))
    params = draw(lambda s: rng.standard_normal(s))
    grads = draw(lambda s: rng.standard_normal(s))
    m = draw(lambda s: 0.1 * rng.standard_normal(s))
    v = draw(lambda s: 0.1 * rng.random(s))
    return params, grads, m, v


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("active", [True, False])
def test_opt_update_matches_mmtpu(rng, kind, active):
    params, grads, m, v = _opt_inputs(rng)
    if kind == "sgd":
        j_state = jopt.OptState(m=None, v=None, count=jnp.int32(3))
    else:
        j_state = jopt.OptState(m=jax.tree.map(jnp.asarray, m),
                                v=jax.tree.map(jnp.asarray, v), count=jnp.int32(3))
    jp = jax.tree.map(jnp.asarray, params)
    jg = jax.tree.map(jnp.asarray, grads)
    want_p, want_s = jopt.opt_update(jp, jg, j_state, jnp.float32(1e-2),
                                     jopt.OPT_CODES[kind], jnp.asarray(active), kind=kind)
    lr = torch.tensor(1e-2, dtype=torch.float32)
    got_p, got_s = topt.opt_update(to_torch(params), to_torch(grads), to_torch(j_state), lr,
                                   topt.OPT_CODES[kind], active, kind=kind)
    close = lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
    jax.tree.map(close, to_numpy(got_p), want_p)
    assert int(got_s.count) == int(want_s.count)
    if kind == "adam":
        jax.tree.map(close, to_numpy(got_s.m), want_s.m)
        jax.tree.map(close, to_numpy(got_s.v), want_s.v)
    else:
        assert got_s.m is None and got_s.v is None


def test_opt_update_code_selects_kind(rng):
    """Without a static kind, opt_code picks the law (mmtpu's branchless path)."""
    params, grads, _, _ = _opt_inputs(rng)
    p, g = to_torch(params), to_torch(grads)
    state = topt.init_opt_state(p)
    by_code, _ = topt.opt_update(p, g, state, 1e-2, topt.OPT_ADAM)
    by_kind, _ = topt.opt_update(p, g, state, 1e-2, None, kind="adam")
    jax.tree.map(np.testing.assert_array_equal, to_numpy(by_code), to_numpy(by_kind))


@pytest.mark.parametrize("dataset", ["mosi", "iemocap", "pom"])
def test_reports_match_mmtpu(rng, dataset):
    n = 40
    if dataset == "mosi":
        y = np.clip(rng.standard_normal(n) * 1.5, -3, 3).astype(np.float32)
        pred = (y + 0.7 * rng.standard_normal(n)).astype(np.float32)
    elif dataset == "iemocap":
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
        pred = rng.standard_normal((n, 2)).astype(np.float32)
    else:
        y = (rng.standard_normal((n, 17)) + 4).astype(np.float32)
        pred = (y + 0.5 * rng.standard_normal((n, 17))).astype(np.float32)
    fn = {"mosi": "full_loss", "iemocap": "iemocap_loss", "pom": "pom_loss"}[dataset]
    want = getattr(jreport, fn)(pred, y, verbose=False)
    got = getattr(treport, fn)(pred, y, verbose=False)
    assert set(got) == set(want)
    for k in want:
        if k == "f_score":
            # rounded to 5 decimals after a float32 sum taken in another order:
            # an ulp can move it by one rounding step (the unrounded value is
            # held to rtol 1e-6 in test_weighted_f1_matches_mmtpu)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-5)
        elif k in ("mae", "corr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("with_nan", [False, True])
def test_weighted_f1_matches_mmtpu(rng, with_nan):
    from mmtpu.eval.metrics import weighted_f1 as j_f1
    from mmtpu_torch.eval.metrics import weighted_f1 as t_f1

    for _ in range(5):
        y = (rng.standard_normal(50) * 2).astype(np.float32)
        pred = (y + rng.standard_normal(50)).astype(np.float32)
        if with_nan:  # a diverged run's predictions
            pred[rng.random(50) < 0.3] = np.nan
        for a, b in ((pred, y), (y, pred)):
            np.testing.assert_allclose(t_f1(a, b), float(j_f1(a, b)), rtol=1e-6)
