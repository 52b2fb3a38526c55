"""The port's latent fit against mmtpu's, step for step.

Same numpy data (13 utterances, batch 5: the last batch is padded), the same
decoder weights, and the permutations JAX draws fed into the port's fit.
Losses rtol 2e-4 and embeddings atol 2e-4, the tolerances of
tests/test_train_parity.py (float32 in another summation order, compounded
over 9 optimizer steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmtpu.models.decoder import NORM_CODES, init_decoder
from mmtpu.train import latents as jl
from mmtpu.train.optim import OPT_CODES
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.train import latents as tl

N, L, V, D, A, VIS = 13, 5, 25, 8, 4, 3


def _data(rng, stats: bool, d: int = D) -> dict:
    vocab = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(1, V, size=(N, L))
    ids[rng.random((N, L)) < 0.2] = 0
    vw = (rng.random(V) * 0.9 + 0.05).astype(np.float32)
    tok = (ids != 0).astype(np.float32)
    d = {
        "text_ids": ids.astype(np.int32), "text_weights": vw[ids], "text_mask": tok,
        "text_gauss": vocab[ids], "text_gauss_mask": tok,
        "audio": rng.standard_normal((N, L, A)).astype(np.float32),
        "audio_mask": (rng.random((N, L, A)) < 0.85).astype(np.float32),
        "visual": rng.standard_normal((N, L, VIS)).astype(np.float32),
        "visual_mask": (rng.random((N, L, VIS)) < 0.85).astype(np.float32),
    }
    if stats:
        for s in ("audio", "visual", "text_gauss"):
            x, m = d[s], d[f"{s}_mask"]
            m3 = m[:, :, None] if m.ndim == 2 else m
            d[f"{s}_s0"] = np.broadcast_to(m3, x.shape).sum(1).astype(np.float32)
            d[f"{s}_s1"] = (m3 * x).sum(1).astype(np.float32)
            d[f"{s}_s2"] = (m3 * x * x).sum(1).astype(np.float32)
    init = rng.standard_normal((N, vocab.shape[1])).astype(np.float32)
    return {"data": d, "vocab": vocab, "init": init}


def _jax_perms(key, n_epochs):
    """The permutations mmtpu's fit draws from ``key`` (latents.py:501-505)."""
    perms = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(sub, N)))
    return perms


def _run_both(inp, kind, norm, train_decoder, shuffle, bsz, n_epochs=3, n_epochs_max=3,
              lr=1e-2):
    dec = init_decoder(jax.random.key(1), inp["vocab"].shape[1], A, VIS, unimodal=False)
    j_hp = {"lr": jnp.float32(lr), "word_loss_weight": jnp.float32(0.002),
            "opt_code": jnp.int32(OPT_CODES[kind]), "norm_code": jnp.int32(NORM_CODES[norm]),
            "n_epochs": jnp.int32(n_epochs)}
    t_hp = {"lr": torch.tensor(lr), "word_loss_weight": torch.tensor(0.002),
            "opt_code": OPT_CODES[kind], "norm_code": NORM_CODES[norm], "n_epochs": n_epochs}
    spec_args = dict(n_epochs_max=n_epochs_max, batch_size=bsz, train_decoder=train_decoder,
                     unimodal=False, shuffle=shuffle, opt_kind=kind)
    key = jax.random.key(7)
    data_j = jl.train_view({k: jnp.asarray(v) for k, v in inp["data"].items()})
    want = jax.jit(jl.fit_latents, static_argnums=(6,))(
        key, jnp.asarray(inp["init"]), dec, data_j, jnp.asarray(inp["vocab"]), j_hp,
        jl.LatentFitSpec(**spec_args))
    got = tl.fit_latents(
        torch.tensor(inp["init"]), to_torch(dec), tl.train_view(to_torch(inp["data"])),
        torch.tensor(inp["vocab"]), t_hp, tl.LatentFitSpec(**spec_args),
        perms=_jax_perms(key, n_epochs_max) if shuffle else None)
    return want, got


def _assert_close(want, got, train_decoder):
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    if train_decoder:
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), atol=2e-4),
                     to_numpy(got[1]), want[1])


@pytest.mark.parametrize("norm", ["layer_norm", "batch_norm"])
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_train_fit_matches_mmtpu(rng, kind, norm):
    """The training fit (decoder learning, shuffled, sufficient statistics)."""
    want, got = _run_both(_data(rng, stats=True), kind, norm, train_decoder=True,
                          shuffle=True, bsz=5)
    _assert_close(want, got, train_decoder=True)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_inference_fit_matches_mmtpu(rng, kind):
    """The frozen-decoder inference fit: unshuffled, batch x8 padded past n."""
    want, got = _run_both(_data(rng, stats=True), kind, "batch_norm", train_decoder=False,
                          shuffle=False, bsz=8)
    _assert_close(want, got, train_decoder=False)


def test_train_fit_matches_mmtpu_above_depth_512(rng):
    """The training fit at a latent depth above the kernels' former 512
    limit (K1 takes any depth): nothing else in the fit assumes D <= 512.
    SGD: Adam's first step moves a coordinate by lr x sign(g), so where a
    gradient component of the 520-wide decoder is within rounding of zero
    the two frameworks' float orders move it apart by up to lr."""
    want, got = _run_both(_data(rng, stats=True, d=520), "sgd", "layer_norm",
                          train_decoder=True, shuffle=True, bsz=5)
    assert got[0].shape == (N, 520)
    _assert_close(want, got, train_decoder=True)


def test_raw_streams_fit_matches_mmtpu(rng):
    """--parity keeps the raw per-timestep Gaussian streams."""
    want, got = _run_both(_data(rng, stats=False), "adam", "layer_norm", train_decoder=True,
                          shuffle=True, bsz=5)
    _assert_close(want, got, train_decoder=True)


def test_epochs_past_n_epochs_change_nothing(rng):
    want, got = _run_both(_data(rng, stats=True), "sgd", None, train_decoder=True,
                          shuffle=True, bsz=5, n_epochs=2, n_epochs_max=4)
    _assert_close(want, got, train_decoder=True)
    inp = _data(np.random.default_rng(0), stats=True)
    _, exact = _run_both(inp, "sgd", None, train_decoder=True, shuffle=True, bsz=5,
                         n_epochs=2, n_epochs_max=2)
    _, masked = _run_both(inp, "sgd", None, train_decoder=True, shuffle=True, bsz=5,
                          n_epochs=2, n_epochs_max=4)
    np.testing.assert_array_equal(masked[0].numpy(), exact[0].numpy())


def test_pad_rows_never_overwrite_row_zero():
    """Row 0 sits in the first batch and its pad duplicates in the last: the
    fit must keep row 0's real update."""
    inp = _data(np.random.default_rng(3), stats=True)
    perm = [np.arange(N)]
    dec = to_torch(init_decoder(jax.random.key(1), D, A, VIS, unimodal=False))
    hp = {"lr": torch.tensor(1e-2), "word_loss_weight": torch.tensor(0.002),
          "opt_code": OPT_CODES["sgd"], "norm_code": 0, "n_epochs": 1}
    spec = tl.LatentFitSpec(n_epochs_max=1, batch_size=5, train_decoder=False,
                            unimodal=False, opt_kind="sgd")
    init = torch.tensor(inp["init"])
    embed, _, _ = tl.fit_latents(init, dec, tl.train_view(to_torch(inp["data"])),
                                 torch.tensor(inp["vocab"]), hp, spec, perms=perm)
    assert not torch.equal(embed[0], init[0])


def test_shuffle_draws_from_generator(rng):
    """Without injected permutations the shuffle comes from the generator:
    the same seed reproduces the fit, another seed changes it."""
    inp = _data(rng, stats=True)
    dec = to_torch(init_decoder(jax.random.key(1), D, A, VIS, unimodal=False))
    hp = {"lr": torch.tensor(1e-2), "word_loss_weight": torch.tensor(0.002),
          "opt_code": OPT_CODES["sgd"], "norm_code": 1, "n_epochs": 2}
    spec = tl.LatentFitSpec(n_epochs_max=2, batch_size=5, train_decoder=True,
                            unimodal=False, opt_kind="sgd")
    data = tl.train_view(to_torch(inp["data"]))
    fit = lambda seed: tl.fit_latents(torch.tensor(inp["init"]), dec, data,
                                      torch.tensor(inp["vocab"]), hp, spec,
                                      generator=torch.Generator().manual_seed(seed))[2]
    assert torch.equal(fit(0), fit(0))
    assert not torch.equal(fit(0), fit(1))


def sentiment_fits(seed, early_stopping, n_out, lr, epochs=320, **spec_fields):
    """mmtpu's jitted sentiment fit and the port's on the same draws: ``(got,
    want)``.  ``spec_fields`` are further fields of both specs; with
    ``shuffle`` the port takes the permutations JAX drew."""
    from mmtpu.models.sentiment import init_sentiment
    from mmtpu.train import sentiment as js
    from mmtpu_torch.train import sentiment as ts

    rng = np.random.default_rng(seed)
    n, nv, d = 40, 12, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    xv = rng.standard_normal((nv, d)).astype(np.float32)
    shape = (n,) if n_out == 1 else (n, n_out)
    y = rng.standard_normal(shape).astype(np.float32)
    yv = rng.standard_normal(shape[:0] + (nv,) + shape[1:]).astype(np.float32)
    params = init_sentiment(jax.random.key(0), d, 5, n_out)
    key = jax.random.key(4)
    hp = {"lr": lr, "lr_decay": 0.5, "n_epochs": epochs - 7}
    want = jax.jit(js.fit_sentiment, static_argnums=(7,))(
        key, params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xv), jnp.asarray(yv),
        {k: jnp.asarray(v) for k, v in hp.items()},
        js.SentimentFitSpec(n_epochs_max=epochs, early_stopping=early_stopping, **spec_fields))
    perms = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(sub, n)))
    spec = ts.SentimentFitSpec(n_epochs_max=epochs, early_stopping=early_stopping,
                               **spec_fields)
    got = ts.fit_sentiment(to_torch(params), torch.tensor(x), torch.tensor(y), torch.tensor(xv),
                           torch.tensor(yv), hp, spec, perms=perms if spec.shuffle else None)
    return got, want


def assert_sentiment_close(got, want):
    """Parameters atol 1e-4, losses rtol 1e-4 / atol 1e-5."""
    for g, w in zip(got[:2], want[:2]):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=1e-4),
                     to_numpy(g), w)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("early_stopping,n_out,lr", [(False, 1, 0.05), (True, 1, 0.0),
                                                     (True, 3, 0.05)])
def test_sentiment_fit_matches_mmtpu(early_stopping, n_out, lr):
    """The sentiment fit's state machine: validation every 10 epochs; with
    early stopping, patience 10, lr decay and reload of the best params over
    3 trials.  With lr 0 every validation after the first fails, so all
    three trials run out and the fit stops; at lr 0.05 the 3-output fit
    overfits its random labels and reloads its best parameters twice."""
    assert_sentiment_close(*sentiment_fits(0, early_stopping, n_out, lr))


def test_sentiment_spec_fields_match_mmtpu():
    """The spec's fields beyond the defaults, as mmtpu reads them: batch 16,
    no shuffle, validation every 3 epochs, patience 2 and 2 trials (the fit
    reloads, then stops, within its 60 epochs)."""
    got, want = sentiment_fits(1, True, 1, 0.05, epochs=60, batch_size=16, shuffle=False,
                               valid_niter=3, patience=2, n_trials=2)
    assert_sentiment_close(got, want)
    assert np.isfinite(got[3].numpy()).all()


@pytest.mark.parametrize("early_stopping,n_out", [(False, 1), (False, 3), (True, 1), (True, 3)])
def test_sentiment_fit_under_config_axis_matches_vmapped_mmtpu(early_stopping, n_out):
    """K = 3 configs through the port's config axis against
    ``jax.vmap(mmtpu.train.sentiment.fit_sentiment)`` on the same draws
    (each config's key gives its permutations): lr (0, 0.05, 0.02), lr decay
    (0.5, 0.3, 0.5), n_epochs (60, 40, 25) of 60, validation every 3 epochs,
    patience 2.  Parameters atol 2e-7, losses atol 5e-7: a few float32 ulps
    (the largest differences seen were 8.9e-8 and 1.8e-7)."""
    from mmtpu.models.sentiment import init_sentiment
    from mmtpu.train import sentiment as js
    from mmtpu_torch.train import sentiment as ts

    rng = np.random.default_rng(7)
    k, n, nv, d, epochs = 3, 40, 12, 6, 60
    x, xv = (rng.standard_normal((k, m, d)).astype(np.float32) for m in (n, nv))
    y, yv = (rng.standard_normal((m,) if n_out == 1 else (m, n_out)).astype(np.float32)
             for m in (n, nv))
    params = jax.tree.map(lambda *a: jnp.stack(a), *[init_sentiment(jax.random.key(i), d, 5, n_out)
                                                     for i in range(k)])
    keys = [jax.random.key(10 + i) for i in range(k)]
    hp = {"lr": np.array([0.0, 0.05, 0.02], np.float32),
          "lr_decay": np.array([0.5, 0.3, 0.5], np.float32),
          "n_epochs": np.array([60, 40, 25], np.int32)}
    fields = dict(n_epochs_max=epochs, early_stopping=early_stopping, valid_niter=3, patience=2)
    spec = js.SentimentFitSpec(**fields)
    want = jax.jit(jax.vmap(lambda key, p, x, xv, hp: js.fit_sentiment(
        key, p, x, jnp.asarray(y), xv, jnp.asarray(yv), hp, spec)))(
        jnp.stack(keys), params, jnp.asarray(x), jnp.asarray(xv),
        {name: jnp.asarray(v) for name, v in hp.items()})
    drawn = []
    for key in keys:  # the fit's own draws: one split of the key per epoch
        drawn.append([])
        for _ in range(epochs):
            key, sub = jax.random.split(key)
            drawn[-1].append(np.array(jax.random.permutation(sub, n)))
    perms = [torch.tensor(np.stack([p[e] for p in drawn])) for e in range(epochs)]
    got = ts.fit_sentiment(to_torch(params), torch.tensor(x), torch.tensor(y), torch.tensor(xv),
                           torch.tensor(yv), {name: torch.tensor(v) for name, v in hp.items()},
                           ts.SentimentFitSpec(**fields), perms=perms)
    for g, w in zip(got[:2], want[:2]):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-7),
                     to_numpy(g), w)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-7)
    assert np.isfinite(got[3].numpy()).all()
