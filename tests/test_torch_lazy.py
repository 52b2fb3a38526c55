"""Lazy Adam in the port against mmtpu's: the four closed-form functions on
the same numpy inputs, and the latent, fused and e2e fits with ``lazy_adam``.

Tolerances: the functions rtol 1e-6 / atol 1e-6 (float32 ``pow`` and sums in
another order); whole fits the repo's losses rtol 2e-4 and embeddings/decoder
atol 2e-4; the port's lazy fit against its own dense fit mmtpu's drift check
(tests/test_train_parity.py::test_lazy_adam_matches_dense: embeddings atol
1e-5, losses rtol 2e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmtpu.models.decoder import NORM_CODES, init_decoder
from mmtpu.train import latents as jl
from mmtpu.train import optim as jopt
from mmtpu.train.optim import OPT_CODES
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.train import latents as tl
from mmtpu_torch.train import optim as topt
from tests.test_torch_e2e import _assert_fit_close, _e2e_both
from tests.test_torch_fit import A, D, N, VIS, _data
from tests.test_torch_runner import _perms

FN_TOL = dict(rtol=1e-6, atol=1e-6)
FIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or FN_TOL))


@pytest.mark.parametrize("k", [None, 3])
def test_lazy_catch_up_sums_its_terms_as_the_formula_does(rng, k):
    """The catch-up, whose terms live in buffers of the epoch's largest size,
    equals the formula on fresh temporaries sized by the block index bit for
    bit, at every block index, with and without a config axis."""
    S, B, Dd = 6, 3, 5
    lead = () if k is None else (k,)
    r = lambda *sh: torch.tensor(rng.standard_normal(lead + sh).astype(np.float32))
    p, m, v = r(B, Dd), 0.1 * r(B, Dd), torch.abs(0.01 * r(B, Dd))
    count = torch.tensor(5 if k is None else [5, 0, 9], dtype=torch.int32)
    lr = torch.tensor(0.01 if k is None else [0.01, 0.1, 0.001])
    coeffs = topt.lazy_adam_coeffs(count, S, lr)
    for s in range(1, S):
        a1, a2 = (c[..., :s].movedim(-1, 0)[..., None, None] for c in coeffs[:2])
        want = p - torch.sum(a1 * m / (torch.sqrt(a2 * v) + topt._EPS), dim=0)
        assert torch.equal(topt.lazy_adam_catch_up(p, m, v, s, coeffs)[0], want)


@pytest.mark.parametrize("S", [1, 2, 5])
def test_lazy_adam_functions_match_mmtpu(rng, S):
    """Coefficients, catch-up at every block index, touch and epilogue, on
    one permuted (S*B, D) table; the catch-up at s = 0 and the epilogue at
    S = 1 return their inputs unchanged."""
    B, Dd, lr = 3, 4, 0.01
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    p, m, v, g = r(S * B, Dd), 0.1 * r(S * B, Dd), np.abs(0.01 * r(S * B, Dd)), r(S * B, Dd)
    t = lambda a: torch.tensor(np.array(a))
    jc = jopt.lazy_adam_coeffs(jnp.int32(7), S, jnp.float32(lr))
    tc = topt.lazy_adam_coeffs(torch.tensor(7, dtype=torch.int32), S, torch.tensor(lr))
    for got, want in zip(tc, jc):
        assert got.dtype == torch.float32 and got.shape == (S,)
        _close(got, want)
    for s in range(S):
        blk = slice(s * B, (s + 1) * B)
        want = jopt.lazy_adam_catch_up(p[blk], m[blk], v[blk], jnp.int32(s), jc)
        got = topt.lazy_adam_catch_up(t(p[blk]), t(m[blk]), t(v[blk]), s, tc)
        for a, b in zip(got, want):
            _close(a, b)
        if s == 0:
            assert all(torch.equal(a, t(b[blk])) for a, b in zip(got, (p, m, v)))
        want = jopt.lazy_adam_touch(*want, g[blk], jnp.int32(s), lr, jc)
        got = topt.lazy_adam_touch(*got, t(g[blk]), s, lr, tc)
        for a, b in zip(got, want):
            _close(a, b)
    want = jopt.lazy_adam_epilogue(p, m, v, S, B, lr, jc)
    got = topt.lazy_adam_epilogue(t(p), t(m), t(v), S, B, lr, tc)
    for a, b, before in zip(got, want, (p, m, v)):
        _close(a, b)
        if S == 1:
            assert torch.equal(a, t(before))


def fit_latents_both(inp, n_epochs, valid=None, lr=1e-2, **spec_args):
    """mmtpu's fit_latents and the port's on the same inputs, the port fed
    JAX's permutations.  ``valid`` (an input dict of :func:`_data`) is the
    valid split of the validation curve."""
    kind = spec_args["opt_kind"]
    dec = init_decoder(jax.random.key(1), D, A, VIS, unimodal=False)
    hp = {"lr": lr, "word_loss_weight": 0.002, "opt_code": OPT_CODES[kind],
          "norm_code": NORM_CODES["layer_norm"], "n_epochs": n_epochs}
    j_hp = {k: jnp.asarray(v, jnp.int32 if isinstance(v, int) else jnp.float32)
            for k, v in hp.items()}
    t_hp = {k: (v if isinstance(v, int) else torch.tensor(v)) for k, v in hp.items()}
    j_split = lambda d: (jnp.asarray(d["init"]),
                         jl.train_view({k: jnp.asarray(v) for k, v in d["data"].items()}))
    t_split = lambda d: (torch.tensor(d["init"]), tl.train_view(to_torch(d["data"])))
    key = jax.random.key(7)
    spec = jl.LatentFitSpec(**spec_args)
    j_init, j_data = j_split(inp)
    want = jax.jit(lambda: jl.fit_latents(key, j_init, dec, j_data, jnp.asarray(inp["vocab"]),
                                          j_hp, spec, None if valid is None else j_split(valid)))()
    curve = valid is not None and spec.valid_every > 0
    perms = _perms(key, N, spec.n_epochs_max, curve) if spec.shuffle else None
    t_init, t_data = t_split(inp)
    got = tl.fit_latents(t_init, to_torch(dec), t_data, torch.tensor(inp["vocab"]), t_hp,
                         tl.LatentFitSpec(**spec_args), perms=perms,
                         validation=None if valid is None else t_split(valid))
    return want, got


def assert_latent_fits_close(want, got, train_decoder=True):
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **FIT_TOL)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    if train_decoder:
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                                             atol=2e-4),
                     to_numpy(got[1]), want[1])


@pytest.mark.parametrize("shuffle,train_decoder,bsz", [(True, True, 5), (False, False, 8)])
def test_lazy_fit_latents_matches_mmtpu(rng, shuffle, train_decoder, bsz):
    """The lazy latent fit, training (shuffled, 3 blocks per epoch) and
    inference (unshuffled, 2 blocks), with n_epochs < n_epochs_max: the fifth
    epoch is inactive and is thrown away whole."""
    want, got = fit_latents_both(_data(rng, stats=True), n_epochs=4, n_epochs_max=5,
                                 batch_size=bsz, train_decoder=train_decoder, unimodal=False,
                                 shuffle=shuffle, opt_kind="adam", lazy_adam=True)
    assert_latent_fits_close(want, got, train_decoder)


def test_lazy_fit_matches_dense_fit(rng):
    """The port's lazy fit against its dense fit on the same draws, at mmtpu's
    drift tolerance; the two inactive epochs change nothing."""
    inp = _data(rng, stats=True)
    perms = [np.random.default_rng(e).permutation(N) for e in range(7)]
    dec = to_torch(init_decoder(jax.random.key(1), D, A, VIS, unimodal=False))
    hp = {"lr": torch.tensor(1e-3), "word_loss_weight": torch.tensor(0.002),
          "opt_code": OPT_CODES["adam"], "norm_code": NORM_CODES["layer_norm"], "n_epochs": 5}
    spec = tl.LatentFitSpec(n_epochs_max=7, batch_size=5, train_decoder=True, unimodal=False,
                            opt_kind="adam")
    fit = lambda s: tl.fit_latents(torch.tensor(inp["init"]), dec,
                                   tl.train_view(to_torch(inp["data"])),
                                   torch.tensor(inp["vocab"]), hp, s, perms=perms)
    dense, lazy = fit(spec), fit(dataclasses.replace(spec, lazy_adam=True))
    np.testing.assert_allclose(lazy[0].numpy(), dense[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lazy[2].numpy(), dense[2].numpy(), rtol=2e-3, atol=1e-6)
    short = fit(dataclasses.replace(spec, lazy_adam=True, n_epochs_max=5))
    assert torch.equal(lazy[0], short[0])


def test_lazy_gate_reads_the_static_kind(rng):
    """With ``opt_kind=None`` and Adam from ``hp["opt_code"]``, ``lazy_adam``
    changes nothing: the dense fit runs, as in mmtpu."""
    inp = _data(rng, stats=True)
    dec = to_torch(init_decoder(jax.random.key(1), D, A, VIS, unimodal=False))
    hp = {"lr": torch.tensor(1e-2), "word_loss_weight": torch.tensor(0.002),
          "opt_code": OPT_CODES["adam"], "norm_code": NORM_CODES["layer_norm"], "n_epochs": 2}
    spec = tl.LatentFitSpec(n_epochs_max=2, batch_size=5, train_decoder=True, unimodal=False)
    fit = lambda s: tl.fit_latents(torch.tensor(inp["init"]), dec,
                                   tl.train_view(to_torch(inp["data"])),
                                   torch.tensor(inp["vocab"]), hp, s,
                                   perms=[np.arange(N)] * 2)
    dense, gated = fit(spec), fit(dataclasses.replace(spec, lazy_adam=True))
    assert torch.equal(dense[0], gated[0]) and torch.equal(dense[2], gated[2])


def test_fused_lazy_fit_latents_matches_mmtpu(rng):
    """Fused decoder update (K2's plain version here, mmtpu's kernel in
    interpret mode) with lazy Adam moving the latent rows."""
    want, got = fit_latents_both(_data(rng, stats=True), n_epochs=3, n_epochs_max=3,
                                 batch_size=5, train_decoder=True, unimodal=False,
                                 opt_kind="adam", lazy_adam=True, fused_dec_update=True)
    assert_latent_fits_close(want, got)


@pytest.mark.parametrize("fused", [False, True])
def test_lazy_fit_e2e_matches_mmtpu(rng, fused):
    """The e2e fit with lazy Adam, dense and fused, one inactive epoch."""
    _, want, got = _e2e_both(rng, "adam", fused, n_epochs=2, n_epochs_max=3,
                             spec_extra={"lazy_adam": True})
    _assert_fit_close(want, got)
