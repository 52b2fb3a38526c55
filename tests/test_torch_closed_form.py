"""The port's closed form and numeric ops against mmtpu on JAX-CPU, on the
same numpy inputs from a seed: ``mmtpu_torch.ops.closed_form``,
``mmtpu_torch.train.warm_start`` (MMB2, MMB1, the raw-layout error, and the
sweep's config axis against per-config calls), ``mmtpu_torch.ops.sif`` and
``mmtpu_torch.ops.posenc`` (also against the port's own numpy forms in
``mmtpu_torch.data.pipeline``).

Tolerances: closed form rtol 1e-5 / atol 1e-6 (float32, summed in another
order); SIF and posenc rtol 1e-5 / atol 1e-6, the first principal
component compared through what uses it (its sign is arbitrary).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmtpu.ops.closed_form as jcf
import mmtpu.ops.posenc as jposenc
import mmtpu.ops.sif as jsif
from mmtpu.data.pipeline import prepare_device_data
from mmtpu.data.synthetic import synthesize_dataset
from mmtpu.models.decoder import MMB2_HEADS, init_decoder as j_init_decoder
from mmtpu.serve import assemble_head_data as j_assemble
from mmtpu.train.latents import train_view
from mmtpu.train.warm_start import closed_form_latents_from_stats as j_from_stats
import mmtpu_torch.data.pipeline as tpipe
import mmtpu_torch.ops as tops
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.serve import assemble_head_data
from mmtpu_torch.train.warm_start import closed_form_latents_from_stats

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=rtol, atol=atol, **kw)


def _tiny(seed=0, n=13, L=5, V=25, D=8, A=4, Vis=3):
    """``tests/test_train_parity.py::_make_tiny``'s shapes, with a decoder."""
    rng = np.random.default_rng(seed)
    vocab = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=(n, L))
    return {
        "vocab": vocab, "ids": ids,
        "weights": (rng.random((n, L)) * 0.9 + 0.05).astype(np.float32),
        "streams": {"text_gauss": vocab[ids],
                    "audio": rng.standard_normal((n, L, A)).astype(np.float32),
                    "visual": rng.standard_normal((n, L, Vis)).astype(np.float32)},
        "dec": j_init_decoder(jax.random.key(seed), D, A, Vis, text_dim=D),
    }


def test_closed_form_latents_matches_mmtpu():
    t = _tiny()
    heads = {h: t["dec"]["heads"][h] for h in MMB2_HEADS}
    want = jcf.closed_form_latents(j_assemble(t["streams"], MMB2_HEADS), heads,
                                   jnp.asarray(t["weights"]),
                                   jnp.asarray(t["streams"]["text_gauss"]))
    got = tops.closed_form_latents(assemble_head_data(to_torch(t["streams"]), MMB2_HEADS),
                                   to_torch(heads), to_torch(t["weights"]),
                                   to_torch(t["streams"]["text_gauss"]))
    assert got.shape == (13, 8)
    _close(got, want)
    hp = heads["textaudio"]
    x = j_assemble(t["streams"], ["textaudio"])["textaudio"]
    for g, w in zip(tops.gaussian_inverse_weights(to_torch(x), to_torch(hp["b_mu"]),
                                                  to_torch(hp["b_log_sigma"])),
                    jcf.gaussian_inverse_weights(x, hp["b_mu"], hp["b_log_sigma"])):
        _close(g, w)


def test_seq_summed_inverse_weights_matches_mmtpu():
    rng = np.random.default_rng(1)
    s0, s1, s2 = (rng.random((6, 5)).astype(np.float32) * 4 for _ in range(3))
    b_mu, b_ls = (rng.standard_normal(5).astype(np.float32) * 0.3 for _ in range(2))
    want = jcf.seq_summed_inverse_weights(s0, s1, s2, b_mu, b_ls)
    got = tops.closed_form.seq_summed_inverse_weights(*map(to_torch, (s0, s1, s2, b_mu, b_ls)))
    for g, w in zip(got, want):
        _close(g, w)


def _stats_prep():
    """Prepared MOSI-like splits with sufficient statistics and the sweep's
    shared positional table (blocks of 2 and 4 channels)."""
    ds = synthesize_dataset("mosi", n_train=13, n_valid=9, n_test=10, vocab_size=25,
                            embed_dim=8, audio_dim=4, visual_dim=3)
    return prepare_device_data(ds, pos_mode="shared", pos_dims=(2, 4))


@pytest.mark.parametrize("unimodal", [False, True], ids=["mmb2", "mmb1"])
def test_from_stats_matches_mmtpu(unimodal):
    """On the sweep's layout, the shared table masked to its dim-4 block."""
    prep = _stats_prep()
    data = train_view(prep.splits["valid"])
    data["pos_mask"] = np.array([0, 0, 1, 1, 1, 1], np.float32)
    dec = j_init_decoder(jax.random.key(3), 8, 4 + 6, 3 + 6, unimodal=unimodal, text_dim=8)
    want = j_from_stats(dec, {k: jnp.asarray(v) for k, v in data.items()},
                        jnp.asarray(prep.vocab_embeddings), unimodal=unimodal)
    got = closed_form_latents_from_stats(to_torch(dec), to_torch(data),
                                         to_torch(prep.vocab_embeddings), unimodal=unimodal)
    assert got.shape == (9, 8) and got.dtype == torch.float32
    _close(got, want)


def test_from_stats_rejects_the_raw_layout():
    t = _tiny()
    raw = dict(to_torch(t["streams"]), text_ids=to_torch(t["ids"]),
               text_weights=to_torch(t["weights"]),
               **{f"{s}_mask": torch.ones(13, 5) for s in ("audio", "visual", "text_gauss")})
    with pytest.raises(ValueError, match="suff-stats"):
        closed_form_latents_from_stats(to_torch(t["dec"]), raw, to_torch(t["vocab"]))


def test_from_stats_config_axis_matches_per_config_calls():
    """K = 3 decoders with (K, D, F) / (K, F) leaves and per-config
    positional masks (K, 1, P) against the shared statistics: each config's
    (B, D) slice equals its own 2-D call."""
    prep = _stats_prep()
    data = to_torch(train_view(prep.splits["test"]))
    vocab = to_torch(prep.vocab_embeddings)
    masks = torch.tensor([[1, 1, 0, 0, 0, 0], [0, 0, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0]],
                         dtype=torch.float32)
    decs = [to_torch(j_init_decoder(jax.random.key(k), 8, 4 + 6, 3 + 6, text_dim=8))
            for k in range(3)]
    stacked = {"heads": {h: {n: torch.stack([d["heads"][h][n] for d in decs])
                             for n in decs[0]["heads"][h]} for h in MMB2_HEADS}}
    got = closed_form_latents_from_stats(stacked, dict(data, pos_mask=masks[:, None, :]), vocab)
    assert got.shape == (3, 10, 8)
    for k in range(3):
        want = closed_form_latents_from_stats(decs[k], dict(data, pos_mask=masks[k]), vocab)
        torch.testing.assert_close(got[k], want, rtol=RTOL, atol=ATOL)


def _sif_inputs(seed=2, n=13, L=5, V=25, D=8):
    rng = np.random.default_rng(seed)
    we = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(-1, V, size=(n, L))  # -1: no token
    vw = (rng.random(V) * 0.9 + 0.05).astype(np.float32)
    return we, ids, vw


def test_sif_matches_mmtpu_and_the_numpy_forms():
    we, ids, vw = _sif_inputs()
    w_j = jsif.seq_weights(jnp.asarray(ids), jnp.asarray(vw))
    w_t = tops.seq_weights(to_torch(ids), to_torch(vw))
    _close(w_t, w_j, rtol=0, atol=0)
    np.testing.assert_array_equal(to_numpy(w_t), tpipe._np_seq_weights(ids, vw))
    w = np.asarray(w_j)
    avg_j = jsif.sif_weighted_average(jnp.asarray(we), jnp.asarray(ids), w_j)
    avg_t = tops.sif_weighted_average(to_torch(we), to_torch(ids), to_torch(w))
    _close(avg_t, avg_j)
    # the principal direction up to its sign, then what uses it
    pc_j, pc_t = np.asarray(jsif.first_pc(avg_j)), to_numpy(tops.first_pc(avg_t))
    _close(pc_t * np.sign(pc_t @ pc_j), pc_j)
    _close(tops.remove_pc(avg_t), jsif.remove_pc(avg_j))
    emb_t = tops.sif_embedding(to_torch(we), to_torch(ids), to_torch(w))
    _close(emb_t, jsif.sif_embedding(jnp.asarray(we), jnp.asarray(ids), w_j))
    _close(emb_t, tpipe._np_sif_embedding(we, ids, w))
    _close(tops.sif_embedding(to_torch(we), to_torch(ids), to_torch(w), rmpc=0), avg_j)
    with pytest.raises(NotImplementedError):
        tops.sif_embedding(to_torch(we), to_torch(ids), to_torch(w), rmpc=2)


@pytest.mark.parametrize("bug_parity", [False, True])
@pytest.mark.parametrize("n,p", [(13, 4), (3, 6)])
def test_posenc_matches_mmtpu_and_the_numpy_form(bug_parity, n, p):
    """Both modes; n < p exercises the reference's loop running out of samples."""
    x = np.random.default_rng(3).standard_normal((n, 5, 4)).astype(np.float32)
    got = tops.add_positional_embeddings(to_torch(x), p, bug_parity=bug_parity)
    assert got.shape == (n, 5, 4 + p)
    _close(got, jposenc.add_positional_embeddings(jnp.asarray(x), p, bug_parity=bug_parity))
    _close(got, tpipe._np_add_positional(x, p, bug_parity))
    _close(tops.positional_encoding(5, p), jposenc.positional_encoding(5, p))
