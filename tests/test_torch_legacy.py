"""The port's legacy models, alternating driver and analysis against mmtpu on
JAX-CPU: ``mmtpu_torch.models.legacy`` on parameters converted from mmtpu's
inits (the LSTM autoencoder included), ``fit_alternating`` for two epochs
from the same parameters, and ``closest_word_ids`` / ``get_closest_words``.

Tolerances: model outputs rtol 1e-5 / atol 1e-6; the alternating fit's
losses rtol 1e-4, its latents and parameters atol 1e-4 (float32 over two
epochs of steps, summed in another order); nearest words exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmtpu.models.legacy as jleg
from mmtpu.analysis import closest_word_ids as j_closest_word_ids
from mmtpu.train.alternating import AlternatingFitSpec as JSpec, fit_alternating as j_fit
import mmtpu_torch.models.legacy as tleg
from mmtpu_torch.analysis import closest_word_ids, get_closest_words
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.train.alternating import AlternatingFitSpec, fit_alternating
from mmtpu_torch.tree import tree_leaves


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=rtol, atol=atol)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_generators_match_mmtpu():
    p = jleg.init_audio_visual_generator(jax.random.key(0), 8, 5, 4)
    x = _x(6, 8)
    for got, want in zip(tleg.apply_audio_visual_generator(to_torch(p), to_torch(x)),
                         jleg.apply_audio_visual_generator(p, jnp.asarray(x))):
        for g, w in zip(got, want):
            _close(g, w)
    pc = jleg.init_concat_generator(jax.random.key(1), 6, 5, 4, 3)
    a, v = _x(7, 6, seed=1), _x(7, 5, seed=2)
    for got, want in zip(tleg.apply_concat_generator(to_torch(pc), to_torch(a), to_torch(v)),
                         jleg.apply_concat_generator(pc, jnp.asarray(a), jnp.asarray(v))):
        for g, w in zip(got, want):
            _close(g, w)
    we = to_torch(_x(7, 10))
    e = tleg.concat_init_embeddings(torch.Generator().manual_seed(0), we, 6, 5)
    assert e.shape == (7, 21) and torch.equal(e[:, :10], we)


def test_port_inits_have_the_layouts_and_laws():
    gen = torch.Generator().manual_seed(0)
    inits = {
        "av": (tleg.init_audio_visual_generator(gen, 8, 5, 4),
               jleg.init_audio_visual_generator(jax.random.key(0), 8, 5, 4)),
        "ae": (tleg.init_autoencoder(gen, 4, 8, 6, 5, 3),
               jleg.init_autoencoder(jax.random.key(0), 4, 8, 6, 5, 3)),
        "lstm": (tleg.init_lstm_autoencoder(gen, 5, 4, 3, 2),
                 jleg.init_lstm_autoencoder(jax.random.key(0), 5, 4, 3, 2)),
    }
    for name, (got, want) in inits.items():
        shapes = [tuple(t.shape) for t in tree_leaves(got)]
        assert shapes == [tuple(np.shape(a)) for a in jax.tree.leaves(want)], name
    bound = 1.0 / np.sqrt(5)  # the LSTM's hidden size
    assert all(float(t.abs().max()) <= bound for t in tree_leaves(inits["lstm"][0]["encoder"]))


def test_autoencoders_match_mmtpu():
    p = jleg.init_autoencoder(jax.random.key(0), 4, 8, 6, 5, 3)
    x = _x(9, 14)
    for g, w in zip(tleg.apply_autoencoder(to_torch(p), to_torch(x)),
                    jleg.apply_autoencoder(p, jnp.asarray(x))):
        _close(g, w)
    pl = jleg.init_lstm_autoencoder(jax.random.key(1), 5, 4, 3, 2)
    xs = _x(3, 6, 9, seed=3)
    lat, recon = tleg.apply_lstm_autoencoder(to_torch(pl), to_torch(xs))
    want_lat, want_recon = jleg.apply_lstm_autoencoder(pl, jnp.asarray(xs))
    assert lat.shape == (3, 5) and recon.shape == (3, 6, 9)
    _close(lat, want_lat)
    _close(recon, want_recon)


def _alt_data(seed=7, n=13, L=5, V=25, D=8, A=4, Vis=3):
    """``_make_tiny``'s shapes in the alternating fit's dict convention."""
    rng = np.random.default_rng(seed)
    vocab = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(1, V, size=(n, L))
    ids[rng.random((n, L)) < 0.2] = 0
    return vocab, {
        "text_ids": ids.astype(np.int32),
        "text_weights": (rng.random((n, L)) * 0.9 + 0.05).astype(np.float32),
        "text_mask": (ids != 0).astype(np.float32),
        "audio": rng.standard_normal((n, L, A)).astype(np.float32),
        "audio_mask": (rng.random((n, L, A)) < 0.85).astype(np.float32),
        "visual": rng.standard_normal((n, L, Vis)).astype(np.float32),
        "visual_mask": (rng.random((n, L, Vis)) < 0.85).astype(np.float32),
    }


@pytest.mark.parametrize("metric", ["angular", "dot_prod"])
def test_fit_alternating_matches_mmtpu(metric):
    """Two epochs at batch 8 (13 rows: the last batch padded at weight 0)."""
    vocab, data = _alt_data()
    params = jleg.init_audio_visual_generator(jax.random.key(2), 8, 4, 3)
    lat_w, p_w, l_w = j_fit(params, {k: jnp.asarray(v) for k, v in data.items()},
                            jnp.asarray(vocab), lr=1e-2, word_loss_weight=0.3,
                            spec=JSpec(n_epochs=2, batch_size=8, word_metric=metric))
    lat_g, p_g, l_g = fit_alternating(to_torch(params), to_torch(data), to_torch(vocab),
                                      lr=1e-2, word_loss_weight=0.3,
                                      spec=AlternatingFitSpec(n_epochs=2, batch_size=8,
                                                              word_metric=metric))
    assert l_g.shape == (2,) and lat_g.shape == (13, 8)
    _close(l_g, l_w, rtol=1e-4, atol=0)
    _close(lat_g, lat_w, rtol=0, atol=1e-4)
    for g, w in zip(tree_leaves(p_g), jax.tree.leaves(p_w)):
        _close(g, w, rtol=0, atol=1e-4)
    # the decoder moved, and gathered text vectors give the same fit as ids
    assert not np.allclose(to_numpy(p_g["audio"]["mu"]["w"]), params["audio"]["mu"]["w"])
    gathered = dict(to_torch(data), text=to_torch(vocab)[to_torch(data["text_ids"])])
    del gathered["text_ids"]
    lat_t, _, l_t = fit_alternating(to_torch(params), gathered, to_torch(vocab), lr=1e-2,
                                    word_loss_weight=0.3,
                                    spec=AlternatingFitSpec(n_epochs=2, batch_size=8,
                                                            word_metric=metric))
    assert torch.equal(lat_t, lat_g) and torch.equal(l_t, l_g)


def test_closest_words_match_mmtpu():
    we = _x(20, 8, seed=4)
    emb = np.concatenate([we[[3, 7]] * 2.0, _x(4, 8, seed=5)])
    ids = closest_word_ids(emb, we, k=3)
    np.testing.assert_array_equal(ids, np.asarray(j_closest_word_ids(emb, we, k=3)))
    np.testing.assert_array_equal(closest_word_ids(to_torch(emb), to_torch(we), k=3), ids)
    words = get_closest_words(emb, we, {f"w{i}": i for i in range(19)}, k=3)
    assert words[0][0] == "w3" and words[1][0] == "w7"
    assert all(w == "<19>" for row, r in zip(words, ids) for w, i in zip(row, r) if i == 19)
