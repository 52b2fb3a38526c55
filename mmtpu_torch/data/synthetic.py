"""Synthetic datasets (the port's copy of :mod:`mmtpu.data.synthetic`) with
the exact shapes/dtypes of the real MOSI/POM/IEMOCAP blobs, which are not
vendored in the reference repo (``.MISSING_LARGE_BLOBS``, ``README.md:9``) —
used for development, tests, and benchmarking.

Shapes mirror the reference loaders (``utils.py:20-128``):
- MOSI: ``text`` = int word ids (N, 20), vocab 3016 x 300 GloVe, covarep
  (N, 20, A), facet (N, 20, V), scalar label in [-3, 3].
- POM: ``text`` = pre-aligned embeddings (N, L, 300), separate ``text_id``
  int arrays, 17-dim trait labels.
- IEMOCAP: like POM but one-hot 4-class (per-emotion binary in the reference
  CLI; we synthesize a class-count-dim label).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _tokens(rng, n, L, vocab, mean_len):
    ids = rng.integers(1, vocab, size=(n, L))
    lengths = np.clip(rng.poisson(mean_len, size=n), 3, L)
    for i, ln in enumerate(lengths):
        ids[i, ln:] = 0  # padding id 0, like MOSI
    return ids.astype(np.int64), lengths.astype(np.int64)


def _modality(rng, n, L, f, lengths, scale=1.0):
    x = rng.standard_normal((n, L, f)).astype(np.float32) * scale
    for i, ln in enumerate(lengths):
        x[i, ln:] = 0.0  # zeros mark padding (masks derive from != 0)
    return x


def synthesize_dataset(
    name: str = "mosi",
    n_train: int = 1284,
    n_valid: int = 229,
    n_test: int = 686,
    seq_len: int = 20,
    vocab_size: int = 3016,
    embed_dim: int = 300,
    audio_dim: int = 74,
    visual_dim: int = 47,
    seed: int = 0,
    text_len: int = 0,
) -> Dict:
    """Return ``{word_embeddings, word_weights, splits: {train/valid/test}}``
    with reference-shaped arrays.

    The latent structure is planted: a hidden per-utterance vector drives the
    modality means and the label, so the generative model genuinely has signal
    to recover (useful for end-to-end smoke accuracy checks).

    ``text_len`` (POM/IEMOCAP only) sets the length of the ``text_id`` token
    rows independently of ``seq_len`` — the real POM blobs carry rows up to
    1357 tokens (pom_test_ids.npy is (203, 1357)) while the aligned-embedding
    stream follows the 20-step video frames; 0 = use ``seq_len``.
    """
    rng = np.random.default_rng(seed)
    word_embeddings = rng.standard_normal((vocab_size, embed_dim)).astype(np.float32)
    word_embeddings /= np.linalg.norm(word_embeddings, axis=-1, keepdims=True)
    word_weights = (rng.random(vocab_size) * 0.9 + 0.05).astype(np.float32)

    splits = {}
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        ids, lengths = _tokens(rng, n, seq_len, vocab_size, mean_len=seq_len * 0.7)
        hidden = rng.standard_normal((n, 8)).astype(np.float32)
        w_a = rng.standard_normal((8, audio_dim)).astype(np.float32) * 0.4
        w_v = rng.standard_normal((8, visual_dim)).astype(np.float32) * 0.4
        covarep = _modality(rng, n, seq_len, audio_dim, lengths)
        facet = _modality(rng, n, seq_len, visual_dim, lengths)
        covarep += (hidden @ w_a)[:, None, :] * (covarep != 0)
        facet += (hidden @ w_v)[:, None, :] * (facet != 0)

        if name == "mosi":
            label = np.clip(hidden[:, 0] * 1.2, -3, 3).astype(np.float32)
            splits[split] = {
                "text": ids, "covarep": covarep, "facet": facet,
                "label": label, "lengths": lengths,
                "id": np.arange(n, dtype=np.int64),
            }
        elif name in ("pom", "iemocap"):
            # long transcript token rows vs 20-step aligned embeddings
            if text_len and text_len != seq_len:
                text_ids, _ = _tokens(
                    rng, n, text_len, vocab_size, mean_len=text_len * 0.5
                )
            else:
                text_ids = ids
            aligned = word_embeddings[ids] * (ids != 0)[:, :, None]
            if name == "pom":
                w_y = rng.standard_normal((8, 17)).astype(np.float32) * 0.5
                label = (hidden @ w_y + 4.0).astype(np.float32)  # traits ~[1, 7]
            else:
                cls = (hidden[:, 0] > 0).astype(np.int64)
                label = np.eye(2, dtype=np.float32)[cls]
            splits[split] = {
                "text": aligned.astype(np.float32), "text_id": text_ids,
                "covarep": covarep, "facet": facet, "label": label,
            }
        else:
            raise ValueError(name)

    return {
        "name": name,
        "word_embeddings": word_embeddings,
        "word_weights": word_weights,
        "splits": splits,
    }
