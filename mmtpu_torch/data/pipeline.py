"""Host data preparation (the port's copy of :mod:`mmtpu.data.pipeline`): the
equivalent of ``simplesif.py`` main()'s data section (``simplesif.py:259-459``),
producing the array dict consumed by ``mmtpu_torch.train.latents.fit_latents``.

Steps mirrored:
1. per-split normalization + masks          (utils.py:155-191, simplesif.py:273-285)
2. SIF word weights + sentence embeddings    (sif.py:34-94, simplesif.py:291-311)
3. token-id → word-vector/weight gathers     (simplesif.py:319-344)
4. positional embeddings on audio/visual     (simplesif.py:353-399)
5. device placement with static shapes

Two positional-embedding modes:
- ``pos_mode="baked"``   — channels appended to the stored arrays, reference
  style (choose ``pos_bug_parity`` for the utils.py:146-148 indexing bug);
- ``pos_mode="shared"``  — arrays keep base features; a shared sinusoidal
  table + per-config channel mask ride along, letting a vmapped sweep serve
  every ``pos_embed_dim`` from ONE copy of the data.  The table is a
  concatenation of one block per *unique* dim in ``pos_dims`` (each block is
  the exact standalone ``positional_encoding(L, p)``), and a config's mask
  selects its own block — so masked equivalence to a standalone run is exact
  for ANY dim set, not just dims sharing leading channel frequencies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from mmtpu_torch.data.normalize import normalize_split, text_token_mask, aligned_text_mask

# NB: preparation is pure numpy — one-time host preprocessing.  The numpy
# helpers below are mmtpu's (mmtpu/data/pipeline.py), whose semantics are
# golden-tested against mmtpu.ops in tests/test_data_config_eval.py; the
# port's copy is held to mmtpu's bit for bit (tests/test_torch_e2e.py).


def _np_seq_weights(ids: np.ndarray, vw: np.ndarray) -> np.ndarray:
    """numpy twin of mmtpu.ops.sif.seq_weights."""
    valid = ids >= 0
    return (vw[np.where(valid, ids, 0)] * valid).astype(np.float32)


def _np_sif_embedding(we: np.ndarray, ids: np.ndarray, w: np.ndarray) -> np.ndarray:
    """numpy twin of mmtpu.ops.sif.sif_embedding (rmpc=1)."""
    gathered = we[np.where(ids >= 0, ids, 0)]
    summed = np.einsum("nl,nld->nd", w, gathered)
    counts = np.maximum((w != 0).sum(-1), 1)
    emb = (summed / counts[:, None]).astype(np.float32)
    gram = emb.T @ emb
    _, vecs = np.linalg.eigh(gram)
    pc = vecs[:, -1]
    pc = pc / np.linalg.norm(pc)
    return emb - (emb @ pc)[:, None] * pc[None, :]


def _np_positional_encoding(seq_len: int, p: int) -> np.ndarray:
    """numpy twin of mmtpu.ops.posenc.positional_encoding."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    chan = np.arange(p)
    even = (chan // 2) * 2
    inv_freq = np.power(10000.0, -(even.astype(np.float32) / p))
    angles = pos * inv_freq[None, :]
    return np.where((chan % 2) == 0, np.sin(angles), np.cos(angles)).astype(
        np.float32
    )


def _np_add_positional(data: np.ndarray, p: int, bug_parity: bool) -> np.ndarray:
    """numpy twin of mmtpu.ops.posenc.add_positional_embeddings."""
    n, seq_len = data.shape[0], data.shape[1]
    if not bug_parity:
        pe = np.broadcast_to(_np_positional_encoding(seq_len, p)[None], (n, seq_len, p))
        return np.concatenate([data, pe], axis=-1).astype(np.float32)
    pos = np.arange(seq_len, dtype=np.float32)
    idxes = np.tile(pos[None, :, None], (n, 1, p)).astype(np.float32)
    out = idxes.copy()
    for i in range(p // 2):
        if 2 * i >= n:
            break
        scale = 10000.0 ** (2 * i / p)
        out[2 * i] = np.sin(idxes[2 * i] / scale)
        if 2 * i + 1 < n:
            out[2 * i + 1] = np.cos(idxes[2 * i + 1] / scale)
    return np.concatenate([data, out], axis=-1).astype(np.float32)


@dataclasses.dataclass
class PreparedData:
    """Ready-to-train view of one dataset (host numpy arrays; the runner
    moves them to its device)."""

    name: str
    vocab_embeddings: np.ndarray  # (V, D) — pre-normalized iff dot_prod metric
    word_weights: np.ndarray  # (V,)
    splits: Dict[str, Dict[str, np.ndarray]]  # fit_latents data dicts
    labels: Dict[str, np.ndarray]
    sif_init: Dict[str, np.ndarray]  # (N, D) cold-start embeddings per split
    embed_dim: int
    audio_dim: int  # incl. baked positional channels, if any
    visual_dim: int
    text_gauss_dim: int
    pos_table: Optional[np.ndarray] = None  # (L, sum(pos_dims)) in "shared" mode
    pos_dims: Optional[tuple] = None  # sorted unique block widths of pos_table
    synthetic: bool = False


def _gauss_text(split_arrays, word_embeddings, name):
    """The Gaussian 'text' stream: warped GloVe gather for MOSI, the aligned
    embeddings for POM/IEMOCAP (simplesif.py:86-91, 319-344)."""
    if name == "mosi":
        ids = split_arrays["text"]
        return None, ids  # gathered later (shared with word-prob stream)
    return split_arrays["text"].astype(np.float32), split_arrays["text_id"]


def prepare_device_data(
    dataset: Dict,
    word_sim_metric: str = "angular",
    pos_embed_dim: int = 0,
    pos_mode: str = "baked",
    pos_max_dim: Optional[int] = None,
    pos_dims: Optional[tuple] = None,
    pos_bug_parity: bool = False,
    normalize_parity: bool = True,
    max_text_len: Optional[int] = None,
    suff_stats: bool = True,
) -> PreparedData:
    """Turn a :func:`mmtpu_torch.data.registry.load_dataset` result into device arrays.

    ``suff_stats=True`` additionally precomputes the per-(utterance, feature)
    Gaussian sufficient statistics ``<stream>_s0/s1/s2`` (and per-channel
    stats for the shared positional table), letting the training step skip
    the sequence axis for every Gaussian head — mathematically exact (see
    ``mmtpu.ops.gaussian.gaussian_logpdf_suffstats``).
    """
    name = dataset["name"]
    we = np.asarray(dataset["word_embeddings"], np.float32)
    ww = np.asarray(dataset["word_weights"], np.float32)
    if word_sim_metric == "dot_prod":
        # reference normalizes the vocab for dot_prod (simplesif.py:292-293)
        we = we / np.linalg.norm(we, axis=-1, keepdims=True)

    splits_out: Dict[str, Dict[str, np.ndarray]] = {}
    labels: Dict[str, np.ndarray] = {}
    sif_init: Dict[str, np.ndarray] = {}

    pos_table = None
    pos_blocks: Optional[tuple] = None
    if pos_mode == "shared" and (pos_embed_dim > 0 or pos_dims):
        # one exact standalone encoding block per unique dim (see module
        # docstring) — ``pos_dims`` is what a sweep passes; the legacy
        # single-dim path degenerates to one block
        if pos_dims:
            pos_blocks = tuple(sorted({int(p) for p in pos_dims if p > 0}))
        else:
            pos_blocks = (int(pos_max_dim or pos_embed_dim),)
        some_split = next(iter(dataset["splits"].values()))
        seq_len = some_split["covarep"].shape[1]
        pos_table = np.concatenate(
            [_np_positional_encoding(seq_len, p) for p in pos_blocks], axis=-1
        )

    a_dim = v_dim = tg_dim = None
    for split, arrays in dataset["splits"].items():
        covarep, facet, masks = normalize_split(
            arrays["covarep"], arrays["facet"], parity=normalize_parity
        )
        aligned, ids = _gauss_text(arrays, we, name)
        ids = np.asarray(ids, np.int64)
        if max_text_len is not None and ids.shape[1] > max_text_len:
            ids = ids[:, :max_text_len]

        token_mask = text_token_mask(ids)
        w_tok = _np_seq_weights(ids, ww)
        sif_init[split] = _np_sif_embedding(we, ids, w_tok)
        ids_clamped = np.where(ids >= 0, ids, 0).astype(np.int32)

        if pos_embed_dim > 0 and pos_mode == "baked":
            covarep = _np_add_positional(covarep, pos_embed_dim, pos_bug_parity)
            facet = _np_add_positional(facet, pos_embed_dim, pos_bug_parity)
            n, L = masks["covarep"].shape[:2]
            ext = np.ones((n, L, pos_embed_dim), np.int64)
            masks["covarep"] = np.concatenate([masks["covarep"], ext], -1)
            masks["facet"] = np.concatenate([masks["facet"], ext], -1)

        # the word-likelihood stream is stored as token IDS — per-token word
        # vectors are gathered from the vocab table inside the training step
        # (see mmtpu_torch.train.latents._word_logprob), never materialized as an
        # (N, L, D) array; at POM's real 1357-token rows that array would be
        # ~2 GB of HBM for ~5 MB of ids
        d: Dict[str, np.ndarray] = {
            "text_ids": ids_clamped,
            "text_weights": w_tok,
            "text_mask": token_mask,
            "audio": covarep.astype(np.float32),
            "audio_mask": masks["covarep"].astype(np.float32),
            "visual": facet.astype(np.float32),
            "visual_mask": masks["facet"].astype(np.float32),
        }
        if aligned is None:  # MOSI: gaussian text stream == word-prob stream
            d["text_gauss"] = we[ids_clamped]
            d["text_gauss_mask"] = d["text_mask"]
        else:
            d["text_gauss"] = aligned
            d["text_gauss_mask"] = aligned_text_mask(aligned)
        if pos_table is not None:
            d["pos_table"] = pos_table
            d["pos_mask"] = np.ones((pos_table.shape[-1],), np.float32)

        if suff_stats:
            def _stats(x, m):
                m3 = m[:, :, None] if m.ndim == 2 else m
                mv = (m3 * x).astype(np.float64)
                return (
                    np.broadcast_to(m3, x.shape).sum(-2).astype(np.float32),
                    mv.sum(-2).astype(np.float32),
                    (mv * x).sum(-2).astype(np.float32),
                )

            for stream, mask_key in (("audio", "audio_mask"),
                                     ("visual", "visual_mask"),
                                     ("text_gauss", "text_gauss_mask")):
                s0, s1, s2 = _stats(d[stream], d[mask_key])
                d[f"{stream}_s0"], d[f"{stream}_s1"], d[f"{stream}_s2"] = s0, s1, s2
            if pos_table is not None:
                # shared-table stats per channel (mask is all-ones over L)
                pt = pos_table.astype(np.float64)
                d["pos_s0"] = np.full((pos_table.shape[-1],), pos_table.shape[0],
                                      np.float32)
                d["pos_s1"] = pt.sum(0).astype(np.float32)
                d["pos_s2"] = (pt * pt).sum(0).astype(np.float32)

        splits_out[split] = d
        labels[split] = np.asarray(arrays["label"], np.float32)
        a_dim = d["audio"].shape[-1]
        v_dim = d["visual"].shape[-1]
        tg_dim = d["text_gauss"].shape[-1]

    return PreparedData(
        name=name,
        vocab_embeddings=we,
        word_weights=ww,
        splits=splits_out,
        labels=labels,
        sif_init=sif_init,
        embed_dim=we.shape[-1],
        audio_dim=int(a_dim),
        visual_dim=int(v_dim),
        text_gauss_dim=int(tg_dim),
        pos_table=pos_table,
        pos_dims=pos_blocks,
        synthetic=bool(dataset.get("synthetic", False)),
    )
