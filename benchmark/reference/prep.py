"""The reference's data preparation, from the raw dataset (numpy): per-split
normalisation and masks, the SIF sentence embeddings that start the fits,
the positional channels, and the observation tensors of the decoder's
heads.  It follows the published baselines' data section (utils.py,
sif_functions.py and simplesif.py of N19-1267's code, as its loaders read
MOSI and POM), including their quirks:

- audio features constant over a split are dropped; masks are ``x != 0``
  taken before scaling; scaling is ``(x + min) * 2 / (max - min) - 1``
  (a ``+min`` where min-max scaling has ``-min``); padding becomes -10;
- a token's SIF weight is its word's weight, padding id 0 included, and a
  row's average divides by the count of nonzero weights;
- the first principal component (of the rows' Gram matrix) is removed;
- the positional channels are the sinusoidal encoding of the 20 aligned
  steps at the config's own width, appended to audio and visual with mask 1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.generate import HEAD_SEGMENTS, MMB2_HEADS


def normalize(covarep: np.ndarray, facet: np.ndarray):
    covarep = np.array(covarep, np.float32)
    facet = np.array(facet, np.float32)
    keep = covarep.max((0, 1)) != covarep.min((0, 1))
    covarep = covarep[:, :, keep]
    out = []
    for x in (covarep, facet):
        pad = x == 0
        lo, hi = x.min((0, 1)), x.max((0, 1))
        y = (x + lo) * 2.0 / (hi - lo) - 1.0
        y[pad] = -10.0
        out.append((y.astype(np.float32), (~pad).astype(np.float32)))
    return out


def sif(word_embeddings: np.ndarray, ids: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Weighted average of the tokens' vectors, first principal component
    removed (float32 products, as the baselines compute them)."""
    w = weights[ids].astype(np.float32)
    emb = np.einsum("nl,nld->nd", w, word_embeddings[ids]) / np.maximum(
        (w != 0).sum(-1), 1)[:, None]
    emb = emb.astype(np.float32)
    _, vecs = np.linalg.eigh(emb.T @ emb)
    pc = vecs[:, -1] / np.linalg.norm(vecs[:, -1])
    return emb - (emb @ pc)[:, None] * pc[None, :]


def positional(seq_len: int, p: int) -> np.ndarray:
    """``(L, p)``: sin on even channels, cos on odd, frequency
    ``10000 ** -(2 floor(c / 2) / p)``."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    chan = np.arange(p)
    inv = np.power(10000.0, -(((chan // 2) * 2).astype(np.float32) / p))
    ang = pos * inv[None, :]
    return np.where(chan % 2 == 0, np.sin(ang), np.cos(ang)).astype(np.float32)


def prepare(dataset: Dict, pos_dims: tuple, device) -> Dict:
    """Per split on ``device``: ``init`` (SIF, ``(N, D)``), ``obs`` and
    ``obs_mask`` (``(N, L, F)``: every head's observations side by side in
    the heads' order, with every positional block after each audio and
    visual segment), ``ids``, ``tok_w`` and ``tok_mask`` (``(N, T)``, the
    word term's tokens) and ``label``; and ``vocab``, ``pos_dims``, the
    column layout ``layout`` (one ``(stream, start, width)`` per segment
    column block, ``stream`` "pos<p>" for a positional block) and the head
    widths, for :func:`pos_column_mask`."""
    we, ww = dataset["word_embeddings"], dataset["word_weights"]
    name = dataset["name"]
    out = {"vocab": torch.as_tensor(we, device=device), "pos_dims": tuple(pos_dims)}
    for split, arrays in dataset["splits"].items():
        (audio, a_mask), (visual, v_mask) = normalize(arrays["covarep"], arrays["facet"])
        n, steps = audio.shape[:2]
        if name == "mosi":
            ids = arrays["text"]
            text, t_mask = we[ids], np.repeat((ids != 0)[:, :, None], we.shape[1], axis=2)
        else:
            ids = arrays["text_id"]
            text = arrays["text"].astype(np.float32)
            t_mask = np.repeat(np.all(text != 0, axis=-1)[:, :, None], text.shape[2], axis=2)
        pos = [np.broadcast_to(positional(steps, p)[None], (n, steps, p)) for p in pos_dims]
        ones = [np.ones((n, steps, p), np.float32) for p in pos_dims]
        streams = {"text": (text, t_mask), "audio": (audio, a_mask), "visual": (visual, v_mask)}
        cols, masks, layout, ofs = [], [], [], 0
        for h in MMB2_HEADS:
            for seg in HEAD_SEGMENTS[h]:
                x, m = streams[seg]
                blocks = [(seg, x, m)]
                if seg != "text":
                    blocks += [(f"pos{p}", pe, o) for p, pe, o in zip(pos_dims, pos, ones)]
                for tag, x, m in blocks:
                    cols.append(x)
                    masks.append(m.astype(np.float32))
                    layout.append((tag, ofs, x.shape[-1]))
                    ofs += x.shape[-1]
        out[split] = {
            "init": torch.as_tensor(sif(we, ids, ww), device=device),
            "obs": torch.as_tensor(np.concatenate(cols, -1), device=device),
            "obs_mask": torch.as_tensor(np.concatenate(masks, -1), device=device),
            "ids": torch.as_tensor(ids, device=device),
            "tok_w": torch.as_tensor(ww[ids], device=device),
            "tok_mask": torch.as_tensor((ids != 0).astype(np.float32), device=device),
            "label": torch.as_tensor(np.asarray(arrays["label"], np.float32), device=device),
        }
        out["layout"] = layout
    return out


def pos_column_mask(prep: Dict, pos_dim: int) -> torch.Tensor:
    """``(F,)``: 1 on every observation column a config of positional width
    ``pos_dim`` models, 0 on the other positional blocks."""
    width = sum(w for _, _, w in prep["layout"])
    mask = torch.ones(width, device=prep["vocab"].device)
    for tag, start, w in prep["layout"]:
        if tag.startswith("pos") and tag != f"pos{pos_dim}":
            mask[start:start + w] = 0.0
    return mask
