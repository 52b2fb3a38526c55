"""The one general generator: what a run makes from ``--seed``.

- :func:`synthesize_dataset`: a frozen copy of the port's synthetic data
  (``mmtpu_torch/data/synthetic.py``): the real datasets' shapes, seeded
  stand-ins for their values, a planted latent that drives the modalities
  and the label.
- :func:`make_grid`: a frozen copy of the reference grid (512 configs, the
  Cartesian product in ``configs/make_configs.py``'s key order, shuffled by
  a seeded ``random.Random``, each stamped with its ``config_num``).
- :func:`call_configs`: the configs of each call of a traffic mix: a bucket
  of the grid cut into slices taken in turn, cycling.
- :class:`Draws`: one config's initial parameters and permutations,
  from generators seeded from ``(seed, call, config_num)``; the port takes
  them through ``run_sweep``'s ``draws=`` hook and the reference makes the
  same from the same key.

Nothing here imports the program: the reference uses it too.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Dict, List

import numpy as np
import torch

GRID_PARAMS = {
    "sentiment_hidden_size": [100, 150],
    "lr": [1e-3, 1e-4],
    "sentiment_lr": [1e-1, 1e-2],
    "seq_len": [20],
    "word_sim_metric": ["angular"],
    "n_epochs": [100, 200],
    "freeze_weights": [False],
    "n_sentiment_epochs": [400],
    "word_loss_weight": [0.001, 0.002],
    "likelihood_weight": [0.0001, 0.001],
    "pos_embed_dim": [2, 4],
    "e2e": [True],
    "norm": ["layer_norm", "batch_norm"],
    "optimizer": ["sgd", "adam"],
}

MMB2_HEADS = ("audio", "visual", "audiovisual", "textaudio", "textvisual", "textaudiovisual")
HEAD_SEGMENTS = {
    "audio": ("audio",),
    "visual": ("visual",),
    "audiovisual": ("audio", "visual"),
    "textaudio": ("text", "audio"),
    "textvisual": ("text", "visual"),
    "textaudiovisual": ("text", "audio", "visual"),
}


def make_grid(shuffle_seed: int = 0) -> List[dict]:
    """The 512 grid configs, shuffled by ``shuffle_seed``, numbered in order."""
    keys = list(GRID_PARAMS)
    configs = [dict(zip(keys, combo)) for combo in itertools.product(*GRID_PARAMS.values())]
    random.Random(shuffle_seed).shuffle(configs)
    for i, c in enumerate(configs):
        c["config_num"] = i
    return configs


def bucket(traffic: dict) -> List[dict]:
    """The traffic's bucket of the grid: its optimizer and epoch count, in
    the shuffled grid's order."""
    return [c for c in make_grid(traffic["grid_shuffle_seed"])
            if c["optimizer"] == traffic["optimizer"] and c["n_epochs"] == traffic["n_epochs"]]


def call_configs(traffic: dict, call: int) -> List[dict]:
    """Call ``call``'s configs: successive slices of ``configs_per_call``
    configs of the bucket, cycling."""
    configs = bucket(traffic)
    k = traffic["configs_per_call"]
    start = (call * k) % len(configs)
    return [configs[(start + i) % len(configs)] for i in range(k)]


def _seed(*key: int) -> int:
    """A 63-bit seed from a key of whole numbers of any size."""
    return int(np.random.SeedSequence([int(k) % 2**64 for k in key]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


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


def synthesize_dataset(name: str, n_train: int, n_valid: int, n_test: int, seq_len: int,
                       vocab_size: int, embed_dim: int, audio_dim: int, visual_dim: int,
                       seed: int, text_len: int = 0) -> Dict:
    """``{name, word_embeddings, word_weights, splits: {train/valid/test}}``
    with the real datasets' shapes: MOSI's ``text`` are word ids ``(N, L)``
    with a scalar label; POM's ``text`` are the aligned word vectors ``(N,
    L, D)`` beside ``text_id`` rows of ``text_len`` tokens, with 17 trait
    labels."""
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
            splits[split] = {"text": ids, "covarep": covarep, "facet": facet, "label": label,
                             "lengths": lengths, "id": np.arange(n, dtype=np.int64)}
        elif name == "pom":
            if text_len and text_len != seq_len:
                text_ids, _ = _tokens(rng, n, text_len, vocab_size, mean_len=text_len * 0.5)
            else:
                text_ids = ids
            aligned = word_embeddings[ids] * (ids != 0)[:, :, None]
            w_y = rng.standard_normal((8, 17)).astype(np.float32) * 0.5
            label = (hidden @ w_y + 4.0).astype(np.float32)  # traits ~[1, 7]
            splits[split] = {"text": aligned.astype(np.float32), "text_id": text_ids,
                             "covarep": covarep, "facet": facet, "label": label}
        else:
            raise ValueError(f"no synthetic stand-in for dataset {name!r}")
    return {"name": name, "word_embeddings": word_embeddings, "word_weights": word_weights,
            "splits": splits, "synthetic": True}


def dataset_for(config: dict, seed: int) -> Dict:
    """The configuration's dataset at its geometry, drawn from ``seed``."""
    g = config["geometry"]
    return synthesize_dataset(config["dataset"], g["n_train"], g["n_valid"], g["n_test"],
                              g["seq_len"], g["vocab_size"], g["embed_dim"], g["audio_dim"],
                              g["visual_dim"], seed=_seed(seed, 0), text_len=g["text_len"])


def _uniform(gen: torch.Generator, shapes: list, bounds: list) -> list:
    """Tensors of ``shapes``, each uniform on ``(-bound, bound)``, from one
    draw of ``gen`` (the torch-``nn.Linear`` law)."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.rand(sum(sizes), generator=gen) * 2.0 - 1.0
    out, ofs = [], 0
    for s, n, b in zip(shapes, sizes, bounds):
        out.append((flat[ofs:ofs + n] * b).reshape(s))
        ofs += n
    return out


def head_width(head: str, text_dim: int, audio_dim: int, visual_dim: int) -> int:
    sizes = {"text": text_dim, "audio": audio_dim, "visual": visual_dim}
    return sum(sizes[s] for s in HEAD_SEGMENTS[head])


class Draws:
    """One config's draws for ``run_sweep``'s ``draws=`` hook (the
    interface of ``mmtpu_torch.sweep.runner.SweepDraws``), on the CPU: the
    decoder and the sentiment MLP by the torch-``nn.Linear`` law, and each
    epoch's permutation, each kind from its own generator seeded from
    ``(seed, call, config_num, kind)``.  The parameter layout is the
    program's public one (``{"heads": {name: {w_mu, b_mu, w_log_sigma,
    b_log_sigma}}, "norm": {scale, bias}}``, ``(in, out)`` weights)."""

    def __init__(self, seed: int, call: int, config_num: int):
        self.key = (seed, call, config_num)

    def _gen(self, kind: int) -> torch.Generator:
        return torch.Generator().manual_seed(_seed(*self.key, kind))

    def init_decoder(self, embed_dim, audio_dim, visual_dim, unimodal, text_dim) -> dict:
        if unimodal:
            raise ValueError("the benchmark runs MMB2 only")
        text_dim = embed_dim if text_dim is None else text_dim
        widths = [head_width(h, text_dim, audio_dim, visual_dim) for h in MMB2_HEADS]
        shapes = [s for f in widths for s in ((embed_dim, f), (f,)) * 2]
        leaves = _uniform(self._gen(1), shapes, [1.0 / math.sqrt(embed_dim)] * len(shapes))
        heads = {}
        for i, h in enumerate(MMB2_HEADS):
            w_mu, b_mu, w_ls, b_ls = leaves[4 * i:4 * i + 4]
            heads[h] = {"w_mu": w_mu, "b_mu": b_mu, "w_log_sigma": w_ls, "b_log_sigma": b_ls}
        return {"heads": heads, "norm": {"scale": torch.ones(embed_dim),
                                         "bias": torch.zeros(embed_dim)}}

    def init_sentiment(self, embed_dim, hidden_dim, n_out, hidden_pad) -> dict:
        hidden_dim, n_out = int(hidden_dim), int(n_out)
        w1, b1, w2, b2 = _uniform(
            self._gen(2), [(embed_dim, hidden_dim), (hidden_dim,), (hidden_dim, n_out),
                           (n_out,)],
            [1.0 / math.sqrt(embed_dim)] * 2 + [1.0 / math.sqrt(hidden_dim)] * 2)
        if hidden_pad is not None and hidden_pad > hidden_dim:
            pad = hidden_pad - hidden_dim
            w1 = torch.nn.functional.pad(w1, (0, pad))
            b1 = torch.nn.functional.pad(b1, (0, pad))
            w2 = torch.nn.functional.pad(w2, (0, 0, 0, pad))
        return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}

    def _perms(self, kind: int, n: int, n_epochs: int) -> list:
        keys = torch.rand((n_epochs, n), generator=self._gen(kind))
        return list(torch.argsort(keys, dim=1))

    def train_permutations(self, n: int, n_epochs: int) -> list:
        return self._perms(3, n, n_epochs)

    def sentiment_permutations(self, n: int, n_epochs: int) -> list:
        return self._perms(4, n, n_epochs)
