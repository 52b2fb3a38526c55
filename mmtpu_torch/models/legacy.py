"""Legacy and auxiliary model family (port of :mod:`mmtpu.models.legacy`).

- :func:`init_audio_visual_generator` / :func:`apply_audio_visual_generator`:
  the bimodal ``AudioVisualGenerator`` (``models.py:204-253``) of the legacy
  alternating driver (:mod:`mmtpu_torch.train.alternating`).
- :func:`init_concat_generator` / :func:`apply_concat_generator`:
  ``AudioVisualGeneratorConcat`` (``models.py:5-49``), separate audio and
  visual latent slices with their own heads, and its random-slice latent
  init :func:`concat_init_embeddings`.
- :func:`init_autoencoder` / :func:`apply_autoencoder`: the two-layer MLP
  ``Autoencoder`` (``models.py:51-70``).
- :func:`init_lstm_autoencoder` / :func:`apply_lstm_autoencoder`:
  ``LSTMAutoencoder`` (``models.py:72-105``), an LSTM encoder and a
  teacher-forced LSTM decoder, written out cell by cell (gate order i, f, g,
  o, as ``torch.nn.LSTM``) so that parameters converted from mmtpu give
  mmtpu's outputs.

Parameters are nested dicts in mmtpu's layout (``(in, out)`` weights), drawn
from an explicit ``torch.Generator`` on the CPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mmtpu_torch.models.init import torch_linear_init


def _linear(p, x):
    return x @ p["w"] + p["b"]


def init_audio_visual_generator(gen: torch.Generator, embed_dim, audio_dim, visual_dim) -> dict:
    """``models.py:204-220``: {audio, visual} x {mu, log_sigma} linear heads."""
    return {mod: {"mu": torch_linear_init(gen, embed_dim, dim),
                  "log_sigma": torch_linear_init(gen, embed_dim, dim)}
            for mod, dim in (("audio", audio_dim), ("visual", visual_dim))}


def apply_audio_visual_generator(params, embeddings) -> tuple:
    """``models.py:241-253``: ``((audio_mu, audio_sigma), (visual_mu,
    visual_sigma))``, sigma exponentiated."""
    return tuple((_linear(params[mod]["mu"], embeddings),
                  torch.exp(_linear(params[mod]["log_sigma"], embeddings)))
                 for mod in ("audio", "visual"))


def init_concat_generator(gen: torch.Generator, audio_embed_dim, visual_embed_dim, audio_dim,
                          visual_dim) -> dict:
    """``models.py:5-21``: heads over separate audio and visual latent slices."""
    return {
        "audio_embed_dim": audio_embed_dim,
        "visual_embed_dim": visual_embed_dim,
        "audio": {"mu": torch_linear_init(gen, audio_embed_dim, audio_dim),
                  "log_sigma": torch_linear_init(gen, audio_embed_dim, audio_dim)},
        "visual": {"mu": torch_linear_init(gen, visual_embed_dim, visual_dim),
                   "log_sigma": torch_linear_init(gen, visual_embed_dim, visual_dim)},
    }


def apply_concat_generator(params, audio_embed, visual_embed) -> tuple:
    """``models.py:33-40``."""
    return tuple((_linear(params[mod]["mu"], x), torch.exp(_linear(params[mod]["log_sigma"], x)))
                 for mod, x in (("audio", audio_embed), ("visual", visual_embed)))


def concat_init_embeddings(gen: torch.Generator, word_embeddings, audio_embed_dim,
                           visual_embed_dim) -> torch.Tensor:
    """``models.py:42-49``: word embeddings followed by normal random audio
    and visual latent slices."""
    n = word_embeddings.shape[0]
    aud = torch.randn((n, audio_embed_dim), generator=gen).to(word_embeddings.device)
    vis = torch.randn((n, visual_embed_dim), generator=gen).to(word_embeddings.device)
    return torch.cat([word_embeddings, aud, vis], dim=1)


def init_autoencoder(gen: torch.Generator, latent_dim, hidden_dim, embedding_dim, audio_dim,
                     visual_dim) -> dict:
    """``models.py:51-61``."""
    out_dim = embedding_dim + audio_dim + visual_dim
    return {"encoder": torch_linear_init(gen, out_dim, hidden_dim),
            "encoder2": torch_linear_init(gen, hidden_dim, latent_dim),
            "decoder": torch_linear_init(gen, latent_dim, hidden_dim),
            "decoder2": torch_linear_init(gen, hidden_dim, out_dim)}


def apply_autoencoder(params, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``models.py:63-70``: ``(latent, reconstruction)``."""
    latent = _linear(params["encoder2"], torch.relu(_linear(params["encoder"], inputs)))
    out = _linear(params["decoder2"], torch.relu(_linear(params["decoder"], latent)))
    return latent, out


def _init_lstm(gen: torch.Generator, in_dim, hidden_dim) -> dict:
    """One ``torch.nn.LSTM`` layer's init law: every weight and bias
    uniform on ``(-k, k)``, ``k = 1/sqrt(hidden_dim)``; ``(in, 4H)`` weights."""
    bound = 1.0 / math.sqrt(hidden_dim)
    u = lambda *shape: torch.empty(shape).uniform_(-bound, bound, generator=gen)  # noqa: E731
    return {"w_ih": u(in_dim, 4 * hidden_dim), "w_hh": u(hidden_dim, 4 * hidden_dim),
            "b_ih": u(4 * hidden_dim), "b_hh": u(4 * hidden_dim)}


def _lstm_cell(params, x, h, c):
    gates = x @ params["w_ih"] + params["b_ih"] + h @ params["w_hh"] + params["b_hh"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)  # torch's gate order
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c2), c2


def _lstm_run(params, xs, h, c):
    """The cell over ``xs`` ``(L, B, F)``: ``(outputs (L, B, H), (h, c))``."""
    ys = []
    for x in xs:
        h, c = _lstm_cell(params, x, h, c)
        ys.append(h)
    return torch.stack(ys), (h, c)


def init_lstm_autoencoder(gen: torch.Generator, latent_dim, embedding_dim, audio_dim,
                          visual_dim) -> dict:
    """``models.py:72-81``."""
    out_dim = embedding_dim + audio_dim + visual_dim
    return {"encoder": _init_lstm(gen, out_dim, latent_dim),
            "decoder": _init_lstm(gen, out_dim, latent_dim),
            "pred": torch_linear_init(gen, latent_dim, out_dim)}


def apply_lstm_autoencoder(params, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``models.py:83-105``: encode the sequence, then decode teacher-forced
    (the decoder's input at step i is the original input at step i-1, zeros
    first), projecting each hidden state to a reconstruction.

    ``inputs`` is ``(B, L, F)``; returns ``(latents (B, H), reconstruction
    (B, L, F))``.
    """
    b, _, f = inputs.shape
    xs = inputs.transpose(0, 1)  # (L, B, F)
    h0 = inputs.new_zeros((b, params["pred"]["w"].shape[0]))
    _, (h_enc, c_enc) = _lstm_run(params["encoder"], xs, h0, torch.zeros_like(h0))
    dec_in = torch.cat([inputs.new_zeros((1, b, f)), xs[:-1]], dim=0)
    ys, _ = _lstm_run(params["decoder"], dec_in, h_enc, c_enc)
    return h_enc, _linear(params["pred"], ys).transpose(0, 1)
