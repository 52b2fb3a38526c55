"""MMB1/MMB2 generative decoder as a parameter dict (port of
:mod:`mmtpu.models.decoder`).

Per-modality-subset pairs of linear heads predict the mean and log-stdev of
diagonal Gaussians, with an optional LayerNorm / train-mode BatchNorm on the
latent before the heads.  Parameters keep mmtpu's layout,
``{"heads": {name: {w_mu, b_mu, w_log_sigma, b_log_sigma}}, "norm": {scale,
bias}}`` with ``(in, out)`` weights, so :mod:`mmtpu_torch.convert` moves them
between the packages unchanged.  The stacked layout (``stack_decoder``) serves
only the fused decoder-update kernel, which is not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from mmtpu_torch.models.init import torch_linear_init

MMB1_HEADS: Tuple[str, ...] = ("audio", "visual")
MMB2_HEADS: Tuple[str, ...] = (
    "audio",
    "visual",
    "audiovisual",
    "textaudio",
    "textvisual",
    "textaudiovisual",
)

_SEGMENTS = {
    "audio": ("audio",),
    "visual": ("visual",),
    "audiovisual": ("audio", "visual"),
    "textaudio": ("text", "audio"),
    "textvisual": ("text", "visual"),
    "textaudiovisual": ("text", "audio", "visual"),
}

NORM_NONE = 0
NORM_LAYER = 1
NORM_BATCH = 2
NORM_CODES = {None: NORM_NONE, "layer_norm": NORM_LAYER, "batch_norm": NORM_BATCH}

_NORM_EPS = 1e-5  # torch LayerNorm / BatchNorm1d default


def head_segments(head: str) -> Tuple[str, ...]:
    """Base-stream composition of a head ("text" = the Gaussian text stream)."""
    return _SEGMENTS[head]


def head_dims(head: str, text_dim: int, audio_dim: int, visual_dim: int) -> int:
    """Output feature dim of a head."""
    sizes = {"text": text_dim, "audio": audio_dim, "visual": visual_dim}
    return sum(sizes[s] for s in head_segments(head))


def init_decoder(gen: torch.Generator, embed_dim: int, audio_dim: int, visual_dim: int,
                 unimodal: bool = False, text_dim: int | None = None) -> dict:
    """Decoder parameters by the torch-Linear init law, drawn from ``gen`` on
    the CPU.

    MMB1 (``unimodal=True``) has only the {audio, visual} heads; MMB2 adds
    every pair and the triple.  Norm parameters (scale 1, bias 0) are always
    present, so the dict's structure does not depend on the norm.
    """
    if text_dim is None:
        text_dim = embed_dim
    heads = MMB1_HEADS if unimodal else MMB2_HEADS
    params: dict = {"heads": {}, "norm": {
        "scale": torch.ones((embed_dim,)),
        "bias": torch.zeros((embed_dim,)),
    }}
    for name in heads:
        out_dim = head_dims(name, text_dim, audio_dim, visual_dim)
        mu = torch_linear_init(gen, embed_dim, out_dim)
        ls = torch_linear_init(gen, embed_dim, out_dim)
        params["heads"][name] = {
            "w_mu": mu["w"], "b_mu": mu["b"],
            "w_log_sigma": ls["w"], "b_log_sigma": ls["b"],
        }
    return params


def apply_norm(x: torch.Tensor, norm_params: Mapping[str, torch.Tensor], norm_code,
               batch_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Branchless none / LayerNorm / train-mode BatchNorm on ``(B, D)``.

    LayerNorm over features; BatchNorm with batch statistics everywhere (the
    reference never calls ``.eval()``).  Both use biased variance and eps
    1e-5.  ``batch_weights`` are ``(B,)`` 0/1 row-validity weights: padded
    rows are left out of the batch statistics.  ``norm_code`` may be an int
    or a 0-d tensor; all three results are computed and one is selected.
    """
    scale, bias = norm_params["scale"], norm_params["bias"]
    ln_mean = torch.mean(x, dim=-1, keepdim=True)
    ln_var = torch.var(x, dim=-1, keepdim=True, correction=0)
    ln = (x - ln_mean) / torch.sqrt(ln_var + _NORM_EPS) * scale + bias
    if batch_weights is None:
        bn_mean = torch.mean(x, dim=0, keepdim=True)
        bn_var = torch.var(x, dim=0, keepdim=True, correction=0)
    else:
        w = batch_weights[:, None]
        denom = torch.clamp_min(torch.sum(w), 1.0)
        bn_mean = torch.sum(x * w, dim=0, keepdim=True) / denom
        bn_var = torch.sum(torch.square(x - bn_mean) * w, dim=0, keepdim=True) / denom
    bn = (x - bn_mean) / torch.sqrt(bn_var + _NORM_EPS) * scale + bias
    code = torch.as_tensor(norm_code, device=x.device)
    return torch.where(code == NORM_LAYER, ln, torch.where(code == NORM_BATCH, bn, x))


def apply_decoder(params: Mapping, latents: torch.Tensor, norm_code=NORM_NONE,
                  batch_weights: torch.Tensor | None = None) -> dict:
    """Latent -> ``{head: {"mu": (B, F_h), "sigma": (B, F_h)}}`` with
    ``mu = x @ w_mu + b_mu`` and ``sigma = exp(x @ w_log_sigma + b_log_sigma)``."""
    x = apply_norm(latents, params["norm"], norm_code, batch_weights)
    out = {}
    for name, h in params["heads"].items():
        mu = x @ h["w_mu"] + h["b_mu"]
        sigma = torch.exp(x @ h["w_log_sigma"] + h["b_log_sigma"])
        out[name] = {"mu": mu, "sigma": sigma}
    return out
