"""MMB1/MMB2 generative decoder as a parameter dict (port of
:mod:`mmtpu.models.decoder`).

Per-modality-subset pairs of linear heads predict the mean and log-stdev of
diagonal Gaussians, with an optional LayerNorm / train-mode BatchNorm on the
latent before the heads.  Parameters keep mmtpu's layout,
``{"heads": {name: {w_mu, b_mu, w_log_sigma, b_log_sigma}}, "norm": {scale,
bias}}`` with ``(in, out)`` weights, so :mod:`mmtpu_torch.convert` moves them
between the packages unchanged.  The stacked layout (:func:`stack_decoder`,
one ``(D, sum F_h)`` weight pair for all heads) is what the fused
decoder-update kernel K2 (:mod:`mmtpu_torch.kernels.decoder_update`) works on.

Every leaf may carry a leading config axis (the sweep's K configs): latents
``(K, B, D)``, weights ``(K, D, F)``, biases and norm parameters ``(K, F)``,
``norm_code`` ``(K,)``; dims are counted from the end
(:func:`mmtpu_torch.tree.per_config`).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from mmtpu_torch.models.init import torch_linear_init
from mmtpu_torch.tree import per_config, rowwise

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
    """Branchless none / LayerNorm / train-mode BatchNorm on ``(B, D)``, or
    on ``(K, B, D)`` with per-config parameters.

    LayerNorm over features; BatchNorm with batch statistics over the row
    axis, per config (the reference never calls ``.eval()``).  Both use
    biased variance and eps 1e-5.  ``batch_weights`` are ``(B,)`` 0/1
    row-validity weights: padded rows are left out of the batch statistics.
    ``norm_code`` may be an int, a 0-d tensor or a ``(K,)`` tensor; all three
    results are computed and one is selected per config.
    """
    scale, bias = rowwise(norm_params["scale"]), rowwise(norm_params["bias"])
    ln_mean = torch.mean(x, dim=-1, keepdim=True)
    ln_var = torch.var(x, dim=-1, keepdim=True, correction=0)
    ln = (x - ln_mean) / torch.sqrt(ln_var + _NORM_EPS) * scale + bias
    if batch_weights is None:
        bn_mean = torch.mean(x, dim=-2, keepdim=True)
        bn_var = torch.var(x, dim=-2, keepdim=True, correction=0)
    else:
        w = batch_weights[..., None]
        denom = torch.clamp_min(torch.sum(w, dim=-2, keepdim=True), 1.0)
        bn_mean = torch.sum(x * w, dim=-2, keepdim=True) / denom
        bn_var = torch.sum(torch.square(x - bn_mean) * w, dim=-2, keepdim=True) / denom
    bn = (x - bn_mean) / torch.sqrt(bn_var + _NORM_EPS) * scale + bias
    code = per_config(torch.as_tensor(norm_code, device=x.device), x.ndim)
    return torch.where(code == NORM_LAYER, ln, torch.where(code == NORM_BATCH, bn, x))


def apply_decoder(params: Mapping, latents: torch.Tensor, norm_code=NORM_NONE,
                  batch_weights: torch.Tensor | None = None) -> dict:
    """Latent -> ``{head: {"mu": (B, F_h), "sigma": (B, F_h)}}`` with
    ``mu = x @ w_mu + b_mu`` and ``sigma = exp(x @ w_log_sigma + b_log_sigma)``
    (``(K, B, F_h)`` under a config axis)."""
    x = apply_norm(latents, params["norm"], norm_code, batch_weights)
    out = {}
    for name, h in params["heads"].items():
        mu = x @ h["w_mu"] + rowwise(h["b_mu"])
        sigma = torch.exp(x @ h["w_log_sigma"] + rowwise(h["b_log_sigma"]))
        out[name] = {"mu": mu, "sigma": sigma}
    return out


def is_stacked(params: Mapping) -> bool:
    """True for the stacked-weight layout (one GEMM for all heads)."""
    return "w_mu" in params["heads"]


def stack_decoder(params: Mapping, pad_to: int = 0):
    """Per-head dict -> stacked layout: the ``2 n_heads`` linears become one
    ``(D, sum F_h)`` weight pair (heads in MMB2 order) and the biases one
    ``(sum F_h,)`` pair.  Returns ``(stacked_params, head_order)``.

    ``pad_to > 0`` zero-pads the stacked feature axis to a multiple of
    ``pad_to``.  The pad columns are inert: no head reads them, so their
    gradient is exactly zero and SGD and Adam keep them exactly zero, and
    :func:`unstack_decoder` drops them.
    """
    order = tuple(h for h in MMB2_HEADS if h in params["heads"])
    hs = params["heads"]

    def cat(k):
        out = torch.cat([hs[h][k] for h in order], dim=-1)
        pad = (-out.shape[-1]) % pad_to if pad_to else 0
        return torch.nn.functional.pad(out, (0, pad)) if pad else out

    stacked = {"heads": {k: cat(k) for k in ("w_mu", "b_mu", "w_log_sigma", "b_log_sigma")},
               "norm": params["norm"]}
    return stacked, order


def unstack_decoder(stacked: Mapping, head_widths) -> dict:
    """Inverse of :func:`stack_decoder`; ``head_widths`` is a sequence of
    ``(head_name, F_h)`` in stack order.  The leaves are copies, not views."""
    hs = stacked["heads"]
    out: dict = {"heads": {}, "norm": stacked["norm"]}
    ofs = 0
    for name, f in head_widths:
        out["heads"][name] = {k: hs[k][..., ofs:ofs + f].clone()
                              for k in ("w_mu", "b_mu", "w_log_sigma", "b_log_sigma")}
        ofs += f
    return out


def apply_decoder_stacked(params: Mapping, latents: torch.Tensor, norm_code=NORM_NONE,
                          batch_weights: torch.Tensor | None = None):
    """Stacked-layout forward: ``(mu_all, sigma_all)``, each ``(B, sum F_h)``
    (pad columns included); callers slice each head at its offset."""
    x = apply_norm(latents, params["norm"], norm_code, batch_weights)
    hs = params["heads"]
    mu = x @ hs["w_mu"] + rowwise(hs["b_mu"])
    sigma = torch.exp(x @ hs["w_log_sigma"] + rowwise(hs["b_log_sigma"]))
    return mu, sigma
