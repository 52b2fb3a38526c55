"""Masked diagonal-Gaussian log-likelihood ops (port of :mod:`mmtpu.ops.gaussian`)."""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_logpdf_masked(mu: torch.Tensor, sigma: torch.Tensor, values: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Masked sum of elementwise Normal log-densities per utterance, ``(B,)``.

    ``mu``/``sigma`` are ``(B, F)`` (sigma already exp'd); ``values`` and
    ``mask`` broadcast to ``(B, L, F)``; a ``(B, L)`` token mask is expanded
    over the feature axis.  Under the sweep's config axis mu/sigma are
    ``(K, B, F)`` and the data and masks broadcast to ``(K, B, L, F)``.
    """
    if mask.ndim == 2:
        mask = mask[:, :, None]
    sig_sq = torch.square(sigma)[..., None, :]  # (B, 1, F)
    term1 = -0.5 * (_LOG_2PI + torch.log(sig_sq))
    diff = values - mu[..., None, :]
    term2 = torch.square(diff) / (2.0 * sig_sq)
    log_prob = (term1 - term2) * mask
    return torch.sum(log_prob, dim=(-1, -2))


def gaussian_suff_stats(values: torch.Tensor, mask: torch.Tensor):
    """Per-(utterance, feature) statistics ``(s0, s1, s2)`` =
    ``(sum_l mask, sum_l mask*x, sum_l mask*x^2)`` of the masked Gaussian sum."""
    if mask.ndim == 2:
        mask = mask[:, :, None]
    m = mask * torch.ones_like(values)
    mv = mask * values
    return torch.sum(m, dim=-2), torch.sum(mv, dim=-2), torch.sum(mv * values, dim=-2)


def gaussian_logpdf_suffstats(mu: torch.Tensor, sigma: torch.Tensor, s0: torch.Tensor,
                              s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """The masked Gaussian log-likelihood from sufficient statistics, ``(B,)``
    (``(K, B)`` for ``(K, B, F)`` operands):
    ``sum_f [term1*s0 - (s2 - 2 mu s1 + mu^2 s0) / (2 sig^2)]``."""
    sig_sq = torch.square(sigma)
    term1 = -0.5 * (_LOG_2PI + torch.log(sig_sq))
    quad = s2 - 2.0 * mu * s1 + torch.square(mu) * s0
    lp = term1 * s0 - quad / (2.0 * sig_sq)
    return torch.sum(lp, dim=-1)
