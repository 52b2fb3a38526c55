"""Closed-form latent estimation, the serving path (port of
:mod:`mmtpu.ops.closed_form`).

The reference inverts the trained linear-Gaussian decoder analytically
(``sif2.py:103-114`` and ``sif2.py:164-208``): one pass of elementwise
weights and per-head products gives each utterance's latent estimate with no
gradient loop.  mmtpu leaves this work to XLA outside any Pallas kernel; here
it is plain PyTorch (elementwise ops and ``torch.einsum``).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch


def gaussian_inverse_weights(data: torch.Tensor, b_mu: torch.Tensor,
                             b_log_sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element inverse weights of one decoder head (``sif2.py:103-114``,
    whose mask argument is ignored there, as here)::

        q_mu    = (x - b_mu) / exp(2 b_logsigma)
        q_sigma = (x - b_mu)^2 / exp(2 b_logsigma) - 1

    ``data`` is ``(B, L, F)``, the biases ``(F,)``; returns two ``(B, L, F)``.
    """
    inv_var = torch.exp(-2.0 * b_log_sigma)
    diff = data - b_mu
    return diff * inv_var, torch.square(diff) * inv_var - 1.0


def seq_summed_inverse_weights(s0, s1, s2, b_mu, b_log_sigma) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse weights summed over the sequence, from the Gaussian
    sufficient statistics ``s0 = sum m``, ``s1 = sum m x``, ``s2 = sum m x^2``::

        sum q_mu    = (s1 - s0 b_mu) / exp(2 b_logsigma)
        sum q_sigma = (s2 - 2 b_mu s1 + s0 b_mu^2) / exp(2 b_logsigma) - s0

    With an all-ones mask this is the sum of :func:`gaussian_inverse_weights`
    over the sequence; masked statistics also leave the padding out.  The
    operands broadcast (a shared ``(F,)`` positional statistic, or per-config
    biases ``(K, 1, F)`` against ``(B, F)`` statistics)."""
    inv_var = torch.exp(-2.0 * b_log_sigma)
    sum_q_mu = (s1 - s0 * b_mu) * inv_var
    sum_q_sigma = (s2 - 2.0 * b_mu * s1 + s0 * torch.square(b_mu)) * inv_var - s0
    return sum_q_mu, sum_q_sigma


def closed_form_latents(data: Mapping[str, torch.Tensor], heads: Mapping[str, Mapping],
                        sentence_weights: torch.Tensor,
                        sent_embeddings: torch.Tensor) -> torch.Tensor:
    """One-pass latent estimate from trained decoder weights
    (``sif2.py:164-208``): each head's inverse weights and the SIF word
    weights, normalised by their total, multiplied into the decoder's weight
    matrices, and each row L2-normalised.

    Args:
        data: ``{head: (B, L, F_h)}`` observed features per head.
        heads: ``{head: {"w_mu": (D, F_h), "b_mu": (F_h,), "w_log_sigma":
            (D, F_h), "b_log_sigma": (F_h,)}}`` in mmtpu's (in, out) layout.
        sentence_weights: ``(B, L)`` per-token SIF weights.
        sent_embeddings: ``(B, L, D)`` per-token word vectors.

    Returns:
        ``(B, D)`` latents.  The norm is not guarded, as in mmtpu: an
        all-zero row gives NaN.
    """
    q = {}
    total = torch.sum(sentence_weights, dim=-1)  # (B,)
    for k, d in data.items():
        qm, qs = gaussian_inverse_weights(d, heads[k]["b_mu"], heads[k]["b_log_sigma"])
        q[k] = (qm, qs)
        total = total + torch.sum(qm, dim=(-1, -2)) + torch.sum(qs, dim=(-1, -2))
    inv_total = (1.0 / total)[:, None, None]  # (B, 1, 1)

    cs = torch.einsum("bl,bld->bd", sentence_weights * inv_total[:, :, 0], sent_embeddings)
    for k, (qm, qs) in q.items():
        # the reference multiplies q (B, L, F) by Linear.weight (F, D)
        # (sif2.py:203-205); the weights here are stored (D, F)
        cs = cs + torch.einsum("blf,fd->bd", qm * inv_total, heads[k]["w_mu"].T)
        cs = cs + torch.einsum("blf,fd->bd", qs * inv_total, heads[k]["w_log_sigma"].T)
    return cs / torch.linalg.vector_norm(cs, dim=-1, keepdim=True)
