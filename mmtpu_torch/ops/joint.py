"""Joint multimodal log-likelihood, the MMB training objective (port of
:mod:`mmtpu.ops.joint`)."""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from mmtpu_torch.ops.gaussian import gaussian_logpdf_masked
from mmtpu_torch.tree import per_config


def joint_log_prob(head_params: Mapping[str, Mapping[str, torch.Tensor]],
                   data: Mapping[str, torch.Tensor], masks: Mapping[str, torch.Tensor],
                   word_log_prob: torch.Tensor, word_loss_weight) -> torch.Tensor:
    """Per-utterance joint log-likelihood over all modality heads and words,
    ``(B,)`` (reference ``losses.py:249-274``).

    ``head_params`` is ``{modality: {"mu": (B, F_m), "sigma": (B, F_m)}}``
    (sigma already exp'd), ``data`` and ``masks`` are ``{modality: (B, L,
    F_m)}``.  With ``word_loss_weight`` w the heads share weight
    ``(1 - w) / n_heads`` and the words get w; with None everything is summed
    unweighted.
    """
    head_lp = [gaussian_logpdf_masked(p["mu"], p["sigma"], data[m], masks[m])
               for m, p in head_params.items()]
    return weighted_joint(head_lp, word_log_prob, word_loss_weight)


def weighted_joint(head_lp: Sequence[torch.Tensor], word_log_prob: torch.Tensor,
                   word_loss_weight) -> torch.Tensor:
    """``sum(head_lp) (1 - w) / n_heads + w word_log_prob`` for weight w
    (reference ``losses.py:267-270``); the plain sum when w is None.  Under
    a config axis the log-probs are ``(K, B)`` and w is ``(K,)``."""
    gauss_total = sum(head_lp)
    if word_loss_weight is None:
        return gauss_total + word_log_prob
    w = per_config(word_loss_weight, word_log_prob.ndim)
    other = (1.0 - w) / len(head_lp)
    return gauss_total * other + w * word_log_prob
