"""Closed-form warm start for the inference fits, from sufficient statistics
(port of :mod:`mmtpu.train.warm_start`).

The sweep's ``infer_warm_start`` starts each valid/test inference fit from
the trained decoder's closed-form latent estimate (``sif2.py:164-208``)
instead of the SIF embedding, near the frozen-decoder fit's fixed point, so
that ``infer_epochs_cap`` can cut its epochs.  The sweep's data carry the
Gaussian sufficient statistics (``<stream>_s0/s1/s2``), not the raw
streams, and the estimator only needs the inverse weights summed over the
sequence, which the statistics give exactly
(:func:`mmtpu_torch.ops.closed_form.seq_summed_inverse_weights`).  Masked
statistics leave the padding out, unlike the reference estimator, which
ignores its mask; with all-ones masks the two agree.

Under the sweep's config axis the decoder's leaves lead with K (``(K, D,
F)`` weights, ``(K, F)`` biases) against the shared ``(B, F)`` statistics
and each config's ``(K, 1, P)`` positional-table statistics: the same
arithmetic broadcasts to ``(K, B, D)``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from mmtpu_torch.models.decoder import MMB1_HEADS, MMB2_HEADS
from mmtpu_torch.ops.closed_form import seq_summed_inverse_weights
from mmtpu_torch.train.latents import _head_parts
from mmtpu_torch.tree import rowwise


def closed_form_latents_from_stats(decoder_params, data: Mapping[str, torch.Tensor],
                                   vocab_emb, unimodal: bool = False,
                                   heads=None) -> torch.Tensor:
    """Closed-form latents on the sufficient-statistics data layout.

    Head by head as :func:`mmtpu_torch.ops.closed_form.closed_form_latents`,
    over each head's segments in the decoder's column order
    (:func:`mmtpu_torch.train.latents._head_parts`), so concatenated heads
    need no concatenated tensors.

    Args:
        decoder_params: ``{"heads": {h: {w_mu (D, F), b_mu (F,), ...}}, ...}``,
            every leaf with a leading config axis K or none.
        data: a split with ``text_ids`` (or ``text``), ``text_weights`` and
            ``<stream>_s0/s1/s2`` (``prepare_device_data(...,
            suff_stats=True)``); raw streams raise ``ValueError``.
        vocab_emb: ``(V, D)`` word vectors (unused when ``data`` has ``text``).
        unimodal: MMB1 (audio and visual heads) or MMB2.
        heads: an explicit head subset, overriding ``unimodal``.

    Returns:
        ``(B, D)`` (``(K, B, D)`` under the config axis) L2-normalised
        float32 latents; all-zero rows come out as zeros.
    """
    if heads is None:
        heads = MMB1_HEADS if unimodal else MMB2_HEADS
    w = data["text_weights"]  # (B, L), zero at padding
    total = torch.sum(w, dim=-1)  # (B,)
    sent = data["text"] if "text" in data else vocab_emb[data["text_ids"]]
    cs = torch.einsum("bl,bld->bd", w, sent)
    for h in heads:
        hp = decoder_params["heads"][h]
        ofs = 0
        for part in _head_parts(h, data):
            if part[0] != "stats":
                raise ValueError("closed_form_latents_from_stats needs the suff-stats data "
                                 "layout (prepare_device_data(..., suff_stats=True))")
            _, s0, s1, s2 = part
            cols = slice(ofs, ofs + s0.shape[-1])
            sq_mu, sq_sigma = seq_summed_inverse_weights(
                s0, s1, s2, rowwise(hp["b_mu"][..., cols]), rowwise(hp["b_log_sigma"][..., cols]))
            # a shared positional statistic adds the same mass to every row
            total = total + torch.sum(sq_mu, dim=-1) + torch.sum(sq_sigma, dim=-1)
            # weights stored (D, F): right-multiply by the (F, D) transpose
            cs = cs + sq_mu @ hp["w_mu"][..., cols].transpose(-1, -2)
            cs = cs + sq_sigma @ hp["w_log_sigma"][..., cols].transpose(-1, -2)
            ofs += s0.shape[-1]
    # all-zero-statistics rows (serving-ladder padding) divide to 0, not NaN
    cs = cs / torch.where(total == 0.0, 1.0, total)[..., None]
    norm = torch.linalg.vector_norm(cs, dim=-1, keepdim=True)
    return (cs / torch.where(norm == 0.0, 1.0, norm)).to(torch.float32)
