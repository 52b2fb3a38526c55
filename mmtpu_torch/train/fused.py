"""Fused decoder-update training step (port of :mod:`mmtpu.train.fused`).

One training step of the latent or e2e fit with a hand-written chain rule,
so that the decoder head weights' gradient product, optimizer step and latent
cotangent run in one kernel per weight leaf (K2,
:mod:`mmtpu_torch.kernels.decoder_update`).  The decoder is in the stacked
layout (:func:`mmtpu_torch.models.decoder.stack_decoder`):

    x            = apply_norm(rows, norm)                [graph kept]
    z_mu, z_sig  = x w_mu + b_mu,  x w_sig + b_sig       [no graph]
    loss         = L(rows, z_mu, z_sig, extra)           [graph kept: word
                   likelihood, per-head Gaussians on the z slices, and the
                   e2e sentiment term through ``combine``]
    g_rows', g_z*, g_extra   by torch.autograd.grad over L
    w', m', v', g_x          = K2(w, m, v, x, g_z)       [per weight leaf]
    g_rows       = g_rows' + (d x / d rows)^T (g_x_mu + g_x_sig)
    biases, norm updated by ``opt_update`` with per-leaf gates

The gradients are those of autograd over the whole loss in exact arithmetic;
floats differ only by the order of the products' sums.
"""

from __future__ import annotations

from typing import Mapping

import torch

from mmtpu_torch.kernels.decoder_update import fused_gemm_adam_update, fused_gemm_sgd_update
from mmtpu_torch.models.decoder import apply_norm
from mmtpu_torch.train.optim import _B1, _B2, OptState, _gated, opt_update
from mmtpu_torch.tree import tree_leaves, tree_map, tree_unflatten


def _requiring_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def fused_joint_step(dec, d_opt: OptState, rows: torch.Tensor, b: Mapping, vocab_emb, hp, spec,
                     row_valid, active, *, heads_gate, norm_gate, extra_params=None,
                     combine=None):
    """One training step's loss and gradients with the fused decoder update.

    ``dec`` is the stacked decoder, ``d_opt`` its ``OptState`` (moments for
    "adam", none for "sgd"), ``rows`` the ``(B, D)`` latent batch.
    ``heads_gate`` / ``norm_gate`` are 0/1 freeze gates (numbers or 0-d
    tensors) for the head weights and biases / the norm's affine parameters.
    ``combine(extra_params, neg_joint, rows) -> (B,)`` replaces the
    per-sample loss (the e2e sentiment term); the gradients of
    ``extra_params`` are returned for the caller's own update.

    Returns ``(loss, g_rows, g_extra, dec2, d_opt2)``.  Every scalar of the
    step (lr, bias corrections, flag) stays on the device.
    """
    from mmtpu_torch.train.latents import _word_logprob, neg_joint, stacked_head_log_probs

    kind = spec.opt_kind
    if kind not in ("sgd", "adam"):
        raise ValueError(f"the fused decoder update needs a static opt_kind, got {kind!r}")
    hs = dec["heads"]

    # 1. the norm, with its graph kept for step 5
    rows_n = rows.detach().requires_grad_()
    norm = _requiring_grad(dec["norm"])
    x = apply_norm(rows_n, norm, hp["norm_code"], row_valid)
    xd = x.detach()

    # 2. the head pre-activations, as leaves of the loss
    with torch.no_grad():
        z_mu = xd @ hs["w_mu"] + hs["b_mu"]
        z_sig = xd @ hs["w_log_sigma"] + hs["b_log_sigma"]
    z_mu.requires_grad_()
    z_sig.requires_grad_()

    # 3. the loss from (rows, z, extra): rows feed the word likelihood and
    #    the extra term only
    lat = rows.detach().requires_grad_()
    extra = None if extra_params is None else _requiring_grad(extra_params)
    word_lp = _word_logprob(spec, lat, vocab_emb, b)
    neg = neg_joint(stacked_head_log_probs(spec, z_mu, torch.exp(z_sig), b), word_lp, hp)
    per_sample = neg if combine is None else combine(extra, neg, lat)
    if row_valid is None:
        loss = torch.mean(per_sample)
    else:
        loss = torch.sum(per_sample * row_valid) / torch.clamp_min(torch.sum(row_valid), 1.0)
    extra_leaves = [] if extra is None else tree_leaves(extra)
    grads = torch.autograd.grad(loss, [lat, z_mu, z_sig] + extra_leaves)
    g_lat, g_zmu, g_zsig = grads[0], grads[1].contiguous(), grads[2].contiguous()
    g_extra = None if extra is None else tree_unflatten(extra, grads[3:])

    # 4. K2 per weight leaf; the step's scalars are device tensors
    on = _gated(active, heads_gate)
    flag = (on.to(torch.float32) if isinstance(on, torch.Tensor)
            else torch.full((), float(on), device=rows.device))
    lr = hp["lr"]
    if kind == "adam":
        count1 = (d_opt.count + 1).to(torch.float32)
        bc1 = 1.0 - torch.pow(_B1, count1)
        bc2 = 1.0 - torch.pow(_B2, count1)
        w_mu2, m_mu2, v_mu2, gx_mu = fused_gemm_adam_update(
            hs["w_mu"], d_opt.m["heads"]["w_mu"], d_opt.v["heads"]["w_mu"], xd, g_zmu,
            lr, bc1, bc2, flag)
        w_sig2, m_sig2, v_sig2, gx_sig = fused_gemm_adam_update(
            hs["w_log_sigma"], d_opt.m["heads"]["w_log_sigma"], d_opt.v["heads"]["w_log_sigma"],
            xd, g_zsig, lr, bc1, bc2, flag)
    else:
        w_mu2, gx_mu = fused_gemm_sgd_update(hs["w_mu"], xd, g_zmu, lr, flag)
        w_sig2, gx_sig = fused_gemm_sgd_update(hs["w_log_sigma"], xd, g_zsig, lr, flag)

    # 5. close the chain rule through the norm
    norm_leaves = tree_leaves(norm)
    g = torch.autograd.grad(x, [rows_n] + norm_leaves, grad_outputs=gx_mu + gx_sig)
    g_rows = g_lat + g[0]
    g_norm = tree_unflatten(norm, g[1:])

    # 6. biases and norm by opt_update, sharing the decoder's step count
    small = {"b_mu": hs["b_mu"], "b_log_sigma": hs["b_log_sigma"], "norm": dec["norm"]}
    g_small = {"b_mu": torch.sum(g_zmu, dim=0), "b_log_sigma": torch.sum(g_zsig, dim=0),
               "norm": g_norm}
    gates = {"b_mu": heads_gate, "b_log_sigma": heads_gate,
             "norm": {k: norm_gate for k in dec["norm"]}}
    pick = lambda t: None if t is None else {
        "b_mu": t["heads"]["b_mu"], "b_log_sigma": t["heads"]["b_log_sigma"], "norm": t["norm"]}
    small_opt = OptState(m=pick(d_opt.m), v=pick(d_opt.v), count=d_opt.count)
    small2, small_opt2 = opt_update(small, g_small, small_opt, lr, None, active, kind=kind,
                                    gates=gates)

    dec2 = {"heads": {"w_mu": w_mu2, "b_mu": small2["b_mu"], "w_log_sigma": w_sig2,
                      "b_log_sigma": small2["b_log_sigma"]},
            "norm": small2["norm"]}
    if kind == "adam":
        d_opt2 = OptState(
            m={"heads": {"w_mu": m_mu2, "b_mu": small_opt2.m["b_mu"], "w_log_sigma": m_sig2,
                         "b_log_sigma": small_opt2.m["b_log_sigma"]},
               "norm": small_opt2.m["norm"]},
            v={"heads": {"w_mu": v_mu2, "b_mu": small_opt2.v["b_mu"], "w_log_sigma": v_sig2,
                         "b_log_sigma": small_opt2.v["b_log_sigma"]},
               "norm": small_opt2.v["norm"]},
            count=small_opt2.count)
    else:
        d_opt2 = OptState(m=None, v=None, count=small_opt2.count)
    return loss.detach(), g_rows, g_extra, dec2, d_opt2
