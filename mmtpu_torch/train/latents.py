"""Latent-optimization engine (port of :mod:`mmtpu.train.latents`).

The per-utterance embedding table is the parameter being fitted (plus, when
training, the decoder), by SGD/Adam on the negative joint log-likelihood,
minibatched with a per-epoch shuffle.  Inference for valid/test is the same
fit with the decoder frozen.  Python loops over epochs and minibatches take
the place of mmtpu's two ``lax.scan``s; the arithmetic of a step is mmtpu's.

Each epoch runs in permuted space: the table is gathered once into the
epoch's order, minibatch ``s`` is rows ``[s*B, (s+1)*B)`` of it, and the last
batch is padded with index 0 and a ``row_valid`` of 0 (pad rows add nothing
to the loss, the gradient or the batch-norm statistics).  SGD updates only a
batch's rows; Adam is dense, so every row takes a step every step.  At the
end of the epoch the pad rows (duplicates of row 0) are sliced off *before*
the permutation is inverted, so a pad row never overwrites row 0's update.

The decoder may travel in the stacked layout
(``LatentFitSpec.stacked_heads``, or ``fused_dec_update``, whose steps run
the fused decoder-update kernel K2 through
:func:`mmtpu_torch.train.fused.fused_joint_step`): it is stacked once at fit
entry and restored to the per-head dict on return.

Data dict convention: as mmtpu's (``text_ids``, ``text_weights``,
``text_mask`` and either the raw streams with masks or their sufficient
statistics ``<stream>_s0/s1/s2``), as tensors on the fit's device.  The
word vectors are gathered from the vocabulary per batch, never as (N, L, D).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from mmtpu_torch.models.decoder import (
    MMB1_HEADS,
    MMB2_HEADS,
    apply_decoder,
    apply_decoder_stacked,
    head_segments,
    is_stacked,
    stack_decoder,
    unstack_decoder,
)
from mmtpu_torch.ops.gaussian import gaussian_logpdf_masked, gaussian_logpdf_suffstats
from mmtpu_torch.ops.joint import weighted_joint
from mmtpu_torch.ops.wordprob import word_logprob_angular, word_logprob_dot_prod
from mmtpu_torch.train.optim import OPT_KINDS, OptState, init_opt_state, opt_update
from mmtpu_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class LatentFitSpec:
    """Static configuration of a latent fit (the fields of
    :class:`mmtpu.train.latents.LatentFitSpec` that this port runs)."""

    n_epochs_max: int
    batch_size: int
    train_decoder: bool
    unimodal: bool
    word_metric: str = "angular"  # 'angular' | 'dot_prod'
    shuffle: bool = True
    opt_kind: str | None = None  # "sgd" | "adam"; None: from hp["opt_code"]
    # the decoder travels stacked: one wide GEMM per step (same math per
    # output column); restored to the per-head dict on return
    stacked_heads: bool = False
    # stacked, and each training step's decoder-weight update runs in the
    # fused kernel K2 (mmtpu_torch.train.fused); needs a static opt_kind
    fused_dec_update: bool = False


def _word_logprob(spec: LatentFitSpec, latents, vocab_emb, b):
    sent = vocab_emb[b["text_ids"]]
    if spec.word_metric == "angular":
        return word_logprob_angular(latents, vocab_emb, b["text_weights"], sent,
                                    b["text_mask"])
    if spec.word_metric == "dot_prod":
        return word_logprob_dot_prod(latents, vocab_emb, b["text_weights"], sent,
                                     b["text_mask"])
    raise NotImplementedError(spec.word_metric)


def _head_parts(head: str, b) -> list:
    """The data parts a head's Gaussian factors over, in its column order."""
    if "pos_table" in b or "pos_s0" in b:
        raise NotImplementedError(
            "shared positional tables (the sweep's layout) are not ported yet "
            "(ROADMAP queue 1, sweep)")
    use_stats = "audio_s0" in b
    parts = []
    for seg in head_segments(head):
        stream = "text_gauss" if seg == "text" else seg
        if use_stats:
            parts.append(("stats", b[f"{stream}_s0"], b[f"{stream}_s1"], b[f"{stream}_s2"]))
        else:
            parts.append(("raw", b[stream], b[f"{stream}_mask"]))
    return parts


def head_width(head: str, b) -> int:
    """mu/sigma column count of a head for this data dict."""
    return sum(int(p[1].shape[-1]) for p in _head_parts(head, b))


def _head_log_prob(head: str, mu, sigma, b) -> torch.Tensor:
    """Masked Gaussian log-prob of one head, summed over its segments."""
    total = 0.0
    ofs = 0
    for part in _head_parts(head, b):
        f = part[1].shape[-1]
        mu_s = mu[:, ofs:ofs + f]
        sig_s = sigma[:, ofs:ofs + f]
        if part[0] == "stats":
            total = total + gaussian_logpdf_suffstats(mu_s, sig_s, part[1], part[2], part[3])
        else:
            total = total + gaussian_logpdf_masked(mu_s, sig_s, part[1], part[2])
        ofs += f
    return total


def stacked_head_log_probs(spec, mu_all, sigma_all, b) -> list:
    """Per-head log-probs from the stacked ``(B, sum F_h)`` mu/sigma, each head
    sliced at its offset; pad columns past the heads are never read."""
    head_lp, ofs = [], 0
    for h in (MMB1_HEADS if spec.unimodal else MMB2_HEADS):
        f = head_width(h, b)
        head_lp.append(_head_log_prob(h, mu_all[:, ofs:ofs + f], sigma_all[:, ofs:ofs + f], b))
        ofs += f
    if ofs > mu_all.shape[-1]:
        raise ValueError(f"stacked decoder is {mu_all.shape[-1]} wide, the heads need {ofs}")
    return head_lp


def neg_joint(head_lp: list, word_lp, hp) -> torch.Tensor:
    """The negative weighted joint log-likelihood at ``hp["word_loss_weight"]``."""
    return -weighted_joint(head_lp, word_lp, hp["word_loss_weight"])


def joint_neg_log_prob_per_sample(decoder_params, lat, b, vocab_emb, hp, spec: LatentFitSpec,
                                  row_valid=None) -> torch.Tensor:
    """Per-sample negative weighted joint log-likelihood ``(B,)``, for either
    decoder layout (per-head or stacked)."""
    word_lp = _word_logprob(spec, lat, vocab_emb, b)
    if is_stacked(decoder_params):
        mu_all, sigma_all = apply_decoder_stacked(decoder_params, lat, hp["norm_code"],
                                                  batch_weights=row_valid)
        return neg_joint(stacked_head_log_probs(spec, mu_all, sigma_all, b), word_lp, hp)
    heads = MMB1_HEADS if spec.unimodal else MMB2_HEADS
    out = apply_decoder(decoder_params, lat, hp["norm_code"], batch_weights=row_valid)
    head_lp = [_head_log_prob(h, out[h]["mu"], out[h]["sigma"], b) for h in heads]
    return neg_joint(head_lp, word_lp, hp)


def batch_neg_log_prob(embed_batch, decoder_params, b, vocab_emb, hp, spec: LatentFitSpec,
                       row_valid=None) -> torch.Tensor:
    """Mean negative joint log-likelihood of one minibatch over its valid rows."""
    neg = joint_neg_log_prob_per_sample(decoder_params, embed_batch, b, vocab_emb, hp, spec,
                                        row_valid)
    if row_valid is None:
        return torch.mean(neg)
    return torch.sum(neg * row_valid) / torch.clamp_min(torch.sum(row_valid), 1.0)


def train_view(data: Mapping) -> dict:
    """Drop the raw per-timestep streams when sufficient statistics are present."""
    if "audio_s0" not in data:
        return dict(data)
    drop = {"audio", "audio_mask", "visual", "visual_mask", "text_gauss",
            "text_gauss_mask", "pos_table"}
    return {k: v for k, v in data.items() if k not in drop}


def start_fit_decoder(decoder_params, spec) -> dict:
    """The decoder as a fit carries it: detached, and stacked when the spec
    asks for the stacked layout (no padding: the fused kernel masks its
    ragged edge itself)."""
    dec = tree_map(torch.Tensor.detach, decoder_params)
    if (spec.stacked_heads or spec.fused_dec_update) and not is_stacked(dec):
        dec, _ = stack_decoder(dec)
    return dec


def finish_fit_decoder(dec, data, spec, was_stacked: bool) -> dict:
    """Restore the per-head decoder dict after a fit that stacked it."""
    if was_stacked or not is_stacked(dec):
        return dec
    heads = MMB1_HEADS if spec.unimodal else MMB2_HEADS
    return unstack_decoder(dec, [(h, head_width(h, data)) for h in heads])


def epoch_permutation(epoch: int, n: int, spec, device, generator=None,
                      perms: Sequence | None = None) -> torch.Tensor:
    """The epoch's row order: the injected permutation, a draw from
    ``generator`` when shuffling, else the identity."""
    if perms is not None:
        return torch.as_tensor(perms[epoch], dtype=torch.long, device=device)
    if spec.shuffle:
        return torch.randperm(n, generator=generator).to(device)
    return torch.arange(n, device=device)


def sparse_sgd_rows(rows, g_rows, lr, active):
    """The SGD step of one batch's rows (the rows of no other batch move)."""
    return rows.detach() - lr * g_rows if active else rows.detach()


def dense_adam_rows(embp, e_opt, lo, hi, g_rows, lr, active):
    """The dense Adam step of the permuted table: every row moves, the
    batch's rows with their gradient and the others by stale momentum."""
    g_full = torch.zeros_like(embp)
    g_full[lo:hi] = g_rows
    return opt_update(embp, g_full, e_opt, lr, None, active, kind="adam")


def fit_latents(init_embed: torch.Tensor, decoder_params, data: Mapping, vocab_emb: torch.Tensor,
                hp: Mapping, spec: LatentFitSpec, generator: torch.Generator | None = None,
                perms: Sequence | None = None):
    """Run the full latent fit; returns ``(embed, decoder_params, losses)``.

    ``losses`` is ``(n_epochs_max,)``: per-epoch sums of batch means.  Epochs
    at or past ``hp["n_epochs"]`` change nothing.

    hp: ``lr`` and ``word_loss_weight`` (floats or 0-d float32 tensors),
    ``norm_code`` (int or 0-d tensor), ``opt_code`` and ``n_epochs`` (ints).

    Shuffling (``spec.shuffle``) draws one permutation per epoch from
    ``generator``; ``perms``, one permutation per epoch, replaces the draws
    (the tests feed in what JAX drew).
    """
    device = init_embed.device
    kind = spec.opt_kind or OPT_KINDS[int(hp["opt_code"])]
    fused = spec.train_decoder and spec.fused_dec_update
    n, _ = init_embed.shape
    bsz = spec.batch_size
    n_batches = -(-n // bsz)
    pad = n_batches * bsz - n
    valid = torch.cat([torch.ones(n, device=device), torch.zeros(pad, device=device)])
    valid = valid.reshape(n_batches, bsz)
    pad_idx = torch.zeros(pad, dtype=torch.long, device=device)
    lr = hp["lr"]

    # hp["train_dec"] = 0 freezes the WHOLE decoder, norm included
    # (simplesif.py:55-56): the non-e2e freeze semantics
    dec_gate = hp["train_dec"] if "train_dec" in hp else None

    embed = init_embed.detach().to(torch.float32).clone()
    was_stacked = is_stacked(decoder_params)
    dec = start_fit_decoder(decoder_params, spec)
    e_opt = init_opt_state(embed, kind)
    d_opt = init_opt_state(dec, kind) if spec.train_decoder else None
    dec_gates = None if dec_gate is None else tree_map(lambda _: dec_gate, dec)
    losses = []
    for epoch in range(spec.n_epochs_max):
        active = epoch < int(hp["n_epochs"])
        perm = epoch_permutation(epoch, n, spec, device, generator, perms)
        idx = torch.cat([perm, pad_idx])
        embp = embed[idx]
        if kind == "adam":
            e_opt = OptState(m=e_opt.m[idx], v=e_opt.v[idx], count=e_opt.count)
        new_rows, batch_losses = [], []
        for s in range(n_batches):
            lo, hi = s * bsz, (s + 1) * bsz
            b = {k: v[idx[lo:hi]] for k, v in data.items()}
            if fused:
                from mmtpu_torch.train.fused import fused_joint_step

                gate = 1.0 if dec_gate is None else dec_gate
                loss, g_rows, _, dec, d_opt = fused_joint_step(
                    dec, d_opt, embp[lo:hi], b, vocab_emb, hp, spec, valid[s], active,
                    heads_gate=gate, norm_gate=gate)
            else:
                rows = embp[lo:hi].detach().requires_grad_()
                if spec.train_decoder:
                    dec = tree_map(lambda t: t.detach().requires_grad_(), dec)
                loss = batch_neg_log_prob(rows, dec, b, vocab_emb, hp, spec, valid[s])
                wrt = [rows] + (tree_leaves(dec) if spec.train_decoder else [])
                grads = torch.autograd.grad(loss, wrt)
                g_rows = grads[0]
                if spec.train_decoder:
                    dec = tree_map(torch.Tensor.detach, dec)
                    dec, d_opt = opt_update(dec, tree_unflatten(dec, grads[1:]), d_opt, lr,
                                            None, active, kind=kind, gates=dec_gates)
            with torch.no_grad():
                if kind == "sgd":
                    new_rows.append(sparse_sgd_rows(embp[lo:hi], g_rows, lr, active))
                else:
                    embp, e_opt = dense_adam_rows(embp, e_opt, lo, hi, g_rows, lr, active)
            batch_losses.append(loss.detach())
        emb_out = torch.cat(new_rows) if kind == "sgd" else embp
        inv = torch.argsort(perm)
        embed = emb_out[:n][inv]
        if kind == "adam":
            e_opt = OptState(m=e_opt.m[:n][inv], v=e_opt.v[:n][inv], count=e_opt.count)
        losses.append(torch.sum(torch.stack(batch_losses)))
    return embed, finish_fit_decoder(dec, data, spec, was_stacked), torch.stack(losses)
