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

Data dict convention: as mmtpu's (``text_ids``, ``text_weights``,
``text_mask`` and either the raw streams with masks or their sufficient
statistics ``<stream>_s0/s1/s2``), as tensors on the fit's device.  The
word vectors are gathered from the vocabulary per batch, never as (N, L, D).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from mmtpu_torch.models.decoder import MMB1_HEADS, MMB2_HEADS, apply_decoder, head_segments
from mmtpu_torch.ops.gaussian import gaussian_logpdf_masked, gaussian_logpdf_suffstats
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


def joint_neg_log_prob_per_sample(decoder_params, lat, b, vocab_emb, hp, spec: LatentFitSpec,
                                  row_valid=None) -> torch.Tensor:
    """Per-sample negative weighted joint log-likelihood ``(B,)``."""
    word_lp = _word_logprob(spec, lat, vocab_emb, b)
    heads = MMB1_HEADS if spec.unimodal else MMB2_HEADS
    out = apply_decoder(decoder_params, lat, hp["norm_code"], batch_weights=row_valid)
    head_lp = [_head_log_prob(h, out[h]["mu"], out[h]["sigma"], b) for h in heads]
    w = hp["word_loss_weight"]
    other = (1.0 - w) / len(head_lp)
    return -(sum(head_lp) * other + w * word_lp)


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
    n, _ = init_embed.shape
    bsz = spec.batch_size
    n_batches = -(-n // bsz)
    pad = n_batches * bsz - n
    valid = torch.cat([torch.ones(n, device=device), torch.zeros(pad, device=device)])
    valid = valid.reshape(n_batches, bsz)
    pad_idx = torch.zeros(pad, dtype=torch.long, device=device)
    lr = hp["lr"]

    embed = init_embed.detach().to(torch.float32).clone()
    dec = tree_map(torch.Tensor.detach, decoder_params)
    e_opt = init_opt_state(embed, kind)
    d_opt = init_opt_state(dec, kind) if spec.train_decoder else None
    losses = []
    for epoch in range(spec.n_epochs_max):
        active = epoch < int(hp["n_epochs"])
        if perms is not None:
            perm = torch.as_tensor(perms[epoch], dtype=torch.long, device=device)
        elif spec.shuffle:
            perm = torch.randperm(n, generator=generator).to(device)
        else:
            perm = torch.arange(n, device=device)
        idx = torch.cat([perm, pad_idx])
        embp = embed[idx]
        if kind == "adam":
            e_opt = OptState(m=e_opt.m[idx], v=e_opt.v[idx], count=e_opt.count)
        new_rows, batch_losses = [], []
        for s in range(n_batches):
            lo, hi = s * bsz, (s + 1) * bsz
            b = {k: v[idx[lo:hi]] for k, v in data.items()}
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
                                        None, active, kind=kind)
            with torch.no_grad():
                if kind == "sgd":
                    new_rows.append(rows.detach() - lr * g_rows if active else rows.detach())
                else:
                    g_full = torch.zeros_like(embp)
                    g_full[lo:hi] = g_rows
                    embp, e_opt = opt_update(embp, g_full, e_opt, lr, None, active, kind=kind)
            batch_losses.append(loss.detach())
        emb_out = torch.cat(new_rows) if kind == "sgd" else embp
        inv = torch.argsort(perm)
        embed = emb_out[:n][inv]
        if kind == "adam":
            e_opt = OptState(m=e_opt.m[:n][inv], v=e_opt.v[:n][inv], count=e_opt.count)
        losses.append(torch.sum(torch.stack(batch_losses)))
    return embed, dec, torch.stack(losses)
