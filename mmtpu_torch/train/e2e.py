"""End-to-end (e2e) training (port of :mod:`mmtpu.train.e2e`): the joint
likelihood and a supervised L1 objective under one optimizer law for the
train embeddings, the decoder and the sentiment MLP, per sample

    likelihood_weight * (-log p) + (1 - likelihood_weight) * L1(sentiment)

(``simplesif.py:786``).  With a semi-supervised ``senti_mask`` the L1 term of
unlabeled rows is zeroed and the batch mean still divides by every valid row,
the reference's quirk (``simplesif.py:779-784``).  Valid/test latents are
still fit likelihood-only by :func:`mmtpu_torch.train.latents.fit_latents`.

The epochs run in permuted space as in the latent fit (sparse SGD rows, dense
stale-momentum Adam or lazy Adam, padded last batch,
:class:`mmtpu_torch.train.latents.PermutedEpoch`).  With ``valid_every`` and a
``validation`` split the fit also returns the recursive likelihood-only
validation curve (``simplesif.py:795-799``).  ``hp["train_heads"] = 0`` freezes
the generator heads only while the norm keeps training (the reference's e2e
``freeze_weights``, ``simplesif.py:689-691``, ``models.py:170-178``).  With
``fused_dec_update`` the decoder weights update in kernel K2
(:func:`mmtpu_torch.train.fused.fused_joint_step`).

Under the sweep's config axis (as :func:`mmtpu_torch.train.latents.fit_latents`
takes it) the sentiment head is per config too, ``(K, D, H)`` weights, and
each config's joint loss is its own batch mean.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from mmtpu_torch import not_ported
from mmtpu_torch.models.decoder import is_stacked
from mmtpu_torch.models.sentiment import apply_sentiment
from mmtpu_torch.train.latents import (
    LatentFitSpec,
    PermutedEpoch,
    epoch_active,
    epoch_permutation,
    finish_fit_decoder,
    fit_kind,
    gather_batch,
    joint_neg_log_prob_per_sample,
    make_inner_valid_spec,
    start_fit_decoder,
    valid_curve_entry,
    valid_fit_loss,
)
from mmtpu_torch.train.optim import init_opt_state, opt_update
from mmtpu_torch.tree import per_config, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class E2EFitSpec:
    """Static configuration of an e2e fit (the fields of
    :class:`mmtpu.train.e2e.E2EFitSpec` that this port runs; the others raise)."""

    n_epochs_max: int
    batch_size: int  # the multimodal loader's batch (cfg.batch_size)
    unimodal: bool
    word_metric: str = "angular"
    shuffle: bool = True
    opt_kind: str | None = None  # "sgd" | "adam"; None: from hp["opt_code"]
    valid_every: int = 0  # recursive validation cadence (0: none)
    valid_batch_mult: int = 8
    batch_shard_axis: str | None = None  # multi-device rows: not ported
    stacked_heads: bool = False
    lazy_adam: bool = False  # epoch-level lazy Adam; needs opt_kind "adam"
    fused_dec_update: bool = False

    def latent_spec(self) -> LatentFitSpec:
        return LatentFitSpec(n_epochs_max=self.n_epochs_max, batch_size=self.batch_size,
                             train_decoder=True, unimodal=self.unimodal,
                             word_metric=self.word_metric, shuffle=self.shuffle,
                             opt_kind=self.opt_kind, stacked_heads=self.stacked_heads,
                             fused_dec_update=self.fused_dec_update, lazy_adam=self.lazy_adam)


def senti_l1(sen, lat, y, mask) -> torch.Tensor:
    """Per-sample L1 error of the sentiment MLP, ``(B,)`` (``(K, B)`` for
    ``(K, B, D)`` latents): unlabeled rows (``mask`` 0) are zeroed before the
    mean over the outputs."""
    err = torch.abs(apply_sentiment(sen, lat) - y)
    if mask is not None:
        err = err * (mask if err.ndim == mask.ndim else mask[..., None])
    rows = lat.ndim - 1  # the row axis, after the config axis if there is one
    if err.ndim > rows:
        err = torch.mean(err, dim=tuple(range(rows, err.ndim)))
    return err


def fit_e2e(init_embed: torch.Tensor, decoder_params, senti_params, data: Mapping,
            labels: torch.Tensor, vocab_emb: torch.Tensor, hp: Mapping, spec: E2EFitSpec,
            senti_mask: torch.Tensor | None = None, generator: torch.Generator | None = None,
            perms: Sequence | None = None, validation=None):
    """The joint fit; returns ``(embed, decoder_params, senti_params, losses)``,
    and ``valid_losses`` after them when ``validation = (valid_init,
    valid_data)`` is given and ``spec.valid_every > 0`` (as
    :func:`mmtpu_torch.train.latents.fit_latents`'s: NaN between samples, one
    final sample appended).

    hp: as :func:`mmtpu_torch.train.latents.fit_latents` plus
    ``likelihood_weight`` and optionally ``train_heads``; under a config axis
    all ``(K,)``, as the inputs are there.  ``senti_mask`` is
    the per-utterance 0/1 labeled mask (None: fully supervised).  ``perms``,
    one permutation per epoch, replaces the draws from ``generator``.
    """
    if spec.batch_shard_axis is not None:
        raise not_ported("batch_shard_axis", "queue 1, parallel")
    lspec = spec.latent_spec()
    inner_spec = None
    if validation is not None and spec.valid_every > 0:
        inner_spec = make_inner_valid_spec(lspec, spec.valid_batch_mult)
    device = init_embed.device
    kind = fit_kind(spec, hp)
    lazy = spec.opt_kind == "adam" and spec.lazy_adam  # mmtpu's gate: the static kind
    n = init_embed.shape[-2]
    bsz = spec.batch_size
    n_batches = -(-n // bsz)
    pad = n_batches * bsz - n
    valid = torch.cat([torch.ones(n, device=device), torch.zeros(pad, device=device)])
    valid = valid.reshape(n_batches, bsz)
    pad_idx = torch.zeros(pad, dtype=torch.long, device=device)
    lr = hp["lr"]
    lw = per_config(hp["likelihood_weight"], init_embed.ndim - 1)  # against (B,) or (K, B)
    heads_gate = hp["train_heads"] if "train_heads" in hp else None

    embed = init_embed.detach().to(torch.float32).clone()
    n_cfg = embed.shape[0] if embed.ndim == 3 else None  # the config axis
    was_stacked = is_stacked(decoder_params)
    dec = start_fit_decoder(decoder_params, lspec)
    sen = tree_map(torch.Tensor.detach, senti_params)
    e_opt = init_opt_state(embed, kind, n_cfg)
    d_opt = init_opt_state(dec, kind, n_cfg)
    s_opt = init_opt_state(sen, kind, n_cfg)
    dec_gates = None
    if heads_gate is not None:
        dec_gates = {"heads": tree_map(lambda _: heads_gate, dec["heads"]),
                     "norm": tree_map(lambda _: 1.0, dec["norm"])}

    losses, curve = [], []
    for epoch in range(spec.n_epochs_max):
        active = epoch_active(epoch, hp)
        perm = epoch_permutation(epoch, n, spec, device, generator, perms)
        table = PermutedEpoch(embed, e_opt, perm, pad_idx, bsz, kind, lazy, lr, active)
        batch_losses = []
        for s in range(n_batches):
            j = table.batch_index(s)
            b = gather_batch(data, j)
            y = labels[j]
            mask = None if senti_mask is None else senti_mask[j]
            if spec.fused_dec_update:
                from mmtpu_torch.train.fused import fused_joint_step

                loss, g_rows, g_sen, dec, d_opt = fused_joint_step(
                    dec, d_opt, table.rows(s), b, vocab_emb, hp, lspec, valid[s], active,
                    heads_gate=1.0 if heads_gate is None else heads_gate, norm_gate=1.0,
                    extra_params=sen,
                    combine=lambda sp, neg, lat: lw * neg + (1.0 - lw) * senti_l1(sp, lat, y,
                                                                                  mask))
            else:
                rows = table.rows(s).detach().requires_grad_()
                dec = tree_map(lambda t: t.detach().requires_grad_(), dec)
                sen = tree_map(lambda t: t.detach().requires_grad_(), sen)
                neg = joint_neg_log_prob_per_sample(dec, rows, b, vocab_emb, hp, lspec, valid[s])
                per_sample = lw * neg + (1.0 - lw) * senti_l1(sen, rows, y, mask)
                loss = torch.sum(per_sample * valid[s], dim=-1) / torch.clamp_min(
                    torch.sum(valid[s]), 1.0)
                dec_leaves, sen_leaves = tree_leaves(dec), tree_leaves(sen)
                # per-config means summed: each config's gradient is its own
                grads = torch.autograd.grad(loss.sum(), [rows] + dec_leaves + sen_leaves)
                g_rows = grads[0]
                g_dec = tree_unflatten(dec, grads[1:1 + len(dec_leaves)])
                g_sen = tree_unflatten(sen, grads[1 + len(dec_leaves):])
                dec = tree_map(torch.Tensor.detach, dec)
                sen = tree_map(torch.Tensor.detach, sen)
                dec, d_opt = opt_update(dec, g_dec, d_opt, lr, None, active, kind=kind,
                                        gates=dec_gates)
            sen, s_opt = opt_update(sen, g_sen, s_opt, lr, None, active, kind=kind)
            table.step(s, g_rows)
            batch_losses.append(loss.detach())
        embed, e_opt = table.finish()
        losses.append(torch.sum(torch.stack(batch_losses), dim=0))
        if inner_spec is not None:
            curve.append(valid_curve_entry(epoch, spec, validation, dec, vocab_emb, hp,
                                           inner_spec))
    out = (embed, finish_fit_decoder(dec, data, lspec, was_stacked), sen,
           torch.stack(losses, dim=-1))
    if inner_spec is None:
        return out
    curve.append(valid_fit_loss(validation, dec, vocab_emb, hp, inner_spec))
    return out + (torch.stack(curve),)
