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
(:func:`mmtpu_torch.train.fused.fused_joint_step`).  With
``batch_shard_axis`` and ``mesh`` each step's rows split over the mesh axis
(:func:`mmtpu_torch.parallel.fit.fit_e2e_mesh`): the sentiment MLP's
gradients are summed over it with the decoder's, and the semi-supervised
quirk divides by the global batch's valid rows.

Under the sweep's config axis (as :func:`mmtpu_torch.train.latents.fit_latents`
takes it) the sentiment head is per config too, ``(K, D, H)`` weights, and
each config's joint loss is its own batch mean.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from mmtpu_torch.graphs import Graphs, fit_graphs, fit_result
from mmtpu_torch.models.decoder import is_stacked
from mmtpu_torch.models.sentiment import apply_sentiment
from mmtpu_torch.train.latents import (
    LatentFitSpec,
    PermutedEpoch,
    batch_shard,
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
from mmtpu_torch.utils.profiling import STEP, in_region, region


@dataclasses.dataclass(frozen=True)
class E2EFitSpec:
    """Static configuration of an e2e fit (the fields of
    :class:`mmtpu.train.e2e.E2EFitSpec` that this port runs)."""

    n_epochs_max: int
    batch_size: int  # the multimodal loader's batch (cfg.batch_size)
    unimodal: bool
    word_metric: str = "angular"
    shuffle: bool = True
    opt_kind: str | None = None  # "sgd" | "adam"; None: from hp["opt_code"]
    valid_every: int = 0  # recursive validation cadence (0: none)
    valid_batch_mult: int = 8
    batch_shard_axis: str | None = None  # split each step's rows over this mesh axis
    stacked_heads: bool = False
    lazy_adam: bool = False  # epoch-level lazy Adam; needs opt_kind "adam"
    fused_dec_update: bool = False

    def latent_spec(self) -> LatentFitSpec:
        return LatentFitSpec(n_epochs_max=self.n_epochs_max, batch_size=self.batch_size,
                             train_decoder=True, unimodal=self.unimodal,
                             word_metric=self.word_metric, shuffle=self.shuffle,
                             opt_kind=self.opt_kind, stacked_heads=self.stacked_heads,
                             fused_dec_update=self.fused_dec_update, lazy_adam=self.lazy_adam,
                             batch_shard_axis=self.batch_shard_axis)


@in_region(STEP["senti"])
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


def _joint_per_sample(lw, neg, sen, lat, y, mask) -> torch.Tensor:
    """``lw * neg + (1 - lw) * senti_l1(...)``, the per-sample objective,
    in that order of operations (the autograd nodes' order, and with it the
    order in which the backward adds the row gradients, is the expression's)."""
    with region(STEP["loss"]):
        weighted = lw * neg
    l1 = senti_l1(sen, lat, y, mask)
    with region(STEP["loss"]):
        return weighted + (1.0 - lw) * l1


def fit_e2e(init_embed: torch.Tensor, decoder_params, senti_params, data: Mapping,
            labels: torch.Tensor, vocab_emb: torch.Tensor, hp: Mapping, spec: E2EFitSpec,
            senti_mask: torch.Tensor | None = None, generator: torch.Generator | None = None,
            perms: Sequence | None = None, validation=None, mesh=None,
            graphs: bool | Graphs = True):
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
    ``mesh`` and ``graphs`` as :func:`mmtpu_torch.train.latents.fit_latents`'s:
    on the card each epoch (the sentiment head and its optimizer state in
    the carry) runs as one CUDA graph replay, and a caller's store is shared
    with the fits run through it.
    """
    lspec = spec.latent_spec()
    shard = batch_shard(dataclasses.replace(lspec, valid_every=spec.valid_every), mesh, hp,
                        init_embed, validation)
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

    embed = init_embed.detach().to(torch.float32).clone()
    n_cfg = embed.shape[0] if embed.ndim == 3 else None  # the config axis
    was_stacked = is_stacked(decoder_params)
    dec = start_fit_decoder(decoder_params, lspec)
    sen = tree_map(torch.Tensor.detach, senti_params)
    e_opt = init_opt_state(embed, kind, n_cfg)
    d_opt = init_opt_state(dec, kind, n_cfg)
    s_opt = init_opt_state(sen, kind, n_cfg)

    # every tensor the body reads is an argument (fits that share a store
    # share its graph); it closes over the spec and the shapes only
    def body(carry, perm, active, hp, data, labels, vocab_emb, senti_mask, valid, pad_idx):
        embed, dec, sen, e_opt, d_opt, s_opt = carry
        lr = hp["lr"]
        with region(STEP["loss"]):
            lw = per_config(hp["likelihood_weight"], embed.ndim - 1)  # against (B,) or (K, B)
        heads_gate = hp["train_heads"] if "train_heads" in hp else None
        dec_gates = None
        if heads_gate is not None:
            dec_gates = {"heads": tree_map(lambda _: heads_gate, dec["heads"]),
                         "norm": tree_map(lambda _: 1.0, dec["norm"])}
        table = PermutedEpoch(embed, e_opt, perm, pad_idx, bsz, kind, lazy, lr, active)
        batch_losses = []
        for s in range(n_batches):
            with region(STEP["gather"]):
                j, rv, count, blk = (table.batch_index(s), valid[s], torch.sum(valid[s]),
                                     slice(None))
                if shard is not None:  # this rank's block of the step's rows
                    blk = shard.block(bsz)
                    j, rv = j[blk], rv[blk]
                b = gather_batch(data, j)
                y = labels[j]
                mask = None if senti_mask is None else senti_mask[j]
            if spec.fused_dec_update:
                from mmtpu_torch.train.fused import fused_joint_step

                loss, g_rows, g_sen, dec, d_opt = fused_joint_step(
                    dec, d_opt, table.rows(s), b, vocab_emb, hp, lspec, rv, active,
                    heads_gate=1.0 if heads_gate is None else heads_gate, norm_gate=1.0,
                    extra_params=sen,
                    combine=lambda sp, neg, lat: _joint_per_sample(lw, neg, sp, lat, y, mask))
            else:
                rows = table.rows(s)
                with region(STEP["gather"]):
                    rows = rows[..., blk, :].detach().requires_grad_()
                    dec = tree_map(lambda t: t.detach().requires_grad_(), dec)
                    sen = tree_map(lambda t: t.detach().requires_grad_(), sen)
                neg = joint_neg_log_prob_per_sample(dec, rows, b, vocab_emb, hp, lspec, rv,
                                                    None if shard is None else shard.row_sum)
                per_sample = _joint_per_sample(lw, neg, sen, rows, y, mask)
                with region(STEP["loss"]):
                    # every valid row of the (global) batch divides, labeled or not
                    loss = torch.sum(per_sample * rv, dim=-1) / torch.clamp_min(count, 1.0)
                    objective = loss.sum()  # per-config means: each config's gradient is its own
                with region(STEP["backward"]):
                    dec_leaves, sen_leaves = tree_leaves(dec), tree_leaves(sen)
                    grads = torch.autograd.grad(objective, [rows] + dec_leaves + sen_leaves)
                    g_rows, g_params = grads[0], grads[1:]
                    if shard is not None:  # the global batch's row gradients, loss and sums
                        g_rows, g_params = shard.rows(g_rows, bsz), shard.reduce_grads(g_params)
                        loss = shard.total(loss)
                    g_dec = tree_unflatten(dec, g_params[:len(dec_leaves)])
                    g_sen = tree_unflatten(sen, g_params[len(dec_leaves):])
                    dec = tree_map(torch.Tensor.detach, dec)
                    sen = tree_map(torch.Tensor.detach, sen)
                with region(STEP["optimizer"]):
                    dec, d_opt = opt_update(dec, g_dec, d_opt, lr, None, active, kind=kind,
                                            gates=dec_gates)
            with region(STEP["optimizer"]):
                sen, s_opt = opt_update(sen, g_sen, s_opt, lr, None, active, kind=kind)
            table.step(s, g_rows)
            with region(STEP["loss"]):
                batch_losses.append(loss.detach())
        embed, e_opt = table.finish()
        with region(STEP["loss"]):
            return ((embed, dec, sen, e_opt, d_opt, s_opt),
                    torch.sum(torch.stack(batch_losses), dim=0))

    # the host part of each epoch, then its device body (a graph replay where
    # graphs says so; a batch-sharded fit runs eagerly)
    run = fit_graphs(graphs, device, shard, spec.n_epochs_max)
    key = ("e2e_epoch", spec, kind)
    carry = (embed, dec, sen, e_opt, d_opt, s_opt)
    losses, curve = [], []
    for epoch in range(spec.n_epochs_max):
        active = epoch_active(epoch, hp)
        perm = epoch_permutation(epoch, n, spec, device, generator, perms)
        carry, loss = run(key, body, carry, perm, active, hp, data, labels, vocab_emb,
                          senti_mask, valid, pad_idx, carry=True)
        losses.append(loss)
        if inner_spec is not None:
            curve.append(valid_curve_entry(epoch, spec, validation, carry[1], vocab_emb, hp,
                                           inner_spec, graphs))
    embed, dec, sen = fit_result(run, graphs, carry[:3])
    out = (embed, finish_fit_decoder(dec, data, lspec, was_stacked), sen,
           torch.stack(losses, dim=-1))
    if inner_spec is None:
        return out
    curve.append(valid_fit_loss(validation, dec, vocab_emb, hp, inner_spec, graphs))
    return out + (torch.stack(curve, dim=-1),)
