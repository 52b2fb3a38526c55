"""Downstream sentiment/trait training with early stopping and lr decay
(port of :mod:`mmtpu.train.sentiment`).

L1 loss, plain SGD, batch 32 shuffled, validation every 10 epochs, optional
early stopping with patience 10 and up to 3 lr-decay trials that reload the
best parameters (the spec's defaults, mmtpu's).  The state machine is kept
in tensors and ``torch.where`` as mmtpu keeps it, so no step waits on the
device, and each epoch is one device body: on the card one CUDA graph
replay, where mmtpu runs the fit as one scan.  As in mmtpu, the final
evaluation uses the LAST parameters; the best snapshot is returned as well.

Under the sweep's config axis the MLP's parameters and the latents lead with
K (``(K, N, D)``), the hp values are ``(K,)``, each epoch's permutation is
``(K, N)``, and every piece of the state machine is per config; the labels
are shared.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from mmtpu_torch.graphs import Graphs, fit_graphs, fit_result
from mmtpu_torch.models.sentiment import apply_sentiment
from mmtpu_torch.train.latents import epoch_active, epoch_permutation, take_rows
from mmtpu_torch.tree import per_config, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class SentimentFitSpec:
    n_epochs_max: int
    batch_size: int = 32  # sentiment_model.py:203
    early_stopping: bool = False
    valid_niter: int = 10  # sentiment_model.py:77
    patience: int = 10  # sentiment_model.py:86
    n_trials: int = 3  # sentiment_model.py:87
    shuffle: bool = True


def _batched_index(n: int, bsz: int, perm: torch.Tensor):
    """The padded rows ``(n_padded,)`` (``(K, n_padded)`` for per-config
    permutations) and the ``(n_batches, bsz)`` row validity."""
    n_batches = -(-n // bsz)
    pad = n_batches * bsz - n
    dev = perm.device
    idx = torch.cat([perm, torch.zeros((*perm.shape[:-1], pad), dtype=perm.dtype, device=dev)],
                    dim=-1)
    valid = torch.cat([torch.ones(n, device=dev), torch.zeros(pad, device=dev)])
    return idx, valid.reshape(n_batches, bsz)


def _l1_batch_mean(pred, y, row_valid, out_dims: int):
    """Mean L1 over the valid rows of a padded batch; multi-output targets
    (``out_dims`` trailing output dims) average over the outputs too."""
    err = torch.abs(pred - y)
    if out_dims:
        err = torch.mean(err, dim=tuple(range(-out_dims, 0)))
    return torch.sum(err * row_valid, dim=-1) / torch.clamp_min(torch.sum(row_valid, dim=-1), 1.0)


def eval_sentiment_loss(params, latents, y, bsz: int = 32) -> torch.Tensor:
    """Mean of the batch-mean L1 losses over unshuffled batches (one per
    config under a config axis)."""
    n = latents.shape[-2]
    idx, valid = _batched_index(n, bsz, torch.arange(n, device=latents.device))
    pred = apply_sentiment(params, take_rows(latents, idx))
    lead = pred.shape[:latents.ndim - 2]
    pred = pred.reshape(*lead, *valid.shape, *pred.shape[len(lead) + 1:])
    y_b = y[idx].reshape(*valid.shape, *y.shape[1:])
    return torch.mean(_l1_batch_mean(pred, y_b, valid, y.ndim - 1), dim=-1)


def fit_sentiment(params, train_latents, train_y, valid_latents, valid_y, hp: Mapping,
                  spec: SentimentFitSpec, generator: torch.Generator | None = None,
                  perms: Sequence | None = None, graphs: bool | Graphs = True):
    """Train the sentiment MLP; returns
    ``(last_params, best_params, train_losses, valid_losses)``.

    hp: ``lr`` (sentiment_lr), ``lr_decay`` (floats), ``n_epochs`` (int).
    ``train_losses`` are per-epoch means of batch means; ``valid_losses`` are
    sampled every ``spec.valid_niter`` epochs and held in between.  With
    ``spec.shuffle`` each epoch's order is drawn from ``generator`` unless
    ``perms`` (one per epoch) is given.

    Under a config axis the latents are ``(K, N, D)``, the parameters lead
    with K, ``hp`` holds ``(K,)`` tensors, each ``perms`` entry is ``(K, N)``
    and the losses are ``(K, n_epochs_max)``.

    ``graphs`` as :func:`mmtpu_torch.train.latents.fit_latents`'s: on the
    card each epoch of a fit of :data:`mmtpu_torch.graphs.MIN_EPOCHS` epochs
    or more is one CUDA graph replay (a validating epoch a graph of its own),
    and a caller's store is shared with the fits run through it (the
    latents, labels and ``lr_decay`` are arguments of each replay).
    """
    device = train_latents.device
    n = train_latents.shape[-2]
    bsz = spec.batch_size
    out_dims = train_y.ndim - 1
    f32 = dict(dtype=torch.float32, device=device)
    lr = torch.as_tensor(hp["lr"], **f32)
    lr_decay = torch.as_tensor(hp["lr_decay"], **f32)
    # the state machine, shaped as lr: one entry per config
    valid_min = torch.full(lr.shape, float("inf"), **f32)
    n_bad = torch.zeros(lr.shape, dtype=torch.int32, device=device)
    trials = torch.zeros(lr.shape, dtype=torch.int32, device=device)
    stopped = torch.zeros(lr.shape, dtype=torch.bool, device=device)
    params = tree_map(torch.Tensor.detach, params)

    # every tensor the body reads is an argument (fits that share a store
    # share its graph); it closes over the spec and the shapes only
    def body(carry, perm, in_range, validate: bool, train_latents, train_y, valid_latents,
             valid_y, lr_decay):
        params, best, lr, valid_min, n_bad, trials, stopped = carry
        flat, valid = _batched_index(n, bsz, perm)
        active = ~stopped & in_range
        lat_p, y_p = take_rows(train_latents, flat), train_y[flat]
        row_axis = flat.ndim - 1
        batch_losses = []
        for s in range(valid.shape[0]):
            lo = s * bsz
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = _l1_batch_mean(apply_sentiment(p, lat_p[..., lo:lo + bsz, :]),
                                  y_p.narrow(row_axis, lo, bsz), valid[s], out_dims)
            # per-config means summed: each config's gradient is its own
            grads = tree_unflatten(p, torch.autograd.grad(loss.sum(), tree_leaves(p)))
            with torch.no_grad():
                params = tree_map(
                    lambda a, ga: torch.where(per_config(active, a.ndim),
                                              a - per_config(lr, a.ndim) * ga, a),
                    tree_map(torch.Tensor.detach, p), grads)
            batch_losses.append(loss.detach())
        train_loss = torch.mean(torch.stack(batch_losses), dim=0)

        with torch.no_grad():
            if validate:
                do_valid = active
                vloss = torch.where(do_valid, eval_sentiment_loss(params, valid_latents,
                                                                  valid_y, bsz), valid_min)
            else:
                do_valid = torch.zeros_like(stopped)
                vloss = valid_min
            is_better = vloss < valid_min
            valid_min2 = torch.where(do_valid & is_better, vloss, valid_min)
            if spec.early_stopping:
                take_best = do_valid & is_better
                best = tree_map(lambda bp, p: torch.where(per_config(take_best, p.ndim), p, bp),
                                best, params)
                n_bad2 = torch.where(do_valid, torch.where(is_better, 0, n_bad + 1), n_bad)
                exhausted = n_bad2 >= spec.patience
                trials = torch.where(do_valid & exhausted, trials + 1, trials)
                retry = do_valid & exhausted & (trials < spec.n_trials)
                stopped = stopped | (do_valid & exhausted & (trials >= spec.n_trials))
                params = tree_map(lambda p, bp: torch.where(per_config(retry, p.ndim), bp, p),
                                  params, best)
                lr = torch.where(retry, lr * lr_decay, lr)
                n_bad = torch.where(retry, 0, n_bad2).to(torch.int32)
        return (params, best, lr, valid_min2, n_bad, trials, stopped), (train_loss, vloss)

    # the host part of each epoch (its order, whether it is in range and
    # validates; mmtpu's lax.cond), then its device body: a graph replay
    # where graphs says so
    run = fit_graphs(graphs, device, None, spec.n_epochs_max)
    key = ("sentiment_epoch", spec)
    carry = (params, params, lr, valid_min, n_bad, trials, stopped)
    train_losses, valid_losses = [], []
    for epoch in range(spec.n_epochs_max):
        perm = epoch_permutation(epoch, n, spec, device, generator, perms)
        in_range = epoch_active(epoch, hp)
        validate = in_range is not False and epoch % spec.valid_niter == 0
        carry, (train_loss, vloss) = run(key, body, carry, perm, in_range, validate,
                                         train_latents, train_y, valid_latents, valid_y,
                                         lr_decay, carry=True)
        train_losses.append(train_loss)
        valid_losses.append(vloss)
    return (*fit_result(run, graphs, carry[:2]), torch.stack(train_losses, dim=-1),
            torch.stack(valid_losses, dim=-1))
