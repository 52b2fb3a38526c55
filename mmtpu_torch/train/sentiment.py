"""Downstream sentiment/trait training with early stopping and lr decay
(port of :mod:`mmtpu.train.sentiment`).

L1 loss, plain SGD, batch 32 shuffled, validation every 10 epochs, optional
early stopping with patience 10 and up to 3 lr-decay trials that reload the
best parameters.  The state machine is kept in tensors and ``torch.where``
as mmtpu keeps it, so no step waits on the device.  As in mmtpu, the final
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

from mmtpu_torch.models.sentiment import apply_sentiment
from mmtpu_torch.train.latents import epoch_active, take_rows
from mmtpu_torch.tree import per_config, tree_leaves, tree_map, tree_unflatten


_BATCH_SIZE = 32  # sentiment_model.py:203
_VALID_NITER = 10  # sentiment_model.py:77
_PATIENCE = 10  # sentiment_model.py:86
_N_TRIALS = 3  # sentiment_model.py:87


@dataclasses.dataclass(frozen=True)
class SentimentFitSpec:
    n_epochs_max: int
    early_stopping: bool = False


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


def eval_sentiment_loss(params, latents, y, bsz: int = _BATCH_SIZE) -> torch.Tensor:
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
                  perms: Sequence | None = None):
    """Train the sentiment MLP; returns
    ``(last_params, best_params, train_losses, valid_losses)``.

    hp: ``lr`` (sentiment_lr), ``lr_decay`` (floats), ``n_epochs`` (int).
    ``train_losses`` are per-epoch means of batch means; ``valid_losses`` are
    sampled every 10 epochs and held in between.  Shuffles are drawn from
    ``generator`` unless ``perms`` (one per epoch) is given.

    Under a config axis the latents are ``(K, N, D)``, the parameters lead
    with K, ``hp`` holds ``(K,)`` tensors, each ``perms`` entry is ``(K, N)``
    and the losses are ``(K, n_epochs_max)``.
    """
    device = train_latents.device
    n = train_latents.shape[-2]
    bsz = _BATCH_SIZE
    out_dims = train_y.ndim - 1
    f32 = dict(dtype=torch.float32, device=device)
    lr = torch.as_tensor(hp["lr"], **f32)
    lr_decay = torch.as_tensor(hp["lr_decay"], **f32)
    valid_min = torch.tensor(float("inf"), **f32)
    n_bad = torch.zeros((), dtype=torch.int32, device=device)
    trials = torch.zeros((), dtype=torch.int32, device=device)
    stopped = torch.zeros((), dtype=torch.bool, device=device)
    params = tree_map(torch.Tensor.detach, params)
    best = params
    train_losses, valid_losses = [], []
    for epoch in range(spec.n_epochs_max):
        if perms is not None:
            perm = torch.as_tensor(perms[epoch], dtype=torch.long, device=device)
        else:
            perm = torch.randperm(n, generator=generator).to(device)
        flat, valid = _batched_index(n, bsz, perm)
        in_range = epoch_active(epoch, hp)
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
            if in_range is not False and epoch % _VALID_NITER == 0:
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
                exhausted = n_bad2 >= _PATIENCE
                trials = torch.where(do_valid & exhausted, trials + 1, trials)
                retry = do_valid & exhausted & (trials < _N_TRIALS)
                stopped = stopped | (do_valid & exhausted & (trials >= _N_TRIALS))
                params = tree_map(lambda p, bp: torch.where(per_config(retry, p.ndim), bp, p),
                                  params, best)
                lr = torch.where(retry, lr * lr_decay, lr)
                n_bad = torch.where(retry, 0, n_bad2).to(torch.int32)
            valid_min = valid_min2
        train_losses.append(train_loss)
        valid_losses.append(vloss)
    return params, best, torch.stack(train_losses, dim=-1), torch.stack(valid_losses, dim=-1)

