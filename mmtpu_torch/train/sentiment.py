"""Downstream sentiment/trait training with early stopping and lr decay
(port of :mod:`mmtpu.train.sentiment`).

L1 loss, plain SGD, batch 32 shuffled, validation every 10 epochs, optional
early stopping with patience 10 and up to 3 lr-decay trials that reload the
best parameters.  The state machine is kept in tensors and ``torch.where``
as mmtpu keeps it, so no step waits on the device.  As in mmtpu, the final
evaluation uses the LAST parameters; the best snapshot is returned as well.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from mmtpu_torch.models.sentiment import apply_sentiment
from mmtpu_torch.tree import tree_leaves, tree_map, tree_unflatten


_BATCH_SIZE = 32  # sentiment_model.py:203
_VALID_NITER = 10  # sentiment_model.py:77
_PATIENCE = 10  # sentiment_model.py:86
_N_TRIALS = 3  # sentiment_model.py:87


@dataclasses.dataclass(frozen=True)
class SentimentFitSpec:
    n_epochs_max: int
    early_stopping: bool = False


def _batched_index(n: int, bsz: int, perm: torch.Tensor):
    n_batches = -(-n // bsz)
    pad = n_batches * bsz - n
    dev = perm.device
    idx = torch.cat([perm, torch.zeros(pad, dtype=perm.dtype, device=dev)])
    valid = torch.cat([torch.ones(n, device=dev), torch.zeros(pad, device=dev)])
    return idx.reshape(n_batches, bsz), valid.reshape(n_batches, bsz)


def _l1_batch_mean(pred, y, row_valid):
    """Mean L1 over the valid rows of a padded batch (multi-output targets
    average over the output dim too)."""
    err = torch.abs(pred - y)
    if err.ndim > row_valid.ndim:
        err = torch.mean(err, dim=tuple(range(row_valid.ndim, err.ndim)))
    return torch.sum(err * row_valid, dim=-1) / torch.clamp_min(torch.sum(row_valid, dim=-1), 1.0)


def eval_sentiment_loss(params, latents, y, bsz: int = _BATCH_SIZE) -> torch.Tensor:
    """Mean of the batch-mean L1 losses over unshuffled batches."""
    n = latents.shape[0]
    idx, valid = _batched_index(n, bsz, torch.arange(n, device=latents.device))
    return torch.mean(_l1_batch_mean(apply_sentiment(params, latents[idx]), y[idx], valid))


def fit_sentiment(params, train_latents, train_y, valid_latents, valid_y, hp: Mapping,
                  spec: SentimentFitSpec, generator: torch.Generator | None = None,
                  perms: Sequence | None = None):
    """Train the sentiment MLP; returns
    ``(last_params, best_params, train_losses, valid_losses)``.

    hp: ``lr`` (sentiment_lr), ``lr_decay`` (floats), ``n_epochs`` (int).
    ``train_losses`` are per-epoch means of batch means; ``valid_losses`` are
    sampled every 10 epochs and held in between.  Shuffles are drawn from
    ``generator`` unless ``perms`` (one per epoch) is given.
    """
    device = train_latents.device
    n = train_latents.shape[0]
    bsz = _BATCH_SIZE
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
        idx, valid = _batched_index(n, bsz, perm)
        in_range = epoch < int(hp["n_epochs"])
        active = ~stopped if in_range else torch.zeros_like(stopped)
        flat = idx.reshape(-1)
        lat_p, y_p = train_latents[flat], train_y[flat]
        batch_losses = []
        for s in range(idx.shape[0]):
            lo, hi = s * bsz, (s + 1) * bsz
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = _l1_batch_mean(apply_sentiment(p, lat_p[lo:hi]), y_p[lo:hi], valid[s])
            grads = tree_unflatten(p, torch.autograd.grad(loss, tree_leaves(p)))
            with torch.no_grad():
                params = tree_map(lambda a, ga: torch.where(active, a - lr * ga, a),
                                  tree_map(torch.Tensor.detach, p), grads)
            batch_losses.append(loss.detach())
        train_loss = torch.mean(torch.stack(batch_losses))

        with torch.no_grad():
            if in_range and epoch % _VALID_NITER == 0:
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
                best = tree_map(lambda bp, p: torch.where(take_best, p, bp), best, params)
                n_bad2 = torch.where(do_valid, torch.where(is_better, 0, n_bad + 1), n_bad)
                exhausted = n_bad2 >= _PATIENCE
                trials = torch.where(do_valid & exhausted, trials + 1, trials)
                retry = do_valid & exhausted & (trials < _N_TRIALS)
                stopped = stopped | (do_valid & exhausted & (trials >= _N_TRIALS))
                params = tree_map(lambda p, bp: torch.where(retry, bp, p), params, best)
                lr = torch.where(retry, lr * lr_decay, lr)
                n_bad = torch.where(retry, 0, n_bad2).to(torch.int32)
            valid_min = valid_min2
        train_losses.append(train_loss)
        valid_losses.append(vloss)
    return params, best, torch.stack(train_losses), torch.stack(valid_losses)
