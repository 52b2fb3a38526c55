"""Mesh-integrated training: one config spanning ranks (port of
:mod:`mmtpu.parallel.fit`).

One config whose step is spread over a 2-D mesh of ranks:

- **batch axis** ("data"): each minibatch's rows split into contiguous
  blocks over the axis (``LatentFitSpec.batch_shard_axis``); the loss,
  batch-norm statistics and the decoder's (and the e2e sentiment MLP's)
  gradients are summed over the axis's group, so the math is the
  single-device fit's (:class:`mmtpu_torch.parallel.collectives.BatchShard`);
- **vocab axis** ("vocab"): each rank holds V / n_v rows of the vocabulary
  and their norms; the word likelihood's partition ``Z`` is kernel K1 on
  the rank's shard, summed over the axis, with K1's backward summed the
  same way (:class:`mmtpu_torch.parallel.collectives.VocabShard`).

The embedding table, the decoder and the optimizer states stay replicated:
every rank applies the same step.  mmtpu gets all of this from GSPMD; the
mesh fit equals the single-device fit up to float order
(``mmtpu/parallel/fit.py:109-110``).

Axes degrade as mmtpu's: a batch size not divisible by the batch axis runs
without a row split, a vocabulary not divisible by the vocab axis stays
whole on every rank.  An axis of size 1 still runs its collectives over
its group of one rank, so that a world of one process takes the code path
of a larger one.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from mmtpu_torch.parallel.collectives import shard_vocab
from mmtpu_torch.parallel.mesh import Mesh, build_mesh
from mmtpu_torch.train.e2e import fit_e2e
from mmtpu_torch.train.latents import fit_latents


def place_fit_inputs(mesh: Mesh, vocab_emb: torch.Tensor, spec, batch_axis: Optional[str],
                     vocab_axis: Optional[str]) -> tuple:
    """The mesh fits' placement: ``(vocab, spec)`` with the vocabulary
    row-sharded over ``vocab_axis`` where it divides (this rank's
    :class:`mmtpu_torch.parallel.collectives.VocabShard`; else the whole
    table) and ``spec.batch_shard_axis`` set where the batch divides the
    batch axis.  Everything else is replicated: each rank holds its own
    copy of the fit's other inputs on its device.  Exposed, as mmtpu's, so
    that a caller can see what was sharded."""
    sizes = mesh.axis_sizes
    if vocab_axis in sizes and vocab_emb.shape[0] % sizes[vocab_axis] == 0:
        vocab_emb = shard_vocab(vocab_emb, mesh.groups[vocab_axis], sizes[vocab_axis],
                                mesh.index(vocab_axis))
    rows = batch_axis in sizes and spec.batch_size % sizes[batch_axis] == 0
    return vocab_emb, dataclasses.replace(spec, batch_shard_axis=batch_axis if rows else None)


def fit_latents_mesh(mesh: Mesh, init_embed: torch.Tensor, decoder_params, data: Mapping,
                     vocab_emb: torch.Tensor, hp: Mapping, spec, batch_axis: Optional[str] = "data",
                     vocab_axis: Optional[str] = "vocab", generator=None, perms=None):
    """:func:`mmtpu_torch.train.latents.fit_latents` sharded over ``mesh``
    (mmtpu's ``fit_latents_mesh``, with the port's ``generator`` / ``perms``
    in place of its key).  Every rank passes the same inputs and the same
    draws, and returns the same ``(embed, decoder_params, losses)``."""
    vocab_emb, spec = place_fit_inputs(mesh, vocab_emb, spec, batch_axis, vocab_axis)
    return fit_latents(init_embed, decoder_params, data, vocab_emb, hp, spec,
                       generator=generator, perms=perms, mesh=mesh)


def fit_e2e_mesh(mesh: Mesh, init_embed: torch.Tensor, decoder_params, senti_params,
                 data: Mapping, labels: torch.Tensor, vocab_emb: torch.Tensor, hp: Mapping, spec,
                 senti_mask=None, batch_axis: Optional[str] = "data",
                 vocab_axis: Optional[str] = "vocab", generator=None, perms=None):
    """:func:`mmtpu_torch.train.e2e.fit_e2e` (the grid's mode) sharded over
    ``mesh`` with :func:`fit_latents_mesh`'s axes and degrading; returns
    ``(embed, decoder_params, senti_params, losses)`` on every rank."""
    vocab_emb, spec = place_fit_inputs(mesh, vocab_emb, spec, batch_axis, vocab_axis)
    return fit_e2e(init_embed, decoder_params, senti_params, data, labels, vocab_emb, hp, spec,
                   senti_mask=senti_mask, generator=generator, perms=perms, mesh=mesh)


def make_fit_mesh(n_batch: Optional[int] = None, n_vocab: Optional[int] = None,
                  backend: Optional[str] = None) -> Mesh:
    """A ("data", "vocab") mesh over the world's ranks (which must be up:
    :func:`mmtpu_torch.parallel.mesh.init_world`); by default every rank on
    the batch axis.  ``n_batch * n_vocab`` must be the world's size."""
    n =dist.get_world_size()
    if n_batch is None and n_vocab is None:
        n_batch, n_vocab = n, 1
    elif n_batch is None:
        n_batch = n // n_vocab
    elif n_vocab is None:
        n_vocab = n // n_batch
    return build_mesh((n_batch, n_vocab), ("data", "vocab"), backend)
