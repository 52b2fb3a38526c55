"""Collective-based sharded ops (port of :mod:`mmtpu.parallel.collectives`).

The word likelihood's partition ``Z_s = sum_v f(cos(c, v))`` is a sum over
the vocabulary (reference ``losses.py:76-78``) and shards along it: each rank
scores its vocabulary shard with kernel K1 and one all-reduce over the
vocab axis's group sums the shards.  mmtpu gets the backward from GSPMD;
here :class:`ShardedAngularPartition` writes it out: K1's backward on the
rank's shard with the cotangent ``g``, then an all-reduce of that partial
latent gradient only.  ``g`` itself is not summed (every rank of the group
holds the same rows and the same ``g``), and nothing else of the latent
gradient is: the heads' and the sentence score's parts are already the same
on every rank of the group, and summing them would count them once per
shard.

The batch axis of the mesh fits (:class:`BatchShard`) splits each
minibatch's rows over the data axis's group: the loss is the group's summed
part over the global count of valid rows, batch-norm statistics are summed
over the group inside an autograd function whose backward sums too (as
SyncBatchNorm), the decoder's and the sentiment MLP's gradients are summed
over the group, and the rows' gradients are assembled by summing a
zero-filled ``(B, D)`` buffer in which each rank wrote its own rows.

Only ``all_reduce`` runs in a fit (NCCL, and gloo with CUDA tensors, take
it), so the same code runs on CPU ranks, on one card per rank, and on
ranks that share one card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from mmtpu_torch.kernels.angular import angular_bwd, angular_fwd
from mmtpu_torch.ops.gaussian import gaussian_logpdf_masked


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``, for values that each rank uses in
    its own part of a loss the ranks sum: the backward sums the cotangents
    over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return AllReduceSum.apply(x, group)


class ShardedAngularPartition(torch.autograd.Function):
    """``Z = sum over the group of K1(latents, vocab shard)``, ``(B, 1)``,
    for latents that every rank of ``group`` holds alike.  The backward is
    K1's backward on the rank's shard, summed over the group."""

    @staticmethod
    def forward(ctx, latents, shard, vnorm, group):
        ctx.save_for_backward(latents, shard, vnorm)
        ctx.group = group
        z = angular_fwd(latents, shard, vnorm)
        dist.all_reduce(z, group=group)
        return z

    @staticmethod
    def backward(ctx, g):
        latents, shard, vnorm = ctx.saved_tensors
        dl = angular_bwd(latents, shard, vnorm, g.contiguous())
        dist.all_reduce(dl, group=ctx.group)
        return dl, None, None, None


class ShardedSum(torch.autograd.Function):
    """``sum over the group of local(*inputs)`` for inputs that every rank
    of ``group`` holds alike and uses alike: the backward recomputes the
    rank's own term and sums its input gradients over the group (the
    pattern of :class:`ShardedAngularPartition`, for plain PyTorch terms)."""

    @staticmethod
    def forward(ctx, group, local, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.group, ctx.local = group, local
        out = local(*inputs)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = ctx.local(*inputs)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g))
        result = []
        for t in inputs:
            grad = next(grads) if t.requires_grad else None
            if grad is not None:
                dist.all_reduce(grad, group=ctx.group)
            result.append(grad)
        return (None, None, *result)


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split into {parts} shards")
    m = n // parts
    return slice(index * m, (index + 1) * m)


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """Rows ``[lo, lo + len(table))`` of a vocabulary of ``n_vocab`` rows,
    with their norms, held by this rank; ``group`` is the vocab axis's.

    Passed to the fits in place of the vocabulary table
    (:func:`mmtpu_torch.parallel.fit.place_fit_inputs`):
    :meth:`partition` is ``Z`` and :meth:`lookup` the sentence words'
    vectors, each summed over the group."""

    table: torch.Tensor
    vnorm: torch.Tensor
    lo: int
    n_vocab: int
    group: object

    def partition(self, latents: torch.Tensor) -> torch.Tensor:
        """The angular ``Z`` of ``(B, D)`` latents, ``(B, 1)``."""
        return ShardedAngularPartition.apply(latents.contiguous(), self.table, self.vnorm,
                                             self.group)

    def dot_partition(self, latents: torch.Tensor) -> torch.Tensor:
        """The dot-product ``Z = sum_v exp(c . v)`` of ``(..., B, D)`` latents."""
        local = lambda lat: torch.sum(torch.exp(lat @ self.table.T), dim=-1,  # noqa: E731
                                      keepdim=True)
        return ShardedSum.apply(self.group, local, latents)

    @torch.no_grad()
    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """``vocab[ids]``: each rank gathers the ids in its shard, zeros
        elsewhere, and the group sums (exact: one term is not zero)."""
        local = ids.long() - self.lo
        mine = (local >= 0) & (local < self.table.shape[0])
        rows = self.table[torch.where(mine, local, 0)] * mine[..., None]
        dist.all_reduce(rows, group=self.group)
        return rows


def shard_vocab(vocab: torch.Tensor, group, parts: int, index: int) -> VocabShard:
    """This rank's :class:`VocabShard` of the ``(V, D)`` table (V divisible by ``parts``)."""
    blk = _block(vocab.shape[0], parts, index, "a vocabulary")
    table = vocab[blk].contiguous()
    return VocabShard(table, torch.linalg.vector_norm(table, dim=-1), blk.start,
                      vocab.shape[0], group)


def sharded_angular_partition(latents: torch.Tensor, vocab_embeddings: torch.Tensor, mesh,
                              axis: str = "vocab") -> torch.Tensor:
    """``Z_s`` with the vocabulary sharded over ``axis`` of ``mesh``:
    latents held alike by the axis's ranks, this rank's rows of the
    ``(V, D)`` table (V divisible by the axis); drop-in for
    :func:`mmtpu_torch.ops.wordprob.angular_partition` under a mesh."""
    shard = shard_vocab(vocab_embeddings, mesh.groups[axis], mesh.size(axis), mesh.index(axis))
    return shard.partition(latents)


def sharded_gaussian_logpdf(mu: torch.Tensor, sigma: torch.Tensor, values: torch.Tensor,
                            mask: torch.Tensor, mesh, axis: str = "seq") -> torch.Tensor:
    """Masked Gaussian log-likelihood ``(B,)`` with the SEQUENCE axis sharded
    over ``axis``: each rank sums its block of the ``(B, L, F)`` values and
    mask (L divisible by the axis) and the group sums the blocks; ``mu``
    and ``sigma`` ``(B, F)`` are held alike by the axis's ranks, and their
    gradients are summed over it (mmtpu's POM long-sequence op)."""
    blk = _block(values.shape[1], mesh.size(axis), mesh.index(axis), "a sequence")
    v, m = values[:, blk], mask[:, blk]
    local = lambda mu_, sigma_: gaussian_logpdf_masked(mu_, sigma_, v, m)  # noqa: E731
    return ShardedSum.apply(mesh.groups[axis], local, mu, sigma)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """A minibatch's rows split over the data axis: this rank takes block
    ``index`` of ``parts`` contiguous blocks (``P("data")``'s split).
    ``sync_stats`` sums the batch-norm statistics over the group (a fit
    whose norm is not batch norm leaves them local: its selected output
    does not read them)."""

    group: object
    parts: int
    index: int
    sync_stats: bool = True

    def block(self, bsz: int) -> slice:
        return _block(bsz, self.parts, self.index, "a batch")

    def row_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Partial row sums of the batch-norm statistics, summed over the group."""
        return all_reduce_sum(t, self.group) if self.sync_stats else t

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """A value summed over the group (no gradient)."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def reduce_grads(self, grads) -> list:
        """Each gradient summed over the group, in one all-reduce."""
        grads = list(grads)
        if not grads:
            return grads
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def rows(self, g_local: torch.Tensor, bsz: int) -> torch.Tensor:
        """The ``(B, D)`` row gradients of the whole batch from each rank's block."""
        full = g_local.new_zeros((bsz,) + tuple(g_local.shape[1:]))
        full[self.block(bsz)] = g_local
        dist.all_reduce(full, group=self.group)
        return full
