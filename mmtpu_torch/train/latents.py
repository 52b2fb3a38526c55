"""Latent-optimization engine (port of :mod:`mmtpu.train.latents`).

The per-utterance embedding table is the parameter being fitted (plus, when
training, the decoder), by SGD/Adam on the negative joint log-likelihood,
minibatched with a per-epoch shuffle.  Inference for valid/test is the same
fit with the decoder frozen.  Python loops over epochs and minibatches take
the place of mmtpu's two ``lax.scan``s; the arithmetic of a step is mmtpu's.
On the card each epoch's steps run as one CUDA graph replay (the inner scan
as one program; :mod:`mmtpu_torch.graphs`), and the host loop over
epochs draws the permutations between replays.

Each epoch runs in permuted space: the table is gathered once into the
epoch's order, minibatch ``s`` is rows ``[s*B, (s+1)*B)`` of it, and the last
batch is padded with index 0 and a ``row_valid`` of 0 (pad rows add nothing
to the loss, the gradient or the batch-norm statistics).  SGD updates only a
batch's rows; Adam is dense, so every row takes a step every step, unless
``lazy_adam`` steps only the batch's rows and applies the others' steps in
closed form (:class:`PermutedEpoch`).

An epoch maps the carry of :func:`init_fit_carry` to the next; the fit runs
every epoch, :func:`fit_latents_segment` an epoch range, so chained segments
(the checkpointed fit, :mod:`mmtpu_torch.train.chunked`) are the same fit.  With ``valid_every`` and a ``validation`` split the fit
also returns the recursive validation curve.

The sweep's config axis: with ``(K, N, D)`` init embeddings, a decoder
whose leaves lead with K, ``(K,)`` hp values and one permutation per config
per epoch (``(K, N)``), the same functions fit K configs as one program.
Each config's rows, batch-norm statistics, optimizer steps and epoch mask
are its own; the step's K per-config batch means are summed for one
backward, and no other reduction crosses configs.  The shared positional
table of the sweep's data (``pos_table`` / ``pos_s0..2`` with a per-config
``pos_mask``) passes through each batch whole.

The decoder may travel in the stacked layout
(``LatentFitSpec.stacked_heads``, or ``fused_dec_update``, whose steps run
the fused decoder-update kernel K2 through
:func:`mmtpu_torch.train.fused.fused_joint_step`): it is stacked once at fit
entry and restored to the per-head dict on return.

Data dict convention: as mmtpu's (``text_ids``, ``text_weights``,
``text_mask`` and either the raw streams with masks or their sufficient
statistics ``<stream>_s0/s1/s2``), as tensors on the fit's device.  The
word vectors are read from the vocabulary by id, a block of tokens at a time
(:func:`mmtpu_torch.ops.wordprob.token_dots`), never as (N, L, D) nor as a
batch's (B, L, D).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from mmtpu_torch.models.decoder import (
    MMB1_HEADS,
    MMB2_HEADS,
    NORM_BATCH,
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
from mmtpu_torch.train.optim import (
    OPT_KINDS,
    OptState,
    init_opt_state,
    lazy_adam_catch_up,
    lazy_adam_coeffs,
    lazy_adam_epilogue,
    lazy_adam_touch,
    opt_update,
)
from mmtpu_torch.graphs import Graphs, fit_graphs, fit_result
from mmtpu_torch.tree import per_config, tree_leaves, tree_map, tree_unflatten


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
    # recursive validation every valid_every epochs (0: none), at
    # valid_batch_mult times the batch (simplesif.py:146-159, 458)
    valid_every: int = 0
    valid_batch_mult: int = 8
    # epoch-level lazy Adam (mmtpu_torch.train.optim); needs opt_kind "adam"
    lazy_adam: bool = False
    # split each minibatch's rows over this axis of the fit's mesh
    # (mmtpu_torch.parallel.fit; needs mesh=... in the fit call)
    batch_shard_axis: str | None = None


def _word_logprob(spec: LatentFitSpec, latents, vocab_emb, b):
    """The word log-likelihood; ``vocab_emb`` is the ``(V, D)`` table or,
    under a vocab-sharded mesh, this rank's
    :class:`mmtpu_torch.parallel.collectives.VocabShard`."""
    if isinstance(vocab_emb, torch.Tensor):  # the tokens' vectors read by id, a block at a time
        sent, ids, table, partition, dot_partition = None, b["text_ids"], vocab_emb, None, None
    else:
        sent, ids, table = vocab_emb.lookup(b["text_ids"]), None, vocab_emb.table
        partition = lambda lat, _: vocab_emb.partition(lat)  # noqa: E731
        dot_partition = lambda lat, _: vocab_emb.dot_partition(lat)  # noqa: E731
    if spec.word_metric == "angular":
        return word_logprob_angular(latents, table, b["text_weights"], sent, b["text_mask"],
                                    partition_fn=partition, text_ids=ids)
    if spec.word_metric == "dot_prod":
        return word_logprob_dot_prod(latents, table, b["text_weights"], sent, b["text_mask"],
                                     partition_fn=dot_partition, text_ids=ids)
    raise NotImplementedError(spec.word_metric)


def _head_parts(head: str, b) -> list:
    """The data parts a head's Gaussian factors over, in its column order:
    its streams' segments, each audio and visual segment followed by the
    shared positional table's channels where the data has one, masked by the
    config's ``pos_mask`` (its own block of the table; the other channels
    give zero log-probability and zero gradients)."""
    use_stats = "audio_s0" in b
    parts = []
    for seg in head_segments(head):
        stream = "text_gauss" if seg == "text" else seg
        if use_stats:
            parts.append(("stats", b[f"{stream}_s0"], b[f"{stream}_s1"], b[f"{stream}_s2"]))
            if seg != "text" and "pos_s0" in b:
                pm = b["pos_mask"]
                parts.append(("stats", b["pos_s0"] * pm, b["pos_s1"] * pm, b["pos_s2"] * pm))
        else:
            mask = b[f"{stream}_mask"]  # a (..., B, L) token mask covers every feature
            parts.append(("raw", b[stream], mask[..., None] if mask.ndim < b[stream].ndim
                          else mask))
            if seg != "text" and "pos_table" in b:
                pm = b["pos_mask"]  # (P,), or (K, 1, P): one more axis for the sequence
                parts.append(("raw", b["pos_table"], pm if pm.ndim == 1 else pm[..., None, :]))
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
        mu_s = mu[..., ofs:ofs + f]
        sig_s = sigma[..., ofs:ofs + f]
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
        head_lp.append(_head_log_prob(h, mu_all[..., ofs:ofs + f], sigma_all[..., ofs:ofs + f],
                                      b))
        ofs += f
    if ofs > mu_all.shape[-1]:
        raise ValueError(f"stacked decoder is {mu_all.shape[-1]} wide, the heads need {ofs}")
    return head_lp


def neg_joint(head_lp: list, word_lp, hp) -> torch.Tensor:
    """The negative weighted joint log-likelihood at ``hp["word_loss_weight"]``."""
    return -weighted_joint(head_lp, word_lp, hp["word_loss_weight"])


def joint_neg_log_prob_per_sample(decoder_params, lat, b, vocab_emb, hp, spec: LatentFitSpec,
                                  row_valid=None, row_sum=None) -> torch.Tensor:
    """Per-sample negative weighted joint log-likelihood ``(B,)``, for either
    decoder layout (per-head or stacked); ``row_sum`` as
    :func:`mmtpu_torch.models.decoder.apply_norm`'s."""
    word_lp = _word_logprob(spec, lat, vocab_emb, b)
    if is_stacked(decoder_params):
        mu_all, sigma_all = apply_decoder_stacked(decoder_params, lat, hp["norm_code"],
                                                  batch_weights=row_valid, row_sum=row_sum)
        return neg_joint(stacked_head_log_probs(spec, mu_all, sigma_all, b), word_lp, hp)
    heads = MMB1_HEADS if spec.unimodal else MMB2_HEADS
    out = apply_decoder(decoder_params, lat, hp["norm_code"], batch_weights=row_valid,
                        row_sum=row_sum)
    head_lp = [_head_log_prob(h, out[h]["mu"], out[h]["sigma"], b) for h in heads]
    return neg_joint(head_lp, word_lp, hp)


def batch_neg_log_prob(embed_batch, decoder_params, b, vocab_emb, hp, spec: LatentFitSpec,
                       row_valid=None, shard=None, n_valid=None) -> torch.Tensor:
    """Mean negative joint log-likelihood of one minibatch over its valid rows
    (one mean per config, ``(K,)``, under a config axis).

    Under a batch-sharded mesh (``shard``, a
    :class:`mmtpu_torch.parallel.collectives.BatchShard`) the rows are this
    rank's block and the result is its part of the mean: its rows' sum over
    ``n_valid``, the global batch's valid rows."""
    neg = joint_neg_log_prob_per_sample(decoder_params, embed_batch, b, vocab_emb, hp, spec,
                                        row_valid, None if shard is None else shard.row_sum)
    if row_valid is None:
        return torch.mean(neg, dim=-1)
    count = torch.sum(row_valid) if n_valid is None else n_valid
    return torch.sum(neg * row_valid, dim=-1) / torch.clamp_min(count, 1.0)


def train_view(data: Mapping) -> dict:
    """Drop the raw per-timestep streams when sufficient statistics are present."""
    if "audio_s0" not in data:
        return dict(data)
    drop = {"audio", "audio_mask", "visual", "visual_mask", "text_gauss",
            "text_gauss_mask", "pos_table"}
    return {k: v for k, v in data.items() if k not in drop}


_SHARED = ("pos_table", "pos_mask", "pos_s0", "pos_s1", "pos_s2")


def gather_batch(data: Mapping, j: torch.Tensor) -> dict:
    """A minibatch's data: the per-utterance arrays at rows ``j`` (``(B,)``,
    or ``(K, B)`` for one row order per config); the shared positional table
    and its per-config mask pass through whole."""
    return {k: (v if k in _SHARED else v[j]) for k, v in data.items()}


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a ``(N, D)`` or ``(K, N, D)`` table: ``idx`` is
    ``(R,)``, one row order for every config, or ``(K, R)``, one per config."""
    if idx.ndim == 1:
        return t[idx] if t.ndim == 2 else t[:, idx]
    return torch.gather(t, 1, idx[..., None].expand(*idx.shape, t.shape[-1]))


def epoch_active(epoch: int, hp: Mapping):
    """Whether ``epoch`` trains: a bool for one config; under a config axis a
    ``(K,)`` mask on the device (no per-config value is read on the host)."""
    n = hp["n_epochs"]
    if isinstance(n, torch.Tensor) and n.ndim == 1:
        return epoch < n
    return epoch < int(n)


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


class PermutedEpoch:
    """The embedding table and its optimizer state through one epoch in
    permuted space: :meth:`rows` is block ``s`` as its step sees it,
    :meth:`step` applies the optimizer to the block, :meth:`finish` returns
    the table and state in row order.

    The laws are mmtpu's: sparse SGD moves only the block's rows; dense Adam
    moves every row every step (stale momentum); lazy Adam steps only the
    block, with its zero-gradient steps in closed form (caught up before the
    forward, the rest in one epilogue), and drops an inactive epoch whole at
    the end instead of gating each step.

    Under a config axis the table is ``(K, N, D)``, ``perm`` is ``(K, N)``
    (or ``(N,)`` shared) and ``lr`` and ``active`` are ``(K,)``: each config
    steps its own rows at its own rate, and an inactive config's epoch is
    dropped whole, per config.
    """

    def __init__(self, embed, e_opt: OptState, perm, pad_idx, bsz: int, kind: str, lazy: bool,
                 lr, active):
        self.idx = torch.cat([perm, pad_idx.expand(*perm.shape[:-1], -1)], dim=-1)
        self.perm, self.bsz, self.kind, self.lazy, self.lr, self.active = (
            perm, bsz, kind, lazy, lr, active)
        self.n_batches = self.idx.shape[-1] // bsz
        self.before = (embed, e_opt)
        self.embp = take_rows(embed, self.idx)
        self.e_opt = e_opt
        if kind == "adam":
            self.e_opt = OptState(m=take_rows(e_opt.m, self.idx), v=take_rows(e_opt.v, self.idx),
                                  count=e_opt.count)
        self.coeffs = lazy_adam_coeffs(e_opt.count, self.n_batches, lr) if lazy else None
        self.stepped = []  # sparse SGD: each block's rows; lazy Adam: each block's (p, m, v)
        self._caught_up = None

    def batch_index(self, s: int) -> torch.Tensor:
        """Block ``s``'s rows of the data, ``(B,)`` or ``(K, B)``."""
        return self.idx[..., s * self.bsz:(s + 1) * self.bsz]

    def rows(self, s: int) -> torch.Tensor:
        blk = slice(s * self.bsz, (s + 1) * self.bsz)
        if self.lazy:
            self._caught_up = lazy_adam_catch_up(self.embp[..., blk, :], self.e_opt.m[..., blk, :],
                                                 self.e_opt.v[..., blk, :], s, self.coeffs)
            return self._caught_up[0]
        return self.embp[..., blk, :]

    def _keep(self, new, old):
        """``new`` where the epoch is active, per config; else ``old``."""
        if isinstance(self.active, bool):
            return new if self.active else old
        return torch.where(per_config(self.active, new.ndim), new, old)

    @torch.no_grad()
    def step(self, s: int, g_rows: torch.Tensor) -> None:
        blk = slice(s * self.bsz, (s + 1) * self.bsz)
        if self.kind == "sgd":
            rows = self.embp[..., blk, :]
            self.stepped.append(self._keep(rows - per_config(self.lr, rows.ndim) * g_rows, rows))
        elif self.lazy:
            p, m, v = self._caught_up
            self.stepped.append(lazy_adam_touch(p, m, v, g_rows, s, self.lr, self.coeffs))
        else:
            g_full = torch.zeros_like(self.embp)
            g_full[..., blk, :] = g_rows
            self.embp, self.e_opt = opt_update(self.embp, g_full, self.e_opt, self.lr, None,
                                               self.active, kind="adam")

    def finish(self) -> tuple:
        """``(embed, e_opt)`` after the epoch.  The pad rows (duplicates of
        row 0) are sliced off before the permutation is inverted, so a pad
        row never overwrites row 0's update."""
        inv = torch.argsort(self.perm, dim=-1)
        n = self.perm.shape[-1]
        unperm = lambda t: take_rows(t[..., :n, :], inv)
        if self.kind == "sgd":
            return unperm(torch.cat(self.stepped, dim=-2)), self.e_opt
        if self.lazy:
            if self.active is False:
                return self.before
            p, m, v = lazy_adam_epilogue(*(torch.cat(t, dim=-2) for t in zip(*self.stepped)),
                                         self.n_batches, self.bsz, self.lr, self.coeffs)
            embed0, opt0 = self.before
            return self._keep(unperm(p), embed0), OptState(
                m=self._keep(unperm(m), opt0.m), v=self._keep(unperm(v), opt0.v),
                count=self._keep(self.e_opt.count + self.n_batches, opt0.count))
        return unperm(self.embp), OptState(m=unperm(self.e_opt.m), v=unperm(self.e_opt.v),
                                           count=self.e_opt.count)


def fit_kind(spec, hp) -> str:
    """The optimizer law of a fit: the spec's static kind, else ``hp["opt_code"]``'s."""
    return spec.opt_kind or OPT_KINDS[int(hp["opt_code"])]


def init_fit_carry(init_embed: torch.Tensor, decoder_params, spec: LatentFitSpec, hp) -> tuple:
    """The state a latent fit carries from epoch to epoch: ``(embed, decoder,
    embed_opt_state, dec_opt_state)``, the decoder in the fit's layout
    (:func:`start_fit_decoder`).  Chained :func:`fit_latents_segment` calls
    from it are :func:`fit_latents`; :mod:`mmtpu_torch.train.chunked`
    checkpoints it between them."""
    kind = fit_kind(spec, hp)
    embed = init_embed.detach().to(torch.float32).clone()
    n_cfg = embed.shape[0] if embed.ndim == 3 else None  # the config axis
    dec = start_fit_decoder(decoder_params, spec)
    d_opt = init_opt_state(dec, kind, n_cfg) if spec.train_decoder else None
    return embed, dec, init_opt_state(embed, kind, n_cfg), d_opt


def batch_shard(spec, mesh, hp: Mapping, init_embed: torch.Tensor, validation=None):
    """The fit's :class:`mmtpu_torch.parallel.collectives.BatchShard` over
    ``spec.batch_shard_axis`` of ``mesh``, or None without the axis.  Its
    batch-norm statistics are summed over the axis unless the fit's one
    norm code, read once here, is not batch norm.  Refused with it: the
    fused decoder update (mmtpu's ``train/fused.py:81``: the fused step is
    per-shard), the config axis, and the validation curve (mmtpu's mesh
    fits are no-validation programs)."""
    axis = spec.batch_shard_axis
    if axis is None:
        return None
    if mesh is None:
        raise ValueError(f"batch_shard_axis {axis!r} needs the mesh it names (mesh=...)")
    if spec.fused_dec_update:
        raise ValueError("the fused decoder update is per-shard: it takes no batch_shard_axis")
    if init_embed.ndim != 2:
        raise ValueError("batch_shard_axis takes one config's (N, D) table, no config axis")
    if validation is not None and spec.valid_every > 0:
        raise ValueError("the batch-sharded fit takes no validation curve")
    from mmtpu_torch.parallel.collectives import BatchShard  # parallel imports this module

    code = torch.as_tensor(hp["norm_code"])
    sync = code.numel() != 1 or int(code) == NORM_BATCH
    return BatchShard(mesh.groups[axis], mesh.size(axis), mesh.index(axis), sync_stats=sync)


def _make_epoch(data: Mapping, vocab_emb, hp: Mapping, spec: LatentFitSpec, n: int, device,
                generator, perms, epochs: int, shard=None, graphs=True):
    """One epoch of a latent fit, ``epoch(carry, epoch_idx) -> (carry, loss)``;
    ``shard`` splits each step's rows over a mesh axis (:func:`batch_shard`).

    The epoch's host part (its permutation, and ``epoch_active`` where that
    is a Python bool) runs first; its device body, every step of the epoch
    unrolled as mmtpu's scan body, reads nothing back to the host, and runs
    as a CUDA graph replay where ``graphs`` says so for a fit of ``epochs``
    epochs (:func:`mmtpu_torch.graphs.fit_graphs`; ``epoch.graphs`` is the
    fit's runner).  The body takes every tensor it reads (the hp, the data,
    the vocabulary) as an argument and closes over the spec and the shapes
    only, which its key names: fits that share a store share its graph."""
    kind = fit_kind(spec, hp)
    fused = spec.train_decoder and spec.fused_dec_update
    # mmtpu's gate: the static kind, so opt_kind=None runs dense Adam
    lazy = spec.opt_kind == "adam" and spec.lazy_adam
    bsz = spec.batch_size
    n_batches = -(-n // bsz)
    pad = n_batches * bsz - n
    valid = torch.cat([torch.ones(n, device=device), torch.zeros(pad, device=device)])
    valid = valid.reshape(n_batches, bsz)
    pad_idx = torch.zeros(pad, dtype=torch.long, device=device)

    def body(carry, perm, active, hp, data, vocab_emb, valid, pad_idx):
        embed, dec, e_opt, d_opt = carry
        lr = hp["lr"]
        # hp["train_dec"] = 0 freezes the WHOLE decoder, norm included
        # (simplesif.py:55-56): the non-e2e freeze semantics
        dec_gate = hp["train_dec"] if "train_dec" in hp else None
        table = PermutedEpoch(embed, e_opt, perm, pad_idx, bsz, kind, lazy, lr, active)
        dec_gates = None if dec_gate is None else tree_map(lambda _: dec_gate, dec)
        batch_losses = []
        for s in range(n_batches):
            j, rv, n_valid, blk = table.batch_index(s), valid[s], None, slice(None)
            if shard is not None:  # this rank's block of the step's rows
                blk = shard.block(bsz)
                j, rv, n_valid = j[blk], rv[blk], torch.sum(valid[s])
            b = gather_batch(data, j)
            if fused:
                from mmtpu_torch.train.fused import fused_joint_step

                gate = 1.0 if dec_gate is None else dec_gate
                loss, g_rows, _, dec, d_opt = fused_joint_step(
                    dec, d_opt, table.rows(s), b, vocab_emb, hp, spec, valid[s], active,
                    heads_gate=gate, norm_gate=gate)
            else:
                rows = table.rows(s)[..., blk, :].detach().requires_grad_()
                if spec.train_decoder:
                    dec = tree_map(lambda t: t.detach().requires_grad_(), dec)
                loss = batch_neg_log_prob(rows, dec, b, vocab_emb, hp, spec, rv, shard, n_valid)
                wrt = [rows] + (tree_leaves(dec) if spec.train_decoder else [])
                # per-config means summed: each config's gradient is its own
                grads = torch.autograd.grad(loss.sum(), wrt)
                g_rows, g_dec = grads[0], grads[1:]
                if shard is not None:  # the global batch's row gradients, loss and sums
                    g_rows, g_dec = shard.rows(g_rows, bsz), shard.reduce_grads(g_dec)
                    loss = shard.total(loss)
                if spec.train_decoder:
                    dec = tree_map(torch.Tensor.detach, dec)
                    dec, d_opt = opt_update(dec, tree_unflatten(dec, g_dec), d_opt, lr,
                                            None, active, kind=kind, gates=dec_gates)
            table.step(s, g_rows)
            batch_losses.append(loss.detach())
        embed, e_opt = table.finish()
        return (embed, dec, e_opt, d_opt), torch.sum(torch.stack(batch_losses), dim=0)

    run = fit_graphs(graphs, device, shard, epochs)
    key = ("latent_epoch", spec, kind)

    def epoch(carry, epoch_idx: int):
        active = epoch_active(epoch_idx, hp)
        perm = epoch_permutation(epoch_idx, n, spec, device, generator, perms)
        return run(key, body, carry, perm, active, hp, data, vocab_emb, valid, pad_idx,
                   carry=True)

    epoch.graphs = run
    return epoch


def fit_latents_segment(carry: tuple, data: Mapping, vocab_emb, hp: Mapping, spec: LatentFitSpec,
                        epoch_start: int, n_seg: int, generator: torch.Generator | None = None,
                        perms: Sequence | None = None, graphs: bool | Graphs = True):
    """Epochs ``[epoch_start, epoch_start + n_seg)`` of a latent fit from
    ``carry`` (:func:`init_fit_carry`); returns ``(carry, losses)`` with
    ``losses`` ``(n_seg,)``.  ``perms`` holds every epoch of the fit (indexed
    by epoch); ``generator`` must be in the state that the uninterrupted fit
    reaches at ``epoch_start``.  ``graphs`` as :func:`fit_latents`'s, for
    a fit of ``n_seg`` epochs: the segment's epochs after its first replay
    one captured graph."""
    epoch = _make_epoch(data, vocab_emb, hp, spec, carry[0].shape[-2], carry[0].device,
                        generator, perms, n_seg, graphs=graphs)
    losses = []
    for e in range(epoch_start, epoch_start + n_seg):
        carry, loss = epoch(carry, e)
        losses.append(loss)
    return fit_result(epoch.graphs, graphs, carry), torch.stack(losses, dim=-1)


def make_inner_valid_spec(spec, valid_batch_mult: int) -> LatentFitSpec:
    """The recursive validation refit's spec: decoder frozen, unshuffled,
    ``valid_batch_mult`` times the batch (simplesif.py:146-159, 458), no
    nested validation.  Shared by the latent and e2e fits."""
    return dataclasses.replace(spec, train_decoder=False, shuffle=False,
                               batch_size=spec.batch_size * valid_batch_mult, valid_every=0)


def valid_fit_loss(validation, dec, vocab_emb, hp: Mapping, inner_spec,
                   graphs: bool | Graphs = True) -> torch.Tensor:
    """One validation sample: the valid split refit from its SIF init against
    the frozen decoder ``dec``; the loss of its last active epoch (each
    config's own under the config axis, ``(K,)``).  The refit is a fit of
    its own, captured apart from the fit that samples it."""
    v_init, v_data = validation
    _, _, v_losses = fit_latents(v_init, dec, v_data, vocab_emb, hp, inner_spec, graphs=graphs)
    n, last = hp["n_epochs"], inner_spec.n_epochs_max - 1
    if isinstance(n, torch.Tensor) and n.ndim == 1:
        idx = torch.clamp(n.to(torch.long) - 1, 0, last)
        return torch.gather(v_losses, -1, idx[:, None])[:, 0]
    return v_losses[min(max(int(n) - 1, 0), last)]


def valid_curve_entry(epoch: int, spec, validation, dec, vocab_emb, hp: Mapping,
                      inner_spec, graphs: bool | Graphs = True) -> torch.Tensor:
    """The curve at ``epoch``: a sample on active epochs at the cadence, else
    NaN (mmtpu's code; its docstring says the last value repeats).  Under
    the config axis the refit runs for every config at the cadence, and a
    config past its own epochs reads NaN, as mmtpu's vmapped ``cond``."""
    nan = torch.full(validation[0].shape[:-2], float("nan"), device=validation[0].device)
    active = epoch_active(epoch, hp)
    if epoch % spec.valid_every != 0 or active is False:
        return nan
    loss = valid_fit_loss(validation, dec, vocab_emb, hp, inner_spec, graphs)
    return loss if active is True else torch.where(active, loss, nan)


def fit_latents(init_embed: torch.Tensor, decoder_params, data: Mapping, vocab_emb: torch.Tensor,
                hp: Mapping, spec: LatentFitSpec, generator: torch.Generator | None = None,
                perms: Sequence | None = None, validation=None, mesh=None,
                graphs: bool | Graphs = True):
    """Run the full latent fit; returns ``(embed, decoder_params, losses)``,
    and ``valid_losses`` after them when ``validation`` is given and
    ``spec.valid_every > 0``.

    ``losses`` is ``(n_epochs_max,)``: per-epoch sums of batch means.  Epochs
    at or past ``hp["n_epochs"]`` change nothing.

    Under a config axis (the sweep's chunk): ``init_embed`` is ``(K, N,
    D)``, the decoder's leaves lead with K, the hp values are ``(K,)``
    tensors (``n_epochs`` included, read on the device), each entry of
    ``perms`` is ``(K, N)``, and ``losses`` is ``(K, n_epochs_max)``.  The
    spec's ``opt_kind`` must be set.

    hp: ``lr`` and ``word_loss_weight`` (floats or 0-d float32 tensors),
    ``norm_code`` (int or 0-d tensor), ``opt_code`` and ``n_epochs`` (ints).

    Shuffling (``spec.shuffle``) draws one permutation per epoch from
    ``generator``; ``perms``, one permutation per epoch, replaces the draws
    (the tests feed in what JAX drew).

    ``validation = (valid_init_embed, valid_data)``: the valid split is refit
    from its SIF init against the current decoder (frozen, unshuffled, batch
    x ``valid_batch_mult``) after every active epoch with
    ``epoch % valid_every == 0`` and once after the last epoch, the
    reference's recursive validation (``simplesif.py:146-159``).
    ``valid_losses`` is ``(n_epochs_max + 1,)``: each refit's last-epoch
    loss, NaN between samples, the final sample last (``(K, n_epochs_max +
    1)`` under the config axis, where ``valid_init_embed`` is ``(K, N, D)``).

    ``mesh`` is the :class:`mmtpu_torch.parallel.mesh.Mesh` that
    ``spec.batch_shard_axis`` names, and ``vocab_emb`` may be this rank's
    vocab shard of it (:func:`mmtpu_torch.parallel.fit.fit_latents_mesh`
    sets them up; :func:`batch_shard` says what it refuses).

    ``graphs`` (:func:`mmtpu_torch.graphs.fit_graphs`): True (the default)
    runs each epoch as a CUDA graph replay on the card (the first epoch
    eagerly, as the warm-up; the second captures) when the fit runs at
    least :data:`mmtpu_torch.graphs.MIN_EPOCHS` epochs, and eagerly
    otherwise and on the CPU; False runs eagerly on the card too.  A
    :class:`mmtpu_torch.graphs.Graphs` store that the caller made is shared
    with every fit run through it: a fit of the same spec and shapes
    replays what an earlier fit captured, from its first epoch, and this
    fit returns copies of its final carry.  A batch-sharded fit runs
    eagerly.  The validation curve's refits are fits of their own (on the
    same store, where one is given).
    """
    shard = batch_shard(spec, mesh, hp, init_embed, validation)
    was_stacked = is_stacked(decoder_params)
    inner_spec = None
    if validation is not None and spec.valid_every > 0:
        inner_spec = make_inner_valid_spec(spec, spec.valid_batch_mult)
    carry = init_fit_carry(init_embed, decoder_params, spec, hp)
    epoch = _make_epoch(data, vocab_emb, hp, spec, carry[0].shape[-2], carry[0].device,
                        generator, perms, spec.n_epochs_max, shard, graphs)
    losses, curve = [], []
    for e in range(spec.n_epochs_max):
        carry, loss = epoch(carry, e)
        losses.append(loss)
        if inner_spec is not None:
            curve.append(valid_curve_entry(e, spec, validation, carry[1], vocab_emb, hp,
                                           inner_spec, graphs))
    embed, dec = fit_result(epoch.graphs, graphs, carry[:2])
    out = (embed, finish_fit_decoder(dec, data, spec, was_stacked), torch.stack(losses, dim=-1))
    if inner_spec is None:
        return out
    curve.append(valid_fit_loss(validation, dec, vocab_emb, hp, inner_spec, graphs))
    return out + (torch.stack(curve, dim=-1),)
