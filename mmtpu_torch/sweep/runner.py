"""One chunk of the hyperparameter sweep (port of mmtpu's chunk program,
:func:`mmtpu.sweep.runner.build_sweep_parts` / ``build_sweep_fn``).

K configs of one optimizer train as one program with a leading config axis,
through mmtpu's four phases:

1. the train fit: the e2e joint fit, the grid's mode, or the likelihood-only
   latent fit (:func:`mmtpu_torch.train.e2e.fit_e2e`,
   :func:`mmtpu_torch.train.latents.fit_latents`);
2. the valid and test inference fits against each config's frozen decoder
   (batch x 8, unshuffled);
3. the sentiment MLP, zero-padded to the chunk's widest hidden layer
   (:func:`mmtpu_torch.train.sentiment.fit_sentiment`);
4. each config's test metrics, on the device
   (:mod:`mmtpu_torch.eval.metrics`).

The phases are the single-config functions: their inputs carry the config
axis (``(K, N, D)`` latents, decoder and MLP leaves that lead with K,
``(K,)`` hyperparameters, one permutation per config per epoch), and they
count dims from the end.  Every reduction stays inside a config, so a config
that diverges leaves the others as they would be alone.  The word
likelihood's partition sees the chunk's K*B rows in one call: one K1 forward
and one backward per step for all K configs (:mod:`mmtpu_torch.ops.wordprob`).

Configs differ in data, not in structure (:mod:`mmtpu_torch.sweep.pack`):
learning rates, loss weights and norms are per-config values; ``n_epochs``
is a per-config mask over the chunk's longest run; each positional dim is
its own block of one shared table, selected by the config's channel mask;
hidden sizes are zero-padded dead units.  The optimizer is one per chunk,
as each chunk of mmtpu's ``run_sweep`` has one.

All randomness of a config comes from its draws object: the decoder init,
the sentiment init, the train fit's and the sentiment fit's permutations.
:class:`SweepDraws` draws them from generators seeded from ``(seed,
config_num, run_idx)``, so a config's result does not depend on the chunk
it lands in (as mmtpu's ``fold_in`` keys; ``mmtpu/sweep/runner.py:670-684``);
the parity tests pass draws that reproduce mmtpu's JAX keys.

:func:`run_sweep` is mmtpu's loop over a whole grid: ``n_runs`` expands
the list into (config, run) pairs, the pairs are bucketed by (optimizer,
n_epochs), each bucket runs in chunks of ``chunk_size`` through the same
four phases, results are scattered back into per-config arrays, and with a
``checkpoint_dir`` each finished chunk is saved so that a restarted sweep
computes only the chunks it lacks.  As in mmtpu, the sweep uploads its data
once, each bucket's chunks share one set of captured graphs (a
:class:`mmtpu_torch.graphs.Graphs` store: the first chunk captures, the
others replay), and the chunks run one deep: chunk k's results are read
back, scattered and saved while chunk k+1 runs.  A chunk too wide for the
card (``torch.cuda.OutOfMemoryError``, also as the cause of a failed
capture) reruns the whole sweep at half the chunk width, as mmtpu's retry
of a failed dispatch does, down to width 2.  mmtpu's concurrent bucket
compiles have no counterpart: the port builds its kernels once.

With a ``mesh`` (:func:`mmtpu_torch.parallel.mesh.make_mesh`, one rank per
process) the config axis is sharded over the mesh's "config" axis: each
rank trains a contiguous block of each chunk's configs as one program on
its own device, with the whole chunk's statics, and the chunk's results are
gathered so that every rank holds all of them.  The draws are per config,
so the result does not depend on the layout.  A rank whose block fails
sends the failure through that gather in place of its results, so every
rank raises alike, and the ranks retry narrower together where each
failure was the card's memory.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

import mmtpu_torch.graphs as graphs_mod
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.data.pipeline import PreparedData
from mmtpu_torch.eval.metrics import iemocap_metrics, mosi_metrics, pom_metrics
from mmtpu_torch.models.decoder import init_decoder
from mmtpu_torch.models.sentiment import apply_sentiment, init_sentiment
from mmtpu_torch.parallel.mesh import config_sharding
from mmtpu_torch.sweep.pack import SweepStatics, pack_configs, statics_from_configs
from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e
from mmtpu_torch.train.latents import LatentFitSpec, fit_latents, train_view
from mmtpu_torch.train.sentiment import SentimentFitSpec, fit_sentiment
from mmtpu_torch.train.warm_start import closed_form_latents_from_stats
from mmtpu_torch.tree import tree_map
from mmtpu_torch.utils.profiling import in_region, region


@dataclasses.dataclass
class SweepResult:
    """Per-config arrays (leading axis = config), ordered as the input list
    (mmtpu's fields, and the port's ``diverged``, ``phase_s`` and
    ``predictions``)."""

    config_nums: np.ndarray
    run_idxs: np.ndarray
    final_train_loss: np.ndarray
    # per-config test metrics after training; "valid_curve" (K, n_epochs_max
    # + 1) with validation_curve=True
    metrics: Dict[str, np.ndarray]
    wall_time_s: float
    n_configs: int
    # seconds this sweep spent building the kernel library (0 when it was
    # built before)
    compile_time_s: float = 0.0
    settle_time_s: float = 0.0  # mmtpu's phased-mode settling: none here
    # run_sweep: one record per computed chunk, in the order drained: {chunk,
    # kind, configs, done_at_s, graphs, device_s, device_warmup_s,
    # device_start_at_s, device_end_at_s, host_s, alloc[, phases]}
    # (run_sweep's docstring)
    chunk_stats: Optional[List[dict]] = None
    # with return_embeddings=True: {"train"/"valid"/"test": (K, N_split, D)}
    embeddings: Optional[Dict[str, np.ndarray]] = None
    diverged: Optional[np.ndarray] = None  # final loss or train embeddings not finite
    # wall seconds per phase, device synced (summed over run_sweep's chunks)
    phase_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # run_chunk with return_embeddings=True: the test predictions the
    # metrics score, (K, N_test[, n_out])
    predictions: Optional[np.ndarray] = None
    # run_sweep: the chunk width it ran at, and the wider widths that ran out
    # of the card's memory before, in the order tried
    chunk_size: Optional[int] = None
    out_of_memory_widths: List[int] = dataclasses.field(default_factory=list)

    @property
    def exec_time_s(self) -> float:
        """Wall seconds less the kernel build (and mmtpu's settling, 0)."""
        return max(self.wall_time_s - self.compile_time_s - self.settle_time_s, 0.0)

    def to_records(self) -> List[dict]:
        """One dict per config: ``config_num``, ``run``, ``final_train_loss``
        and each metric (lists for per-trait metrics and the curve), as
        mmtpu's."""
        out = []
        for i in range(self.n_configs):
            rec = {"config_num": int(self.config_nums[i]), "run": int(self.run_idxs[i]),
                   "final_train_loss": float(self.final_train_loss[i])}
            for k, v in self.metrics.items():
                val = np.asarray(v[i])
                rec[k] = val.tolist() if val.ndim else float(val)
            out.append(rec)
        return out


def empty_sweep_result(prep, valid_curve_len: int = 0) -> SweepResult:
    """A result of no configs with ``prep``'s metric schema (and a
    ``valid_curve`` column of ``valid_curve_len``, if > 0): what a process
    whose multihost shard is empty brings to the sweep's gather."""
    schema = metric_schema(prep)
    if valid_curve_len > 0:
        schema["valid_curve"] = (valid_curve_len,)
    return SweepResult(config_nums=np.zeros((0,), np.int64), run_idxs=np.zeros((0,), np.int64),
                       final_train_loss=np.zeros((0,), np.float32),
                       metrics={k: np.zeros((0,) + s, np.float32) for k, s in schema.items()},
                       wall_time_s=0.0, n_configs=0, diverged=np.zeros((0,), bool))


def metric_schema(prep) -> Dict[str, tuple]:
    """Per-config metric names -> trailing shapes for ``prep``'s dataset (as
    :func:`mmtpu.sweep.runner.metric_schema`)."""
    if prep.name == "mosi":
        return {k: () for k in ("mae", "corr", "mult_acc", "f_score", "accuracy")}
    if prep.name == "pom":
        t = int(prep.labels["test"].shape[1])
        return {k: (t,) for k in ("mae", "corr", "mult_acc", "f_score")}
    return {k: () for k in ("accuracy", "f_score")}


class SweepDraws:
    """The draws of one (config, run), each kind from its own
    ``torch.Generator`` seeded from ``(seed, config_num, run_idx, kind)``:
    a config's draws depend neither on its chunk nor on how many epochs the
    other configs run.  Parameters come back on the CPU."""

    _KINDS = ("decoder", "sentiment", "train", "sentiment_fit")

    def __init__(self, seed: int, config_num: int, run_idx: int = 0):
        self.gens = {}
        for i, kind in enumerate(self._KINDS):
            state = np.random.SeedSequence([seed, config_num, run_idx, i]).generate_state(1)
            self.gens[kind] = torch.Generator().manual_seed(int(state[0]))

    def init_decoder(self, embed_dim, audio_dim, visual_dim, unimodal, text_dim) -> dict:
        return init_decoder(self.gens["decoder"], embed_dim, audio_dim, visual_dim,
                            unimodal=unimodal, text_dim=text_dim)

    def init_sentiment(self, embed_dim, hidden_dim, n_out, hidden_pad) -> dict:
        return init_sentiment(self.gens["sentiment"], embed_dim, hidden_dim, n_out,
                              hidden_pad=hidden_pad)

    def train_permutations(self, n: int, n_epochs: int) -> list:
        return [torch.randperm(n, generator=self.gens["train"]) for _ in range(n_epochs)]

    def sentiment_permutations(self, n: int, n_epochs: int) -> list:
        gen = self.gens["sentiment_fit"]
        return [torch.randperm(n, generator=gen) for _ in range(n_epochs)]


def build_sweep_parts(statics: SweepStatics, labels: Dict[str, torch.Tensor],
                      vocab: torch.Tensor, dataset_name: str,
                      senti_mask=None, graphs=True) -> Dict[str, Callable]:
    """The chunk's four phases as functions of the per-config inputs (with
    or without the config axis): ``train(init, dec, senti, hp, data, perms,
    validation) -> (embed, dec, losses, valid_curve or None)``, ``infer(init,
    dec, hp, data) -> embed``, ``sent(senti, train_e, valid_e, s_hp, perms)
    -> senti``, ``score(senti, test_e) -> (metrics, predictions)``.

    ``senti_mask`` is the sweep-level 0/1 labeled mask over the train rows
    (the reference's ``--semi_sup_idxes``, shared by every config): the e2e
    joint loss zeroes the sentiment term of unlabeled rows, and the
    sentiment phase trains on the labeled rows only (as
    :func:`mmtpu.sweep.runner.build_sweep_parts`).

    ``graphs`` (:func:`mmtpu_torch.graphs.fit_graphs`: a bool, or a store
    shared with the parts of other chunks) reaches the train, infer and
    sent fits: on the card each of their epochs is one CUDA graph replay
    where the fit is long enough to repay its capture (an inference fit's
    epochs are capped by ``infer_epochs_cap``).  Nothing in them reads the
    host between epochs (the config axis's epoch masks are device tensors).
    ``score`` runs eagerly."""
    valid_every = 80 if statics.validation_curve else 0  # valid_niter * 8
    lspec = LatentFitSpec(n_epochs_max=statics.n_epochs_max, batch_size=statics.batch_size,
                          train_decoder=True, unimodal=statics.unimodal,
                          word_metric=statics.word_metric, opt_kind=statics.opt_kind,
                          lazy_adam=statics.lazy_adam, valid_every=valid_every,
                          fused_dec_update=statics.fused_dec_update)
    espec = E2EFitSpec(n_epochs_max=statics.n_epochs_max, batch_size=statics.batch_size,
                       unimodal=statics.unimodal, word_metric=statics.word_metric,
                       opt_kind=statics.opt_kind, lazy_adam=statics.lazy_adam,
                       valid_every=valid_every, fused_dec_update=statics.fused_dec_update)
    cap = statics.infer_epochs_cap
    ispec = dataclasses.replace(lspec, batch_size=statics.batch_size * 8, train_decoder=False,
                                shuffle=False, valid_every=0, fused_dec_update=False,
                                n_epochs_max=min(statics.n_epochs_max, cap) if cap
                                else statics.n_epochs_max)
    sspec = SentimentFitSpec(n_epochs_max=statics.n_sentiment_epochs_max,
                             early_stopping=statics.early_stopping)
    metric_fn = {"mosi": mosi_metrics, "pom": pom_metrics}.get(dataset_name, iemocap_metrics)
    y_train, sel, mask = labels["train"], None, None
    if senti_mask is not None:
        sel = _to_device(torch.as_tensor(np.nonzero(np.asarray(senti_mask))[0]), y_train.device)
        mask = _to_device(torch.as_tensor(np.asarray(senti_mask), dtype=torch.float32),
                          y_train.device)
        y_train = y_train[sel]

    def train(init, dec, senti, hp, data, perms, validation=None):
        if statics.e2e:
            out = fit_e2e(init, dec, senti, data, labels["train"], vocab, hp, espec,
                          senti_mask=mask, perms=perms, validation=validation, graphs=graphs)
            embed, dec2, losses = out[0], out[1], out[3]
        else:
            out = fit_latents(init, dec, data, vocab, hp, lspec, perms=perms,
                              validation=validation, graphs=graphs)
            embed, dec2, losses = out[:3]
        return embed, dec2, losses, (out[-1] if validation is not None else None)

    def infer_spec(n_rows: int) -> LatentFitSpec:
        """With ``infer_batch_clamp`` a single-batch fit's batch shrinks to
        the next ``batch_size`` multiple >= its rows; a split of several
        batches keeps the reference's."""
        if not statics.infer_batch_clamp or n_rows >= ispec.batch_size:
            return ispec
        bs = statics.batch_size
        return dataclasses.replace(ispec, batch_size=-(-n_rows // bs) * bs)

    def infer(init, dec, hp, data):
        if statics.infer_warm_start:  # each config's closed form of its trained decoder
            init = closed_form_latents_from_stats(dec, data, vocab, unimodal=statics.unimodal)
        if cap:
            n = hp["n_epochs"]
            hp = dict(hp, n_epochs=torch.clamp(n, max=cap) if isinstance(n, torch.Tensor)
                      else min(n, cap))
        return fit_latents(init, dec, data, vocab, hp, infer_spec(init.shape[-2]),
                           graphs=graphs)[0]

    def sent(senti, train_e, valid_e, s_hp, perms):
        if sel is not None:
            train_e = train_e[..., sel, :]
        return fit_sentiment(senti, train_e, y_train, valid_e, labels["valid"], s_hp, sspec,
                             perms=perms, graphs=graphs)[0]

    @torch.no_grad()
    def score(senti, test_e):
        pred = apply_sentiment(senti, test_e)
        return metric_fn(pred, labels["test"]), pred

    return {"train": train, "infer": infer, "sent": sent, "score": score}


def sweep_statics(configs: Sequence[dict], prep: PreparedData, *, batch_size: int,
                  unimodal: bool, **options) -> SweepStatics:
    """The statics of ``configs`` with the sweep's ``options`` (fields of
    :class:`SweepStatics`), the positional layout rebased onto the prepared
    table's blocks."""
    statics = statics_from_configs(configs, batch_size=batch_size, unimodal=unimodal)
    statics = dataclasses.replace(statics, **options)
    if statics.pos_max > 0:
        if prep.pos_table is None:
            raise ValueError("the sweep needs prepare_device_data(..., pos_mode='shared', "
                             f"pos_dims={statics.pos_dims})")
        prep_dims = tuple(int(p) for p in (prep.pos_dims or ()))
        if not set(statics.pos_dims) <= set(prep_dims):
            raise ValueError(f"configs use pos_embed_dim {statics.pos_dims} but the prepared "
                             f"table has blocks {prep_dims}; prepare with "
                             f"pos_dims={statics.pos_dims}")
        statics = dataclasses.replace(statics, pos_dims=prep_dims, pos_max=sum(prep_dims))
    return statics


def chunk_statics(configs: Sequence[dict], prep: PreparedData, *, batch_size: int,
                  unimodal: bool, lazy_adam: bool, **options) -> SweepStatics:
    """One chunk's statics: one optimizer kind (a list that mixes them
    raises ``ValueError``), as :func:`sweep_statics`."""
    kinds = sorted({c.get("optimizer", "sgd") for c in configs})
    if len(kinds) != 1:
        raise ValueError(f"a sweep chunk trains one optimizer kind, got {kinds}: bucket the "
                         f"configs by optimizer")
    return sweep_statics(configs, prep, batch_size=batch_size, unimodal=unimodal,
                         opt_kind=kinds[0], lazy_adam=lazy_adam, **options)


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` (on the CPU) on ``device``, queued without waiting: a copy to
    the card from pageable memory waits for the stream to drain, one from
    pinned memory does not (the pinned block outlives the copy)."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _to_host(t):
    """``t``'s copy in pinned host memory, queued on the stream behind the
    work that makes it; ``t`` itself off the card (None stays None)."""
    if t is None or t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


@dataclasses.dataclass
class _Uploaded:
    """What a sweep uploads once and every chunk reads, as mmtpu keeps it on
    the device for the whole sweep: each split's fit data, labels and SIF
    init, and the vocabulary, on ``device``."""

    data: Dict[str, dict]
    labels: Dict[str, torch.Tensor]
    init: Dict[str, torch.Tensor]
    vocab: torch.Tensor

    @classmethod
    def of(cls, prep: PreparedData, device: torch.device) -> "_Uploaded":
        splits = ("train", "valid", "test")
        return cls(data={s: to_torch(train_view(prep.splits[s]), device) for s in splits},
                   labels={s: to_torch(prep.labels[s], device) for s in splits},
                   init={s: to_torch(prep.sif_init[s], device) for s in splits},
                   vocab=to_torch(prep.vocab_embeddings, device))


class _Clock:
    """The one clock of a sweep call: an anchor mark of the stream
    (:func:`mmtpu_torch.graphs.stream_mark`) that the host waited for just
    before ``t0``, so that a later mark's seconds from the anchor, once it
    has completed, are its seconds since ``t0``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.anchor = graphs_mod.stream_mark(device)
        if device.type == "cuda":
            self.anchor.synchronize()
        self.t0 = time.perf_counter()

    def mark(self):
        return graphs_mod.stream_mark(self.device)

    def at(self, mark) -> float:
        return graphs_mod.span_s(self.anchor, mark)


def _alloc_counts(device: torch.device) -> np.ndarray:
    """The caching allocator's ``cudaMalloc`` and ``cudaFree`` calls so far;
    none off the card."""
    if device.type != "cuda":
        return np.zeros(2, np.int64)
    stats = torch.cuda.memory_stats(device)
    return np.array([stats.get("num_device_alloc", 0), stats.get("num_device_free", 0)])


class _Queued:
    """A chunk's four phases queued on the device, with the copies of its
    results to the host queued behind them; :meth:`finish` waits for those
    copies alone (not for work queued after them) and builds the result;
    its seconds waiting go into ``spans`` (:func:`_queue`) as ``wait_s``."""

    def __init__(self, host: dict, event, hp_np: Dict[str, np.ndarray], n_epochs_max: int,
                 schema: Dict[str, tuple], t_start: float, phase_s: Dict[str, float],
                 spans: Optional[dict]):
        self.host, self.event, self.hp_np, self.n_epochs_max = host, event, hp_np, n_epochs_max
        self.schema, self.t_start, self.phase_s, self.spans = schema, t_start, phase_s, spans

    def finish(self) -> SweepResult:
        t0 = time.perf_counter()
        if self.event is not None:
            with region("mmtpu.chunk.wait"):
                self.event.synchronize()  # every mark before it has completed
        if self.spans is not None:
            self.spans["wait_s"] = time.perf_counter() - t0
        h, hp_np = self.host, self.hp_np
        k = len(hp_np["config_num"])
        last = np.clip(hp_np["n_epochs"] - 1, 0, self.n_epochs_max - 1)
        final = to_numpy(h["losses"])[np.arange(k), last]
        diverged = ~(np.isfinite(final) & to_numpy(h["finite"]))
        metrics = {m: to_numpy(v).reshape(k, *self.schema[m]) for m, v in h["metrics"].items()}
        if h["curve"] is not None:  # (K, n_epochs_max + 1), NaN between samples
            metrics["valid_curve"] = to_numpy(h["curve"])
        return SweepResult(
            config_nums=hp_np["config_num"].astype(np.int64),
            run_idxs=hp_np["run_idx"].astype(np.int64),
            final_train_loss=final,
            metrics=metrics,
            diverged=diverged,
            wall_time_s=time.perf_counter() - self.t_start,
            n_configs=k,
            phase_s=self.phase_s,
            embeddings=None if h["emb"] is None else {s: to_numpy(e) for s, e in h["emb"].items()},
            predictions=None if h["pred"] is None else to_numpy(h["pred"]),
        )


def _queue(configs: Sequence[dict], prep: PreparedData, up: _Uploaded, statics: SweepStatics,
           draws: Sequence, device: torch.device, return_embeddings: bool, config_axis: bool,
           senti_mask=None, graphs=True, phase_timing: bool = False,
           spans: Optional[dict] = None) -> _Queued:
    """Queue the four phases for ``configs`` (with the config axis, or one
    config, ``config_axis=False``, through the plain single-config inputs)
    and their results' copies to the host: the host's preparation (draws,
    packing, uploads), then the phases, with no synchronize and no read on
    the host, unless ``phase_timing`` times each phase (the device synced
    after it).  ``graphs`` is the fits' (:func:`build_sweep_parts`).
    ``spans``, a sweep call's record of the chunk, holds the call's
    ``clock``: a mark of it is queued before the first phase and after
    each, into ``spans["marks"]``, with the host's seconds before the first,
    ``prepare_s``."""
    t_start = time.perf_counter()
    with region("mmtpu.chunk.prepare"):
        k = len(configs)
        hp_np = pack_configs(configs, statics)
        p_tab = 0 if prep.pos_table is None else int(prep.pos_table.shape[-1])
        n_out = 1 if prep.labels["train"].ndim == 1 else prep.labels["train"].shape[-1]
        n_train = prep.sif_init["train"].shape[0]
        n_sent = n_train if senti_mask is None else int(np.count_nonzero(senti_mask))

        decs = [d.init_decoder(prep.embed_dim, prep.audio_dim + p_tab, prep.visual_dim + p_tab,
                               statics.unimodal, prep.text_gauss_dim) for d in draws]
        sens = [d.init_sentiment(prep.embed_dim, int(h), n_out, statics.hidden_max)
                for d, h in zip(draws, hp_np["hidden_dims"])]
        tperms = [d.train_permutations(n_train, statics.n_epochs_max) for d in draws]
        sperms = [d.sentiment_permutations(n_sent, statics.n_sentiment_epochs_max) for d in draws]
        pos_mask = np.pad(hp_np["pos_mask"], ((0, 0), (0, p_tab - hp_np["pos_mask"].shape[-1])))
        upload = lambda a: _to_device(torch.as_tensor(a), device)  # noqa: E731

        init = up.init
        if config_axis:
            pick = lambda key: upload(hp_np[key])  # (K,)  # noqa: E731
            stack = lambda trees: tree_map(  # noqa: E731
                lambda *xs: _to_device(torch.stack(xs), device), *trees)
            dec, sen = stack(decs), stack(sens)
            # every epoch's (K, N) permutations in one upload
            tperm = list(_to_device(torch.stack([torch.stack([p[e] for p in tperms])
                                                 for e in range(statics.n_epochs_max)]), device))
            sperm = list(_to_device(torch.stack([torch.stack([p[e] for p in sperms])
                                                 for e in range(statics.n_sentiment_epochs_max)]),
                                    device))
            init = {s: v.expand(k, *v.shape) for s, v in init.items()}
            pm = upload(pos_mask[:, None, :])  # (K, 1, P)
        else:
            if k != 1:
                raise ValueError("without the config axis, one config at a time")
            pick = lambda key: upload(hp_np[key][0])  # 0-d  # noqa: E731
            dec = tree_map(lambda t: t.to(device), decs[0])
            sen = tree_map(lambda t: t.to(device), sens[0])
            tperm, sperm = tperms[0], sperms[0]
            pm = upload(pos_mask[0])  # (P,)
        hp = {key: pick(key) for key in ("lr", "word_loss_weight", "likelihood_weight",
                                          "norm_code", "train_dec")}
        hp["train_heads"] = hp["train_dec"]  # the e2e fit's freeze gates the heads only
        s_hp = {"lr": pick("sentiment_lr"), "lr_decay": pick("lr_decay")}
        if config_axis:
            hp["n_epochs"], s_hp["n_epochs"] = pick("n_epochs"), pick("n_sentiment_epochs")
        else:  # one config: the host loop reads its epoch counts
            hp["n_epochs"] = int(hp_np["n_epochs"][0])
            s_hp["n_epochs"] = int(hp_np["n_sentiment_epochs"][0])
        # the configs' positional masks join the sweep's data in this chunk's dicts
        data = {s: dict(v, pos_mask=pm) for s, v in up.data.items()} if p_tab else up.data
        validation = (init["valid"], data["valid"]) if statics.validation_curve else None

        parts = build_sweep_parts(statics, up.labels, up.vocab, prep.name, senti_mask, graphs)
    phase_s: Dict[str, float] = {}
    if spans is not None:
        spans.update(prepare_s=time.perf_counter() - t_start,
                     marks=[("start", spans["clock"].mark())])

    def phase(name, fn, *args):
        with region(f"mmtpu.chunk.{name}"):
            t0 = time.perf_counter()
            out = fn(*args)
            if phase_timing:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                phase_s[name] = time.perf_counter() - t0
        if spans is not None:
            spans["marks"].append((name, spans["clock"].mark()))
        return out

    embed, dec2, losses, curve = phase("train", parts["train"], init["train"], dec, sen, hp,
                                       data["train"], tperm, validation)
    valid_e = phase("valid_infer", parts["infer"], init["valid"], dec2, hp, data["valid"])
    test_e = phase("test_infer", parts["infer"], init["test"], dec2, hp, data["test"])
    sen2 = phase("sentiment", parts["sent"], sen, embed, valid_e, s_hp, sperm)
    metrics, pred = phase("metrics", parts["score"], sen2, test_e)

    emb = {s: e.reshape(k, *e.shape[-2:]) for s, e in
           (("train", embed), ("valid", valid_e), ("test", test_e))}
    out_shape = pred.shape[-2:] if n_out > 1 else pred.shape[-1:]  # (N_test[, n_out])
    host = tree_map(_to_host, {
        "losses": losses.reshape(k, -1),
        "finite": torch.isfinite(emb["train"]).reshape(k, -1).all(dim=1),
        "metrics": metrics,
        "curve": None if curve is None else curve.reshape(k, -1),
        "emb": emb if return_embeddings else None,
        "pred": pred.reshape(k, *out_shape) if return_embeddings else None})
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return _Queued(host, event, hp_np, statics.n_epochs_max, metric_schema(prep), t_start,
                   phase_s, spans)


def _execute(configs: Sequence[dict], prep: PreparedData, statics: SweepStatics,
             draws: Sequence, device: torch.device, return_embeddings: bool,
             config_axis: bool, senti_mask=None, graphs=True) -> SweepResult:
    """Run the four phases for ``configs`` (as :func:`_queue`) and wait for
    the result: uploads ``prep``, times each phase (device synced)."""
    return _queue(configs, prep, _Uploaded.of(prep, device), statics, draws, device,
                  return_embeddings, config_axis, senti_mask, graphs, phase_timing=True).finish()


def _concat(parts: Sequence[SweepResult], wall_time_s: float) -> SweepResult:
    """The ranks' blocks of one chunk as one result, in rank order; each
    phase takes its slowest rank's seconds."""
    cat = lambda get: np.concatenate([get(p) for p in parts])  # noqa: E731
    first = parts[0]
    return SweepResult(
        config_nums=cat(lambda p: p.config_nums), run_idxs=cat(lambda p: p.run_idxs),
        final_train_loss=cat(lambda p: p.final_train_loss),
        metrics={m: cat(lambda p: p.metrics[m]) for m in first.metrics},
        wall_time_s=wall_time_s, n_configs=sum(p.n_configs for p in parts),
        diverged=cat(lambda p: p.diverged),
        phase_s={k: max(p.phase_s[k] for p in parts) for k in first.phase_s},
        embeddings=(None if first.embeddings is None else
                    {s: cat(lambda p: p.embeddings[s]) for s in first.embeddings}),
        predictions=None if first.predictions is None else cat(lambda p: p.predictions))


def _queue_chunk(configs: Sequence[dict], prep: PreparedData, up: _Uploaded,
                 statics: SweepStatics, draws: Sequence, device: torch.device,
                 return_embeddings: bool, senti_mask=None, mesh=None, graphs=True,
                 phase_timing: bool = False,
                 spans: Optional[dict] = None) -> Callable[[], SweepResult]:
    """One chunk with the config axis, queued (:func:`_queue`, which fills
    ``spans`` with this rank's marks); returns its ``finish``.  With ``mesh``, this rank's block of the configs (with
    the whole chunk's statics) runs to its end and every rank's blocks are
    gathered before this returns: the gather is a collective, which every
    rank enters in the chunks' order, so the mesh's chunks are not
    pipelined.  A block that raises is gathered as a :class:`_RankFailure`,
    and every rank then raises (:func:`_raise_on_failure`)."""
    if mesh is None:
        return _queue(configs, prep, up, statics, draws, device, return_embeddings, True,
                      senti_mask, graphs, phase_timing, spans).finish
    t0 = time.perf_counter()
    sharding = config_sharding(mesh)
    blk = sharding.block(len(configs))
    local = failed = None
    if blk.stop > blk.start:  # more ranks than configs leave a rank none
        try:
            local = _queue(configs[blk], prep, up, statics, draws[blk], device,
                           return_embeddings, True, senti_mask, graphs, phase_timing,
                           spans).finish()
        except Exception as exc:  # the gather below tells every rank
            failed = exc
            local = _RankFailure(mesh.index("config"), _out_of_memory(exc), repr(exc))
    parts = [p for p in sharding.gather(local) if p is not None]
    _raise_on_failure(parts, failed)
    result = _concat(parts, time.perf_counter() - t0)
    return lambda: result


@dataclasses.dataclass(frozen=True)
class _RankFailure:
    """A mesh rank's part of a chunk that raised, in place of its results."""

    rank: int
    out_of_memory: bool
    error: str


def _raise_on_failure(parts: list, failed: Optional[BaseException]) -> None:
    """Every rank of the mesh raises alike when any rank's part of the chunk
    failed: a ``torch.cuda.OutOfMemoryError`` when each failure was the
    card's memory (so that every rank retries the sweep narrower, and the
    ranks' collectives stay matched), else a ``RuntimeError``; chained to
    this rank's own error."""
    bad = [p for p in parts if isinstance(p, _RankFailure)]
    if not bad:
        return
    kind = torch.cuda.OutOfMemoryError if all(p.out_of_memory for p in bad) else RuntimeError
    raise kind("a chunk failed on the mesh: " + "; ".join(
        f"config rank {p.rank}: {p.error}" for p in bad)) from failed


def _check_mesh(mesh) -> None:
    if mesh is not None and "config" not in mesh.axis_names:
        raise ValueError(f"the sweep shards a mesh's 'config' axis; this mesh has "
                         f"{mesh.axis_names}")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return device


def _draws_for(configs, draws, seed: int) -> list:
    if draws is None:
        return [SweepDraws(seed, int(c.get("config_num", 0)), int(c.get("_run_idx", 0)))
                for c in configs]
    if len(draws) != len(configs):
        raise ValueError(f"{len(draws)} draws for {len(configs)} configs")
    return list(draws)


def run_chunk(configs: Sequence[dict], prep: PreparedData, *, batch_size: int = 64,
              unimodal: bool = False, seed: int = 0, lazy_adam: bool = True,
              return_embeddings: bool = False, device="cuda", draws: Optional[Sequence] = None,
              fused_dec_update: bool = False, validation_curve: bool = False,
              infer_warm_start: bool = False, infer_epochs_cap: int = 0,
              infer_batch_clamp: bool = False, senti_mask=None, mesh=None,
              graphs: bool = True) -> SweepResult:
    """Train ``configs`` (one optimizer kind, one e2e mode, one word metric)
    as one chunk with a leading config axis on ``device``.

    ``prep`` is :func:`mmtpu_torch.data.pipeline.prepare_device_data`'s
    output in ``pos_mode="shared"`` with every positional dim the configs
    use (or none).  ``lazy_adam`` (the sweep's default, as in mmtpu) runs
    the latent tables of an Adam chunk with epoch-level lazy Adam; False is
    dense Adam.  ``draws`` holds one draws object per config (the interface
    of :class:`SweepDraws`, which is the default).  The chunk's epoch count
    is its longest config's; a config's later epochs are masked, and its
    final loss is its own last epoch's.

    The other options are mmtpu's (:func:`run_sweep`): ``fused_dec_update``
    (K2 in the train fit, two launches per step for the chunk),
    ``validation_curve`` (``metrics["valid_curve"]``), ``infer_warm_start``,
    ``infer_epochs_cap``, ``infer_batch_clamp``, ``senti_mask`` and
    ``mesh`` (every rank of the mesh calls with the same configs; each
    trains its block of them on ``device``, its own, and every rank returns
    the whole chunk's result).  ``graphs`` as :func:`build_sweep_parts`'s:
    True captures the train and infer fits' epochs on the card.
    """
    _check_mesh(mesh)
    if not configs:
        raise ValueError("run_chunk needs at least one config")
    device = _device(device)
    statics = chunk_statics(configs, prep, batch_size=batch_size, unimodal=unimodal,
                            lazy_adam=lazy_adam, fused_dec_update=fused_dec_update,
                            validation_curve=validation_curve,
                            infer_warm_start=infer_warm_start,
                            infer_epochs_cap=int(infer_epochs_cap),
                            infer_batch_clamp=infer_batch_clamp)
    return _queue_chunk(configs, prep, _Uploaded.of(prep, device), statics,
                        _draws_for(configs, draws, seed), device, return_embeddings,
                        senti_mask=senti_mask, mesh=mesh, graphs=graphs, phase_timing=True)()


def run_config_alone(config: dict, prep: PreparedData, *, batch_size: int = 64,
                     unimodal: bool = False, seed: int = 0, lazy_adam: bool = True,
                     device="cuda", draws=None, graphs: bool = True) -> SweepResult:
    """One config of a chunk run by itself through the single-config fits
    (no config axis), with the draws it has in any chunk: the reference
    that the chunk is held to.  Returns a one-config :class:`SweepResult`
    with embeddings and predictions."""
    device = _device(device)
    statics = chunk_statics([config], prep, batch_size=batch_size, unimodal=unimodal,
                            lazy_adam=lazy_adam)
    return _execute([config], prep, statics,
                    _draws_for([config], None if draws is None else [draws], seed), device,
                    return_embeddings=True, config_axis=False, graphs=graphs)


def _kernel_build_s(device: torch.device) -> float:
    """Seconds spent building the kernel library now; 0 where it was built
    before (by this process or an earlier one) or off the card."""
    if device.type != "cuda":
        return 0.0
    from mmtpu_torch.kernels import build

    built = build.library_path().is_file()
    t0 = time.perf_counter()
    build.load()
    return 0.0 if built else time.perf_counter() - t0


def _out_of_memory(exc: BaseException) -> bool:
    """Whether ``exc`` is the card running out of memory: a
    ``torch.cuda.OutOfMemoryError``, or an error that it caused (a capture
    that failed on one, :class:`mmtpu_torch.graphs.GraphCaptureError`)."""
    while exc is not None:
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
        exc = exc.__cause__
    return False


def _buckets(configs: Sequence[dict], n_epochs_max: int, chunk: int) -> list:
    """mmtpu's work list (``mmtpu/sweep/runner.py:538-553``): ``(chunk_id,
    kind, n_epochs, positions)`` per chunk.  Configs are bucketed by
    (optimizer, n_epochs) where the grid has 2-4 distinct epoch counts, else
    by optimizer at the grid's longest count; each bucket is cut into chunks
    of ``chunk``, the last one ragged."""
    ne_values = sorted({int(c.get("n_epochs", 100)) for c in configs})
    split_epochs = 1 < len(ne_values) <= 4
    by_key: Dict[tuple, list] = {}
    for i, c in enumerate(configs):
        ne = int(c.get("n_epochs", 100)) if split_epochs else n_epochs_max
        by_key.setdefault((c.get("optimizer", "sgd"), ne), []).append(i)
    return [(f"{kind}{ne}_{ci}", kind, ne, pos[ci * chunk:(ci + 1) * chunk])
            for (kind, ne), pos in sorted(by_key.items())
            for ci in range(-(-len(pos) // chunk))]


class _ChunkStore:
    """Finished chunks in ``checkpoint_dir``: ``chunk_<id>.npz`` each, and
    ``sweep_state.json`` naming them beside the sweep's fingerprint; both
    written to a temporary name and renamed.  A state of another sweep
    (another fingerprint, config count or chunk size) is ignored."""

    def __init__(self, root: str, n_configs: int, chunk: int, fingerprint: str):
        self.root, self.key = root, {"n_configs": n_configs, "chunk": chunk,
                                     "fingerprint": fingerprint}
        self.path = os.path.join(root, "sweep_state.json")
        self.done: List[str] = []
        self.stale = False
        os.makedirs(root, exist_ok=True)
        if os.path.isfile(self.path):
            with open(self.path) as f:
                st = json.load(f)
            if all(st.get(k) == v for k, v in self.key.items()):
                self.done = [str(c) for c in st.get("chunks", [])]
            else:
                self.stale = True

    def load(self, cid: str) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.root, f"chunk_{cid}.npz")) as npz:
            return {k: npz[k] for k in npz.files}

    def save(self, cid: str, arrays: Dict[str, np.ndarray]) -> None:
        path = os.path.join(self.root, f"chunk_{cid}.npz")
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **arrays)
        os.replace(path + ".tmp", path)
        self.done.append(cid)
        with open(self.path + ".tmp", "w") as f:
            json.dump(dict(self.key, chunks=sorted(self.done)), f)
        os.replace(self.path + ".tmp", self.path)


@in_region("mmtpu.sweep.call")
def run_sweep(configs: Sequence[dict], prep: PreparedData, batch_size: int = 64,
              unimodal: bool = False, seed: int = 0, chunk_size: Optional[int] = None,
              return_embeddings: bool = False, verbose: bool = True,
              checkpoint_dir: Optional[str] = None, n_runs: int = 1,
              senti_mask: Optional[np.ndarray] = None, validation_curve: bool = False,
              lazy_adam: Optional[bool] = None, phase_timing: bool = False,
              infer_batch_clamp: bool = False, fused_dec_update: bool = False,
              infer_warm_start: bool = False, infer_epochs_cap: int = 0, *, device="cuda",
              draws: Optional[Callable] = None, mesh=None) -> SweepResult:
    """Run every config of the grid in chunks with a leading config axis
    (mmtpu's :func:`mmtpu.sweep.runner.run_sweep`, less its TPU options
    ``use_pallas`` and ``unroll``).

    Args:
        configs: config dicts (reference JSON format).
        prep: :func:`mmtpu_torch.data.pipeline.prepare_device_data` output in
            ``pos_mode="shared"`` with every positional dim the configs use.
        chunk_size: configs per chunk; default ``min(len, 32)`` after the
            ``n_runs`` expansion (the chunk ids and the resume state key on
            it).  A bucket's last chunk runs at its own width.
        checkpoint_dir: each finished chunk is saved there; a restarted
            sweep of the same fingerprint (statics, seed, batch size,
            configs, mask, ``return_embeddings``) computes only the chunks
            it lacks; another sweep's state is ignored.
        n_runs: repetitions per config with independent draws, as
            ``(config, run)`` pairs along the config axis.
        senti_mask: sweep-level 0/1 labeled mask over the train rows
            (semi-supervised runs; :func:`build_sweep_parts`).
        validation_curve: per-config recursive validation curves, cadence
            80, as ``metrics["valid_curve"]`` (``n_epochs_max + 1`` wide
            over the grid, NaN between samples).
        lazy_adam: epoch-level lazy Adam for the latent tables; None (the
            default) is on, as in mmtpu; False is dense Adam.
        phase_timing: time each chunk's phases, the device synced after
            each, into its ``chunk_stats`` entry and ``phase_s``; the chunks
            then run one after another (without it, chunk k's results are
            read back, scattered and saved while chunk k+1 runs, and
            ``phase_s`` is empty).
        infer_batch_clamp, infer_warm_start, infer_epochs_cap,
            fused_dec_update: as :class:`SweepStatics`.
        device: ``"cuda"`` (the default) or ``"cpu"``.
        draws: ``(config_num, run_idx) -> draws object`` (the interface of
            :class:`SweepDraws`, which is the default, seeded from ``seed``).
        mesh: shard each chunk's configs over the mesh's "config" axis
            (:func:`run_chunk`); every rank calls alike and returns the
            whole result.  Every rank reads ``checkpoint_dir``; the mesh's
            first rank alone writes it.

    The result's ``chunk_stats`` holds one record per computed chunk, the
    chunk's span of the call (named by its ``chunk`` id), on the call's one
    clock: the call first waits for the card once (an event recorded and
    synchronised, the one wait that the timeline adds), and its seconds
    count from there, as ``done_at_s`` (when the chunk was read back,
    scattered and saved) does.

    - ``device_s``: the stream's seconds in each phase (``train``,
      ``valid_infer``, ``test_infer``, ``sentiment``, ``metrics``), between
      timing events queued before the first phase and after each, read once
      the chunk's results are back (on the CPU, the host's seconds around
      each phase).  A bucket's first chunk's phases hold the bucket's
      warm-ups and captures.
    - ``device_warmup_s``: the stream's seconds in the bucket's eager
      warm-ups in the chunk (``Graphs.warmup_marks``), inside its phases.
    - ``device_start_at_s``, ``device_end_at_s``: the events before the
      train phase and after the metrics.
    - ``host_s``: the host's seconds of the chunk's ``prepare`` (draws,
      inits, permutations, packing and uploads, until the first phase is
      queued), of the bucket's ``capture`` in its phases (``Graphs.capture_s``:
      each from an idle card, with ``torch.cuda.graph``'s own
      ``gc.collect`` and ``empty_cache``), of the ``wait`` for its results
      and of its ``drain`` (scatter and checkpoint save).
    - ``alloc``: the caching allocator's ``device_allocs`` (``cudaMalloc``)
      and ``device_frees`` (``cudaFree``) while the chunk was queued and
      drained; 0 on the CPU.
    - ``graphs``: the bucket's warm-ups, captures and replays in the chunk;
      ``phases``: with ``phase_timing``, the synced seconds of each phase.

    Under an active ``torch.profiler`` session the call, each chunk's
    preparation, phases, wait and drain and each warm-up and capture are
    host ranges of the trace (``mmtpu.sweep.call``,
    ``mmtpu.chunk.{prepare,<phase>,wait,drain}``,
    ``mmtpu.graphs.{warmup,capture}``;
    :func:`mmtpu_torch.utils.profiling.region`).  ``chunk_size`` is the
    width the sweep ran at; ``out_of_memory_widths`` the wider ones that ran
    out of the card's memory first.
    """
    _check_mesh(mesh)
    device = _device(device)
    clock = _Clock(device)  # the call's one synchronize
    t0 = clock.t0
    compile_time = _kernel_build_s(device)
    if n_runs > 1:
        configs = [dict(c, _run_idx=r) for c in configs for r in range(n_runs)]
    if not configs:
        raise ValueError("run_sweep needs at least one config")
    statics = sweep_statics(configs, prep, batch_size=batch_size, unimodal=unimodal,
                            lazy_adam=lazy_adam is None or bool(lazy_adam),
                            validation_curve=validation_curve,
                            infer_batch_clamp=infer_batch_clamp,
                            fused_dec_update=fused_dec_update,
                            infer_warm_start=infer_warm_start,
                            infer_epochs_cap=int(infer_epochs_cap))
    if draws is None:
        draws = lambda num, run: SweepDraws(seed, num, run)  # noqa: E731
    k_total = len(configs)
    chunk = chunk_size or min(k_total, 32)
    work = _buckets(configs, statics.n_epochs_max, chunk)

    store = None
    if checkpoint_dir is not None:
        fingerprint = hashlib.sha256(json.dumps(
            {"bucketing": "opt+epochs", "return_embeddings": return_embeddings, "seed": seed,
             "batch_size": batch_size, "unimodal": unimodal,
             "statics": dataclasses.asdict(statics), "configs": list(configs),
             "senti_mask": None if senti_mask is None else np.asarray(senti_mask).tolist()},
            sort_keys=True, default=str).encode()).hexdigest()
        store = _ChunkStore(checkpoint_dir, k_total, chunk, fingerprint)
        if verbose and store.done:
            print(f"[sweep] resuming: {len(store.done)}/{len(work)} chunks already complete")
        elif verbose and store.stale:
            print("[sweep] checkpoint_dir holds a different sweep (fingerprint mismatch) — "
                  "starting fresh")

    final_loss = np.zeros(k_total, np.float32)
    diverged = np.zeros(k_total, bool)
    out: Dict[str, np.ndarray] = {}  # metrics, then "emb_<split>"
    chunk_stats: List[dict] = []
    phase_s: Dict[str, float] = {}

    def scatter(positions, arrays):
        final_loss[positions] = arrays["final_train_loss"]
        diverged[positions] = arrays["diverged"]
        for name, v in arrays.items():
            if name not in ("final_train_loss", "diverged"):
                if name not in out:
                    out[name] = np.zeros((k_total,) + v.shape[1:], v.dtype)
                out[name][positions] = v

    # the index of each bucket's last chunk to compute
    last_of = {(kind, ne): wi for wi, (cid, kind, ne, _) in enumerate(work)
               if store is None or cid not in store.done}
    # the splits, labels, vocabulary and SIF inits: uploaded once per sweep
    up = _Uploaded.of(prep, device) if last_of else None
    # one store of captured graphs per (optimizer, n_epochs) bucket: each
    # chunk of a bucket replays what its first chunk captured (mmtpu's one
    # program per bucket); dropped once the bucket's last chunk is drained
    stores: Dict[tuple, graphs_mod.Graphs] = {}

    # the allocator's counts at the last read: each chunk's queue and
    # drain take the calls since the read before them
    last_allocs = _alloc_counts(device)

    def allocs_since() -> np.ndarray:
        nonlocal last_allocs
        now = _alloc_counts(device)
        since, last_allocs = now - last_allocs, now
        return since

    def queue(wi, cid, kind, ne, positions):
        chunk_cfgs = [configs[p] for p in positions]
        bucket = (kind, ne)
        if bucket not in stores:
            stores[bucket] = graphs_mod.Graphs(device, graphs_mod.use_graphs(True, device))
        g = stores[bucket]
        counts = (g.warmups, g.captures, g.replays)
        n_warm, capture_s = len(g.warmup_marks), g.capture_s
        # the chunk's timeline as queued: its marks and seconds (_queue),
        # its warm-ups' marks, its captures' seconds, its allocations
        spans = {"clock": clock}
        finish = _queue_chunk(
            chunk_cfgs, prep, up, dataclasses.replace(statics, opt_kind=kind, n_epochs_max=ne),
            [draws(int(c.get("config_num", 0)), int(c.get("_run_idx", 0))) for c in chunk_cfgs],
            device, return_embeddings, senti_mask=senti_mask, mesh=mesh, graphs=g,
            phase_timing=phase_timing, spans=spans)
        made = {name: n - n0 for name, n, n0 in zip(
            ("warmups", "captures", "replays"), (g.warmups, g.captures, g.replays), counts)}
        spans.update(warmups=g.warmup_marks[n_warm:], capture_s=g.capture_s - capture_s,
                     allocs=allocs_since())
        return wi, cid, kind, ne, positions, finish, made, spans

    def drain(queued):
        """Chunk ``queued``'s results read back, scattered, saved and counted."""
        wi, cid, kind, ne, positions, finish, made, spans = queued
        res = finish()
        t_drain = time.perf_counter()
        with region("mmtpu.chunk.drain"):
            arrays = {"final_train_loss": res.final_train_loss, "diverged": res.diverged,
                      **res.metrics}
            if "valid_curve" in arrays:  # a bucket's curve, padded to the grid's width
                vc = arrays["valid_curve"]
                arrays["valid_curve"] = np.pad(vc, ((0, 0), (0, statics.n_epochs_max + 1
                                                             - vc.shape[-1])),
                                               constant_values=np.nan)
            if return_embeddings:
                arrays.update({f"emb_{s}": e for s, e in res.embeddings.items()})
            scatter(positions, arrays)
            if store is not None and (mesh is None or mesh.is_main):
                store.save(cid, arrays)
        drain_s = time.perf_counter() - t_drain
        for name, secs in res.phase_s.items():
            phase_s[name] = phase_s.get(name, 0.0) + secs
        # a mesh rank that trained none of the chunk's configs has no timeline
        timeline = {}
        if "marks" in spans:
            at = [(name, clock.at(m)) for name, m in spans["marks"]]
            allocs = spans["allocs"] + allocs_since()
            timeline = {
                "device_s": {name: round(b - a, 6) for (_, a), (name, b) in zip(at, at[1:])},
                "device_warmup_s": round(sum(graphs_mod.span_s(*m) for m in spans["warmups"]), 6),
                "device_start_at_s": round(at[0][1], 6), "device_end_at_s": round(at[-1][1], 6),
                "host_s": {"prepare": round(spans["prepare_s"], 6),
                           "capture": round(spans["capture_s"], 6),
                           "wait": round(spans["wait_s"], 6), "drain": round(drain_s, 6)},
                "alloc": {"device_allocs": int(allocs[0]), "device_frees": int(allocs[1])}}
        chunk_stats.append({"chunk": cid, "kind": kind, "configs": len(positions),
                            "done_at_s": round(time.perf_counter() - t0, 2), "graphs": made,
                            **timeline,
                            **({"phases": {k: round(v, 3) for k, v in res.phase_s.items()}}
                               if phase_timing else {})})
        if last_of[(kind, ne)] == wi:
            del stores[(kind, ne)]
        if verbose:
            print(f"[sweep] chunk {wi + 1}/{len(work)} [{kind}] done ({len(positions)} "
                  f"configs, {time.perf_counter() - t0:.1f}s)")

    # one chunk deep (mmtpu/sweep/runner.py:890-897): chunk k+1 is queued
    # (its host preparation overlapping chunk k on the device) before chunk
    # k is drained; phase_timing and the mesh run each chunk to its end
    pending, retry = None, False
    try:
        for wi, (cid, kind, ne, positions) in enumerate(work):
            if store is not None and cid in store.done:
                scatter(positions, store.load(cid))
                continue
            try:
                queued = queue(wi, cid, kind, ne, positions)
            except BaseException as exc:
                # the chunk before is finished and saved first, unless the
                # whole sweep reruns narrower
                if pending is not None and not (chunk > 2 and _out_of_memory(exc)):
                    drain(pending)
                raise
            done, pending = pending, queued
            if done is not None:
                drain(done)
            if phase_timing or mesh is not None:
                done, pending = pending, None
                drain(done)
        if pending is not None:
            drain(pending)
    except (torch.cuda.OutOfMemoryError, graphs_mod.GraphCaptureError) as exc:
        if chunk <= 2 or not _out_of_memory(exc):
            raise
        retry = True  # outside the handler: its traceback holds the failed chunk's tensors
    if retry:
        # mmtpu/sweep/runner.py:898-925: the whole sweep again at half the
        # width (chunks saved at this width are abandoned: the state keys on
        # it); configs are already (config, run) pairs, so n_runs is 1.  The
        # failed width's graphs and queued chunk go first, then the cached
        # blocks they held.
        pending = queued = up = None
        stores.clear()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if verbose:
            print(f"[sweep] chunk width {chunk} failed on device — "
                  f"retrying the sweep at width {chunk // 2}")
        res = run_sweep(configs, prep, batch_size=batch_size, unimodal=unimodal, seed=seed,
                        chunk_size=chunk // 2, return_embeddings=return_embeddings,
                        verbose=verbose, checkpoint_dir=checkpoint_dir,
                        senti_mask=senti_mask, validation_curve=validation_curve,
                        lazy_adam=statics.lazy_adam, phase_timing=phase_timing,
                        infer_batch_clamp=infer_batch_clamp,
                        fused_dec_update=fused_dec_update,
                        infer_warm_start=infer_warm_start,
                        infer_epochs_cap=infer_epochs_cap, device=device, draws=draws,
                        mesh=mesh)
        res.out_of_memory_widths.insert(0, chunk)
        return res

    return SweepResult(
        config_nums=np.asarray([c.get("config_num", i) for i, c in enumerate(configs)]),
        run_idxs=np.asarray([c.get("_run_idx", 0) for c in configs]),
        final_train_loss=final_loss,
        metrics={k: v for k, v in out.items() if not k.startswith("emb_")},
        wall_time_s=time.perf_counter() - t0,
        n_configs=k_total,
        compile_time_s=compile_time,
        chunk_stats=chunk_stats,
        embeddings=({s: out[f"emb_{s}"] for s in ("train", "valid", "test")}
                    if return_embeddings else None),
        diverged=diverged,
        phase_s=phase_s,
        chunk_size=chunk,
    )
