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

mmtpu's loop over many chunks is not ported yet: the options below that
belong to it raise :func:`mmtpu_torch.not_ported`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mmtpu_torch import not_ported
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.data.pipeline import PreparedData
from mmtpu_torch.eval.metrics import iemocap_metrics, mosi_metrics, pom_metrics
from mmtpu_torch.models.decoder import init_decoder
from mmtpu_torch.models.sentiment import apply_sentiment, init_sentiment
from mmtpu_torch.sweep.pack import SweepStatics, pack_configs, statics_from_configs
from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e
from mmtpu_torch.train.latents import LatentFitSpec, fit_latents, train_view
from mmtpu_torch.train.sentiment import SentimentFitSpec, fit_sentiment
from mmtpu_torch.tree import tree_map


@dataclasses.dataclass
class SweepResult:
    """Per-config arrays (leading axis = config), ordered as the input list."""

    config_nums: np.ndarray
    run_idxs: np.ndarray
    final_train_loss: np.ndarray
    metrics: Dict[str, np.ndarray]  # per-config test metrics after training
    diverged: np.ndarray  # final loss or train embeddings not finite
    wall_time_s: float
    n_configs: int
    phase_s: Dict[str, float]  # wall seconds per phase, device synced
    # with return_embeddings=True: {"train"/"valid"/"test": (K, N_split, D)}
    # and the test predictions the metrics score, (K, N_test[, n_out])
    embeddings: Optional[Dict[str, np.ndarray]] = None
    predictions: Optional[np.ndarray] = None


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
                      vocab: torch.Tensor, dataset_name: str) -> Dict[str, Callable]:
    """The chunk's four phases as functions of the per-config inputs (with
    or without the config axis): ``train(init, dec, senti, hp, data, perms)
    -> (embed, dec, losses)``, ``infer(init, dec, hp, data) -> embed``,
    ``sent(senti, train_e, valid_e, s_hp, perms) -> senti``,
    ``score(senti, test_e) -> (metrics, predictions)``."""
    lspec = LatentFitSpec(n_epochs_max=statics.n_epochs_max, batch_size=statics.batch_size,
                          train_decoder=True, unimodal=statics.unimodal,
                          word_metric=statics.word_metric, opt_kind=statics.opt_kind,
                          lazy_adam=statics.lazy_adam)
    espec = E2EFitSpec(n_epochs_max=statics.n_epochs_max, batch_size=statics.batch_size,
                       unimodal=statics.unimodal, word_metric=statics.word_metric,
                       opt_kind=statics.opt_kind, lazy_adam=statics.lazy_adam)
    ispec = dataclasses.replace(lspec, batch_size=statics.batch_size * 8, train_decoder=False,
                                shuffle=False)
    sspec = SentimentFitSpec(n_epochs_max=statics.n_sentiment_epochs_max,
                             early_stopping=statics.early_stopping)
    metric_fn = {"mosi": mosi_metrics, "pom": pom_metrics}.get(dataset_name, iemocap_metrics)

    def train(init, dec, senti, hp, data, perms):
        if statics.e2e:
            embed, dec2, _, losses = fit_e2e(init, dec, senti, data, labels["train"], vocab, hp,
                                             espec, perms=perms)
        else:
            embed, dec2, losses = fit_latents(init, dec, data, vocab, hp, lspec, perms=perms)
        return embed, dec2, losses

    def infer(init, dec, hp, data):
        return fit_latents(init, dec, data, vocab, hp, ispec)[0]

    def sent(senti, train_e, valid_e, s_hp, perms):
        return fit_sentiment(senti, train_e, labels["train"], valid_e, labels["valid"], s_hp,
                             sspec, perms=perms)[0]

    @torch.no_grad()
    def score(senti, test_e):
        pred = apply_sentiment(senti, test_e)
        return metric_fn(pred, labels["test"]), pred

    return {"train": train, "infer": infer, "sent": sent, "score": score}


def _check_options(fused_dec_update, validation_curve, infer_warm_start, infer_epochs_cap,
                   infer_batch_clamp, senti_mask, mesh) -> None:
    for on, what, item in (
            (fused_dec_update, "the sweep's fused decoder update", "queue 1 item 2b"),
            (validation_curve, "the sweep's validation curve", "queue 1 item 2b"),
            (infer_warm_start, "infer_warm_start", "queue 1 item 4"),
            (infer_epochs_cap, "infer_epochs_cap", "queue 1 item 2b"),
            (infer_batch_clamp, "infer_batch_clamp", "queue 1 item 2b"),
            (senti_mask is not None, "the sweep's senti_mask", "queue 1 item 2b"),
            (mesh is not None, "the sweep's mesh", "queue 1 item 5")):
        if on:
            raise not_ported(what, item)


def chunk_statics(configs: Sequence[dict], prep: PreparedData, *, batch_size: int,
                  unimodal: bool, lazy_adam: bool) -> SweepStatics:
    """The chunk's statics: one optimizer kind (a list that mixes them
    raises ``ValueError``), the positional layout rebased onto the prepared
    table's blocks."""
    kinds = sorted({c.get("optimizer", "sgd") for c in configs})
    if len(kinds) != 1:
        raise ValueError(f"a sweep chunk trains one optimizer kind, got {kinds}: bucket the "
                         f"configs by optimizer")
    statics = statics_from_configs(configs, batch_size=batch_size, unimodal=unimodal)
    statics = dataclasses.replace(statics, opt_kind=kinds[0], lazy_adam=lazy_adam)
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


def _stack(trees: list, device) -> dict:
    return tree_map(lambda *xs: torch.stack(xs).to(device), *trees)


def _execute(configs: Sequence[dict], prep: PreparedData, statics: SweepStatics,
             draws: Sequence, device: torch.device, return_embeddings: bool,
             config_axis: bool) -> SweepResult:
    """Run the four phases for ``configs``: with the config axis, or (one
    config, ``config_axis=False``) through the plain single-config inputs."""
    t_start = time.perf_counter()
    k = len(configs)
    hp_np = pack_configs(configs, statics)
    data = {s: to_torch(train_view(prep.splits[s]), device) for s in ("train", "valid", "test")}
    labels = {s: to_torch(prep.labels[s], device) for s in ("train", "valid", "test")}
    vocab = to_torch(prep.vocab_embeddings, device)
    init = {s: to_torch(prep.sif_init[s], device) for s in ("train", "valid", "test")}
    p_tab = 0 if prep.pos_table is None else int(prep.pos_table.shape[-1])
    n_out = 1 if prep.labels["train"].ndim == 1 else prep.labels["train"].shape[-1]
    n_train = prep.sif_init["train"].shape[0]

    decs = [d.init_decoder(prep.embed_dim, prep.audio_dim + p_tab, prep.visual_dim + p_tab,
                           statics.unimodal, prep.text_gauss_dim) for d in draws]
    sens = [d.init_sentiment(prep.embed_dim, int(h), n_out, statics.hidden_max)
            for d, h in zip(draws, hp_np["hidden_dims"])]
    tperms = [d.train_permutations(n_train, statics.n_epochs_max) for d in draws]
    sperms = [d.sentiment_permutations(n_train, statics.n_sentiment_epochs_max) for d in draws]
    pos_mask = np.pad(hp_np["pos_mask"], ((0, 0), (0, p_tab - hp_np["pos_mask"].shape[-1])))

    if config_axis:
        pick = lambda key: torch.as_tensor(hp_np[key], device=device)  # (K,)
        dec, sen = _stack(decs, device), _stack(sens, device)
        tperm = [torch.stack([p[e] for p in tperms]).to(device)
                 for e in range(statics.n_epochs_max)]
        sperm = [torch.stack([p[e] for p in sperms]).to(device)
                 for e in range(statics.n_sentiment_epochs_max)]
        init = {s: v.expand(k, *v.shape) for s, v in init.items()}
        pm = torch.as_tensor(pos_mask[:, None, :], device=device)  # (K, 1, P)
    else:
        if k != 1:
            raise ValueError("without the config axis, one config at a time")
        pick = lambda key: torch.as_tensor(hp_np[key][0], device=device)  # 0-d
        dec = tree_map(lambda t: t.to(device), decs[0])
        sen = tree_map(lambda t: t.to(device), sens[0])
        tperm, sperm = tperms[0], sperms[0]
        pm = torch.as_tensor(pos_mask[0], device=device)  # (P,)
    hp = {key: pick(key) for key in ("lr", "word_loss_weight", "likelihood_weight",
                                      "norm_code", "train_dec")}
    hp["train_heads"] = hp["train_dec"]  # the e2e fit's freeze gates the heads only
    s_hp = {"lr": pick("sentiment_lr"), "lr_decay": pick("lr_decay")}
    if config_axis:
        hp["n_epochs"], s_hp["n_epochs"] = pick("n_epochs"), pick("n_sentiment_epochs")
    else:  # one config: the host loop reads its epoch counts
        hp["n_epochs"] = int(hp_np["n_epochs"][0])
        s_hp["n_epochs"] = int(hp_np["n_sentiment_epochs"][0])
    if p_tab:
        for split in data.values():
            split["pos_mask"] = pm

    parts = build_sweep_parts(statics, labels, vocab, prep.name)
    phase_s: Dict[str, float] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        phase_s[name] = time.perf_counter() - t0
        return out

    embed, dec2, losses = timed("train", parts["train"], init["train"], dec, sen, hp,
                                data["train"], tperm)
    valid_e = timed("valid_infer", parts["infer"], init["valid"], dec2, hp, data["valid"])
    test_e = timed("test_infer", parts["infer"], init["test"], dec2, hp, data["test"])
    sen2 = timed("sentiment", parts["sent"], sen, embed, valid_e, s_hp, sperm)
    metrics, pred = timed("metrics", parts["score"], sen2, test_e)

    losses = losses.reshape(k, -1)
    last = np.clip(hp_np["n_epochs"] - 1, 0, statics.n_epochs_max - 1)
    final = to_numpy(losses)[np.arange(k), last]
    emb = {s: e.reshape(k, *e.shape[-2:]) for s, e in
           (("train", embed), ("valid", valid_e), ("test", test_e))}
    finite = torch.isfinite(emb["train"]).reshape(k, -1).all(dim=1)
    diverged = ~(np.isfinite(final) & to_numpy(finite))
    schema = metric_schema(prep)
    out_shape = pred.shape[-2:] if n_out > 1 else pred.shape[-1:]  # (N_test[, n_out])
    return SweepResult(
        config_nums=hp_np["config_num"].astype(np.int64),
        run_idxs=hp_np["run_idx"].astype(np.int64),
        final_train_loss=final,
        metrics={m: to_numpy(v).reshape(k, *schema[m]) for m, v in metrics.items()},
        diverged=diverged,
        wall_time_s=time.perf_counter() - t_start,
        n_configs=k,
        phase_s=phase_s,
        embeddings={s: to_numpy(e) for s, e in emb.items()} if return_embeddings else None,
        predictions=to_numpy(pred).reshape(k, *out_shape) if return_embeddings else None,
    )


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
              infer_batch_clamp: bool = False, senti_mask=None, mesh=None) -> SweepResult:
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

    The other options are mmtpu's and raise ``not_ported`` until they are
    ported (ROADMAP.md queue 1).
    """
    _check_options(fused_dec_update, validation_curve, infer_warm_start, infer_epochs_cap,
                   infer_batch_clamp, senti_mask, mesh)
    if not configs:
        raise ValueError("run_chunk needs at least one config")
    device = _device(device)
    statics = chunk_statics(configs, prep, batch_size=batch_size, unimodal=unimodal,
                            lazy_adam=lazy_adam)
    return _execute(configs, prep, statics, _draws_for(configs, draws, seed), device,
                    return_embeddings, config_axis=True)


def run_config_alone(config: dict, prep: PreparedData, *, batch_size: int = 64,
                     unimodal: bool = False, seed: int = 0, lazy_adam: bool = True,
                     device="cuda", draws=None) -> SweepResult:
    """One config of a chunk run by itself through the single-config fits
    (no config axis), with the draws it has in any chunk: the reference
    that the chunk is held to.  Returns a one-config :class:`SweepResult`
    with embeddings and predictions."""
    device = _device(device)
    statics = chunk_statics([config], prep, batch_size=batch_size, unimodal=unimodal,
                            lazy_adam=lazy_adam)
    return _execute([config], prep, statics,
                    _draws_for([config], None if draws is None else [draws], seed), device,
                    return_embeddings=True, config_axis=False)
