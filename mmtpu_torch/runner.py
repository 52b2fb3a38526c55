"""Experiment runner (port of :mod:`mmtpu.runner`).

One run does what mmtpu's does: numpy data preparation
(:mod:`mmtpu_torch.data`, the port's copy of ``mmtpu.data``), the training
fit (the e2e joint fit or the likelihood-only latent fit, as the config
says), the valid/test inference fits against the frozen decoder (batch x8,
unshuffled), the downstream sentiment MLP evaluated before and after
training, and the artifacts.

All randomness of a run comes from a :class:`Draws` object: the decoder
init, the e2e sentiment init, the training fit's shuffles, the sentiment
init and its shuffles.  The default draws from
``torch.Generator(seed + run_idx)``; the parity tests pass one that
reproduces mmtpu's JAX key splits.

With a ``mesh`` (:func:`mmtpu_torch.parallel.fit.make_fit_mesh`) the run
spans the ranks of a ``torch.distributed`` world, one process each: the
training fit and the inference fits split their batches' rows over "data"
and the vocabulary over "vocab" (:mod:`mmtpu_torch.parallel.fit`); every
rank computes the same results, and the mesh's first rank alone writes the
artifacts and prints.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from mmtpu_torch.config import ExperimentConfig
from mmtpu_torch.convert import to_numpy, to_torch
from mmtpu_torch.data.pipeline import PreparedData, prepare_device_data
from mmtpu_torch.data.registry import load_dataset
from mmtpu_torch.eval.report import full_loss, iemocap_loss, pom_loss
from mmtpu_torch.io.artifacts import ArtifactStore
from mmtpu_torch.io.checkpoint import Checkpointer
from mmtpu_torch.models.decoder import (MMB1_HEADS, MMB2_HEADS, NORM_CODES, assemble_head_data,
                                        init_decoder)
from mmtpu_torch.models.sentiment import apply_sentiment, init_sentiment
from mmtpu_torch.ops.closed_form import closed_form_latents
from mmtpu_torch.parallel.fit import fit_e2e_mesh, fit_latents_mesh
from mmtpu_torch.train.chunked import fit_latents_checkpointed
from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e
from mmtpu_torch.train.latents import LatentFitSpec, fit_latents, train_view
from mmtpu_torch.train.optim import OPT_CODES
from mmtpu_torch.train.sentiment import SentimentFitSpec, fit_sentiment
from mmtpu_torch.tree import tree_map


def build_hp(cfg: ExperimentConfig, device) -> Dict:
    """Fit hyperparameters: the ones that enter tensor math are 0-d tensors
    on ``device``; ``opt_code`` and ``n_epochs`` steer the host loop."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return {
        "lr": f32(cfg.lr),
        "word_loss_weight": f32(cfg.word_loss_weight),
        "likelihood_weight": f32(cfg.likelihood_weight),
        "opt_code": OPT_CODES[cfg.optimizer],
        "norm_code": torch.tensor(NORM_CODES[cfg.norm], device=device),
        "n_epochs": int(cfg.n_epochs),
    }


def prepare(cfg: ExperimentConfig, data_dir: str = ".") -> PreparedData:
    """As :func:`mmtpu.runner.prepare`; parity mode keeps the raw Gaussian
    streams, otherwise the fits use sufficient statistics."""
    dataset = load_dataset(cfg.dataset, data_dir=data_dir, emotion=cfg.emotion)
    return prepare_device_data(
        dataset,
        word_sim_metric=cfg.word_sim_metric,
        pos_embed_dim=cfg.pos_embed_dim,
        pos_mode="baked",
        pos_bug_parity=cfg.parity,
        suff_stats=not cfg.parity,
    )


def semi_sup_mask(dataset: str, semi_sup_idxes: Optional[str], n_train: int, seed: int = 0,
                  data_dir: str = ".") -> Optional[np.ndarray]:
    """0/1 labeled mask from ``<dataset>_subset_idxes.h5``; a deterministic
    subset when the file is absent (as mmtpu's)."""
    if semi_sup_idxes is None:
        return None
    mask = np.zeros(n_train, np.float32)
    path = os.path.join(data_dir, f"{dataset}_subset_idxes.h5")
    if os.path.isfile(path):
        import h5py

        with h5py.File(path, "r") as f:
            idxes = f[semi_sup_idxes][:]
    else:
        frac = float(semi_sup_idxes)
        rng = np.random.default_rng(seed)
        idxes = rng.choice(n_train, size=int(round(frac * n_train)), replace=False)
    mask[idxes] = 1.0
    return mask


class Draws:
    """The random draws of one run, from one ``torch.Generator`` in call
    order.  Parameters come back on the CPU; permutations as CPU tensors."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def init_decoder(self, embed_dim, audio_dim, visual_dim, unimodal, text_dim) -> dict:
        return init_decoder(self.gen, embed_dim, audio_dim, visual_dim, unimodal=unimodal,
                            text_dim=text_dim)

    def init_e2e_sentiment(self, embed_dim, hidden_dim, n_out) -> dict:
        """The sentiment MLP that the e2e fit trains jointly."""
        return init_sentiment(self.gen, embed_dim, hidden_dim, n_out)

    def train_permutations(self, n: int, n_epochs: int) -> list:
        return [torch.randperm(n, generator=self.gen) for _ in range(n_epochs)]

    def init_sentiment(self, embed_dim, hidden_dim, n_out) -> dict:
        return init_sentiment(self.gen, embed_dim, hidden_dim, n_out)

    def sentiment_permutations(self, n: int, n_epochs: int) -> list:
        return [torch.randperm(n, generator=self.gen) for _ in range(n_epochs)]


def _to_device(params: dict, device) -> dict:
    return tree_map(lambda t: t.to(device), params)


def _sentiment_phase(cfg: ExperimentConfig, prep: PreparedData, latents: Dict, store,
                     which: str, draws, device, train_idxes=None, verbose: bool = True) -> Dict:
    """Eval-before, train (optionally early-stopped), eval-after with the
    LAST parameters (``mmtpu.runner._sentiment_phase``)."""
    train_lat, valid_lat, test_lat = latents["train"], latents["valid"], latents["test"]
    y_train, y_valid = (to_torch(prep.labels[s], device) for s in ("train", "valid"))
    if train_idxes is not None:  # semi-sup: the labeled rows only
        sel = torch.as_tensor(np.nonzero(train_idxes)[0], device=device)
        train_lat, y_train = train_lat[sel], y_train[sel]

    n_out = 1 if y_train.ndim == 1 else y_train.shape[-1]
    params = _to_device(
        draws.init_sentiment(prep.embed_dim, cfg.sentiment_hidden_size, n_out), device)

    def report(pred):
        pred, y = to_numpy(pred), prep.labels["test"]
        if cfg.dataset == "mosi":
            return full_loss(pred, y, verbose=verbose)
        if cfg.dataset == "iemocap":
            return iemocap_loss(pred, y, verbose=verbose)
        return pom_loss(pred, y, verbose=verbose)

    with torch.no_grad():
        before = report(apply_sentiment(params, test_lat))
    if store is not None:
        store.save_results(which, "before", before)

    shp = {"lr": cfg.sentiment_lr, "lr_decay": cfg.lr_decay, "n_epochs": cfg.n_sentiment_epochs}
    sspec = SentimentFitSpec(n_epochs_max=cfg.n_sentiment_epochs,
                             early_stopping=cfg.early_stopping)
    perms = draws.sentiment_permutations(train_lat.shape[0], cfg.n_sentiment_epochs)
    last, _, tr_losses, va_losses = fit_sentiment(
        params, train_lat, y_train, valid_lat, y_valid, shp, sspec, perms=perms)
    with torch.no_grad():
        after = report(apply_sentiment(last, test_lat))
    if store is not None:
        store.save_results(which, "after", after)
        store.save_sentiment_losses(which, tr_losses, va_losses)
        store.save_sentiment_model(which, last)
    return {"before": before, "after": after}


def time_closed_form(cfg: ExperimentConfig, prep: PreparedData, decoder, device,
                     verbose: bool = True) -> Dict:
    """The ``--time_test`` harness (``simplesif.py:808-889``): the
    closed-form latents of the test split from the trained decoder, with
    each head's streams concatenated as the reference's explicit cats
    (``simplesif.py:820-842``).  One call warms up, the next is timed, the
    device synchronised on either side.  Returns ``{"latency_s",
    "n_utterances"}``."""
    heads = MMB1_HEADS if cfg.unimodal else MMB2_HEADS
    d = prep.splits["test"]
    vocab = to_torch(prep.vocab_embeddings, device)
    data = assemble_head_data({k: to_torch(d[k], device)
                               for k in ("text_gauss", "audio", "visual")}, heads)
    head_params = {h: decoder["heads"][h] for h in heads}
    weights = to_torch(d["text_weights"], device)
    sent = vocab[to_torch(d["text_ids"], device)]

    def call():
        with torch.no_grad():
            return closed_form_latents(data, head_params, weights, sent)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    call()
    sync()
    t0 = time.perf_counter()
    lat = call()
    sync()
    dt = time.perf_counter() - t0
    if verbose:
        print("time taken:", dt)
    return {"latency_s": dt, "n_utterances": int(lat.shape[0])}


def run_experiment(
    cfg: ExperimentConfig,
    data_dir: str = ".",
    out_root: str = "model_saves",
    prep: Optional[PreparedData] = None,
    run_idx: int = 0,
    save_artifacts: bool = True,
    time_test: bool = False,
    validation_curve: bool = False,
    verbose: bool = True,
    mesh=None,
    resume_dir: Optional[str] = None,
    lazy_adam: bool = False,
    *,
    device,
    draws=None,
) -> Dict:
    """Run one full experiment for one config on ``device``.

    Returns mmtpu's results dict (``config_num``, ``train_time_s``,
    ``final_train_loss``, ``diverged``, ``sentiment``).  A config whose
    final loss or embeddings are not finite is recorded as diverged; the run
    goes on.  ``draws`` defaults to ``Draws(cfg.seed + run_idx)``.

    ``validation_curve=True`` refits the valid split against the frozen
    decoder every 80 epochs and after the last (the reference's recursive
    validation, ``simplesif.py:146-159``) and writes that curve's samples as
    ``embed_valid_loss``.  ``resume_dir`` makes the non-e2e training fit
    resumable in epoch segments (:mod:`mmtpu_torch.train.chunked`; a killed
    run restarted with the same directory goes on where it stopped).
    ``lazy_adam=True`` runs the training and inference fits with epoch-level
    lazy Adam (an Adam config only; the sweep's default in mmtpu).
    ``time_test=True`` times the closed-form estimate of the test split from
    the trained decoder (:func:`time_closed_form`) into
    ``results["closed_form"]``.

    ``mesh`` (a ("data", "vocab") :class:`mmtpu_torch.parallel.mesh.Mesh`;
    every rank calls with the same arguments and its own ``device``) runs
    the training and inference fits sharded over it
    (:func:`mmtpu_torch.parallel.fit.fit_latents_mesh`,
    :func:`mmtpu_torch.parallel.fit.fit_e2e_mesh`).  As in mmtpu it takes
    neither ``validation_curve`` nor ``resume_dir``.
    """
    if mesh is not None and validation_curve:
        raise ValueError("--mesh does not support --validation_curve "
                         "(the mesh fits are no-validation programs)")
    if resume_dir is not None and cfg.e2e:
        raise ValueError("--resume_dir supports non-e2e fits only "
                         "(pass --e2e n or set e2e: false in the config)")
    if resume_dir is not None and mesh is not None:
        raise ValueError("--resume_dir and --mesh are mutually exclusive")
    if mesh is not None and not mesh.is_main:  # the first rank writes and prints
        save_artifacts, verbose = False, False
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    if prep is None:
        prep = prepare(cfg, data_dir)
    if draws is None:
        draws = Draws(cfg.seed + run_idx)

    store = None
    if save_artifacts:
        store = ArtifactStore(out_root, cfg.config_name or "mmtpu", cfg.config_num, run_idx)
        store.save_config(cfg.to_dict())
        store.save_embeddings(
            "pre", np.concatenate([prep.sif_init[s] for s in ("train", "valid", "test")], axis=0))

    decoder = _to_device(draws.init_decoder(
        prep.embed_dim, prep.audio_dim, prep.visual_dim, cfg.unimodal, prep.text_gauss_dim),
        device)
    hp = build_hp(cfg, device)
    vocab = to_torch(prep.vocab_embeddings, device)
    split = {s: to_torch(train_view(prep.splits[s]), device) for s in ("train", "valid", "test")}
    init = {s: to_torch(prep.sif_init[s], device) for s in ("train", "valid", "test")}

    t_train_start = time.time()
    semi_mask = semi_sup_mask(cfg.dataset, cfg.semi_sup_idxes, prep.labels["train"].shape[0],
                              seed=cfg.seed, data_dir=data_dir)
    valid_every = 80 if validation_curve else 0  # the reference's valid_niter * 8
    validation = (init["valid"], split["valid"]) if validation_curve else None
    valid_curve = None
    if cfg.e2e:
        labels = to_torch(prep.labels["train"], device)
        n_out = 1 if labels.ndim == 1 else labels.shape[-1]
        senti0 = _to_device(draws.init_e2e_sentiment(prep.embed_dim, cfg.sentiment_hidden_size,
                                                     n_out), device)
        espec = E2EFitSpec(n_epochs_max=cfg.n_epochs, batch_size=cfg.batch_size,
                           unimodal=cfg.unimodal, word_metric=cfg.word_sim_metric,
                           opt_kind=cfg.optimizer, valid_every=valid_every,
                           lazy_adam=lazy_adam)
        # e2e freeze_weights: the heads freeze, the norm still trains
        e2e_hp = dict(hp, train_heads=torch.tensor(float(not cfg.freeze_weights),
                                                   device=device))
        perms = draws.train_permutations(init["train"].shape[0], cfg.n_epochs)
        smask = None if semi_mask is None else to_torch(semi_mask, device)
        if mesh is not None:
            out = fit_e2e_mesh(mesh, init["train"], decoder, senti0, split["train"], labels,
                               vocab, e2e_hp, espec, senti_mask=smask, perms=perms)
        else:
            out = fit_e2e(init["train"], decoder, senti0, split["train"], labels, vocab, e2e_hp,
                          espec, senti_mask=smask, perms=perms, validation=validation)
        train_embed, decoder, _, train_losses = out[:4]
        valid_curve = out[4] if validation_curve else None
    else:
        spec = LatentFitSpec(
            n_epochs_max=cfg.n_epochs,
            batch_size=cfg.batch_size,
            train_decoder=not cfg.freeze_weights,
            unimodal=cfg.unimodal,
            word_metric=cfg.word_sim_metric,
            opt_kind=cfg.optimizer,
            valid_every=valid_every,
            lazy_adam=lazy_adam,
        )
        perms = draws.train_permutations(init["train"].shape[0], cfg.n_epochs)
        if resume_dir is not None and not validation_curve:
            train_embed, decoder, train_losses = fit_latents_checkpointed(
                init["train"], decoder, split["train"], vocab, hp, spec,
                checkpointer=Checkpointer(resume_dir), verbose=verbose, perms=perms)
        elif mesh is not None:
            train_embed, decoder, train_losses = fit_latents_mesh(
                mesh, init["train"], decoder, split["train"], vocab, hp, spec, perms=perms)
        else:
            out = fit_latents(init["train"], decoder, split["train"], vocab, hp, spec,
                              perms=perms, validation=validation)
            train_embed, decoder, train_losses = out[:3]
            valid_curve = out[3] if validation_curve else None

    # inference = the fit with the decoder frozen; valid/test are unshuffled
    # at batch_size*8 (simplesif.py:458-459)
    infer_spec = LatentFitSpec(
        n_epochs_max=cfg.n_epochs,
        batch_size=cfg.batch_size * 8,
        train_decoder=False,
        unimodal=cfg.unimodal,
        word_metric=cfg.word_sim_metric,
        shuffle=False,
        opt_kind=cfg.optimizer,
        lazy_adam=lazy_adam,
    )
    def infer(s):  # with a mesh the inference fits split their batches over it too
        if mesh is None:
            return fit_latents(init[s], decoder, split[s], vocab, hp, infer_spec)
        return fit_latents_mesh(mesh, init[s], decoder, split[s], vocab, hp, infer_spec)

    valid_embed, _, valid_losses = infer("valid")
    test_embed, _, test_losses = infer("test")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.time() - t_train_start

    train_losses_np = to_numpy(train_losses)
    if store is not None:
        store.save_losses("embed_loss", train_losses_np)
        store.save_losses("embed_valid_loss", valid_losses if valid_curve is None
                          else valid_curve[torch.isfinite(valid_curve)])
        store.save_losses("embed_test_loss", test_losses)
        store.save_embeddings("post", torch.cat([train_embed, valid_embed, test_embed]))

    final_loss = float(train_losses_np[cfg.n_epochs - 1])
    diverged = not (np.isfinite(final_loss) and bool(torch.isfinite(train_embed).all()))
    if diverged and verbose:
        print(f"[mmtpu_torch] WARNING: config {cfg.config_num} diverged "
              f"(final_loss={final_loss})")
    results: Dict = {
        "config_num": cfg.config_num,
        "train_time_s": train_time,
        "final_train_loss": final_loss,
        "diverged": diverged,
    }
    if time_test:
        results["closed_form"] = time_closed_form(cfg, prep, decoder, device, verbose)
    latents = {"train": train_embed, "valid": valid_embed, "test": test_embed}
    # semi-sup subsetting applies in both modes (simplesif.py:910-912)
    results["sentiment"] = _sentiment_phase(cfg, prep, latents, store, "post", draws, device,
                                            train_idxes=semi_mask, verbose=verbose)
    return results
