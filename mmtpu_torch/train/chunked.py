"""Epoch-segmented latent fits with checkpoint and resume (port of
:mod:`mmtpu.train.chunked`).

:func:`fit_latents_checkpointed` runs the latent fit as a loop over epoch
segments (:func:`mmtpu_torch.train.latents.fit_latents_segment`) and saves
the fit's state after each: embeddings, decoder, both optimizer states, the
losses so far and, when the fit draws its shuffles from a generator, the
generator's state.  Run to its end it is the monolithic fit; killed, the next
call with the same checkpointer resumes at the last saved segment.  A
checkpoint of another fit (its fingerprint differs) is refused and the fit
starts at epoch 0.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from mmtpu_torch.io.checkpoint import Checkpointer
from mmtpu_torch.models.decoder import is_stacked
from mmtpu_torch.train.latents import (
    LatentFitSpec,
    finish_fit_decoder,
    fit_latents_segment,
    init_fit_carry,
)
from mmtpu_torch.train.optim import OptState


def _summary(t) -> list:
    t = torch.as_tensor(t)
    return [str(t.dtype), list(t.shape), float(torch.sum(t.to(torch.float64)))]


def fit_fingerprint(init_embed, data: Mapping, vocab_emb, hp: Mapping, spec: LatentFitSpec,
                    perms: Sequence | None = None,
                    generator: torch.Generator | None = None) -> str:
    """sha256 over what determines the fit's trajectory: the spec, the
    hyperparameters, each input's dtype, shape and float64 sum, the injected
    permutations, and whether a generator draws the shuffles (its state is
    saved with the fit's, and a saved tree has it or not)."""
    desc = {
        "spec": dataclasses.asdict(spec),
        "hp": {k: float(v) for k, v in sorted(hp.items())},
        "data": {k: _summary(v) for k, v in sorted(data.items())},
        "vocab": _summary(vocab_emb),
        "init": _summary(init_embed),
        "generator": generator is not None,
    }
    if perms is not None:
        desc["perms"] = hashlib.sha256(b"".join(
            np.asarray(torch.as_tensor(p).cpu(), np.int64).tobytes() for p in perms)).hexdigest()
    return hashlib.sha256(json.dumps(desc, sort_keys=True).encode()).hexdigest()


def _opt_tree(o: OptState) -> dict:
    return {"count": o.count} if o.m is None else {"m": o.m, "v": o.v, "count": o.count}


def _state(carry: tuple, losses, generator) -> dict:
    """The saved tree: the fit's carry, its losses and the generator's state."""
    embed, dec, e_opt, d_opt = carry
    state = {"embed": embed, "dec": dec, "e_opt": _opt_tree(e_opt), "losses": losses}
    if d_opt is not None:
        state["d_opt"] = _opt_tree(d_opt)
    if generator is not None:
        state["generator"] = generator.get_state()
    return state


def _carry(state: dict) -> tuple:
    opt = lambda t: OptState(m=t.get("m"), v=t.get("v"), count=t["count"])
    d_opt = opt(state["d_opt"]) if "d_opt" in state else None
    return state["embed"], state["dec"], opt(state["e_opt"]), d_opt


def fit_latents_checkpointed(init_embed: torch.Tensor, decoder_params, data: Mapping,
                             vocab_emb: torch.Tensor, hp: Mapping, spec: LatentFitSpec,
                             checkpointer: Optional[Checkpointer] = None,
                             segment_epochs: int = 25, verbose: bool = False,
                             generator: torch.Generator | None = None,
                             perms: Sequence | None = None):
    """:func:`mmtpu_torch.train.latents.fit_latents` (without validation) in
    segments of ``segment_epochs`` epochs, saved to ``checkpointer`` after
    each; returns ``(embed, decoder_params, losses)``, the monolithic fit's
    result when run to the end."""
    if spec.valid_every:
        raise ValueError("validation-curve mode is monolithic-only")
    n_total = spec.n_epochs_max
    was_stacked = is_stacked(decoder_params)
    carry = init_fit_carry(init_embed, decoder_params, spec, hp)
    losses = torch.zeros(n_total, dtype=torch.float32, device=init_embed.device)
    start = 0
    fingerprint = None
    if checkpointer is not None:
        fingerprint = fit_fingerprint(init_embed, data, vocab_emb, hp, spec, perms, generator)
        manifest = checkpointer.manifest()
        if manifest is not None and manifest["extra"].get("fingerprint") == fingerprint:
            saved, step, _ = checkpointer.restore(_state(carry, losses, generator))
            carry, losses = _carry(saved), saved["losses"]
            if generator is not None:
                generator.set_state(saved["generator"])
            start = int(step)
            if verbose:
                print(f"[chunked] resuming at epoch {start}/{n_total}")
        elif manifest is not None and verbose:
            print("[chunked] checkpoint belongs to a different fit (fingerprint mismatch) — "
                  "starting at epoch 0")

    for s0 in range(start, n_total, segment_epochs):
        n_seg = min(segment_epochs, n_total - s0)
        carry, seg_losses = fit_latents_segment(carry, data, vocab_emb, hp, spec, s0, n_seg,
                                                generator, perms)
        losses[s0:s0 + n_seg] = seg_losses
        if checkpointer is not None:
            checkpointer.save(s0 + n_seg, _state(carry, losses, generator),
                              extra={"n_epochs_max": n_total, "fingerprint": fingerprint})
    return carry[0], finish_fit_decoder(carry[1], data, spec, was_stacked), losses
