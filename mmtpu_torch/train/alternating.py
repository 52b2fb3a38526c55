"""Legacy alternating driver: closed-form estimation and decoder updates
(port of :mod:`mmtpu.train.alternating`).

The reference's legacy ``sif2.py`` pipeline (``optimize_embeddings``,
``sif2.py:339-462``), as mmtpu implements its evident intent: each epoch,
(1) every latent is re-estimated in closed form from the current bimodal
decoder, then (2) minibatch SGD steps the decoder's parameters against the
old-style joint log-likelihood (``losses.py:153-214``: the word term with
weight w, the audio and visual Gaussians with (1-w)/2 each).

The latents of an epoch are constants of its steps, as in mmtpu, which
computes them outside ``value_and_grad``: here under ``torch.no_grad()``, so
no gradient reaches the decoder through the closed form.  The word term then
depends on no parameter; on a CUDA tensor its partition ``Z`` runs kernel
K1's forward once per step, and K1's backward never.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from mmtpu_torch.graphs import Graphs, fit_graphs, fit_result
from mmtpu_torch.models.legacy import apply_audio_visual_generator
from mmtpu_torch.ops.closed_form import closed_form_latents
from mmtpu_torch.ops.gaussian import gaussian_logpdf_masked
from mmtpu_torch.ops.wordprob import word_logprob_angular, word_logprob_dot_prod
from mmtpu_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AlternatingFitSpec:
    n_epochs: int = 100  # sif2.py:405
    batch_size: int = 32  # sif2.py:479
    word_metric: str = "angular"
    a: float = 1e-3


def _legacy_heads(params) -> dict:
    """Bimodal params in the closed form's head layout ((in, out) weights)."""
    return {mod: {"w_mu": params[mod]["mu"]["w"], "b_mu": params[mod]["mu"]["b"],
                  "w_log_sigma": params[mod]["log_sigma"]["w"],
                  "b_log_sigma": params[mod]["log_sigma"]["b"]}
            for mod in ("audio", "visual")}


def joint_log_prob_old(params, latents, b: Mapping[str, torch.Tensor], vocab_emb,
                       word_loss_weight, spec: AlternatingFitSpec) -> torch.Tensor:
    """The old-style two-modality objective per utterance, ``(B,)``
    (``losses.py:153-214``)."""
    (a_mu, a_sig), (v_mu, v_sig) = apply_audio_visual_generator(params, latents)
    word_fn = word_logprob_angular if spec.word_metric == "angular" else word_logprob_dot_prod
    sent = b["text"] if "text" in b else vocab_emb[b["text_ids"]]
    word_lp = word_fn(latents, vocab_emb, b["text_weights"], sent, b["text_mask"], a=spec.a)
    audio_lp = gaussian_logpdf_masked(a_mu, a_sig, b["audio"], b["audio_mask"])
    visual_lp = gaussian_logpdf_masked(v_mu, v_sig, b["visual"], b["visual_mask"])
    half = (1.0 - word_loss_weight) / 2.0  # losses.py:207-210
    return half * audio_lp + half * visual_lp + word_loss_weight * word_lp


def estimate_latents(params, data, sentence_weights, sent_embeddings) -> torch.Tensor:
    """The closed-form estimate through the bimodal decoder (``sif2.py:164-208``
    on the {audio, visual} heads; each row L2-normalised)."""
    return closed_form_latents({"audio": data["audio"], "visual": data["visual"]},
                               _legacy_heads(params), sentence_weights, sent_embeddings)


def fit_alternating(params, data: Mapping[str, torch.Tensor], vocab_emb: torch.Tensor, lr,
                    word_loss_weight, spec: AlternatingFitSpec = AlternatingFitSpec(),
                    graphs: bool | Graphs = True) -> tuple:
    """Alternate closed-form latent estimation with decoder SGD.

    ``data`` is the latent fit's dict convention (``text_ids`` or gathered
    ``text``, ``text_weights``, ``text_mask``, ``audio``, ``audio_mask``,
    ``visual``, ``visual_mask``) on the device of ``params``.  Each epoch's
    steps take fixed batches of ``spec.batch_size`` rows in order, the last
    padded with row 0 at weight 0; a step's loss is the mean over its real
    rows, an epoch's the sum of its steps'.  ``graphs`` as
    :func:`mmtpu_torch.train.latents.fit_latents`'s: on the card each epoch
    of a fit of :data:`mmtpu_torch.graphs.MIN_EPOCHS` epochs or more (its
    closed form and its steps) is one CUDA graph replay, and a caller's
    store is shared with the fits run through it.

    Returns ``(final_latents (N, D), params, epoch_losses (n_epochs,))``.
    """
    data = dict(data)
    if "text" not in data:  # the ids convention of prepare_device_data
        data["text"] = vocab_emb[data["text_ids"]]
    n = data["audio"].shape[0]
    dev = data["audio"].device
    bsz = spec.batch_size
    n_batches = -(-n // bsz)
    pad = n_batches * bsz - n
    idx = torch.cat([torch.arange(n, device=dev), torch.zeros(pad, dtype=torch.long, device=dev)])
    idx = idx.reshape(n_batches, bsz)
    valid = torch.cat([torch.ones(n, device=dev), torch.zeros(pad, device=dev)])
    valid = valid.reshape(n_batches, bsz)

    # every tensor the body reads is an argument (fits that share a store
    # share its graph); it closes over the spec and the shapes only
    def body(params, data, vocab_emb, idx, valid, lr, word_loss_weight):
        with torch.no_grad():  # the epoch's latents are constants of its steps
            latents = estimate_latents(params, data, data["text_weights"], data["text"])
        batch_losses = []
        for j, rv in zip(idx, valid):
            b = {k: v[j] for k, v in data.items()}
            params = tree_map(lambda t: t.detach().requires_grad_(), params)
            lp = joint_log_prob_old(params, latents[j], b, vocab_emb, word_loss_weight, spec)
            loss = torch.sum(-lp * rv) / torch.clamp_min(torch.sum(rv), 1.0)
            leaves = tree_leaves(params)
            grads = torch.autograd.grad(loss, leaves)
            params = tree_unflatten(params, [p.detach() - lr * g for p, g in zip(leaves, grads)])
            batch_losses.append(loss.detach())
        return params, torch.sum(torch.stack(batch_losses))

    # each epoch's closed form and steps: a graph replay where graphs says so
    run = fit_graphs(graphs, dev, None, spec.n_epochs)
    params = tree_map(torch.Tensor.detach, params)
    epoch_losses = []
    for _ in range(spec.n_epochs):
        params, loss = run(("alternating_epoch", spec), body, params, data, vocab_emb, idx,
                           valid, lr, word_loss_weight, carry=True)
        epoch_losses.append(loss)
    params = fit_result(run, graphs, params)
    with torch.no_grad():
        final = estimate_latents(params, data, data["text_weights"], data["text"])
    return final, params, torch.stack(epoch_losses)
