"""Arora-style word-likelihood ops (angular and dot-product mixtures).

Port of :mod:`mmtpu.ops.wordprob`.  The model is
``p(w | c) = alpha(c) * p(w) + (1 - alpha(c)) * score(w, c) / Z(c)`` where the
partition ``Z`` sums over the whole vocabulary.  :func:`angular_partition`
here is the plain PyTorch version of ``Z``; by default
:func:`word_logprob_angular` computes ``Z`` through
:func:`mmtpu_torch.kernels.angular.angular_partition`, which launches the
hand-written CUDA kernel for a CUDA tensor and uses this plain version for a
CPU tensor.

Under the sweep's config axis the latents are ``(K, B, D)`` against the one
shared ``(V, D)`` vocabulary: their rows are flattened to ``(K*B, D)``, so
one call of ``Z`` (one K1 forward and one backward) serves all K configs.
The rows are independent, so no value crosses configs.

The per-token term reads each token's word vector.  The fits pass the
tokens' ids (``text_ids``) in place of the gathered ``(..., B, L, D)``
vectors: :func:`token_dots` computes the ``(..., B, L)`` dots and keeps
nothing ``(B, L, D)``-shaped for the backward (mmtpu leaves this to XLA's
fusions; gathered whole, a K = 32 sweep chunk's training step at POM's
1357-token rows held 2048 x 1357 x 300 floats, 3.3 GB).  For a CUDA tensor
it launches the hand-written kernels of
:mod:`mmtpu_torch.kernels.token_dots`, which read each row by id from the
vocabulary; for a CPU tensor it runs the plain twin
(:func:`token_dots_plain`), which gathers a block of tokens at a time.
"""

from __future__ import annotations

import math

import torch

_PI = math.pi
# torch.nn.CosineSimilarity default denominator clamp (reference losses.py:74).
_COS_EPS = 1e-8
# Margin keeping arccos' derivative finite at |cos| == 1 (mmtpu.ops.wordprob).
_ACOS_CLIP = 1e-7


def _safe_acos(cos: torch.Tensor) -> torch.Tensor:
    return torch.acos(torch.clamp(cos, -1.0 + _ACOS_CLIP, 1.0 - _ACOS_CLIP))


def angular_partition(latents: torch.Tensor, vocab_embeddings: torch.Tensor) -> torch.Tensor:
    """Angular partition ``Z_s = sum_v (1 - acos(cos(c, v)) / pi)``, ``(B, 1)``.

    Cosine similarity uses torch's denominator clamp ``max(|c||v|, 1e-8)``.
    """
    lat_norm = torch.linalg.vector_norm(latents, dim=-1, keepdim=True)  # (B, 1)
    voc_norm = torch.linalg.vector_norm(vocab_embeddings, dim=-1)  # (V,)
    dots = latents @ vocab_embeddings.T
    cos = dots / torch.clamp_min(lat_norm * voc_norm[None, :], _COS_EPS)
    return torch.sum(1.0 - _safe_acos(cos) / _PI, dim=-1, keepdim=True)


def _token_mask(mask: torch.Tensor, word_weights: torch.Tensor) -> torch.Tensor:
    """The ``(..., B, L)`` token mask; a ``(..., B, L, 1)`` one is squeezed."""
    return mask[..., 0] if mask.ndim > word_weights.ndim else mask


def _partition(partition_fn, latents: torch.Tensor, vocab_embeddings: torch.Tensor):
    """``Z`` as ``(..., B, 1)``; leading config rows go through one call."""
    if latents.ndim == 2:
        return partition_fn(latents, vocab_embeddings)
    z = partition_fn(latents.reshape(-1, latents.shape[-1]), vocab_embeddings)
    return z.reshape(*latents.shape[:-1], 1)


# the most elements of gathered word vectors (a block of tokens of every row)
# that the plain twin of token_dots holds at once: 512 MiB of float32
TOKEN_BLOCK_ELEMS = 1 << 27


def token_block(rows: int, depth: int) -> int:
    """Tokens per block of :func:`token_dots_plain` for ``rows`` rows of depth ``depth``."""
    return max(1, TOKEN_BLOCK_ELEMS // max(1, rows * depth))


def token_dots_plain(latents, vocab, ids) -> torch.Tensor:
    """``(R, M, L)`` dots of the ``(R, M, D)`` latents with the word vectors
    ``vocab[ids]`` of row ``r``'s ``L`` tokens (``M`` latents share each
    row's tokens), a gathered block of at most :data:`TOKEN_BLOCK_ELEMS`
    elements at a time: the plain twin of the token kernel's forward."""
    rows, n_tok = ids.shape
    step = token_block(rows, latents.shape[-1])
    out = latents.new_empty(rows, latents.shape[1], n_tok)
    for s in range(0, n_tok, step):
        out[:, :, s:s + step] = torch.bmm(latents, vocab[ids[:, s:s + step]].transpose(1, 2))
    return out


def token_dots_plain_bwd(g, vocab, ids) -> torch.Tensor:
    """The ``(R, M, D)`` latent gradient of :func:`token_dots_plain` for the
    cotangent ``g`` ``(R, M, L)``: the blocks added in a fixed order."""
    rows, n_tok = ids.shape
    step = token_block(rows, vocab.shape[-1])
    g_lat = g.new_zeros(rows, g.shape[1], vocab.shape[-1])
    for s in range(0, n_tok, step):
        g_lat.baddbmm_(g[:, :, s:s + step], vocab[ids[:, s:s + step]])
    return g_lat


class _TokenDots(torch.autograd.Function):
    """``(R, M, L)`` dots of the ``(R, M, D)`` latents with the word vectors
    ``vocab[ids]`` (:func:`token_dots_plain`), through
    :mod:`mmtpu_torch.kernels.token_dots`; the gradient reaches the latents
    only (the vocabulary is data) and needs only the vocabulary and the ids.
    Every sum has a fixed order, so two calls are bit for bit equal."""

    @staticmethod
    def forward(ctx, latents, vocab, ids):
        from mmtpu_torch.kernels.token_dots import token_dots_fwd

        ctx.save_for_backward(vocab, ids)
        return token_dots_fwd(latents, vocab, ids)

    @staticmethod
    def backward(ctx, g):
        from mmtpu_torch.kernels.token_dots import token_dots_bwd

        vocab, ids = ctx.saved_tensors
        return token_dots_bwd(g, vocab, ids), None, None


def token_dots(latents: torch.Tensor, vocab_embeddings: torch.Tensor,
               text_ids: torch.Tensor) -> torch.Tensor:
    """``(..., B, L)`` dots ``vocab[text_ids[..., b, l]] . latents[..., b, :]``
    of ``(..., B, D)`` latents (leading axes broadcast), without a
    ``(..., B, L, D)`` tensor: the token kernels on the card, at most
    :data:`TOKEN_BLOCK_ELEMS` gathered elements at a time on the CPU, forward
    and backward.  ``(B, L)`` ids under leading latent axes (the sweep's
    configs in an unshuffled inference fit) are read once for all of them."""
    if vocab_embeddings.requires_grad:
        raise ValueError("token_dots differentiates the latents only; the vocabulary "
                         "must not require grad")
    d, n_tok = latents.shape[-1], text_ids.shape[-1]
    if text_ids.ndim == 2 and latents.ndim > 2:  # (B, M, D): the configs share each row
        lat = latents.reshape(-1, *latents.shape[-2:]).transpose(0, 1)
        dots = _TokenDots.apply(lat, vocab_embeddings, text_ids)
        return dots.transpose(0, 1).reshape(*latents.shape[:-1], n_tok)
    lead = torch.broadcast_shapes(latents.shape[:-1], text_ids.shape[:-1])
    lat = latents.expand(*lead, d).reshape(-1, 1, d)
    ids = text_ids.expand(*lead, n_tok).reshape(-1, n_tok)
    return _TokenDots.apply(lat, vocab_embeddings, ids).reshape(*lead, n_tok)


def _dots(latents, vocab_embeddings, sent_embeddings, text_ids) -> torch.Tensor:
    """Each token's ``(..., B, L)`` dot with its row's latent: from the
    gathered ``sent_embeddings``, or from ``text_ids`` into the vocabulary
    (:func:`token_dots`)."""
    if (sent_embeddings is None) == (text_ids is None):
        raise ValueError("pass exactly one of sent_embeddings and text_ids")
    if text_ids is None:
        return torch.einsum("...ld,...d->...l", sent_embeddings, latents)
    return token_dots(latents, vocab_embeddings, text_ids)


def _sentence_angular_score(latents, vocab_embeddings, sent_embeddings,
                            text_ids) -> torch.Tensor:
    """``1 - acos(cos(sent_word, latent)) / pi`` per token (losses.py:84)."""
    lat_norm = torch.linalg.vector_norm(latents, dim=-1)[..., None]  # (B, 1)
    if text_ids is None:
        sent_norm = torch.linalg.vector_norm(sent_embeddings, dim=-1)  # (B, L)
    else:
        sent_norm = torch.linalg.vector_norm(vocab_embeddings, dim=-1)[text_ids]
    dots = _dots(latents, vocab_embeddings, sent_embeddings, text_ids)
    cos = dots / torch.clamp_min(sent_norm * lat_norm, _COS_EPS)
    return 1.0 - _safe_acos(cos) / _PI


def word_logprob_angular(
    latents: torch.Tensor,
    vocab_embeddings: torch.Tensor,
    word_weights: torch.Tensor,
    sent_embeddings: torch.Tensor | None,
    mask: torch.Tensor,
    a: float = 1e-3,
    partition_fn=None,
    *,
    text_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Angular-distance word log-likelihood per utterance, ``(B,)`` (``(K,
    B)`` for ``(K, B, D)`` latents).

    As :func:`mmtpu.ops.wordprob.word_logprob_angular`; ``partition_fn``
    overrides the computation of ``Z_s`` (default: the kernel wrapper
    :func:`mmtpu_torch.kernels.angular.angular_partition`).  The tokens'
    word vectors come as ``sent_embeddings`` ``(B, L, D)``, or as their ids
    ``text_ids`` ``(B, L)`` (``sent_embeddings`` None; :func:`token_dots`).
    """
    if partition_fn is None:
        from mmtpu_torch.kernels.angular import angular_partition as partition_fn
    mask = _token_mask(mask, word_weights)
    z = _partition(partition_fn, latents, vocab_embeddings)  # (B, 1)
    alpha = 1.0 / (z * a + 1.0)
    unigram = alpha * word_weights
    score = _sentence_angular_score(latents, vocab_embeddings, sent_embeddings, text_ids)
    context = (1.0 - alpha) * score / z
    log_probs = torch.log(unigram + context) * mask
    return torch.sum(log_probs, dim=-1)


def word_logprob_dot_prod(
    latents: torch.Tensor,
    vocab_embeddings: torch.Tensor,
    word_weights: torch.Tensor,
    sent_embeddings: torch.Tensor | None,
    mask: torch.Tensor,
    a: float = 1e-3,
    partition_fn=None,
    *,
    text_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dot-product (softmax-form) word log-likelihood per utterance, ``(B,)``
    (:func:`mmtpu.ops.wordprob.word_logprob_dot_prod`); ``partition_fn``
    overrides the computation of ``Z = sum_v exp(c . v)``; the tokens as
    :func:`word_logprob_angular`'s."""
    mask = _token_mask(mask, word_weights)
    if partition_fn is None:
        z = torch.sum(torch.exp(latents @ vocab_embeddings.T), dim=-1, keepdim=True)  # (B, 1)
    else:
        z = partition_fn(latents, vocab_embeddings)
    alpha = 1.0 / (z * a + 1.0)
    unigram = alpha * word_weights
    dot = _dots(latents, vocab_embeddings, sent_embeddings, text_ids)
    context = (1.0 - alpha) * torch.exp(dot) / z
    log_probs = torch.log(unigram + context) * mask
    return torch.sum(log_probs, dim=-1)
