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


def _sentence_angular_score(latents: torch.Tensor, sent_embeddings: torch.Tensor) -> torch.Tensor:
    """``1 - acos(cos(sent_word, latent)) / pi`` per token (losses.py:84)."""
    lat_norm = torch.linalg.vector_norm(latents, dim=-1)[..., None]  # (B, 1)
    sent_norm = torch.linalg.vector_norm(sent_embeddings, dim=-1)  # (B, L)
    dots = torch.einsum("...ld,...d->...l", sent_embeddings, latents)
    cos = dots / torch.clamp_min(sent_norm * lat_norm, _COS_EPS)
    return 1.0 - _safe_acos(cos) / _PI


def word_logprob_angular(
    latents: torch.Tensor,
    vocab_embeddings: torch.Tensor,
    word_weights: torch.Tensor,
    sent_embeddings: torch.Tensor,
    mask: torch.Tensor,
    a: float = 1e-3,
    partition_fn=None,
) -> torch.Tensor:
    """Angular-distance word log-likelihood per utterance, ``(B,)`` (``(K,
    B)`` for ``(K, B, D)`` latents).

    As :func:`mmtpu.ops.wordprob.word_logprob_angular`; ``partition_fn``
    overrides the computation of ``Z_s`` (default: the kernel wrapper
    :func:`mmtpu_torch.kernels.angular.angular_partition`).
    """
    if partition_fn is None:
        from mmtpu_torch.kernels.angular import angular_partition as partition_fn
    mask = _token_mask(mask, word_weights)
    z = _partition(partition_fn, latents, vocab_embeddings)  # (B, 1)
    alpha = 1.0 / (z * a + 1.0)
    unigram = alpha * word_weights
    score = _sentence_angular_score(latents, sent_embeddings)
    context = (1.0 - alpha) * score / z
    log_probs = torch.log(unigram + context) * mask
    return torch.sum(log_probs, dim=-1)


def word_logprob_dot_prod(
    latents: torch.Tensor,
    vocab_embeddings: torch.Tensor,
    word_weights: torch.Tensor,
    sent_embeddings: torch.Tensor,
    mask: torch.Tensor,
    a: float = 1e-3,
    partition_fn=None,
) -> torch.Tensor:
    """Dot-product (softmax-form) word log-likelihood per utterance, ``(B,)``
    (:func:`mmtpu.ops.wordprob.word_logprob_dot_prod`); ``partition_fn``
    overrides the computation of ``Z = sum_v exp(c . v)``."""
    mask = _token_mask(mask, word_weights)
    if partition_fn is None:
        z = torch.sum(torch.exp(latents @ vocab_embeddings.T), dim=-1, keepdim=True)  # (B, 1)
    else:
        z = partition_fn(latents, vocab_embeddings)
    alpha = 1.0 / (z * a + 1.0)
    unigram = alpha * word_weights
    dot = torch.einsum("...ld,...d->...l", sent_embeddings, latents)
    context = (1.0 - alpha) * torch.exp(dot) / z
    log_probs = torch.log(unigram + context) * mask
    return torch.sum(log_probs, dim=-1)
