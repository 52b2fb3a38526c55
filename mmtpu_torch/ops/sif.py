"""SIF sentence-embedding ops on tensors (port of :mod:`mmtpu.ops.sif`).

Arora et al.'s smooth-inverse-frequency cold start: per-token weights, the
weighted average of word vectors per sentence, and the removal of the first
principal component (``sif_functions.py:8-96``).  The reference takes the
component from sklearn's randomized ``TruncatedSVD`` on the *uncentered*
data; here, as in mmtpu, it is the exact top eigenvector of the ``(D, D)``
Gram matrix, which agrees up to sign.

The data pipeline keeps its numpy forms of the same functions
(:mod:`mmtpu_torch.data.pipeline`); these are the package API's.
"""

from __future__ import annotations

import torch


def seq_weights(token_ids: torch.Tensor, vocab_weights: torch.Tensor) -> torch.Tensor:
    """``(N, L)`` float32 weights: ``vocab_weights[id]`` where ``id >= 0``,
    else 0 (``sif_functions.py:8-15``; padding id 0 keeps its weight, as in
    the reference)."""
    valid = token_ids >= 0
    return (vocab_weights[torch.where(valid, token_ids, 0)] * valid).to(torch.float32)


def sif_weighted_average(word_embeddings: torch.Tensor, token_ids: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """``(N, D)``: ``w[i] . We[x[i]] / count_nonzero(w[i])``
    (``sif_functions.py:28-56``), the divisor clamped to at least 1 so that
    an all-padding row gives zeros."""
    gathered = word_embeddings[torch.where(token_ids >= 0, token_ids, 0)]  # (N, L, D)
    summed = torch.einsum("nl,nld->nd", weights, gathered)
    counts = torch.clamp_min(torch.sum(weights != 0, dim=-1), 1)
    return summed / counts[:, None].to(summed.dtype)


def first_pc(x: torch.Tensor) -> torch.Tensor:
    """``(D,)`` unit first principal direction of the uncentered ``(N, D)``
    data: the top eigenvector of ``x.T @ x``.  Its sign is arbitrary."""
    _, vecs = torch.linalg.eigh(x.T @ x)  # eigenvalues ascending
    pc = vecs[:, -1]
    return pc / torch.linalg.vector_norm(pc)


def remove_pc(x: torch.Tensor, pc: torch.Tensor | None = None) -> torch.Tensor:
    """``x - (x @ pc) pc`` (``sif_functions.py:69-81``, ``npc=1``)."""
    if pc is None:
        pc = first_pc(x)
    return x - (x @ pc)[:, None] * pc[None, :]


def sif_embedding(word_embeddings: torch.Tensor, token_ids: torch.Tensor,
                  weights: torch.Tensor, rmpc: int = 1) -> torch.Tensor:
    """The weighted average, then first-PC removal (``sif_functions.py:84-96``;
    ``rmpc`` 0 or 1)."""
    emb = sif_weighted_average(word_embeddings, token_ids, weights)
    if rmpc > 0:
        if rmpc != 1:
            raise NotImplementedError("only rmpc in {0, 1} is supported")
        emb = remove_pc(emb)
    return emb
