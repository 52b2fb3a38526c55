"""Embedding analysis: the nearest vocabulary words of each utterance
embedding (port of :mod:`mmtpu.analysis`; the reference imports
``get_closest_words`` from a module its repository lacks,
``simplesif.py:30``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def closest_word_ids(embeddings, word_embeddings, k: int = 5) -> np.ndarray:
    """``(N, k)`` vocabulary ids by cosine similarity, most similar first
    (each row's norm clamped at 1e-8).  Tensors are used on their device;
    numpy arrays on the CPU."""
    e = torch.as_tensor(embeddings)
    w = torch.as_tensor(word_embeddings, device=e.device)
    e = e / torch.clamp_min(torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-8)
    w = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1, keepdim=True), 1e-8)
    _, idx = torch.topk(e @ w.T, k, dim=-1)
    return idx.cpu().numpy()


def get_closest_words(embeddings, word_embeddings, word2ix: Dict[str, int],
                      k: int = 5) -> List[List[str]]:
    """The k closest vocabulary words of each utterance (the diagnostic the
    reference calls at ``simplesif.py:437-438``)."""
    ix2word: Dict[int, str] = {}
    for word, ix in word2ix.items():
        ix2word.setdefault(int(ix), word)
    ids = closest_word_ids(embeddings, word_embeddings, k)
    return [[ix2word.get(int(i), f"<{int(i)}>") for i in row] for row in ids]
