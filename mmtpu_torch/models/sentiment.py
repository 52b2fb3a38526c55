"""Downstream sentiment/trait MLP (port of :mod:`mmtpu.models.sentiment`):
``Linear(D->H) -> ReLU -> Linear(H->n_out)``, squeezed when ``n_out == 1``."""

from __future__ import annotations

from typing import Mapping

import torch

from mmtpu_torch.models.init import torch_linear_init


def init_sentiment(gen: torch.Generator, embed_dim: int, hidden_dim: int, n_out: int) -> dict:
    l1 = torch_linear_init(gen, embed_dim, hidden_dim)
    l2 = torch_linear_init(gen, hidden_dim, n_out)
    return {"w1": l1["w"], "b1": l1["b"], "w2": l2["w"], "b2": l2["b"]}


def apply_sentiment(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    out = h @ params["w2"] + params["b2"]
    if out.shape[-1] == 1:
        out = out[..., 0]
    return out
