"""Downstream sentiment/trait MLP (port of :mod:`mmtpu.models.sentiment`):
``Linear(D->H) -> ReLU -> Linear(H->n_out)``, squeezed when ``n_out == 1``.

``hidden_pad`` lets the sweep's configs with different hidden sizes share
one shape: the extra hidden units are zero-initialized, and a zero-initialized
ReLU unit is dead under SGD and Adam alike (its input weights get zero
gradient because its output weight is 0, and its output weight gets zero
gradient because its activation is 0), so the padded model trains exactly as
the unpadded one.  With a leading config axis on the parameters (``(K, D,
H)`` weights, ``(K, H)`` biases) the MLP applies per config to ``(K, B, D)``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from mmtpu_torch.models.init import torch_linear_init
from mmtpu_torch.tree import rowwise


def init_sentiment(gen: torch.Generator, embed_dim: int, hidden_dim: int, n_out: int,
                   hidden_pad: int | None = None) -> dict:
    """MLP parameters by the torch-Linear init law, zero-padded to
    ``hidden_pad`` hidden units when that is larger."""
    l1 = torch_linear_init(gen, embed_dim, hidden_dim)
    l2 = torch_linear_init(gen, hidden_dim, n_out)
    p = {"w1": l1["w"], "b1": l1["b"], "w2": l2["w"], "b2": l2["b"]}
    if hidden_pad is not None and hidden_pad > hidden_dim:
        pad = hidden_pad - hidden_dim
        p["w1"] = torch.nn.functional.pad(p["w1"], (0, pad))
        p["b1"] = torch.nn.functional.pad(p["b1"], (0, pad))
        p["w2"] = torch.nn.functional.pad(p["w2"], (0, 0, 0, pad))
    return p


def apply_sentiment(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + rowwise(params["b1"]))
    out = h @ params["w2"] + rowwise(params["b2"])
    if out.shape[-1] == 1:
        out = out[..., 0]
    return out
