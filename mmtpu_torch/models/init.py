"""Parameter initializer with torch-``nn.Linear`` distributional parity
(port of :mod:`mmtpu.models.init`)."""

from __future__ import annotations

import math

import torch


def torch_linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                      dtype=torch.float32) -> dict:
    """Weight ``(in_dim, out_dim)`` + bias ``(out_dim,)``, each i.i.d. uniform
    on ``(-1/sqrt(in_dim), 1/sqrt(in_dim))``, drawn from ``gen`` on the CPU
    (callers move them to their device).

    Weights keep mmtpu's ``(in, out)`` layout, so the forward is ``x @ w + b``.
    """
    bound = 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), dtype=dtype).uniform_(-bound, bound, generator=gen)
    b = torch.empty((out_dim,), dtype=dtype).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}
