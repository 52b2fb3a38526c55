"""Move parameters, optimizer state and data between mmtpu and the port.

mmtpu keeps parameters as nested dicts of arrays (the decoder's
``{"heads": {h: {w_mu, b_mu, w_log_sigma, b_log_sigma}}, "norm": {scale,
bias}}``, the sentiment MLP's ``{w1, b1, w2, b2}``), weights in ``(in, out)``
layout, and optimizer state as ``OptState(m, v, count)``.  The port keeps the
same structures with tensors, so conversion is leaf by leaf.  Leaves are
copied (``np.array``), never viewed: a JAX array on the CPU may alias a
numpy buffer, and a tensor trained in place would change it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mmtpu_torch.train.optim import OptState


def to_torch(tree, device=None):
    """numpy / JAX arrays (in dicts or an ``OptState``) -> tensors on ``device``.
    Integer arrays become int64 (PyTorch's index type) except an ``OptState``
    count, which stays int32 as in mmtpu."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # mmtpu's or the port's OptState
        count = torch.tensor(np.array(tree.count), dtype=torch.int32, device=device)
        return OptState(m=to_torch(tree.m, device), v=to_torch(tree.v, device), count=count)
    arr = np.array(tree)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.tensor(arr, dtype=torch.int64, device=device)
    return torch.tensor(arr, device=device)


def to_numpy(tree):
    """Tensors (in dicts or an ``OptState``) -> numpy arrays (copies)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return OptState(m=to_numpy(tree.m), v=to_numpy(tree.v), count=to_numpy(tree.count))
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree)
