"""Sinusoidal positional channels for audio/visual features (port of
:mod:`mmtpu.ops.posenc`; reference ``utils.py:130-153``).

The reference's loop indexes the *batch* axis where it means the channel
axis (``utils.py:146-148``): only samples ``0 .. P-1`` get sin/cos codes and
every other sample gets raw integer positions.  ``bug_parity=True`` does
exactly that; the default is the intended encoding.

The data pipeline keeps its numpy forms (:mod:`mmtpu_torch.data.pipeline`);
these are the package API's.
"""

from __future__ import annotations

import torch


def positional_encoding(seq_len: int, pos_embed_dim: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """``(seq_len, P)``: ``PE(pos, 2i) = sin(pos / 10000^(2i/P))`` and
    ``PE(pos, 2i+1) = cos(pos / 10000^(2i/P))``."""
    pos = torch.arange(seq_len, dtype=dtype, device=device)[:, None]
    chan = torch.arange(pos_embed_dim, device=device)
    even = (chan // 2) * 2  # both channels of a pair use exponent 2i
    inv_freq = torch.pow(10000.0, -(even.to(dtype) / pos_embed_dim))
    angles = pos * inv_freq[None, :]
    return torch.where(chan % 2 == 0, torch.sin(angles), torch.cos(angles))


def add_positional_embeddings(data: torch.Tensor, pos_embed_dim: int,
                              bug_parity: bool = False) -> torch.Tensor:
    """``(N, L, F)`` features with ``pos_embed_dim`` positional channels
    appended, ``(N, L, F + P)``; ``bug_parity`` reproduces the reference's
    batch-axis indexing."""
    n, seq_len = data.shape[0], data.shape[1]
    if not bug_parity:
        pe = positional_encoding(seq_len, pos_embed_dim, data.dtype, data.device)
        return torch.cat([data, pe[None].expand(n, -1, -1)], dim=-1)
    # raw positions tiled to (N, L, P); for i < P // 2, SAMPLE rows 2i and
    # 2i + 1 become sin / cos of the whole (L, P) slab at 10000^(2i/P)
    idxes = torch.arange(seq_len, dtype=data.dtype, device=data.device)[None, :, None]
    out = idxes.expand(n, seq_len, pos_embed_dim).clone()
    for i in range(pos_embed_dim // 2):
        if 2 * i >= n:
            break
        scale = 10000.0 ** (2 * i / pos_embed_dim)
        out[2 * i] = torch.sin(idxes[0] / scale)
        if 2 * i + 1 < n:
            out[2 * i + 1] = torch.cos(idxes[0] / scale)
    return torch.cat([data, out], dim=-1)
