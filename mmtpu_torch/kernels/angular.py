"""Kernel K1: the angular word-likelihood partition and its latent gradient.

Replaces the Pallas TPU kernels of :mod:`mmtpu.kernels.angular`
(``_fwd_kernel`` / ``_bwd_kernel`` and their ``custom_vjp``) with CUDA C++
kernels for Hopper (``mmtpu_torch/csrc/angular.cu`` for the forward,
``mmtpu_torch/csrc/angular_bwd.cu`` for the backward, both on the tiles of
``angular_tile.cuh``; built by :mod:`mmtpu_torch.kernels.build`).  The
sources' headers say how the kernels are laid out and what bounds them on an
H100.  Their grids come from :func:`fwd_grid` / :func:`bwd_grid`, fed the
resident blocks per SM from the library's occupancy query at the call's
depth.

- :func:`angular_fwd` / :func:`angular_bwd` are the wrappers.  For a CUDA
  tensor each launches its kernel (and adds one to :data:`LAUNCHES`) or
  raises; for a CPU tensor each computes its plain PyTorch version.  Nothing
  falls back from CUDA to the plain version.
- :class:`AngularPartitionFn` is the autograd function: its forward saves
  ``(latents, vocab, vnorm)`` and its backward recomputes the cosines (no
  ``(B, V)`` residual).  The vocabulary is a constant: it gets no gradient,
  as in the TPU kernel.
- :func:`angular_partition_ref` (the plain
  :func:`mmtpu_torch.ops.wordprob.angular_partition`) and
  :func:`angular_partition_bwd_ref` (the explicit gradient formula) are the
  plain versions that the tests and ``chip_smoke.py`` hold the kernels to.

``MIN_PALLAS_ROWS`` of the TPU module was measured on a TPU and is not carried
over: the kernel serves every row count.
"""

from __future__ import annotations

import math

import torch

from mmtpu_torch.graphs import launch_counter
from mmtpu_torch.kernels.build import Tickets, blocks_per_sm, sm_count
from mmtpu_torch.ops.wordprob import _ACOS_CLIP, _COS_EPS
from mmtpu_torch.ops.wordprob import angular_partition as angular_partition_ref

_PI = math.pi

# kernel launches by wrapper; read (and reset) by chip_smoke.py, and added to
# on each CUDA graph replay (mmtpu_torch/graphs.py)
LAUNCHES = launch_counter({"fwd": 0, "bwd": 0})


def angular_partition_bwd_ref(latents, vocab, vnorm, g):
    """Plain latent cotangent of ``Z`` by the TPU backward's formula:

    ``dl = sum_v g w v / max(|l||v|, 1e-8) - (sum_v g w cos) l / max(|l|^2, 1e-8)``
    with ``w = (1/pi) / sqrt(max(1 - cos^2, 1e-12))``.
    """
    lnorm_sq = torch.sum(latents * latents, dim=-1, keepdim=True)
    lnorm = torch.sqrt(lnorm_sq)
    dots = latents @ vocab.T
    denom = torch.clamp_min(lnorm * vnorm[None, :], _COS_EPS)
    cos = torch.clamp(dots / denom, -1.0 + _ACOS_CLIP, 1.0 - _ACOS_CLIP)
    w = (1.0 / _PI) / torch.sqrt(torch.clamp_min(1.0 - cos * cos, 1e-12))
    wg = w * g
    t1 = (wg / denom) @ vocab
    s = torch.sum(wg * cos, dim=-1, keepdim=True)
    return t1 - s * latents / torch.clamp_min(lnorm_sq, _COS_EPS)


def _check_cuda(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"angular kernel: tensors on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"angular kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("angular kernel takes contiguous tensors")


def _check_shapes(latents, vocab, vnorm) -> None:
    if latents.ndim != 2 or vocab.ndim != 2:
        raise ValueError(f"angular kernel takes (B, D) latents and (V, D) vocab, "
                         f"got {tuple(latents.shape)} and {tuple(vocab.shape)}")
    if latents.shape[1] != vocab.shape[1]:
        raise ValueError(f"latent depth {latents.shape[1]} != vocab depth "
                         f"{vocab.shape[1]}")
    if vnorm.shape != (vocab.shape[0],):
        raise ValueError(f"vnorm shape {tuple(vnorm.shape)} != ({vocab.shape[0]},)")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"angular kernel: unsupported device {t.device}")


def fwd_grid(b: int, v: int, row_tile: int, vocab_tile: int, sm_count: int,
             blocks_per_sm: int, depth_slices: int = 1) -> tuple:
    """``(n_chunks, tiles_per_chunk)`` of the forward's grid, one block per
    (row tile, depth slice, vocabulary chunk of whole sub-tiles): as many
    chunks as one wave of the card's ``blocks_per_sm * sm_count`` slots
    holds, and no more, so each block loads its latent tile and writes its
    partials once for as many sub-tiles as it can.  Where the row tiles
    (times the depth slices) alone fill the slots, one chunk.  A chunk takes
    at least two sub-tiles wherever the blocks would still cover every SM.
    The forward has one depth slice.  A function of its arguments only, so
    runs reproduce."""
    n_rt = -(-b // row_tile) * depth_slices
    n_sub = -(-v // vocab_tile)
    tpc = -(-n_sub // max(1, blocks_per_sm * sm_count // n_rt))
    if tpc == 1 and n_rt * -(-n_sub // 2) >= sm_count:
        tpc = 2
    tpc = min(tpc, n_sub)
    return -(-n_sub // tpc), tpc


# The backward's grid: the same rule over (row tile, depth slice) pairs
# (``depth_slices`` from the library, one up to D = 512), which gave the
# fastest of the measured chunk sizes for both kernels at 64 and 512 rows
# (scripts/torch_k1_grid.py).
bwd_grid = fwd_grid


# the forward kernel's tickets, one per row tile
_TICKETS = Tickets()


def angular_fwd(latents: torch.Tensor, vocab: torch.Tensor, vnorm: torch.Tensor) -> torch.Tensor:
    """``Z`` as ``(B, 1)``; ``vnorm`` is the ``(V,)`` vocab row norms."""
    _check_shapes(latents, vocab, vnorm)
    if _on_cpu(latents):
        return angular_partition_ref(latents, vocab)
    from mmtpu_torch.kernels.build import check_launch, load

    _check_cuda(latents, vocab, vnorm)
    lib = load()
    b, d = latents.shape
    v = vocab.shape[0]
    out = torch.empty((b, 1), dtype=torch.float32, device=latents.device)
    if b == 0:
        return out
    dev = latents.device
    row_tile = lib.angular_row_tile()
    chunks, tpc = fwd_grid(b, v, row_tile, lib.angular_vocab_tile(), sm_count(dev.index),
                           blocks_per_sm("angular_fwd_blocks_per_sm", dev.index, d))
    partial = torch.empty((chunks, b), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _TICKETS(dev, stream, -(-b // row_tile))
        err = lib.angular_fwd(latents.data_ptr(), vocab.data_ptr(), vnorm.data_ptr(),
                              partial.data_ptr(), tickets.data_ptr(), out.data_ptr(), b, v, d,
                              chunks, tpc, stream)
    check_launch(lib, "angular_fwd", err)
    LAUNCHES["fwd"] += 1
    return out


def angular_bwd(latents: torch.Tensor, vocab: torch.Tensor, vnorm: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """Latent cotangent ``(B, D)`` for the upstream cotangent ``g`` ``(B, 1)``."""
    _check_shapes(latents, vocab, vnorm)
    if g.shape != (latents.shape[0], 1):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != ({latents.shape[0]}, 1)")
    if _on_cpu(latents):
        return angular_partition_bwd_ref(latents, vocab, vnorm, g)
    from mmtpu_torch.kernels.build import check_launch, load

    _check_cuda(latents, vocab, vnorm, g)
    lib = load()
    b, d = latents.shape
    v = vocab.shape[0]
    dlat = torch.empty((b, d), dtype=torch.float32, device=latents.device)
    if b == 0:
        return dlat
    dev = latents.device
    chunks, tpc = bwd_grid(b, v, lib.angular_row_tile(), lib.angular_vocab_tile(),
                           sm_count(dev.index),
                           blocks_per_sm("angular_bwd_blocks_per_sm", dev.index, d),
                           lib.angular_bwd_depth_slices(d))
    # each vocabulary chunk's part of dl, rows padded to a multiple of 4 floats
    partial = torch.empty((chunks, b, -(-d // 4) * 4), dtype=torch.float32,
                          device=latents.device)
    with torch.cuda.device(latents.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.angular_bwd(latents.data_ptr(), vocab.data_ptr(), vnorm.data_ptr(),
                              g.data_ptr(), partial.data_ptr(), dlat.data_ptr(), b, v, d,
                              chunks, tpc, stream)
    check_launch(lib, "angular_bwd", err)
    LAUNCHES["bwd"] += 1
    return dlat


class AngularPartitionFn(torch.autograd.Function):
    """``Z = angular_partition(latents, vocab)`` with a recomputing backward."""

    @staticmethod
    def forward(ctx, latents, vocab):
        vnorm = torch.linalg.vector_norm(vocab, dim=-1)
        ctx.save_for_backward(latents, vocab, vnorm)
        return angular_fwd(latents, vocab, vnorm)

    @staticmethod
    def backward(ctx, g):
        latents, vocab, vnorm = ctx.saved_tensors
        return angular_bwd(latents, vocab, vnorm, g.contiguous()), None


def angular_partition(latents: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """Drop-in for :func:`mmtpu_torch.ops.wordprob.angular_partition`
    (``(B, D)``, ``(V, D)`` -> ``(B, 1)``) through :class:`AngularPartitionFn`."""
    return AngularPartitionFn.apply(latents, vocab)
