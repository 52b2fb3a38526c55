"""Kernel K2: the fused decoder update of one stacked weight leaf.

Replaces the Pallas TPU kernels of :mod:`mmtpu.kernels.decoder_update`
(``fused_gemm_adam_update`` / ``fused_gemm_sgd_update``) with a CUDA C++
kernel for Hopper (``mmtpu_torch/csrc/decoder_update.cu``, built by
:mod:`mmtpu_torch.kernels.build`).  One call computes ``g_w = x^T g_z``, the
torch-Adam or SGD step of the weight table (gated by ``flag``) and the latent
cotangent ``g_x = g_z w^T`` with the pre-update ``w``.  The source's header
says how the kernel is laid out and what bounds it on an H100.  One call is
one launch; its grid comes from K1's :func:`mmtpu_torch.kernels.angular.fwd_grid`
(D tiles for row tiles, F sub-tiles for vocabulary sub-tiles), fed the
resident blocks per SM from the library's occupancy query.

- :func:`fused_gemm_adam_update` / :func:`fused_gemm_sgd_update` are the
  wrappers, with mmtpu's arguments and return order.  For CUDA tensors each
  launches the kernel (and adds one to :data:`LAUNCHES`) or raises; for CPU
  tensors each computes its plain version.  Nothing falls back from CUDA to
  the plain version.  The outputs are new tensors; the inputs are not
  changed.  mmtpu's ``tile`` argument (the TPU's F tile, a VMEM choice) is
  not carried over: the kernel takes any F and masks the edge itself.
- :func:`reference_adam` / :func:`reference_sgd` are the plain versions
  (torch twins of mmtpu's ``xla_reference_adam`` / ``xla_reference_sgd``)
  that the tests and ``chip_smoke.py`` hold the kernel to.

``lr``, ``bc1``, ``bc2`` and ``flag`` may be numbers or 0-d tensors.  On the
card each travels to the kernel on its own: a 0-d tensor on the card by its
device pointer (converted to float32 there only where it is not already), a
number or a host tensor by value.  A caller that keeps them on the device
never waits for the host.
"""

from __future__ import annotations

import torch

from mmtpu_torch.kernels.angular import fwd_grid
from mmtpu_torch.kernels.build import Tickets, blocks_per_sm, sm_count
from mmtpu_torch.train.optim import _B1, _B2, _EPS

# kernel launches by wrapper; read (and reset) by chip_smoke.py
LAUNCHES = {"adam": 0, "sgd": 0}


def reference_adam(w, m, v, x, g_z, lr, bc1, bc2, flag):
    """Plain version of :func:`fused_gemm_adam_update`."""
    g = x.T @ g_z
    m2 = _B1 * m + (1.0 - _B1) * g
    v2 = _B2 * v + (1.0 - _B2) * (g * g)
    w2 = w - lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + _EPS)
    keep = torch.as_tensor(flag, device=w.device) > 0
    return (torch.where(keep, w2, w), torch.where(keep, m2, m), torch.where(keep, v2, v),
            g_z @ w.T)


def reference_sgd(w, x, g_z, lr, flag):
    """Plain version of :func:`fused_gemm_sgd_update`."""
    g = x.T @ g_z
    keep = torch.as_tensor(flag, device=w.device) > 0
    return torch.where(keep, w - lr * g, w), g_z @ w.T


def _check(w, x, g_z, *tables) -> None:
    if w.ndim != 2 or x.ndim != 2 or g_z.ndim != 2:
        raise ValueError("decoder update takes (D, F) weights, (B, D) latents and (B, F) "
                         f"cotangents, got {tuple(w.shape)}, {tuple(x.shape)}, "
                         f"{tuple(g_z.shape)}")
    (d, f), b = w.shape, x.shape[0]
    if x.shape[1] != d or g_z.shape != (b, f):
        raise ValueError(f"decoder update: weights {tuple(w.shape)}, latents "
                         f"{tuple(x.shape)} and cotangents {tuple(g_z.shape)} disagree")
    for t in tables:
        if t.shape != w.shape:
            raise ValueError(f"moment shape {tuple(t.shape)} != weight shape {tuple(w.shape)}")
    if min(b, d, f) < 1:
        raise ValueError(f"decoder update takes non-empty shapes, got B, D, F = {b, d, f}")


def _on_cpu(*tensors) -> bool:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"decoder update: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"decoder update: unsupported device {dev}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"decoder update kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("decoder update kernel takes contiguous tensors")
    return False


def _scalar(s, device) -> tuple:
    """``(pointer, value, keep)`` of one scalar argument for the kernel.  A
    0-d tensor on the card travels by its device pointer, converted to
    float32 on ``device`` only where its dtype or device differs (``keep``
    holds the copy until the launch is queued); a number, or a tensor on the
    host, travels by value.  Nothing waits for the card."""
    if isinstance(s, torch.Tensor):
        if s.numel() != 1:
            raise ValueError(f"decoder update: scalar argument of shape {tuple(s.shape)}")
        if s.device.type == "cpu":
            return None, float(s), None
        if s.device != device or s.dtype != torch.float32:
            s = s.to(device=device, dtype=torch.float32)
        return s.data_ptr(), 0.0, s
    return None, float(s), None


# the kernel's tickets, one per (D tile, batch chunk)
_TICKETS = Tickets()


def _launch(kind: str, x, g_z, w, m, v, scalars):
    from mmtpu_torch.kernels.build import check_launch, load

    lib = load()
    dev = w.device
    (b, d), f = x.shape, w.shape[1]
    d_tile, b_chunk = lib.dec_update_d_tile(), lib.dec_update_batch_chunk()
    # K1's forward grid rule, with D tiles for row tiles and F sub-tiles for
    # vocabulary sub-tiles
    chunks, tpc = fwd_grid(d, f, d_tile, lib.dec_update_f_tile(), sm_count(dev.index),
                           blocks_per_sm("dec_update_blocks_per_sm", dev.index,
                                         int(kind == "adam")))
    # one (D tile, batch chunk) region per ticket, a padded slab per chunk in each
    regions = -(-d // d_tile) * -(-b // b_chunk)
    partial = torch.empty(regions * chunks * b_chunk * d_tile, dtype=torch.float32, device=dev)
    g_x = torch.empty((b, d), dtype=torch.float32, device=dev)
    w2 = torch.empty_like(w)
    args = [_scalar(s, dev) for s in scalars]
    flat = [a for p, val, _ in args for a in (p, val)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _TICKETS(dev, stream, regions)
        tail = (partial.data_ptr(), tickets.data_ptr(), g_x.data_ptr(), b, d, f, chunks, tpc,
                stream)
        if kind == "adam":
            m2, v2 = torch.empty_like(m), torch.empty_like(v)
            err = lib.dec_update_adam(x.data_ptr(), g_z.data_ptr(), w.data_ptr(), m.data_ptr(),
                                      v.data_ptr(), *flat, w2.data_ptr(), m2.data_ptr(),
                                      v2.data_ptr(), *tail)
        else:
            err = lib.dec_update_sgd(x.data_ptr(), g_z.data_ptr(), w.data_ptr(), *flat,
                                     w2.data_ptr(), *tail)
    check_launch(lib, f"dec_update_{kind}", err)
    LAUNCHES[kind] += 1
    return (w2, m2, v2, g_x) if kind == "adam" else (w2, g_x)


def fused_gemm_adam_update(w, m, v, x, g_z, lr, bc1, bc2, flag):
    """Fused ``g_w = x^T g_z``, torch-Adam step of ``(w, m, v)`` and
    ``g_x = g_z w^T``; returns ``(w2, m2, v2, g_x)``.

    ``w, m, v``: ``(D, F)``; ``x``: ``(B, D)``; ``g_z``: ``(B, F)``.  ``bc1``,
    ``bc2`` are ``1 - beta^count`` at the post-increment step count;
    ``flag`` 0 passes ``w, m, v`` through unchanged (``g_x`` is computed
    either way).  Zero columns of ``w, m, v`` with zero ``g_z`` stay zero.
    """
    _check(w, x, g_z, m, v)
    if _on_cpu(w, m, v, x, g_z):
        return reference_adam(w, m, v, x, g_z, lr, bc1, bc2, flag)
    return _launch("adam", x, g_z, w, m, v, (lr, bc1, bc2, flag))


def fused_gemm_sgd_update(w, x, g_z, lr, flag):
    """SGD variant of :func:`fused_gemm_adam_update`: returns ``(w2, g_x)``."""
    _check(w, x, g_z)
    if _on_cpu(w, x, g_z):
        return reference_sgd(w, x, g_z, lr, flag)
    return _launch("sgd", x, g_z, w, None, None, (lr, flag))
