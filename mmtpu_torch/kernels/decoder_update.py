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

The config axis (the sweep's K configs, as mmtpu vmaps its kernel there):
the wrappers take ``(D, F)`` tables, ``x (B, D)`` and ``g_z (B, F)``, or the
same with a leading ``K``: ``(K, D, F)``, ``(K, B, D)``, ``(K, B, F)``.  One
call is one launch whatever K (config k is the kernel's ``blockIdx.z``); the
2-D call is the K = 1 case of the same launch.

``lr``, ``bc1``, ``bc2`` and ``flag`` may each be a number, a 0-d tensor
(one value for every config) or a ``(K,)`` tensor (one per config).  On the
card each travels to the kernel on its own: a tensor on the card by its
device pointer (converted to float32 there only where it is not already), a
``(K,)`` host tensor copied to the card first, a number or a 0-d host tensor
by value.  A caller that keeps them on the device never waits for the host.
Inside a CUDA graph capture (:mod:`mmtpu_torch.graphs`) a host tensor
is refused: a graph would freeze a one-element tensor's value and replay a
copy from host memory that may be gone; a number is a constant of the graph.
"""

from __future__ import annotations

import torch

from mmtpu_torch.graphs import launch_counter
from mmtpu_torch.kernels.angular import fwd_grid
from mmtpu_torch.kernels.build import Tickets, blocks_per_sm, sm_count
from mmtpu_torch.train.optim import _B1, _B2, _EPS
from mmtpu_torch.tree import per_config

# kernel launches by wrapper; read (and reset) by chip_smoke.py, and added to
# on each CUDA graph replay (mmtpu_torch/graphs.py)
LAUNCHES = launch_counter({"adam": 0, "sgd": 0})


def _keep(flag, w):
    """``flag > 0`` against ``w``'s rank (per config under the config axis)."""
    return per_config(torch.as_tensor(flag, device=w.device) > 0, w.ndim)


def reference_adam(w, m, v, x, g_z, lr, bc1, bc2, flag):
    """Plain version of :func:`fused_gemm_adam_update`."""
    lr, bc1, bc2 = (per_config(s, w.ndim) for s in (lr, bc1, bc2))
    g = x.transpose(-1, -2) @ g_z
    m2 = _B1 * m + (1.0 - _B1) * g
    v2 = _B2 * v + (1.0 - _B2) * (g * g)
    w2 = w - lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + _EPS)
    keep = _keep(flag, w)
    return (torch.where(keep, w2, w), torch.where(keep, m2, m), torch.where(keep, v2, v),
            g_z @ w.transpose(-1, -2))


def reference_sgd(w, x, g_z, lr, flag):
    """Plain version of :func:`fused_gemm_sgd_update`."""
    g = x.transpose(-1, -2) @ g_z
    return (torch.where(_keep(flag, w), w - per_config(lr, w.ndim) * g, w),
            g_z @ w.transpose(-1, -2))


def _check(w, x, g_z, tables, scalars) -> None:
    if w.ndim not in (2, 3) or x.ndim != w.ndim or g_z.ndim != w.ndim:
        raise ValueError("decoder update takes (D, F) weights, (B, D) latents and (B, F) "
                         "cotangents, each with or without a leading config axis, got "
                         f"{tuple(w.shape)}, {tuple(x.shape)}, {tuple(g_z.shape)}")
    lead, (d, f), b = w.shape[:-2], w.shape[-2:], x.shape[-2]
    if x.shape != (*lead, b, d) or g_z.shape != (*lead, b, f):
        raise ValueError(f"decoder update: weights {tuple(w.shape)}, latents "
                         f"{tuple(x.shape)} and cotangents {tuple(g_z.shape)} disagree")
    for t in tables:
        if t.shape != w.shape:
            raise ValueError(f"moment shape {tuple(t.shape)} != weight shape {tuple(w.shape)}")
    k = lead[0] if lead else 1
    if min(k, b, d, f) < 1:
        raise ValueError(f"decoder update takes non-empty shapes, got K, B, D, F = {k, b, d, f}")
    for s in scalars:
        if isinstance(s, torch.Tensor) and s.numel() != 1 and not (lead and s.shape == (k,)):
            raise ValueError(f"decoder update: a scalar argument has one element or, with the "
                             f"config axis, is a ({k},) tensor; got {tuple(s.shape)}")


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
    """``(pointer, value, stride, keep)`` of one scalar argument for the
    kernel.  A tensor on the card travels by its device pointer, converted
    to contiguous float32 on ``device`` only where it is not (``keep``
    holds the copy until the launch is queued), with stride 1 for one value
    per config and 0 for one value; a ``(K,)`` host tensor is copied to the
    card first; a number, or a one-element tensor on the host, travels by
    value."""
    if not isinstance(s, torch.Tensor):
        return None, float(s), 0, None
    if (s.device.type == "cpu" and device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("decoder update: a host tensor scalar inside a CUDA graph capture; "
                           "pass a device tensor (or a number, a constant of the graph)")
    if s.numel() == 1 and s.device.type == "cpu":
        return None, float(s), 0, None
    if s.device != device or s.dtype != torch.float32 or not s.is_contiguous():
        s = s.to(device=device, dtype=torch.float32).contiguous()
    return s.data_ptr(), 0.0, int(s.numel() > 1), s


# the kernel's tickets, one per (config, D tile, batch chunk)
_TICKETS = Tickets()


def _launch(kind: str, x, g_z, w, m, v, scalars):
    from mmtpu_torch.kernels.build import check_launch, load

    lib = load()
    dev = w.device
    k = w.shape[0] if w.ndim == 3 else 1
    (b, d), f = x.shape[-2:], w.shape[-1]
    d_tile, b_chunk = lib.dec_update_d_tile(), lib.dec_update_batch_chunk()
    # K1's forward grid rule, with D tiles for row tiles and F sub-tiles for
    # vocabulary sub-tiles, fed 1/K of the card's slots: the K configs'
    # blocks together stay near one wave (one F chunk per D tile at least)
    chunks, tpc = fwd_grid(d, f, d_tile, lib.dec_update_f_tile(),
                           max(1, sm_count(dev.index) // k),
                           blocks_per_sm("dec_update_blocks_per_sm", dev.index,
                                         int(kind == "adam")))
    # per config, one (D tile, batch chunk) region per ticket and a padded
    # slab per chunk in each
    regions = k * -(-d // d_tile) * -(-b // b_chunk)
    partial = torch.empty(regions * chunks * b_chunk * d_tile, dtype=torch.float32, device=dev)
    g_x = torch.empty(x.shape, dtype=torch.float32, device=dev)
    w2 = torch.empty_like(w)
    args = [_scalar(s, dev) for s in scalars]
    flat = [a for p, val, stride, _ in args for a in (p, val, stride)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _TICKETS(dev, stream, regions)
        tail = (partial.data_ptr(), tickets.data_ptr(), g_x.data_ptr(), k, b, d, f, chunks, tpc,
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

    ``w, m, v``: ``(D, F)``; ``x``: ``(B, D)``; ``g_z``: ``(B, F)``; or
    each with a leading config axis K.  ``bc1``, ``bc2`` are ``1 - beta^count``
    at the post-increment step count; ``flag`` 0 passes ``w, m, v`` through
    unchanged (``g_x`` is computed either way), per config where it is
    ``(K,)``.  Zero columns of ``w, m, v`` with zero ``g_z`` stay zero.
    """
    _check(w, x, g_z, (m, v), (lr, bc1, bc2, flag))
    if _on_cpu(w, m, v, x, g_z):
        return reference_adam(w, m, v, x, g_z, lr, bc1, bc2, flag)
    return _launch("adam", x, g_z, w, m, v, (lr, bc1, bc2, flag))


def fused_gemm_sgd_update(w, x, g_z, lr, flag):
    """SGD variant of :func:`fused_gemm_adam_update`: returns ``(w2, g_x)``."""
    _check(w, x, g_z, (), (lr, flag))
    if _on_cpu(w, x, g_z):
        return reference_sgd(w, x, g_z, lr, flag)
    return _launch("sgd", x, g_z, w, None, None, (lr, flag))
