"""Kernel K2: the fused decoder update of one stacked weight leaf.

Replaces the Pallas TPU kernels of :mod:`mmtpu.kernels.decoder_update`
(``fused_gemm_adam_update`` / ``fused_gemm_sgd_update``) with a CUDA C++
kernel for Hopper (``mmtpu_torch/csrc/decoder_update.cu``, built by
:mod:`mmtpu_torch.kernels.build`).  One call computes ``g_w = x^T g_z``, the
torch-Adam or SGD step of the weight table (gated by ``flag``) and the latent
cotangent ``g_x = g_z w^T`` with the pre-update ``w``.  The source's header
says how the kernel is laid out and what bounds it on an H100.

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

``lr``, ``bc1``, ``bc2`` and ``flag`` may be numbers or 0-d tensors; on the
card they travel to the kernel as one ``(4,)`` float32 device tensor, so a
caller that keeps them on the device never waits for the host.
"""

from __future__ import annotations

import torch

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


def _scalars(device, lr, bc1, bc2, flag) -> torch.Tensor:
    """``(lr, bc1, bc2, flag)`` as one ``(4,)`` float32 tensor on ``device``;
    numbers are filled in on the device, not copied from the host."""
    parts = [s.to(device=device, dtype=torch.float32).reshape(()) if isinstance(s, torch.Tensor)
             else torch.full((), float(s), dtype=torch.float32, device=device)
             for s in (lr, bc1, bc2, flag)]
    return torch.stack(parts)


def _launch(kind: str, x, g_z, w, m, v, scalars):
    from mmtpu_torch.kernels.build import check_launch, load

    lib = load()
    (b, d), f = x.shape, w.shape[1]
    n_ftiles = -(-f // lib.dec_update_f_tile())
    partial = torch.empty((n_ftiles, b, d), dtype=torch.float32, device=w.device)
    g_x = torch.empty((b, d), dtype=torch.float32, device=w.device)
    w2 = torch.empty_like(w)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "adam":
            m2, v2 = torch.empty_like(m), torch.empty_like(v)
            err = lib.dec_update_adam(x.data_ptr(), g_z.data_ptr(), w.data_ptr(), m.data_ptr(),
                                      v.data_ptr(), scalars.data_ptr(), w2.data_ptr(),
                                      m2.data_ptr(), v2.data_ptr(), partial.data_ptr(),
                                      g_x.data_ptr(), b, d, f, stream)
        else:
            err = lib.dec_update_sgd(x.data_ptr(), g_z.data_ptr(), w.data_ptr(),
                                     scalars.data_ptr(), w2.data_ptr(), partial.data_ptr(),
                                     g_x.data_ptr(), b, d, f, stream)
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
    return _launch("adam", x, g_z, w, m, v, _scalars(w.device, lr, bc1, bc2, flag))


def fused_gemm_sgd_update(w, x, g_z, lr, flag):
    """SGD variant of :func:`fused_gemm_adam_update`: returns ``(w2, g_x)``."""
    _check(w, x, g_z)
    if _on_cpu(w, x, g_z):
        return reference_sgd(w, x, g_z, lr, flag)
    return _launch("sgd", x, g_z, w, None, None, _scalars(w.device, lr, 0.0, 0.0, flag))
