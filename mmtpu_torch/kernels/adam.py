"""Adam over every leaf of a parameter tree in one hand-written CUDA launch.

A kernel with no Pallas counterpart: mmtpu leaves its optimizer to XLA,
which fuses each leaf's update into one loop.  The CUDA C++ source,
``mmtpu_torch/csrc/adam.cu`` (built by :mod:`mmtpu_torch.kernels.build`),
says how it is laid out and what bounds it on an H100: one pass over device
memory that reads p, g, m and v and writes p, m and v, for all the leaves of
a tree at once.

- :func:`adam_tree` steps a tree by ``opt_update``'s Adam law, with its
  per-config ``active`` and per-leaf gates; :func:`adam_touch` steps one
  block of lazy Adam's table (``lazy_adam_touch``).  For CUDA tensors each
  launches the kernel (and adds to :data:`LAUNCHES`) or raises; for CPU
  tensors each runs the plain twin (:func:`mmtpu_torch.train.optim.adam_plain`,
  :func:`~mmtpu_torch.train.optim.adam_leaf`).  Nothing falls back from CUDA
  to the twin.
- The bias corrections come from the caller, as the twin's do.  ``lr``,
  ``bc1``, ``bc2``, ``active`` and each gate are ``(K,)`` device vectors
  under a config axis, 0-d device tensors, or Python numbers passed by value:
  nothing is read on the host and no tensor is made from host data, so a
  captured epoch may call either wrapper.
- :func:`plan` maps the leaves to launches and blocks, in Python alone.
"""

from __future__ import annotations

import ctypes

import torch

from mmtpu_torch.graphs import launch_counter
from mmtpu_torch.tree import tree_leaves, tree_unflatten

# kernel launches by wrapper, added to on each CUDA graph replay
# (mmtpu_torch/graphs.py)
LAUNCHES = launch_counter({"tree": 0, "touch": 0})

# adam.cu's THREADS, UNROLL and MAX_LEAVES: a block takes TILE units (float4s
# on the vector path, floats elsewhere); a launch takes up to MAX_LEAVES leaves
THREADS = 256
UNROLL = 4
TILE = THREADS * UNROLL
MAX_LEAVES = 32
_LIMIT = 2**31  # elements, offsets and strides are 32-bit in the kernel


class _Scalar(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("value", ctypes.c_float), ("stride", ctypes.c_int),
                ("is_bool", ctypes.c_int)]


class _Leaf(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p * 4), ("dst", ctypes.c_void_p * 3), ("n", ctypes.c_int),
                ("inner", ctypes.c_int), ("cs", ctypes.c_int * 4), ("gate", _Scalar),
                ("vec", ctypes.c_int), ("first_block", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("lr", _Scalar), ("bc1", _Scalar), ("bc2", _Scalar), ("active", _Scalar),
                ("leaf", _Leaf * MAX_LEAVES), ("n_leaves", ctypes.c_int)]


def args_size() -> int:
    """Bytes of the kernel's by-value argument struct."""
    return ctypes.sizeof(_Args)


def blocks_of(n: int, vec: bool) -> int:
    """The blocks of a leaf of ``n`` elements."""
    return -(-(n // 4 if vec else n) // TILE)


def plan(leaves, max_leaves: int = MAX_LEAVES) -> list:
    """The launches for ``leaves``, ``(n, vec)`` each: per launch ``(blocks,
    [(leaf index, first block), ...])``, at most ``max_leaves`` leaves a
    launch, in order."""
    launches, cur, blocks = [], [], 0
    for i, (n, vec) in enumerate(leaves):
        if len(cur) == max_leaves:
            launches.append((blocks, cur))
            cur, blocks = [], 0
        cur.append((i, blocks))
        blocks += blocks_of(n, vec)
    if cur:
        launches.append((blocks, cur))
    return launches


def takes_vector(inner: int, ptrs, strides) -> bool:
    """Whether a leaf takes float4 units: its elements per config, every
    config stride a multiple of 4 and every pointer 16-byte aligned."""
    return inner % 4 == 0 and all(s % 4 == 0 for s in strides) and all(p % 16 == 0 for p in ptrs)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"adam kernel: unsupported device {t.device}")


def _scalar(x, dev, name: str, dtypes) -> tuple:
    """``(_Scalar, K or None)`` of a per-config value."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"adam kernel: {name} on {x.device}, the leaves on {dev}")
        if x.dtype not in dtypes or x.ndim > 1:
            raise TypeError(f"adam kernel: {name} takes a 0-d or (K,) tensor of {dtypes}, got "
                            f"{x.dtype} {tuple(x.shape)}")
        return (_Scalar(x.data_ptr(), 0.0, x.stride(0) if x.ndim else 0, x.dtype == torch.bool),
                x.shape[0] if x.ndim else None)
    return _Scalar(None, float(x), 0, 0), None


def _config_stride(t: torch.Tensor, k) -> int | None:
    """Elements between ``t``'s configs where each config's elements lie
    contiguous (all of ``t`` without a config axis); None elsewhere."""
    if k is None:
        return t.numel() if t.is_contiguous() else None
    shape, strides, inner = t.shape, t.stride(), 1
    for i in range(t.ndim - 1, 0, -1):
        if shape[i] != 1 and strides[i] != inner:
            return None
        inner *= shape[i]
    return strides[0] if k > 1 else inner


def _launch(kind: str, ps, gs, ms, vs, gates, lr, bc1, bc2, active) -> tuple:
    """``(p2, m2, v2)`` lists for the leaves ``ps``; leaves whose gate is
    off on the host keep their tensors."""
    from mmtpu_torch.kernels.build import check_launch, load

    dev = ps[0].device
    scalars, ks = {}, set()
    for name, x, dtypes in (("lr", lr, (torch.float32,)), ("bc1", bc1, (torch.float32,)),
                            ("bc2", bc2, (torch.float32,)), ("active", active, (torch.bool,))):
        scalars[name], k = _scalar(x, dev, name, dtypes)
        ks.add(k)
    gate_of = [_scalar(gt, dev, "a gate", (torch.float32, torch.bool)) for gt in gates]
    ks |= {k for _, k in gate_of}
    ks.discard(None)
    if len(ks) > 1:
        raise ValueError(f"adam kernel: per-config values of lengths {sorted(ks)}")
    k = ks.pop() if ks else None
    out_p, out_m, out_v = list(ps), list(ms), list(vs)
    if isinstance(active, bool) and not active:
        return out_p, out_m, out_v
    todo = []
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        gate = gate_of[i][0]
        if not isinstance(gates[i], torch.Tensor) and not gates[i] > 0:
            continue  # the gate is off for every config: the twin keeps the leaf
        ins = [p, g, m, v]
        for t in ins:
            if t.device != dev or t.dtype != torch.float32 or t.shape != p.shape:
                raise TypeError(f"adam kernel takes float32 leaves of one shape on {dev}, got "
                                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        n = p.numel()
        if n == 0:
            continue
        if k is not None and (p.ndim == 0 or p.shape[0] != k):
            raise ValueError(f"adam kernel: a leaf of shape {tuple(p.shape)} under {k} configs")
        strides = []
        for j, t in enumerate(ins):
            cs = _config_stride(t, k)
            if cs is None:
                ins[j] = t = t.contiguous()
                cs = _config_stride(t, k)
            strides.append(cs)
        if n >= _LIMIT or any(cs >= _LIMIT for cs in strides) or (
                k is not None and (k - 1) * max(strides) + n // k >= _LIMIT):
            raise ValueError(f"adam kernel: a leaf of {n} elements exceeds its 32-bit offsets")
        inner = n if k is None else n // k
        outs = [torch.empty(p.shape, dtype=torch.float32, device=dev) for _ in range(3)]
        vec = takes_vector(inner, [t.data_ptr() for t in ins], strides)
        todo.append((ins, outs, n, inner, strides, gate, vec))
        out_p[i], out_m[i], out_v[i] = outs
    if not todo:
        return out_p, out_m, out_v
    lib = load()
    _check_layout(lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for blocks, members in plan([(t[2], t[6]) for t in todo]):
            args = _Args(n_leaves=len(members), **scalars)
            for slot, (j, first) in enumerate(members):
                ins, outs, n, inner, strides, gate, vec = todo[j]
                leaf = args.leaf[slot]
                leaf.src[:] = [t.data_ptr() for t in ins]
                leaf.dst[:] = [t.data_ptr() for t in outs]
                leaf.n, leaf.inner, leaf.cs[:] = n, inner, strides
                leaf.gate, leaf.vec, leaf.first_block = gate, vec, first
            check_launch(lib, "adam_apply", lib.adam_apply(ctypes.byref(args), blocks, stream))
            LAUNCHES[kind] += 1
    return out_p, out_m, out_v


def _check_layout(lib) -> None:
    """Raise unless the library's struct and tile are the wrapper's."""
    got = (lib.adam_args_size(), lib.adam_max_leaves(), lib.adam_tile())
    if got != (args_size(), MAX_LEAVES, TILE):
        raise RuntimeError(f"adam.cu's (struct bytes, leaves, tile) {got} differ from the "
                           f"wrapper's {(args_size(), MAX_LEAVES, TILE)}")


def adam_tree(params, grads, m, v, lr, bc1, bc2, active=True, gates=None) -> tuple:
    """``(params2, m2, v2)``: one Adam step of every leaf of ``params``
    (``grads``, ``m``, ``v`` trees like it), :func:`opt_update`'s law with
    the caller's bias corrections.  ``active`` (a bool, a 0-d or ``(K,)``
    bool tensor) and each leaf's gate (``gates``, a tree like ``params`` of
    numbers or 0-d or ``(K,)`` float32 tensors; None: all on) decide, per
    config, whether the leaf moves.  On the card one launch takes up to
    :data:`MAX_LEAVES` leaves."""
    ps = tree_leaves(params)
    if _on_cpu(ps[0]):
        from mmtpu_torch.train.optim import adam_plain  # optim imports this module

        return adam_plain(params, grads, m, v, lr, bc1, bc2, active, gates)
    gts = [1.0] * len(ps) if gates is None else tree_leaves(gates)
    out = _launch("tree", ps, tree_leaves(grads), tree_leaves(m), tree_leaves(v), gts, lr, bc1,
                  bc2, active)
    return tuple(tree_unflatten(params, col) for col in out)


def adam_touch(p, m, v, g, lr, bc1, bc2) -> tuple:
    """``(p2, m2, v2)``: one ungated Adam step of one tensor (lazy Adam's
    block of a permuted table, whose configs may lie a table apart)."""
    if _on_cpu(p):
        from mmtpu_torch.train.optim import adam_leaf  # optim imports this module

        return adam_leaf(p, g, m, v, lr, bc1, bc2)
    out = _launch("touch", [p], [g], [m], [v], [1.0], lr, bc1, bc2, True)
    return tuple(col[0] for col in out)

