#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mmtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

0. the card's name and power limit; TF32 off for matmuls and cuDNN;
1. build the CUDA kernel library from ``mmtpu_torch/csrc`` (one ``nvcc`` per
   source, side by side; timed), K1's resident blocks per SM at D = 300
   and 512 and K2's (Adam and SGD; at any depth) from the runtime's
   occupancy query;
2. kernel K1 (angular partition, forward and backward) against its plain
   PyTorch versions at the main path's shapes, plus a ragged shape and a
   zero latent row, with the forward and the backward each called twice and
   required bit for bit equal; kernel and plain times at 64 and 512 rows
   (device time per call from queued bursts, and the median of single
   calls) and the bounds at both;
3. kernel K2 (fused decoder update, Adam and SGD) against its plain versions
   at (B, D, F) = (64, 300, 1400), (64, 300, 1536), (512, 300, 1416) and the
   ragged (37, 300, 37) and (33, 300, 1401), with flag 1 and flag 0, each
   called twice and required bit for bit equal; the CUDA kernels that one
   call of each kind issues, counted under ``torch.profiler`` (exactly one);
   times and bounds at (64, 300, 1400) and (512, 300, 1416);
4. the non-e2e path through the normal entry point,
   ``mmtpu_torch.run.main([cfg, "mosi", "--e2e", "n", "--device", "cuda",
   ...])``: the MMB2 latent fit at full MOSI width (synthetic data:
   1284/229/686 utterances, vocab 3016 x 300, audio 74, visual 47, batch 64,
   inference batch 512; SGD, layer norm, lr 1e-4 as in bench.py), 3 epochs,
   10 sentiment epochs;
5. the e2e path, the grid's mode, through the same entry point with
   ``--e2e y`` at the same width and settings (likelihood weight from the
   grid);
6. the fused decoder update: ``fit_e2e`` with ``fused_dec_update=True``
   beside the same fit without it, same draws, at the same width, once with
   SGD and once with Adam, each timed after one untimed warm-up epoch;
7. small configs on the GPU and on the CPU (where the kernel wrappers use
   their plain versions), which must agree: the non-e2e run and the fused
   e2e fit;
8. lazy Adam: the e2e run through ``run.main`` on an Adam config with and
   without ``--lazy_adam`` (held to each other at mmtpu's drift tolerance,
   their training rates printed side by side), then ``fit_e2e`` with the
   fused decoder update and lazy Adam (K2-adam twice per step);
9. the non-e2e run with ``--validation_curve`` (samples at epoch 0 and at
   the end; K1 launched for the two refits of the valid split on top of
   phase 4's count), and the Adam training fit checkpointed one epoch per
   segment, killed after its first save, resumed from epoch 1 and held to
   the uninterrupted fit bit for bit;
10. one sweep chunk, ``mmtpu_torch.sweep.run_chunk``: the first 32 configs
   of the grid's Adam / 100-epoch bucket trained as one program with a
   leading config axis (lazy Adam, the sweep's default) at full MOSI width,
   epochs cut to 2 and sentiment epochs to 10; K1 launched once per step for
   the whole chunk (48 of each kind, at 2048 rows in training and 16384 in
   inference); K1 against its plain versions at those row counts (phase 2's
   gates, with times and bounds); four of the configs (each norm at lr 1e-4
   and 1e-3) run alone through the single-config fits with the same draws
   and held to the chunk's results (embeddings at lr 1e-4 only: see the
   phase's code); diverged configs reported, the others finite; the phases'
   wall seconds, the training rate and the peak memory printed.

Phases 8, 9 and 10 run inside the temporary directory of phases 4-6, before
phase 7.  Around each path of phases 4-6 and 8-10 the kernel launch counts
are set to 0 just before and read just after.  The line before the last is
the kernels' JSON record; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# (B, D, V, zero_row): the train batch, the inference batch, a large batch,
# a ragged shape, and a zero latent row (exercises the 1e-8 cosine clamp)
SHAPES = [(64, 300, 3016, False), (512, 300, 3016, False), (2048, 300, 3016, False),
          (37, 300, 3001, False), (64, 300, 3016, True)]
FWD_SUM_REL, FWD_RTOL = 1e-5, 1e-5  # the TPU kernel's gate (bench.py) and tests
GRAD_MAX_REL, GRAD_ATOL = 1e-3, 1e-5
# (B, D, F) of K2: the train batch at the stacked MOSI head width (pos 2), the
# width the TPU code padded to, the inference batch at pos 4, ragged shapes
# (the last with F odd: the kernel's scalar edge path)
K2_SHAPES = [(64, 300, 1400), (64, 300, 1536), (512, 300, 1416), (37, 300, 37),
             (33, 300, 1401)]
K2_RTOL, K2_ATOL, K2_GX_MAX_REL = 1e-5, 1e-5, 1e-5  # the TPU kernel's tests
N_EPOCHS, N_SENTIMENT_EPOCHS = 3, 10
STEPS_PER_EPOCH = -(-1284 // 64)
# one NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
# elementwise operations per weight element of a K2 step, beside its two
# products: Adam's moments, bias corrections, sqrt, eps, divide and step; SGD's step
K2_ELEMENTWISE_OPS = {"adam": 14, "sgd": 2}
# lazy against dense Adam (phase 8; final loss, post embeddings): mmtpu's own
# drift check (tests/test_train_parity.py::test_lazy_adam_matches_dense). On
# the CPU this phase measured 0 and 5.0e-8 (the kernels' plain versions).
LAZY_LOSS_RTOL, LAZY_EMB_ATOL = 2e-3, 1e-5
# a resumed fit against the uninterrupted one (phase 9): bit for bit. Every
# kernel of the fit adds in a fixed order (K1, K2 and cuBLAS on one stream),
# the checkpoint holds float32 exactly, and autograd reaches no index backward
RESUME_RTOL, RESUME_ATOL = 0.0, 0.0
# phase 10: the sweep chunk, cut in depth only (the grid says 100 epochs and
# 400 sentiment epochs), and its tolerance against the configs run alone:
# the CPU parity tests' (loss rtol, embeddings and predictions atol)
SWEEP_K, SWEEP_EPOCHS, SWEEP_SENTIMENT_EPOCHS = 32, 2, 10
SWEEP_RTOL, SWEEP_ATOL = 2e-4, 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def _call_ms(torch, fn, reps: int = 30) -> float:
    """Median time of one call between CUDA events, host launch gaps included."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, reps: int = 100, bursts: int = 3) -> float:
    """Device time per call: a burst of calls queued behind a GPU-side sleep,
    so the host's launch gaps do not show; median over bursts."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # outlasts enqueuing the burst
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float) -> tuple:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes over the memory rate; and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _k1_case(torch, dev, gen, b, d, v, zero_row=False) -> tuple:
    """K1's inputs at one shape: normal latents (row 0 zero with
    ``zero_row``), a unit-norm vocabulary, a normal cotangent."""
    lat = torch.randn(b, d, generator=gen)
    if zero_row:
        lat[0] = 0.0
    voc = torch.randn(v, d, generator=gen)
    voc = voc / torch.linalg.vector_norm(voc, dim=-1, keepdim=True)
    g = torch.randn(b, 1, generator=gen)
    return lat.to(dev), voc.to(dev), g.to(dev)


def _check_k1(torch, K, lat, voc, g, zero_row=False) -> tuple:
    """K1's forward and backward at one shape against the plain versions at
    the TPU kernel's gates, each called twice and required bit for bit
    equal; returns the largest absolute errors ``(fwd, bwd)``."""
    b, d = lat.shape
    v = voc.shape[0]
    vnorm = torch.linalg.vector_norm(voc, dim=-1)
    z_k = K.angular_fwd(lat, voc, vnorm)
    z_p = K.angular_partition_ref(lat, voc)
    dl_k = K.angular_bwd(lat, voc, vnorm, g)
    # partials are added in a fixed order (no atomics): a second call is bit for bit equal
    same_fwd = torch.equal(z_k, K.angular_fwd(lat, voc, vnorm))
    same = torch.equal(dl_k, K.angular_bwd(lat, voc, vnorm, g))
    dl_f = K.angular_partition_bwd_ref(lat, voc, vnorm, g)
    lat_p = lat.clone().requires_grad_()
    (K.angular_partition_ref(lat_p, voc) * g).sum().backward()
    dl_a = lat_p.grad
    torch.cuda.synchronize()

    sum_rel = abs(z_k.sum().item() - z_p.sum().item()) / abs(z_p.sum().item())
    elem_rel = ((z_k - z_p).abs() / z_p.abs()).max().item()
    grad_rel = ((dl_k - dl_a).abs().max() / dl_a.abs().max()).item()
    # the zero row's gradient is ~1e8 (it divides by the 1e-8 clamp), so it
    # is held to the max-rel limit only; the other rows to atol 1e-5
    rows = slice(1, None) if zero_row else slice(None)
    grad_abs = (dl_k[rows] - dl_f[rows]).abs().max().item()
    log(f"[k1] B={b} D={d} V={v} zero_row={zero_row}: fwd sum rel {sum_rel:.3e}, "
        f"elem rel {elem_rel:.3e}; grad max-rel vs autograd {grad_rel:.3e}, "
        f"abs vs bwd_ref {grad_abs:.3e}; repeat bit-equal fwd {same_fwd} bwd {same}")
    if not (sum_rel < FWD_SUM_REL and elem_rel < FWD_RTOL):
        raise AssertionError(f"K1 forward disagrees at {(b, d, v, zero_row)}")
    if not (grad_rel < GRAD_MAX_REL and grad_abs < GRAD_ATOL):
        raise AssertionError(f"K1 backward disagrees at {(b, d, v, zero_row)}")
    if not same_fwd:
        raise AssertionError(f"K1 forward differs between two calls at {(b, d, v, zero_row)}")
    if not same:
        raise AssertionError(f"K1 backward differs between two calls at {(b, d, v, zero_row)}")
    return (z_k - z_p).abs().max().item(), grad_abs


def _k1_times(torch, K, lat, voc, g, single_calls: bool = True, reps: int = 100) -> dict:
    """Device ms per call of both kernels and both plain versions at one
    shape (queued bursts); with ``single_calls``, the median of single calls
    is printed too."""
    b = lat.shape[0]
    vnorm = torch.linalg.vector_norm(voc, dim=-1)
    fns = {"fwd": lambda: K.angular_fwd(lat, voc, vnorm),
           "fwd_plain": lambda: K.angular_partition_ref(lat, voc),
           "bwd": lambda: K.angular_bwd(lat, voc, vnorm, g),
           "bwd_plain": lambda: K.angular_partition_bwd_ref(lat, voc, vnorm, g)}
    times = {k: _device_ms(torch, f, reps=reps) for k, f in fns.items()}
    printed = [("device", times)]
    if single_calls:
        printed.append(("one call", {k: _call_ms(torch, f) for k, f in fns.items()}))
    for kind, t in printed:
        log(f"[k1] B={b} {kind} ms: fwd kernel {t['fwd']:.4f} plain {t['fwd_plain']:.4f}; "
            f"bwd kernel {t['bwd']:.4f} plain {t['bwd_plain']:.4f}")
    return times


def _k1_bounds(b: int, d: int = 300, v: int = 3016) -> dict:
    """K1's bounds at ``b`` rows: each input read once, each output written once."""
    fwd_bytes = 4 * (b * d + v * d + v + b)
    bounds = {"fwd": bound_ms(2 * b * v * d, fwd_bytes),
              "bwd": bound_ms(4 * b * v * d, fwd_bytes + 4 * b * d)}
    log(f"[k1] bound at B={b}: fwd {bounds['fwd'][0]:.5f} ms ({bounds['fwd'][1]}), "
        f"bwd {bounds['bwd'][0]:.5f} ms ({bounds['bwd'][1]})")
    return bounds


def check_kernels(torch, K, dev) -> dict:
    """Phase 2: K1 forward/backward vs the plain versions; returns errors and times."""
    gen = torch.Generator().manual_seed(0)
    fwd_err = bwd_err = 0.0
    for b, d, v, zero_row in SHAPES:
        errs = _check_k1(torch, K, *_k1_case(torch, dev, gen, b, d, v, zero_row), zero_row)
        fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])
    times = {b: _k1_times(torch, K, *_k1_case(torch, dev, gen, b, 300, 3016)) for b in (64, 512)}
    bounds = {b: _k1_bounds(b) for b in (64, 512)}
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "times": times, "bounds": bounds}


def _k2_case(torch, dev, gen, b, d, f):
    """Inputs of one K2 call.  g_z is scaled by 1/sqrt(B), so g_w ~ N(0, 1)
    at every batch; every output table is then far above atol 1e-5 (v and
    v2 >= 0.01, m2 ~ 0.1, the Adam step ~ 0.2 lr), so the check resolves an
    error in any element of any of them.  The scalars are device tensors
    (lr 1e-3, bias corrections at step 5)."""
    r = lambda *s: torch.randn(*s, generator=gen)
    t = {"w": 0.05 * r(d, f), "m": 0.1 * r(d, f), "v": 0.01 * (1.0 + r(d, f).abs()),
         "x": r(b, d), "g_z": r(b, f) / b ** 0.5}
    t = {k: a.to(dev) for k, a in t.items()}
    t["lr"] = torch.tensor(1e-3, device=dev)
    t["bc1"] = torch.tensor(1.0 - 0.9 ** 5, device=dev)
    t["bc2"] = torch.tensor(1.0 - 0.999 ** 5, device=dev)
    return t


def _k2_calls(T, t, flag):
    adam = dict(kernel=lambda: T.fused_gemm_adam_update(t["w"], t["m"], t["v"], t["x"],
                                                        t["g_z"], t["lr"], t["bc1"], t["bc2"],
                                                        flag),
                plain=lambda: T.reference_adam(t["w"], t["m"], t["v"], t["x"], t["g_z"],
                                               t["lr"], t["bc1"], t["bc2"], flag))
    sgd = dict(kernel=lambda: T.fused_gemm_sgd_update(t["w"], t["x"], t["g_z"], t["lr"], flag),
               plain=lambda: T.reference_sgd(t["w"], t["x"], t["g_z"], t["lr"], flag))
    return {"adam": adam, "sgd": sgd}


def compare_k2(kind: str, got, want, t: dict, on: float, where) -> tuple:
    """Hold one K2 call's outputs to its plain version's: each of w, m, v
    elementwise at rtol/atol 1e-5 and at max-rel 1e-5 over the table; with
    flag 0, bit for bit equal to the inputs; g_x at max-rel 1e-5.  Returns
    the largest absolute error over the tables, g_x's and g_x's max-rel."""
    worst = 0.0
    for name, g, w_ in zip(("w", "m", "v") if kind == "adam" else ("w",), got[:-1], want[:-1]):
        if on == 0.0 and not (g == t[name]).all():
            raise AssertionError(f"K2-{kind} flag 0 changed {name} at {where}")
        diff = (g - w_).abs()
        if (diff - (K2_ATOL + K2_RTOL * w_.abs())).max().item() > 0:
            raise AssertionError(f"K2-{kind} {name} outside rtol/atol 1e-5 at {where} flag {on}")
        if diff.max().item() > K2_RTOL * w_.abs().max().item():
            raise AssertionError(f"K2-{kind} {name} max-rel above 1e-5 at {where} flag {on}")
        worst = max(worst, diff.max().item())
    gx_abs = (got[-1] - want[-1]).abs().max().item()
    gx_rel = gx_abs / want[-1].abs().max().item()
    if gx_rel > K2_GX_MAX_REL:
        raise AssertionError(f"K2-{kind} g_x max-rel {gx_rel:.3e} at {where}")
    return worst, gx_abs, gx_rel


def check_k2(torch, T, dev) -> dict:
    """Phase 3: K2 (Adam and SGD) vs its plain versions; errors, times, bounds."""
    gen = torch.Generator().manual_seed(1)
    err = {"adam": 0.0, "sgd": 0.0}
    for b, d, f in K2_SHAPES:
        t = _k2_case(torch, dev, gen, b, d, f)
        for on in (1.0, 0.0):
            flag = torch.tensor(on, device=dev)
            for kind, fns in _k2_calls(T, t, flag).items():
                got, want = fns["kernel"](), fns["plain"]()
                # g_x's partials are added in a fixed order (no atomics)
                same = all(torch.equal(a, g) for a, g in zip(fns["kernel"](), got))
                torch.cuda.synchronize()
                worst, gx_abs, gx_rel = compare_k2(kind, got, want, t, on, (b, d, f))
                err[kind] = max(err[kind], worst, gx_abs)
                log(f"[k2] {kind} B={b} D={d} F={f} flag={on:.0f}: tables max abs "
                    f"{worst:.3e}; g_x max abs {gx_abs:.3e}, max-rel {gx_rel:.3e}; "
                    f"repeat bit-equal {same}")
                if not same:
                    raise AssertionError(f"K2-{kind} differs between two calls at {(b, d, f)}")

    times, bounds = {}, {}
    for b, d, f in ((64, 300, 1400), (512, 300, 1416)):
        t = _k2_case(torch, dev, gen, b, d, f)
        fns = _k2_calls(T, t, torch.tensor(1.0, device=dev))
        if b == 64:
            counts = _k2_device_kernels(torch, {k: fns[k]["kernel"] for k in ("adam", "sgd")})
            for kind, n in counts.items():
                log(f"[k2] {kind} B={b}: one call issues {n} CUDA kernel(s) (torch.profiler)")
                if n != 1:
                    raise AssertionError(f"one K2-{kind} call issued {n} CUDA kernels, not 1")
        for kind in ("adam", "sgd"):
            tk = {k: _device_ms(torch, fn) for k, fn in fns[kind].items()}
            times.setdefault(kind, {})[b] = tk
            calls = {k: _call_ms(torch, fn) for k, fn in fns[kind].items()}
            tables = 3 if kind == "adam" else 1
            ops = 4 * b * d * f + K2_ELEMENTWISE_OPS[kind] * d * f
            nbytes = 4 * (2 * tables * d * f + b * f + 2 * b * d)
            bk = bounds.setdefault(kind, {})[b] = bound_ms(ops, nbytes)
            log(f"[k2] {kind} B={b} D={d} F={f}: device ms kernel {tk['kernel']:.4f} "
                f"plain {tk['plain']:.4f}; one call ms kernel {calls['kernel']:.4f} "
                f"plain {calls['plain']:.4f}; bound {bk[0]:.5f} ms ({bk[1]}: "
                f"{ops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB)")
    return {"err": err, "times": times, "bounds": bounds}


def _k2_device_kernels(torch, fns: dict) -> dict:
    """The CUDA kernels that one call of each of ``fns`` issues, as
    torch.profiler's device events count them.  All calls go through one
    profiler session (a second session in a process can record no device
    events), each call in its own ``record_function`` range that ends after
    a synchronise; a kernel belongs to the range its start falls in.  Raises
    where the profiler sees no device work at all (then it cannot tell)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns.values():
        fn()  # allocations and scratch of the first calls stay out of the count
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for kind, fn in fns.items():
            with record_function(f"k2_call_{kind}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith("k2_call_")]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device event for a K2 call: it "
                             "cannot count the call's kernels on this machine")
    counts = {}
    for kind in fns:
        span = next(e.time_range for e in events
                    if e.name == f"k2_call_{kind}" and e.device_type != cuda)
        names = [e.name for e in kernels if span.start <= e.time_range.start <= span.end]
        log(f"[k2] profiled device events of one {kind} call: {names}")
        counts[kind] = len(names)
    if sum(counts.values()) != len(kernels):
        raise AssertionError(f"{len(kernels)} device events, {counts} inside the calls' ranges")
    return counts


def _reset_launches(K, T) -> None:
    K.LAUNCHES.update(fwd=0, bwd=0)
    T.LAUNCHES.update(adam=0, sgd=0)


def _read_launches(K, T) -> dict:
    return {"k1_fwd": K.LAUNCHES["fwd"], "k1_bwd": K.LAUNCHES["bwd"],
            "k2_adam": T.LAUNCHES["adam"], "k2_sgd": T.LAUNCHES["sgd"]}


def smoke_config(e2e: bool) -> dict:
    """Grid config 0 with bench.py's fit settings (layer norm, lr 1e-4): as it
    stands (batch norm, lr 1e-3) it diverges to NaN within 3 epochs at MOSI
    width, in mmtpu as in the port.  Its likelihood weight is the grid's."""
    from mmtpu_torch.config import make_grid

    return dict(make_grid()[0], e2e=e2e, n_epochs=N_EPOCHS,
                n_sentiment_epochs=N_SENTIMENT_EPOCHS, norm="layer_norm", lr=1e-4)


def run_cli_path(torch, K, T, tmp: str, e2e: bool, flags=(), tag=None, **cfg_over) -> dict:
    """One MOSI run through ``mmtpu_torch.run.main`` (phases 4, 5, 8 and 9):
    the smoke config with ``cfg_over``, the CLI ``flags``."""
    import numpy as np

    import mmtpu_torch.runner as runner
    from mmtpu_torch.run import main

    tag = tag or ("e2e" if e2e else "non-e2e")
    cfg = dict(smoke_config(e2e), **cfg_over)
    cfg_path = os.path.join(tmp, f"config_{tag}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out_root = os.path.join(tmp, f"out_{tag}")
    data_dir = os.path.join(tmp, "data")  # empty: the synthetic full-size MOSI
    os.makedirs(data_dir, exist_ok=True)

    fits = []
    originals = {"fit_latents": runner.fit_latents, "fit_e2e": runner.fit_e2e}

    def timed(name, trains):  # times each fit and keeps its result; the run is unchanged
        def fit(init_embed, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](init_embed, *args, **kw)
            torch.cuda.synchronize()
            fits.append((int(init_embed.shape[0]), trains(args), time.perf_counter() - t0, out))
            return out
        return fit

    runner.fit_latents = timed("fit_latents", lambda args: args[-1].train_decoder)
    runner.fit_e2e = timed("fit_e2e", lambda args: True)
    _reset_launches(K, T)
    try:
        t0 = time.perf_counter()
        rc = main([cfg_path, "mosi", "--e2e", "y" if e2e else "n", "--device", "cuda",
                   "--out_root", out_root, "--data_dir", data_dir, *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        runner.fit_latents, runner.fit_e2e = originals["fit_latents"], originals["fit_e2e"]
    launches = _read_launches(K, T)
    if rc != 0:
        raise AssertionError(f"mmtpu_torch.run.main returned {rc}")

    folder = os.path.join(out_root, "mmtpu", f"config_{cfg['config_num']}_run_0")
    losses = np.loadtxt(os.path.join(folder, "embed_loss.txt"))
    post = np.load(os.path.join(folder, "post", "embed.npy"))
    if not os.path.isfile(os.path.join(folder, "post", "test_results_after.json")):
        raise AssertionError("post/test_results_after.json missing")
    if post.shape != (1284 + 229 + 686, 300):
        raise AssertionError(f"post/embed.npy has shape {post.shape}")
    if not (np.isfinite(losses).all() and np.isfinite(post).all()):
        raise AssertionError(f"non-finite loss or embeddings: losses {losses}")
    steps = N_EPOCHS * STEPS_PER_EPOCH
    for k in ("k1_fwd", "k1_bwd"):
        if launches[k] < steps:
            raise AssertionError(f"{k} launched {launches[k]} times in the {tag} path, "
                                 f"expected at least {steps}")
    train_s = sum(s for n, trains, s, _ in fits if trains)
    train_utt_s = 1284 * N_EPOCHS / train_s
    log(f"[{tag}] run.main wall {wall:.3f} s; train fit {train_s:.3f} s = "
        f"{train_utt_s:.1f} utt/s ({N_EPOCHS} epochs x 1284); fits "
        f"{[(n, round(s, 4)) for n, _, s, _ in fits]}; final loss {losses[-1]:.4f}; "
        f"launches {launches}")
    return {"launches": launches, "wall_s": wall, "train_utt_s": train_utt_s,
            "final_loss": float(losses[-1]), "post": post, "folder": folder,
            "train_fit": next(out for _, trains, _, out in fits if trains)}


def _e2e_inputs(torch, cfg: dict, data_dir: str, dev, kind: str) -> tuple:
    """The training fit's inputs of one run of ``cfg`` on ``dev``, with the
    draws of ``Draws(seed)``."""
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.convert import to_torch
    from mmtpu_torch.runner import Draws, build_hp, prepare
    from mmtpu_torch.train.latents import train_view

    ecfg = ExperimentConfig.from_dict(dict(cfg, optimizer=kind))
    prep = prepare(ecfg, data_dir)
    draws = Draws(ecfg.seed)
    move = lambda tree: {k: (move(v) if isinstance(v, dict) else v.to(dev))
                         for k, v in tree.items()}
    dec = move(draws.init_decoder(prep.embed_dim, prep.audio_dim, prep.visual_dim,
                                  ecfg.unimodal, prep.text_gauss_dim))
    labels = to_torch(prep.labels["train"], dev)
    sen = move(draws.init_e2e_sentiment(prep.embed_dim, ecfg.sentiment_hidden_size, 1))
    n = prep.sif_init["train"].shape[0]
    perms = draws.train_permutations(n, ecfg.n_epochs)
    hp = dict(build_hp(ecfg, dev), train_heads=torch.tensor(1.0, device=dev))
    return (to_torch(prep.sif_init["train"], dev), dec, sen,
            to_torch(train_view(prep.splits["train"]), dev), labels,
            to_torch(prep.vocab_embeddings, dev), hp, perms, ecfg)


def run_fused_path(torch, K, T, tmp: str) -> dict:
    """Phase 6: ``fit_e2e`` with and without the fused decoder update, SGD and
    Adam, same draws, at full MOSI width."""
    from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e

    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir, exist_ok=True)
    out = {}
    for kind in ("sgd", "adam"):
        emb0, dec, sen, data, labels, vocab, hp, perms, ecfg = _e2e_inputs(
            torch, smoke_config(True), data_dir, torch.device("cuda", 0), kind)
        res = {}
        for fused in (False, True):
            spec = E2EFitSpec(n_epochs_max=ecfg.n_epochs, batch_size=ecfg.batch_size,
                              unimodal=False, opt_kind=kind, fused_dec_update=fused)
            # one untimed epoch first: the first use of each kernel and each
            # GEMM shape in a process costs extra time once
            fit_e2e(emb0, dec, sen, data, labels, vocab, hp,
                    dataclasses.replace(spec, n_epochs_max=1), perms=perms[:1])
            torch.cuda.synchronize()
            _reset_launches(K, T)
            t0 = time.perf_counter()
            fit = fit_e2e(emb0, dec, sen, data, labels, vocab, hp, spec, perms=perms)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            res[fused] = {"fit": fit, "s": secs, "launches": _read_launches(K, T)}
        dense, fused = res[False]["fit"], res[True]["fit"]
        steps = ecfg.n_epochs * STEPS_PER_EPOCH
        got = res[True]["launches"][f"k2_{kind}"]
        if got != 2 * steps:
            raise AssertionError(f"K2-{kind} launched {got} times in the fused fit, "
                                 f"expected {2 * steps}")
        if res[False]["launches"][f"k2_{kind}"] != 0:
            raise AssertionError(f"K2-{kind} launched in the dense fit")
        for k in ("k1_fwd", "k1_bwd"):
            if res[True]["launches"][k] < steps:
                raise AssertionError(f"{k} launched {res[True]['launches'][k]} times in the "
                                     f"fused fit")
        loss_d, loss_f = float(dense[3][-1]), float(fused[3][-1])
        loss_rel = abs(loss_f - loss_d) / abs(loss_d)
        emb_delta = (fused[0] - dense[0]).abs().max().item()
        dec_delta = max((fused[1]["heads"][h][k] - dense[1]["heads"][h][k]).abs().max().item()
                        for h in dense[1]["heads"] for k in dense[1]["heads"][h])
        utt_s = {f: 1284 * ecfg.n_epochs / res[f]["s"] for f in (False, True)}
        log(f"[fused] {kind}: final loss dense {loss_d:.6f} fused {loss_f:.6f} (rel "
            f"{loss_rel:.3e}); max |delta| embeddings {emb_delta:.3e}, decoder "
            f"{dec_delta:.3e}; utt/s dense {utt_s[False]:.1f} fused {utt_s[True]:.1f}; "
            f"fused launches {res[True]['launches']}")
        if not (all(torch.isfinite(t).all() for t in (fused[0], fused[3])) and loss_rel < 1e-3):
            raise AssertionError(f"fused and dense e2e fits disagree ({kind})")
        out[kind] = {"launches": res[True]["launches"], "loss_rel": loss_rel,
                     "utt_s_dense": utt_s[False], "utt_s_fused": utt_s[True]}
    return out


def run_lazy_path(torch, K, T, tmp: str) -> dict:
    """Phase 8: lazy Adam at full MOSI width.  The e2e run through
    ``run.main`` on an Adam config with and without ``--lazy_adam`` (same
    draws), held to each other at the lazy tolerance; then ``fit_e2e`` with
    the fused decoder update and lazy Adam, which must launch K2-adam twice
    per step and end on the lazy run's training loss (the fused check's
    tolerance)."""
    import numpy as np

    from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e

    dense = run_cli_path(torch, K, T, tmp, True, tag="e2e-adam", optimizer="adam")
    lazy = run_cli_path(torch, K, T, tmp, True, ["--lazy_adam"], tag="e2e-adam-lazy",
                        optimizer="adam")
    loss_rel = abs(lazy["final_loss"] - dense["final_loss"]) / abs(dense["final_loss"])
    emb_abs = float(np.abs(lazy["post"] - dense["post"]).max())
    log(f"[lazy] e2e Adam run.main, lazy against dense: final loss rel {loss_rel:.3e}, post "
        f"embeddings max abs {emb_abs:.3e}; train fit utt/s dense {dense['train_utt_s']:.1f} "
        f"lazy {lazy['train_utt_s']:.1f}")
    if not (loss_rel < LAZY_LOSS_RTOL and emb_abs < LAZY_EMB_ATOL):
        raise AssertionError("the lazy-Adam run disagrees with the dense one")

    data_dir = os.path.join(tmp, "data")
    emb0, dec, sen, data, labels, vocab, hp, perms, ecfg = _e2e_inputs(
        torch, smoke_config(True), data_dir, torch.device("cuda", 0), "adam")
    spec = E2EFitSpec(n_epochs_max=ecfg.n_epochs, batch_size=ecfg.batch_size, unimodal=False,
                      opt_kind="adam", fused_dec_update=True, lazy_adam=True)
    fit_e2e(emb0, dec, sen, data, labels, vocab, hp, dataclasses.replace(spec, n_epochs_max=1),
            perms=perms[:1])  # untimed warm-up epoch
    torch.cuda.synchronize()
    _reset_launches(K, T)
    t0 = time.perf_counter()
    fit = fit_e2e(emb0, dec, sen, data, labels, vocab, hp, spec, perms=perms)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_launches(K, T)
    steps = ecfg.n_epochs * STEPS_PER_EPOCH
    if launches["k2_adam"] != 2 * steps or launches["k2_sgd"] != 0:
        raise AssertionError(f"the fused lazy fit launched K2 {launches}, expected "
                             f"{2 * steps} K2-adam")
    if min(launches["k1_fwd"], launches["k1_bwd"]) < steps:
        raise AssertionError(f"K1 launched {launches} times in the fused lazy fit")
    fused_rel = abs(float(fit[3][-1]) - lazy["final_loss"]) / abs(lazy["final_loss"])
    utt_s = 1284 * ecfg.n_epochs / secs
    log(f"[lazy] fused + lazy e2e fit: final loss rel {fused_rel:.3e} against the lazy run; "
        f"{utt_s:.1f} utt/s; launches {launches}")
    if not (torch.isfinite(fit[0]).all() and fused_rel < 1e-3):
        raise AssertionError("the fused lazy e2e fit disagrees with the lazy run")
    return {"launches": {"e2e_adam": dense["launches"], "e2e_adam_lazy": lazy["launches"],
                         "fused_lazy_adam": launches},
            "loss_rel": loss_rel, "emb_abs": emb_abs, "fused_loss_rel": fused_rel,
            "utt_s_dense": dense["train_utt_s"], "utt_s_lazy": lazy["train_utt_s"],
            "utt_s_fused_lazy": utt_s}


def run_curve_and_resume(torch, K, T, tmp: str, non_e2e: dict) -> dict:
    """Phase 9: the non-e2e run through ``run.main`` with
    ``--validation_curve`` (phase 4's run plus two refits of the valid split,
    at epoch 0 and after the last); then the Adam training fit checkpointed
    one epoch per segment, killed after its first save, resumed, and held to
    the uninterrupted fit."""
    import numpy as np

    from mmtpu_torch.io.checkpoint import Checkpointer
    from mmtpu_torch.train.chunked import fit_latents_checkpointed
    from mmtpu_torch.train.latents import LatentFitSpec, fit_latents
    from mmtpu_torch.tree import tree_leaves

    run = run_cli_path(torch, K, T, tmp, False, ["--validation_curve"], tag="non-e2e-curve")
    curve = run["train_fit"][3].cpu().numpy()
    sampled = [True] + [False] * (N_EPOCHS - 1) + [True]
    if list(np.isfinite(curve)) != sampled:
        raise AssertionError(f"validation curve {curve}: samples expected at {sampled}")
    written = np.loadtxt(os.path.join(run["folder"], "embed_valid_loss.txt"))
    if written.shape != (2,) or not np.array_equal(written, curve[np.isfinite(curve)]):
        raise AssertionError(f"embed_valid_loss.txt holds {written}, the curve {curve}")
    refit_steps = 2 * N_EPOCHS * -(-229 // 512)
    for k in ("k1_fwd", "k1_bwd"):
        if run["launches"][k] - non_e2e["launches"][k] != refit_steps:
            raise AssertionError(f"{k}: {run['launches'][k]} launches with the curve, "
                                 f"{non_e2e['launches'][k]} without; expected {refit_steps} more")
    log(f"[curve] validation curve {curve.tolist()}; K1 launches {run['launches']} "
        f"(+{refit_steps} each for the refits)")

    emb0, dec, _, data, _, vocab, hp, perms, ecfg = _e2e_inputs(
        torch, smoke_config(False), os.path.join(tmp, "data"), torch.device("cuda", 0), "adam")
    spec = LatentFitSpec(n_epochs_max=ecfg.n_epochs, batch_size=ecfg.batch_size,
                         train_decoder=True, unimodal=False, opt_kind="adam")
    whole = fit_latents(emb0, dec, data, vocab, hp, spec, perms=perms)
    ck = Checkpointer(os.path.join(tmp, "resume"))
    save = ck.save

    def save_then_die(step, tree, extra=None):
        save(step, tree, extra)
        raise KeyboardInterrupt

    ck.save = save_then_die
    try:
        fit_latents_checkpointed(emb0, dec, data, vocab, hp, spec, checkpointer=ck,
                                 segment_epochs=1, perms=perms)
    except KeyboardInterrupt:
        pass
    else:
        raise AssertionError("the checkpointed fit went on past its first save")
    ck.save = save
    if ck.latest_step() != 1:
        raise AssertionError(f"checkpoint at epoch {ck.latest_step()}, expected 1")
    _reset_launches(K, T)
    t0 = time.perf_counter()
    resumed = fit_latents_checkpointed(emb0, dec, data, vocab, hp, spec, checkpointer=ck,
                                       segment_epochs=1, perms=perms)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_launches(K, T)
    if launches["k1_fwd"] != (N_EPOCHS - 1) * STEPS_PER_EPOCH:
        raise AssertionError(f"the resumed fit launched K1 {launches['k1_fwd']} times: "
                             f"it did not start at epoch 1")
    pairs = [(resumed[0], whole[0]), (resumed[2], whole[2])] + list(
        zip(tree_leaves(resumed[1]), tree_leaves(whole[1])))
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    emb_abs = (resumed[0] - whole[0]).abs().max().item()
    loss_rel = ((resumed[2] - whole[2]).abs() / whole[2].abs()).max().item()
    log(f"[resume] resumed at epoch 1 ({secs:.3f} s, launches {launches}); against the "
        f"uninterrupted fit: bit-equal {bit_equal}, embeddings max abs {emb_abs:.3e}, losses "
        f"max rel {loss_rel:.3e}")
    if not (emb_abs <= RESUME_ATOL and loss_rel <= RESUME_RTOL):
        raise AssertionError("the resumed fit disagrees with the uninterrupted one")
    return {"launches": {"validation_curve": run["launches"], "resumed": launches},
            "curve": [float(c) if np.isfinite(c) else None for c in curve],
            "bit_equal": bit_equal, "emb_abs": emb_abs, "loss_rel": loss_rel}


def sweep_configs() -> list:
    """The first ``SWEEP_K`` configs of the grid's Adam / 100-epoch bucket,
    their epochs cut to ``SWEEP_EPOCHS`` and ``SWEEP_SENTIMENT_EPOCHS``."""
    from mmtpu_torch.config import make_grid

    bucket = [c for c in make_grid() if c["optimizer"] == "adam" and c["n_epochs"] == 100]
    return [dict(c, n_epochs=SWEEP_EPOCHS, n_sentiment_epochs=SWEEP_SENTIMENT_EPOCHS)
            for c in bucket[:SWEEP_K]]


def run_sweep_chunk(torch, K, T, tmp: str) -> dict:
    """Phase 10: one sweep chunk at full MOSI width through ``run_chunk``,
    its K1 launches and row counts, K1 at those row counts against its plain
    versions, four configs run alone against the chunk, diverged configs."""
    import numpy as np

    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.sweep.runner import run_chunk, run_config_alone

    dev = torch.device("cuda", 0)
    configs = sweep_configs()
    k = len(configs)
    log(f"[sweep] {k} configs (grid numbers {[c['config_num'] for c in configs]}), depth cut: "
        f"n_epochs 100 -> {SWEEP_EPOCHS}, n_sentiment_epochs 400 -> {SWEEP_SENTIMENT_EPOCHS}")
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(load_dataset("mosi", data_dir=os.path.join(tmp, "data")),
                               pos_mode="shared", pos_dims=dims)
    n_train, n_valid, n_test = (prep.sif_init[s].shape[0] for s in ("train", "valid", "test"))

    rows = {"fwd": [], "bwd": []}
    wrapped = {"fwd": K.angular_fwd, "bwd": K.angular_bwd}

    def recording(kind):  # the rows of each call; the wrapper itself counts launches
        def call(lat, *args):
            rows[kind].append(int(lat.shape[0]))
            return wrapped[kind](lat, *args)
        return call

    K.angular_fwd, K.angular_bwd = recording("fwd"), recording("bwd")
    torch.cuda.synchronize(dev)  # the context exists before its statistics are reset
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches(K, T)
    try:
        t0 = time.perf_counter()
        chunk = run_chunk(configs, prep, batch_size=64, device=dev, return_embeddings=True)
        wall = time.perf_counter() - t0
    finally:
        K.angular_fwd, K.angular_bwd = wrapped["fwd"], wrapped["bwd"]
    launches = _read_launches(K, T)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    train_steps = SWEEP_EPOCHS * -(-n_train // 64)
    infer_steps = SWEEP_EPOCHS * (-(-n_valid // 512) + -(-n_test // 512))
    want_rows = [k * 64] * train_steps + [k * 512] * infer_steps
    log(f"[sweep] chunk of {k}: wall {wall:.3f} s, phases "
        f"{ {p: round(t, 3) for p, t in chunk.phase_s.items()} }; launches {launches}; K1 rows "
        f"per call: {sorted(set(rows['fwd']))}; peak memory {peak_gib:.2f} GiB")
    for kind in ("fwd", "bwd"):
        if launches[f"k1_{kind}"] != len(want_rows) or rows[kind] != want_rows:
            raise AssertionError(f"K1-{kind}: {launches[f'k1_{kind}']} launches at rows "
                                 f"{rows[kind]}, expected {len(want_rows)} ({train_steps} at "
                                 f"{k * 64}, {infer_steps} at {k * 512})")
    if launches["k2_adam"] or launches["k2_sgd"]:
        raise AssertionError(f"K2 launched in the chunk: {launches}")

    ok = ~chunk.diverged
    log(f"[sweep] diverged: {int(chunk.diverged.sum())} of {k} "
        f"{chunk.config_nums[chunk.diverged].tolist()}; final losses "
        f"{np.round(chunk.final_train_loss, 4).tolist()}")
    results = [chunk.embeddings[s] for s in ("train", "valid", "test")] + [
        chunk.predictions, chunk.final_train_loss]
    if not ok.any() or not all(np.isfinite(r[ok]).all() for r in results):
        raise AssertionError("a config that did not diverge has non-finite results")
    if any(np.isfinite(results[0][i]).all() and np.isfinite(results[-1][i])
           for i in np.nonzero(chunk.diverged)[0]):
        raise AssertionError("a finite config is reported diverged")

    # configs run alone: the first non-diverged config of each norm at each
    # learning rate.  All are held at the loss and prediction gates; the
    # embeddings at lr 1e-4 only.  Adam's first step moves a coordinate by
    # lr x sign(g), so where a gradient component is within rounding of zero
    # any two float orders of the same fit (the chunk's batched products and
    # K1's grid at K*B rows against one config's) move that coordinate apart
    # by up to a few lr: at lr 1e-3 a few coordinates of 660,000 differ by
    # 2e-3 to 3.3e-3 (PERF.md section 6), above a 2e-4 gate by nature.
    picks = [(next(i for i in range(k) if ok[i] and configs[i]["norm"] == norm
                   and configs[i]["lr"] == lr), lr == 1e-4)
             for lr in (1e-4, 1e-3) for norm in ("batch_norm", "layer_norm")]
    parity, alone_train_s = {}, []
    for i, emb_gated in picks:
        c = configs[i]
        alone = run_config_alone(c, prep, batch_size=64, device=dev)
        alone_train_s.append(alone.phase_s["train"])
        loss_rel = abs(alone.final_train_loss[0] - chunk.final_train_loss[i]) / abs(
            alone.final_train_loss[0])
        diffs = [np.abs(alone.embeddings[s][0] - chunk.embeddings[s][i])
                 for s in ("train", "valid", "test")]
        emb_abs = max(float(d.max()) for d in diffs)
        emb_over = sum(int((d > SWEEP_ATOL).sum()) for d in diffs)
        pred_abs = float(np.abs(alone.predictions[0] - chunk.predictions[i]).max())
        parity[int(c["config_num"])] = {"norm": c["norm"], "lr": c["lr"],
                                        "loss_rel": float(loss_rel), "emb_abs": emb_abs,
                                        "emb_over_atol": emb_over, "pred_abs": pred_abs}
        log(f"[sweep] config {c['config_num']} ({c['norm']}, lr {c['lr']}) alone against the "
            f"chunk: final loss rel {loss_rel:.3e}, embeddings max abs {emb_abs:.3e} ("
            f"{emb_over} of {sum(d.size for d in diffs)} above {SWEEP_ATOL}"
            f"{'' if emb_gated else ', not gated'}), test predictions max abs {pred_abs:.3e}")
        if not (loss_rel < SWEEP_RTOL and pred_abs < SWEEP_ATOL
                and (emb_abs < SWEEP_ATOL or not emb_gated)):
            raise AssertionError(f"config {c['config_num']} alone disagrees with the chunk")

    work = n_train * SWEEP_EPOCHS
    rate = k * work / chunk.phase_s["train"]
    single = work / statistics.median(alone_train_s)
    log(f"[sweep] train phase: {rate:.1f} config-utterance-epochs/s for the chunk; one config "
        f"alone {single:.1f}, x{k} = {k * single:.1f} (printed, not claimed)")

    gen = torch.Generator().manual_seed(3)
    k1 = {"times": {}, "bounds": {}, "fwd_err": 0.0, "bwd_err": 0.0}
    for b in (k * 64, k * 512):
        case = _k1_case(torch, dev, gen, b, 300, 3016)
        errs = _check_k1(torch, K, *case)
        k1["fwd_err"], k1["bwd_err"] = max(k1["fwd_err"], errs[0]), max(k1["bwd_err"], errs[1])
        k1["times"][b] = _k1_times(torch, K, *case, single_calls=False, reps=20)
        k1["bounds"][b] = _k1_bounds(b)
    return {"launches": launches, "wall_s": wall, "phase_s": chunk.phase_s,
            "peak_gib": peak_gib, "rate": rate, "single_rate": single, "parity": parity,
            "diverged": chunk.config_nums[chunk.diverged].tolist(), "k1": k1}


def check_small_agreement(torch) -> None:
    """Phase 7: small configs on the GPU (kernels) and on the CPU (plain
    versions) with the same draws must agree."""
    import numpy as np

    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.convert import to_torch
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.runner import Draws, build_hp, run_experiment
    from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e
    from mmtpu_torch.train.latents import train_view

    ds = synthesize_dataset("mosi", n_train=70, n_valid=20, n_test=30, vocab_size=200,
                            embed_dim=32, audio_dim=6, visual_dim=5)
    prep = prepare_device_data(ds, pos_embed_dim=2)
    for opt, norm, lr in (("sgd", "batch_norm", 1e-4), ("adam", "layer_norm", 1e-3)):
        cfg = ExperimentConfig(dataset="mosi", n_epochs=2, n_sentiment_epochs=3, batch_size=16,
                               e2e=False, norm=norm, optimizer=opt, lr=lr, config_name="agree")
        with tempfile.TemporaryDirectory() as tmp:
            res = {dev: run_experiment(cfg, out_root=os.path.join(tmp, dev), prep=prep,
                                       verbose=False, device=dev) for dev in ("cuda", "cpu")}
            emb = {dev: np.load(os.path.join(tmp, dev, "agree", "config_0_run_0", "post",
                                             "embed.npy")) for dev in res}
        loss_rel = abs(res["cuda"]["final_train_loss"] - res["cpu"]["final_train_loss"]) / abs(
            res["cpu"]["final_train_loss"])
        emb_abs = float(np.abs(emb["cuda"] - emb["cpu"]).max())
        log(f"[agree] {opt}/{norm} GPU vs CPU: final loss rel {loss_rel:.3e}, post "
            f"embeddings max abs {emb_abs:.3e}")
        # the CPU parity tests' tolerances (mmtpu vs the port)
        if not (np.isfinite(res["cpu"]["final_train_loss"]) and loss_rel < 2e-4
                and emb_abs < 2e-4):
            raise AssertionError(f"GPU and CPU runs disagree ({opt}/{norm})")

    # the fused e2e fit, semi-supervised, with the same draws on both devices
    n = prep.sif_init["train"].shape[0]
    smask = (np.arange(n) % 3 != 0).astype(np.float32)
    for opt, norm in (("sgd", "batch_norm"), ("adam", "layer_norm")):
        cfg = ExperimentConfig(dataset="mosi", n_epochs=2, batch_size=16, norm=norm,
                               optimizer=opt, lr=1e-3, likelihood_weight=0.3)
        fits = {}
        for dev in ("cuda", "cpu"):
            draws = Draws(1)
            move = lambda tree: {k: (move(v) if isinstance(v, dict) else v.to(dev))
                                 for k, v in tree.items()}
            dec = move(draws.init_decoder(prep.embed_dim, prep.audio_dim, prep.visual_dim,
                                          False, prep.text_gauss_dim))
            sen = move(draws.init_e2e_sentiment(prep.embed_dim, 8, 1))
            spec = E2EFitSpec(n_epochs_max=2, batch_size=16, unimodal=False, opt_kind=opt,
                              fused_dec_update=True)
            fits[dev] = fit_e2e(to_torch(prep.sif_init["train"], dev), dec, sen,
                                to_torch(train_view(prep.splits["train"]), dev),
                                to_torch(prep.labels["train"], dev),
                                to_torch(prep.vocab_embeddings, dev), build_hp(cfg, dev), spec,
                                senti_mask=to_torch(smask, dev),
                                perms=draws.train_permutations(n, 2))
        loss = {dev: float(f[3][-1]) for dev, f in fits.items()}
        loss_rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        emb_abs = (fits["cuda"][0].cpu() - fits["cpu"][0]).abs().max().item()
        log(f"[agree] fused e2e {opt}/{norm} GPU vs CPU: final loss rel {loss_rel:.3e}, "
            f"embeddings max abs {emb_abs:.3e}")
        if not (np.isfinite(loss["cpu"]) and loss_rel < 2e-4 and emb_abs < 2e-4):
            raise AssertionError(f"GPU and CPU fused e2e fits disagree ({opt}/{norm})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import mmtpu_torch.kernels.angular as K
    import mmtpu_torch.kernels.decoder_update as T
    from mmtpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = build.load()
    occupancy = {f"{kind} D={d}": getattr(lib, f"angular_{kind}_blocks_per_sm")(d)
                 for kind in ("fwd", "bwd") for d in (300, 512)}
    k2_occupancy = {kind: lib.dec_update_blocks_per_sm(int(kind == "adam"))
                    for kind in ("adam", "sgd")}
    log(f"[build] kernel library built and loaded in {time.perf_counter() - t0:.2f} s; "
        f"K1 resident blocks per SM: {occupancy}; K2 resident blocks per SM (D = 300 and "
        f"any D): {k2_occupancy}")

    k1 = check_kernels(torch, K, dev)
    k2 = check_k2(torch, T, dev)
    with tempfile.TemporaryDirectory() as tmp:
        non_e2e = run_cli_path(torch, K, T, tmp, e2e=False)
        e2e = run_cli_path(torch, K, T, tmp, e2e=True)
        fused = run_fused_path(torch, K, T, tmp)
        lazy = run_lazy_path(torch, K, T, tmp)
        resume = run_curve_and_resume(torch, K, T, tmp, non_e2e)
        sweep = run_sweep_chunk(torch, K, T, tmp)
    check_small_agreement(torch)

    t, kb = k1["times"], k1["bounds"]
    st, sb = sweep["k1"]["times"], sweep["k1"]["bounds"]
    by_path = {"non_e2e": non_e2e["launches"], "e2e": e2e["launches"],
               "fused_sgd": fused["sgd"]["launches"], "fused_adam": fused["adam"]["launches"],
               **lazy["launches"], **resume["launches"], "sweep_chunk": sweep["launches"]}
    k1_path = {"fwd": e2e["launches"]["k1_fwd"], "bwd": e2e["launches"]["k1_bwd"]}
    record = {"kernels": [
        {"name": f"K1-{kind} angular_partition", "route": "cuda", "source": source,
         "replaces": f"mmtpu/kernels/angular.py:{line}",
         "launches": k1_path[kind], "max_abs_err": k1[f"{kind}_err"],
         "ms": t[64][kind], "plain_ms": t[64][f"{kind}_plain"],
         "bound_ms": kb[64][kind][0], "bound_by": kb[64][kind][1], "library_ms": None,
         "ms_b64": t[64][kind], "bound_ms_b64": kb[64][kind][0],
         "ms_b512": t[512][kind], "plain_ms_b512": t[512][f"{kind}_plain"],
         "bound_ms_b512": kb[512][kind][0], "bound_by_b512": kb[512][kind][1],
         "launches_sweep_chunk": sweep["launches"][f"k1_{kind}"],
         "max_abs_err_sweep_rows": sweep["k1"][f"{kind}_err"],
         **{f"{key}_b{b}": val for b in st for key, val in (
             ("ms", st[b][kind]), ("plain_ms", st[b][f"{kind}_plain"]),
             ("bound_ms", sb[b][kind][0]), ("bound_by", sb[b][kind][1]))}}
        for kind, line, source in (("fwd", 171, "mmtpu_torch/csrc/angular.cu"),
                                   ("bwd", 199, "mmtpu_torch/csrc/angular_bwd.cu"))
    ] + [
        {"name": f"K2-{kind} fused_gemm_{kind}_update", "route": "cuda",
         "source": "mmtpu_torch/csrc/decoder_update.cu",
         "replaces": f"mmtpu/kernels/decoder_update.py:{line}",
         "launches": fused[kind]["launches"][f"k2_{kind}"], "max_abs_err": k2["err"][kind],
         "ms": k2["times"][kind][64]["kernel"], "plain_ms": k2["times"][kind][64]["plain"],
         "bound_ms": k2["bounds"][kind][64][0], "bound_by": k2["bounds"][kind][64][1],
         "library_ms": None,
         "ms_b64": k2["times"][kind][64]["kernel"], "bound_ms_b64": k2["bounds"][kind][64][0],
         "ms_b512": k2["times"][kind][512]["kernel"],
         "plain_ms_b512": k2["times"][kind][512]["plain"],
         "bound_ms_b512": k2["bounds"][kind][512][0],
         "bound_by_b512": k2["bounds"][kind][512][1]}
        for kind, line in (("adam", 166), ("sgd", 210))
    ], "launches_by_path": by_path,
        "paths": {"non_e2e": {k: non_e2e[k] for k in ("wall_s", "train_utt_s", "final_loss")},
                  "e2e": {k: e2e[k] for k in ("wall_s", "train_utt_s", "final_loss")},
                  "fused": {k: {m: v[m] for m in ("loss_rel", "utt_s_dense", "utt_s_fused")}
                            for k, v in fused.items()},
                  "lazy": {k: v for k, v in lazy.items() if k != "launches"},
                  "curve_and_resume": {k: v for k, v in resume.items() if k != "launches"},
                  "sweep_chunk": {k: v for k, v in sweep.items() if k not in ("launches", "k1")}},
        "card": smi}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
