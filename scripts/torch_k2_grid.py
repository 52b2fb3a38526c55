#!/usr/bin/env python3
"""Device time of the port's K2 kernel (``mmtpu_torch/csrc/decoder_update.cu``,
the fused decoder update, Adam and SGD) for each number of F sub-tiles per
chunk, at the train batch (64 rows, F = 1400) and the inference batch (512
rows, F = 1416) at D = 300.  On one CUDA card.

    python3 scripts/torch_k2_grid.py [--tpc 1,2,3,4,6,8,12,23]
    python3 scripts/torch_k2_grid.py --wrappers [--root DIR]

One JSON object per line.  Per chunk size: kind, rows, tiles per chunk,
chunks, blocks, device ms per call (CUDA events over bursts queued behind a
GPU-side sleep, as chip_smoke.py times), the largest difference from the
wrapper's result, and whether the grid is the wrapper's own.  With
``--wrappers`` it times only the public wrappers and their plain versions at
both shapes, importing ``mmtpu_torch`` and ``chip_smoke`` from ``--root``
(default: this checkout), so that two trees (a parent and a change, each
unpacked with ``git archive``) are timed by the same script.  It records
times and routes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 300
SHAPES = ((64, 1400), (512, 1416))


def inputs(torch, dev, b, f):
    """chip_smoke.py's K2 inputs: every output table far above 1e-5."""
    gen = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=gen)
    t = {"w": 0.05 * r(D, f), "m": 0.1 * r(D, f), "v": 0.01 * (1.0 + r(D, f).abs()),
         "x": r(b, D), "g_z": r(b, f) / b ** 0.5}
    t = {k: a.to(dev) for k, a in t.items()}
    for k, val in (("lr", 1e-3), ("bc1", 1.0 - 0.9 ** 5), ("bc2", 1.0 - 0.999 ** 5),
                   ("flag", 1.0)):
        t[k] = torch.tensor(val, device=dev)
    return t


def wrapper_calls(T, t):
    return {"adam": (lambda: T.fused_gemm_adam_update(t["w"], t["m"], t["v"], t["x"], t["g_z"],
                                                      t["lr"], t["bc1"], t["bc2"], t["flag"]),
                     lambda: T.reference_adam(t["w"], t["m"], t["v"], t["x"], t["g_z"],
                                              t["lr"], t["bc1"], t["bc2"], t["flag"])),
            "sgd": (lambda: T.fused_gemm_sgd_update(t["w"], t["x"], t["g_z"], t["lr"],
                                                    t["flag"]),
                    lambda: T.reference_sgd(t["w"], t["x"], t["g_z"], t["lr"], t["flag"]))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_grid: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--tpc", default="1,2,3,4,6,8,12,23")
    ap.add_argument("--wrappers", action="store_true")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import mmtpu_torch.kernels.decoder_update as T
    from chip_smoke import _device_ms
    from mmtpu_torch.kernels.build import check_launch, load

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = load()

    if args.wrappers:
        for b, f in SHAPES:
            t = inputs(torch, dev, b, f)
            for kind, (kernel, plain) in wrapper_calls(T, t).items():
                print(json.dumps({"root": args.root, "kind": kind, "b": b, "d": D, "f": f,
                                  "ms": _device_ms(torch, kernel),
                                  "plain_ms": _device_ms(torch, plain)}), flush=True)
        return 0

    from mmtpu_torch.kernels.angular import fwd_grid
    from mmtpu_torch.kernels.build import sm_count

    sm = sm_count(0)
    dt, ft, bb = lib.dec_update_d_tile(), lib.dec_update_f_tile(), lib.dec_update_batch_chunk()
    occ = {k: lib.dec_update_blocks_per_sm(int(k == "adam")) for k in ("adam", "sgd")}
    print(json.dumps({"sm": sm, "d_tile": dt, "f_tile": ft, "batch_chunk": bb,
                      "blocks_per_sm": occ}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    n_dt = -(-D // dt)
    for b, f in SHAPES:
        t = inputs(torch, dev, b, f)
        n_sub = -(-f // ft)
        regions = n_dt * -(-b // bb)
        tickets = torch.zeros(regions, dtype=torch.int32, device=dev)
        for kind, (kernel, _) in wrapper_calls(T, t).items():
            want = kernel()
            default = fwd_grid(D, f, dt, ft, sm, occ[kind])
            for tpc in sorted({min(int(x), n_sub) for x in args.tpc.split(",")} | {default[1]}):
                chunks = -(-n_sub // tpc)
                partial = torch.empty(regions * chunks * bb * dt, device=dev)
                out = [torch.empty_like(a) for a in want]
                tail = (partial.data_ptr(), tickets.data_ptr(), out[-1].data_ptr(), b, D, f,
                        chunks, tpc, stream)
                sc = [a for k in (("lr", "bc1", "bc2", "flag") if kind == "adam"
                                  else ("lr", "flag")) for a in (t[k].data_ptr(), 0.0)]

                if kind == "adam":
                    def call():
                        check_launch(lib, "dec_update_adam", lib.dec_update_adam(
                            t["x"].data_ptr(), t["g_z"].data_ptr(), t["w"].data_ptr(),
                            t["m"].data_ptr(), t["v"].data_ptr(), *sc, out[0].data_ptr(),
                            out[1].data_ptr(), out[2].data_ptr(), *tail))
                else:
                    def call():
                        check_launch(lib, "dec_update_sgd", lib.dec_update_sgd(
                            t["x"].data_ptr(), t["g_z"].data_ptr(), t["w"].data_ptr(), *sc,
                            out[0].data_ptr(), *tail))

                ms = _device_ms(torch, call)
                diff = max((a - g).abs().max().item() for a, g in zip(out, want))
                print(json.dumps({"kind": kind, "b": b, "f": f, "tpc": tpc, "chunks": chunks,
                                  "blocks": n_dt * chunks, "ms": ms,
                                  "max_abs_vs_wrapper": diff,
                                  "wrapper_grid": (chunks, tpc) == default}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
