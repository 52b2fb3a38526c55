#!/usr/bin/env python3
"""Device time of the port's K1 kernels (``mmtpu_torch/csrc/angular.cu``,
the forward, and ``angular_bwd.cu``, the backward) for each vocabulary chunk
size, at the train (64) and inference (512) batch against the MOSI
vocabulary (3016 rows, ``--depth`` wide, 300 by default); then the forward
against its plain version over a range of row counts.  On one CUDA card.

    python3 scripts/torch_k1_grid.py [--depth 300] [--tpc 1,2,3,4,6,8,12,24]
                                     [--rows 8,16,32,64,128,256,512,2048]
    python3 scripts/torch_k1_grid.py --wrappers [--depth 300] [--root DIR]
                                     [--rows 64,512,2048,16384]

The card's name and power limit, then one JSON object per line (with
``--wrappers``, each after chip_smoke.py's ``[k1] bound`` line).  Per chunk
size: kernel, rows, tiles per chunk, chunks, blocks, device ms per call (CUDA events over bursts queued behind a
GPU-side sleep, as chip_smoke.py times), the largest difference from the
wrapper's result, and whether the grid is the wrapper's own (``fwd_grid`` /
``bwd_grid``).  Per row count: the forward wrapper's and the plain version's
device ms.  With ``--wrappers`` it times only the public wrappers of both
kernels and their plain versions at ``--rows``, beside each kernel's bound
(chip_smoke.py's ``_k1_bounds``), importing ``mmtpu_torch`` and
``chip_smoke`` from ``--root`` (default: this checkout), so that two trees
(a parent and a change, each unpacked with ``git archive``) are timed by
the same script.  It records times and routes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 3016
# burst lengths per row count for --wrappers (chip_smoke.py's at 16384 rows)
REPS = {16384: 5, 2048: 20}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_grid: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=300)
    ap.add_argument("--tpc", default="1,2,3,4,6,8,12,24")
    ap.add_argument("--rows", default=None)
    ap.add_argument("--wrappers", action="store_true")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    d = args.depth
    sys.path.insert(0, os.path.abspath(args.root))
    import mmtpu_torch.kernels.angular as K
    from chip_smoke import _device_ms, _k1_bounds
    from mmtpu_torch.kernels.build import check_launch, load

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)

    def inputs(b):
        lat = torch.randn(b, d, generator=gen).to(dev)
        voc = torch.randn(V, d, generator=gen).to(dev)
        voc = voc / torch.linalg.vector_norm(voc, dim=-1, keepdim=True)
        g = torch.randn(b, 1, generator=gen).to(dev)
        return lat, voc, torch.linalg.vector_norm(voc, dim=-1), g

    if args.wrappers:
        for b in (int(x) for x in (args.rows or "64,512,2048,16384").split(",")):
            lat, voc, vn, g = inputs(b)
            reps = REPS.get(b, 100)
            bounds = _k1_bounds(b, d)
            row = {"root": args.root, "b": b, "d": d, "v": V}
            for kind, kernel, plain in (
                    ("fwd", lambda: K.angular_fwd(lat, voc, vn),
                     lambda: K.angular_partition_ref(lat, voc)),
                    ("bwd", lambda: K.angular_bwd(lat, voc, vn, g),
                     lambda: K.angular_partition_bwd_ref(lat, voc, vn, g))):
                row.update({f"{kind}_ms": _device_ms(torch, kernel, reps=reps),
                            f"{kind}_plain_ms": _device_ms(torch, plain, reps=reps),
                            f"{kind}_bound_ms": bounds[kind][0],
                            f"{kind}_bound_by": bounds[kind][1]})
            print(json.dumps(row), flush=True)
        return 0

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    bm, bv = lib.angular_row_tile(), lib.angular_vocab_tile()
    n_sub = -(-V // bv)
    occ = {k: getattr(lib, f"angular_{k}_blocks_per_sm")(d) for k in ("fwd", "bwd")}
    slices = lib.angular_bwd_depth_slices(d)
    print(json.dumps({"sm": sm, "d": d, "blocks_per_sm": occ, "bwd_depth_slices": slices}),
          flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    for b in (64, 512):
        lat, voc, vn, g = inputs(b)
        n_rt = -(-b // bm)
        cases = {"fwd": (K.fwd_grid(b, V, bm, bv, sm, occ["fwd"]), K.angular_fwd(lat, voc, vn)),
                 "bwd": (K.bwd_grid(b, V, bm, bv, sm, occ["bwd"], slices),
                         K.angular_bwd(lat, voc, vn, g))}
        for kind, (default, want) in cases.items():
            for tpc in sorted({int(x) for x in args.tpc.split(",")} | {default[1]}):
                chunks = -(-n_sub // tpc)
                if kind == "fwd":
                    partial = torch.empty(chunks, b, device=dev)
                    tickets = torch.zeros(n_rt, dtype=torch.int32, device=dev)
                    out = torch.empty(b, 1, device=dev)

                    def call():
                        check_launch(lib, "angular_fwd", lib.angular_fwd(
                            lat.data_ptr(), voc.data_ptr(), vn.data_ptr(), partial.data_ptr(),
                            tickets.data_ptr(), out.data_ptr(), b, V, d, chunks, tpc, stream))
                else:
                    partial = torch.empty(chunks, b, -(-d // 4) * 4, device=dev)
                    out = torch.empty(b, d, device=dev)

                    def call():
                        check_launch(lib, "angular_bwd", lib.angular_bwd(
                            lat.data_ptr(), voc.data_ptr(), vn.data_ptr(), g.data_ptr(),
                            partial.data_ptr(), out.data_ptr(), b, V, d, chunks, tpc, stream))

                ms = _device_ms(torch, call)
                blocks = n_rt * chunks * (slices if kind == "bwd" else 1)
                row = {"kernel": kind, "b": b, "d": d, "tpc": tpc, "chunks": chunks,
                       "blocks": blocks, "ms": ms,
                       "max_abs_vs_wrapper": (out - want).abs().max().item(),
                       "wrapper_grid": (chunks, tpc) == default}
                print(json.dumps(row), flush=True)

    for b in (int(x) for x in (args.rows or "8,16,32,64,128,256,512,2048").split(",")):
        lat, voc, vn, _ = inputs(b)
        row = {"kernel": "fwd", "b": b, "d": d,
               "grid": K.fwd_grid(b, V, bm, bv, sm, occ["fwd"]),
               "ms": _device_ms(torch, lambda: K.angular_fwd(lat, voc, vn)),
               "plain_ms": _device_ms(torch, lambda: K.angular_partition_ref(lat, voc))}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
