#!/usr/bin/env python3
"""Device time of the port's K1 backward (``mmtpu_torch/csrc/angular_bwd.cu``)
for each vocabulary chunk size, at the train (64) and inference (512) batch
against the MOSI vocabulary (3016 x 300), on one CUDA card.

    python3 scripts/torch_k1_bwd_grid.py [--tpc 1,2,3,4,6,8,12,24]

Each line: rows, tiles per chunk, chunks, blocks, device ms per call (CUDA
events over bursts queued behind a GPU-side sleep, as chip_smoke.py times),
and whether the result equals the wrapper's bit for bit where the grid is
the wrapper's own (``bwd_grid``), one JSON object per line.  The plain
version's time is printed beside each batch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_bwd_grid: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import mmtpu_torch.kernels.angular as K
    from chip_smoke import _device_ms
    from mmtpu_torch.kernels.build import check_launch, load

    ap = argparse.ArgumentParser()
    ap.add_argument("--tpc", default="1,2,3,4,6,8,12,24")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = load()
    dev = torch.device("cuda", 0)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    bm, bv = lib.angular_bwd_row_tile(), lib.angular_bwd_vocab_tile()
    gen = torch.Generator().manual_seed(3)
    for b in (64, 512):
        d, v = 300, 3016
        lat = torch.randn(b, d, generator=gen).to(dev)
        voc = torch.randn(v, d, generator=gen).to(dev)
        voc = voc / torch.linalg.vector_norm(voc, dim=-1, keepdim=True)
        vn = torch.linalg.vector_norm(voc, dim=-1)
        g = torch.randn(b, 1, generator=gen).to(dev)
        want = K.angular_bwd(lat, voc, vn, g)
        plain = _device_ms(torch, lambda: K.angular_partition_bwd_ref(lat, voc, vn, g))
        default = K.bwd_grid(b, v, bm, bv, sm)
        n_sub = -(-v // bv)
        print(f"B={b}: wrapper grid (chunks, tpc) {default}; plain {plain:.4f} ms", flush=True)
        for tpc in sorted({int(x) for x in args.tpc.split(",")} | {default[1]}):
            chunks = -(-n_sub // tpc)
            d4p = -(-d // 4) * 4
            partial = torch.empty(chunks, b, d4p, device=dev)
            out = torch.empty(b, d, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = lib.angular_bwd(lat.data_ptr(), voc.data_ptr(), vn.data_ptr(), g.data_ptr(),
                                      partial.data_ptr(), out.data_ptr(), b, v, d, chunks, tpc,
                                      stream)
                check_launch(lib, "angular_bwd", err)

            ms = _device_ms(torch, call)
            err = (out - want).abs().max().item()
            row = {"b": b, "tpc": tpc, "chunks": chunks, "blocks": -(-b // bm) * chunks,
                   "ms": ms, "plain_ms": plain, "max_abs_vs_wrapper": err,
                   "wrapper_grid": (chunks, tpc) == default}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
