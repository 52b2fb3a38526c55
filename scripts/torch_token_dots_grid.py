#!/usr/bin/env python3
"""Device time of the port's token kernels (``mmtpu_torch/csrc/token_dots.cu``:
each token's word vector read by id, forward dots and latent gradient)
against their plain twins (blocked gather and ``bmm`` / ``baddbmm``,
``mmtpu_torch/ops/wordprob.py``) at the shapes of the sweep's fits: POM's
training step (2048 rows of M = 1 latent, 1357 tokens, V = 9206), its
inference fits (203 and 100 rows of M = 32 configs), and MOSI's 20-token
rows (V = 3016).  On one CUDA card.

    python3 scripts/torch_token_dots_grid.py [--cases pom_train,pom_infer_test,...]
    python3 scripts/torch_token_dots_grid.py --tiles [--cases pom_train]

The card's name and power limit, then one JSON object per case: the tile
parameters (``fwd_tiles``, ``bwd_tiles``), device ms per call of each kernel
and each twin (CUDA events over bursts queued behind a GPU-side sleep, as
chip_smoke.py times), each kernel's bound (chip_smoke.py's ``bound_ms``:
float32 operations against each input and output byte read or written once),
the word-vector bytes the kernel reads from L2 over its time, and the largest
difference from the twin.  With ``--tiles`` it times the kernels' entry
points at other tile parameters beside the wrappers' own.  It records times
and routes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# rows, latents per row, tokens per row, vocabulary rows, depth
CASES = {
    "pom_train": (2048, 1, 1357, 9206, 300),
    "pom_infer_test": (203, 32, 1357, 9206, 300),
    "pom_infer_valid": (100, 32, 1357, 9206, 300),
    "mosi_train": (2048, 1, 20, 3016, 300),
    "mosi_infer_test": (512, 32, 20, 3016, 300),
}


def _inputs(torch, dev, rows, m, n_tok, v, d):
    """Normal latents and cotangent, a unit-norm vocabulary and ids whose
    second half is the padding id 0, as the benchmark's rows."""
    gen = torch.Generator().manual_seed(3)
    lat = torch.randn(rows, m, d, generator=gen)
    voc = torch.randn(v, d, generator=gen)
    voc = voc / torch.linalg.vector_norm(voc, dim=-1, keepdim=True)
    ids = torch.randint(1, v, (rows, n_tok), generator=gen)
    ids[:, n_tok // 2:] = 0
    g = torch.randn(rows, m, n_tok, generator=gen)
    return lat.to(dev), voc.to(dev), ids.to(dev), g.to(dev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_token_dots_grid: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--tiles", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import mmtpu_torch.kernels.token_dots as TD
    from chip_smoke import _device_ms, bound_ms
    from mmtpu_torch.kernels.build import check_launch, load
    from mmtpu_torch.ops.wordprob import token_dots_plain, token_dots_plain_bwd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = load()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in args.cases.split(","):
        rows, m, n_tok, v, d = CASES[name]
        lat, voc, ids, g = _inputs(torch, dev, rows, m, n_tok, v, d)
        reps = 20 if rows * m * n_tok > 1 << 20 else 100
        dots, glat = TD.token_dots_fwd(lat, voc, ids), TD.token_dots_bwd(g, voc, ids)
        ops = 2.0 * rows * m * n_tok * d
        io = 4.0 * (v * d + rows * m * d + rows * m * n_tok) + ids.element_size() * rows * n_tok
        row = {"case": name, "rows": rows, "m": m, "n_tok": n_tok, "v": v, "d": d,
               "fwd_tiles": TD.fwd_tiles(m, n_tok, rows, sms),
               "bwd_tiles": TD.bwd_tiles(m, d // 4, n_tok, rows, sms)}
        for kind, kernel, twin, want in (
                ("fwd", lambda: TD.token_dots_fwd(lat, voc, ids),
                 lambda: token_dots_plain(lat, voc, ids), dots),
                ("bwd", lambda: TD.token_dots_bwd(g, voc, ids),
                 lambda: token_dots_plain_bwd(g, voc, ids), glat)):
            ms = _device_ms(torch, kernel, reps=reps)
            bound = bound_ms(ops, io)
            row.update({f"{kind}_ms": ms, f"{kind}_twin_ms": _device_ms(torch, twin, reps=reps),
                        f"{kind}_bound_ms": bound[0], f"{kind}_bound_by": bound[1],
                        f"{kind}_vector_tb_per_s": 4.0 * rows * n_tok * d / ms / 1e9,
                        f"{kind}_max_abs_vs_twin": (want - twin()).abs().max().item()})
        print(json.dumps(row), flush=True)
        if not args.tiles:
            continue
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty(rows, m, n_tok, device=dev)
        gl = torch.empty(rows, m, d, device=dev)
        mt = TD.m_tile(m)
        for ks_log2 in range(1, 6):
            for passes in (1, 2, 4, 8):
                def fwd():
                    check_launch(lib, "token_dots_fwd", lib.token_dots_fwd(
                        lat.data_ptr(), lat.stride(0), lat.stride(1), voc.data_ptr(),
                        ids.data_ptr(), 1, out.data_ptr(), out.stride(0), out.stride(1), rows,
                        m, n_tok, d, v, 1, mt, ks_log2, passes, stream))
                ms = _device_ms(torch, fwd, reps=reps)
                print(json.dumps({"case": name, "kernel": "fwd", "ks_log2": ks_log2,
                                  "passes": passes, "ms": ms,
                                  "max_abs_vs_wrapper": (out - dots).abs().max().item(),
                                  "wrapper_tiles": (mt, ks_log2, passes) == row["fwd_tiles"]}),
                      flush=True)
        for cw in sorted({row["bwd_tiles"][1], 75, 38, 25, 19, 15, 13, 10}):
            threads = mt // TD._BWD_TILE[mt] * cw  # of one token slice
            for ts in sorted({1, 2, 3, 4, 6, 8, 10, TD.THREADS // threads}):
                if ts < 1 or ts * threads > TD.THREADS:
                    continue

                def bwd():
                    check_launch(lib, "token_dots_bwd", lib.token_dots_bwd(
                        g.data_ptr(), g.stride(0), g.stride(1), voc.data_ptr(), ids.data_ptr(),
                        1, gl.data_ptr(), gl.stride(0), gl.stride(1), rows, m, n_tok, d, v, 1,
                        mt, cw, ts, stream))
                ms = _device_ms(torch, bwd, reps=reps)
                print(json.dumps({"case": name, "kernel": "bwd", "cw": cw, "ts": ts, "ms": ms,
                                  "max_abs_vs_wrapper": (gl - glat).abs().max().item(),
                                  "wrapper_tiles": (mt, cw, ts) == row["bwd_tiles"]}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
