#!/usr/bin/env python3
"""Where a sweep chunk's time goes, and how far float order moves a config.
On one CUDA card, at full MOSI width (synthetic data), with the chunk of
``chip_smoke.py`` phase 10 (the first 32 configs of the grid's Adam /
100-epoch bucket, 2 epochs, 10 sentiment epochs).

    python3 scripts/torch_sweep_chunk.py [--configs 32] [--alone 6,8]

1. The chunk three times (``run_chunk``): wall seconds per phase; the first
   call pays the card's first-use costs.
2. A fourth call under ``torch.profiler``: the device's busy share of the
   train phase's wall time (kernel time summed over the phase's kernels,
   which run one at a time on one stream), the kernel launches, and the
   kernels with the most device time.
3. Each config named by ``--alone`` (grid numbers) run alone through the
   single-config fits on the card and on the CPU, and the chunk's copy of
   it: the largest embedding difference per split, the coordinates above
   2e-4, the final loss and the test predictions, for each pair.

One JSON object per line.  It records measurements and routes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compare(a, i, b, j) -> dict:
    import numpy as np

    out = {}
    for s in ("train", "valid", "test"):
        d = np.abs(a.embeddings[s][i] - b.embeddings[s][j])
        out[s] = {"max_abs": float(d.max()), "above_2e-4": int((d > 2e-4).sum()),
                  "rows_above_1e-5": int((d.max(axis=-1) > 1e-5).sum())}
    out["loss_rel"] = float(abs(a.final_train_loss[i] - b.final_train_loss[j])
                            / abs(b.final_train_loss[j]))
    out["pred_max_abs"] = float(np.abs(a.predictions[i] - b.predictions[j]).max())
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_chunk: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, default=32)
    ap.add_argument("--alone", default="6,8", help="grid numbers of configs to run alone")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.kernels import build
    from mmtpu_torch.sweep.runner import run_chunk, run_config_alone
    from torch.profiler import ProfilerActivity, profile, record_function

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load()
    cs.SWEEP_K = args.configs
    configs = cs.sweep_configs()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        prep = prepare_device_data(load_dataset("mosi", data_dir=tmp), pos_mode="shared",
                                   pos_dims=tuple(sorted({c["pos_embed_dim"] for c in configs})))

    def chunk():
        return run_chunk(configs, prep, batch_size=64, device=dev, return_embeddings=True)

    for call in range(3):
        t0 = time.perf_counter()
        res = chunk()
        print(json.dumps({"call": call, "configs": len(configs),
                          "wall_s": time.perf_counter() - t0, "phase_s": res.phase_s}),
              flush=True)

    import mmtpu_torch.sweep.runner as runner

    parts = runner.build_sweep_parts

    def traced_parts(*a, **kw):  # the train phase in a range of its own
        p = parts(*a, **kw)
        train = p["train"]

        def train_traced(*targs):
            with record_function("sweep_train_phase"):
                out = train(*targs)
                torch.cuda.synchronize(dev)
            return out

        return dict(p, train=train_traced)

    runner.build_sweep_parts = traced_parts
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = chunk()
    finally:
        runner.build_sweep_parts = parts
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    span = next(e.time_range for e in events
                if e.name == "sweep_train_phase" and e.device_type != cuda)
    kernels = [e for e in events if e.device_type == cuda and e.name != "sweep_train_phase"
               and span.start <= e.time_range.start <= span.end]
    busy_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    wall_us = span.end - span.start
    by_name: dict = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({"profiled_train_phase": {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / wall_us, "kernels": len(kernels),
        "top_kernels_ms": [{"name": n[:80], "calls": c, "ms": ms} for n, (c, ms) in top]}}),
          flush=True)

    nums = [c["config_num"] for c in configs]
    for num in (int(x) for x in args.alone.split(",") if x):
        i = nums.index(num)
        on = {d: run_config_alone(configs[i], prep, batch_size=64, device=d)
              for d in ("cuda", "cpu")}
        print(json.dumps({"config": num, "norm": configs[i]["norm"], "lr": configs[i]["lr"],
                          "chunk_vs_alone_card": _compare(res, i, on["cuda"], 0),
                          "alone_card_vs_alone_cpu": _compare(on["cuda"], 0, on["cpu"], 0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
