#!/usr/bin/env python3
"""Peak device memory and phase seconds of one POM sweep chunk at POM's real
geometry (600 / 100 / 203 utterances, 1357-token rows of a 9206 x 300
vocabulary, audio and visual 43, 17 traits; synthetic), eager, on one CUDA
card.  The chunk is the first ``WIDTH`` (32, the CLI's default chunk
width) configs of the grid's Adam / 100-epoch bucket cut to ``EPOCHS`` (1)
epoch and one sentiment epoch: its inference fits run 32 x 512 rows per
step, where the word term's per-token vectors dominate the memory.

    python3 scripts/torch_token_memory.py [--root DIR]

``--root`` (default: this checkout) is the tree whose ``mmtpu_torch`` runs,
so that two trees (a parent and a change, each unpacked with ``git archive``)
are measured by the same script in one call.  The chunk runs twice; the
second run's phases (wall seconds, device synced after each) are printed,
and the peak over both (``torch.cuda.max_memory_allocated`` and
``max_memory_reserved``).  One JSON line, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POM = dict(n_train=600, n_valid=100, n_test=203, vocab_size=9206, embed_dim=300,
           audio_dim=43, visual_dim=43, text_len=1357)
WIDTH, EPOCHS = 32, 1


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=ROOT)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_token_memory: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from mmtpu_torch.config import make_grid
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.sweep.runner import run_chunk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bucket = [c for c in make_grid() if c["optimizer"] == "adam" and c["n_epochs"] == 100]
    configs = [dict(c, n_epochs=EPOCHS, n_sentiment_epochs=1) for c in bucket[:WIDTH]]
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(synthesize_dataset("pom", **POM), pos_mode="shared",
                               pos_dims=dims)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        res = run_chunk(configs, prep, device=dev, graphs=False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "root": os.path.abspath(args.root), "width": WIDTH, "epochs": EPOCHS,
        "peak_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2 ** 30,
        "phase_s": res.phase_s, "finite": bool(all(
            v == v for v in res.final_train_loss.tolist())), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
