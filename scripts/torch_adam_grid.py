#!/usr/bin/env python3
"""Device time of the port's Adam kernel (``mmtpu_torch/csrc/adam.cu``: one
launch for every leaf of a tree) against its plain twin (``adam_plain`` /
``adam_leaf``, about 18 elementwise kernels a leaf,
``mmtpu_torch/train/optim.py``) at the shapes of the sweep's width-32 train
step: MOSI's and POM's e2e decoder trees (six heads' weights and biases, the
norm), their sentiment heads, and lazy Adam's touch of a (32, 64, 300) block
of the permuted latent table.  On one CUDA card.

    python3 scripts/torch_adam_grid.py [--cases mosi_decoder,pom_decoder,...]

The card's name and power limit, then one JSON object per case: floats,
launches, device ms per call of the kernel and of the twin, each captured in
a CUDA graph as the train step captures them (replays timed with CUDA events
over bursts queued behind a GPU-side sleep, as chip_smoke.py times; eager
calls would time the wrappers' host work at the decoder trees), the bound (28
bytes a float, p, g, m and v read and p, m and v written once, at 3.35 TB/s;
chip_smoke.py's ``bound_ms``), the kernel's share of it, and whether p, m
and v equal the twin's bit for bit.  It records times and routes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 32
# audio width, visual width, labels (the decoder's text width is 300)
GEOMETRY = {"mosi": (74, 47, 1), "pom": (43, 43, 17)}
CASES = ("mosi_decoder", "mosi_sentiment", "pom_decoder", "pom_sentiment", "touch")


def _tree(torch, dev, case):
    """``(p, g, m, v)`` trees of the case, a ``(K,)`` rate, bias corrections
    and (decoder) the heads' gates, as ``fit_e2e`` passes them."""
    from mmtpu_torch.models.decoder import init_decoder
    from mmtpu_torch.models.sentiment import init_sentiment
    from mmtpu_torch.tree import tree_map

    gen = torch.Generator().manual_seed(3)
    if case == "touch":
        like = torch.empty(64, 300)
    else:
        name, part = case.split("_")
        audio, visual, n_out = GEOMETRY[name]
        like = (init_decoder(gen, 300, audio, visual, False, 300) if part == "decoder"
                else init_sentiment(gen, 300, 100, n_out))

    def draw(scale=1.0, square=False):
        def one(t):
            x = torch.randn(K, *t.shape, generator=gen)
            return (scale * (x.square() if square else x)).to(dev)
        return tree_map(one, like)

    trees = (draw(), draw(), draw(0.1), draw(1e-4, square=True))
    lr = torch.full((K,), 1e-3, device=dev)
    c = torch.arange(1, K + 1, device=dev).float() * 63
    bc1, bc2 = 1.0 - torch.pow(0.9, c), 1.0 - torch.pow(0.999, c)
    gates = None
    if case.endswith("decoder"):
        gate = torch.ones(K, device=dev)
        gates = {"heads": tree_map(lambda _: gate, like["heads"]),
                 "norm": tree_map(lambda _: 1.0, like["norm"])}
    return trees, lr, bc1, bc2, gates


def _captured(torch, fn):
    """A replay of ``fn`` captured in a CUDA graph (after an eager call)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_adam_grid: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import mmtpu_torch.kernels.adam as A
    from chip_smoke import _device_ms, bound_ms
    from mmtpu_torch.train.optim import adam_leaf, adam_plain
    from mmtpu_torch.tree import tree_leaves

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    active = torch.ones(K, dtype=torch.bool, device=dev)
    for case in args.cases.split(","):
        (p, g, m, v), lr, bc1, bc2, gates = _tree(torch, dev, case)
        if case == "touch":
            kernel = lambda: A.adam_touch(p, m, v, g, lr, bc1, bc2)  # noqa: E731
            twin = lambda: adam_leaf(p, g, m, v, lr, bc1, bc2)  # noqa: E731
        else:
            kernel = lambda: A.adam_tree(p, g, m, v, lr, bc1, bc2, active, gates)  # noqa: E731
            twin = lambda: adam_plain(p, g, m, v, lr, bc1, bc2, active, gates)  # noqa: E731
        before = sum(A.LAUNCHES.values())
        got, want = kernel(), twin()
        launches = sum(A.LAUNCHES.values()) - before
        flat = lambda outs: [t for o in outs for t in tree_leaves(o)]  # noqa: E731
        floats = sum(t.numel() for t in tree_leaves(p))
        ms = _device_ms(torch, _captured(torch, kernel), reps=50)
        bound = bound_ms(12.0 * floats, 28.0 * floats)
        print(json.dumps({
            "case": case, "leaves": len(tree_leaves(p)), "floats": floats, "launches": launches,
            "kernel_ms": ms, "twin_ms": _device_ms(torch, _captured(torch, twin), reps=20),
            "bound_ms": bound[0], "bound_by": bound[1], "roofline_pct": 100.0 * bound[0] / ms,
            "bit_equal": all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
