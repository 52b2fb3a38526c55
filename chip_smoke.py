#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mmtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

0. the card's name and power limit; TF32 off for matmuls and cuDNN;
1. build the CUDA kernel library from ``mmtpu_torch/csrc`` (timed);
2. kernel K1 (angular partition, forward and backward) against its plain
   PyTorch versions at the main path's shapes, plus a ragged shape and a
   zero latent row; kernel and plain times at 64 and 512 rows (device time
   per call from queued bursts, and the median of single calls);
3. the main path through the normal entry point,
   ``mmtpu_torch.run.main([cfg, "mosi", "--device", "cuda", ...])``: the
   non-e2e MMB2 fit at full MOSI width (synthetic data: 1284/229/686
   utterances, vocab 3016 x 300, audio 74, visual 47, batch 64, inference
   batch 512; SGD, layer norm, lr 1e-4 as in bench.py), 3 epochs, 10
   sentiment epochs; the kernel launch counts of that run are read from zero;
4. the same small config run on the GPU and on the CPU (where the kernel
   wrappers use their plain versions), which must agree.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

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
N_EPOCHS, N_SENTIMENT_EPOCHS = 3, 10


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


def check_kernels(torch, K, dev) -> dict:
    """Phase 2: K1 forward/backward vs the plain versions; returns errors and times."""
    gen = torch.Generator().manual_seed(0)
    fwd_err = bwd_err = 0.0
    for b, d, v, zero_row in SHAPES:
        lat = torch.randn(b, d, generator=gen)
        if zero_row:
            lat[0] = 0.0
        voc = torch.randn(v, d, generator=gen)
        voc = voc / torch.linalg.vector_norm(voc, dim=-1, keepdim=True)
        g = torch.randn(b, 1, generator=gen)
        lat, voc, g = lat.to(dev), voc.to(dev), g.to(dev)
        vnorm = torch.linalg.vector_norm(voc, dim=-1)

        z_k = K.angular_fwd(lat, voc, vnorm)
        z_p = K.angular_partition_ref(lat, voc)
        dl_k = K.angular_bwd(lat, voc, vnorm, g)
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
        fwd_err = max(fwd_err, (z_k - z_p).abs().max().item())
        bwd_err = max(bwd_err, grad_abs)
        log(f"[k1] B={b} D={d} V={v} zero_row={zero_row}: fwd sum rel {sum_rel:.3e}, "
            f"elem rel {elem_rel:.3e}; grad max-rel vs autograd {grad_rel:.3e}, "
            f"abs vs bwd_ref {grad_abs:.3e}")
        if not (sum_rel < FWD_SUM_REL and elem_rel < FWD_RTOL):
            raise AssertionError(f"K1 forward disagrees at {(b, d, v, zero_row)}")
        if not (grad_rel < GRAD_MAX_REL and grad_abs < GRAD_ATOL):
            raise AssertionError(f"K1 backward disagrees at {(b, d, v, zero_row)}")

    times = {}
    for b in (64, 512):
        lat = torch.randn(b, 300, generator=gen).to(dev)
        voc = torch.randn(3016, 300, generator=gen).to(dev)
        voc = voc / torch.linalg.vector_norm(voc, dim=-1, keepdim=True)
        vnorm = torch.linalg.vector_norm(voc, dim=-1)
        g = torch.randn(b, 1, generator=gen).to(dev)
        fns = {"fwd": lambda: K.angular_fwd(lat, voc, vnorm),
               "fwd_plain": lambda: K.angular_partition_ref(lat, voc),
               "bwd": lambda: K.angular_bwd(lat, voc, vnorm, g),
               "bwd_plain": lambda: K.angular_partition_bwd_ref(lat, voc, vnorm, g)}
        times[b] = {k: _device_ms(torch, f) for k, f in fns.items()}
        calls = {k: _call_ms(torch, f) for k, f in fns.items()}
        for kind, t in (("device", times[b]), ("one call", calls)):
            log(f"[k1] B={b} {kind} ms: fwd kernel {t['fwd']:.4f} plain {t['fwd_plain']:.4f}; "
                f"bwd kernel {t['bwd']:.4f} plain {t['bwd_plain']:.4f}")
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "times": times}


def run_main_path(torch, K, tmp: str) -> dict:
    """Phase 3: the non-e2e MOSI run through ``mmtpu_torch.run.main``."""
    import numpy as np

    from mmtpu.config import make_grid
    import mmtpu_torch.runner as runner
    from mmtpu_torch.run import main

    # grid config 0 with bench.py's fit settings (SGD, layer norm, lr 1e-4):
    # as it stands (batch norm, lr 1e-3) it diverges to NaN within 3 epochs
    # at MOSI width, in mmtpu as in the port
    cfg = dict(make_grid()[0], e2e=False, n_epochs=N_EPOCHS,
               n_sentiment_epochs=N_SENTIMENT_EPOCHS, norm="layer_norm", lr=1e-4)
    cfg_path = os.path.join(tmp, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out_root = os.path.join(tmp, "out")
    data_dir = os.path.join(tmp, "data")  # empty: the synthetic full-size MOSI
    os.makedirs(data_dir)

    fits = []
    fit_latents = runner.fit_latents

    def timed_fit(init_embed, *args, **kw):  # times each fit; the run is unchanged
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit_latents(init_embed, *args, **kw)
        torch.cuda.synchronize()
        fits.append((int(init_embed.shape[0]), args[-1].train_decoder,
                     time.perf_counter() - t0))
        return out

    runner.fit_latents = timed_fit
    K.LAUNCHES.update(fwd=0, bwd=0)
    try:
        t0 = time.perf_counter()
        rc = main([cfg_path, "mosi", "--device", "cuda", "--out_root", out_root,
                   "--data_dir", data_dir])
        wall = time.perf_counter() - t0
    finally:
        runner.fit_latents = fit_latents
    launches = dict(K.LAUNCHES)
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
    steps = N_EPOCHS * -(-1284 // cfg.get("batch_size", 64))
    for k in ("fwd", "bwd"):
        if launches[k] < steps:
            raise AssertionError(f"K1 {k} launched {launches[k]} times in the main path, "
                                 f"expected at least {steps}")
    train_s = sum(s for n, trains, s in fits if trains)
    train_utt_s = 1284 * N_EPOCHS / train_s
    log(f"[main] run.main wall {wall:.3f} s; train fit {train_s:.3f} s = "
        f"{train_utt_s:.1f} utt/s ({N_EPOCHS} epochs x 1284); fits "
        f"{[(n, round(s, 4)) for n, _, s in fits]}; final loss {losses[-1]:.4f}; "
        f"K1 launches {launches}")
    return {"launches": launches, "wall_s": wall, "train_utt_s": train_utt_s,
            "final_loss": float(losses[-1])}


def check_small_agreement(torch) -> None:
    """Phase 4: a small config on the GPU (kernels) and on the CPU (plain
    versions) with the same draws must agree."""
    import numpy as np

    from mmtpu.config import ExperimentConfig
    from mmtpu.data.pipeline import prepare_device_data
    from mmtpu.data.synthetic import synthesize_dataset
    from mmtpu_torch.runner import run_experiment

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import mmtpu_torch.kernels.angular as K
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
    build.load()
    log(f"[build] kernel library built and loaded in {time.perf_counter() - t0:.2f} s")

    k1 = check_kernels(torch, K, dev)
    with tempfile.TemporaryDirectory() as tmp:
        main_run = run_main_path(torch, K, tmp)
    check_small_agreement(torch)

    t = k1["times"]
    record = {"kernels": [
        {"name": "K1-fwd angular_partition", "route": "cuda",
         "source": "mmtpu_torch/csrc/angular.cu", "replaces": "mmtpu/kernels/angular.py:171",
         "launches": main_run["launches"]["fwd"], "max_abs_err": k1["fwd_err"],
         "ms": t[64]["fwd"], "plain_ms": t[64]["fwd_plain"],
         "ms_b512": t[512]["fwd"], "plain_ms_b512": t[512]["fwd_plain"]},
        {"name": "K1-bwd angular_partition", "route": "cuda",
         "source": "mmtpu_torch/csrc/angular.cu", "replaces": "mmtpu/kernels/angular.py:199",
         "launches": main_run["launches"]["bwd"], "max_abs_err": k1["bwd_err"],
         "ms": t[64]["bwd"], "plain_ms": t[64]["bwd_plain"],
         "ms_b512": t[512]["bwd"], "plain_ms_b512": t[512]["bwd_plain"]},
    ], "main_path": {"wall_s": main_run["wall_s"], "train_utt_s": main_run["train_utt_s"],
                     "final_loss": main_run["final_loss"], "card": smi}}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
