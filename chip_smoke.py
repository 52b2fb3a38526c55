#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mmtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

0. the card's name and power limit; TF32 off for matmuls and cuDNN;
1. build the CUDA kernel library from ``mmtpu_torch/csrc`` (one ``nvcc`` per
   source, side by side; timed), K1's resident blocks per SM at D = 300,
   512, 768, 1024 and 2048, its backward's depth slices there, and K2's
   (Adam and SGD; at any depth) from the runtime's occupancy query;
2. kernel K1 (angular partition, forward and backward) against its plain
   PyTorch versions at the main path's shapes (64, 512 and 32 rows: the
   fits' batches and the alternating fit's), plus a ragged shape and a
   zero latent row, and at depths of several depth chunks and slices (513,
   767, 768, 1024 and 2048), with the forward and the backward each called
   twice and required bit for bit equal; kernel and plain times at 64 and
   512 rows (device time per call from queued bursts, and the median of
   single calls) and the bounds at both; kernel and plain times and bounds
   at D = 768 and 1024 at 64, 2048 and 16384 rows;
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
   ``--e2e y --time_test`` at the same width and settings (likelihood
   weight from the grid);
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
   wall seconds, the training rate and the peak memory printed;
11. the fused sweep chunks: phase 10's Adam configs through ``run_chunk``
   with ``fused_dec_update`` (held to phase 10's dense chunk), and the first
   32 configs of the grid's SGD / 100-epoch bucket (layer norm, lr 1e-4: the
   grid's SGD configs diverge at this width, as in phase 4) without and with
   it; K2 launched twice per
   train step for the whole chunk (84 of the chunk's kind), K1 as in the
   dense chunk; the fused chunk held to the dense one (final loss rtol 2e-4,
   test predictions atol 5e-4, embeddings atol 2e-4 for SGD; for Adam, per
   config, at most 1e-4 of the coordinates above 2e-4 and none above 8 lr:
   see ``ADAM_EMB_OVER_SHARE``); the train phase's rates side by side
   (printed, not claimed);
12. the whole sweep: ``python -m mmtpu_torch.sweep mosi`` in a subprocess
   at full MOSI width, ``--fused_dec``, 16 grid configs over both optimizers
   and both epoch counts (cut 100 -> 1 and 200 -> 2 epochs, sentiment
   epochs 400 -> 10) in chunks of 8 with ``--resume_dir``, its kernel
   launches counted in that process; then one chunk's entry taken out of
   ``sweep_state.json`` and the command run again: it computes that chunk
   only, and its CSV equals the first run's bit for bit;
13. closed form and serving: phase 5's ``--time_test`` result (the 686-row
   test split's latency); that run's decoder through ``closed_form_latents``
   on the card against the CPU (rtol 1e-5, atol 1e-6); a
   ``ClosedFormServer`` on the card (ladder 64 / 256 / 1024, the run's
   sentiment head and the vocabulary) whose raw and stats answers at 64 and
   686 rows, a 3-row request against the 64-row one, and a 1500-row request
   (above the ladder) against its two halves agree within 1e-5; each
   request size's latency, median of 8, device- and host-resident, raw and
   stats; one device-resident 686-row request of each form traced under
   ``torch.profiler``: its kernels, its device-busy time and its share of
   the traced wall time;
14. the warm-started chunk: phase 10's configs through ``run_chunk`` with
   ``infer_warm_start`` and ``infer_epochs_cap=1``: each config's inference
   init against a 2-D ``closed_form_latents_from_stats`` of its own decoder
   (1e-5), the train fit as phase 10's, finite results, K1's launches (42
   + 3 of each kind) beside phase 10's; then phase 10's configs uncapped
   and the warm-started chunk again, both already warm, for the infer
   phases' seconds side by side;
15. the legacy alternating fit, ``fit_alternating`` on the MOSI train split
   (the bimodal generator, 3 epochs of 41 batches of 32): K1's forward 123
   times and its backward never; against the same fit on the CPU (losses
   rtol 2e-4, latents atol 2e-4); K1's forward, through the wrapper the fit
   calls, on the fit's first and last (padded) 32-row batches of its final
   latents against its plain version at phase 2's gates; seconds per epoch;
16. SIF, posenc and nearest words (``mmtpu_torch.ops``,
   ``mmtpu_torch.analysis``) on the card against the CPU at MOSI width;
17. multi-device on the one card: K1 against its plain versions at the
   shards' shapes (``MESH_SHARD_SHAPES``); worker processes under
   ``torchrun`` (this script with ``--mesh-worker``), CUDA ranks sharing
   card 0 over gloo: four run phase 5's e2e run through
   ``run_experiment(mesh=(2, 2))`` with its inference fits, two run phase
   4's training fit through ``fit_latents_mesh`` on (2, 1) with batch norm
   (at lr 1e-5) and on (1, 2), each held to the same finite fit on one device (loss rtol 2e-4 /
   atol 1e-5, embeddings and decoder rtol 2e-3 / atol 2e-5) with K1 once
   per step of each kind on every rank; on the (2, 2) and (1, 2) meshes
   each rank's vocabulary-sharded Z and its latent gradient on the fit's
   first batch against the plain versions over the whole vocabulary, and
   that step's loss and latent gradient against one device (1e-5 of the
   loss and of the gradient's largest entry, ``vocab_shard_check``); then ``run_sweep_multihost`` over
   eight SGD grid configs cut to 1-2 epochs with the fused decoder update,
   every config finite and held to ``run_sweep`` in this process (rtol
   2e-4); and ``torchrun
   --nproc_per_node 1`` of ``mmtpu_torch.run ... --mesh data,vocab`` over
   NCCL, held to phase 4's run; each part's wall seconds, printed as N ranks
   sharing one card, not a scaling number;
18. ``mmtpu_torch.run --profile DIR`` in a fresh process: its trace names
   K1's kernels as often as the run launched them; ``make_configs`` writes
   the 512 configs of ``config.make_grid``.
19. phase 5's e2e config through ``run_experiment(prep=...)`` on a synthetic
   MOSI (1284/229/686 utterances, seq 20, vocab 3016, batch 64) whose word
   embeddings, and so the latents, are 768 wide: K1 at that depth on the
   main path, launched as in phase 5 (72 of each kind); held to the same
   run on the CPU (final loss rtol 2e-4, post embeddings atol 2e-4).
20. the captured paths (``mmtpu_torch/graphs.py``: one CUDA graph per
   epoch of a fit of ``graphs.MIN_EPOCHS`` epochs or more and per ladder
   size of the server, the default on the card; the fits of the phases
   above are shorter and run eagerly, phase 13's servers captured)
   against eager (``graphs=False``), in turns in one process (eager, then
   captured): phase 4's training fit and phase 5's e2e fit
   (``GRAPH_EPOCHS`` epochs), phase 10's chunk dense and fused
   (``GRAPH_SWEEP_EPOCHS`` epochs) and phase 13's server; each pair held to
   the whole-fit gates (loss rtol 2e-4, embeddings atol 2e-4), the chunks
   to phase 11's rule, the server to ``SERVE_ATOL``, with their
   bit-equality reported; s per steady epoch, utt/s (config·utt·epochs/s
   for the chunks), capture seconds, peak memory, K1 / K2 launches (equal
   in every turn) and request ms at 3, 64, 686 and 1500 rows; a bucket of
   ``GRAPH_SWEEP_CHUNKS`` chunks of ``GRAPH_SWEEP_K`` configs of the grid
   (``GRAPH_SWEEP_EPOCHS`` epochs and sentiment epochs) through
   ``run_sweep``, one store of graphs
   for the bucket and one chunk deep, against fresh ``run_chunk`` calls:
   each chunk after the first warms up and captures nothing, and equals
   its chunk alone bit for bit with the same K1 / K2 launches, with
   ``done_at_s`` per chunk and the sweep's wall time against the chunks'
   alone; the chunk's
   and one config's inference fits eager against captured at the grid's
   100 epochs and at caps on either side of ``MIN_EPOCHS``
   (``GRAPH_BREAK_EVEN``); phase 4's config's sentiment fit, the K = 32
   chunk's sentiment phase and phase 15's alternating fit
   (``GRAPH_SENT_EPOCHS`` epochs; the sentiment fits' validating epochs a
   graph of their own), eager and captured in turns at the whole-fit gates
   with their bit-equality, s per steady epoch, capture seconds, peak
   memory and launches (K1-fwd once per alternating step in every turn,
   nothing in the sentiment fits), and the chunk's sentiment phase once
   eager and once captured at ``GRAPH_SENT_GRID_EPOCHS`` (the grid's 400
   cut to 100); then,
   in a fresh process under ``torch.profiler`` (``--graphs-worker``), each
   path's host kernel and graph launches per step and per epoch (a steady
   captured sentiment or alternating epoch: one graph launch and at most
   ``GRAPH_EPOCH_HOST_LAUNCHES`` kernels and copies) and the device's idle
   share over one steady epoch (8 requests), and K1's and K2's kernels
   named in the trace inside every epoch, replays included, against the
   launch counters (which a replay adds to by its capture's launches): any
   difference fails.
21. the other tasks (synthetic data): K1 at POM's 9206-word vocabulary
   against its plain versions at phase 2's gates (64, 512 and 4096 rows,
   times and bounds); POM at its real geometry (``POM_GEOMETRY``: 1357-token
   rows), IEMOCAP and MOSI under ``dot_prod`` through ``run_experiment``,
   e2e captured and non-e2e eager (``TASK_RUNS``), each against the same
   run on the CPU in two worker processes (``--tasks-worker``) at the
   whole-fit gates, with K1's launches, the graphs captured, the training
   fit's s per steady epoch and the test metrics scored on the card against
   the host report.  K1 and these paths run before the workers start, so
   their times are taken with no other process on the host; the rest of
   the phase runs beside the workers: ``dot_prod`` e2e again with TF32
   matmuls (finite); the sentiment fit at 17 and 2 outputs captured against eager,
   bit for bit; a POM sweep (``POM_SWEEP_K`` configs in chunks of
   ``POM_SWEEP_CHUNK``, captured: each later chunk only replays) and one
   chunk at the default width ``POM_WIDE_K`` with their peak memory; the
   width-halving retry forced by a memory fraction (widths 32 then 16,
   every result finite, the fraction restored); ``python -m
   mmtpu_torch.sweep pom`` and ``iemocap`` on a small ``--configs_dir``.
   Every ``run_experiment`` path here launches the token kernels once a step
   each way (``dot_prod`` too, where K1 does not run), and the POM sweep and
   chunk once a step each way, as K1;
22. the token kernels (``mmtpu_torch/kernels/token_dots.py``, runs right
   after phase 3) against their plain twins at ``TOKEN_SHAPES``: POM's
   training step and inference fits, MOSI's 20-token rows; int64 and int32
   ids, one launch each per call, two calls bit for bit equal; kernel and
   twin device ms and the bounds at each shape.  Phases 4, 5, 8 and 9 hold
   them to at least one launch per step each way, phase 10 to one per step,
   phase 15 and phase 20's alternating and sentiment fits to none.
23. the Adam kernel (``mmtpu_torch/kernels/adam.py``, runs right after
   phase 22) against the plain chain on the card (``adam_plain``,
   ``adam_leaf``) at a width-32 grid step's trees: MOSI's and POM's e2e
   decoders and sentiment heads, with per-config rates and step counts, a
   mixed ``active`` and a heads gate with zeros, and lazy Adam's touch of
   a ``(32, 64, 300)`` block at the first and the last step of a 21-step
   epoch; one launch per call, bit for bit the chain, two calls bit for
   bit equal; kernel and chain device ms (CUDA graph replays) and the
   bytes bound at each.  Every Adam path holds the kernel's launches: an
   e2e step two tree launches (decoder, sentiment head) and a touch with
   lazy Adam, three tree launches with dense Adam (phases 6 and 8); a
   non-e2e training step two tree launches with dense Adam (phase 9); a
   sweep chunk two tree launches a train step and a touch a step of every
   fit (phases 10, 11 and 21); the SGD runs (phases 4 and 5) and the
   alternating, sentiment and server paths (phases 13, 15 and 20) none.

Each phase prints its wall seconds (``[time]``).  Phase 3 also holds K2 with
the config axis (``K2_BATCHED_SHAPES``, per-config
lr, bias corrections and flag, one config at flag 0) to its plain version and
times it at the fused chunk's shape, beside 32 2-D calls, one per config slice
of the same inputs, timed as one burst.  Phases 8-18 run inside the temporary
directory of phases 4-6, before phase 7, and phases 20 and 21 after phase
18 in it; phase 19 runs last.  Around each path
of phases 4-6 and 8-21 the kernel launch counts (K1, K2, the token kernels and
the Adam kernel) are set to 0 just before and read just after
(phases 12, 17 and 18 in the processes that run them).  The line before the last is the kernels'
JSON record; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the rest of the repository beside it, the script exits
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

# (B, D, V, zero_row): the train batch, the inference batch, the alternating
# fit's batch, a large batch, a ragged shape, and a zero latent row (exercises
# the 1e-8 cosine clamp); then depths above one depth chunk (384 floats),
# where the forward streams both operands chunk by chunk and the backward
# cuts the output depth into slices of at most 512 floats: one past 512, one
# off the float4 boundary (the scalar load path), 768 and 1024 (two slices;
# a 2048-row batch and a zero row among them) and 2048 (four slices)
SHAPES = [(64, 300, 3016, False), (512, 300, 3016, False), (32, 300, 3016, False),
          (2048, 300, 3016, False), (37, 300, 3001, False), (64, 300, 3016, True),
          (64, 513, 3016, False), (37, 767, 3001, False), (64, 768, 3016, False),
          (2048, 1024, 3016, False), (64, 1024, 3016, True), (64, 2048, 3016, False)]
# K1 timed at the widths of larger word-embedding tables, at the train batch,
# a sweep chunk's train rows and its inference rows (burst lengths per rows)
DEEP_DEPTHS, DEEP_ROWS = (768, 1024), {64: 100, 2048: 20, 16384: 5}
FWD_SUM_REL, FWD_RTOL = 1e-5, 1e-5  # the TPU kernel's gate (bench.py) and tests
GRAD_MAX_REL, GRAD_ATOL = 1e-3, 1e-5
# (B, D, F) of K2: the train batch at the stacked MOSI head width (pos 2), the
# width the TPU code padded to, the inference batch at pos 4, ragged shapes
# (the last with F odd: the kernel's scalar edge path)
K2_SHAPES = [(64, 300, 1400), (64, 300, 1536), (512, 300, 1416), (37, 300, 37),
             (33, 300, 1401)]
K2_RTOL, K2_ATOL, K2_GX_MAX_REL = 1e-5, 1e-5, 1e-5  # the TPU kernel's tests
# (K, B, D, F) of K2 with the config axis: the sweep's fused chunk (32
# configs, the train batch, the stacked MOSI head width) and ragged shapes
K2_BATCHED_SHAPES = [(32, 64, 300, 1400), (3, 37, 300, 37), (2, 33, 300, 1401)]
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
# phase 11: a fused chunk's test predictions against the dense chunk's, at
# mmtpu's own fused tolerance (tests/test_fused_update.py:196-200)
FUSED_PRED_ATOL = 5e-4
# phase 11, an Adam chunk's embeddings, fused against dense: Adam's first
# step moves a coordinate by lr x sign(g), so where a gradient component is
# within rounding of zero the two float orders of the decoder's products
# (K2's against cuBLAS's) move that coordinate apart by a few lr, at either
# learning rate (on the card: one coordinate of 21.1 million at lr 1e-4, by
# 2.95e-4; 1-14 per config at lr 1e-3, by up to 3.34e-3; PERF.md section
# 6).  Each config is held to: at most this share of its coordinates
# above SWEEP_ATOL, and none further than this many lr.  The limit lies
# between the largest sound reading, 3.34 lr, and a planted per-config lr
# fault's 19.7 lr (456,632 coordinates per config), a factor of about 2.4
# from each.  SGD has no such step: an SGD chunk's embeddings are held at
# SWEEP_ATOL everywhere.
ADAM_EMB_OVER_SHARE, ADAM_EMB_MAX_LR = 1e-4, 8.0
# phase 22: the token kernels at the fits' shapes, (rows, latents per row M,
# tokens per row, vocabulary, bursts of timed calls): POM's training step
# (a width-32 chunk's 2048 rows, M = 1) and its inference fits (203 test and
# 100 valid rows, M = 32 configs), MOSI's 20-token rows in training and at
# a 512-row inference block; against the plain twin at rtol 1e-5 (atol 1e-5
# on the dots, 1e-4 on the latent gradients: sums of up to 1357 terms in
# another order), as tests/test_torch_cuda.py holds them
TOKEN_SHAPES = {"pom_train": (2048, 1, 1357, 9206, 10), "pom_infer_b203": (203, 32, 1357, 9206, 20),
                "pom_infer_b100": (100, 32, 1357, 9206, 20),
                "mosi_train": (2048, 1, 20, 3016, 50), "mosi_infer_b512": (512, 32, 20, 3016, 50)}
TOKEN_RTOL, TOKEN_FWD_ATOL, TOKEN_BWD_ATOL = 1e-5, 1e-5, 1e-4
# phase 13: the closed form on the card against the CPU (the CPU parity
# tests' tolerance against mmtpu); the server's ladder, a request above it,
# and the server's raw, stats and padded answers held to each other at
# mmtpu's tests/test_warm_start.py tolerance
CF_RTOL, CF_ATOL = 1e-5, 1e-6
SERVE_LADDER, SERVE_BIG, SERVE_ATOL = (64, 256, 1024), 1500, 1e-5
# phase 14: each config's warm start against its own 2-D closed form
WARM_INIT_ATOL = 1e-5
# phase 15: the alternating fit (batch 32 as sif2.py:479), the card against
# the CPU at the whole-fit parity tolerances
ALT_EPOCHS, ALT_LR, ALT_WORD_WEIGHT = 3, 1e-3, 0.001
ALT_LOSS_RTOL, ALT_LAT_ATOL = 2e-4, 2e-4
# phase 16: SIF, posenc and nearest words, the card against the CPU (the CPU
# tests' tolerance against mmtpu; nearest words by their cosines)
OPS_RTOL, OPS_ATOL = 1e-5, 1e-6
# phase 19: the e2e run at a 768-wide word-embedding table (MOSI's geometry
# otherwise), the card against the CPU at the whole-fit parity tolerances
DEEP_E2E_D = 768
DEEP_LOSS_RTOL, DEEP_EMB_ATOL = 2e-4, 2e-4


# phase 23: the Adam kernel at a width-32 grid step's trees, (audio width,
# visual width, labels) of MOSI's and POM's decoders (text 300) and
# sentiment heads (hidden 100), and lazy Adam's touch (rows per block,
# depth, steps of the epoch); bit for bit the plain chain on the card, as
# tests/test_torch_cuda.py holds it.  Its bound: 28 bytes a float (p, g, m
# and v read, p, m and v written) and 12 operations.
ADAM_K, ADAM_GEOMETRY, ADAM_TOUCH = 32, {"mosi": (74, 47, 1), "pom": (43, 43, 17)}, (64, 300, 21)


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
    b, d = lat.shape
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
        log(f"[k1] B={b} D={d} {kind} ms: fwd kernel {t['fwd']:.4f} plain {t['fwd_plain']:.4f}; "
            f"bwd kernel {t['bwd']:.4f} plain {t['bwd_plain']:.4f}")
    return times


def _k1_bounds(b: int, d: int = 300, v: int = 3016) -> dict:
    """K1's bounds at ``b`` rows and depth ``d``: each input read once, each
    output written once."""
    fwd_bytes = 4 * (b * d + v * d + v + b)
    bounds = {"fwd": bound_ms(2 * b * v * d, fwd_bytes),
              "bwd": bound_ms(4 * b * v * d, fwd_bytes + 4 * b * d)}
    log(f"[k1] bound at B={b} D={d}: fwd {bounds['fwd'][0]:.5f} ms ({bounds['fwd'][1]}), "
        f"bwd {bounds['bwd'][0]:.5f} ms ({bounds['bwd'][1]})")
    return bounds


def check_kernels(torch, K, dev) -> dict:
    """Phase 2: K1 forward/backward vs the plain versions; returns errors,
    times and bounds at D = 300 (64 and 512 rows) and at ``DEEP_DEPTHS``
    (``DEEP_ROWS``)."""
    gen = torch.Generator().manual_seed(0)
    fwd_err = bwd_err = 0.0
    for b, d, v, zero_row in SHAPES:
        errs = _check_k1(torch, K, *_k1_case(torch, dev, gen, b, d, v, zero_row), zero_row)
        fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])
    times = {b: _k1_times(torch, K, *_k1_case(torch, dev, gen, b, 300, 3016)) for b in (64, 512)}
    bounds = {b: _k1_bounds(b) for b in (64, 512)}
    deep = {}
    for d in DEEP_DEPTHS:
        for b, reps in DEEP_ROWS.items():
            case = _k1_case(torch, dev, gen, b, d, 3016)
            deep[d, b] = {"times": _k1_times(torch, K, *case, single_calls=False, reps=reps),
                          "bounds": _k1_bounds(b, d)}
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "times": times, "bounds": bounds,
            "deep": deep}


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


def _k2_batched_case(torch, dev, gen, k, b, d, f, flag_last: float):
    """Inputs of one K2 call with the config axis: as ``_k2_case`` per
    config, with per-config lr (1e-3 to 3e-3), bias corrections (step
    counts 1 to K) and flag (1, the last config's ``flag_last``), all on the
    card."""
    r = lambda *s: torch.randn(*s, generator=gen)
    t = {"w": 0.05 * r(k, d, f), "m": 0.1 * r(k, d, f), "v": 0.01 * (1.0 + r(k, d, f).abs()),
         "x": r(k, b, d), "g_z": r(k, b, f) / b ** 0.5}
    count = torch.arange(1, k + 1, dtype=torch.float32)
    flag = torch.ones(k)
    flag[-1] = flag_last
    t.update(lr=1e-3 * (1.0 + torch.arange(k) % 3), bc1=1.0 - 0.9 ** count,
             bc2=1.0 - 0.999 ** count, flag=flag)
    return {k_: a.to(dev) for k_, a in t.items()}


def _k2_sliced(T, t: dict, k: int) -> dict:
    """Per kind, one function that makes ``k`` 2-D K2 calls, one per config
    slice of the config axis's inputs ``t`` (the same work as one batched
    call, in ``k`` launches)."""
    calls = [_k2_calls(T, s, s["flag"]) for s in ({n: a[i] for n, a in t.items()}
                                                  for i in range(k))]
    return {kind: (lambda kind=kind: [c[kind]["kernel"]() for c in calls])
            for kind in ("adam", "sgd")}


def check_k2_batched(torch, T, dev, err: dict) -> None:
    """Phase 3, the config axis: K2 against its plain version at
    ``K2_BATCHED_SHAPES``, each config held to ``compare_k2``'s gates (the
    last one at flag 0, its tables bit for bit), one launch per call, two
    calls bit for bit equal."""
    gen = torch.Generator().manual_seed(2)
    for k, b, d, f in K2_BATCHED_SHAPES:
        t = _k2_batched_case(torch, dev, gen, k, b, d, f, flag_last=0.0)
        for kind, fns in _k2_calls(T, t, t["flag"]).items():
            before = T.LAUNCHES[kind]
            got, want = fns["kernel"](), fns["plain"]()
            launches = T.LAUNCHES[kind] - before
            same = all(torch.equal(a, g) for a, g in zip(fns["kernel"](), got))
            torch.cuda.synchronize()
            worst = gx_rel = 0.0
            for i in range(k):
                errs = compare_k2(kind, [g[i] for g in got], [w_[i] for w_ in want],
                                  {n: t[n][i] for n in ("w", "m", "v")}, float(t["flag"][i]),
                                  (k, b, d, f, i))
                worst, gx_rel = max(worst, errs[0], errs[1]), max(gx_rel, errs[2])
            err[kind] = max(err[kind], worst)
            log(f"[k2] {kind} K={k} B={b} D={d} F={f} (config {k - 1} at flag 0): max abs "
                f"{worst:.3e}, g_x max-rel {gx_rel:.3e}; {launches} launch(es); repeat "
                f"bit-equal {same}")
            if launches != 1:
                raise AssertionError(f"one batched K2-{kind} call launched {launches} times")
            if not same:
                raise AssertionError(f"K2-{kind} differs between two calls at {(k, b, d, f)}")


def check_k2(torch, T, dev) -> dict:
    """Phase 3: K2 (Adam and SGD) vs its plain versions, without and with
    the config axis; errors, times, bounds."""
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

    check_k2_batched(torch, T, dev, err)

    times, bounds = {}, {}
    # the sweep's fused shape, every config at flag 1 (the whole step's work)
    kb, bb, db, fb = K2_BATCHED_SHAPES[0]
    tb = _k2_batched_case(torch, dev, gen, kb, bb, db, fb, flag_last=1.0)
    batched, sliced = _k2_calls(T, tb, tb["flag"]), _k2_sliced(T, tb, kb)
    for b, d, f in ((64, 300, 1400), (512, 300, 1416)):
        t = _k2_case(torch, dev, gen, b, d, f)
        fns = _k2_calls(T, t, torch.tensor(1.0, device=dev))
        if b == 64:  # one profiler session for the 2-D and the batched calls
            counts = _k2_device_kernels(torch, {
                **{k: fns[k]["kernel"] for k in ("adam", "sgd")},
                **{f"{k}_k{kb}": batched[k]["kernel"] for k in ("adam", "sgd")}})
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
    for kind in ("adam", "sgd"):
        tk = {k: _device_ms(torch, fn, reps=30) for k, fn in batched[kind].items()}
        tk["sliced"] = _device_ms(torch, sliced[kind], reps=10)
        times[kind][f"k{kb}"] = tk
        tables = 3 if kind == "adam" else 1
        ops = kb * (4 * bb * db * fb + K2_ELEMENTWISE_OPS[kind] * db * fb)
        nbytes = 4 * kb * (2 * tables * db * fb + bb * fb + 2 * bb * db)
        bk = bounds[kind][f"k{kb}"] = bound_ms(ops, nbytes)
        log(f"[k2] {kind} K={kb} B={bb} D={db} F={fb}: device ms kernel {tk['kernel']:.4f} "
            f"plain {tk['plain']:.4f}; {kb} 2-D calls, one per config slice, "
            f"{tk['sliced']:.4f}; bound {bk[0]:.5f} ms ({bk[1]}: {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return {"err": err, "times": times, "bounds": bounds}


# idle seconds before each traced range: the trace places a device event by
# its start on the host's clock, and the device clock's offset from it (a
# kernel launched just after one range ended was seen inside it) must stay
# below the gap between ranges
TRACE_GAP_S = 0.005


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
            time.sleep(TRACE_GAP_S)
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
    import mmtpu_torch.kernels.adam as A
    import mmtpu_torch.kernels.token_dots as TD

    K.LAUNCHES.update(fwd=0, bwd=0)
    T.LAUNCHES.update(adam=0, sgd=0)
    TD.LAUNCHES.update(fwd=0, bwd=0)
    A.LAUNCHES.update(tree=0, touch=0)


def _read_launches(K, T) -> dict:
    import mmtpu_torch.kernels.adam as A
    import mmtpu_torch.kernels.token_dots as TD

    return {"k1_fwd": K.LAUNCHES["fwd"], "k1_bwd": K.LAUNCHES["bwd"],
            "k2_adam": T.LAUNCHES["adam"], "k2_sgd": T.LAUNCHES["sgd"],
            "tok_fwd": TD.LAUNCHES["fwd"], "tok_bwd": TD.LAUNCHES["bwd"],
            "adam_tree": A.LAUNCHES["tree"], "adam_touch": A.LAUNCHES["touch"]}


def _hold_adam(launches: dict, tag: str, tree: int, touch: int, at_least: bool = False) -> None:
    """Raise unless ``launches`` holds ``tree`` Adam tree launches and
    ``touch`` touches (or at least as many)."""
    got = (launches["adam_tree"], launches["adam_touch"])
    if not (got[0] >= tree and got[1] >= touch if at_least else got == (tree, touch)):
        raise AssertionError(f"the Adam kernel launched {got[0]} tree and {got[1]} touch times "
                             f"in the {tag} path, expected {'at least ' if at_least else ''}"
                             f"{tree} and {touch}")


def _token_case(torch, dev, gen, rows, m, n_tok, v, d=300) -> tuple:
    """The token term's inputs at one shape: ``(R, M, D)`` normal latents, a
    unit-norm ``(V, D)`` vocabulary, ``(R, L)`` int64 ids with a zero-padded
    tail and the last word repeated in every row, an ``(R, M, L)`` normal
    cotangent."""
    lat = torch.randn(rows, m, d, generator=gen)
    voc = torch.randn(v, d, generator=gen)
    voc = voc / torch.linalg.vector_norm(voc, dim=-1, keepdim=True)
    ids = torch.randint(1, v, (rows, n_tok), generator=gen)
    ids[:, n_tok // 2:] = 0
    ids[:, :min(n_tok, 8)] = v - 1
    g = torch.randn(rows, m, n_tok, generator=gen)
    return lat.to(dev), voc.to(dev), ids.to(dev), g.to(dev)


def _token_bounds(rows: int, m: int, n_tok: int, v: int, d: int = 300) -> dict:
    """The token kernels' bounds: two operations per (row, latent, token,
    depth) each way; the ids, the latents or the cotangent and the output
    moved once, and each word vector read once (the table stays in L2)."""
    ids, lat, dots, voc = 8 * rows * n_tok, 4 * rows * m * d, 4 * rows * m * n_tok, 4 * v * d
    ops = 2 * rows * m * n_tok * d
    return {"fwd": bound_ms(ops, ids + lat + dots + voc),
            "bwd": bound_ms(ops, ids + dots + lat + voc)}


def check_token_kernels(torch, dev) -> dict:
    """Phase 22: the token kernels at ``TOKEN_SHAPES`` against their plain
    twins (int64 and int32 ids), one launch each per call, a second call bit
    for bit equal; device ms of kernel and twin per call, and the bounds."""
    import mmtpu_torch.kernels.token_dots as TD
    from mmtpu_torch.ops.wordprob import token_dots_plain, token_dots_plain_bwd

    gen = torch.Generator().manual_seed(22)
    out = {"fwd_err": 0.0, "bwd_err": 0.0, "times": {}, "bounds": {}}
    for tag, (rows, m, n_tok, v, reps) in TOKEN_SHAPES.items():
        lat, voc, ids, g = _token_case(torch, dev, gen, rows, m, n_tok, v)
        want = {"fwd": token_dots_plain(lat, voc, ids), "bwd": token_dots_plain_bwd(g, voc, ids)}
        for ids_t in (ids, ids.int()):
            before = dict(TD.LAUNCHES)
            got = [{"fwd": TD.token_dots_fwd(lat, voc, ids_t),
                    "bwd": TD.token_dots_bwd(g, voc, ids_t)} for _ in range(2)]
            torch.cuda.synchronize()
            if TD.LAUNCHES != {k: n + 2 for k, n in before.items()}:
                raise AssertionError(f"token kernels at {tag}: launches {before} -> "
                                     f"{dict(TD.LAUNCHES)}, expected two each")
            for kind, atol in (("fwd", TOKEN_FWD_ATOL), ("bwd", TOKEN_BWD_ATOL)):
                err = (got[0][kind] - want[kind]).abs()
                over = (err - TOKEN_RTOL * want[kind].abs()).max().item()
                same = torch.equal(got[0][kind], got[1][kind])
                out[f"{kind}_err"] = max(out[f"{kind}_err"], err.max().item())
                log(f"[token] {tag} (R={rows} M={m} L={n_tok} V={v}, {ids_t.dtype}) {kind}: "
                    f"max abs {err.max().item():.3e}, max abs over rtol {over:.3e} (atol "
                    f"{atol}); repeat bit-equal {same}")
                if not over < atol:
                    raise AssertionError(f"token kernel {kind} disagrees with its twin at {tag}")
                if not same:
                    raise AssertionError(f"token kernel {kind} differs between two calls at {tag}")
        fns = {"fwd": lambda: TD.token_dots_fwd(lat, voc, ids),
               "fwd_plain": lambda: token_dots_plain(lat, voc, ids),
               "bwd": lambda: TD.token_dots_bwd(g, voc, ids),
               "bwd_plain": lambda: token_dots_plain_bwd(g, voc, ids)}
        t = out["times"][tag] = {k: _device_ms(torch, f, reps=reps) for k, f in fns.items()}
        b = out["bounds"][tag] = _token_bounds(rows, m, n_tok, v)
        log(f"[token] {tag} device ms: fwd kernel {t['fwd']:.4f} plain {t['fwd_plain']:.4f} "
            f"bound {b['fwd'][0]:.5f} ({b['fwd'][1]}); bwd kernel {t['bwd']:.4f} plain "
            f"{t['bwd_plain']:.4f} bound {b['bwd'][0]:.5f} ({b['bwd'][1]})")
        del lat, voc, ids, g, want, got, fns
    return out


def _adam_trees(torch, dev, gen) -> dict:
    """Phase 23's trees: ``(p, g, m, v)`` at each of MOSI's and POM's
    width-32 decoders and sentiment heads, normal draws with small
    positive ``v``."""
    from mmtpu_torch.models.decoder import init_decoder
    from mmtpu_torch.models.sentiment import init_sentiment
    from mmtpu_torch.tree import tree_map

    out = {}
    for name, (audio, visual, n_out) in ADAM_GEOMETRY.items():
        for part, like in (("decoder", init_decoder(gen, 300, audio, visual, False, 300)),
                           ("sentiment", init_sentiment(gen, 300, 100, n_out))):
            def draw(scale=1.0, square=False, like=like):
                def one(t):
                    x = torch.randn(ADAM_K, *t.shape, generator=gen)
                    return (scale * (x.square() if square else x)).to(dev)
                return tree_map(one, like)

            out[f"{name}_{part}"] = (draw(), draw(), draw(0.1), draw(1e-4, square=True))
    return out


def _replayed(torch, fn):
    """A replay of ``fn`` captured in a CUDA graph, as the train step
    captures it (after an eager call): an eager call at a decoder tree
    would time the wrapper's host work."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def check_adam_kernel(torch, dev) -> dict:
    """Phase 23: the Adam kernel's tree and touch against the plain chain on
    the card, bit for bit, one launch a call and two calls bit for bit
    equal; device ms of kernel and chain per call, and the bounds."""
    import mmtpu_torch.kernels.adam as A
    from mmtpu_torch.train.optim import (adam_leaf, adam_plain, lazy_adam_catch_up,
                                         lazy_adam_coeffs)
    from mmtpu_torch.tree import tree_leaves, tree_map

    gen = torch.Generator().manual_seed(23)
    k = ADAM_K
    lr = (10.0 ** -torch.randint(2, 5, (k,), generator=gen).float()).to(dev)
    count0 = torch.randint(0, 2100, (k,), generator=gen, dtype=torch.int32).to(dev)
    c = (count0 + 1).float()
    bc1, bc2 = 1.0 - torch.pow(0.9, c), 1.0 - torch.pow(0.999, c)
    active = (torch.rand(k, generator=gen) < 0.8).to(dev)
    gate = (torch.rand(k, generator=gen) < 0.7).float().to(dev)
    cases = {}
    for tag, (p, g, m, v) in _adam_trees(torch, dev, gen).items():
        gates = None
        if tag.endswith("decoder"):  # fit_e2e's per-config heads gate
            gates = {"heads": tree_map(lambda _: gate, p["heads"]),
                     "norm": tree_map(lambda _: 1.0, p["norm"])}
        cases[tag] = ("tree", sum(t.numel() for t in tree_leaves(p)),
                      lambda p=p, g=g, m=m, v=v, gates=gates: A.adam_tree(
                          p, g, m, v, lr, bc1, bc2, active, gates),
                      lambda p=p, g=g, m=m, v=v, gates=gates: adam_plain(
                          p, g, m, v, lr, bc1, bc2, active, gates))
    b, d, steps = ADAM_TOUCH
    p, m, v = (torch.randn(k, steps * b, d, generator=gen).to(dev) for _ in range(3))
    v = 1e-4 * v.square()
    g = torch.randn(k, b, d, generator=gen).to(dev)
    coeffs = lazy_adam_coeffs(count0, steps, lr)
    for s in (0, steps - 1):  # views of the table (configs a table apart); the catch-up's
        blk = slice(s * b, (s + 1) * b)
        p_s, m_s, v_s = lazy_adam_catch_up(p[:, blk], m[:, blk], v[:, blk], s, coeffs)
        b1, b2 = coeffs[2][:, s], coeffs[3][:, s]
        cases[f"touch_s{s}"] = (
            "touch", p_s.numel(),
            lambda p_s=p_s, m_s=m_s, v_s=v_s, b1=b1, b2=b2: A.adam_touch(
                p_s, m_s, v_s, g, lr, b1, b2),
            lambda p_s=p_s, m_s=m_s, v_s=v_s, b1=b1, b2=b2: adam_leaf(
                p_s, g, m_s, v_s, lr, b1, b2))
    flat = lambda outs: [t for o in outs for t in tree_leaves(o)]  # noqa: E731
    out = {"times": {}, "bounds": {}, "floats": {}}
    for tag, (kind, floats, kernel, chain) in cases.items():
        before = dict(A.LAUNCHES)
        got = [flat(kernel()) for _ in range(2)]
        torch.cuda.synchronize()
        launched = {n: A.LAUNCHES[n] - before[n] for n in before}
        want = flat(chain())
        equal = all(torch.equal(x, y) for x, y in zip(got[0], want))
        same = all(torch.equal(x, y) for x, y in zip(got[0], got[1]))
        log(f"[adam] {tag} ({floats} floats): launches {launched}; bit-equal the chain "
            f"{equal}; repeat bit-equal {same}")
        if launched != {kind: 2, **{n: 0 for n in before if n != kind}}:
            raise AssertionError(f"the Adam kernel at {tag} launched {launched}, expected two "
                                 f"{kind} launches")
        if not (equal and same):
            raise AssertionError(f"the Adam kernel at {tag} differs from the chain or between "
                                 f"two calls")
        t = out["times"][tag] = {"kernel": _device_ms(torch, _replayed(torch, kernel), reps=50),
                                 "plain": _device_ms(torch, _replayed(torch, chain), reps=20)}
        bnd = out["bounds"][tag] = bound_ms(12.0 * floats, 28.0 * floats)
        out["floats"][tag] = floats
        log(f"[adam] {tag} device ms: kernel {t['kernel']:.4f} chain {t['plain']:.4f} bound "
            f"{bnd[0]:.5f} ({bnd[1]}), {100.0 * bnd[0] / t['kernel']:.1f} % of it")
    return out


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
    closed_form = []  # --time_test's result, as run_experiment returns it

    def time_closed_form(*args, **kw):
        closed_form.append(originals["time_closed_form"](*args, **kw))
        return closed_form[-1]

    originals["time_closed_form"] = runner.time_closed_form
    runner.time_closed_form = time_closed_form
    _reset_launches(K, T)
    try:
        t0 = time.perf_counter()
        rc = main([cfg_path, "mosi", "--e2e", "y" if e2e else "n", "--device", "cuda",
                   "--out_root", out_root, "--data_dir", data_dir, *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        runner.fit_latents, runner.fit_e2e = originals["fit_latents"], originals["fit_e2e"]
        runner.time_closed_form = originals["time_closed_form"]
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
    for k in ("k1_fwd", "k1_bwd", "tok_fwd", "tok_bwd"):
        if launches[k] < steps:
            raise AssertionError(f"{k} launched {launches[k]} times in the {tag} path, "
                                 f"expected at least {steps}")
    lazy = "--lazy_adam" in flags
    if cfg["optimizer"] != "adam":
        _hold_adam(launches, tag, 0, 0)
    elif e2e:  # each train step's; the inference fits step their tables on top
        _hold_adam(launches, tag, (2 if lazy else 3) * steps, steps if lazy else 0, at_least=True)
    train_s = sum(s for n, trains, s, _ in fits if trains)
    train_utt_s = 1284 * N_EPOCHS / train_s
    log(f"[{tag}] run.main wall {wall:.3f} s; train fit {train_s:.3f} s = "
        f"{train_utt_s:.1f} utt/s ({N_EPOCHS} epochs x 1284); fits "
        f"{[(n, round(s, 4)) for n, _, s, _ in fits]}; final loss {losses[-1]:.4f}; "
        f"launches {launches}")
    return {"launches": launches, "wall_s": wall, "train_utt_s": train_utt_s,
            "final_loss": float(losses[-1]), "post": post, "folder": folder,
            "train_fit": next(out for _, trains, _, out in fits if trains),
            "closed_form": closed_form[0] if closed_form else None}


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
        for f in (False, True):  # dense Adam: the decoder, the sentiment head, the table
            _hold_adam(res[f]["launches"], f"{'fused' if f else 'dense'} {kind} e2e fit",
                       3 * steps if kind == "adam" else 0, 0)
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
    _hold_adam(launches, "fused lazy e2e fit", 2 * steps, steps)
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
    _hold_adam(launches, "resumed Adam training fit", 2 * (N_EPOCHS - 1) * STEPS_PER_EPOCH, 0)
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
    if launches["tok_fwd"] != len(want_rows) or launches["tok_bwd"] != len(want_rows):
        raise AssertionError(f"token kernels launched {launches} in the chunk, expected "
                             f"{len(want_rows)} each (one per step, as K1)")
    _hold_adam(launches, "sweep chunk", 2 * train_steps, len(want_rows))

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
            "diverged": chunk.config_nums[chunk.diverged].tolist(), "k1": k1,
            "result": chunk}


def sgd_sweep_configs() -> list:
    """The first ``SWEEP_K`` configs of the grid's SGD / 100-epoch bucket, cut
    as ``sweep_configs``, with layer norm and lr 1e-4: as the grid has them
    (batch norm or lr 1e-3) SGD configs diverge at MOSI width (phase 4)."""
    from mmtpu_torch.config import make_grid

    bucket = [c for c in make_grid() if c["optimizer"] == "sgd" and c["n_epochs"] == 100]
    return [dict(c, n_epochs=SWEEP_EPOCHS, n_sentiment_epochs=SWEEP_SENTIMENT_EPOCHS,
                 norm="layer_norm", lr=1e-4) for c in bucket[:SWEEP_K]]


def run_fused_chunks(torch, K, T, tmp: str, dense_adam: dict) -> dict:
    """Phase 11: the sweep chunk with the fused decoder update
    (``run_chunk(..., fused_dec_update=True)``) beside the same chunk
    without it: phase 10's Adam configs, held to phase 10's dense chunk
    ``dense_adam`` (the same configs, data and options), and the SGD configs
    of ``sgd_sweep_configs``.  K2 twice per train step for the whole chunk, K1
    as in the dense chunk; each fused chunk held to its dense chunk (final
    loss rtol 2e-4, test predictions atol 5e-4; embeddings atol 2e-4 for
    SGD, and for Adam per config at most ``ADAM_EMB_OVER_SHARE`` of the
    coordinates above 2e-4 and none above ``ADAM_EMB_MAX_LR`` lr, for the
    reason given there); the train phase's rates side by side (printed, not
    claimed)."""
    return {"adam": fused_chunk(torch, K, T, tmp, "adam", sweep_configs(),
                                (dense_adam["result"], dense_adam["launches"])),
            "sgd": fused_chunk(torch, K, T, tmp, "sgd", sgd_sweep_configs())}


def fused_chunk(torch, K, T, tmp: str, kind: str, configs: list, dense=None) -> dict:
    """Phase 11 for one optimizer's configs: the chunk with the fused
    decoder update against the chunk without it (``dense``, a result and
    its launch counts, where the caller has it; else run here), their
    launches, agreement and rates."""
    import numpy as np

    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.sweep.runner import run_chunk

    dev = torch.device("cuda", 0)
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(load_dataset("mosi", data_dir=os.path.join(tmp, "data")),
                               pos_mode="shared", pos_dims=dims)
    n_train, k = prep.sif_init["train"].shape[0], len(configs)
    steps = SWEEP_EPOCHS * -(-n_train // 64)
    res, launches = {}, {}
    if dense is not None:
        res[False], launches[False] = dense
    for fused in [f for f in (False, True) if f not in res]:
        _reset_launches(K, T)
        res[fused] = run_chunk(configs, prep, batch_size=64, device=dev,
                               return_embeddings=True, fused_dec_update=fused)
        launches[fused] = _read_launches(K, T)
    dense, fused = res[False], res[True]
    want_k2 = {f"k2_{kk}": 2 * steps if kk == kind else 0 for kk in ("adam", "sgd")}
    got_k2 = {kk: launches[True][kk] for kk in want_k2}
    if got_k2 != want_k2 or any(launches[False][kk] for kk in want_k2):
        raise AssertionError(f"K2 launches: fused chunk {got_k2}, expected {want_k2}; "
                             f"dense chunk {launches[False]}")
    for kk in ("k1_fwd", "k1_bwd"):
        if launches[True][kk] != launches[False][kk] or not launches[True][kk]:
            raise AssertionError(f"{kk}: fused chunk {launches[True][kk]}, dense "
                                 f"{launches[False][kk]}")
    all_steps = steps + SWEEP_EPOCHS * sum(-(-prep.sif_init[s].shape[0] // 512)
                                           for s in ("valid", "test"))
    for f in (False, True):  # Adam: the decoder and the sentiment head; a touch every step
        _hold_adam(launches[f], f"{'fused' if f else 'dense'} {kind} chunk",
                   2 * steps if kind == "adam" else 0, all_steps if kind == "adam" else 0)
    if not np.array_equal(fused.diverged, dense.diverged) or dense.diverged.all():
        raise AssertionError(f"diverged configs differ: fused {fused.diverged}, dense "
                             f"{dense.diverged}")
    ok = ~dense.diverged
    loss_rel = float(np.max(np.abs(fused.final_train_loss[ok] - dense.final_train_loss[ok])
                            / np.abs(dense.final_train_loss[ok])))
    pred_abs = float(np.abs(fused.predictions[ok] - dense.predictions[ok]).max())
    emb_abs = {lr: 0.0 for lr in sorted({c["lr"] for c in configs})}
    emb_over, bad = 0, []
    for i in np.nonzero(ok)[0]:  # each config's embeddings, all three splits
        c = configs[i]
        d = np.concatenate([np.abs(fused.embeddings[s][i] - dense.embeddings[s][i])
                            for s in ("train", "valid", "test")])
        over = int((d > SWEEP_ATOL).sum())
        emb_abs[c["lr"]], emb_over = max(emb_abs[c["lr"]], float(d.max())), emb_over + over
        if over:
            log(f"[fused-sweep] {kind} config {c['config_num']} ({c['norm']}, lr {c['lr']}): "
                f"{over} of {d.size} embedding coordinates above {SWEEP_ATOL}, in "
                f"{int((d.max(-1) > SWEEP_ATOL).sum())} rows; max {float(d.max()):.3e} "
                f"({float(d.max()) / c['lr']:.2f} lr)")
        if kind == "sgd" and over or kind == "adam" and (
                over > ADAM_EMB_OVER_SHARE * d.size or d.max() > ADAM_EMB_MAX_LR * c["lr"]):
            bad.append(c["config_num"])
    rates = {f: k * n_train * SWEEP_EPOCHS / res[f].phase_s["train"] for f in res}
    log(f"[fused-sweep] {kind} chunk of {k} ({int(ok.sum())} finite): K2 launches "
        f"{got_k2} ({steps} train steps), K1 {launches[True]['k1_fwd']} of each kind as "
        f"the dense chunk; fused against dense: final loss max rel {loss_rel:.3e}, "
        f"predictions max abs {pred_abs:.3e}, embeddings max abs by lr {emb_abs} "
        f"({emb_over} coordinates above {SWEEP_ATOL} in all); train phase s dense "
        f"{dense.phase_s['train']:.3f} fused {fused.phase_s['train']:.3f}; "
        f"config-utterance-epochs/s dense {rates[False]:.1f} fused {rates[True]:.1f} "
        f"(printed, not claimed)")
    if not (loss_rel < SWEEP_RTOL and pred_abs < FUSED_PRED_ATOL) or bad:
        raise AssertionError(f"the fused {kind} chunk disagrees with the dense one (embeddings "
                             f"outside the gate in configs {bad})")
    return {"launches": launches[True], "loss_rel": loss_rel, "pred_abs": pred_abs,
            "emb_abs_by_lr": {str(lr): v for lr, v in emb_abs.items()},
            "emb_over_atol": emb_over, "rate_dense": rates[False], "rate_fused": rates[True],
            "train_s_dense": dense.phase_s["train"], "train_s_fused": fused.phase_s["train"]}


# runs `python -m mmtpu_torch.sweep <args>` and prints the kernel launch
# counts of that process on its last line
_SWEEP_CLI = """
import json, runpy, sys
import mmtpu_torch.kernels.angular as K
import mmtpu_torch.kernels.decoder_update as T
sys.argv = ["mmtpu_torch.sweep"] + sys.argv[1:]
try:
    runpy.run_module("mmtpu_torch.sweep", run_name="__main__", alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "k1_fwd": K.LAUNCHES["fwd"], "k1_bwd": K.LAUNCHES["bwd"],
                  "k2_adam": T.LAUNCHES["adam"], "k2_sgd": T.LAUNCHES["sgd"]}))
sys.exit(rc or 0)
"""


def cli_sweep_configs() -> list:
    """Phase 12's grid: ten configs of the grid's Adam / 100-epoch bucket and
    two of each other (optimizer, n_epochs) bucket, epochs cut 100 -> 1 and
    200 -> 2, sentiment epochs 400 -> ``SWEEP_SENTIMENT_EPOCHS``."""
    from mmtpu_torch.config import make_grid

    take = {("adam", 100): 10, ("adam", 200): 2, ("sgd", 100): 2, ("sgd", 200): 2}
    out = []
    for c in make_grid():
        key = (c["optimizer"], c["n_epochs"])
        if take.get(key, 0) > 0:
            take[key] -= 1
            out.append(dict(c, n_epochs=c["n_epochs"] // 100,
                            n_sentiment_epochs=SWEEP_SENTIMENT_EPOCHS))
    return out


def run_cli_sweep(torch, tmp: str) -> dict:
    """Phase 12: ``python -m mmtpu_torch.sweep mosi`` in a subprocess on the
    synthetic MOSI blobs at full width, ``--fused_dec``, 16 configs in
    chunks of 8 with a resume directory; then one chunk's entry taken out of
    ``sweep_state.json`` and the command run again: it computes that chunk
    only, and its CSV equals the first run's bit for bit."""
    import csv

    configs = cli_sweep_configs()
    cfg_dir, out_dir = os.path.join(tmp, "cli_cfgs"), os.path.join(tmp, "cli_results")
    resume = os.path.join(tmp, "cli_resume")
    os.makedirs(cfg_dir, exist_ok=True)
    for c in configs:
        with open(os.path.join(cfg_dir, f"config_{c['config_num']}.json"), "w") as f:
            json.dump(c, f)
    argv = ["mosi", "--configs_dir", cfg_dir, "--limit", str(len(configs)), "--chunk_size",
            "8", "--resume_dir", resume, "--fused_dec", "--phase_timing", "--device", "cuda",
            "--data_dir", os.path.join(tmp, "data"), "--out", out_dir, "--name", "cli"]
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(tag):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _SWEEP_CLI, *argv], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the sweep CLI ({tag}) exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        launches = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(os.path.join(out_dir, "cli_summary.json")) as f:
            summary = json.load(f)
        with open(os.path.join(out_dir, "cli.csv"), "rb") as f:
            table = f.read()
        return {"wall_s": wall, "launches": launches, "summary": summary, "csv": table}

    first = run("first")
    chunks = [c["chunk"] for c in first["summary"]["chunks"]]
    n_train, n_valid, n_test = 1284, 229, 686
    epochs = {cid: int(cid.split("_")[0][len(kind):]) for cid, kind in
              ((c["chunk"], c["kind"]) for c in first["summary"]["chunks"])}
    per_epoch_k1 = -(-n_train // 64) + -(-n_valid // 512) + -(-n_test // 512)
    want = {"k1_fwd": sum(epochs.values()) * per_epoch_k1}
    want["k1_bwd"] = want["k1_fwd"]
    for kind in ("adam", "sgd"):
        want[f"k2_{kind}"] = sum(2 * ne * -(-n_train // 64) for cid, ne in epochs.items()
                                 if cid.startswith(kind))
    got = {k: first["launches"][k] for k in want}
    rows = list(csv.DictReader(first["csv"].decode().splitlines()))
    finite = sum(all(r[m] not in ("nan", "") for m in ("final_train_loss", "mae", "corr"))
                 for r in rows)
    log(f"[cli-sweep] python -m mmtpu_torch.sweep: {len(rows)} rows ({finite} finite), chunks "
        f"{chunks}, wall {first['wall_s']:.1f} s (summary wall "
        f"{first['summary']['wall_time_s']} s, kernel build "
        f"{first['summary']['compile_time_s']} s); launches {got}")
    if chunks != ["adam1_0", "adam1_1", "adam2_0", "sgd1_0", "sgd2_0"]:
        raise AssertionError(f"the CLI sweep ran chunks {chunks}")
    if got != want:
        raise AssertionError(f"the CLI sweep launched {got}, expected {want}")
    if len(rows) != len(configs) or finite == 0:
        raise AssertionError(f"the CLI sweep's CSV has {len(rows)} rows, {finite} finite")

    state_path = os.path.join(resume, "sweep_state.json")
    with open(state_path) as f:
        state = json.load(f)
    dropped = "adam1_1"
    state["chunks"].remove(dropped)
    with open(state_path, "w") as f:
        json.dump(state, f)
    again = run("resumed")
    redone = [c["chunk"] for c in again["summary"]["chunks"]]
    same = again["csv"] == first["csv"]
    log(f"[cli-sweep] resumed without {dropped}: computed {redone}, launches "
        f"{ {k: again['launches'][k] for k in want} }, wall {again['wall_s']:.1f} s; CSV "
        f"bit-equal {same}")
    if redone != [dropped] or again["launches"]["k2_adam"] != 2 * -(-n_train // 64):
        raise AssertionError(f"the resumed CLI sweep computed {redone}, launches "
                             f"{again['launches']}")
    if not same:
        raise AssertionError("the resumed CLI sweep's CSV differs from the first run's")
    return {"launches": got, "launches_resumed": {k: again["launches"][k] for k in want},
            "chunks": chunks, "rows": len(rows), "finite_rows": finite,
            "wall_s": first["wall_s"], "wall_s_resumed": again["wall_s"],
            "summary": {k: v for k, v in first["summary"].items() if k != "chunks"}}


def _host_ms(torch, fn, reps: int = 8) -> float:
    """Median host-clock ms of one call that ends with its result on the host,
    the device synchronised before each; after one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# traces one request of each form (raw, stats), moved to the card first,
# through a ClosedFormServer built from the payload at argv[1], in a fresh
# process: a
# process's second torch.profiler session records no device event, and phase 3
# holds this one's first.  Prints, per form, the device events per call, their
# summed device time per call (kernels and copies) and the traced wall time
# per call; the busy times are null where the trace holds no device event.
_SERVE_TRACE = """
import json, sys, time
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from mmtpu_torch.serve import ClosedFormServer
torch.backends.cuda.matmul.allow_tf32 = False
p = torch.load(sys.argv[1], weights_only=False)
server = ClosedFormServer(p["dec"], batch_sizes=p["ladder"], sentiment_params=p["senti"],
                          word_embeddings=p["vocab"], device="cuda")
forms = {name: {k: torch.as_tensor(v).to("cuda", torch.float32 if v.dtype.kind == "f"
                                          else torch.int64) for k, v in r.items()}
         for name, r in p["forms"].items()}
reps, walls = 8, {}
for f in forms.values():
    server(f), server(f)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for name, f in forms.items():
        with record_function("serve_" + name):
            t0 = time.perf_counter()
            for _ in range(reps):
                server(f)
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3 / reps
events, cuda = prof.events(), torch.autograd.DeviceType.CUDA
device = [e for e in events if e.device_type == cuda and not e.name.startswith("serve_")]
out = {}
for name in forms:
    span = next(e.time_range for e in events
                if e.name == "serve_" + name and e.device_type != cuda)
    inside = [e for e in device if span.start <= e.time_range.start <= span.end]
    busy = sum(e.time_range.elapsed_us() for e in inside) / 1e3 / reps
    out[name] = {"device_events": len(inside) / reps, "wall_ms": walls[name],
                 "busy_ms": busy if inside else None,
                 "busy_share": busy / walls[name] if inside else None}
print(json.dumps(out))
"""


def trace_serving(torch, tmp: str, payload: dict) -> dict:
    """Runs ``_SERVE_TRACE`` on ``payload`` in a subprocess; its result."""
    path = os.path.join(tmp, "serve_trace.pt")
    torch.save(payload, path)
    proc = subprocess.run([sys.executable, "-c", _SERVE_TRACE, path], cwd=tmp,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the serving trace exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _on_device(torch, r: dict, dev) -> dict:
    """A request's arrays as device tensors (float32 or int64)."""
    return {k: (torch.as_tensor(v).to(dev) if v.dtype.kind == "f"
                else torch.as_tensor(v).long().to(dev)) for k, v in r.items()}


def run_serving(torch, K, T, tmp: str, e2e: dict) -> dict:
    """Phase 13: ``--time_test`` of phase 5's run; that run's decoder through
    ``closed_form_latents`` on the card against the CPU; a
    ``ClosedFormServer`` on the card (ladder ``SERVE_LADDER``, the run's
    sentiment head, the vocabulary): raw against stats requests, padding,
    a request above the ladder against its halves, latencies."""
    import numpy as np

    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.convert import to_torch
    from mmtpu_torch.models.decoder import MMB2_HEADS
    from mmtpu_torch.ops.closed_form import closed_form_latents
    from mmtpu_torch.runner import prepare
    from mmtpu_torch.serve import ClosedFormServer, assemble_head_data, stats_request
    from mmtpu_torch.tree import tree_map

    dev = torch.device("cuda", 0)
    cf = e2e["closed_form"]
    log(f"[serve] --time_test of the e2e run: latency_s {cf['latency_s']:.6f} for "
        f"{cf['n_utterances']} test utterances (one warm call, synced)")
    if cf["n_utterances"] != 686 or not cf["latency_s"] > 0:
        raise AssertionError(f"--time_test returned {cf}")
    _, dec, senti = e2e["train_fit"][:3]
    prep = prepare(ExperimentConfig.from_dict(smoke_config(True)), os.path.join(tmp, "data"))
    d = prep.splits["test"]

    def latents(where):
        streams = {k: to_torch(d[k], where) for k in ("text_gauss", "audio", "visual")}
        vocab = to_torch(prep.vocab_embeddings, where)
        with torch.no_grad():
            return closed_form_latents(assemble_head_data(streams, MMB2_HEADS),
                                       tree_map(lambda t: t.detach().to(where), dec["heads"]),
                                       to_torch(d["text_weights"], where),
                                       vocab[to_torch(d["text_ids"], where)])

    got, want = latents(dev).cpu(), latents("cpu")
    cf_abs = (got - want).abs().max().item()
    over = ((got - want).abs() - (CF_ATOL + CF_RTOL * want.abs())).max().item()
    log(f"[serve] closed_form_latents on the card against the CPU (686 x 300, the run's "
        f"decoder): max abs {cf_abs:.3e}; finite {bool(torch.isfinite(got).all())}")
    if over > 0 or not torch.isfinite(got).all():
        raise AssertionError("closed_form_latents on the card disagrees with the CPU")

    _reset_launches(K, T)
    server = ClosedFormServer(dec, batch_sizes=SERVE_LADDER, sentiment_params=senti,
                              word_embeddings=prep.vocab_embeddings, device=dev)
    keys = ("text_ids", "text_weights", "text_gauss", "audio", "visual")
    test = {k: d[k] for k in keys}
    big = {k: np.concatenate([prep.splits["train"][k], prep.splits["valid"][k]])[:SERVE_BIG]
           for k in keys}
    reqs = {n: {k: v[:n] for k, v in test.items()} for n in (3, 64)}
    reqs[686], reqs[SERVE_BIG] = test, big
    server.warmup({k: v[:2] for k, v in test.items()})
    out = {n: server(r) for n, r in reqs.items()}
    checks = {}
    for n in (64, 686):
        lat_s, pred_s = server(stats_request(reqs[n]))
        checks[f"stats_vs_raw_{n}"] = max(float(np.abs(lat_s - out[n][0]).max()),
                                          float(np.abs(pred_s - out[n][1]).max()))
    checks["rows3_vs_64"] = float(np.abs(out[3][0] - out[64][0][:3]).max())
    half = SERVE_BIG // 2
    halves = [server({k: v[sl] for k, v in big.items()})
              for sl in (slice(0, half), slice(half, None))]
    checks["above_ladder_vs_halves"] = max(
        float(np.abs(np.concatenate([h[i] for h in halves]) - out[SERVE_BIG][i]).max())
        for i in (0, 1))
    finite = all(np.isfinite(o[i]).all() for o in out.values() for i in (0, 1))
    log(f"[serve] server on the card, ladder {SERVE_LADDER}: max abs differences {checks} "
        f"(limit {SERVE_ATOL}); outputs finite {finite}")
    if not finite or max(checks.values()) > SERVE_ATOL:
        raise AssertionError("the server on the card is not padding- or path-invariant")

    latency = {}
    for n, r in reqs.items():
        sr = stats_request(r)
        forms = {"device_raw": _on_device(torch, r, dev),
                 "device_stats": _on_device(torch, sr, dev), "host_raw": r, "host_stats": sr}
        latency[n] = {name: _host_ms(torch, lambda f=f: server(f)) for name, f in forms.items()}
        log(f"[serve] {n} rows: median of 8 ms " + ", ".join(
            f"{name} {ms:.3f}" for name, ms in latency[n].items()))
    launches = _read_launches(K, T)
    if any(launches.values()):
        raise AssertionError(f"the server launched {launches}: it runs no kernel of the port")
    trace = trace_serving(torch, tmp, {
        "dec": tree_map(lambda t: t.detach().cpu(), dec),
        "senti": tree_map(lambda t: t.detach().cpu(), senti),
        "vocab": prep.vocab_embeddings, "ladder": SERVE_LADDER,
        "forms": {"device_raw": test, "device_stats": stats_request(test)}})
    for form, t in trace.items():
        busy = ("not measured (the trace holds no device event)" if t["busy_ms"] is None
                else f"device busy {t['busy_ms']:.3f} ms, {100 * t['busy_share']:.1f} % of it")
        log(f"[serve] 686 rows, {form}, traced (torch.profiler, 8 calls): "
            f"{t['device_events']:.0f} device events per call, wall {t['wall_ms']:.3f} ms, {busy}")
    return {"launches": launches, "time_test": cf, "cf_abs": cf_abs, "checks": checks,
            "latency_ms": latency, "trace_686": trace}


def run_warm_chunk(torch, K, T, tmp: str, dense: dict) -> dict:
    """Phase 14: phase 10's configs through ``run_chunk`` with
    ``infer_warm_start`` and ``infer_epochs_cap=1``: each config's inference
    init against a 2-D ``closed_form_latents_from_stats`` of its own
    decoder, the train fit against phase 10's, finite results, and K1's
    launches beside phase 10's.  Then phase 10's configs uncapped and the
    warm-started chunk again, both already warm, for the infer phases'
    seconds: phase 10's own call was the first of its shapes."""
    import numpy as np

    import mmtpu_torch.sweep.runner as sweep_runner
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.tree import tree_map

    dev = torch.device("cuda", 0)
    configs = sweep_configs()
    k = len(configs)
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(load_dataset("mosi", data_dir=os.path.join(tmp, "data")),
                               pos_mode="shared", pos_dims=dims)
    n_train, n_valid, n_test = (prep.sif_init[s].shape[0] for s in ("train", "valid", "test"))
    warm = sweep_runner.closed_form_latents_from_stats
    inits = []

    def recording(dec, data, vocab, **kw):
        inits.append((dec, data, vocab, kw, warm(dec, data, vocab, **kw)))
        return inits[-1][-1]

    sweep_runner.closed_form_latents_from_stats = recording
    _reset_launches(K, T)
    try:
        chunk = sweep_runner.run_chunk(configs, prep, batch_size=64, device=dev,
                                       return_embeddings=True, infer_warm_start=True,
                                       infer_epochs_cap=1)
    finally:
        sweep_runner.closed_form_latents_from_stats = warm
    launches = _read_launches(K, T)
    init_abs = 0.0
    for dec, data, vocab, kw, got in inits:
        for i in range(k):
            want = warm(tree_map(lambda t: t[i], dec), dict(data, pos_mask=data["pos_mask"][i, 0]),
                        vocab, **kw)
            init_abs = max(init_abs, (got[i] - want).abs().max().item())
    steps = SWEEP_EPOCHS * -(-n_train // 64) + -(-n_valid // 512) + -(-n_test // 512)
    base = dense["result"]
    steady = {"uncapped": sweep_runner.run_chunk(configs, prep, batch_size=64, device=dev,
                                                 return_embeddings=True),
              "warm": sweep_runner.run_chunk(configs, prep, batch_size=64, device=dev,
                                             return_embeddings=True, infer_warm_start=True,
                                             infer_epochs_cap=1)}
    infer_s = {name: r.phase_s["valid_infer"] + r.phase_s["test_infer"]
               for name, r in (*steady.items(), ("phase10_first", base))}
    ok = ~chunk.diverged
    results = [chunk.embeddings[s] for s in ("train", "valid", "test")] + [
        chunk.predictions, chunk.final_train_loss]
    finite = bool(ok.any()) and all(np.isfinite(r[ok]).all() for r in results)
    train_rel = float(np.max(np.abs(chunk.final_train_loss[ok] - base.final_train_loss[ok])
                             / np.abs(base.final_train_loss[ok])))
    log(f"[warm] chunk of {k}, inference from the closed form, capped at 1 epoch: "
        f"{len(inits)} warm starts (valid, test), each config's init against its 2-D call: "
        f"max abs {init_abs:.3e}; train loss against phase 10 max rel {train_rel:.3e}; "
        f"diverged {int(chunk.diverged.sum())} (phase 10: {int(base.diverged.sum())}); "
        f"finite {finite}; infer phases s, both warm: warm-started {infer_s['warm']:.3f}, "
        f"uncapped {infer_s['uncapped']:.3f} ({infer_s['warm'] / infer_s['uncapped']:.3f}x; "
        f"phase 10's first call {infer_s['phase10_first']:.3f}); K1 launches "
        f"{launches['k1_fwd']} / {launches['k1_bwd']} against phase 10's {dense['launches']['k1_fwd']} / "
        f"{dense['launches']['k1_bwd']}")
    if len(inits) != 2 or init_abs > WARM_INIT_ATOL:
        raise AssertionError("the warm starts differ from their per-config closed forms")
    if launches["k1_fwd"] != steps or launches["k1_bwd"] != steps or launches["k2_adam"]:
        raise AssertionError(f"the warm-started chunk launched {launches}, expected K1 {steps}")
    if not finite or not np.array_equal(chunk.diverged, base.diverged) or train_rel > 1e-6:
        raise AssertionError("the warm-started chunk's train fit or results are off")
    return {"launches": launches, "init_abs": init_abs, "train_loss_rel": train_rel,
            "infer_s": infer_s, "phase_s": chunk.phase_s}


def _alternating_inputs(torch, tmp: str) -> tuple:
    """``(prep, train split, params)`` of phase 15's alternating fit: the
    bimodal generator at 300 -> audio 74, visual 47, drawn from seed 0, on
    the CPU."""
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.models.legacy import init_audio_visual_generator

    prep = prepare_device_data(load_dataset("mosi", data_dir=os.path.join(tmp, "data")))
    keys = ("text_ids", "text_weights", "text_mask", "audio", "audio_mask", "visual",
            "visual_mask")
    params = init_audio_visual_generator(torch.Generator().manual_seed(0), prep.embed_dim,
                                         prep.audio_dim, prep.visual_dim)
    return prep, {k: prep.splits["train"][k] for k in keys}, params


def run_alternating(torch, K, T, tmp: str) -> dict:
    """Phase 15: ``fit_alternating`` on the MOSI train split (the bimodal
    generator at 300 -> audio 74, visual 47; batch 32, ``ALT_EPOCHS``
    epochs) on the card, K1's forward once per step and never its backward,
    against the same fit on the CPU from the same parameters."""
    from mmtpu_torch.convert import to_torch
    from mmtpu_torch.train.alternating import AlternatingFitSpec, fit_alternating
    from mmtpu_torch.tree import tree_map

    dev = torch.device("cuda", 0)
    prep, train, params = _alternating_inputs(torch, tmp)
    spec = AlternatingFitSpec(n_epochs=ALT_EPOCHS, batch_size=32)
    steps = ALT_EPOCHS * -(-train["audio"].shape[0] // 32)

    def fit(where, s=spec):
        return fit_alternating(tree_map(lambda t: t.to(where), params), to_torch(train, where),
                               to_torch(prep.vocab_embeddings, where), lr=ALT_LR,
                               word_loss_weight=ALT_WORD_WEIGHT, spec=s)

    fit(dev, dataclasses.replace(spec, n_epochs=1))  # untimed warm-up epoch
    torch.cuda.synchronize()
    _reset_launches(K, T)
    t0 = time.perf_counter()
    lat, _, losses = fit(dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_launches(K, T)
    lat_c, _, losses_c = fit("cpu")
    loss_rel = ((losses.cpu() - losses_c).abs() / losses_c.abs()).max().item()
    lat_abs = (lat.cpu() - lat_c).abs().max().item()
    log(f"[alternating] {ALT_EPOCHS} epochs x {steps // ALT_EPOCHS} batches of 32: "
        f"{secs / ALT_EPOCHS:.4f} s/epoch on the card; launches {launches}; epoch losses "
        f"{[round(x, 4) for x in losses.tolist()]}; against the CPU: losses max rel "
        f"{loss_rel:.3e}, latents max abs {lat_abs:.3e}")
    if launches != {"k1_fwd": steps, "k1_bwd": 0, "k2_adam": 0, "k2_sgd": 0, "tok_fwd": 0,
                    "tok_bwd": 0, "adam_tree": 0, "adam_touch": 0}:
        raise AssertionError(f"the alternating fit launched {launches}, expected K1-fwd {steps}")
    if not (torch.isfinite(losses).all() and torch.isfinite(lat).all()
            and loss_rel < ALT_LOSS_RTOL and lat_abs < ALT_LAT_ATOL):
        raise AssertionError("the alternating fit on the card disagrees with the CPU")
    k1_err = check_alternating_k1(torch, K, lat, to_torch(prep.vocab_embeddings, dev))
    return {"launches": launches, "s_per_epoch": secs / ALT_EPOCHS, "loss_rel": loss_rel,
            "lat_abs": lat_abs, "losses": losses.tolist(), "k1_fwd_err": k1_err, "prep": prep}


def check_alternating_k1(torch, K, lat, voc) -> float:
    """K1's forward through the wrapper the alternating fit calls
    (``angular_partition``) on the fit's first and last 32-row batches of
    its final latents (the last is padded with row 0, as the fit pads it),
    against the plain version at phase 2's gates: the fit's own check cannot
    see Z, whose term enters its loss at weight ``ALT_WORD_WEIGHT``.
    Returns the largest absolute error."""
    n = lat.shape[0]
    tail = n - (n - 1) % 32 - 1
    batches = {"first": lat[:32],
               "last": torch.cat([lat[tail:], lat[:1].expand(32 - (n - tail), -1)])}
    err = 0.0
    for name, batch in batches.items():
        z_k = K.angular_partition(batch, voc)
        z_p = K.angular_partition_ref(batch, voc)
        sum_rel = abs(z_k.sum().item() - z_p.sum().item()) / abs(z_p.sum().item())
        elem_rel = ((z_k - z_p).abs() / z_p.abs()).max().item()
        err = max(err, (z_k - z_p).abs().max().item())
        log(f"[alternating] K1-fwd on the fit's {name} batch (rows {tuple(batch.shape)}): "
            f"sum rel {sum_rel:.3e}, elem rel {elem_rel:.3e}")
        if not (z_k.shape == (32, 1) and sum_rel < FWD_SUM_REL and elem_rel < FWD_RTOL):
            raise AssertionError(f"K1 forward disagrees on the alternating fit's {name} batch")
    return err


def check_numeric_ops(torch, prep) -> dict:
    """Phase 16: SIF, posenc and nearest words on the card against the CPU at
    MOSI width (the train split, vocabulary 3016 x 300)."""
    import numpy as np

    import mmtpu_torch.ops as ops
    from mmtpu_torch.analysis import closest_word_ids

    dev = torch.device("cuda", 0)
    tr = prep.splits["train"]
    on = lambda x, where: torch.as_tensor(x).to(where)  # noqa: E731
    errs = {}

    def compare(name, fn):
        got, want = fn(dev).cpu(), fn("cpu")
        over = ((got - want).abs() - (OPS_ATOL + OPS_RTOL * want.abs())).max().item()
        errs[name] = (got - want).abs().max().item()
        if over > 0:
            raise AssertionError(f"{name} on the card disagrees with the CPU")

    ids = torch.as_tensor(tr["text_ids"]).long()
    compare("seq_weights", lambda w: ops.seq_weights(ids.to(w), on(prep.word_weights, w)))
    compare("sif_embedding", lambda w: ops.sif_embedding(on(prep.vocab_embeddings, w),
                                                         ids.to(w), on(tr["text_weights"], w)))
    for bug in (False, True):
        compare(f"add_positional_embeddings bug_parity={bug}",
                lambda w: ops.add_positional_embeddings(on(tr["audio"], w), 4, bug_parity=bug))
    emb = ops.sif_embedding(on(prep.vocab_embeddings, "cpu"), ids, on(tr["text_weights"], "cpu"))
    got = closest_word_ids(emb.to(dev), on(prep.vocab_embeddings, dev), k=5)
    want = closest_word_ids(emb, prep.vocab_embeddings, k=5)
    # ties aside, the same words: compare the picks' cosines in float64
    e64 = emb.double() / emb.double().norm(dim=-1, keepdim=True)
    v64 = torch.as_tensor(prep.vocab_embeddings).double()
    sims = e64 @ (v64 / v64.norm(dim=-1, keepdim=True)).T
    pick = lambda i: torch.gather(sims, 1, torch.as_tensor(i))  # noqa: E731
    errs["closest_word_ids cosine"] = (pick(got) - pick(want)).abs().max().item()
    same = float(np.mean(got == want))
    log(f"[ops] card against CPU, max abs: {errs}; closest_word_ids identical share {same}")
    if errs["closest_word_ids cosine"] > OPS_ATOL:
        raise AssertionError("closest_word_ids on the card picks other words than the CPU")
    return {"max_abs": errs, "closest_same_share": same}


# phase 17: the mesh fits and the multi-process sweep on the one card.  K1 at
# the shards' shapes: MOSI's 3016-row vocabulary over 2 and 4 vocab ranks, the
# 64- and 512-row batches over 2 and 4 data ranks
MESH_SHARD_SHAPES = [(32, 300, 1508), (16, 300, 754), (64, 300, 1508), (256, 300, 1508)]
# the mesh fits against the single-device fits (tests/test_parallel.py)
MESH_LOSS_RTOL, MESH_LOSS_ATOL = 2e-4, 1e-5
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 2e-3, 2e-5
# the multi-process sweep against the single-process sweep: SGD configs at
# layer norm and lr 1e-4 (sgd_sweep_configs' reason), whose results move
# only by float order; Adam's lr x sign(g) first step would move a few
# coordinates by lr (phase 11)
MULTIHOST_RTOL = 2e-4
# one step's loss and latent gradient on a vocab-sharded mesh against one
# device with the whole table: relative error of the loss, and of the
# gradient against its largest entry (entries reach ~1e2 at MOSI width, and
# the batch split's float order moves them by ~1e-6 of that, the card's
# reading; a gradient part counted twice moves them by O(1))
STEP_MAX_REL = 1e-5
MESH_SHARED = "N ranks sharing one card, not a scaling number"
WORKER_TIMEOUT_S = 600


def _torchrun(n: int, script: str, args: list, tmp: str, tag: str) -> dict:
    """Start ``torchrun --standalone`` with ``n`` processes of ``script``
    (its own free port) as :func:`_start` does."""
    return _start([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(n), script, *args], tmp, tag)


def _start(cmd: list, tmp: str, tag: str) -> dict:
    """Start ``cmd`` in ``tmp``, its output into ``<tmp>/<tag>.log``; a
    thread notes when it ends.  :func:`_wait_all` collects it."""
    import threading

    job = {"log": os.path.join(tmp, f"{tag}.log"), "t0": time.perf_counter()}
    job["out"] = open(job["log"], "w")
    # a session of its own, so that _stop ends torchrun's workers with it
    job["proc"] = subprocess.Popen(cmd, cwd=tmp, env=dict(os.environ, PYTHONPATH=ROOT),
                                   stdout=job["out"], stderr=subprocess.STDOUT, text=True,
                                   start_new_session=True)

    def note_end():
        job["proc"].wait()
        job["end"] = time.perf_counter()

    threading.Thread(target=note_end, daemon=True).start()
    return job


def _stop(jobs: dict) -> None:
    """Kill every process of the jobs that still runs, and close their logs."""
    import signal

    for job in jobs.values():
        if job["proc"].poll() is None:
            os.killpg(job["proc"].pid, signal.SIGKILL)
            job["proc"].wait()
        job["out"].close()


def _wait_all(jobs: dict) -> dict:
    """Wait for :func:`_torchrun` jobs, each at most ``WORKER_TIMEOUT_S``
    from its start; raise with a failed job's log end.  Returns ``{tag:
    (wall seconds from its start to its end, log text)}``; every process
    has ended on return."""
    try:
        for tag, job in jobs.items():
            left = WORKER_TIMEOUT_S - (time.perf_counter() - job["t0"])
            try:
                job["proc"].wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{tag} did not end within {WORKER_TIMEOUT_S} s") from None
    finally:
        _stop(jobs)
    walls = {}
    for tag, job in jobs.items():
        with open(job["log"]) as f:
            text = f.read()
        if job["proc"].returncode != 0:
            raise AssertionError(f"{tag} exited {job['proc'].returncode}:\n{text[-4000:]}")
        while "end" not in job:  # the noting thread runs on after wait() returns
            time.sleep(0.01)
        walls[tag] = (job["end"] - job["t0"], text)
    return walls


def _latent_inputs(torch, cfg: dict, data_dir: str, dev) -> tuple:
    """The non-e2e training fit's inputs of ``run_experiment`` for ``cfg``
    (``Draws(seed)``: the decoder, then the permutations) on ``dev``."""
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.convert import to_torch
    from mmtpu_torch.runner import Draws, build_hp, prepare
    from mmtpu_torch.train.latents import LatentFitSpec, train_view
    from mmtpu_torch.tree import tree_map

    ecfg = ExperimentConfig.from_dict(cfg)
    prep = prepare(ecfg, data_dir)
    draws = Draws(ecfg.seed)
    dec = tree_map(lambda t: t.to(dev), draws.init_decoder(
        prep.embed_dim, prep.audio_dim, prep.visual_dim, ecfg.unimodal, prep.text_gauss_dim))
    perms = draws.train_permutations(prep.sif_init["train"].shape[0], ecfg.n_epochs)
    spec = LatentFitSpec(n_epochs_max=ecfg.n_epochs, batch_size=ecfg.batch_size,
                         train_decoder=True, unimodal=False, opt_kind=ecfg.optimizer)
    return (to_torch(prep.sif_init["train"], dev), dec,
            to_torch(train_view(prep.splits["train"]), dev),
            to_torch(prep.vocab_embeddings, dev), build_hp(ecfg, dev), spec, perms)


def mesh_bn_config() -> dict:
    """Phase 4's config with batch norm at lr 1e-5, for the batch-sharded
    fit: at lr 1e-4 SGD with batch norm diverges at MOSI width in its
    second epoch, on one device as on the mesh (on the CPU too)."""
    return dict(smoke_config(False), norm="batch_norm", lr=1e-5)


def multihost_configs() -> list:
    """Phase 17's sweep: four configs each of the grid's SGD / 100- and
    200-epoch buckets, epochs cut 100 -> 1 and 200 -> 2, sentiment epochs
    400 -> ``SWEEP_SENTIMENT_EPOCHS``, at layer norm and lr 1e-4."""
    from mmtpu_torch.config import make_grid

    out, take = [], {100: 4, 200: 4}
    for c in make_grid():
        if c["optimizer"] == "sgd" and take.get(c["n_epochs"], 0) > 0:
            take[c["n_epochs"]] -= 1
            out.append(dict(c, n_epochs=c["n_epochs"] // 100, norm="layer_norm", lr=1e-4,
                            n_sentiment_epochs=SWEEP_SENTIMENT_EPOCHS))
    return out


def _multihost_prep(data_dir: str, configs: list):
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset

    dims = tuple(sorted({c["pos_embed_dim"] for c in configs} - {0}))
    return prepare_device_data(load_dataset("mosi", data_dir=data_dir), pos_mode="shared",
                               pos_dims=dims)


def _sweep_columns(res) -> dict:
    return {"final_train_loss": res.final_train_loss, "config_nums": res.config_nums,
            **{f"m:{k}": v for k, v in res.metrics.items()}}


def vocab_shard_check(torch, K, mesh, dev, data_dir: str) -> dict:
    """On a vocab-sharded ``mesh``, the first batch of phase 4's training
    fit through the fit's own placement (``place_fit_inputs``: this rank's
    ``VocabShard`` and batch block).  (1) ``Z`` of this rank's rows and its
    latent gradient under a cotangent held alike by the ranks, against the
    plain versions over the whole 3016-row vocabulary at phase 2's gates;
    the latents are SIF vectors of norm ~0.1, whose gradients reach ~1e2,
    so phase 2's unit-scale atol holds relative to the gradient's largest
    entry (stricter than its max-rel gate).  (2) The step's loss and its latent gradient as the fit takes
    them (``batch_neg_log_prob``, ``BatchShard.total`` / ``rows``) against
    the same loss on one device with the whole table, at ``STEP_MAX_REL``.  A ``Z`` left unsummed over the vocab group, or a latent
    gradient summed over it whole (the heads' part counted n_v times),
    fails here: the fits cannot show either, as the word term's weight
    (0.002) keeps its change below the embeddings' ulp at lr 1e-4."""
    from mmtpu_torch.parallel.collectives import VocabShard
    from mmtpu_torch.parallel.fit import place_fit_inputs
    from mmtpu_torch.train.latents import batch_neg_log_prob, batch_shard, gather_batch

    emb0, dec, data, vocab, hp, spec, perms = _latent_inputs(
        torch, smoke_config(False), data_dir, dev)
    shard_v, spec_m = place_fit_inputs(mesh, vocab, spec, "data", "vocab")
    if not isinstance(shard_v, VocabShard) or shard_v.table.shape[0] == vocab.shape[0]:
        raise AssertionError(f"the vocabulary is not sharded on the {mesh.shape} mesh")
    bsz = spec.batch_size
    j = torch.as_tensor(perms[0][:bsz], device=dev)
    shard_b = batch_shard(spec_m, mesh, hp, emb0)
    blk = shard_b.block(bsz)
    lat_all = emb0[j]
    lat = lat_all[blk].contiguous()
    g = torch.randn(bsz, 1, generator=torch.Generator().manual_seed(170)).to(dev)[blk]

    lat_m = lat.clone().requires_grad_()
    z_m = shard_v.partition(lat_m)
    (dl_m,) = torch.autograd.grad(torch.sum(z_m * g), lat_m)
    z_p = K.angular_partition_ref(lat, vocab)
    dl_p = K.angular_partition_bwd_ref(lat, vocab, torch.linalg.vector_norm(vocab, dim=-1), g)
    z_sum_rel = abs(z_m.sum().item() - z_p.sum().item()) / abs(z_p.sum().item())
    z_rel = ((z_m - z_p).abs() / z_p.abs()).max().item()
    dl_rel = ((dl_m - dl_p).abs().max() / dl_p.abs().max()).item()
    if not (z_sum_rel < FWD_SUM_REL and z_rel < FWD_RTOL):
        raise AssertionError(f"{mesh.shape} mesh: the sharded Z is not the whole "
                             f"vocabulary's (sum rel {z_sum_rel:.3e}, elem rel {z_rel:.3e})")
    if not dl_rel < GRAD_ATOL:
        raise AssertionError(f"{mesh.shape} mesh: the sharded Z's latent gradient is not the "
                             f"whole vocabulary's (max rel {dl_rel:.3e})")

    valid = torch.ones(bsz, device=dev)
    rows = lat.clone().requires_grad_()
    loss = batch_neg_log_prob(rows, dec, gather_batch(data, j[blk]), shard_v, hp, spec_m,
                              valid[blk], shard_b, torch.sum(valid))
    (g_rows,) = torch.autograd.grad(loss, rows)
    loss, g_rows = shard_b.total(loss), shard_b.rows(g_rows, bsz)
    rows_1 = lat_all.clone().requires_grad_()
    loss_1 = batch_neg_log_prob(rows_1, dec, gather_batch(data, j), vocab, hp, spec, valid)
    (g_1,) = torch.autograd.grad(loss_1, rows_1)
    loss_rel = abs(loss.item() - loss_1.item()) / abs(loss_1.item())
    g_rel = ((g_rows - g_1).abs().max() / g_1.abs().max()).item()
    if not (loss_rel < STEP_MAX_REL and g_rel < STEP_MAX_REL):
        raise AssertionError(f"{mesh.shape} mesh: one step's loss (rel {loss_rel:.3e}) or "
                             f"latent gradient (max rel {g_rel:.3e}) is not one device's")
    return {"z_elem_rel": z_rel, "z_grad_max_rel": dl_rel, "step_loss_rel": loss_rel,
            "step_grad_max_rel": g_rel}


def mesh_worker(argv: list) -> int:
    """One rank of phase 17's worlds (``chip_smoke.py --mesh-worker JOB TMP``
    under torchrun): CUDA ranks sharing card 0 over gloo.  ``e2e``: the
    e2e run of phase 5 through ``run_experiment(mesh=(2, 2))``; ``fits``:
    the non-e2e training fit through ``fit_latents_mesh`` on (2, 1)
    (``mesh_bn_config``) and (1, 2) (phase 4's config), then
    ``run_sweep_multihost`` over ``multihost_configs`` with the fused
    decoder update.  On the (2, 2) and (1, 2) meshes each rank also runs
    :func:`vocab_shard_check`.  Each rank writes ``<job>_rank<r>.json``
    (its kernel launches, seconds, backend, device and vocab-shard check);
    rank 0 also ``<job>.pt`` (the results)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import mmtpu_torch.kernels.angular as K
    import mmtpu_torch.kernels.decoder_update as T
    from mmtpu_torch.convert import to_numpy
    from mmtpu_torch.parallel import fit as pfit
    from mmtpu_torch.parallel.mesh import init_world

    job, tmp = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_world("cuda:0", "gloo")  # the ranks share the one card
    rank = dist.get_rank()
    data_dir = os.path.join(tmp, "data")
    info = {"backend": dist.get_backend(), "device": str(dev), "world": dist.get_world_size()}
    keep = {}

    def part(name, fn):
        _reset_launches(K, T)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        info[name] = {"s": time.perf_counter() - t0, "launches": _read_launches(K, T)}
        keep[name] = out

    if job == "e2e":
        import mmtpu_torch.runner as runner
        from mmtpu_torch.config import ExperimentConfig

        cfg = ExperimentConfig.from_json(os.path.join(tmp, "config_e2e.json"))
        prep = runner.prepare(cfg, data_dir)
        fits, orig = [], runner.fit_e2e_mesh

        def recording(*args, **kw):  # the training fit's result; the run is unchanged
            fits.append(orig(*args, **kw))
            return fits[-1]

        runner.fit_e2e_mesh = recording
        mesh = pfit.make_fit_mesh(2, 2)
        part("e2e_2x2", lambda: runner.run_experiment(
            cfg, prep=prep, out_root=os.path.join(tmp, "out_mesh"),
            mesh=mesh, device=dev, verbose=False)["final_train_loss"])
        keep["e2e_2x2"] = {"final_loss": keep["e2e_2x2"], "fit": [to_numpy(x) for x in fits[0]]}
        info["vocab_shard_2x2"] = vocab_shard_check(torch, K, mesh, dev, data_dir)
    else:
        from mmtpu_torch.parallel.multihost import run_sweep_multihost

        for name, shape, cfg in (("latents_2x1", (2, 1), mesh_bn_config()),
                                 ("latents_1x2", (1, 2), smoke_config(False))):
            emb0, dec, data, vocab, hp, spec, perms = _latent_inputs(torch, cfg, data_dir, dev)
            mesh = pfit.make_fit_mesh(*shape)
            part(name, lambda: [to_numpy(x) for x in pfit.fit_latents_mesh(
                mesh, emb0, dec, data, vocab, hp, spec, perms=perms)])
        # on the last mesh, (1, 2)
        info["vocab_shard_1x2"] = vocab_shard_check(torch, K, mesh, dev, data_dir)
        configs = multihost_configs()
        prep = _multihost_prep(data_dir, configs)
        part("sweep_multihost", lambda: _sweep_columns(run_sweep_multihost(
            configs, prep, verbose=False, batch_size=64, fused_dec_update=True, device=dev)))
    with open(os.path.join(tmp, f"{job}_rank{rank}.json"), "w") as f:
        json.dump(info, f)
    if rank == 0:
        torch.save(keep, os.path.join(tmp, f"{job}.pt"))
    dist.destroy_process_group()
    return 0


# runs `python -m mmtpu_torch.run <args>` and prints the kernel launch counts
# of that process on its last line (phase 17's NCCL run under torchrun and
# phase 18's profiled run)
_RUN_CLI = """
import json, runpy, sys
import mmtpu_torch.kernels.angular as K
sys.argv = ["mmtpu_torch.run"] + sys.argv[1:]
try:
    runpy.run_module("mmtpu_torch.run", run_name="__main__", alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "k1_fwd": K.LAUNCHES["fwd"], "k1_bwd": K.LAUNCHES["bwd"]}))
sys.exit(rc or 0)
"""


def _write_run_cli(tmp: str) -> str:
    path = os.path.join(tmp, "run_cli.py")
    with open(path, "w") as f:
        f.write(_RUN_CLI)
    return path


def _close(got, want, rtol, atol) -> float:
    """Raise unless ``got`` is within ``rtol`` / ``atol`` of ``want`` (NaN
    equal to NaN); returns the largest absolute difference."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    both = np.isfinite(got) & np.isfinite(want)
    return float(np.abs(got - want)[both].max()) if both.any() else 0.0


def _fit_diffs(got: list, want, loss_at: int) -> dict:
    """A mesh fit's (numpy) leaves against a single-device fit's, both
    finite: the losses at ``loss_at`` at the loss tolerance, the embeddings
    and the decoder at the parameter tolerance; returns the final loss and
    the largest differences."""
    import numpy as np

    from mmtpu_torch.convert import to_numpy
    from mmtpu_torch.tree import tree_leaves

    want = [to_numpy(w) for w in want]
    for fit in (got, want):
        if not all(np.isfinite(x).all() for x in [fit[0], fit[loss_at]] + tree_leaves(fit[1])):
            raise AssertionError("a mesh fit or its single-device fit is not finite")
    out = {"final_loss": float(want[loss_at][-1]),
           "loss": _close(got[loss_at], want[loss_at], MESH_LOSS_RTOL, MESH_LOSS_ATOL),
           "embed": _close(got[0], want[0], MESH_PARAM_RTOL, MESH_PARAM_ATOL)}
    out["decoder"] = max(_close(a, b, MESH_PARAM_RTOL, MESH_PARAM_ATOL)
                         for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])))
    return out


def _rank_infos(tmp: str, job: str, n: int) -> list:
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f"{job}_rank{r}.json")) as f:
            out.append(json.load(f))
    for info in out:
        if info["backend"] != "gloo" or info["device"] != "cuda:0":
            raise AssertionError(f"{job}: a rank ran on {info['device']} over "
                                 f"{info['backend']}, not cuda:0 over gloo")
    return out


def run_mesh(torch, K, T, tmp: str, non_e2e: dict, e2e: dict) -> dict:
    """Phase 17: (a) K1 at the shards' shapes against its plain versions;
    (b) four ranks sharing the card over gloo run phase 5's e2e run through
    ``run_experiment(mesh=(2, 2))``, two run phase 4's training fit through
    ``fit_latents_mesh`` on (2, 1) with batch norm (``mesh_bn_config``) and on
    (1, 2), each held to the same fit on one device (phase 5's, a batch-norm
    fit here, and phase 4's), all finite, with K1 once per step on every
    rank, and each rank's :func:`vocab_shard_check` on (2, 2) and (1, 2); (c) ``torchrun
    --nproc_per_node 1 -m mmtpu_torch.run ... --mesh data,vocab`` over NCCL,
    held to phase 4's run; (d) the two ranks' ``run_sweep_multihost`` over
    ``multihost_configs`` with the fused decoder update, every config
    finite on both sides and held to ``run_sweep`` in this process.  The worlds run side by side with this
    process's references; each part's wall seconds are printed as such."""
    import numpy as np

    from mmtpu_torch.sweep.runner import run_sweep
    from mmtpu_torch.train.latents import fit_latents

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(17)
    fwd_err = bwd_err = 0.0
    for b, d, v in MESH_SHARD_SHAPES:
        errs = _check_k1(torch, K, *_k1_case(torch, dev, gen, b, d, v))
        fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])

    me = os.path.join(ROOT, "chip_smoke.py")
    run_cli = _write_run_cli(tmp)
    cfg_path = os.path.join(tmp, "config_non-e2e.json")
    jobs = {"e2e": _torchrun(4, me, ["--mesh-worker", "e2e", tmp], tmp, "mesh_e2e"),
            "fits": _torchrun(2, me, ["--mesh-worker", "fits", tmp], tmp, "mesh_fits"),
            "nccl": _torchrun(1, run_cli, [
                cfg_path, "mosi", "--e2e", "n", "--device", "cuda", "--mesh", "data,vocab",
                "--out_root", os.path.join(tmp, "out_nccl"), "--data_dir",
                os.path.join(tmp, "data")], tmp, "mesh_nccl")}

    try:  # the single-device references these worlds do not share with phases 4-5
        emb0, dec, data, vocab, hp, spec, perms = _latent_inputs(
            torch, mesh_bn_config(), os.path.join(tmp, "data"), dev)
        bn_ref = fit_latents(emb0, dec, data, vocab, hp, spec, perms=perms)
        configs = multihost_configs()
        t0 = time.perf_counter()
        sweep_ref = run_sweep(configs, _multihost_prep(os.path.join(tmp, "data"), configs),
                              batch_size=64, fused_dec_update=True, device=dev, verbose=False)
        torch.cuda.synchronize(dev)
        sweep_ref_s = time.perf_counter() - t0
        walls = _wait_all(jobs)
    finally:
        _stop(jobs)
    e2e_info, fit_info = _rank_infos(tmp, "e2e", 4), _rank_infos(tmp, "fits", 2)
    got_e2e = torch.load(os.path.join(tmp, "e2e.pt"), weights_only=False)
    got_fits = torch.load(os.path.join(tmp, "fits.pt"), weights_only=False)

    steps = N_EPOCHS * STEPS_PER_EPOCH
    infer = N_EPOCHS * (-(-229 // 512) + -(-686 // 512))
    k1 = {"e2e_2x2": [i["e2e_2x2"]["launches"] for i in e2e_info],
          **{n: [i[n]["launches"] for i in fit_info] for n in ("latents_2x1", "latents_1x2")}}
    want_k1 = {"e2e_2x2": steps + infer, "latents_2x1": steps, "latents_1x2": steps}
    for name, per_rank in k1.items():
        for launched in per_rank:
            if launched["k1_fwd"] != want_k1[name] or launched["k1_bwd"] != want_k1[name]:
                raise AssertionError(f"{name}: a rank launched K1 {launched}, expected "
                                     f"{want_k1[name]} of each kind (one per step)")

    diffs = {"e2e_2x2": _fit_diffs(got_e2e["e2e_2x2"]["fit"], e2e["train_fit"], 3),
             "latents_2x1": _fit_diffs(got_fits["latents_2x1"], bn_ref, 2),
             "latents_1x2": _fit_diffs(got_fits["latents_1x2"], non_e2e["train_fit"], 2)}
    mesh_post = np.load(os.path.join(tmp, "out_mesh", "mmtpu", "config_0_run_0", "post",
                                     "embed.npy"))
    diffs["e2e_2x2"]["post_embed"] = _close(mesh_post, e2e["post"], MESH_PARAM_RTOL,
                                            MESH_PARAM_ATOL)
    diffs["e2e_2x2"]["run_final_loss"] = _close(got_e2e["e2e_2x2"]["final_loss"],
                                                e2e["final_loss"], MESH_LOSS_RTOL, MESH_LOSS_ATOL)

    nccl_s, nccl_log = walls["nccl"]
    nccl_launches = json.loads(nccl_log.strip().splitlines()[-1])
    if "backend nccl" not in nccl_log:
        raise AssertionError("the torchrun --mesh run did not report an NCCL group")
    nccl_post = np.load(os.path.join(tmp, "out_nccl", "mmtpu", "config_0_run_0", "post",
                                     "embed.npy"))
    diffs["cli_nccl_1x1"] = {"post_embed": _close(nccl_post, non_e2e["post"], MESH_PARAM_RTOL,
                                                  MESH_PARAM_ATOL)}
    if nccl_launches["k1_fwd"] != non_e2e["launches"]["k1_fwd"]:
        raise AssertionError(f"the NCCL run launched {nccl_launches}, phase 4 "
                             f"{non_e2e['launches']}")

    got_sweep, want_sweep = got_fits["sweep_multihost"], _sweep_columns(sweep_ref)
    if got_sweep["config_nums"].tolist() != want_sweep["config_nums"].tolist():
        raise AssertionError("the multi-process sweep's configs are not the sweep's")
    finite = [int(np.isfinite(c["final_train_loss"]).sum()) for c in (got_sweep, want_sweep)]
    if finite != [len(configs)] * 2:
        raise AssertionError(f"finite final losses {finite} of {len(configs)} configs "
                             "(multi-process, one process): a diverged config tests nothing")
    diffs["sweep_multihost"] = {k: _close(got_sweep[k], v, MULTIHOST_RTOL, 0.0)
                                for k, v in want_sweep.items() if k != "config_nums"}
    sweep_launches = [i["sweep_multihost"]["launches"] for i in fit_info]
    shards = [configs[r::2] for r in range(2)]
    for r, launched in enumerate(sweep_launches):
        epochs = sorted({c["n_epochs"] for c in shards[r]})  # one chunk per bucket
        want = {"k1_fwd": sum(epochs) * (STEPS_PER_EPOCH + 1 + 2),
                "k2_sgd": sum(2 * ne * STEPS_PER_EPOCH for ne in epochs)}
        if any(launched[k] != v for k, v in want.items()):
            raise AssertionError(f"multi-process sweep rank {r} launched {launched}, "
                                 f"expected {want}")

    seconds = {"e2e_2x2 (4 ranks)": [round(i["e2e_2x2"]["s"], 3) for i in e2e_info],
               "latents_2x1 (2 ranks)": [round(i["latents_2x1"]["s"], 3) for i in fit_info],
               "latents_1x2 (2 ranks)": [round(i["latents_1x2"]["s"], 3) for i in fit_info],
               "sweep_multihost (2 ranks)": [round(i["sweep_multihost"]["s"], 3)
                                             for i in fit_info],
               "sweep one process": round(sweep_ref_s, 3),
               "each world's wall": {t: round(w[0], 1) for t, w in walls.items()}}
    log(f"[mesh] K1 at the shards' shapes {MESH_SHARD_SHAPES}: max abs fwd {fwd_err:.3e}, "
        f"bwd {bwd_err:.3e}")
    log(f"[mesh] K1 launches per rank: {k1}; NCCL run (1 rank, torchrun) {nccl_launches}; "
        f"multi-process sweep per rank {sweep_launches}")
    vocab_checks = {"e2e_2x2": [i["vocab_shard_2x2"] for i in e2e_info],
                    "fits_1x2": [i["vocab_shard_1x2"] for i in fit_info]}
    log(f"[mesh] against one device, largest differences: {diffs}; sweep configs finite "
        f"{finite[0]}/{len(configs)}")
    log(f"[mesh] vocab-sharded Z and one step's gradient per rank against the whole "
        f"vocabulary: {vocab_checks}")
    log(f"[mesh] wall seconds ({MESH_SHARED}): {seconds}")
    return {"k1_fwd_err": fwd_err, "k1_bwd_err": bwd_err, "k1_launches": k1,
            "k1_launches_nccl": nccl_launches, "sweep_launches": sweep_launches,
            "diffs": diffs, "vocab_checks": vocab_checks, "seconds": seconds,
            "finite_sweep_configs": finite[0]}


def run_aux(tmp: str) -> dict:
    """Phase 18: ``mmtpu_torch.run`` with ``--profile DIR`` in a fresh process
    (a process's second profiler session records no device event) on phase
    4's config cut to one epoch: its trace names K1's kernels; and
    ``python -m mmtpu_torch.make_configs``'s 512 files equal
    ``config.make_grid``."""
    from mmtpu_torch import make_configs
    from mmtpu_torch.config import make_grid

    cfg = dict(smoke_config(False), n_epochs=1, n_sentiment_epochs=1)
    cfg_path = os.path.join(tmp, "config_profile.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    trace_dir = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, _write_run_cli(tmp), cfg_path, "mosi",
                           "--e2e", "n", "--device", "cuda", "--no_artifacts", "--profile",
                           trace_dir, "--data_dir", os.path.join(tmp, "data")], cwd=tmp,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=WORKER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the --profile run exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    launches = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1 = {kind: sum(f"angular_{kind}_kernel" in n for n in kernels) for kind in ("fwd", "bwd")}
    log(f"[aux] --profile run: {len(kernels)} device kernels in the trace, K1 {k1} against "
        f"{launches} launched; wall {wall:.1f} s")
    if k1["fwd"] != launches["k1_fwd"] or k1["bwd"] != launches["k1_bwd"] or not k1["fwd"]:
        raise AssertionError(f"the trace names K1 {k1} times, the run launched {launches}")

    folder = os.path.join(tmp, "configs")
    if make_configs.main([folder]) != 0:
        raise AssertionError("make_configs failed")
    written = []
    for i in range(512):
        with open(os.path.join(folder, f"config_{i}.json")) as f:
            written.append(json.load(f))
    same = written == make_grid()
    log(f"[aux] make_configs wrote {len(os.listdir(folder))} files; the 512 configs equal "
        f"make_grid(): {same}")
    if not same:
        raise AssertionError("make_configs' files differ from config.make_grid()")
    return {"trace_kernels": len(kernels), "trace_k1": k1, "launches": launches,
            "wall_s": wall}


def run_deep_e2e(torch, K, T, e2e: dict) -> dict:
    """Phase 19: phase 5's e2e config through ``run_experiment(prep=...)`` on
    a synthetic MOSI whose word embeddings are ``DEEP_E2E_D`` wide (1284 /
    229 / 686 utterances, seq 20, vocab 3016, batch 64, cut in epochs only),
    on the card and on the CPU: losses and post embeddings held to each other,
    both finite, and K1 launched as often as in phase 5."""
    import numpy as np

    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset
    from mmtpu_torch.runner import run_experiment

    cfg = ExperimentConfig.from_dict(dict(smoke_config(True), config_name="deep"))
    prep = prepare_device_data(synthesize_dataset("mosi", embed_dim=DEEP_E2E_D),
                               word_sim_metric=cfg.word_sim_metric,
                               pos_embed_dim=cfg.pos_embed_dim, pos_mode="baked",
                               pos_bug_parity=cfg.parity, suff_stats=not cfg.parity)
    res, wall, emb = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                _reset_launches(K, T)
            t0 = time.perf_counter()
            res[dev] = run_experiment(cfg, out_root=os.path.join(tmp, dev), prep=prep,
                                      verbose=False, device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = _read_launches(K, T)
            wall[dev] = time.perf_counter() - t0
            emb[dev] = np.load(os.path.join(tmp, dev, "deep", f"config_{cfg.config_num}_run_0",
                                            "post", "embed.npy"))
    loss = {dev: float(r["final_train_loss"]) for dev, r in res.items()}
    loss_rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    emb_abs = float(np.abs(emb["cuda"] - emb["cpu"]).max())
    want = {k: e2e["launches"][k] for k in ("k1_fwd", "k1_bwd")}
    got = {k: launches[k] for k in want}
    log(f"[deep] e2e at D={DEEP_E2E_D}, card against CPU: final loss {loss['cuda']:.4f} rel "
        f"{loss_rel:.3e}, post embeddings {emb['cuda'].shape} max abs {emb_abs:.3e}; K1 "
        f"launches {got['k1_fwd']} / {got['k1_bwd']} (phase 5 at D=300: {want['k1_fwd']} / "
        f"{want['k1_bwd']}); run_experiment wall s card {wall['cuda']:.3f}, CPU "
        f"{wall['cpu']:.3f}")
    n_utt = sum(x.shape[0] for x in prep.sif_init.values())
    if emb["cuda"].shape != (n_utt, DEEP_E2E_D):
        raise AssertionError(f"post/embed.npy has shape {emb['cuda'].shape}")
    if not all(np.isfinite(loss[d]) and np.isfinite(emb[d]).all() for d in res):
        raise AssertionError(f"non-finite loss or embeddings at D={DEEP_E2E_D}: {loss}")
    if not (loss_rel < DEEP_LOSS_RTOL and emb_abs < DEEP_EMB_ATOL):
        raise AssertionError(f"the D={DEEP_E2E_D} e2e run on the card disagrees with the CPU")
    if got != want:
        raise AssertionError(f"K1 launched {got} at D={DEEP_E2E_D}, phase 5 {want}")
    return {"launches": launches, "loss_rel": loss_rel, "emb_abs": emb_abs,
            "final_loss": loss["cuda"], "wall_s": wall}


# phase 21: the other tasks.  POM at its real geometry (scripts/parity_fullscale.py:
# 600 / 100 / 203 utterances, 1357-token rows of a 9206 x 300 vocabulary,
# audio and visual 43, 17 traits), IEMOCAP at MOSI's scale (2-class one-hot
# labels) and MOSI under the dot_prod word metric, all synthetic (the real
# blobs are not in the repository).  Their run_experiment paths run e2e
# captured (graphs.MIN_EPOCHS epochs) and non-e2e eager (TASK_EAGER_EPOCHS),
# on the card and then, in worker processes started after them, on the CPU,
# at the whole-fit gates; the sentiment epochs are phase 5's smoke config's
# (10, cut from the grid's 400)
POM_GEOMETRY = dict(n_train=600, n_valid=100, n_test=203, vocab_size=9206, embed_dim=300,
                    audio_dim=43, visual_dim=43, text_len=1357)
TASK_EAGER_EPOCHS = 3
TASK_LOSS_RTOL, TASK_EMB_ATOL = 2e-4, 2e-4
# (tag, dataset, word metric, e2e) of phase 21's run_experiment paths
TASK_RUNS = (("pom_e2e", "pom", "angular", True), ("pom", "pom", "angular", False),
             ("iemocap_e2e", "iemocap", "angular", True), ("iemocap", "iemocap", "angular", False),
             ("dot_prod_e2e", "mosi", "dot_prod", True), ("dot_prod", "mosi", "dot_prod", False))
# the CPU references' worker processes, (torch threads, tags) each: the
# POM e2e run alone in one, the rest in the other (torch's threads scale
# poorly at these sizes, so two processes of a few threads each finish
# sooner than one of many; the card's process keeps a core)
TASK_WORKERS = ((4, ("pom_e2e",)),
                (3, ("pom", "iemocap_e2e", "iemocap", "dot_prod_e2e", "dot_prod")))
# K1 at POM's vocabulary: the train batch, the inference batch and a K = 8
# chunk's inference rows (burst lengths per rows)
POM_K1_ROWS = {64: 100, 512: 50, 4096: 10}
# the POM sweep: the first POM_SWEEP_K configs of the grid's Adam / 100-epoch
# bucket in chunks of POM_SWEEP_CHUNK (a bucket with a later chunk), epochs
# and sentiment epochs cut to POM_SWEEP_EPOCHS (captured); one chunk at the
# CLI's default width POM_WIDE_K; the width-halving retry forced at that
# width on a sweep of its configs cut to RETRY_EPOCHS (eager)
POM_SWEEP_K, POM_SWEEP_CHUNK, POM_WIDE_K, POM_SWEEP_EPOCHS = 16, 8, 32, 20
RETRY_EPOCHS = 2


def task_config(tag: str, dataset: str, metric: str, e2e: bool):
    """The smoke config (phase 4 / 5) on ``dataset`` under ``metric``: e2e at
    ``graphs.MIN_EPOCHS`` epochs (captured), non-e2e at ``TASK_EAGER_EPOCHS``."""
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.graphs import MIN_EPOCHS

    return ExperimentConfig.from_dict(dict(
        smoke_config(e2e), dataset=dataset, word_sim_metric=metric, config_name=tag,
        n_epochs=MIN_EPOCHS if e2e else TASK_EAGER_EPOCHS))


def task_prep(dataset: str, metric: str, cfg=None, pos_dims=None):
    """The synthetic data of a phase-21 path: POM at ``POM_GEOMETRY``, the
    others at MOSI's; positional channels baked as ``run_experiment``'s
    ``prepare`` does for ``cfg``, or shared blocks ``pos_dims`` (the sweep)."""
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.synthetic import synthesize_dataset

    ds = synthesize_dataset(dataset, **(POM_GEOMETRY if dataset == "pom" else {}))
    if pos_dims is not None:
        return prepare_device_data(ds, word_sim_metric=metric, pos_mode="shared",
                                   pos_dims=pos_dims)
    return prepare_device_data(ds, word_sim_metric=metric, pos_embed_dim=cfg.pos_embed_dim,
                               pos_mode="baked", pos_bug_parity=cfg.parity,
                               suff_stats=not cfg.parity)


def _run_task(tag, dataset, metric, e2e, device, out_root: str, prep=None) -> dict:
    """One phase-21 path through ``run_experiment`` on ``device``; its final
    loss, post embeddings, test results after training and wall seconds."""
    import numpy as np

    from mmtpu_torch.runner import run_experiment

    cfg = task_config(tag, dataset, metric, e2e)
    prep = prep or task_prep(dataset, metric, cfg)
    t0 = time.perf_counter()
    res = run_experiment(cfg, out_root=out_root, prep=prep, verbose=False, device=device)
    wall = time.perf_counter() - t0
    folder = os.path.join(out_root, tag, f"config_{cfg.config_num}_run_0", "post")
    return {"final_loss": float(res["final_train_loss"]), "after": res["sentiment"]["after"],
            "emb": np.load(os.path.join(folder, "embed.npy")), "wall_s": wall,
            "folder": folder, "n_test": int(prep.sif_init["test"].shape[0])}


def tasks_worker(argv: list) -> int:
    """Phase 21's CPU references (``chip_smoke.py --tasks-worker TMP
    THREADS TAG,...``): the named paths of ``TASK_RUNS`` through
    ``run_experiment`` on the CPU with ``THREADS`` torch threads, their post
    embeddings under ``TMP/cpu`` and one JSON line per path."""
    import torch

    torch.set_num_threads(int(argv[1]))
    tags = argv[2].split(",")
    out_root = os.path.join(argv[0], "cpu")
    for tag, dataset, metric, e2e in TASK_RUNS:
        if tag not in tags:
            continue
        r = _run_task(tag, dataset, metric, e2e, "cpu", out_root)
        print(json.dumps({"tag": tag, "final_loss": r["final_loss"], "wall_s": r["wall_s"],
                          "folder": r["folder"]}), flush=True)
    return 0


def _count_captures(G) -> tuple:
    """Counts the CUDA graphs captured from now on (every store); returns
    ``(counts, restore)``."""
    counts = {"captures": 0}
    capture = G.Graphs._capture

    def counting(self, *args, **kw):
        counts["captures"] += 1
        return capture(self, *args, **kw)

    G.Graphs._capture = counting
    return counts, lambda: setattr(G.Graphs, "_capture", capture)


def check_pom_k1(torch, K, dev) -> dict:
    """K1 at POM's 9206-word vocabulary against its plain versions at phase
    2's gates, at ``POM_K1_ROWS``; times and bounds there."""
    gen = torch.Generator().manual_seed(21)
    out = {"fwd_err": 0.0, "bwd_err": 0.0, "times": {}, "bounds": {}}
    v = POM_GEOMETRY["vocab_size"]
    for b, reps in POM_K1_ROWS.items():
        case = _k1_case(torch, dev, gen, b, 300, v)
        errs = _check_k1(torch, K, *case)
        out["fwd_err"], out["bwd_err"] = max(out["fwd_err"], errs[0]), max(out["bwd_err"], errs[1])
        out["times"][b] = _k1_times(torch, K, *case, single_calls=False, reps=reps)
        out["bounds"][b] = _k1_bounds(b, 300, v)
    return out


def _task_metrics(torch, r: dict, dataset: str, prep, hidden: int, dev) -> dict:
    """The card run's test predictions (its saved sentiment MLP on its post
    test embeddings) scored on the card by ``pom_metrics`` /
    ``iemocap_metrics`` / ``mosi_metrics``, against the host report that
    ``run_experiment`` wrote from the same run (``pom_loss`` rounds to 3
    decimals, ``full_loss`` to 5 and ``iemocap_loss`` not)."""
    import numpy as np

    from mmtpu_torch.eval.metrics import iemocap_metrics, mosi_metrics, pom_metrics
    from mmtpu_torch.models.sentiment import apply_sentiment, init_sentiment
    from mmtpu_torch.tree import tree_leaves, tree_unflatten

    y = prep.labels["test"]
    n_out = 1 if y.ndim == 1 else y.shape[-1]
    like = init_sentiment(torch.Generator().manual_seed(0), prep.embed_dim, hidden, n_out)
    with np.load(os.path.join(r["folder"], "senti.npz")) as saved:
        params = tree_unflatten(like, [torch.as_tensor(saved[f"p{i}"], device=dev)
                                       for i in range(len(tree_leaves(like)))])
    test = torch.as_tensor(r["emb"][-r["n_test"]:], device=dev)
    with torch.no_grad():
        pred = apply_sentiment(params, test)
    fn = {"pom": pom_metrics, "iemocap": iemocap_metrics}.get(dataset, mosi_metrics)
    dm = {k: v.cpu().numpy() for k, v in fn(pred, torch.as_tensor(y, device=dev)).items()}
    shape = (y.shape[-1],) if dataset == "pom" else ()
    tol = 6e-4 if dataset == "pom" else 2e-5  # pom_loss rounds to 3 decimals
    host = r["after"]
    diffs = {k: float(np.max(np.abs(v - np.asarray(host[k])))) for k, v in dm.items()}
    for k, v in dm.items():
        if v.shape != shape or not np.isfinite(v).all():
            raise AssertionError(f"{dataset} {k} on the card: shape {v.shape} (want {shape}), "
                                 f"finite {np.isfinite(v).all()}")
        if not diffs[k] <= tol:
            raise AssertionError(f"{dataset} {k} on the card differs from the host report by "
                                 f"{diffs[k]:.3e}")
    return {"shapes": {k: list(v.shape) for k, v in dm.items()}, "host_diff": diffs}


def _sentiment_widths(torch, G, preps: dict, dev) -> dict:
    """The sentiment fit at POM's 17 outputs and IEMOCAP's 2, on the SIF
    embeddings of each, ``graphs.MIN_EPOCHS`` epochs captured and eager:
    bit for bit, with the captures counted."""
    from mmtpu_torch.models.sentiment import init_sentiment
    from mmtpu_torch.train.sentiment import SentimentFitSpec, fit_sentiment
    from mmtpu_torch.tree import tree_leaves, tree_map

    out = {}
    for name, prep in preps.items():
        x, xv = (torch.as_tensor(prep.sif_init[s], device=dev) for s in ("train", "valid"))
        y, yv = (torch.as_tensor(prep.labels[s], device=dev) for s in ("train", "valid"))
        n_out = y.shape[-1]
        gen = torch.Generator().manual_seed(5)
        params = tree_map(lambda t: t.to(dev), init_sentiment(gen, prep.embed_dim, 150, n_out))
        perms = [torch.randperm(x.shape[0], generator=gen).to(dev)
                 for _ in range(G.MIN_EPOCHS)]
        hp = {"lr": 1e-2, "lr_decay": 0.5, "n_epochs": G.MIN_EPOCHS}
        spec = SentimentFitSpec(n_epochs_max=G.MIN_EPOCHS)
        runs = {}
        for graphs in (False, True):
            counts, restore = _count_captures(G)
            try:
                fit = fit_sentiment(params, x, y, xv, yv, hp, spec, perms=perms, graphs=graphs)
            finally:
                restore()
            runs[graphs] = ([fit[2], fit[3], *tree_leaves(fit[0])], counts["captures"])
        same = all(torch.equal(a, b) for a, b in zip(runs[False][0], runs[True][0]))
        finite = all(bool(torch.isfinite(t).all()) for t in runs[True][0])
        log(f"[tasks] sentiment fit at {n_out} outputs (synthetic {name}, {G.MIN_EPOCHS} "
            f"epochs): captured "
            f"({runs[True][1]} graphs) against eager ({runs[False][1]}): bit-equal {same}; "
            f"finite {finite}")
        if not (same and finite and runs[True][1] > 0 and runs[False][1] == 0):
            raise AssertionError(f"the {n_out}-output sentiment fit captured is not the eager one")
        out[name] = {"n_out": n_out, "bit_equal": same, "captures": runs[True][1]}
    return out


def _pom_configs(k: int) -> list:
    """The first ``k`` configs of the grid's Adam / 100-epoch bucket, their
    epochs and sentiment epochs cut to ``POM_SWEEP_EPOCHS``."""
    from mmtpu_torch.config import make_grid

    bucket = [c for c in make_grid() if c["optimizer"] == "adam" and c["n_epochs"] == 100]
    return [dict(c, n_epochs=POM_SWEEP_EPOCHS, n_sentiment_epochs=POM_SWEEP_EPOCHS)
            for c in bucket[:k]]


def _memory(torch, dev) -> dict:
    return {"allocated_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "reserved_gib": torch.cuda.max_memory_reserved(dev) / 2 ** 30}


def _fresh_peak(torch, dev) -> None:
    """Cached blocks freed and the peak statistics reset: the next peak is
    what the next call holds, beside the tensors alive now."""
    import gc

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def _finite_result(res) -> bool:
    import numpy as np

    return bool(np.isfinite(res.final_train_loss).all() and not res.diverged.any()
                and all(np.isfinite(v).all() for v in res.metrics.values()))


def run_pom_sweeps(torch, K, T, dev) -> dict:
    """Phase 21's POM sweeps at the real geometry, captured: ``run_sweep``
    over ``POM_SWEEP_K`` configs in chunks of ``POM_SWEEP_CHUNK`` (each later
    chunk replays the bucket's graphs; every result finite; K1 launches;
    peak memory); one ``run_chunk`` at the CLI's default width
    ``POM_WIDE_K`` (peak memory); then the width-halving retry of a sweep
    of ``POM_WIDE_K`` configs (``RETRY_EPOCHS``, eager), forced by a memory
    fraction just under that sweep's peak at its width, from ``POM_WIDE_K``
    to half of it, every result finite; the fraction restored."""
    import contextlib
    import io

    import numpy as np

    from mmtpu_torch.sweep.runner import run_chunk, run_sweep

    wide = _pom_configs(POM_WIDE_K)
    dims = tuple(sorted({c["pos_embed_dim"] for c in wide}))
    prep = task_prep("pom", "angular", pos_dims=dims)
    n_train, n_valid, n_test = (prep.sif_init[s].shape[0] for s in ("train", "valid", "test"))
    per_chunk = POM_SWEEP_EPOCHS * (-(-n_train // 64) + -(-n_valid // 512) + -(-n_test // 512))
    out = {}

    _fresh_peak(torch, dev)
    _reset_launches(K, T)
    t0 = time.perf_counter()
    sweep = run_sweep(wide[:POM_SWEEP_K], prep, chunk_size=POM_SWEEP_CHUNK, device=dev,
                      verbose=False)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = _read_launches(K, T)
    mem8 = _memory(torch, dev)
    stats = sweep.chunk_stats
    log(f"[tasks] synthetic POM sweep ({POM_SWEEP_K} configs of the grid's Adam / 100 bucket "
        f"in chunks of {POM_SWEEP_CHUNK}, epochs and sentiment epochs 100 / 400 -> "
        f"{POM_SWEEP_EPOCHS}, "
        f"rows of {POM_GEOMETRY['text_len']} tokens, vocabulary {POM_GEOMETRY['vocab_size']}): "
        f"wall {wall:.3f} s (CPU workers running); chunks "
        f"{[(s['chunk'], s['configs'], s['graphs'], s['done_at_s']) for s in stats]}; "
        f"launches {launches}; peak {mem8['allocated_gib']:.2f} GiB allocated, "
        f"{mem8['reserved_gib']:.2f} GiB reserved; mae {sweep.metrics['mae'].shape}; finite "
        f"{_finite_result(sweep)}")
    later = [s["graphs"] for s in stats[1:]]
    if len(stats) != POM_SWEEP_K // POM_SWEEP_CHUNK or not later or any(
            g["warmups"] or g["captures"] or not g["replays"] for g in later):
        raise AssertionError(f"a later chunk of the POM bucket did not only replay: {stats}")
    want = len(stats) * per_chunk
    if any(launches[k] != want for k in ("k1_fwd", "k1_bwd", "tok_fwd", "tok_bwd")):
        raise AssertionError(f"K1 and the token kernels launched {launches} in the POM sweep, "
                             f"expected {want} each")
    train_steps = POM_SWEEP_EPOCHS * -(-n_train // 64)
    _hold_adam(launches, "POM sweep", len(stats) * 2 * train_steps, want)
    if not _finite_result(sweep) or sweep.metrics["mae"].shape != (POM_SWEEP_K, 17):
        raise AssertionError("the POM sweep has a non-finite result or a wrong metric shape")
    out["sweep"] = {"wall_s": wall, "chunks": stats, "launches": launches, "peak": mem8}
    del sweep

    _fresh_peak(torch, dev)
    _reset_launches(K, T)
    t0 = time.perf_counter()
    chunk = run_chunk(wide, prep, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = _read_launches(K, T)
    mem32 = _memory(torch, dev)
    log(f"[tasks] synthetic POM chunk at width {POM_WIDE_K}: wall {wall:.3f} s (CPU workers "
        f"running), phases "
        f"{ {p: round(t, 3) for p, t in chunk.phase_s.items()} }; launches {launches}; peak "
        f"{mem32['allocated_gib']:.2f} GiB allocated, {mem32['reserved_gib']:.2f} GiB reserved "
        f"(the train fit's {POM_WIDE_K * 64} rows and the inference fits' {POM_WIDE_K * 512} "
        f"rows of {POM_GEOMETRY['text_len']} tokens); finite {_finite_result(chunk)}")
    if not _finite_result(chunk) or any(launches[k] != per_chunk for k in (
            "k1_fwd", "k1_bwd", "tok_fwd", "tok_bwd")):
        raise AssertionError(f"the width-{POM_WIDE_K} POM chunk: finite "
                             f"{_finite_result(chunk)}, launches {launches}")
    _hold_adam(launches, f"width-{POM_WIDE_K} POM chunk", 2 * train_steps, per_chunk)
    out["wide_chunk"] = {"wall_s": wall, "phase_s": chunk.phase_s, "launches": launches,
                         "peak": mem32}
    del chunk

    # the retry, eager (RETRY_EPOCHS; a captured fit's graphs keep a pool
    # each, whose reserved memory hardly depends on the width).  The
    # fraction caps the reserved memory.  An eager sweep fits under its
    # reserved peak from an empty cache (its blocks fragment: width 16 can
    # fail under a cap a little below its reserved peak, though that is far
    # above what it allocates), and none fits under its allocated peak; so
    # the limit is halfway between width 16's reserved peak and width 32's
    # allocated peak (width 32 fits under a cap halfway between the two
    # reserved peaks: 3.4 GiB reserved, 1.8 allocated on an H100)
    half = POM_WIDE_K // 2
    retry_cfgs = [dict(c, n_epochs=RETRY_EPOCHS, n_sentiment_epochs=RETRY_EPOCHS) for c in wide]
    peaks = {}
    for width in (half, POM_WIDE_K):
        _fresh_peak(torch, dev)
        run_sweep(retry_cfgs, prep, chunk_size=width, device=dev, verbose=False)
        peaks[width] = _memory(torch, dev)
    lo, hi = peaks[half]["reserved_gib"], peaks[POM_WIDE_K]["allocated_gib"]
    if not lo < hi:
        raise AssertionError(f"no memory cap can force the retry: width {half} reserved "
                             f"{lo:.3f} GiB, width {POM_WIDE_K} allocated {hi:.3f}")
    limit = (lo + hi) / 2
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    _fresh_peak(torch, dev)
    printed = io.StringIO()
    torch.cuda.set_per_process_memory_fraction(limit / total, dev)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            retried = run_sweep(retry_cfgs, prep, chunk_size=POM_WIDE_K, device=dev,
                                verbose=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    mem = _memory(torch, dev)
    lines = [ln for ln in printed.getvalue().splitlines() if "failed on device" in ln]
    widths = [POM_WIDE_K] + [int(ln.rsplit(" ", 1)[-1]) for ln in lines]
    ran = sorted({s["configs"] for s in retried.chunk_stats})
    log(f"[tasks] retry (synthetic POM, {len(wide)} configs, {RETRY_EPOCHS} epochs eager) "
        f"under a memory limit of {limit:.3f} GiB of {total:.2f} (fraction "
        f"{limit / total:.5f}; the same sweep unlimited peaked at width {half} "
        f"{peaks[half]['allocated_gib']:.3f} GiB allocated, {lo:.3f} reserved, and at width "
        f"{POM_WIDE_K} {hi:.3f} allocated, {peaks[POM_WIDE_K]['reserved_gib']:.3f} reserved: "
        f"the limit is {limit - lo:.3f} GiB above the one's reserved and {hi - limit:.3f} "
        f"below the other's allocated): printed {lines}; widths tried {widths}, chunks run at {ran}; wall "
        f"{wall:.3f} s (CPU workers running); peak {mem['allocated_gib']:.3f} GiB allocated, "
        f"{mem['reserved_gib']:.3f} reserved; finite {_finite_result(retried)}; the fraction "
        f"restored to 1.0")
    if widths != [POM_WIDE_K, half] or ran != [half] or not _finite_result(retried):
        raise AssertionError(f"the forced retry went {widths} (chunks {ran}), expected "
                             f"{[POM_WIDE_K, half]}")
    if retried.n_configs != POM_WIDE_K:
        raise AssertionError(f"the retried sweep returned {retried.n_configs} configs")
    out["retry"] = {"limit_gib": limit, "total_gib": total, "widths": widths,
                    "unlimited_peaks": peaks, "wall_s": wall, "peak": mem, "printed": lines}
    return out


def run_sweep_cli_tasks(torch, tmp: str) -> dict:
    """``python -m mmtpu_torch.sweep pom`` and ``iemocap`` (in this process,
    through the CLI's ``main``) on a ``--configs_dir`` of two grid configs
    cut to 1 epoch and 2 sentiment epochs: the synthetic stand-ins of the
    registry (MOSI's geometry), every row finite, the metrics' columns."""
    import csv

    from mmtpu_torch.sweep.__main__ import main as sweep_main

    cfg_dir = os.path.join(tmp, "task_cli_configs")
    os.makedirs(cfg_dir, exist_ok=True)
    for c in _pom_configs(2):
        with open(os.path.join(cfg_dir, f"config_{c['config_num']}.json"), "w") as f:
            json.dump(dict(c, n_epochs=1, n_sentiment_epochs=2), f)
    out = {}
    for dataset in ("pom", "iemocap"):
        res_dir = os.path.join(tmp, f"task_cli_{dataset}")
        t0 = time.perf_counter()
        rc = sweep_main([dataset, "--configs_dir", cfg_dir, "--out", res_dir, "--name", dataset,
                         "--data_dir", os.path.join(tmp, "data"), "--device", "cuda"])
        wall = time.perf_counter() - t0
        with open(os.path.join(res_dir, f"{dataset}.csv")) as f:
            rows = list(csv.DictReader(f))
        cols = sorted(k for k in rows[0] if k in ("mae", "corr", "accuracy", "f_score"))
        finite = all(float(r["final_train_loss"]) == float(r["final_train_loss"]) for r in rows)
        log(f"[tasks] python -m mmtpu_torch.sweep {dataset} --configs_dir (the registry's "
            f"synthetic stand-in at MOSI's geometry, 2 configs, 1 epoch): "
            f"rc {rc}, {len(rows)} rows, metric columns {cols}, final losses finite {finite}, "
            f"wall {wall:.2f} s (CPU workers running)")
        if rc != 0 or len(rows) != 2 or not finite:
            raise AssertionError(f"the sweep CLI on {dataset}: rc {rc}, rows {rows}")
        out[dataset] = {"rows": len(rows), "columns": cols, "wall_s": wall}
    return out


def run_tasks(torch, K, T, tmp: str) -> dict:
    """Phase 21: the other tasks, on synthetic data.  K1 at POM's vocabulary
    and the ``run_experiment`` paths of ``TASK_RUNS`` on the card (launches
    and captures counted) come first, timed with no other process on the
    host's cores.  Then the CPU references start in two worker processes,
    and beside them run the dot_prod e2e path again with TF32 on, the sentiment
    fit at 17 and 2 outputs, the POM sweeps and the retry (their walls are
    taken with the workers running), and the sweep CLI on POM and IEMOCAP;
    last, each path against the CPU at the whole-fit gates."""
    import numpy as np

    import mmtpu_torch.graphs as G

    dev = torch.device("cuda", 0)
    k1 = check_pom_k1(torch, K, dev)
    card, preps, launches, metrics = {}, {}, {}, {}
    for tag, dataset, metric, e2e in TASK_RUNS:
        cfg = task_config(tag, dataset, metric, e2e)
        key = (dataset, metric)
        if key not in preps:
            preps[key] = task_prep(dataset, metric, cfg)
        counts, restore = _count_captures(G)
        torch.cuda.synchronize(dev)
        _reset_launches(K, T)
        try:
            with _GraphProbe(torch) as probe:
                card[tag] = _run_task(tag, dataset, metric, e2e, dev,
                                      os.path.join(tmp, "cuda"), preps[key])
        finally:
            restore()
        torch.cuda.synchronize(dev)
        launches[tag] = _read_launches(K, T)
        card[tag]["captures"] = counts["captures"]
        # the training fit is the run's first store: one call per epoch
        epochs = [c[2] for c in probe.calls if c[0] is probe.made[0]]
        card[tag]["steady_epoch_s"] = _steady(epochs, e2e)
        prep = preps[key]
        n = {s: prep.sif_init[s].shape[0] for s in ("train", "valid", "test")}
        steps = cfg.n_epochs * (
            -(-n["train"] // 64) + -(-n["valid"] // 512) + -(-n["test"] // 512))
        want = 0 if metric == "dot_prod" else steps
        metrics[tag] = _task_metrics(torch, card[tag], dataset, prep,
                                     cfg.sentiment_hidden_size, dev)
        log(f"[tasks] {tag} (synthetic {dataset}) on the card: {cfg.n_epochs} epochs "
            f"{'captured' if e2e else 'eager'} ({counts['captures']} graphs captured), "
            f"final loss {card[tag]['final_loss']:.4f}, run_experiment wall "
            f"{card[tag]['wall_s']:.3f} s, the {'e2e' if e2e else 'latent'} training fit "
            f"{card[tag]['steady_epoch_s']:.4f} s per steady epoch "
            f"({len(epochs)} epochs; no other process running); launches {launches[tag]} "
            f"(expected K1 {want} each); device metrics {metrics[tag]['shapes']}, against the "
            f"host report max abs {metrics[tag]['host_diff']}")
        if launches[tag]["k1_fwd"] != want or launches[tag]["k1_bwd"] != want:
            raise AssertionError(f"{tag}: K1 launched {launches[tag]}, expected {want}")
        if launches[tag]["tok_fwd"] != steps or launches[tag]["tok_bwd"] != steps:
            raise AssertionError(f"{tag}: the token kernels launched {launches[tag]}, "
                                 f"expected {steps} each (one per step)")
        if e2e != (counts["captures"] > 0):
            raise AssertionError(f"{tag}: {counts['captures']} graphs captured")

    # the CPU references start only now, so that the card paths above were
    # timed alone; what follows runs beside them
    jobs = {f"tasks_worker{i}": _start([sys.executable, os.path.abspath(__file__),
                                        "--tasks-worker", tmp, str(n), ",".join(tags)],
                                       tmp, f"tasks_worker{i}")
            for i, (n, tags) in enumerate(TASK_WORKERS)}
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = _run_task("dot_prod_e2e", "mosi", "dot_prod", True, dev,
                             os.path.join(tmp, "cuda_tf32"), preps[("mosi", "dot_prod")])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        f32 = card["dot_prod_e2e"]
        tf32_diff = {"loss_rel": abs(tf32["final_loss"] - f32["final_loss"]) / abs(
            f32["final_loss"]), "emb_abs": float(np.abs(tf32["emb"] - f32["emb"]).max())}
        tf32_finite = bool(np.isfinite(tf32["final_loss"]) and np.isfinite(tf32["emb"]).all())
        log(f"[tasks] dot_prod_e2e (synthetic mosi) with TF32 matmuls on the card: final loss "
            f"{tf32['final_loss']:.4f}, finite {tf32_finite}; "
            f"against float32: loss rel {tf32_diff['loss_rel']:.3e}, post embeddings max abs "
            f"{tf32_diff['emb_abs']:.3e} (printed, not gated)")
        if not tf32_finite:
            raise AssertionError("dot_prod with TF32 on is not finite")

        sent = _sentiment_widths(torch, G, {"pom": preps[("pom", "angular")],
                                            "iemocap": preps[("iemocap", "angular")]}, dev)
        del preps
        sweeps = run_pom_sweeps(torch, K, T, dev)
        cli = run_sweep_cli_tasks(torch, tmp)

        walls = _wait_all(jobs)
        log("[tasks] CPU references: " + "; ".join(
            f"{','.join(tags)} ({n} threads) {walls[f'tasks_worker{i}'][0]:.1f} s"
            for i, (n, tags) in enumerate(TASK_WORKERS)) + " from their start")
        cpu = {}
        for _, text in walls.values():
            for line in text.splitlines():
                if line.startswith("{"):
                    r = json.loads(line)
                    cpu[r["tag"]] = r
    finally:
        _stop(jobs)
    diffs = {}
    for tag, *_ in TASK_RUNS:
        want_emb = np.load(os.path.join(cpu[tag]["folder"], "embed.npy"))
        got = card[tag]
        loss_rel = abs(got["final_loss"] - cpu[tag]["final_loss"]) / abs(cpu[tag]["final_loss"])
        emb_abs = float(np.abs(got["emb"] - want_emb).max())
        finite = bool(np.isfinite(got["final_loss"]) and np.isfinite(got["emb"]).all()
                      and np.isfinite(want_emb).all())
        diffs[tag] = {"loss_rel": loss_rel, "emb_abs": emb_abs, "card_s": got["wall_s"],
                      "cpu_s": cpu[tag]["wall_s"], "captures": got["captures"],
                      "steady_epoch_s": got["steady_epoch_s"]}
        log(f"[tasks] {tag} (synthetic), card against CPU: final loss rel {loss_rel:.3e}, post "
            f"embeddings {got['emb'].shape} max abs {emb_abs:.3e}; finite {finite}; "
            f"run_experiment wall s card {got['wall_s']:.3f}, CPU {cpu[tag]['wall_s']:.3f}")
        if not finite or not (loss_rel < TASK_LOSS_RTOL and emb_abs < TASK_EMB_ATOL):
            raise AssertionError(f"{tag} on the card disagrees with the CPU")
    return {"k1": k1, "launches": launches, "diffs": diffs, "metrics": metrics,
            "tf32": tf32_diff, "sentiment": sent, "sweeps": sweeps, "cli": cli,
            "worker_s": {tag: w[0] for tag, w in walls.items()}}


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


# phase 20: the captured paths (CUDA graphs, mmtpu_torch/graphs.py; the
# default on the card for a fit of graphs.MIN_EPOCHS epochs or more) against
# eager (graphs=False), in turns in one process: eager, then captured (one
# turn of each holds every gate; the spread of both modes was measured with
# four turns per pair, PERF.md section 5, and the time went to phase 21).
# The fits and the chunks run GRAPH_EPOCHS epochs (phase 4's, 5's and 10's
# configs cut in depth only, to the fewest epochs that the default
# captures).  The fits at the whole-fit gates (loss rtol, embeddings atol),
# the chunks at phase 11's rule, the server at phase 13's SERVE_ATOL; each
# pair also reports whether it is bit-equal.
GRAPH_EPOCHS = GRAPH_SWEEP_EPOCHS = 20
# the sweep's inference fits eager against captured by epoch count, for
# graphs.MIN_EPOCHS: (label, "chunk" (the K = 32 dense chunk's) or "alone"
# (one config's), the chunk's n_epochs, infer_epochs_cap): caps below and at
# the threshold (the grid's uncapped 100 epochs are measured in PERF.md
# section 6 and left out here to keep the script in its time)
GRAPH_BREAK_EVEN = (("chunk_cap10", "chunk", 100, 10), ("chunk_cap20", "chunk", 200, 20),
                    ("alone_cap5", "alone", 100, 5))
# phase 20's sweep bucket: GRAPH_SWEEP_CHUNKS chunks of GRAPH_SWEEP_K configs
# of the grid's Adam / 100-epoch bucket at GRAPH_SWEEP_EPOCHS train and
# sentiment epochs, through run_sweep (one store of graphs for the bucket,
# one chunk deep) and as fresh run_chunk calls.  Half the grid's chunk width
# keeps the script inside its time (at K = 32 the check took 35 s of a
# 645 s run on an H100, PERF.md §6); each chunk still holds both hidden
# sizes and both positional dims, so its statics are the sweep's
GRAPH_SWEEP_CHUNKS, GRAPH_SWEEP_K = 3, 16
GRAPH_LOSS_RTOL, GRAPH_EMB_ATOL = 2e-4, 2e-4
GRAPH_TURNS = (False, True)
# the device kernels of K1 and K2 by name in a torch.profiler trace (CUPTI
# names the kernels that a graph replay runs as it names launched ones);
# K2's Adam and SGD instances share a name stem and are counted together
GRAPH_TRACED_KERNELS = {"k1_fwd": "angular_fwd_kernel", "k1_bwd": "angular_bwd_kernel",
                        "k2": "dec_update_kernel"}
# phase 20's sentiment and alternating fits: phase 4's config's sentiment fit
# (one config), the K = 32 chunk's sentiment phase (phase 10's configs) and
# phase 15's alternating fit, GRAPH_SENT_EPOCHS epochs each (a validating
# sentiment epoch is a graph of its own: warmed up at epoch 0, captured at
# 10, replayed from 20), eager against captured in turns; then the chunk's
# sentiment phase once eager and once captured at GRAPH_SENT_GRID_EPOCHS,
# the grid's 400 cut to 100 (400 took 32-38 s eager, PERF.md section 5).
# Each of their epochs is 41 steps of 32 rows.
GRAPH_SENT_EPOCHS, GRAPH_SENT_GRID_EPOCHS = 40, 100
SENT_STEPS_PER_EPOCH = -(-1284 // 32)
# a steady captured epoch of those fits is one graph launch plus a few
# copies and kernels around it (the permutation, the loss, and under the
# config axis the epoch's mask): the most host launches of each kind
GRAPH_EPOCH_HOST_LAUNCHES = 8


class _GraphProbe:
    """Phase 20's view of :class:`mmtpu_torch.graphs.Graphs`: every
    instance made while it is entered, and every call of one, synced before
    and after and timed on the host clock (one call is one epoch of a fit or
    one request), with the kernel launch counters' change over the call and
    the replays it made; with ``ranges`` each call is also a
    ``record_function`` range named ``<tag>|<instance index>|<key>|<call
    index>``.  ``calls`` holds ``(graphs, key, seconds, launches, replays,
    range name)``."""

    def __init__(self, torch, tag: str = "", ranges: bool = False):
        self.torch, self.tag, self.ranges = torch, tag, ranges
        self.made, self.calls = [], []

    def __enter__(self):
        from mmtpu_torch import graphs as G

        import mmtpu_torch.kernels.angular as K
        import mmtpu_torch.kernels.decoder_update as T

        torch, probe = self.torch, self
        init, call = self._saved = (G.Graphs.__init__, G.Graphs.__call__)

        def made(g, *args, **kw):
            init(g, *args, **kw)
            probe.made.append(g)

        def timed(g, key, body, *args, **kw):
            n = sum(1 for c in probe.calls if c[0] is g)
            name = f"{probe.tag}|{probe.made.index(g)}|{key}|{n}"
            torch.cuda.synchronize()
            launched, replays = _read_launches(K, T), g.replays
            if probe.ranges:
                time.sleep(TRACE_GAP_S)
            t0 = time.perf_counter()
            if probe.ranges:
                with torch.profiler.record_function(name):
                    out = call(g, key, body, *args, **kw)
                    torch.cuda.synchronize()
            else:
                out = call(g, key, body, *args, **kw)
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = {k: v - launched[k] for k, v in _read_launches(K, T).items()}
            probe.calls.append((g, key, secs, launched, g.replays - replays, name))
            return out

        G.Graphs.__init__, G.Graphs.__call__ = made, timed
        return self

    def __exit__(self, *exc):
        from mmtpu_torch import graphs as G

        G.Graphs.__init__, G.Graphs.__call__ = self._saved

    def epochs(self, g=None) -> list:
        """The seconds of each call of ``g`` (the first instance made)."""
        g = g if g is not None else self.made[0]
        return [c[2] for c in self.calls if c[0] is g]


def _graph_inputs(torch, tmp: str, dev) -> dict:
    """Phase 20's fit paths, ``path -> run(graphs) -> (embeddings, losses)``:
    phase 4's training fit and phase 5's e2e fit, cut to GRAPH_EPOCHS."""
    from mmtpu_torch.train.e2e import E2EFitSpec, fit_e2e
    from mmtpu_torch.train.latents import fit_latents

    data_dir = os.path.join(tmp, "data")
    emb0, dec, data, vocab, hp, spec, perms = _latent_inputs(
        torch, dict(smoke_config(False), n_epochs=GRAPH_EPOCHS), data_dir, dev)
    e2e_cfg = dict(smoke_config(True), n_epochs=GRAPH_EPOCHS)
    x = _e2e_inputs(torch, e2e_cfg, data_dir, dev, e2e_cfg["optimizer"])
    espec = E2EFitSpec(n_epochs_max=GRAPH_EPOCHS, batch_size=64, unimodal=False,
                       opt_kind=e2e_cfg["optimizer"])

    def train_fit(graphs):
        out = fit_latents(emb0, dec, data, vocab, hp, spec, perms=perms, graphs=graphs)
        return out[0], out[2]

    def e2e_fit(graphs):
        out = fit_e2e(*x[:7], espec, perms=x[7], graphs=graphs)
        return out[0], out[3]

    return {"train_fit": train_fit, "e2e_fit": e2e_fit}


def _graph_chunks(torch, tmp: str, dev) -> dict:
    """Phase 20's chunk paths: phase 10's configs cut to GRAPH_SWEEP_EPOCHS,
    ``run(graphs) -> SweepResult``, dense and fused."""
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.sweep.runner import run_chunk

    configs = [dict(c, n_epochs=GRAPH_SWEEP_EPOCHS) for c in sweep_configs()]
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(load_dataset("mosi", data_dir=os.path.join(tmp, "data")),
                               pos_mode="shared", pos_dims=dims)
    return {f"chunk_{'fused' if fused else 'dense'}": (
        lambda graphs, fused=fused: run_chunk(configs, prep, batch_size=64, device=dev,
                                              return_embeddings=True, fused_dec_update=fused,
                                              graphs=graphs)) for fused in (False, True)}, configs


def _sent_calls(torch, tmp: str, dev) -> dict:
    """Phase 10's chunk, one training and inference epoch and the grid's
    GRAPH_SENT_GRID_EPOCHS sentiment epochs, run eagerly with its sentiment
    phase left out: the arguments that ``build_sweep_parts`` took (less
    ``graphs``) and those of its ``sent`` call."""
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.sweep import runner

    configs = [dict(c, n_epochs=1, n_sentiment_epochs=GRAPH_SENT_GRID_EPOCHS)
               for c in sweep_configs()]
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(load_dataset("mosi", data_dir=os.path.join(tmp, "data")),
                               pos_mode="shared", pos_dims=dims)
    real, rec = runner.build_sweep_parts, {}

    def watched(*args):
        rec["args"] = args[:5]
        parts = real(*args)
        parts["sent"] = lambda *a: rec.setdefault("sent", a)[0]
        return parts

    runner.build_sweep_parts = watched
    try:
        runner.run_chunk(configs, prep, batch_size=64, device=dev, graphs=False)
    finally:
        runner.build_sweep_parts = real
    return rec


def _graph_small_fits(torch, tmp: str, dev, sent: dict) -> dict:
    """Phase 20's sentiment and alternating paths, ``path -> run(graphs,
    epochs) -> {"loss", "vloss", "params"}`` (the losses where the fit
    returns them): phase 4's config's sentiment fit on the SIF
    latents of MOSI's train and valid splits (draws from seed 0), the
    chunk's sentiment phase through ``build_sweep_parts`` on the arguments
    ``sent`` recorded (:func:`_sent_calls`), and phase 15's alternating fit."""
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.convert import to_torch
    from mmtpu_torch.runner import Draws, prepare
    from mmtpu_torch.sweep import runner
    from mmtpu_torch.train.alternating import AlternatingFitSpec, fit_alternating
    from mmtpu_torch.train.sentiment import SentimentFitSpec, fit_sentiment
    from mmtpu_torch.tree import tree_leaves, tree_map

    move = lambda tree: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
    cfg = ExperimentConfig.from_dict(smoke_config(False))
    prep = prepare(cfg, os.path.join(tmp, "data"))
    draws = Draws(0)
    x, xv, y, yv = (to_torch(d[s], dev) for d in (prep.sif_init, prep.labels)
                    for s in ("train", "valid"))
    senti = draws.init_sentiment(prep.embed_dim, cfg.sentiment_hidden_size, 1)
    perms = draws.sentiment_permutations(x.shape[0], GRAPH_SENT_GRID_EPOCHS)

    def sentiment_fit(graphs, epochs):
        hp = {"lr": cfg.sentiment_lr, "lr_decay": cfg.lr_decay, "n_epochs": epochs}
        spec = SentimentFitSpec(n_epochs_max=epochs, early_stopping=cfg.early_stopping)
        last, _, losses, vlosses = fit_sentiment(move(senti), x, y, xv, yv, hp, spec,
                                                 perms=perms, graphs=graphs)
        return {"loss": losses, "vloss": vlosses, "params": tree_leaves(last)}

    statics, *rest = sent["args"]
    c_senti, train_e, valid_e, s_hp, c_perms = sent["sent"]

    def sentiment_chunk(graphs, epochs):
        parts = runner.build_sweep_parts(
            dataclasses.replace(statics, n_sentiment_epochs_max=epochs), *rest, graphs=graphs)
        hp = dict(s_hp, n_epochs=torch.full_like(s_hp["n_epochs"], epochs))
        return {"params": tree_leaves(parts["sent"](c_senti, train_e, valid_e, hp,
                                                    c_perms[:epochs]))}

    _, train, params = _alternating_inputs(torch, tmp)
    train, vocab = to_torch(train, dev), to_torch(prep.vocab_embeddings, dev)

    def alternating_fit(graphs, epochs):
        lat, p, losses = fit_alternating(
            move(params), train, vocab, lr=ALT_LR, word_loss_weight=ALT_WORD_WEIGHT,
            spec=AlternatingFitSpec(n_epochs=epochs, batch_size=32), graphs=graphs)
        return {"loss": losses, "params": [lat, *tree_leaves(p)]}

    return {"sentiment_fit": sentiment_fit, "sentiment_chunk": sentiment_chunk,
            "alternating_fit": alternating_fit}


def _compare_outs(captured: list, eager: list) -> dict:
    """Captured runs against eager ones (``{"loss", "vloss", "params"}``):
    the largest loss rel and parameter abs differences, and bit-equality."""
    rec = {"loss_rel": 0.0, "params_abs": 0.0, "bit_equal": True}
    for c in captured:
        for e in eager:
            if "loss" in e:
                rec["loss_rel"] = max(rec["loss_rel"], (
                    (c["loss"] - e["loss"]).abs() / e["loss"].abs()).max().item())
            rec["params_abs"] = max(rec["params_abs"], *(
                (a - b).abs().max().item() for a, b in zip(c["params"], e["params"])))
            flat = lambda o: [o[k].cpu() for k in ("loss", "vloss") if k in o] + [  # noqa: E731
                t.cpu() for t in o["params"]]
            rec["bit_equal"] &= _same(flat(c), flat(e))
    return rec


def run_graph_small_fits(torch, K, T, tmp: str, dev) -> dict:
    """Phase 20's sentiment and alternating fits (:func:`_graph_small_fits`),
    eager against captured in turns at GRAPH_SENT_EPOCHS epochs, then the
    chunk's sentiment phase eager and captured at GRAPH_SENT_GRID_EPOCHS;
    saves the chunk's sentiment arguments for the traced worker."""
    sent = _sent_calls(torch, tmp, dev)
    c_args = sent["sent"]
    torch.save({"args": sent["args"], "sent": (*c_args[:4], c_args[4][:4])},
               os.path.join(tmp, "graphs_sent.pt"))
    out, paths = {}, _graph_small_fits(torch, tmp, dev, sent)
    for path, fn in paths.items():
        turns = [_turn(torch, K, T, dev, lambda g: fn(g, GRAPH_SENT_EPOCHS), g)
                 for g in GRAPH_TURNS]
        eager, captured = _split_turns(turns)
        rec = _compare_outs([t["out"] for t in captured], [t["out"] for t in eager])
        s_epoch = {m: [_steady(t["probe"].epochs(), m == "captured") for t in ts]
                   for m, ts in (("eager", eager), ("captured", captured))}
        made = [t["probe"].made[0] for t in captured]
        rec.update({"s_per_epoch": s_epoch,
                    "first_epochs_s": [t["probe"].epochs()[:3] for t in captured],
                    "capture_s": [g.capture_s for g in made],
                    "graphs": [(g.captures, g.replays) for g in made],
                    "peak_gib": {m: [t["peak_gib"] for t in ts]
                                 for m, ts in (("eager", eager), ("captured", captured))},
                    "launches": [t["launches"] for t in turns]})
        log(f"[graphs] {path}, eager / captured in turns ({GRAPH_SENT_EPOCHS} epochs of "
            f"{SENT_STEPS_PER_EPOCH} steps): s per steady epoch eager "
            f"{[round(x, 5) for x in s_epoch['eager']]} captured "
            f"{[round(x, 5) for x in s_epoch['captured']]}; captured first three epochs "
            f"{[[round(x, 4) for x in f] for f in rec['first_epochs_s']]} s, capture "
            f"{[round(x, 4) for x in rec['capture_s']]} s, (graphs, replays) {rec['graphs']}; "
            f"peak GiB {rec['peak_gib']}; launches {rec['launches'][0]} in every turn: "
            f"{all(t['launches'] == turns[0]['launches'] for t in turns)}; captured against "
            f"eager: loss max rel {rec['loss_rel']:.3e}, params max abs "
            f"{rec['params_abs']:.3e}, bit-equal {rec['bit_equal']}")
        k1 = GRAPH_SENT_EPOCHS * SENT_STEPS_PER_EPOCH if path == "alternating_fit" else 0
        if any(t["launches"] != {"k1_fwd": k1, "k1_bwd": 0, "k2_adam": 0, "k2_sgd": 0,
                                 "tok_fwd": 0, "tok_bwd": 0, "adam_tree": 0, "adam_touch": 0}
               for t in turns):
            raise AssertionError(f"{path}: launches {rec['launches']}, expected K1-fwd {k1} "
                                 f"in every turn and nothing else")
        if not all(g.captures and g.replays for g in made) or any(
                t["probe"].made[0].enabled for t in eager):
            raise AssertionError(f"{path}: the captured turns did not replay, or the eager "
                                 f"turns captured")
        if not (rec["loss_rel"] < GRAPH_LOSS_RTOL and rec["params_abs"] < GRAPH_EMB_ATOL):
            raise AssertionError(f"{path}: the captured fit disagrees with the eager one")
        out[path] = rec

    grid = lambda g: paths["sentiment_chunk"](g, GRAPH_SENT_GRID_EPOCHS)  # noqa: E731
    eager, captured = (_turn(torch, K, T, dev, grid, g) for g in (False, True))
    rec = _compare_outs([captured["out"]], [eager["out"]])
    rec.update({"s": {"eager": eager["s"], "captured": captured["s"]},
                "s_per_steady_epoch": {"eager": _steady(eager["probe"].epochs(), False),
                                       "captured": _steady(captured["probe"].epochs(), True)},
                "capture_s": captured["probe"].made[0].capture_s,
                "peak_gib": {"eager": eager["peak_gib"], "captured": captured["peak_gib"]}})
    log(f"[graphs] sentiment_chunk at {GRAPH_SENT_GRID_EPOCHS} epochs ("
        f"{len(sweep_configs())} configs): s eager {eager['s']:.3f} captured "
        f"{captured['s']:.3f} (capture {rec['capture_s']:.3f} s); s per steady epoch eager "
        f"{rec['s_per_steady_epoch']['eager']:.5f} captured "
        f"{rec['s_per_steady_epoch']['captured']:.5f}; peak GiB {rec['peak_gib']}; captured "
        f"against eager: params max abs {rec['params_abs']:.3e}, bit-equal {rec['bit_equal']}")
    if not rec["params_abs"] < GRAPH_EMB_ATOL:
        raise AssertionError(f"the chunk's captured {GRAPH_SENT_GRID_EPOCHS}-epoch sentiment "
                             f"phase disagrees")
    out["sentiment_chunk_grid"] = rec
    return out


def _turn(torch, K, T, dev, fn, graphs):
    """One run of ``fn(graphs)``: its result, launches, seconds, peak memory
    and the Graphs calls it made."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches(K, T)
    with _GraphProbe(torch) as probe:
        t0 = time.perf_counter()
        out = fn(graphs)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
    return {"out": out, "launches": _read_launches(K, T), "s": secs, "probe": probe,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def _split_turns(turns: list) -> tuple:
    """``(eager turns, captured turns)`` of runs made in ``GRAPH_TURNS`` order."""
    return ([t for t, g in zip(turns, GRAPH_TURNS) if not g],
            [t for t, g in zip(turns, GRAPH_TURNS) if g])


def _steady(times: list, captured: bool) -> float:
    """Seconds per steady epoch: the median past the first epoch (eager) or
    past the warm-up and capture epochs (captured)."""
    return statistics.median(times[2:] if captured else times[1:])


def _same(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)
               for x, y in zip(a, b))


def run_graphs(torch, K, T, tmp: str, e2e: dict) -> dict:
    """Phase 20: the training fit, the e2e fit, the K = 32 chunk (dense and
    fused), the sentiment and alternating fits and the server, eager
    against captured in turns; then their host launches per step and
    device idle share under ``torch.profiler`` in a fresh process
    (``--graphs-worker``)."""
    import numpy as np

    from mmtpu_torch import graphs as G

    if GRAPH_EPOCHS < G.MIN_EPOCHS or GRAPH_SWEEP_EPOCHS < G.MIN_EPOCHS:
        raise AssertionError(f"phase 20's fits would not capture below {G.MIN_EPOCHS} epochs")
    dev = torch.device("cuda", 0)
    out = {}
    for path, fn in _graph_inputs(torch, tmp, dev).items():
        turns = [_turn(torch, K, T, dev, fn, g) for g in GRAPH_TURNS]
        eager, captured = _split_turns(turns)
        diffs = [((c["out"][1] - e["out"][1]).abs() / e["out"][1].abs()).max().item()
                 for c in captured for e in eager]
        emb = [(c["out"][0] - e["out"][0]).abs().max().item() for c in captured for e in eager]
        bit_equal = all(_same([x.cpu() for x in c["out"]], [x.cpu() for x in e["out"]])
                        for c in captured for e in eager)
        steps = GRAPH_EPOCHS * STEPS_PER_EPOCH
        s_epoch = {m: [_steady(t["probe"].epochs(), m == "captured") for t in ts]
                   for m, ts in (("eager", eager), ("captured", captured))}
        rec = {"s_per_epoch": s_epoch,
               "utt_s": {m: [1284 / s for s in v] for m, v in s_epoch.items()},
               "first_epochs_s": [t["probe"].epochs()[:2] for t in captured],
               "capture_s": [t["probe"].made[0].capture_s for t in captured],
               "peak_gib": {m: [t["peak_gib"] for t in ts]
                            for m, ts in (("eager", eager), ("captured", captured))},
               "launches": [t["launches"] for t in turns], "loss_rel": max(diffs),
               "emb_abs": max(emb), "bit_equal": bit_equal}
        log(f"[graphs] {path}, eager / captured in turns ({GRAPH_EPOCHS} epochs): s per "
            f"steady epoch eager {[round(s, 5) for s in s_epoch['eager']]} captured "
            f"{[round(s, 5) for s in s_epoch['captured']]}; utt/s eager "
            f"{[round(u, 1) for u in rec['utt_s']['eager']]} captured "
            f"{[round(u, 1) for u in rec['utt_s']['captured']]}; captured first two epochs "
            f"(warm-up, capture + replay) {[[round(s, 4) for s in f] for f in rec['first_epochs_s']]} s, "
            f"capture {[round(s, 4) for s in rec['capture_s']]} s; peak GiB {rec['peak_gib']}; "
            f"launches {rec['launches']}; captured against eager: loss max rel "
            f"{rec['loss_rel']:.3e}, embeddings max abs {rec['emb_abs']:.3e}, bit-equal "
            f"{bit_equal}")
        if any(t["launches"] != turns[0]["launches"] for t in turns) or min(
                turns[0]["launches"]["k1_fwd"], turns[0]["launches"]["k1_bwd"]) != steps:
            raise AssertionError(f"{path}: launches {rec['launches']}, expected {steps} of K1 "
                                 f"each in every turn")
        if not (rec["loss_rel"] < GRAPH_LOSS_RTOL and rec["emb_abs"] < GRAPH_EMB_ATOL):
            raise AssertionError(f"{path}: the captured fit disagrees with the eager one")
        out[path] = rec

    chunks, configs = _graph_chunks(torch, tmp, dev)
    n_train, k = 1284, len(configs)
    for path, fn in chunks.items():
        turns = [_turn(torch, K, T, dev, fn, g) for g in GRAPH_TURNS]
        eager, captured = _split_turns(turns)
        worst = {"loss_rel": 0.0, "pred_abs": 0.0, "emb_abs": 0.0}
        bad, bit_equal = [], True
        for c in captured:
            for e in eager:
                got, want = c["out"], e["out"]
                ok = ~want.diverged
                if not np.array_equal(got.diverged, want.diverged) or not ok.any():
                    raise AssertionError(f"{path}: diverged configs differ or all diverged")
                worst["loss_rel"] = max(worst["loss_rel"], float(np.max(
                    np.abs(got.final_train_loss[ok] - want.final_train_loss[ok])
                    / np.abs(want.final_train_loss[ok]))))
                worst["pred_abs"] = max(worst["pred_abs"], float(
                    np.abs(got.predictions[ok] - want.predictions[ok]).max()))
                bit_equal &= _same([got.final_train_loss, got.predictions]
                                   + [got.embeddings[s] for s in ("train", "valid", "test")],
                                   [want.final_train_loss, want.predictions]
                                   + [want.embeddings[s] for s in ("train", "valid", "test")])
                for i in np.nonzero(ok)[0]:  # phase 11's per-config rule (Adam)
                    d = np.concatenate([np.abs(got.embeddings[s][i] - want.embeddings[s][i])
                                        for s in ("train", "valid", "test")])
                    worst["emb_abs"] = max(worst["emb_abs"], float(d.max()))
                    if ((d > SWEEP_ATOL).sum() > ADAM_EMB_OVER_SHARE * d.size
                            or d.max() > ADAM_EMB_MAX_LR * configs[i]["lr"]):
                        bad.append(int(configs[i]["config_num"]))
        s_epoch = {m: [_steady(t["probe"].epochs(), m == "captured") for t in ts]
                   for m, ts in (("eager", eager), ("captured", captured))}
        steps = -(-n_train // 64)
        rec = {"s_per_epoch": s_epoch, "ms_per_step": {
                   m: [1e3 * s / steps for s in v] for m, v in s_epoch.items()},
               "rate": {m: [k * n_train / s for s in v] for m, v in s_epoch.items()},
               "phase_s": [t["out"].phase_s for t in turns],
               "capture_s": [sum(g.capture_s for g in t["probe"].made) for t in captured],
               "peak_gib": {m: [t["peak_gib"] for t in ts]
                            for m, ts in (("eager", eager), ("captured", captured))},
               "launches": [t["launches"] for t in turns], "bit_equal": bit_equal, **worst}
        log(f"[graphs] {path} ({k} configs, {GRAPH_SWEEP_EPOCHS} epochs), eager / captured in "
            f"turns: train ms per steady step eager "
            f"{[round(x, 3) for x in rec['ms_per_step']['eager']]} captured "
            f"{[round(x, 3) for x in rec['ms_per_step']['captured']]}; config-utterance-epochs/s "
            f"eager {[round(r, 1) for r in rec['rate']['eager']]} captured "
            f"{[round(r, 1) for r in rec['rate']['captured']]}; phases s "
            f"{[{p: round(v, 3) for p, v in ps.items()} for ps in rec['phase_s']]}; capture "
            f"(all the chunk's graphs) {[round(s, 3) for s in rec['capture_s']]} s; peak GiB "
            f"{rec['peak_gib']}; launches {rec['launches'][0]} in every turn: "
            f"{all(t['launches'] == turns[0]['launches'] for t in turns)}; captured against "
            f"eager: final loss max rel {worst['loss_rel']:.3e}, predictions max abs "
            f"{worst['pred_abs']:.3e}, embeddings max abs {worst['emb_abs']:.3e}, bit-equal "
            f"{bit_equal}")
        if any(t["launches"] != turns[0]["launches"] for t in turns):
            raise AssertionError(f"{path}: launches differ between turns: {rec['launches']}")
        if not (worst["loss_rel"] < SWEEP_RTOL and worst["pred_abs"] < FUSED_PRED_ATOL) or bad:
            raise AssertionError(f"{path}: the captured chunk disagrees with the eager one "
                                 f"(embeddings outside phase 11's rule in configs {bad})")
        out[path] = rec

    out["sweep"] = _graph_sweep(torch, K, T, tmp, dev)
    out.update(run_graph_small_fits(torch, K, T, tmp, dev))
    out["break_even"] = _graph_break_even(torch, tmp, dev)
    out["server"] = _graph_server(torch, K, T, tmp, e2e, dev)
    traced = _graph_trace(torch, tmp, e2e)
    out["profiled"], out["trace_placement"] = traced["paths"], traced["placement"]
    log(f"[graphs] traced K1 / K2 kernels placed by their launch call's host time "
        f"{traced['placement']['by_launch']}, by their own start "
        f"{traced['placement']['by_own_start']}; named in the whole trace "
        f"{traced['placement']['in_trace']}")
    for path, t in out["profiled"].items():
        log(f"[graphs] {path}, traced (torch.profiler, one steady epoch or 8 requests): " + "; ".join(
            f"{m} host launches per step: kernels {v['kernel_launches_per_step']:.2f}, graphs "
            f"{v['graph_launches_per_step']:.3f}, copies and sets {v['copies_per_step']:.2f} ("
            f"per epoch or 8 requests: {v['kernel_launches_per_step'] * v['steps']:.0f}, "
            f"{v['graph_launches_per_step'] * v['steps']:.0f}, "
            f"{v['copies_per_step'] * v['steps']:.0f}); device events {v['device_events']}, "
            f"busy {v['busy_ms']:.3f} of {v['wall_ms']:.3f} ms, idle "
            f"{100 * v['idle_share']:.1f} %" for m, v in t.items()))
        if path in ("sentiment_fit", "sentiment_chunk", "alternating_fit"):
            v = t["captured"]
            per_epoch = [round(v[f"{k}_per_step"] * v["steps"])
                         for k in ("graph_launches", "kernel_launches", "copies")]
            if per_epoch[0] != 1 or max(per_epoch[1:]) > GRAPH_EPOCH_HOST_LAUNCHES:
                raise AssertionError(f"{path}: a steady captured epoch launched (graphs, kernels, "
                                     f"copies) {per_epoch} from the host")
        for m, v in t.items():
            c = v.get("launch_check")
            if c is None:  # the server runs no K1 or K2
                continue
            log(f"[graphs] {path}, {m}, K1 / K2 in the trace against the counters over "
                f"{c['calls']} Graphs calls ({c['replays']} replays): traced {c['traced']}, "
                f"counted {c['counted']}, traced inside replays {c['replay_traced']}; "
                f"calls that differ: {len(c['mismatched'])}")
            runs_k1 = not path.startswith("sentiment")  # the sentiment fits run no kernel
            if c["mismatched"] or (m == "captured") != bool(c["replays"]) or runs_k1 and (
                    c["traced"]["k1_fwd"] == 0
                    or c["replays"] and c["replay_traced"]["k1_fwd"] == 0):
                raise AssertionError(f"{path} ({m}): the K1 / K2 kernels in the trace differ from "
                                     f"the launch counters: {c['mismatched'][:3]}")
    return out


def _graph_sweep(torch, K, T, tmp: str, dev) -> dict:
    """Phase 20's sweep bucket (``GRAPH_SWEEP_CHUNKS`` chunks of
    ``GRAPH_SWEEP_K`` configs), once through
    ``run_sweep`` and once as fresh ``run_chunk`` calls, one per chunk.  Per
    chunk: bit-equality, the bucket store's warm-ups, captures and replays,
    K1 / K2 launches (the sweep's counted around each chunk's queue step,
    where its fits launch and replay) and ``done_at_s``; the sweep's wall
    time against the chunks' alone.  Fails unless every chunk after the
    first warms up and captures nothing, equals its chunk alone bit for bit
    and launches what it launches alone."""
    import numpy as np

    from mmtpu_torch.config import make_grid
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.sweep import runner

    bucket = [c for c in make_grid() if c["optimizer"] == "adam" and c["n_epochs"] == 100]
    configs = [dict(c, n_epochs=GRAPH_SWEEP_EPOCHS, n_sentiment_epochs=GRAPH_SWEEP_EPOCHS)
               for c in bucket[:GRAPH_SWEEP_CHUNKS * GRAPH_SWEEP_K]]
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(load_dataset("mosi", data_dir=os.path.join(tmp, "data")),
                               pos_mode="shared", pos_dims=dims)
    queue, swept_launches = runner._queue, []

    def counted(*args, **kw):
        before = _read_launches(K, T)
        out = queue(*args, **kw)
        swept_launches.append({k: v - before[k] for k, v in _read_launches(K, T).items()})
        return out

    torch.cuda.synchronize(dev)
    _reset_launches(K, T)
    runner._queue = counted
    try:
        t0 = time.perf_counter()
        swept = runner.run_sweep(configs, prep, batch_size=64, chunk_size=GRAPH_SWEEP_K,
                                 return_embeddings=True, verbose=False, device=dev)
        torch.cuda.synchronize(dev)
        sweep_s = time.perf_counter() - t0
    finally:
        runner._queue = queue
    sweep_launches = _read_launches(K, T)
    alone, alone_s, alone_launches = [], [], []
    for i in range(GRAPH_SWEEP_CHUNKS):
        _reset_launches(K, T)
        t0 = time.perf_counter()
        rows = slice(i * GRAPH_SWEEP_K, (i + 1) * GRAPH_SWEEP_K)
        alone.append(runner.run_chunk(configs[rows], prep, batch_size=64,
                                      return_embeddings=True, device=dev))
        torch.cuda.synchronize(dev)
        alone_s.append(time.perf_counter() - t0)
        alone_launches.append(_read_launches(K, T))
    chunks = []
    for i, (stats, want) in enumerate(zip(swept.chunk_stats, alone)):
        rows = slice(i * GRAPH_SWEEP_K, (i + 1) * GRAPH_SWEEP_K)
        bit_equal = _same([swept.final_train_loss[rows]]
                          + [swept.metrics[m][rows] for m in sorted(want.metrics)]
                          + [swept.embeddings[s][rows] for s in ("train", "valid", "test")],
                          [want.final_train_loss] + [want.metrics[m] for m in sorted(want.metrics)]
                          + [want.embeddings[s] for s in ("train", "valid", "test")])
        chunks.append({"chunk": stats["chunk"], "bit_equal": bit_equal, **stats["graphs"],
                       "launches": swept_launches[i], "launches_alone": alone_launches[i],
                       "done_at_s": stats["done_at_s"], "alone_s": alone_s[i],
                       "diverged": int(want.diverged.sum())})
    rec = {"chunks": chunks, "sweep_s": sweep_s, "sweep_wall_time_s": swept.wall_time_s,
           "alone_sum_s": sum(alone_s), "launches": sweep_launches}
    for c in chunks:
        log(f"[graphs] sweep bucket, chunk {c['chunk']} ({GRAPH_SWEEP_K} configs, "
            f"{GRAPH_SWEEP_EPOCHS} epochs and sentiment epochs): bit-equal to the chunk alone "
            f"{c['bit_equal']}; warm-ups {c['warmups']}, captures {c['captures']}, replays "
            f"{c['replays']}; launches {c['launches']}, alone {c['launches_alone']}; done at "
            f"{c['done_at_s']} s; alone {c['alone_s']:.3f} s; diverged configs {c['diverged']}")
    log(f"[graphs] sweep bucket of {GRAPH_SWEEP_CHUNKS} chunks: run_sweep {sweep_s:.3f} s "
        f"(its wall_time_s {swept.wall_time_s:.3f}) against the chunks alone "
        f"{[round(x, 3) for x in alone_s]} s, summed {sum(alone_s):.3f} s; launches "
        f"{sweep_launches}")
    first, later = chunks[0], chunks[1:]
    if not first["captures"] or any(c["warmups"] or c["captures"] or not c["replays"]
                                    for c in later):
        raise AssertionError(f"sweep bucket: a chunk after the first warmed up or captured, "
                             f"or the first captured nothing: {chunks}")
    if not all(c["bit_equal"] and c["launches"] == c["launches_alone"] for c in chunks):
        raise AssertionError(f"sweep bucket: a chunk differs from the chunk alone: {chunks}")
    return rec


def _infer_calls(torch, run) -> dict:
    """``run()`` (a chunk or a config alone, eagerly) with the sweep's
    ``build_sweep_parts`` watched: the arguments it took and those of each
    ``infer`` call (valid, then test)."""
    from mmtpu_torch.sweep import runner

    real, rec = runner.build_sweep_parts, {"calls": []}

    def watched(*args):
        rec["args"] = args[:5]
        parts = real(*args)
        infer = parts["infer"]
        parts["infer"] = lambda *a: rec["calls"].append(a) or infer(*a)
        return parts

    runner.build_sweep_parts = watched
    try:
        run()
    finally:
        runner.build_sweep_parts = real
    return rec


def _graph_break_even(torch, tmp: str, dev) -> dict:
    """Phase 20's break-even of graphs.MIN_EPOCHS: the valid and test
    inference fits of phase 10's dense chunk and of one of its configs alone,
    with the trained decoder of a one-epoch run, at GRAPH_BREAK_EVEN's epoch
    counts and caps; eager against captured in turns (``GRAPH_TURNS``), captured
    forced below the threshold.  Per case: which mode the default picks,
    seconds per fit, and the captured embeddings against the eager ones."""
    import dataclasses

    from mmtpu_torch import graphs as G
    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.sweep import runner

    configs = [dict(c, n_epochs=1) for c in sweep_configs()]
    dims = tuple(sorted({c["pos_embed_dim"] for c in configs}))
    prep = prepare_device_data(load_dataset("mosi", data_dir=os.path.join(tmp, "data")),
                               pos_mode="shared", pos_dims=dims)
    recs = {"chunk": _infer_calls(torch, lambda: runner.run_chunk(
                configs, prep, batch_size=64, device=dev, graphs=False)),
            "alone": _infer_calls(torch, lambda: runner.run_config_alone(
                configs[0], prep, batch_size=64, device=dev, graphs=False))}
    out, threshold = {}, G.MIN_EPOCHS
    for label, kind, n_epochs, cap in GRAPH_BREAK_EVEN:
        statics, *rest = recs[kind]["args"]
        statics = dataclasses.replace(statics, n_epochs_max=n_epochs, infer_epochs_cap=cap)
        fit_epochs = min(n_epochs, cap) if cap else n_epochs
        rec = {"fit_epochs": fit_epochs, "default": "captured" if fit_epochs >= threshold
               else "eager", "eager_s": {}, "captured_s": {}, "capture_s": {}}
        worst = 0.0
        turns = GRAPH_TURNS
        for g in turns:
            G.MIN_EPOCHS = 0  # both modes at any epoch count
            try:
                parts = runner.build_sweep_parts(statics, *rest, graphs=g)
                for split, (init, dec, hp, data) in zip(("valid", "test"), recs[kind]["calls"]):
                    n = hp["n_epochs"]
                    hp = dict(hp, n_epochs=torch.full_like(n, n_epochs)
                              if isinstance(n, torch.Tensor) else n_epochs)
                    torch.cuda.synchronize()
                    with _GraphProbe(torch) as probe:
                        t0 = time.perf_counter()
                        emb = parts["infer"](init, dec, hp, data)
                        torch.cuda.synchronize()
                        secs = time.perf_counter() - t0
                    mode = "captured" if g else "eager"
                    rec[f"{mode}_s"].setdefault(split, []).append(secs)
                    if g:
                        rec["capture_s"].setdefault(split, []).append(probe.made[0].capture_s)
                        worst = max(worst, (emb - rec[split]).abs().max().item())
                    else:
                        rec[split] = emb
            finally:
                G.MIN_EPOCHS = threshold
        for split in ("valid", "test"):
            rec.pop(split)
        rec["emb_abs"] = worst
        log(f"[graphs] break-even {label} ({kind}, {fit_epochs} epochs per inference fit, the "
            f"default {rec['default']}): s per fit, eager / captured in turns: " + "; ".join(
                f"{split} {[round(x, 4) for x in rec['eager_s'][split]]} / "
                f"{[round(x, 4) for x in rec['captured_s'][split]]} (capture "
                f"{[round(x, 4) for x in rec['capture_s'][split]]})" for split in ("valid", "test"))
            + f"; captured against eager embeddings max abs {worst:.3e}")
        if not worst < GRAPH_EMB_ATOL:
            raise AssertionError(f"break-even {label}: the captured inference fits disagree")
        out[label] = rec
    return out


def _graph_server(torch, K, T, tmp: str, e2e: dict, dev) -> dict:
    """Phase 20's server: phase 13's ladder and requests, eager against
    captured in turns per size and form, and their answers."""
    import numpy as np

    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.runner import prepare
    from mmtpu_torch.serve import ClosedFormServer, stats_request

    _, dec, senti = e2e["train_fit"][:3]
    prep = prepare(ExperimentConfig.from_dict(smoke_config(True)), os.path.join(tmp, "data"))
    keys = ("text_ids", "text_weights", "text_gauss", "audio", "visual")
    test = {k: prep.splits["test"][k] for k in keys}
    big = {k: np.concatenate([prep.splits["train"][k], prep.splits["valid"][k]])[:SERVE_BIG]
           for k in keys}
    reqs = {3: {k: v[:3] for k, v in test.items()}, 64: {k: v[:64] for k, v in test.items()},
            686: test, SERVE_BIG: big}
    servers = {}
    for g in (False, True):
        servers[g] = ClosedFormServer(dec, batch_sizes=SERVE_LADDER, sentiment_params=senti,
                                      word_embeddings=prep.vocab_embeddings, device=dev,
                                      graphs=g)
        t0 = time.perf_counter()
        servers[g].warmup({k: v[:2] for k, v in test.items()})
        torch.cuda.synchronize()
        servers[g].warmup_s = time.perf_counter() - t0
    latency, worst, bit_equal = {}, 0.0, True
    _reset_launches(K, T)
    for n, r in reqs.items():
        sr = stats_request(r)
        forms = {"device_raw": _on_device(torch, r, dev),
                 "device_stats": _on_device(torch, sr, dev), "host_raw": r, "host_stats": sr}
        latency[n] = {}
        for name, f in forms.items():
            ms = {g: [] for g in (False, True)}
            for g in GRAPH_TURNS:
                ms[g].append(_host_ms(torch, lambda f=f, g=g: servers[g](f)))
            latency[n][name] = {"eager": ms[False], "captured": ms[True]}
            got, want = servers[True](f), servers[False](f)
            worst = max(worst, *(float(np.abs(a - b).max()) for a, b in zip(got, want)))
            bit_equal &= _same(got, want)
        log(f"[graphs] server {n} rows: median of 8 ms, eager / captured in turns: " + ", ".join(
            f"{name} {[round(x, 3) for x in v['eager']]} / {[round(x, 3) for x in v['captured']]}"
            for name, v in latency[n].items()))
    graphs = servers[True]._graphs
    log(f"[graphs] server: warm-up s eager {servers[False].warmup_s:.3f} captured "
        f"{servers[True].warmup_s:.3f} (capture {graphs.capture_s:.3f} s, {graphs.captures} "
        f"graphs); captured against eager answers max abs {worst:.3e} (limit {SERVE_ATOL}), "
        f"bit-equal {bit_equal}")
    launches = _read_launches(K, T)
    if worst > SERVE_ATOL or any(launches.values()) or not graphs.replays:
        raise AssertionError(f"the captured server disagrees with the eager one, or launched "
                             f"{launches}")
    return {"latency_ms": latency, "max_abs": worst, "bit_equal": bit_equal,
            "capture_s": graphs.capture_s, "graphs": graphs.captures,
            "warmup_s": {"eager": servers[False].warmup_s, "captured": servers[True].warmup_s}}


def _graph_trace(torch, tmp: str, e2e: dict) -> dict:
    """Runs this script with ``--graphs-worker TMP`` (a fresh process: a
    process's second profiler session records no device event); its result."""
    from mmtpu_torch.tree import tree_map

    _, dec, senti = e2e["train_fit"][:3]
    torch.save({"dec": tree_map(lambda t: t.detach().cpu(), dec),
                "senti": tree_map(lambda t: t.detach().cpu(), senti)},
               os.path.join(tmp, "graphs_server.pt"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--graphs-worker", tmp],
                          cwd=tmp, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=WORKER_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"the graphs worker exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def graphs_worker(argv: list) -> int:
    """Phase 20's traced runs (``chip_smoke.py --graphs-worker TMP``): each fit
    and chunk path eager and captured (3 epochs, the sentiment and
    alternating fits 4: the last is a steady replay)
    and 8 686-row device-resident requests of each form, in one
    ``torch.profiler`` session; per path and mode, the steady epoch's (or
    the requests') host kernel and graph launches per step, device events,
    busy time and idle share.  Prints one JSON line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, ROOT)
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.runner import prepare
    from mmtpu_torch.serve import ClosedFormServer, stats_request

    (tmp,) = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # 3 epochs, the last a steady replay (one is the same at any epoch
    # count), with the threshold lowered so that the fits capture
    from mmtpu_torch import graphs as G

    global GRAPH_EPOCHS, GRAPH_SWEEP_EPOCHS
    GRAPH_EPOCHS = GRAPH_SWEEP_EPOCHS = G.MIN_EPOCHS = 3
    paths = _graph_inputs(torch, tmp, dev)
    paths.update(_graph_chunks(torch, tmp, dev)[0])
    steps = dict.fromkeys(paths, STEPS_PER_EPOCH)
    # the sentiment and alternating fits at 4 epochs: a sentiment fit's
    # epoch 0 validates (a key of its own), so its last epoch is the first
    # steady replay of the training key
    sent = torch.load(os.path.join(tmp, "graphs_sent.pt"), weights_only=False)
    for path, fn in _graph_small_fits(torch, tmp, dev, sent).items():
        paths[path] = lambda g, fn=fn: fn(g, 4)
        steps[path] = SENT_STEPS_PER_EPOCH
    p = torch.load(os.path.join(tmp, "graphs_server.pt"), weights_only=False)
    prep = prepare(ExperimentConfig.from_dict(smoke_config(True)), os.path.join(tmp, "data"))
    test = {k: prep.splits["test"][k] for k in ("text_ids", "text_weights", "text_gauss",
                                                "audio", "visual")}
    forms = {"raw": _on_device(torch, test, dev),
             "stats": _on_device(torch, stats_request(test), dev)}
    servers = {g: ClosedFormServer(p["dec"], batch_sizes=SERVE_LADDER, sentiment_params=p["senti"],
                                   word_embeddings=prep.vocab_embeddings, device=dev, graphs=g)
               for g in (False, True)}
    for s in servers.values():
        for f in forms.values():
            s(f), s(f)
    windows, probes, reps = {}, {}, 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for path, fn in paths.items():
            for g in (False, True):
                tag = f"{path}|{'captured' if g else 'eager'}"
                with _GraphProbe(torch, tag, ranges=True) as probe:
                    fn(g)
                probes[tag] = probe
                # the fit's or the chunk's train fit: its last epoch is steady
                windows[tag] = (f"{tag}|0|{probe.calls[0][1]}|{len(probe.epochs()) - 1}",
                                steps[path])
        for name, f in forms.items():
            for g in (False, True):
                tag = f"serve_686_{name}|{'captured' if g else 'eager'}"
                with record_function(tag):
                    for _ in range(reps):
                        servers[g](f)
                    torch.cuda.synchronize()
                windows[tag] = (tag, reps)
    # one pass over the trace: the ranges (spans), the device events (kernels,
    # copies and sets; the ranges' own device-side annotations, named as the
    # ranges, span whole windows and are left out), the host's runtime calls,
    # and K1 and K2 placed by the host time of the runtime call that launched
    # them (cudaLaunchKernel, or cudaGraphLaunch for a replay's kernels; the
    # same correlation id), which the device clock's offset cannot move
    # across a range's edge; by their own start where no call matches
    spans, device, host, launched_at, kernels = {}, [], [], {}, []
    patterns = tuple(GRAPH_TRACED_KERNELS.values())
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if "|" not in name:
                device.append((start, start + e.duration_ns()))
                if any(k in name for k in patterns):
                    kernels.append((e.correlation_id(), start, name))
        elif "|" in name:
            spans[name] = (start, start + e.duration_ns())
        elif name.startswith("cu"):
            host.append((start, name))
            if name.startswith("cuda") and "Launch" in name:
                launched_at[e.correlation_id()] = start
    device.sort()
    named = [(launched_at.get(c, t), n, c in launched_at) for c, t, n in kernels]
    placement = {"by_launch": sum(x[2] for x in named),
                 "by_own_start": sum(not x[2] for x in named),
                 "in_trace": {k: sum(pat in n for _, n, _ in named)
                              for k, pat in GRAPH_TRACED_KERNELS.items()}}
    out = {}
    for tag, (span_name, per) in windows.items():
        a, b = spans[span_name]
        inside = [(s, e) for s, e in device if a <= s <= b]
        busy, end = 0, a
        for s, e in inside:  # the union of the device intervals
            busy += max(0, e - max(s, end))
            end = max(end, e)
        calls = [n for t, n in host if a <= t <= b]
        path, mode = tag.split("|")[:2]
        out.setdefault(path, {})[mode] = {
            "kernel_launches_per_step": sum("LaunchKernel" in n for n in calls) / per,
            "graph_launches_per_step": sum("GraphLaunch" in n for n in calls) / per,
            "copies_per_step": sum("Memcpy" in n or "Memset" in n for n in calls) / per,
            "steps": per, "device_events": len(inside), "busy_ms": busy / 1e6,
            "wall_ms": (b - a) / 1e6,
            "idle_share": 1 - busy / max(b - a, 1)}
    for tag, probe in probes.items():  # K1 and K2 in the trace against the counters
        path, mode = tag.split("|")
        check = {"calls": 0, "replays": 0, "traced": dict.fromkeys(GRAPH_TRACED_KERNELS, 0),
                 "counted": dict.fromkeys(GRAPH_TRACED_KERNELS, 0), "replay_traced":
                 dict.fromkeys(GRAPH_TRACED_KERNELS, 0), "mismatched": []}
        for _, _, _, launched, replays, name in probe.calls:
            a, b = spans[name]
            counted = {k: launched[k] for k in ("k1_fwd", "k1_bwd")}
            counted["k2"] = launched["k2_adam"] + launched["k2_sgd"]
            traced = {k: sum(a <= t <= b and pat in n for t, n, _ in named)
                      for k, pat in GRAPH_TRACED_KERNELS.items()}
            check["calls"] += 1
            check["replays"] += replays
            for k in traced:
                check["traced"][k] += traced[k]
                check["counted"][k] += counted[k]
                check["replay_traced"][k] += traced[k] if replays else 0
            if traced != counted:
                check["mismatched"].append({"call": name, "traced": traced, "counted": counted})
        out[path][mode]["launch_check"] = check
    print(json.dumps({"paths": out, "placement": placement}), flush=True)
    return 0


def _traced_launches(graphs: dict, key: str) -> dict:
    """Phase 20's traced runs, per path and mode: the launches of ``key``
    (K1's ``k1_fwd`` / ``k1_bwd``, or ``k2``) the counters gave (graph
    replays add their capture's), those the trace named, and those it named
    inside replays."""
    return {f"{path}_{m}": {"counted": c["counted"][key], "traced": c["traced"][key],
                            "traced_in_replays": c["replay_traced"][key]}
            for path, t in graphs["profiled"].items() for m, v in t.items()
            for c in [v.get("launch_check")] if c is not None}


def _phase(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds printed under the phase's name."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--mesh-worker"]:  # one rank of phase 17's worlds
        return mesh_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--graphs-worker"]:  # phase 20's traced runs
        return graphs_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--tasks-worker"]:  # phase 21's CPU references
        sys.path.insert(0, ROOT)
        return tasks_worker(sys.argv[2:])
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
                 for kind in ("fwd", "bwd") for d in (300, 512, 768, 1024, 2048)}
    slices = {d: lib.angular_bwd_depth_slices(d) for d in (300, 512, 768, 1024, 2048)}
    k2_occupancy = {kind: lib.dec_update_blocks_per_sm(int(kind == "adam"))
                    for kind in ("adam", "sgd")}
    log(f"[build] kernel library built and loaded in {time.perf_counter() - t0:.2f} s; "
        f"K1 resident blocks per SM: {occupancy}; K1-bwd depth slices: {slices}; K2 resident blocks per SM (D = 300 and "
        f"any D): {k2_occupancy}")

    k1 = _phase("2 (K1)", check_kernels, torch, K, dev)
    k2 = _phase("3 (K2)", check_k2, torch, T, dev)
    tok = _phase("22 (token kernels)", check_token_kernels, torch, dev)
    adam = _phase("23 (Adam kernel)", check_adam_kernel, torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        non_e2e = _phase("4 (non-e2e)", run_cli_path, torch, K, T, tmp, e2e=False)
        e2e = _phase("5 (e2e)", run_cli_path, torch, K, T, tmp, e2e=True,
                     flags=["--time_test"])
        fused = _phase("6 (fused)", run_fused_path, torch, K, T, tmp)
        lazy = _phase("8 (lazy)", run_lazy_path, torch, K, T, tmp)
        resume = _phase("9 (curve, resume)", run_curve_and_resume, torch, K, T, tmp, non_e2e)
        sweep = _phase("10 (sweep chunk)", run_sweep_chunk, torch, K, T, tmp)
        fused_sweep = _phase("11 (fused chunks)", run_fused_chunks, torch, K, T, tmp, sweep)
        cli_sweep = _phase("12 (sweep CLI)", run_cli_sweep, torch, tmp)
        serving = _phase("13 (serving)", run_serving, torch, K, T, tmp, e2e)
        warm = _phase("14 (warm chunk)", run_warm_chunk, torch, K, T, tmp, sweep)
        alternating = _phase("15 (alternating)", run_alternating, torch, K, T, tmp)
        ops = _phase("16 (ops)", check_numeric_ops, torch, alternating.pop("prep"))
        mesh = _phase("17 (mesh)", run_mesh, torch, K, T, tmp, non_e2e, e2e)
        aux = _phase("18 (aux)", run_aux, tmp)
        graphs = _phase("20 (graphs)", run_graphs, torch, K, T, tmp, e2e)
        tasks = _phase("21 (tasks)", run_tasks, torch, K, T, tmp)
    _phase("7 (small agreement)", check_small_agreement, torch)
    deep_e2e = _phase("19 (deep e2e)", run_deep_e2e, torch, K, T, e2e)

    t, kb = k1["times"], k1["bounds"]
    st, sb = sweep["k1"]["times"], sweep["k1"]["bounds"]
    by_path = {"non_e2e": non_e2e["launches"], "e2e": e2e["launches"],
               "fused_sgd": fused["sgd"]["launches"], "fused_adam": fused["adam"]["launches"],
               **lazy["launches"], **resume["launches"], "sweep_chunk": sweep["launches"],
               "sweep_fused_adam": fused_sweep["adam"]["launches"],
               "sweep_fused_sgd": fused_sweep["sgd"]["launches"],
               "sweep_cli": cli_sweep["launches"],
               "sweep_cli_resumed": cli_sweep["launches_resumed"],
               "serving": serving["launches"], "sweep_warm_chunk": warm["launches"],
               "alternating": alternating["launches"], "deep_e2e": deep_e2e["launches"],
               **{f"task_{tag}": n for tag, n in tasks["launches"].items()},
               "task_pom_sweep": tasks["sweeps"]["sweep"]["launches"],
               "task_pom_chunk_k32": tasks["sweeps"]["wide_chunk"]["launches"]}
    pk = tasks["k1"]
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
         "launches_sweep_warm_chunk": warm["launches"][f"k1_{kind}"],
         "launches_alternating": alternating["launches"][f"k1_{kind}"],
         **({"max_abs_err_alternating_rows": alternating["k1_fwd_err"]} if kind == "fwd" else {}),
         "launches_mesh": {**{name: [r[f"k1_{kind}"] for r in ranks]
                              for name, ranks in mesh["k1_launches"].items()},
                           "cli_nccl_1x1": mesh["k1_launches_nccl"][f"k1_{kind}"]},
         "max_abs_err_mesh_shards": mesh[f"k1_{kind}_err"],
         "launches_profiled_run": aux["launches"][f"k1_{kind}"],
         "launches_deep_e2e": deep_e2e["launches"][f"k1_{kind}"],
         "launches_traced_phase20": _traced_launches(graphs, f"k1_{kind}"),
         "max_abs_err_sweep_rows": sweep["k1"][f"{kind}_err"],
         "max_abs_err_v9206": pk[f"{kind}_err"],
         "launches_tasks": {tag: n[f"k1_{kind}"] for tag, n in tasks["launches"].items()},
         **{f"{key}_v9206_b{b}": val for b in pk["times"] for key, val in (
             ("ms", pk["times"][b][kind]), ("plain_ms", pk["times"][b][f"{kind}_plain"]),
             ("bound_ms", pk["bounds"][b][kind][0]), ("bound_by", pk["bounds"][b][kind][1]))},
         **{f"{key}_d{d}_b{b}": val for (d, b), x in k1["deep"].items() for key, val in (
             ("ms", x["times"][kind]), ("plain_ms", x["times"][f"{kind}_plain"]),
             ("bound_ms", x["bounds"][kind][0]), ("bound_by", x["bounds"][kind][1]))},
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
         "bound_by_b512": k2["bounds"][kind][512][1],
         "launches_sweep_fused": fused_sweep[kind]["launches"][f"k2_{kind}"],
         "launches_sweep_multihost": [r[f"k2_{kind}"] for r in mesh["sweep_launches"]],
         "launches_traced_phase20_adam_and_sgd": _traced_launches(graphs, "k2"),
         "ms_k32": k2["times"][kind]["k32"]["kernel"],
         "plain_ms_k32": k2["times"][kind]["k32"]["plain"],
         "ms_2d_x32": k2["times"][kind]["k32"]["sliced"],
         "bound_ms_k32": k2["bounds"][kind]["k32"][0],
         "bound_by_k32": k2["bounds"][kind]["k32"][1]}
        for kind, line in (("adam", 166), ("sgd", 210))
    ] + [
        {"name": f"token_dots-{kind}", "route": "cuda", "source": "mmtpu_torch/csrc/token_dots.cu",
         "replaces": "mmtpu/ops/wordprob.py:57 (no Pallas kernel: XLA fuses the gather)",
         "launches": e2e["launches"][f"tok_{kind}"], "max_abs_err": tok[f"{kind}_err"],
         "ms": tok["times"]["pom_train"][kind], "plain_ms": tok["times"]["pom_train"][f"{kind}_plain"],
         "bound_ms": tok["bounds"]["pom_train"][kind][0],
         "bound_by": tok["bounds"]["pom_train"][kind][1], "library_ms": None,
         **{f"{key}_{tag}": val for tag in TOKEN_SHAPES for key, val in (
             ("ms", tok["times"][tag][kind]), ("plain_ms", tok["times"][tag][f"{kind}_plain"]),
             ("bound_ms", tok["bounds"][tag][kind][0]), ("bound_by", tok["bounds"][tag][kind][1]))},
         "launches_non_e2e": non_e2e["launches"][f"tok_{kind}"],
         "launches_sweep_chunk": sweep["launches"][f"tok_{kind}"],
         "launches_tasks": {tag: n[f"tok_{kind}"] for tag, n in tasks["launches"].items()},
         "launches_task_pom_sweep": tasks["sweeps"]["sweep"]["launches"][f"tok_{kind}"],
         "launches_task_pom_chunk_k32": tasks["sweeps"]["wide_chunk"]["launches"][f"tok_{kind}"]}
        for kind in ("fwd", "bwd")
    ] + [
        {"name": "adam_apply", "route": "cuda", "source": "mmtpu_torch/csrc/adam.cu",
         "replaces": "mmtpu/train/optim.py:107 (no Pallas kernel: XLA fuses each leaf's update)",
         "launches": sweep["launches"]["adam_tree"], "max_abs_err": 0.0,
         "ms": adam["times"]["mosi_decoder"]["kernel"],
         "plain_ms": adam["times"]["mosi_decoder"]["plain"],
         "bound_ms": adam["bounds"]["mosi_decoder"][0],
         "bound_by": adam["bounds"]["mosi_decoder"][1], "library_ms": None,
         **{f"{key}_{tag}": val for tag in adam["times"] for key, val in (
             ("floats", adam["floats"][tag]), ("ms", adam["times"][tag]["kernel"]),
             ("plain_ms", adam["times"][tag]["plain"]), ("bound_ms", adam["bounds"][tag][0]))},
         "launches_touch_sweep_chunk": sweep["launches"]["adam_touch"],
         "launches_fused_lazy_e2e": [lazy["launches"]["fused_lazy_adam"][f"adam_{n}"]
                                     for n in ("tree", "touch")],
         "launches_task_pom_sweep": [tasks["sweeps"]["sweep"]["launches"][f"adam_{n}"]
                                     for n in ("tree", "touch")]}
    ], "launches_by_path": by_path,
        "paths": {"non_e2e": {k: non_e2e[k] for k in ("wall_s", "train_utt_s", "final_loss")},
                  "e2e": {k: e2e[k] for k in ("wall_s", "train_utt_s", "final_loss")},
                  "fused": {k: {m: v[m] for m in ("loss_rel", "utt_s_dense", "utt_s_fused")}
                            for k, v in fused.items()},
                  "lazy": {k: v for k, v in lazy.items() if k != "launches"},
                  "curve_and_resume": {k: v for k, v in resume.items() if k != "launches"},
                  "sweep_chunk": {k: v for k, v in sweep.items()
                                  if k not in ("launches", "k1", "result")},
                  "sweep_fused": {k: {m: x for m, x in v.items() if m != "launches"}
                                  for k, v in fused_sweep.items()},
                  "sweep_cli": {k: v for k, v in cli_sweep.items()
                                if not k.startswith("launches")},
                  "serving": {k: v for k, v in serving.items() if k != "launches"},
                  "sweep_warm_chunk": {k: v for k, v in warm.items() if k != "launches"},
                  "alternating": {k: v for k, v in alternating.items() if k != "launches"},
                  "numeric_ops": ops,
                  "mesh": {k: mesh[k] for k in ("diffs", "vocab_checks", "seconds",
                                                "finite_sweep_configs")},
                  "aux": {k: aux[k] for k in ("trace_kernels", "trace_k1", "wall_s")},
                  "deep_e2e": {k: v for k, v in deep_e2e.items() if k != "launches"},
                  "tasks": {k: v for k, v in tasks.items() if k not in ("k1", "launches")},
                  "graphs": graphs},
        "card": smi}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
