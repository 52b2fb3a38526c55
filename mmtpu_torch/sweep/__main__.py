"""Sweep CLI of the port — flag-compatible with ``python -m mmtpu.sweep``.

Runs the hyperparameter grid in-process, K configs per chunk::

    python -m mmtpu_torch.sweep mosi                      # full 512-config grid
    python -m mmtpu_torch.sweep mosi --configs_dir configs/multimodal_search
    python -m mmtpu_torch.sweep mosi --limit 100 --chunk_size 32
    python -m mmtpu_torch.sweep mosi --resume_dir sweep_ckpt   # crash-resumable
    python -m mmtpu_torch.sweep mosi --device cpu --limit 4    # on the CPU
    torchrun --nproc_per_node 4 -m mmtpu_torch.sweep mosi --multihost  # a shard per card
    torchrun --nproc_per_node 4 -m mmtpu_torch.sweep mosi --mesh  # each chunk over 4 cards

Writes ``results/<name>.csv`` (the columns of mmtpu's: each record of
:meth:`mmtpu_torch.sweep.runner.SweepResult.to_records` plus the config's
grid columns) and ``results/<name>_summary.json`` (mmtpu's keys).

``--device`` defaults to ``cuda``; asking for CUDA where there is none
raises, nothing falls back to the CPU.  One process runs per rank of a
``torch.distributed`` world (``torchrun``'s environment; a rank's device is
``cuda:LOCAL_RANK`` for ``--device cuda``, its backend NCCL for CUDA and
gloo for the CPU).  ``--multihost`` gives each process the strided shard
``configs[p::P]`` of the grid and gathers the results once at the end
(:func:`mmtpu_torch.parallel.multihost.run_sweep_multihost`); without
torchrun's environment it is one process.  ``--mesh`` shards each chunk's
configs over the world's ranks (a world of this one process without
torchrun's environment); under ``--multihost`` each process already sweeps
its shard on its own card, so ``--mesh`` adds nothing there.  Rank 0 alone
writes the results.
``--pallas``, ``--no_pallas`` and ``--unroll`` are refused: on the card the
angular partition always runs in the port's own kernel (K1), and the port's
fits run no scan to unroll.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
import time

# the grid's columns that the CSV carries beside each record (as mmtpu's)
CONFIG_COLUMNS = ("lr", "sentiment_lr", "n_epochs", "optimizer", "norm", "pos_embed_dim",
                  "sentiment_hidden_size", "word_loss_weight", "likelihood_weight")

_REFUSED = {
    "pallas": "--pallas has no counterpart: on the card the angular partition always runs "
              "in the port's kernel K1",
    "no_pallas": "--no_pallas has no counterpart: on the card the angular partition always "
                 "runs in the port's kernel K1 (--device cpu runs its plain version)",
    "unroll": "--unroll has no counterpart: the port's fits are host loops, not scans",
}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="mmtpu_torch.sweep", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset", choices=["mosi", "pom", "iemocap"])
    parser.add_argument("--configs_dir",
                        help="directory of config_<i>.json files; default: generate the "
                             "reference grid in memory")
    parser.add_argument("--limit", type=int, help="run only the first N configs")
    parser.add_argument("--chunk_size", type=int,
                        help="configs per chunk (default min(N, 32))")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--unimodal", action="store_true")
    parser.add_argument("--emotion", choices=["happy", "angry", "neutral", "sad"])
    parser.add_argument("--data_dir", default=".")
    parser.add_argument("--name", default="sweep")
    parser.add_argument("--out", default="results")
    parser.add_argument("--resume_dir", help="chunk checkpoint dir (resume here)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--mesh", action="store_true",
                        help="shard each chunk's configs over the world's ranks")
    parser.add_argument("--multihost", action="store_true",
                        help="each process of torchrun's world sweeps the shard configs[p::P]; "
                             "one gather at the end")
    parser.add_argument("--pallas", action="store_true", help="refused: " + _REFUSED["pallas"])
    parser.add_argument("--no_pallas", action="store_true",
                        help="refused: " + _REFUSED["no_pallas"])
    parser.add_argument("--unroll", type=int, help="refused: " + _REFUSED["unroll"])
    parser.add_argument("--fused_dec", action="store_true",
                        help="the train fit's decoder-weight updates in kernel K2")
    parser.add_argument("--exact_adam", action="store_true",
                        help="dense Adam instead of the epoch-level lazy-Adam default")
    parser.add_argument("--phase_timing", action="store_true",
                        help="record each chunk's phase seconds in the summary's chunk stats")
    parser.add_argument("--infer_clamp", action="store_true",
                        help="shrink single-batch inference fits' batch to the split's rows "
                             "(float-order deltas only)")
    parser.add_argument("--no_infer_clamp", action="store_true",
                        help="keep the reference's batch_size*8 for single-batch inference "
                             "fits (the default)")
    parser.add_argument("--infer_warm_start", action="store_true",
                        help="start valid/test inference fits from the trained decoder's "
                             "closed-form latent estimate in place of the SIF embedding; "
                             "not reference parity")
    parser.add_argument("--infer_epochs", type=int, default=0,
                        help="cap inference-fit epochs (0 = the config's n_epochs, the "
                             "reference's semantics); not reference parity")
    parser.add_argument("--top_k_artifacts", type=int, default=0,
                        help="after the sweep, rerun the top-K configs through the full "
                             "runner to persist reference-layout artifacts")
    parser.add_argument("--n_runs", type=int, default=1,
                        help="repetitions per config with independent seeds")
    parser.add_argument("--validation_curve", action="store_true",
                        help="per-config recursive validation curves (cadence 80 epochs)")
    parser.add_argument("--semi_sup_idxes", choices=["0.%d" % i for i in range(1, 10)],
                        help="semi-supervised labeled fraction: e2e joint losses mask "
                             "unlabeled rows; the sentiment phase trains on the subset")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    for flag, msg in _REFUSED.items():
        if getattr(args, flag) not in (False, None):
            parser.error(msg)
    return args


def _load_configs(args) -> list:
    from mmtpu_torch.config import make_grid

    if args.configs_dir:
        configs = []
        for path in sorted(glob.glob(os.path.join(args.configs_dir, "config_*.json"))):
            with open(path) as f:
                configs.append(json.load(f))
        configs.sort(key=lambda c: c.get("config_num", 0))
    else:
        configs = make_grid()
    return configs[:args.limit] if args.limit else configs


def _write_results(args, res, configs) -> tuple:
    """The CSV of records with their config columns, and the summary JSON."""
    os.makedirs(args.out, exist_ok=True)
    records = res.to_records()
    cfg_by_num = {c.get("config_num", i): c for i, c in enumerate(configs)}
    for rec in records:
        cfg = cfg_by_num.get(rec["config_num"], {})
        rec.update({k: cfg[k] for k in CONFIG_COLUMNS if k in cfg})
    csv_path = os.path.join(args.out, f"{args.name}.csv")
    keys = sorted({k for r in records for k in r}, key=str)
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in records:
            w.writerow({k: (json.dumps(v) if isinstance(v, list) else v) for k, v in r.items()})
    summary = {
        "n_configs": res.n_configs,
        "wall_time_s": round(res.wall_time_s, 2),
        "compile_time_s": round(res.compile_time_s, 2),
        "exec_time_s": round(res.exec_time_s, 2),
        "configs_per_hour": round(res.n_configs / res.wall_time_s * 3600, 1),
        "configs_per_hour_exec": round(res.n_configs / max(res.exec_time_s, 1e-9) * 3600, 1),
        "dataset": args.dataset,
        "chunks": res.chunk_stats or [],
    }
    with open(os.path.join(args.out, f"{args.name}_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[sweep] done: {summary}")
    print(f"[sweep] wrote {csv_path}")
    return records, summary


def _persist_top_k(args, records, configs, device) -> None:
    """Rerun the best ``--top_k_artifacts`` configs through the full runner
    (reference-layout artifacts), on the optimizer path that selected them."""
    from mmtpu_torch.config import ExperimentConfig
    from mmtpu_torch.runner import run_experiment

    key, reverse = {"mosi": ("mae", False), "iemocap": ("accuracy", True)}.get(
        args.dataset, ("corr", True))  # pom: mean per-trait correlation

    def score(rec):
        v = rec.get(key)
        if isinstance(v, list):
            v = sum(v) / len(v)
        if v is None or v != v:  # NaN ranks last
            return float("-inf") if reverse else float("inf")
        return v

    top = sorted(records, key=score, reverse=reverse)[:args.top_k_artifacts]
    print(f"[sweep] persisting artifacts for top-{len(top)} configs by {key}")
    cfg_by_num = {c.get("config_num", i): c for i, c in enumerate(configs)}
    for rec in top:
        raw = dict(cfg_by_num[rec["config_num"]])
        raw.pop("_run_idx", None)
        cfg = ExperimentConfig.from_dict(
            raw, dataset=args.dataset, batch_size=args.batch_size,
            unimodal=args.unimodal or None, emotion=args.emotion, config_name=args.name,
            seed=args.seed, semi_sup_idxes=args.semi_sup_idxes or None)
        run_experiment(cfg, data_dir=args.data_dir, run_idx=rec["run"], verbose=False,
                       lazy_adam=not args.exact_adam, device=device)
        print(f"[sweep]   config {rec['config_num']} run {rec['run']} saved")


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch.distributed as dist

    configs = _load_configs(args)
    if not configs:
        print("no configs found", file=sys.stderr)
        return 1
    own_world = (args.mesh or args.multihost) and not dist.is_initialized()
    try:
        return _sweep(args, configs)
    finally:
        if own_world and dist.is_initialized():  # the group this call started ends with it
            dist.destroy_process_group()


def _sweep(args, configs) -> int:
    import torch.distributed as dist

    from mmtpu_torch.data.pipeline import prepare_device_data
    from mmtpu_torch.data.registry import load_dataset
    from mmtpu_torch.parallel.mesh import init_world, make_mesh, rank_device
    from mmtpu_torch.parallel.multihost import init_multihost, run_sweep_multihost
    from mmtpu_torch.sweep.runner import run_sweep

    device, mesh = args.device, None
    if args.multihost:
        device = rank_device(args.device)
        init_multihost(device)
        if args.mesh:
            print("[sweep] --multihost: each process sweeps its shard on its own card; "
                  "--mesh adds nothing")
    elif args.mesh:
        device = init_world(args.device)
        mesh = make_mesh()
        print(f"[sweep] mesh over {mesh.ranks.size} rank(s)")
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    pos_dims = tuple(sorted({c.get("pos_embed_dim", 0) for c in configs} - {0}))
    t0 = time.time()
    ds = load_dataset(args.dataset, data_dir=args.data_dir, emotion=args.emotion)
    if ds.get("synthetic"):
        print("[mmtpu_torch] real data blobs not found — using synthetic stand-ins")
    prep = prepare_device_data(ds, pos_mode="shared" if pos_dims else "baked",
                               pos_dims=pos_dims or None)
    print(f"[sweep] {len(configs)} configs on {args.dataset} (prep {time.time() - t0:.1f}s)")

    mask = None
    if args.semi_sup_idxes:
        from mmtpu_torch.runner import semi_sup_mask

        mask = semi_sup_mask(args.dataset, args.semi_sup_idxes, prep.labels["train"].shape[0],
                             seed=args.seed, data_dir=args.data_dir)
        print(f"[sweep] semi-supervised: {int(mask.sum())} labeled rows")

    sweep_kw = dict(batch_size=args.batch_size, unimodal=args.unimodal, seed=args.seed,
                    chunk_size=args.chunk_size, checkpoint_dir=args.resume_dir,
                    senti_mask=mask, validation_curve=args.validation_curve,
                    lazy_adam=False if args.exact_adam else None,
                    infer_batch_clamp=args.infer_clamp and not args.no_infer_clamp,
                    phase_timing=args.phase_timing, fused_dec_update=args.fused_dec,
                    infer_warm_start=args.infer_warm_start,
                    infer_epochs_cap=args.infer_epochs, device=device)
    if args.multihost:
        res = run_sweep_multihost(configs, prep, n_runs=args.n_runs, **sweep_kw)
    else:
        res = run_sweep(configs, prep, n_runs=args.n_runs, mesh=mesh, verbose=main_rank,
                        **sweep_kw)
    if not main_rank:
        return 0  # rank 0 writes the CSV, the summary and the artifacts
    records, _ = _write_results(args, res, configs)
    if args.top_k_artifacts > 0:
        _persist_top_k(args, records, configs, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
