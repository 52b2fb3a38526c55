"""CLI of the port — flag-compatible with ``python -m mmtpu.run``.

Usage::

    python -m mmtpu_torch.run <config.json> {mosi,pom,iemocap} [--e2e {y,n}]
        [--device cuda] [--unimodal] [--pos_embed_dim N] [--batch_size N]
        [--n_runs N] [--semi_sup_idxes 0.1..0.9] [--config_name NAME]
        [--lr_decay F] [--early_stopping] [--sentiment_epochs N]
        [--emotion E] [--optimizer {sgd,adam}] [--norm {layer_norm,batch_norm}]
        [--likelihood_weight F] [--data_dir DIR] [--out_root DIR] [--parity]
        [--seed N] [--no_artifacts] [--lazy_adam] [--validation_curve]
        [--resume_dir DIR] [--time_test] [--mesh [AXES]]
        [--profile [DIR]]

    torchrun --nproc_per_node N -m mmtpu_torch.run <config.json> mosi --mesh data,vocab

``--device`` (default ``cuda``) picks the device; asking for CUDA where
there is none raises, nothing falls back to the CPU.  Accepted for
compatibility and without effect: ``--cuda``/``--cuda_device`` (use
``--device``), ``--pallas`` (the angular partition always runs through the
port's own kernel wrapper: the CUDA kernel on a CUDA device) and
``--precision`` (the port computes in float32 and leaves TF32 at PyTorch's
default, off for matmuls).  ``--e2e`` (or the config's ``e2e`` key, true
in every grid config) picks the joint fit or the likelihood-only one.
``--lazy_adam`` runs an Adam config's fits with epoch-level lazy Adam;
``--validation_curve`` writes the recursive validation curve (a refit of the
valid split every 80 epochs and after the last) as ``embed_valid_loss``;
``--resume_dir DIR`` checkpoints the non-e2e training fit in epoch segments
under ``DIR`` (``DIR_run<r>`` for each run when ``n_runs > 1``) and resumes
from it.  ``--time_test`` times the closed-form estimate of the test split
from the trained decoder and prints ``time taken:``.

``--mesh AXES`` (``data``, ``vocab``, ``data,vocab`` or sizes such as
``data=2,vocab=2``; default ``data,vocab``) spans the run over the ranks of
a ``torch.distributed`` world, one process per rank: ``torchrun``'s world
where its environment is set, else a world of this one process (its
collectives still run).  A rank's device is ``cuda:LOCAL_RANK`` for
``--device cuda`` and its backend NCCL (gloo for the CPU).  The first rank
alone writes the artifacts and prints.  ``--profile DIR`` runs under
``torch.profiler`` and writes a Chrome trace into ``DIR``
(:func:`mmtpu_torch.utils.profiling.trace`).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mmtpu_torch.config import ExperimentConfig


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="mmtpu_torch.run", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config_file", help="JSON config (reference format)")
    parser.add_argument("dataset", choices=["mosi", "pom", "iemocap"])
    parser.add_argument("--unimodal", action="store_true", help="run MMB1")
    parser.add_argument("--pos_embed_dim", type=int)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--n_runs", type=int, default=None)
    parser.add_argument("--semi_sup_idxes",
                        choices=["{:.1f}".format(x) for x in np.arange(0.1, 1, 0.1)])
    parser.add_argument("--config_name")
    parser.add_argument("--lr_decay", type=float, default=None)
    parser.add_argument("--early_stopping", action="store_true")
    parser.add_argument("--sentiment_epochs", type=int)
    parser.add_argument("--emotion", choices=["happy", "angry", "neutral", "sad"])
    parser.add_argument("--optimizer", choices=["sgd", "adam"])
    parser.add_argument("--norm", choices=["layer_norm", "batch_norm"])
    parser.add_argument("--likelihood_weight", type=float)
    parser.add_argument("--e2e", choices=["y", "n"])
    parser.add_argument("--time_test", action="store_true")
    parser.add_argument("--cuda", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--cuda_device", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--data_dir", default=".")
    parser.add_argument("--out_root", default="model_saves")
    parser.add_argument("--parity", action="store_true",
                        help="reproduce reference quirks (pos-embed bug, raw Gaussian streams)")
    parser.add_argument("--validation_curve", action="store_true")
    parser.add_argument("--precision", choices=["default", "highest"], help=argparse.SUPPRESS)
    parser.add_argument("--pallas", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--mesh", metavar="AXES", nargs="?", const="data,vocab")
    parser.add_argument("--lazy_adam", action="store_true")
    parser.add_argument("--resume_dir", metavar="DIR")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_artifacts", action="store_true")
    parser.add_argument("--profile", metavar="DIR", nargs="?", const="mmtpu_torch_trace")
    return parser.parse_args(argv)


def _parse_mesh(spec: str):
    """'data' | 'vocab' | 'data,vocab' | 'data=4,vocab=2' -> a
    :func:`mmtpu_torch.parallel.fit.make_fit_mesh` ("data", "vocab") mesh
    over the world's ranks (mmtpu's ``run.py:95-116``, over ranks in place
    of devices)."""
    import torch.distributed as dist

    from mmtpu_torch.parallel.fit import make_fit_mesh

    sizes = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        if name not in ("data", "vocab"):
            raise ValueError(f"unknown mesh axis {name!r} (want data/vocab)")
        sizes[name] = int(val) if val else None
    n = dist.get_world_size()
    n_b, n_v = sizes.get("data", 1), sizes.get("vocab", 1)
    if "data" in sizes and "vocab" in sizes and n_b is None and n_v is None:
        n_v = 2 if n % 2 == 0 and n > 1 else 1  # default split
        n_b = n // n_v
    return make_fit_mesh(n_b, n_v)


def main(argv=None) -> int:
    args = parse_args(argv)
    import contextlib

    import torch
    import torch.distributed as dist

    from mmtpu_torch.runner import prepare, run_experiment
    from mmtpu_torch.utils.profiling import trace

    mesh, own_world = None, False
    if args.mesh:
        from mmtpu_torch.parallel.mesh import init_world

        own_world = not dist.is_initialized()
        device = init_world(args.device)
        mesh = _parse_mesh(args.mesh)
    else:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch.cuda.is_available() is False")
    say = print if mesh is None or mesh.is_main else (lambda *a, **k: None)

    overrides = dict(
        dataset=args.dataset,
        unimodal=args.unimodal or None,
        pos_embed_dim=args.pos_embed_dim,
        batch_size=args.batch_size,
        n_runs=args.n_runs,
        semi_sup_idxes=args.semi_sup_idxes,
        config_name=args.config_name,
        lr_decay=args.lr_decay,
        early_stopping=args.early_stopping or None,
        sentiment_epochs=args.sentiment_epochs,
        emotion=args.emotion,
        optimizer=args.optimizer,
        norm=args.norm,
        likelihood_weight=args.likelihood_weight,
        e2e=args.e2e,
        parity=args.parity or None,
        seed=args.seed,
        use_pallas=args.pallas or None,
    )
    try:
        cfg = ExperimentConfig.from_json(args.config_file, **overrides)
        say("######################################")
        say(f"Config: {cfg.config_num}")
        say(json.dumps(cfg.to_dict(), indent=2))

        prep = prepare(cfg, args.data_dir)
        if prep.synthetic:
            say("[mmtpu_torch] real data blobs not found — using synthetic stand-ins")
        if mesh is not None:
            say(f"[mmtpu_torch] mesh {mesh.axis_sizes} over {mesh.ranks.size} rank(s), "
                f"backend {dist.get_backend()}")
        with trace(args.profile) if args.profile else contextlib.nullcontext():
            for r in range(cfg.n_runs):
                res = run_experiment(
                    cfg,
                    data_dir=args.data_dir,
                    out_root=args.out_root,
                    prep=prep,
                    run_idx=r,
                    save_artifacts=not args.no_artifacts,
                    time_test=args.time_test,
                    validation_curve=args.validation_curve,
                    mesh=mesh,
                    resume_dir=(f"{args.resume_dir}_run{r}" if args.resume_dir
                                and cfg.n_runs > 1 else args.resume_dir),
                    lazy_adam=args.lazy_adam,
                    device=device,
                )
                say(f"run {r}: train_time={res['train_time_s']:.2f}s "
                    f"final_loss={res['final_train_loss']:.3f}")
        if args.profile:
            say(f"[mmtpu_torch] profiler trace written to {args.profile}")
    finally:
        if own_world:  # the group this call started ends with it
            dist.destroy_process_group()
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
