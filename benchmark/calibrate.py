"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, on the card at the cell's own size (the benchmark's runs do not run
this):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control] \
        [--faults F,..] [--fault-seeds N]

For each seed, in one process: the set-up and the window's first call, as a
run makes them, then the compared numbers of

- ``sound``: the program against the float32 reference (the lower reading
  is the largest over a dozen seeds or more);
- ``control`` (``--control``): the reference computed with TF32 matmuls,
  put in the program's place, against the float32 reference;
- each fault of ``--faults`` (:data:`FAULTS`), planted in the program for
  that seed's call, on the first ``--fault-seeds`` seeds (all by default):
  ``stale`` (the fits' optimizer steps return their state unchanged),
  ``late`` (the joint fit's state stops after its first two epochs),
  ``half_batch`` (each joint-fit step's loss is the mean over the first
  half of its rows) and ``answer`` (one test prediction altered by 0.01
  where the scoring produces it).

One JSON line per seed and reading on standard output: the compared
numbers, the picked configs, and the joint fits' last losses (the
program's; the reference's first and last), for a look at a number.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def stale():
    """Every optimizer step of the fits returns its state unchanged (the
    sentiment fit's SGD steps by zero gradients)."""
    import mmtpu_torch.train.e2e as e2e
    import mmtpu_torch.train.latents as latents
    import mmtpu_torch.train.sentiment as sentiment

    def update(orig):
        return lambda params, grads, state, *a, **k: (params, state)

    def touch(orig):
        return lambda p_s, m_s, v_s, *a, **k: (p_s, m_s, v_s)

    def no_grads(orig):  # the sentiment fit's gradients, which only its step reads
        return lambda like, leaves: orig(like, [g * 0.0 for g in leaves])

    with _patched(e2e, "opt_update", update), _patched(latents, "opt_update", update), \
            _patched(latents, "lazy_adam_touch", touch), \
            _patched(sentiment, "tree_unflatten", no_grads):
        yield


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a named tuple
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


class _Frozen:
    """A fit's epoch runner whose joint-fit epochs after the first ``after``
    each run from the state those left and hand it on unchanged (their
    losses are computed; their steps are thrown away)."""

    def __init__(self, run, after: int):
        self.run, self.after, self.n, self.kept = run, after, 0, None

    def __call__(self, key, body, state, *args, **kw):
        if key[0] != "e2e_epoch":
            return self.run(key, body, state, *args, **kw)
        self.n += 1
        if self.n <= self.after:
            out, loss = self.run(key, body, state, *args, **kw)
            if self.n == self.after:
                self.kept = _clone(out)
            return out, loss
        return self.kept, self.run(key, body, self.kept, *args, **kw)[1]


@contextlib.contextmanager
def late():
    """The joint fit's state stops after its first two epochs: a fault that
    the compared first epochs do not see."""
    import mmtpu_torch.train.e2e as e2e

    def make(orig):
        return lambda *a, **k: _Frozen(orig(*a, **k), after=2)

    with _patched(e2e, "fit_graphs", make):
        yield


def _half(orig):
    """Per-sample values with the second half of the rows replaced by the
    first half's mean: the batch mean is the first half's, and so are the
    gradients."""
    import torch

    def fn(*a, **k):
        per = orig(*a, **k)
        h = per.shape[-1] // 2
        first = per[..., :h]
        rest = first.mean(-1, keepdim=True).expand(*first.shape[:-1], per.shape[-1] - h)
        return torch.cat([first, rest], -1)
    return fn


@contextlib.contextmanager
def half_batch():
    """Each joint-fit step leaves out half of its batch."""
    import mmtpu_torch.train.e2e as e2e

    with _patched(e2e, "joint_neg_log_prob_per_sample", _half), _patched(e2e, "senti_l1", _half):
        yield


@contextlib.contextmanager
def answer():
    """The scoring's first test prediction of every config is 0.01 off."""
    import mmtpu_torch.sweep.runner as runner

    def make(orig):
        def fn(params, x):
            pred = orig(params, x).clone()
            first = pred[..., 0] if pred.ndim < x.ndim else pred[..., 0, 0]
            first += 0.01
            return pred
        return fn

    with _patched(runner, "apply_sentiment", make):
        yield


FAULTS = {"stale": stale, "late": late, "half_batch": half_batch, "answer": answer}


def as_answers(ref: dict, prog: dict) -> dict:
    """The reference's outputs in the form of the program's answers (the
    control put in the program's place), on ``prog``'s picks."""
    out = dict(prog)
    n = len(prog["configs"])
    out["losses"] = list(ref["losses"])
    out["train"] = list(ref["latents"])
    out["decoder"] = [{k: v[i:i + 1] for k, v in ref["decoder"].items()} for i in range(n)]
    out["valid"], out["test"] = list(ref["valid"]), list(ref["test"])
    out["senti_losses"] = list(ref["senti_losses"])
    out["pred"] = list(ref["pred"])
    out["metrics"] = [{k: v[i] for k, v in ref["metrics"].items()} for i in range(n)]
    out["diverged"] = [not bool(ref["losses"][i, -1].isfinite()) for i in range(n)]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", type=int, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import compare
    from benchmark.run import cell_spec, load_module

    spec = cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    driver_mod = load_module(spec["driver"], "benchmark_driver")
    epochs = spec["traffic"]["check_epochs"]
    faults = [f for f in args.faults.split(",") if f]
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        driver = driver_mod.Driver(spec["config"], spec["traffic"], seed, "cuda")
        driver.setup()
        runs = {"sound": contextlib.nullcontext}
        if args.fault_seeds is None or n < args.fault_seeds:
            runs.update({f: FAULTS[f] for f in faults})
        for name, ctx in runs.items():
            with ctx():
                window = driver.window(0.0)
            prog = driver.answers(window)
            window = None
            gc.collect()
            torch.cuda.empty_cache()
            ref = driver.reference(prog)
            line = {"seed": seed, "reading": name,
                    "numbers": compare.numbers(prog, ref, epochs),
                    "losses": {"program_last": [float(x[-1]) for x in prog["losses"]],
                               "reference_first": ref["losses"][:, 0].tolist(),
                               "reference_last": ref["losses"][:, -1].tolist(),
                               "diverged": prog["diverged"]},
                    "configs": [{k: c[k] for k in ("norm", "lr", "likelihood_weight",
                                                   "word_loss_weight", "pos_embed_dim")}
                                for c in prog["configs"]]}
            print(json.dumps(line), flush=True)
            if name == "sound" and args.control:
                ctl = as_answers(driver.reference(prog, tf32=True), prog)
                print(json.dumps({"seed": seed, "reading": "control",
                                  "numbers": compare.numbers(ctl, ref, epochs)}), flush=True)
        driver.release()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
