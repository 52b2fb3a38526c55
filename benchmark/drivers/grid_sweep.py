"""Driver of the grid traffic: back-to-back ``run_sweep`` calls, each over
one slice of a bucket of the reference grid, as ``python -m
mmtpu_torch.sweep`` runs the grid (chunk width, lazy Adam and the other
options at the CLI's defaults).

Traffic parameters (``benchmark/traffic/<name>.json``): ``grid_shuffle_seed``,
``optimizer`` and ``n_epochs`` (the bucket), ``configs_per_call``,
``chunk_size``, ``check_configs`` (the configs of the window's first call
whose answers the reference checks), ``check_epochs`` (the epochs of the
joint and sentiment fits compared from their start), ``piece_epochs`` (the
traced piece's train, inference and sentiment epochs, at the chunk width).

The window's calls run as a user's do (no ``phase_timing``, which makes
each chunk wait for the one before); the traced run times the phases in
one more call after the window.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops, generate
from benchmark.trace import span


# the draws' call keys of the set-up's call, the traced piece and the traced
# run's phase-timed call, apart from the window's calls 0, 1, ...
WARMUP_CALL, PIECE_CALL, PHASE_CALL = 1 << 40, (1 << 40) + 1, (1 << 40) + 2


@dataclasses.dataclass
class Call:
    """One call of the window: its configs, result and seconds, and on a
    card the allocator's reserved peak from the call's start (its reserve
    at the start included) and its reserved and allocated bytes at the
    end."""

    index: int
    configs: List[dict]
    result: object
    wall_s: float
    peak_reserved: int = 0
    reserved_after: int = 0
    allocated_after: int = 0


def _host(tree):
    """``tree``'s tensors (in dicts and lists) on the host."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return tree.detach().cpu()


def _take(tree, idx):
    """``tree``'s tensors at configs ``idx`` of their leading axis."""
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return tree.index_select(0, idx)


class _Recorder:
    """Wraps ``build_sweep_parts`` for one call: for the picked configs of
    each chunk (``picks[chunk]``, positions in the chunk), it keeps what each
    phase hands on: the train phase's epoch losses, trained decoder and
    latents, the inference phases' latents, the sentiment phase's epoch
    losses and last parameters and the scoring's predictions and metrics.
    Each is gathered on the device as the phase returns (queued on the
    stream, no wait)."""

    def __init__(self, build, picks: Dict[int, list], device):
        self.build, self.chunk, self.kept = build, 0, {}
        self.picks = {c: torch.as_tensor(p, device=device) for c, p in picks.items()}

    def __call__(self, *args, **kwargs):
        import mmtpu_torch.sweep.runner as runner

        parts = self.build(*args, **kwargs)
        chunk, self.chunk = self.chunk, self.chunk + 1
        if chunk not in self.picks:
            return parts
        idx, kept = self.picks[chunk], self.kept.setdefault(chunk, {})

        def train(*a, **k):
            out = parts["train"](*a, **k)
            kept.update(losses=_take(out[2], idx), decoder=_take(out[1], idx),
                        train=_take(out[0], idx))
            return out

        def infer(*a, **k):
            out = parts["infer"](*a, **k)
            kept.setdefault("infer", []).append(_take(out, idx))
            return out

        def sent(*a, **k):
            inner = runner.fit_sentiment

            def fit(*fa, **fk):  # the fit's epoch losses, which the phase drops
                res = inner(*fa, **fk)
                kept["senti_losses"] = _take(res[2], idx)
                return res
            runner.fit_sentiment = fit
            try:
                out = parts["sent"](*a, **k)
            finally:
                runner.fit_sentiment = inner
            kept["senti"] = _take(out, idx)
            return out

        def score(*a, **k):
            metrics, pred = parts["score"](*a, **k)
            kept.update(pred=_take(pred, idx), metrics=_take(metrics, idx))
            return metrics, pred

        return {"train": train, "infer": infer, "sent": sent, "score": score}

    def host(self) -> Dict[int, dict]:
        return _host(self.kept)


def _spanned_parts(build):
    """``build_sweep_parts`` with each phase inside a harness span."""
    def wrapped(*args, **kwargs):
        parts = build(*args, **kwargs)

        def spanned(name, fn):
            def call(*a, **k):
                with span(f"sweep.{name}"):
                    return fn(*a, **k)
            return call
        return {name: spanned(name, fn) for name, fn in parts.items()}
    return wrapped


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.pos_dims = tuple(sorted({c["pos_embed_dim"] for c in generate.bucket(traffic)}))

    def setup(self) -> None:
        """The data and its preparation by the program, then one short eager
        call of the cell's own shapes (one epoch of each fit): the
        allocator, cuBLAS and the kernel library warm."""
        from mmtpu_torch.data.pipeline import prepare_device_data

        self.dataset = generate.dataset_for(self.config, self.seed)
        self.prep = prepare_device_data(self.dataset, pos_mode="shared",
                                        pos_dims=self.pos_dims)
        warm = [dict(c, n_epochs=1, n_sentiment_epochs=1)
                for c in generate.call_configs(self.traffic, 0)[:self.traffic["chunk_size"]]]
        self._sweep(warm, call=WARMUP_CALL)

    def _sweep(self, configs, call: int, **kw):
        from mmtpu_torch.sweep.runner import run_sweep

        return run_sweep(configs, self.prep, batch_size=self.config["batch_size"],
                         seed=self.seed, chunk_size=self.traffic["chunk_size"], verbose=False,
                         device=self.device,
                         draws=lambda num, run: generate.Draws(self.seed, call, num), **kw)

    def call(self, index: int) -> Call:
        configs = generate.call_configs(self.traffic, index)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        res = self._sweep(configs, index)
        out = Call(index, configs, res, time.perf_counter() - t0)
        if cuda:  # run_sweep has read every result back: no work is queued
            out.peak_reserved = torch.cuda.max_memory_reserved(self.device)
            out.reserved_after = torch.cuda.memory_reserved(self.device)
            out.allocated_after = torch.cuda.memory_allocated(self.device)
        return out

    def picks(self) -> list:
        """The positions in the window's first call of the configs whose
        answers the reference checks: ``check_configs`` of them, drawn from
        the seed."""
        rng = random.Random(generate._seed(self.seed, 7))
        return sorted(rng.sample(range(self.traffic["configs_per_call"]),
                                 self.traffic["check_configs"]))

    def window(self, seconds: float) -> Dict:
        """Calls until ``seconds`` have passed, the one in flight finished;
        the first call records what its phases hand on at the picks."""
        import mmtpu_torch.sweep.runner as runner

        k = self.traffic["chunk_size"]
        picks = {}
        for p in self.picks():
            picks.setdefault(p // k, []).append(p % k)
        recorder = _Recorder(runner.build_sweep_parts, picks, self.device)
        calls, t0 = [], time.perf_counter()
        runner.build_sweep_parts = recorder
        try:
            calls.append(self.call(0))
        finally:
            runner.build_sweep_parts = recorder.build
        while time.perf_counter() - t0 < seconds:
            calls.append(self.call(len(calls)))
        return {"calls": calls, "window_s": time.perf_counter() - t0,
                "recorded": recorder.host()}

    def attempted(self, window: Dict) -> int:
        return sum(len(c.configs) for c in window["calls"])

    def end_to_end(self, window: Dict) -> Dict[str, float]:
        """Every config of the window's calls over the window's hours."""
        return {"sweep_configs_per_h": self.attempted(window) / window["window_s"] * 3600.0}

    # -- the traced run --------------------------------------------------

    def tokens(self) -> Dict[str, list]:
        """Each row's valid tokens of the word term, per split."""
        key = "text" if self.dataset["name"] == "mosi" else "text_id"
        return {s: list((np.asarray(a[key]) != 0).sum(-1).tolist())
                for s, a in self.dataset["splits"].items()}

    def piece(self):
        """The traced piece's configs: one chunk of the cell's width, its
        epochs cut to ``piece_epochs`` (so that each fit is still
        captured)."""
        e = self.traffic["piece_epochs"]
        return [dict(c, n_epochs=e, n_sentiment_epochs=e)
                for c in generate.call_configs(self.traffic, 0)[:self.traffic["chunk_size"]]]

    def traced(self, window: Dict) -> Dict:
        """What the per-layer readers read: the window's calls, the window's
        matmul FLOPs, one more call of the window's first call's configs with
        ``phase_timing`` (the phases' seconds), and the piece run unprofiled
        and then profiled, inside the harness's spans of the chunk's
        phases."""
        import mmtpu_torch.sweep.runner as runner
        from mmtpu_torch.kernels.angular import LAUNCHES

        from benchmark import trace

        geometry = dict(self.config["geometry"], n_out=self.config["n_out"])
        toks = self.tokens()
        total = sum(flops.config_flops(c, geometry, toks)
                    for call in window["calls"] for c in call.configs)
        timed = self._sweep(window["calls"][0].configs, call=PHASE_CALL, phase_timing=True)
        piece = self.piece()
        build = runner.build_sweep_parts
        runner.build_sweep_parts = _spanned_parts(build)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._sweep(piece, call=PIECE_CALL)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            before = dict(LAUNCHES)
            traced = trace.profile(lambda: self._sweep(piece, call=PIECE_CALL))
            launched = {k: LAUNCHES[k] - before[k] for k in before}
        finally:
            runner.build_sweep_parts = build
        n = {s: len(v) for s, v in toks.items()}
        e = self.traffic["piece_epochs"]
        return {
            "calls": [{"configs": len(c.configs), "wall_s": c.wall_s,
                       "chunk_stats": c.result.chunk_stats, "phase_s": c.result.phase_s}
                      for c in window["calls"]],
            "window_s": window["window_s"],
            "flops": total,
            "phase_call": {"chunks": len(timed.chunk_stats), "phase_s": timed.phase_s,
                           "chunk_stats": timed.chunk_stats},
            "piece": {"wall_s": wall, "configs": len(piece), "epochs": e,
                      "train_steps": -(-n["train"] // self.config["batch_size"]),
                      "k1_rows": flops.k1_calls(n, len(piece), self.config["batch_size"], e),
                      "k1_launches": launched},
            "trace": traced,
            "geometry": geometry,
        }

    # -- correctness -----------------------------------------------------

    def answers(self, window: Dict) -> Dict:
        """The program's answers at the picks, in pick order: per phase what
        it handed on (host tensors), and the picked configs."""
        k = self.traffic["chunk_size"]
        from benchmark.reference.mmb2 import flat_decoder

        rec, configs = window["recorded"], window["calls"][0].configs
        diverged = window["calls"][0].result.diverged
        picks = self.picks()
        out: Dict[str, list] = {}
        seen = {}
        for p in picks:
            chunk = rec[p // k]
            i = seen.setdefault(p // k, 0)
            seen[p // k] += 1
            entry = {"losses": chunk["losses"][i], "train": chunk["train"][i],
                     "decoder": flat_decoder(_take(chunk["decoder"], torch.tensor([i]))),
                     "diverged": bool(diverged[p]),
                     "valid": chunk["infer"][0][i], "test": chunk["infer"][1][i],
                     "senti": _take(chunk["senti"], torch.tensor([i])),
                     "senti_losses": chunk["senti_losses"][i],
                     "pred": chunk["pred"][i],
                     "metrics": {m: v[i] for m, v in chunk["metrics"].items()}}
            for name, v in entry.items():
                out.setdefault(name, []).append(v)
        out["configs"] = [configs[p] for p in picks]
        out["draws"] = [generate.Draws(self.seed, 0, configs[p]["config_num"]) for p in picks]
        return out

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.prep = None

    def reference(self, prog: Dict, tf32: bool = False) -> Dict:
        """The plain reference at the picks, stage by stage (float32; TF32
        for the control): the whole joint fit from the draws, then each
        later phase from what the program's phase before handed on (its
        trained decoder, its train latents, its sentiment parameters and
        test latents), as ``benchmark.compare`` sets out."""
        from benchmark.reference import mmb2
        from benchmark.reference.prep import prepare

        dev = self.device
        cat = lambda xs: torch.stack(xs).to(dev)  # noqa: E731
        tree = lambda ts: {k: (tree([t[k] for t in ts]) if isinstance(ts[0][k], dict)  # noqa: E731
                               else torch.cat([t[k] for t in ts]).to(dev)) for k in ts[0]}
        configs, draws = prog["configs"], prog["draws"]
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            prep = prepare(self.dataset, self.pos_dims, dev)
            out = mmb2.train(configs, draws, prep, self.config["batch_size"])
            decoder = tree(prog["decoder"])
            for split in ("valid", "test"):
                out[split] = mmb2.infer(configs, decoder, prep, split,
                                        self.config["batch_size"] * 8)
            out["senti_losses"] = mmb2.sentiment(configs, draws, prep, cat(prog["train"]),
                                                 self.traffic["check_epochs"])
            out["pred"], out["metrics"] = mmb2.score(tree(prog["senti"]), cat(prog["test"]),
                                                     prep, self.dataset["name"])
            out["init"] = {s: prep[s]["init"] for s in ("train", "valid", "test")}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        return _host(out)
