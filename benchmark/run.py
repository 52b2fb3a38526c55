"""The benchmark of ``mmtpu_torch`` on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration (``benchmark/configs/<config>.json``)
and a traffic mix (``benchmark/traffic/<traffic>.json``), whose ``driver``
is ``benchmark/drivers/<driver>.py``; the per-layer metrics of a traced run
are read by ``benchmark/metrics/<metric>.py``, and the limits of the
comparison are ``benchmark/limits/<cell>.json``.  Everything is found by
name: a new cell, traffic mix or metric is new files and entries.

A run: set-up (data and draws from ``--seed``, the program's data
preparation, one short eager call), then the measured window (the
driver's calls until ``--seconds`` have passed, the one in flight
finished), then, with ``--trace 1``, one phase-timed call and the traced
piece; then the program's
state is dropped and the plain reference recomputes a sample of the
window's answers.  The last line of standard output is the result (JSON);
the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

It exits 2, printing no result, without a card (or with fewer cards than
the cell asks for), and 3 where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``mmtpu`` was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from the process's start

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX stack and the JAX package, by whole top-level module name
BANNED = ("jax", "jaxlib", "flax", "mmtpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark by its file (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, root: str = ROOT) -> dict:
    """Everything a run of ``workload`` reads, found by name."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    here = os.path.join(root, "benchmark")
    traffic = load_json(here, "traffic", f"{cell['traffic']}.json")
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    return {"cell": cell, "config": load_json(here, "configs", f"{cell['config']}.json"),
            "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer,
            "limits": load_json(here, "limits", f"{workload}.json"),
            "driver": os.path.join(here, "drivers", f"{traffic['driver']}.py"),
            "readers": {m["name"]: os.path.join(here, "metrics", f"{m['name']}.py")
                        for m in per_layer}}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def read_per_layer(spec: dict, record: dict) -> dict:
    """Each per-layer metric from its reader; one that finds nothing to read
    is left out."""
    out = {}
    for m in spec["per_layer"]:
        reader = load_module(spec["readers"][m["name"]], f"benchmark_metric.{m['name']}")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float = T_START) -> dict:
    """One run; returns the result's fields (``checks`` last)."""
    import torch

    from benchmark import compare

    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the configuration states
    torch.backends.cudnn.allow_tf32 = False
    driver = load_module(spec["driver"], "benchmark_driver").Driver(
        spec["config"], spec["traffic"], seed, device)
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s")
    window = driver.window(seconds)
    calls = window["calls"]
    # each call's reserved peak counts from its own start; the window's is
    # the largest, the metric the first call's (a later call starts from what
    # the calls before it left reserved)
    peak = max(c.peak_reserved for c in calls)
    log(f"window {window['window_s']:.2f} s: calls " + ", ".join(f"{c.wall_s:.2f} s" for c in calls))
    for c in calls:
        log(f"call {c.index}: reserved peak {c.peak_reserved / 2**30:.3f} GiB, at its end "
            f"reserved {c.reserved_after / 2**30:.3f} GiB, allocated "
            f"{c.allocated_after / 2**30:.3f} GiB")
    names = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": spec["cell"]["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": driver.attempted(window), "failed": 0}
    if trace:
        t0 = time.perf_counter()
        record = driver.traced(window)
        log(f"traced piece {time.perf_counter() - t0:.2f} s (unprofiled "
            f"{record['piece']['wall_s']:.2f} s, K1 launches {record['piece']['k1_launches']}, "
            f"traced K1 {record['trace']['k1']})")
        metrics = read_per_layer(spec, record)
        device_info.update(busy_s=record["trace"]["busy_s"], window_s=record["trace"]["wall_s"])
        result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                               "idle_gaps": record["trace"]["idle_gaps"]}
    else:
        values = dict(driver.end_to_end(window), peak_mem_gib=calls[0].peak_reserved / 2**30,
                      setup_s=setup_s)
        metrics = {n: {"value": float(values[n]), "unit": u} for n, u in names.items()}
    prog = driver.answers(window)
    driver.release()
    window = calls = None  # the program's results and state go before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = driver.reference(prog)
    log(f"reference {time.perf_counter() - t0:.2f} s")
    values = compare.numbers(prog, ref, spec["traffic"]["check_epochs"])
    correct, rows = compare.judge(values, spec["limits"])
    result.update(correct=correct, metrics=metrics, device=device_info)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # the program's and the GPU compilers' caches stay in the checkout, at
    # fixed paths (the kernel library builds into mmtpu_torch/_build/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    sys.path.insert(0, ROOT)
    spec = cell_spec(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"benchmark: the run imported {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
