"""CPU tests of the benchmark harness (run from the repository's root:
``python -m pytest benchmark/tests -q -p no:cacheprovider``).

A whole run at a tiny size on the CPU (the harness's look for a card
skipped, the kernels' plain versions under the program): the reference
agrees with the program, and each fault planted in the program makes
``correct`` false.  The control (TF32) needs the card: its test carries
the ``cuda`` marker and decides in a fixture.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import calibrate, compare, flops, generate  # noqa: E402
from benchmark.run import cell_spec, load_module, read_per_layer, run_cell  # noqa: E402

BENCH = os.path.join(ROOT, "benchmark")
TINY_LIMITS = {"train_loss_gap": 1e-4, "train_change_gap": 1e-3,
               "infer_change_gap": 1e-3, "senti_loss_gap": 1e-4, "pred_gap": 1e-4,
               "metric_gap": 1e-4}


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _tiny_spec(dataset: str = "mosi") -> dict:
    geometry = dict(n_train=70, n_valid=20, n_test=30, seq_len=8, vocab_size=200,
                    embed_dim=300, audio_dim=12, visual_dim=9,
                    text_len=50 if dataset == "pom" else 0)
    spec = cell_spec("mosi_mmb2.grid_adam100")
    spec["config"] = {"dataset": dataset, "geometry": geometry,
                      "n_out": 17 if dataset == "pom" else 1, "batch_size": 16}
    spec["traffic"] = dict(spec["traffic"], configs_per_call=4, chunk_size=2, check_configs=3)
    spec["limits"] = dict(TINY_LIMITS)
    return spec


@pytest.fixture
def tiny(monkeypatch):
    """Grid calls cut to 3 epochs and 4 sentiment epochs, two torch threads."""
    orig = generate.call_configs
    monkeypatch.setattr(generate, "call_configs", lambda t, i: [
        dict(c, n_epochs=3, n_sentiment_epochs=4) for c in orig(t, i)])
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_file_of_a_cell_loads_by_name(workload):
    spec = cell_spec(workload)
    cfg = spec["config"]
    assert set(cfg["geometry"]) >= {"n_train", "vocab_size", "embed_dim", "text_len"}
    assert os.path.isfile(spec["driver"])
    assert set(spec["limits"]) == set(TINY_LIMITS)
    for name, path in spec["readers"].items():
        assert callable(load_module(path, f"benchmark_metric.{name}").read), name
    names = {m["name"] for m in spec["end_to_end"]}
    assert {"setup_s", "sweep_configs_per_h", "peak_mem_gib"} <= names


def test_a_dropped_in_metric_is_found_without_edits(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["per_layer"].append({"name": "stub.count", "unit": "calls", "better": "lower",
                               "source": "program_counter", "layer": "sweep driver",
                               "moves": "sweep_configs_per_h"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark" / "metrics" / "stub.count.py").write_text(
        "def read(record):\n    return len(record['calls'])\n")
    spec = cell_spec("mosi_mmb2.grid_adam100", root=str(tmp_path))
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] == "stub.count"]
    assert read_per_layer(spec, {"calls": [1, 2, 3]}) == {
        "stub.count": {"value": 3.0, "unit": "calls"}}


def _record(k1_fwd_n: int = 2) -> dict:
    """A traced run's record as ``Driver.traced`` builds it, by hand."""
    return {"calls": [{"configs": 64, "wall_s": 40.0, "phase_s": {"train": 30.0, "sentiment": 4.0},
                       "chunk_stats": [{"done_at_s": 24.0}, {"done_at_s": 44.0}]}],
            "window_s": 40.0, "flops": 67e12 * 40.0 * 0.04,
            "phase_call": {"chunks": 2, "phase_s": {"train": 30.0, "sentiment": 4.0},
                           "chunk_stats": [{"done_at_s": 24.0}, {"done_at_s": 44.0}]},
            "piece": {"wall_s": 8.0, "train_steps": 21, "k1_rows": [2048, 16384]},
            "trace": {"busy_s": 6.0, "graph_replays": {"sweep.train": 19},
                      "graph_kernels": {"sweep.train": 19 * 21 * 1780},
                      "k1": {"fwd_n": k1_fwd_n, "fwd_s": 1e-3, "bwd_n": 2, "bwd_s": 2e-3}},
            "geometry": {"embed_dim": 300, "vocab_size": 3016}}


def test_the_per_layer_readers_read_a_record():
    spec = cell_spec("mosi_mmb2.grid_adam100")
    got = read_per_layer(spec, _record())
    assert got["sweep.first_chunk_extra_s"]["value"] == pytest.approx(4.0)
    assert got["chunk.train_s"]["value"] == pytest.approx(15.0)
    assert got["chunk.sent_s"]["value"] == pytest.approx(2.0)
    assert got["step.kernels_per_train_step"]["value"] == pytest.approx(1780)
    assert got["step_mfu"]["value"] == pytest.approx(4.0)
    assert got["device.idle_pct.sweep"]["value"] == pytest.approx(25.0)
    bound = flops.k1_bounds(2048, 300, 3016)["fwd"][0] + flops.k1_bounds(16384, 300, 3016)["fwd"][0]
    assert got["k1_fwd_roofline"]["value"] == pytest.approx(100 * bound / 1e3 / 1e-3)
    # a trace whose K1 kernels do not match the piece's calls gives no roofline
    assert "k1_fwd_roofline" not in read_per_layer(spec, _record(k1_fwd_n=3))


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*subdirs) -> list:
    out = []
    for sub in subdirs:
        for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
            out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def test_nothing_imports_jax_or_the_jax_package_and_the_reference_not_the_program():
    for path in _sources(""):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "mmtpu"}, path
    plain = _sources("reference") + [os.path.join(BENCH, f) for f in
                                     ("generate.py", "compare.py", "flops.py")]
    for path in plain:
        assert "mmtpu_torch" not in _imports(path), path


def test_k1_bounds_reproduce_the_recorded_ones():
    assert flops.k1_bounds(2048, 300, 3016)["fwd"][0] == pytest.approx(0.0553, abs=5e-5)
    assert flops.k1_bounds(2048, 300, 3016)["bwd"][0] == pytest.approx(0.1106, abs=5e-5)
    assert flops.k1_bounds(4096, 300, 9206)["fwd"][0] == pytest.approx(0.3377, abs=5e-5)
    assert flops.k1_bounds(4096, 300, 9206)["bwd"][0] == pytest.approx(0.6754, abs=5e-5)
    assert flops.k1_bounds(64, 300, 3016)["fwd"] == (pytest.approx(0.00173, abs=5e-6),
                                                     "operations")


def test_the_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "mosi_mmb2.grid_adam100", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


@pytest.mark.parametrize("dataset", ["mosi", "pom"])
def test_a_tiny_run_agrees_with_the_reference(tiny, dataset):
    result = run_cell(_tiny_spec(dataset), 2**33 + 5, 0.0, False, device="cpu")
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] == 4 and result["metrics"]["sweep_configs_per_h"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_a_fault_in_the_program_makes_the_run_incorrect(tiny, fault):
    with calibrate.FAULTS[fault]():
        result = run_cell(_tiny_spec(), 7, 0.0, False, device="cpu")
    assert not result["correct"], result["checks"]
    if fault == "late":  # it acts after the compared first epochs
        checks = result["checks"]
        assert checks["train_loss_gap"]["value"] <= checks["train_loss_gap"]["limit"]
        assert checks["train_change_gap"]["value"] > checks["train_change_gap"]["limit"]


def _answers(n: int = 2) -> tuple:
    """Program answers and a reference's, equal, at ``n`` picks, by hand."""
    t = torch.arange(1.0, 5.0).reshape(2, 2)
    dec = {"w_mu": t[None], "scale": t[None, 0]}
    ref = {"losses": torch.tensor([[3.0, 2.0, 1.0]] * n), "latents": t.expand(n, 2, 2) * 2,
           "decoder": {k: v.expand(n, *v.shape[1:]) * 2 for k, v in dec.items()},
           "decoder0": {k: v.expand(n, *v.shape[1:]) for k, v in dec.items()},
           "init": {"train": t, "valid": t, "test": t},
           "valid": t.expand(n, 2, 2) * 3, "test": t.expand(n, 2, 2) * 3,
           "senti_losses": torch.ones(n, 2), "pred": torch.zeros(n, 3),
           "metrics": {"mae": torch.ones(n), "corr": torch.full((n,), 0.5)}}
    prog = {"losses": list(ref["losses"]), "train": list(ref["latents"]),
            "decoder": [{k: v[i:i + 1] for k, v in ref["decoder"].items()} for i in range(n)],
            "diverged": [False] * n, "valid": list(ref["valid"]), "test": list(ref["test"]),
            "senti_losses": list(ref["senti_losses"]), "pred": list(ref["pred"]),
            "metrics": [{k: v[i] for k, v in ref["metrics"].items()} for i in range(n)]}
    return prog, ref


def test_a_value_not_finite_is_excused_only_where_both_sides_diverged():
    prog, ref = _answers()
    assert max(compare.numbers(prog, ref, 2).values()) == 0.0
    # the program's trained decoder NaN after epoch 2, handed on: the later
    # phases, computed from it, read NaN on both sides
    nan = float("nan")
    prog["losses"][1] = torch.tensor([3.0, 2.0, nan])
    prog["decoder"][1] = {k: v * nan for k, v in prog["decoder"][1].items()}
    for k in ("valid", "test", "pred"):
        prog[k][1] = prog[k][1] * nan
        ref[k][1] = ref[k][1] * nan
    got = compare.numbers(prog, ref, 2)
    assert got["train_loss_gap"] == 0.0
    assert got["train_change_gap"] == got["infer_change_gap"] == got["pred_gap"] == float("inf")
    prog["diverged"][1] = True  # flagged by the program, not by the reference's own fit
    assert compare.numbers(prog, ref, 2)["train_change_gap"] == float("inf")
    ref["losses"][1, 2] = nan
    ref["latents"][1] = ref["latents"][1] * nan
    ref["decoder"] = {k: v.clone() for k, v in ref["decoder"].items()}
    for v in ref["decoder"].values():
        v[1] = nan
    got = compare.numbers(prog, ref, 2)
    assert got["train_change_gap"] == got["infer_change_gap"] == got["pred_gap"] == 0.0
    # the correlation of constant (finite) predictions is NaN on both sides
    prog, ref = _answers()
    prog["metrics"][0]["corr"] = ref["metrics"]["corr"][0] = torch.tensor(nan)
    assert compare.numbers(prog, ref, 2)["metric_gap"] == 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_the_control_fails_the_limits_on_the_card(card, tiny, workload):
    """The reference computed with TF32 matmuls in the program's place, at
    a small size: the cell's limits refuse it."""
    spec = _tiny_spec("pom" if workload.startswith("pom") else "mosi")
    spec["config"]["geometry"].update(n_train=640, vocab_size=2000)
    spec["limits"] = cell_spec(workload)["limits"]
    driver = load_module(spec["driver"], "benchmark_driver").Driver(
        spec["config"], spec["traffic"], 11, card)
    driver.setup()
    prog = driver.answers(driver.window(0.0))
    ref = driver.reference(prog)
    ctl = calibrate.as_answers(driver.reference(prog, tf32=True), prog)
    sound = compare.judge(compare.numbers(prog, ref, 2), spec["limits"])[0]
    control = compare.judge(compare.numbers(ctl, ref, 2), spec["limits"])[0]
    assert sound and not control
