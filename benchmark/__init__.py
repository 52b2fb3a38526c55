"""The benchmark of mmtpu_torch on an NVIDIA card: ``python3 benchmark/run.py``
(``BENCHMARK.json`` at the repository root names its cells and metrics)."""
