"""mmtpu_torch — the PyTorch/CUDA port of :mod:`mmtpu` for NVIDIA Hopper.

The package mirrors ``mmtpu``'s module layout and function names; ``mmtpu``
stays the reference each module is tested against.  Plain tensor code is
PyTorch; every Pallas TPU kernel on the ported path is a CUDA C++ kernel
written for ``sm_90a`` (``mmtpu_torch/csrc``), built from source at first use.

The jax-free parts of ``mmtpu`` are imported, not copied: ``mmtpu.config``
(experiment configs, the grid) and ``mmtpu.data`` (loading, synthesis, numpy
preparation).  Nothing here imports jax.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (importing the package imports no submodule)."""
    if name == "run_experiment":
        from mmtpu_torch.runner import run_experiment

        return run_experiment
    if name == "ExperimentConfig":
        from mmtpu.config import ExperimentConfig

        return ExperimentConfig
    if name == "load_dataset":
        from mmtpu.data import load_dataset

        return load_dataset
    raise AttributeError(name)
