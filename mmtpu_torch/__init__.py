"""mmtpu_torch — the PyTorch/CUDA port of :mod:`mmtpu` for NVIDIA Hopper.

The package mirrors ``mmtpu``'s module layout and function names; ``mmtpu``
stays the reference each module is tested against.  Plain tensor code is
PyTorch; every Pallas TPU kernel on the ported path is a CUDA C++ kernel
written for ``sm_90a`` (``mmtpu_torch/csrc``), built from source at first use.

The port imports neither jax nor ``mmtpu``.  It keeps its own copies of the
numpy-only parts of ``mmtpu`` that it needs: :mod:`mmtpu_torch.config`
(experiment configs, the grid) and :mod:`mmtpu_torch.data` (loading,
synthesis, numpy preparation).

Ported and running: the MMB1/MMB2 latent fit and the e2e fit with their
inference fits, the sentiment MLP, reports, artifacts and the CLI
(:mod:`mmtpu_torch.run`), including ``--lazy_adam``, ``--validation_curve``
and ``--resume_dir``; and one chunk of the hyperparameter sweep, K configs
trained as one program with a leading config axis
(:func:`mmtpu_torch.sweep.runner.run_chunk`).  What is not ported yet raises
:func:`not_ported`.
"""

__version__ = "0.1.0"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a part of mmtpu that the port does not have yet;
    ``item`` names its entry in ROADMAP.md."""
    return NotImplementedError(f"{what} is not ported to mmtpu_torch yet (ROADMAP.md: {item})")


def __getattr__(name):
    """Lazy top-level API (importing the package imports no submodule)."""
    if name == "run_experiment":
        from mmtpu_torch.runner import run_experiment

        return run_experiment
    if name == "ExperimentConfig":
        from mmtpu_torch.config import ExperimentConfig

        return ExperimentConfig
    if name == "load_dataset":
        from mmtpu_torch.data import load_dataset

        return load_dataset
    raise AttributeError(name)
