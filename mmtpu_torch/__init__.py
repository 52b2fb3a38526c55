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
(:mod:`mmtpu_torch.run`), including ``--lazy_adam``, ``--validation_curve``,
``--resume_dir`` and ``--time_test``; the hyperparameter sweep, chunks of K
configs trained as one program with a leading config axis, and its driver
and CLI (:mod:`mmtpu_torch.sweep`), including ``--infer_warm_start``; the
closed form and serving (:mod:`mmtpu_torch.ops.closed_form`,
:mod:`mmtpu_torch.train.warm_start`, :mod:`mmtpu_torch.serve`); the legacy
models and the alternating driver (:mod:`mmtpu_torch.models.legacy`,
:mod:`mmtpu_torch.train.alternating`); the SIF and positional-encoding ops
of mmtpu's ``ops`` API (:mod:`mmtpu_torch.ops`) and
:mod:`mmtpu_torch.analysis`; multi-device runs over ``torch.distributed``,
one process per rank (:mod:`mmtpu_torch.parallel`: meshes, fits sharded
over batch and vocabulary, the sweep's config axis over ranks and the
multi-process sweep, behind ``--mesh`` and ``--multihost``); and the aux
modules (:mod:`mmtpu_torch.utils`, ``--profile``,
:mod:`mmtpu_torch.make_configs`).  mmtpu's XLA compilation cache has no
counterpart: the kernels build once per source hash.
"""

__version__ = "0.1.0"


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
