"""The hyperparameter sweep (port of :mod:`mmtpu.sweep`): K configs of one
optimizer trained as one program with a leading config axis.

:mod:`mmtpu_torch.sweep.pack` packs the configs' hyperparameters into
``(K,)`` arrays; :func:`mmtpu_torch.sweep.runner.run_chunk` trains one chunk
of them through mmtpu's four phases (the train fit, the valid/test inference
fits, the sentiment MLP, the test metrics); :func:`run_sweep` drives a whole
grid through such chunks (buckets, ``n_runs``, resume), and
``python -m mmtpu_torch.sweep`` is its CLI.
"""

from mmtpu_torch.sweep.pack import SweepStatics, pack_configs, statics_from_configs

__all__ = ["SweepStatics", "pack_configs", "statics_from_configs", "run_chunk", "run_sweep",
           "SweepResult"]


def __getattr__(name):
    """``run_sweep``, ``run_chunk`` and ``SweepResult`` without importing the
    runner (and the fits) at package import."""
    if name in ("run_sweep", "run_chunk", "SweepResult"):
        from mmtpu_torch.sweep import runner

        return getattr(runner, name)
    raise AttributeError(name)
