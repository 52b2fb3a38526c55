"""Numeric guards, structured logging and profiling (port of :mod:`mmtpu.utils`).

mmtpu's ``utils/cache.py`` is XLA's compilation cache and has no
counterpart here: the port compiles its kernels once per source hash into
``mmtpu_torch/_build/`` (:mod:`mmtpu_torch.kernels.build`).
"""
