"""Multi-process execution (port of :mod:`mmtpu.parallel.multihost`).

In PyTorch a host's devices and several hosts are the same thing: one
process per card in a ``torch.distributed`` process group.  So the port's
two tiers share one layer:

1. **The sweep over processes** (:func:`run_sweep_multihost`): configs need
   no communication while they train, so each process runs its strided
   shard of the grid on its own card, and the per-config metric rows are
   merged once at the end with one gather.
2. **One config over processes**: :func:`mmtpu_torch.parallel.fit.fit_latents_mesh`
   on a mesh of the world's ranks (:func:`mmtpu_torch.parallel.fit.make_fit_mesh`).

Launch with ``torchrun`` (``python -m torch.distributed.run``), which sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``; :func:`init_multihost` joins that group.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from mmtpu_torch.parallel.mesh import default_backend

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

# how long the ranks of a sweep wait for each other before its one gather:
# shards are uneven and each builds its kernels, so the skew is unbounded
# in principle (mmtpu waits four hours, multihost.py:198)
GATHER_TIMEOUT_S = 4 * 3600


def init_multihost(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group that ``torchrun``'s environment describes,
    with ``backend`` (default: :func:`mmtpu_torch.parallel.mesh.default_backend`
    of ``device``).  Idempotent.  Without that environment (and no group
    up) it does nothing, as mmtpu's does with no coordinator.  Returns
    whether a process group is up."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    dist.init_process_group(backend or default_backend(device))
    return True


def world() -> tuple:
    """``(rank, world_size)``: ``(0, 1)`` without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_configs(configs: Sequence[dict], process_id: Optional[int] = None,
                  num_processes: Optional[int] = None):
    """Strided per-process config shard: process p takes ``configs[p::P]``.

    Returns ``(local_configs, global_indices)``.  Strided, not contiguous,
    so that the grid's expensive and cheap configs spread evenly."""
    rank, size = world()
    p = rank if process_id is None else process_id
    n = size if num_processes is None else num_processes
    idx = np.arange(p, len(configs), n)
    return [configs[i] for i in idx], idx


def run_sweep_multihost(configs: Sequence[dict], prep, n_runs: int = 1, verbose: bool = True,
                        **kw):
    """Run the config grid across every process of the group; every
    process returns the complete, identically ordered
    :class:`mmtpu_torch.sweep.runner.SweepResult` of the whole grid.

    Call :func:`init_multihost` first (without a group: one process, and the
    gather is a no-op).  Takes every keyword of
    :func:`mmtpu_torch.sweep.runner.run_sweep`; a ``checkpoint_dir`` is
    suffixed per process so that each keeps its own chunk resume.  With
    ``return_embeddings`` the embeddings stay local: the merged result has
    ``embeddings=None``.

    Before the gather the processes meet at a barrier with a long timeout
    (:data:`GATHER_TIMEOUT_S`) on a gloo group made for this call, so a fast
    process (an empty shard) waits for a slow one there, and a sweep's
    gather pairs only with its own.  The gather is one
    ``all_gather_object`` of the metric columns over that group.
    """
    from mmtpu_torch.sweep.runner import SweepResult, empty_sweep_result, run_sweep

    pid, n_proc = world()
    local_cfgs, cfg_idx = shard_configs(configs, pid, n_proc)
    # stamp the GLOBAL grid index, so that two processes never both emit
    # config_num 0, 1, ... (run_sweep's fallback is the local index)
    local_cfgs = [c if "config_num" in c else dict(c, config_num=int(g))
                  for c, g in zip(local_cfgs, cfg_idx)]
    if kw.get("checkpoint_dir"):
        kw = dict(kw, checkpoint_dir=f"{kw['checkpoint_dir']}_p{pid}")
    if verbose:
        print(f"[multihost] process {pid}/{n_proc}: {len(local_cfgs)} of {len(configs)} "
              f"configs")

    # the valid_curve columns must have one width across processes: each
    # shard's run_sweep sizes them to its own epoch max, and an empty shard
    # has none, so both take the whole grid's width
    vc_full = 0
    if kw.get("validation_curve"):
        vc_full = max(int(c.get("n_epochs", 100)) for c in configs) + 1
    if local_cfgs:
        local = run_sweep(local_cfgs, prep, n_runs=n_runs, verbose=verbose, **kw)
        if vc_full:
            vc = local.metrics["valid_curve"]
            local.metrics["valid_curve"] = np.pad(
                vc, ((0, 0), (0, vc_full - vc.shape[-1])), constant_values=np.nan)
    else:  # an empty shard still takes part in the gather the others wait in
        local = empty_sweep_result(prep, valid_curve_len=vc_full)

    # the global order is config-major, run-minor (run_sweep's n_runs
    # expansion): local row (j, r) lands at cfg_idx[j] * n_runs + r
    k_global = len(configs) * n_runs
    pos = np.repeat(cfg_idx * n_runs, n_runs) + np.tile(np.arange(n_runs), len(cfg_idx))

    def scatter(local_arr):
        local_arr = np.asarray(local_arr, np.float64)
        out = np.full((k_global,) + local_arr.shape[1:], np.nan)
        out[pos] = local_arr
        return out

    cols = {"config_nums": scatter(local.config_nums), "run_idxs": scatter(local.run_idxs),
            "final_train_loss": scatter(local.final_train_loss),
            "diverged": scatter(np.zeros(0) if local.diverged is None else local.diverged)}
    cols.update({f"m:{k}": scatter(v) for k, v in local.metrics.items()})

    gathered = [cols]
    if n_proc > 1:
        group = dist.new_group(backend="gloo",
                               timeout=datetime.timedelta(seconds=GATHER_TIMEOUT_S))
        try:
            dist.monitored_barrier(group=group,
                                   timeout=datetime.timedelta(seconds=GATHER_TIMEOUT_S))
            gathered = [None] * n_proc
            dist.all_gather_object(gathered, cols, group=group)
        finally:
            dist.destroy_process_group(group)

    def combine(key):
        # each row is real in exactly one process's columns and NaN in the others'
        stack = np.stack([g[key] for g in gathered])
        first = np.argmax(~np.isnan(stack), axis=0)
        return np.take_along_axis(stack, first[None], axis=0)[0]

    merged = {k: combine(k) for k in cols}
    return SweepResult(
        config_nums=merged["config_nums"].astype(np.int64),
        run_idxs=merged["run_idxs"].astype(np.int64),
        final_train_loss=merged["final_train_loss"].astype(np.float32),
        metrics={k[2:]: v.astype(np.float32) for k, v in merged.items() if k.startswith("m:")},
        wall_time_s=local.wall_time_s,
        n_configs=k_global,
        compile_time_s=local.compile_time_s,
        chunk_stats=local.chunk_stats,  # this process's chunks only
        diverged=merged["diverged"] == 1,
        phase_s=local.phase_s,
    )

