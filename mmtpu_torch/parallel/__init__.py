"""Meshes of ranks, sharded ops and sharded fits over ``torch.distributed``
(port of :mod:`mmtpu.parallel`).

One process per rank, each on its own device (or CUDA ranks sharing one
card over gloo).  mmtpu's parallel axes:

- "config": the sweep's config axis, with no communication while configs
  train (:func:`mmtpu_torch.sweep.runner.run_chunk` with a mesh, and the
  processes of :func:`run_sweep_multihost`);
- "data": each minibatch's rows split over ranks, with summed gradients
  (:func:`fit_latents_mesh`, :func:`fit_e2e_mesh`);
- "vocab": the word likelihood's vocabulary split over ranks, with the
  partition summed (:func:`sharded_angular_partition`, or inside the mesh
  fits).
"""

from mmtpu_torch.parallel.collectives import sharded_angular_partition, sharded_gaussian_logpdf
from mmtpu_torch.parallel.fit import fit_e2e_mesh, fit_latents_mesh, make_fit_mesh, place_fit_inputs
from mmtpu_torch.parallel.mesh import config_sharding, init_world, make_mesh, replicated
from mmtpu_torch.parallel.multihost import init_multihost, run_sweep_multihost, shard_configs

__all__ = [
    "make_mesh",
    "config_sharding",
    "replicated",
    "init_world",
    "sharded_angular_partition",
    "sharded_gaussian_logpdf",
    "fit_e2e_mesh",
    "fit_latents_mesh",
    "make_fit_mesh",
    "place_fit_inputs",
    "init_multihost",
    "run_sweep_multihost",
    "shard_configs",
]
