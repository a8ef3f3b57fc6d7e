"""Meshes, collectives and the sharded algorithms over them
(``bayesic_tpu.parallel``'s counterpart, on ``torch.distributed``), and
particle resampling.

A sharded run is one process a rank (``launcher.initialize``); ``mesh``
names the axes and holds every collective; ``dp`` and ``dp_fused`` shard
SVI's rows, ``infer.mcmc.MCMC(chain_sharding=)`` the chains and
``infer.smc.SMC(particle_sharding=)`` the particles, which
``resample.systematic_resample_shard_map`` resamples across the ranks.
"""

from .dp import dp_svi_run
from .mesh import (AXES, Sharding, make_mesh, put_replicated, put_sharded,
                   replicate, shard_leading)
from .resample import (compensated_cumsum, effective_sample_size,
                       normalize_log_weights, systematic_ancestors,
                       systematic_resample, systematic_resample_shard_map)

__all__ = ["AXES", "Sharding", "make_mesh", "shard_leading", "replicate",
           "put_sharded", "put_replicated", "normalize_log_weights",
           "effective_sample_size", "compensated_cumsum",
           "systematic_ancestors", "systematic_resample",
           "systematic_resample_shard_map", "dp_svi_run"]
