"""Meshes, collectives and the sharded algorithms over them
(``bayesic_tpu.parallel``'s counterpart, on ``torch.distributed``), and
particle resampling.

A sharded run is one process a rank (``launcher.initialize``); ``mesh``
names the axes (``"data"``, ``"chain"``, ``"particle"``, ``"model"``) and
holds every collective, the differentiable ``enter`` / ``gather`` /
``reduce`` among them; ``dp`` and ``dp_fused`` shard SVI's rows over
``"data"``, ``infer.mcmc.MCMC(chain_sharding=)`` the chains and
``infer.smc.SMC(particle_sharding=)`` the particles, which
``resample.systematic_resample_shard_map`` resamples across the ranks;
``tp`` splits parameters and observations over the ``"model"`` axis
(``shard_params`` / ``gather_params``, ``sharded_logdensity``,
``ShardedMeanFieldGuide``; the DLGM decoder by
``models.dlgm.run_svi(model_sharding=)``).
"""

from .dp import dp_svi_run
from .mesh import (AXES, Sharding, enter, gather, make_mesh, put_replicated,
                   put_sharded, reduce, replicate, shard_leading)
from .resample import (compensated_cumsum, effective_sample_size,
                       normalize_log_weights, systematic_ancestors,
                       systematic_resample, systematic_resample_shard_map)
from .tp import (ShardedMeanFieldGuide, gather_params, shard_params,
                 sharded_logdensity)

__all__ = ["AXES", "Sharding", "make_mesh", "shard_leading", "replicate",
           "put_sharded", "put_replicated", "normalize_log_weights",
           "effective_sample_size", "compensated_cumsum",
           "systematic_ancestors", "systematic_resample",
           "systematic_resample_shard_map", "dp_svi_run", "enter", "gather",
           "reduce", "shard_params", "gather_params", "sharded_logdensity",
           "ShardedMeanFieldGuide"]
