"""MCMC backend: HMC / iterative multinomial NUTS with windowed adaptation,
elliptical slice, parallel tempering and NUTS within Gibbs, all chains
batched on a leading axis."""

from .adapt import (
    DualAveragingState,
    WelfordState,
    build_schedule,
    da_init,
    da_update,
    find_reasonable_step_size,
    welford_finalize,
    welford_init,
    welford_update,
    welford_update_batch,
)
from .hmc import HMCInfo, make_hmc_kernel
from .integrators import IntegratorState, make_leapfrog
from .mcmc import MCMC, MCMCResult, gather_chains
from .metrics import kinetic_energy, mass_sqrt, sample_momentum, velocity
from .nuts import NUTSInfo, make_nuts_kernel, nuts_core
from .streams import NUTSStreams, StreamKey, nuts_streams
from .ess import EllipticalSlice, ESSResult
from .gibbs import DiscreteGibbs, GibbsResult
from .tempering import ParallelTempering, PTResult, geometric_ladder

__all__ = [
    "MCMC", "MCMCResult", "gather_chains", "make_nuts_kernel", "nuts_core",
    "make_hmc_kernel",
    "ParallelTempering", "PTResult", "geometric_ladder",
    "EllipticalSlice", "ESSResult",
    "DiscreteGibbs", "GibbsResult",
    "make_leapfrog", "IntegratorState", "NUTSInfo", "HMCInfo",
    "kinetic_energy", "sample_momentum", "velocity", "mass_sqrt",
    "da_init", "da_update", "DualAveragingState",
    "welford_init", "welford_update", "welford_update_batch",
    "welford_finalize", "WelfordState",
    "build_schedule", "find_reasonable_step_size",
    "NUTSStreams", "StreamKey", "nuts_streams",
]
