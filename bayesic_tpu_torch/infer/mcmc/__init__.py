"""MCMC backend: HMC / iterative multinomial NUTS with windowed adaptation,
all chains batched on a leading axis.  Elliptical slice, Gibbs and
tempering are not ported yet."""

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
from .mcmc import MCMC, MCMCResult
from .metrics import kinetic_energy, mass_sqrt, sample_momentum, velocity
from .nuts import NUTSInfo, make_nuts_kernel, nuts_core
from .streams import NUTSStreams, StreamKey, nuts_streams

__all__ = [
    "MCMC", "MCMCResult", "make_nuts_kernel", "nuts_core", "make_hmc_kernel",
    "make_leapfrog", "IntegratorState", "NUTSInfo", "HMCInfo",
    "kinetic_energy", "sample_momentum", "velocity", "mass_sqrt",
    "da_init", "da_update", "DualAveragingState",
    "welford_init", "welford_update", "welford_update_batch",
    "welford_finalize", "WelfordState",
    "build_schedule", "find_reasonable_step_size",
    "NUTSStreams", "StreamKey", "nuts_streams",
]
