"""Sequential Monte Carlo: adaptive tempering, systematic resampling, HMC
mutation."""

from .smc import SMC, SMCResult, gather_particles, stage_draws

__all__ = ["SMC", "SMCResult", "stage_draws", "gather_particles"]
