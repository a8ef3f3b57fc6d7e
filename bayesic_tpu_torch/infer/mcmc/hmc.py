"""Static-trajectory HMC kernel over a batch of chains.

Counterpart of ``bayesic_tpu/infer/mcmc/hmc.py``: ``num_steps`` leapfrogs
from a fresh momentum, then a Metropolis accept.  Randomness is pre-drawn:
the momentum normals and the accept log-uniform (``log_u_acc[:, 0]``) of a
``streams.NUTSStreams``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .integrators import IntegratorState, make_leapfrog
from .metrics import kinetic_energy, sample_momentum

__all__ = ["HMCInfo", "make_hmc_kernel"]


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    num_steps: torch.Tensor
    energy: torch.Tensor
    is_accepted: torch.Tensor


def make_hmc_kernel(potential_and_grad, num_steps=32,
                    divergence_threshold=1000.0, dense=False):
    """Returns ``step(streams, state, step_size, inv_mass) -> (state,
    info)`` over all chains at once."""

    leapfrog = make_leapfrog(potential_and_grad, dense)

    def step(streams, state: IntegratorState, step_size, inv_mass):
        p0 = sample_momentum(streams.mom, inv_mass, dense)
        h0 = state.pe + kinetic_energy(inv_mass, p0, dense)
        start = IntegratorState(state.q, p0, state.pe, state.grad)
        end = start
        for _ in range(num_steps):
            end = leapfrog(end, step_size, inv_mass)
        delta = end.pe + kinetic_energy(inv_mass, end.p, dense) - h0
        delta = torch.where(torch.isnan(delta), float("inf"), delta)
        diverging = delta > divergence_threshold
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
        # log u < min(0, -delta)  <=>  u < accept_prob
        accept = streams.log_u_acc[:, 0] < torch.clamp(-delta, max=0.0)
        a = accept[:, None]
        new_state = IntegratorState(
            torch.where(a, end.q, start.q), torch.zeros_like(p0),
            torch.where(accept, end.pe, start.pe),
            torch.where(a, end.grad, start.grad))
        info = HMCInfo(accept_prob, diverging,
                       torch.full_like(accept, num_steps, dtype=torch.int32),
                       h0, accept)
        return new_state, info

    return step
