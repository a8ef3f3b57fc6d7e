"""Symplectic integrators for HMC/NUTS.

Counterpart of ``bayesic_tpu/infer/mcmc/integrators.py``.  ``make_leapfrog``
takes any batched ``potential_and_grad(q (C, D)) -> (pe (C,), grad (C, D))``;
the step size is a scalar or one per chain, (C,).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .metrics import velocity

__all__ = ["IntegratorState", "make_leapfrog", "per_chain"]


class IntegratorState(NamedTuple):
    q: torch.Tensor       # position (flat unconstrained params), (C, D)
    p: torch.Tensor       # momentum
    pe: torch.Tensor      # potential energy = -log density, (C,)
    grad: torch.Tensor    # d pe / d q


def per_chain(x, like):
    """A scalar, or a (C,) tensor of per-chain values, shaped to broadcast
    against ``like`` (C, D)."""
    if isinstance(x, torch.Tensor) and x.dim() == 1 and like.dim() == 2:
        return x[:, None]
    return x


def make_leapfrog(potential_and_grad: Callable, dense=False):
    """Velocity-Verlet step: half-kick, drift, half-kick, with one
    gradient evaluation per step."""

    def step(state: IntegratorState, step_size, inv_mass) -> IntegratorState:
        eps = per_chain(step_size, state.q)
        p_half = state.p - 0.5 * eps * state.grad
        q_new = state.q + eps * velocity(inv_mass, p_half, dense)
        pe_new, grad_new = potential_and_grad(q_new)
        p_new = p_half - 0.5 * eps * grad_new
        return IntegratorState(q_new, p_new, pe_new, grad_new)

    return step
