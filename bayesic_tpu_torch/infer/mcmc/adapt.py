"""Warmup adaptation: dual-averaging step size + Welford mass matrix with
Stan-style windowing.

Counterpart of ``bayesic_tpu/infer/mcmc/adapt.py``.  The states are
NamedTuples of tensors whose leading axes, if any, are chains: pooled
adaptation keeps one state, per-chain adaptation one per chain, and the
same functions serve both.  The window schedule is host numpy, the same arrays
as the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .integrators import IntegratorState
from .metrics import sample_momentum

__all__ = [
    "DualAveragingState", "da_init", "da_update",
    "WelfordState", "welford_init", "welford_update", "welford_update_batch",
    "welford_finalize", "build_schedule", "find_reasonable_step_size",
]


# -- dual averaging (Nesterov 2009, as used by Stan/NUTS paper) -------------

class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    grad_avg: torch.Tensor   # running average of (target - accept)
    t: torch.Tensor
    mu: torch.Tensor         # shrinkage target = log(10 * eps0)


def da_init(step_size):
    log_eps = torch.log(torch.as_tensor(step_size, dtype=torch.float32))
    zero = torch.zeros_like(log_eps)
    return DualAveragingState(log_eps, zero, zero, zero,
                              math.log(10.0) + log_eps)


def da_update(state: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveragingState:
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    grad_avg = (1.0 - eta_h) * state.grad_avg + eta_h * (target - accept_prob)
    log_step = state.mu - torch.sqrt(t) / gamma * grad_avg
    eta_x = t ** (-kappa)
    log_step_avg = eta_x * log_step + (1.0 - eta_x) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, grad_avg, t, state.mu)


# -- Welford online (co)variance -------------------------------------------

class WelfordState(NamedTuple):
    mean: torch.Tensor   # (..., d)
    m2: torch.Tensor     # sum of squared deviations: diag (..., d), dense
                         # (..., d, d)
    count: torch.Tensor  # (...)


def _is_diag(state):
    return state.m2.shape == state.mean.shape


def welford_init(dim, dense=False, dtype=torch.float32, batch=(),
                 device=None):
    """Empty estimate; ``batch`` gives leading (chain) axes."""
    batch = tuple(batch)
    shape = batch + ((dim, dim) if dense else (dim,))
    return WelfordState(
        torch.zeros(batch + (dim,), dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(batch, dtype=dtype, device=device),
    )


def welford_update(state: WelfordState, x) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    delta2 = x - mean
    if _is_diag(state):
        m2 = state.m2 + delta * delta2
    else:
        m2 = state.m2 + delta[..., :, None] * delta2[..., None, :]
    return WelfordState(mean, m2, count)


def welford_update_batch(state: WelfordState, xs) -> WelfordState:
    """Chan-et-al parallel update with a whole batch ``xs`` (n, d) — used by
    pooled cross-chain adaptation (all chains feed ONE mass estimate)."""
    nb = xs.shape[0]
    mean_b = torch.mean(xs, 0)
    delta_b = xs - mean_b
    diag = _is_diag(state)
    m2_b = torch.sum(delta_b * delta_b, 0) if diag else delta_b.T @ delta_b
    n_a = state.count
    n = n_a + nb
    delta = mean_b - state.mean
    mean = state.mean + delta * nb / n
    if diag:
        m2 = state.m2 + m2_b + delta * delta * n_a * nb / n
    else:
        m2 = state.m2 + m2_b + torch.outer(delta, delta) * n_a * nb / n
    return WelfordState(mean, m2, n)


def welford_finalize(state: WelfordState, regularize=True):
    """Return the *inverse mass* estimate (posterior variance, regularized
    toward identity as Stan does)."""
    diag = _is_diag(state)
    n = state.count[..., None] if diag else state.count[..., None, None]
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        shrink = n / (n + 5.0)
        if diag:
            var = shrink * var + 1e-3 * (1.0 - shrink)
        else:
            d = var.shape[-1]
            eye = torch.eye(d, dtype=var.dtype, device=var.device)
            var = shrink * var + 1e-3 * (1.0 - shrink) * eye
    return var


# -- Stan warmup windows -----------------------------------------------------

def build_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Host-side schedule: for each warmup step, whether we are in a slow
    (mass-estimation) window and whether this step closes a window (mass
    matrix refresh + step-size re-init).  Returns numpy bool arrays."""
    in_slow = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    if num_warmup < 20:
        return in_slow, window_end
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.1 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    start = init_buffer
    size = base_window
    while start < num_warmup - term_buffer:
        end = min(start + size, num_warmup - term_buffer)
        # final window absorbs the remainder if the next one wouldn't fit
        if end + 2 * size > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        in_slow[start:end] = True
        window_end[end - 1] = True
        start = end
        size *= 2
    return in_slow, window_end


# -- initial step-size search ------------------------------------------------

def find_reasonable_step_size(potential_and_grad, kinetic_fn, leapfrog, q,
                              eps, inv_mass, init_step=1.0, dense=None):
    """Double/halve the step size until the one-step acceptance crosses 0.5
    (NUTS paper, Algorithm 4), for every chain of ``q`` (C, D) at once.
    ``eps`` holds the standard normals of the momentum draw; ``dense`` as
    in ``metrics`` (``kinetic_fn`` and ``leapfrog`` must agree with it).
    Returns one step size per chain (a 0-d tensor for a single chain ``q``
    (D,))."""
    pe, grad = potential_and_grad(q)
    p = sample_momentum(eps, inv_mass, dense)
    h0 = pe + kinetic_fn(inv_mass, p)
    state0 = IntegratorState(q, p, pe, grad)
    log_half, ln2 = math.log(0.5), math.log(2.0)

    def accept_at(log_eps):
        s = leapfrog(state0, torch.exp(log_eps), inv_mass)
        return h0 - (s.pe + kinetic_fn(inv_mass, s.p))   # log accept ratio

    log_eps = torch.full(pe.shape, math.log(init_step), dtype=q.dtype,
                         device=q.device)
    direction = torch.where(accept_at(log_eps) > log_half, 1.0, -1.0)
    for _ in range(50):
        la = accept_at(log_eps)
        keep = torch.where(direction > 0, la > log_half, la < log_half)
        if not bool(keep.any()):
            break
        log_eps = torch.where(keep, log_eps + direction * ln2, log_eps)
    return torch.exp(log_eps)
