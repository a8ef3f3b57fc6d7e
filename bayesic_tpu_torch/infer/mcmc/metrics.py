"""Euclidean metric (mass matrix) for HMC/NUTS: kinetic energy, momentum
sampling, velocities.

Counterpart of ``bayesic_tpu/infer/mcmc/metrics.py``.  JAX picks the variant
from the rank of one chain's inverse mass (1 = diagonal, 2 = dense) and
vmaps the chains.  Here the chain axis is written out, so a (C, D) inverse
mass could be C diagonals or one dense matrix: the callers say which with
``dense``.  Shapes: ``p`` is (..., D); a diagonal inverse mass is (D,) or
per chain (C, D); a dense one (D, D) or per chain (C, D, D).  ``dense=None``
keeps JAX's rule for a single chain (dense when ``inv_mass`` is 2-D and
``p`` is 1-D).
"""

from __future__ import annotations

import torch

__all__ = ["kinetic_energy", "velocity", "sample_momentum", "mass_sqrt"]


def _dense(inv_mass, p, dense):
    if dense is None:
        return inv_mass.dim() == 2 and p.dim() == 1
    return bool(dense)


def kinetic_energy(inv_mass, p, dense=None):
    """0.5 * p^T M^{-1} p, over the last axis."""
    if not _dense(inv_mass, p, dense):
        return 0.5 * torch.sum(p * inv_mass * p, -1)
    return 0.5 * torch.sum(p * velocity(inv_mass, p, True), -1)


def velocity(inv_mass, p, dense=None):
    """dq/dt = M^{-1} p."""
    if not _dense(inv_mass, p, dense):
        return inv_mass * p
    return torch.einsum("...ij,...j->...i", inv_mass, p)


def mass_sqrt(inv_mass, dense=None):
    """A factor S with S S^T = M, given M^{-1} (for momentum sampling).

    diag: S = 1/sqrt(inv_mass).  dense: with L = chol(M^{-1}),
    M = L^{-T} L^{-1}, so S = L^{-T}.  ``dense=None`` means dense for a 2-D
    ``inv_mass``."""
    if dense is None:
        dense = inv_mass.dim() == 2
    if not dense:
        return torch.rsqrt(inv_mass)
    l_inv = torch.linalg.cholesky(inv_mass)
    eye = torch.eye(inv_mass.shape[-1], dtype=inv_mass.dtype,
                    device=inv_mass.device).expand_as(l_inv)
    return torch.linalg.solve_triangular(l_inv, eye, upper=False) \
        .transpose(-1, -2)


def sample_momentum(eps, inv_mass, dense=None):
    """Momenta ~ N(0, M) from standard normals ``eps`` (..., D) drawn by the
    caller (randomness enters as an input)."""
    dense = _dense(inv_mass, eps, dense)
    s = mass_sqrt(inv_mass, dense)
    if not dense:
        return s * eps
    return torch.einsum("...ij,...j->...i", s, eps)
