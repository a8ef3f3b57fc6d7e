"""Bijective transforms between unconstrained space and distribution
supports, with log-abs-det-Jacobians (the subset the DLGM path needs).

Counterpart of ``bayesic_tpu/dist/transforms.py``.  Conventions:

* ``forward(u)`` maps unconstrained -> constrained; ``inverse(x)`` the reverse.
* ``log_det_jacobian(u)`` returns ``log |det dF/du|`` elementwise (both
  transforms here are scalar).
"""

from __future__ import annotations

import torch

from . import constraints

__all__ = ["Transform", "Identity", "Exp", "biject_to"]


class Transform:
    """Base bijector."""

    def forward(self, u):
        raise NotImplementedError

    def inverse(self, x):
        raise NotImplementedError

    def log_det_jacobian(self, u):
        raise NotImplementedError

    def inverse_shape(self, shape):
        return tuple(shape)

    def __repr__(self):
        return self.__class__.__name__ + "()"


class Identity(Transform):
    """Passes any value through unchanged, including a dict of tensors
    (a ``param`` site whose value is a module's parameters)."""

    def forward(self, u):
        return u

    def inverse(self, x):
        return x

    def log_det_jacobian(self, u):
        return torch.zeros_like(u)


class Exp(Transform):
    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        return torch.log(torch.as_tensor(x, dtype=torch.float32))

    def log_det_jacobian(self, u):
        return u


def biject_to(constraint):
    """Map a Constraint to a Transform from unconstrained space onto it."""
    if isinstance(constraint, constraints._Real):
        return Identity()
    if isinstance(constraint, constraints._Positive):
        return Exp()
    raise ValueError(
        f"No bijector for constraint {constraint!r} "
        f"(only real and positive are ported)."
    )
