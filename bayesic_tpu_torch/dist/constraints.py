"""Support constraints for distributions (the subset the DLGM,
hierarchical-logistic, GMM and linear-regression paths need).

Counterpart of ``bayesic_tpu/dist/constraints.py``.  A ``Constraint``
describes the support of a distribution; ``biject_to`` (in
``transforms.py``) maps each constraint to a bijector from R^n onto it.
"""

from __future__ import annotations

import torch


class Constraint:
    """Base constraint (a predicate on values)."""

    is_discrete: bool = False

    def __call__(self, x):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__.lstrip("_") + "()"


class _Real(Constraint):
    def __call__(self, x):
        return torch.isfinite(x)


class _Positive(Constraint):
    def __call__(self, x):
        return x > 0


class _Simplex(Constraint):
    event_dim = 1

    def __call__(self, x):
        return torch.all(x >= 0, dim=-1) & (torch.abs(x.sum(-1) - 1.0) < 1e-6)


class _LowerCholesky(Constraint):
    event_dim = 2

    def __call__(self, x):
        tril = torch.all(torch.triu(x, 1) == 0, dim=-1).all(-1)
        pos_diag = torch.all(torch.diagonal(x, dim1=-2, dim2=-1) > 0, dim=-1)
        return tril & pos_diag


class _IntegerInterval(Constraint):
    is_discrete = True

    def __init__(self, low, high):
        self.low, self.high = low, high

    def __call__(self, x):
        return (x >= self.low) & (x <= self.high) & (x == torch.floor(x))

    def __repr__(self):
        return f"IntegerInterval({self.low}, {self.high})"


class _Boolean(Constraint):
    is_discrete = True

    def __call__(self, x):
        return (x == 0) | (x == 1)


real = _Real()
positive = _Positive()
simplex = _Simplex()
lower_cholesky = _LowerCholesky()
boolean = _Boolean()
integer_interval = _IntegerInterval
