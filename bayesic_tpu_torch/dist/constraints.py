"""Support constraints for distributions.

Counterpart of ``bayesic_tpu/dist/constraints.py``.  A ``Constraint``
describes the support of a distribution; ``biject_to`` (in
``transforms.py``) maps each continuous constraint to a bijector from R^n
onto it.  Discrete constraints have no bijector: a discrete site can only
be observed.
"""

from __future__ import annotations

import torch


class Constraint:
    """Base constraint. ``event_dim`` is the number of rightmost dims that
    form one event of the constrained value."""

    event_dim: int = 0
    is_discrete: bool = False

    def __call__(self, x):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__.lstrip("_") + "()"


class _Real(Constraint):
    def __call__(self, x):
        return torch.isfinite(x)


class _RealVector(Constraint):
    event_dim = 1

    def __call__(self, x):
        return torch.all(torch.isfinite(x), dim=-1)


class _Positive(Constraint):
    def __call__(self, x):
        return x > 0


class _Nonnegative(Constraint):
    def __call__(self, x):
        return x >= 0


class _UnitInterval(Constraint):
    def __call__(self, x):
        return (x >= 0) & (x <= 1)


class _Interval(Constraint):
    def __init__(self, low, high):
        self.low = low
        self.high = high

    def __call__(self, x):
        return (x >= self.low) & (x <= self.high)

    def __repr__(self):
        return f"Interval({self.low}, {self.high})"


class _GreaterThan(Constraint):
    def __init__(self, low):
        self.low = low

    def __call__(self, x):
        return x > self.low

    def __repr__(self):
        return f"GreaterThan({self.low})"


class _Simplex(Constraint):
    event_dim = 1

    def __call__(self, x):
        return torch.all(x >= 0, dim=-1) & (torch.abs(x.sum(-1) - 1.0) < 1e-6)


class _Ordered(Constraint):
    event_dim = 1

    def __call__(self, x):
        return torch.all(x[..., 1:] > x[..., :-1], dim=-1)


def _all_matrix(x):
    return torch.all(torch.all(x, dim=-1), dim=-1)


class _CorrCholesky(Constraint):
    """Lower-triangular with positive diagonal and unit-norm rows."""

    event_dim = 2

    def __call__(self, x):
        tril = _all_matrix(torch.triu(x, 1) == 0)
        pos_diag = torch.all(torch.diagonal(x, dim1=-2, dim2=-1) > 0, dim=-1)
        unit_row = torch.all(
            torch.abs(torch.sum(x * x, dim=-1) - 1.0) < 1e-5, dim=-1)
        return tril & pos_diag & unit_row


class _LowerCholesky(Constraint):
    event_dim = 2

    def __call__(self, x):
        tril = _all_matrix(torch.triu(x, 1) == 0)
        pos_diag = torch.all(torch.diagonal(x, dim1=-2, dim2=-1) > 0, dim=-1)
        return tril & pos_diag


class _RealMatrix(Constraint):
    event_dim = 2

    def __call__(self, x):
        return _all_matrix(torch.isfinite(x))


class _PositiveDefinite(Constraint):
    """Symmetric positive-definite matrices."""

    event_dim = 2

    def __call__(self, x):
        # a relative symmetry tolerance: float32 SPD matrices with entries
        # ~1e6 are symmetric only to ~1e-2, and an absolute 1e-5 would
        # accept meaningfully asymmetric tiny ones
        xt = x.transpose(-1, -2)
        sym = _all_matrix(torch.abs(x - xt) <= 1e-5 * (1.0 + torch.abs(x)))
        # cholesky_ex reports a non-PD matrix (info > 0) without raising
        chol, info = torch.linalg.cholesky_ex(x)
        return sym & (info == 0) & _all_matrix(torch.isfinite(chol))


class _Boolean(Constraint):
    is_discrete = True

    def __call__(self, x):
        return (x == 0) | (x == 1)


class _NonnegativeInteger(Constraint):
    is_discrete = True

    def __call__(self, x):
        return (x >= 0) & (x == torch.floor(x))


class _IntegerInterval(Constraint):
    is_discrete = True

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def __call__(self, x):
        return (x >= self.low) & (x <= self.high) & (x == torch.floor(x))

    def __repr__(self):
        return f"IntegerInterval({self.low}, {self.high})"


real = _Real()
real_vector = _RealVector()
positive = _Positive()
nonnegative = _Nonnegative()
unit_interval = _UnitInterval()
simplex = _Simplex()
ordered = _Ordered()
corr_cholesky = _CorrCholesky()
lower_cholesky = _LowerCholesky()
real_matrix = _RealMatrix()
positive_definite = _PositiveDefinite()
boolean = _Boolean()
nonnegative_integer = _NonnegativeInteger()
interval = _Interval
greater_than = _GreaterThan
integer_interval = _IntegerInterval
