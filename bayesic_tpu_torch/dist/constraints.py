"""Support constraints for distributions (the subset the DLGM and
hierarchical-logistic paths need).

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


class _Boolean(Constraint):
    is_discrete = True

    def __call__(self, x):
        return (x == 0) | (x == 1)


real = _Real()
positive = _Positive()
boolean = _Boolean()
