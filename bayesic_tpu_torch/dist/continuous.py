"""Scalar continuous distribution families (Normal for the DLGM,
HalfNormal for the hierarchical-logistic scale).

Counterpart of ``bayesic_tpu/dist/continuous.py``.  This is the port's own
code, not ``torch.distributions``.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import Distribution, _shape, broadcast_shapes

__all__ = ["Normal", "HalfNormal"]

_LOG_2PI = math.log(2.0 * math.pi)


def _log(a):
    return torch.log(a) if isinstance(a, torch.Tensor) else math.log(a)


class Normal(Distribution):
    _params = ("loc", "scale")

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale
        super().__init__(broadcast_shapes(_shape(loc), _shape(scale)))

    def sample(self, generator, sample_shape=()):
        eps = torch.randn(self.shape(sample_shape), generator=generator,
                          device=generator.device, dtype=torch.float32)
        return self.loc + self.scale * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - 0.5 * _LOG_2PI


class HalfNormal(Distribution):
    """|N(0, scale)| on the positive reals; ``biject_to`` gives it Exp."""

    _params = ("scale",)
    support = constraints.positive

    def __init__(self, scale=1.0):
        self.scale = scale
        super().__init__(_shape(scale))

    def sample(self, generator, sample_shape=()):
        eps = torch.randn(self.shape(sample_shape), generator=generator,
                          device=generator.device, dtype=torch.float32)
        return torch.abs(self.scale * eps)

    def log_prob(self, x):
        z = x / self.scale
        return (math.log(2.0) - 0.5 * z * z - _log(self.scale)
                - 0.5 * _LOG_2PI)
