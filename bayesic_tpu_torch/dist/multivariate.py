"""Multivariate distribution families (Dirichlet, the GMM's weight
prior).

Counterpart of the Dirichlet in ``bayesic_tpu/dist/multivariate.py``.
"""

from __future__ import annotations

import torch

from . import constraints
from .distribution import Distribution

__all__ = ["Dirichlet"]


class Dirichlet(Distribution):
    support = constraints.simplex

    def __init__(self, concentration):
        self.concentration = torch.as_tensor(concentration,
                                             dtype=torch.float32)
        shape = tuple(self.concentration.shape)
        super().__init__(shape[:-1], shape[-1:])

    def expand(self, batch_shape):
        batch_shape = tuple(torch.broadcast_shapes(self.batch_shape,
                                                   tuple(batch_shape)))
        return Dirichlet(self.concentration.expand(batch_shape
                                                   + self.event_shape))

    def sample(self, generator, sample_shape=()):
        """Normalised standard-gamma draws on the generator's device."""
        conc = self.concentration.to(generator.device).expand(
            self.shape(sample_shape))
        g = torch._standard_gamma(conc.contiguous(), generator=generator)
        return g / g.sum(-1, keepdim=True)

    def log_prob(self, x):
        a = self.concentration
        return (torch.sum((a - 1.0) * torch.log(x), -1)
                + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1))
