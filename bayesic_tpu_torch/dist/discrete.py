"""Discrete distribution families (Bernoulli, for observed sites).

Counterpart of ``bayesic_tpu/dist/discrete.py``.  Discrete sites have no
bijector, so they can only be observed: ``core/logjoint`` refuses a latent
one (``constraints.boolean.is_discrete``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import constraints
from .distribution import Distribution, _shape

__all__ = ["Bernoulli"]


class Bernoulli(Distribution):
    """``Bernoulli(probs=p)`` or ``Bernoulli(logits=l)``; held as logits."""

    _params = ("logits",)
    support = constraints.boolean

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs/logits")
        if logits is None:
            probs = torch.as_tensor(probs, dtype=torch.float32)
            logits = torch.log(probs) - torch.log1p(-probs)
        self.logits = logits
        super().__init__(_shape(logits))

    @property
    def probs(self):
        return torch.sigmoid(torch.as_tensor(self.logits))

    def sample(self, generator, sample_shape=()):
        u = torch.rand(self.shape(sample_shape), generator=generator,
                       device=generator.device)
        return (u < self.probs).to(torch.int32)

    def log_prob(self, x):
        # x*l - softplus(l), valid for x in {0, 1}
        logits = torch.as_tensor(self.logits)
        return x * logits - F.softplus(logits)
