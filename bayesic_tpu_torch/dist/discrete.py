"""Discrete distribution families (Bernoulli and Categorical, for observed
sites and as a mixture's weights).

Counterpart of ``bayesic_tpu/dist/discrete.py``.  Discrete sites have no
bijector, so they can only be observed: ``core/logjoint`` refuses a latent
one (``constraints.boolean.is_discrete``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import constraints
from .distribution import Distribution, _shape

__all__ = ["Bernoulli", "Categorical"]


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


class Categorical(Distribution):
    """``Categorical(probs=p)`` or ``Categorical(logits=l)`` over the last
    axis; held as logits (``log p`` for probs, as in the JAX package)."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs/logits")
        self.logits = torch.as_tensor(logits) if logits is not None \
            else torch.log(torch.as_tensor(probs))
        super().__init__(tuple(self.logits.shape[:-1]))

    @property
    def support(self):
        return constraints.integer_interval(0, self.num_categories - 1)

    @property
    def num_categories(self):
        return self.logits.shape[-1]

    @property
    def probs(self):
        return torch.softmax(self.logits, -1)

    def log_probs_normalized(self):
        return self.logits - torch.logsumexp(self.logits, -1, keepdim=True)

    def expand(self, batch_shape):
        batch_shape = tuple(torch.broadcast_shapes(self.batch_shape,
                                                   tuple(batch_shape)))
        return Categorical(logits=self.logits.expand(
            batch_shape + (self.num_categories,)))

    def sample(self, generator, sample_shape=()):
        shape = self.shape(sample_shape)
        p = self.probs.to(generator.device).expand(
            shape + (self.num_categories,)).reshape(-1, self.num_categories)
        idx = torch.multinomial(p, 1, generator=generator)
        return idx.reshape(shape).to(torch.int32)

    def log_prob(self, x):
        logp = self.log_probs_normalized()
        x = torch.as_tensor(x, device=logp.device).long()
        shape = torch.broadcast_shapes(x.shape, self.batch_shape)
        logp = logp.expand(tuple(shape) + (self.num_categories,))
        return torch.gather(logp, -1, x.expand(shape)[..., None])[..., 0]
