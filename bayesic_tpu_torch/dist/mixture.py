"""Finite mixtures whose components' rightmost batch axis is the mixture
axis (MixtureSameFamily, the GMM's likelihood with the assignment
marginalised out).

Counterpart of ``bayesic_tpu/dist/mixture.py``.
"""

from __future__ import annotations

import torch

from .discrete import Categorical
from .distribution import Distribution, broadcast_shapes

__all__ = ["MixtureSameFamily"]


class MixtureSameFamily(Distribution):
    """``mixing`` is a Categorical over K; ``components`` a distribution
    whose rightmost batch dim is K (one slice per component)."""

    def __init__(self, mixing, components):
        if not isinstance(mixing, Categorical):
            raise TypeError("mixing must be a Categorical")
        k = components.batch_shape[-1]
        if mixing.num_categories != k:
            raise ValueError(
                f"mixing has {mixing.num_categories} categories but "
                f"components' mixture axis is {k}")
        self.mixing = mixing
        self.components = components
        super().__init__(broadcast_shapes(mixing.batch_shape,
                                          components.batch_shape[:-1]),
                         components.event_shape)

    @property
    def num_components(self):
        return self.components.batch_shape[-1]

    @property
    def support(self):
        return self.components.support

    reparametrized = False  # the discrete index breaks the pathwise gradient

    def log_prob(self, x):
        ev = len(self.components.event_shape)
        comp_lp = self.components.log_prob(x.unsqueeze(-1 - ev))  # (..., K)
        return torch.logsumexp(self.mixing.log_probs_normalized() + comp_lp,
                               -1)

    def sample(self, generator, sample_shape=()):
        idx = self.mixing.sample(generator, sample_shape).long()
        comps = self.components.sample(generator, sample_shape)
        # comps (..., batch, K, event): pick along the mixture axis
        ev = len(self.components.event_shape)
        idx = idx.reshape(idx.shape + (1,) * (1 + ev)).expand(
            idx.shape + (1,) + comps.shape[comps.dim() - ev:])
        return torch.gather(comps, -1 - ev, idx).squeeze(-1 - ev)

    @property
    def mean(self):
        ev = len(self.components.event_shape)
        w = self.mixing.probs
        w = w.reshape(tuple(w.shape) + (1,) * ev)
        return torch.sum(w * self.components.mean, -1 - ev)

    def expand(self, batch_shape):
        batch_shape = tuple(batch_shape)
        return MixtureSameFamily(
            self.mixing.expand(batch_shape),
            self.components.expand(batch_shape + (self.num_components,)))
