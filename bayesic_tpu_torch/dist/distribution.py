"""Distribution base class with batch and event shapes.

Counterpart of ``bayesic_tpu/dist/distribution.py``.  ``sample`` takes an
explicit ``torch.Generator`` (no global RNG); the noise is drawn on the
generator's device.  Parameters may be Python floats or tensors.
"""

from __future__ import annotations

import torch

from . import constraints

__all__ = ["Distribution", "Independent"]


def _shape(a):
    return tuple(a.shape) if isinstance(a, torch.Tensor) else ()


def broadcast_shapes(*shapes):
    return tuple(torch.broadcast_shapes(*shapes))


class Distribution:
    """Base class.

    Subclasses declare ``_params``, the attribute names of their (scalar
    family) parameters, which :meth:`expand` broadcasts.
    """

    _params: tuple = ()
    support = constraints.real

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    # -- shapes ------------------------------------------------------------
    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    def shape(self, sample_shape=()):
        return tuple(sample_shape) + self._batch_shape + self._event_shape

    # -- core API ----------------------------------------------------------
    def sample(self, generator, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError

    # -- structure helpers -------------------------------------------------
    def expand(self, batch_shape):
        """Broadcast this distribution's batch shape to ``batch_shape``
        (union semantics, as in the JAX package).  Float parameters stay
        floats: they broadcast in ``log_prob`` and ``sample`` as they are,
        and so never pin the distribution to a device."""
        batch_shape = broadcast_shapes(self.batch_shape, tuple(batch_shape))
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        for name in self._params:
            leaf = getattr(self, name)
            if isinstance(leaf, torch.Tensor):
                setattr(new, name, leaf.expand(batch_shape))
        new._batch_shape = batch_shape
        return new

    def to_event(self, ndims=None):
        """Reinterpret the rightmost ``ndims`` batch dims as event dims."""
        if ndims is None:
            ndims = len(self.batch_shape)
        if ndims == 0:
            return self
        return Independent(self, ndims)

    def __repr__(self):
        return (
            f"{type(self).__name__}(batch_shape={self.batch_shape}, "
            f"event_shape={self.event_shape})"
        )


class Independent(Distribution):
    """Reinterpret the rightmost ``ndims`` batch dims of ``base`` as event
    dims: ``log_prob`` sums over them."""

    _params = ("base_dist",)

    def __init__(self, base_dist, ndims):
        if ndims > len(base_dist.batch_shape):
            raise ValueError(
                f"to_event({ndims}) exceeds batch rank "
                f"{len(base_dist.batch_shape)}")
        self.base_dist = base_dist
        self.ndims = ndims
        shape = base_dist.batch_shape
        split = len(shape) - ndims
        super().__init__(shape[:split], shape[split:] + base_dist.event_shape)

    def expand(self, batch_shape):
        batch_shape = broadcast_shapes(self.batch_shape, tuple(batch_shape))
        base_shape = batch_shape + self.event_shape[:self.ndims]
        return Independent(self.base_dist.expand(base_shape), self.ndims)

    @property
    def support(self):
        return self.base_dist.support

    def sample(self, generator, sample_shape=()):
        return self.base_dist.sample(generator, sample_shape)

    def log_prob(self, x):
        lp = self.base_dist.log_prob(x)
        return torch.sum(lp, dim=tuple(range(-self.ndims, 0)))
