"""Distribution base class with batch and event shapes.

Counterpart of ``bayesic_tpu/dist/distribution.py``.  ``sample`` takes an
explicit ``torch.Generator`` (no global RNG); the noise is drawn on the
generator's device.  Parameters may be Python floats or tensors; a
family's tensors keep the device they were given, and a float (or a
0-dim CPU tensor made from one) broadcasts against tensors on any device.
"""

from __future__ import annotations

import functools

import torch

from . import constraints

__all__ = ["Distribution", "Independent", "Delta", "TransformedDistribution",
           "in_float64"]


def _shape(a):
    return tuple(a.shape) if isinstance(a, torch.Tensor) else ()


def broadcast_shapes(*shapes):
    return tuple(torch.broadcast_shapes(*shapes))


def as_param(a):
    """A family's parameter as a tensor: tensors stay as they are (device
    and dtype), Python numbers become 0-dim float32 tensors."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.tensor(a, dtype=torch.float32)


def _float_dtype(*xs):
    """float64 if any of the tensors is, else float32."""
    return torch.float64 if any(
        isinstance(x, torch.Tensor) and x.dtype == torch.float64
        for x in xs) else torch.float32


def in_float64(method):
    """Evaluate ``method(self, x)`` in float64 and return the result in the
    float dtype of ``x`` and the parameters (float32 unless one of them is
    float64).  A log-density that sums lgamma or log terms of size ~10
    into a value near 0 keeps its float32 rounding only if the terms are
    summed in float64: float32 lgamma and log differ by a few ulp between
    implementations (the card's libdevice, the CPU's), ~1e-6 absolute at
    that size, which is all of a value near 0."""
    @functools.wraps(method)
    def wrapper(self, x):
        x = torch.as_tensor(x)
        dtype = _float_dtype(x, *(getattr(self, n, None)
                                  for n in self._params))
        return method(self.to_float64(), x.to(torch.float64)).to(dtype)
    return wrapper


class Distribution:
    """Base class.

    Subclasses declare ``_params``, the attribute names of their
    parameters, and ``_param_event_ndims``, the rightmost dims of each that
    belong to one event, which :meth:`expand` keeps.
    """

    _params: tuple = ()
    _param_event_ndims: dict = {}
    reparametrized: bool = True
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

    @property
    def event_ndim(self):
        return len(self._event_shape)

    def shape(self, sample_shape=()):
        return tuple(sample_shape) + self._batch_shape + self._event_shape

    # -- core API ----------------------------------------------------------
    def sample(self, generator, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError

    def sample_and_log_prob(self, generator, sample_shape=()):
        x = self.sample(generator, sample_shape)
        return x, self.log_prob(x)

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    # -- structure helpers -------------------------------------------------
    def to_float64(self):
        """A copy whose floating parameters (and those of distribution-
        valued ones) are float64."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        for name in self._params:
            leaf = getattr(self, name)
            if isinstance(leaf, Distribution):
                setattr(new, name, leaf.to_float64())
            elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                setattr(new, name, leaf.to(torch.float64))
        return new

    def expand(self, batch_shape):
        """Broadcast this distribution's batch shape to ``batch_shape``
        (union semantics, as in the JAX package).  Parameters that are
        Python floats or 0-dim CPU tensors (a float's) stay as they are:
        they broadcast in ``log_prob`` and ``sample``, and so never pin the
        distribution to a device.  Distribution-valued parameters expand
        recursively."""
        batch_shape = broadcast_shapes(self.batch_shape, tuple(batch_shape))
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        for name in self._params:
            leaf = getattr(self, name)
            if isinstance(leaf, Distribution):
                setattr(new, name, leaf.expand(batch_shape))
            elif isinstance(leaf, torch.Tensor) and (
                    leaf.dim() > 0 or leaf.device.type != "cpu"):
                ev = self._param_event_ndims.get(name, 0)
                tail = tuple(leaf.shape[leaf.dim() - ev:]) if ev else ()
                setattr(new, name, leaf.expand(batch_shape + tail))
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
    def reparametrized(self):
        return self.base_dist.reparametrized

    @property
    def support(self):
        return self.base_dist.support

    def sample(self, generator, sample_shape=()):
        return self.base_dist.sample(generator, sample_shape)

    def log_prob(self, x):
        lp = self.base_dist.log_prob(x)
        return torch.sum(lp, dim=tuple(range(-self.ndims, 0)))

    @property
    def mean(self):
        return self.base_dist.mean

    @property
    def variance(self):
        return self.base_dist.variance

    def entropy(self):
        return torch.sum(self.base_dist.entropy(),
                         dim=tuple(range(-self.ndims, 0)))


class Delta(Distribution):
    """Point mass (the distribution of a ``deterministic`` site)."""

    _params = ("value",)

    def __init__(self, value, event_ndim=0):
        self.value = torch.as_tensor(value)
        shape = tuple(self.value.shape)
        split = len(shape) - event_ndim
        super().__init__(shape[:split], shape[split:])

    def sample(self, generator, sample_shape=()):
        return self.value.expand(self.shape(sample_shape))

    @in_float64
    def log_prob(self, x):
        lp = torch.where(x == self.value, 0.0, float("-inf"))
        if self.event_ndim:
            lp = torch.sum(lp, dim=tuple(range(-self.event_ndim, 0)))
        return lp

    def expand(self, batch_shape):
        batch_shape = broadcast_shapes(self.batch_shape, tuple(batch_shape))
        return Delta(self.value.expand(batch_shape + self.event_shape),
                     event_ndim=len(self.event_shape))

    @property
    def mean(self):
        return self.value

    @property
    def variance(self):
        return torch.zeros_like(self.value)


class TransformedDistribution(Distribution):
    """Pushforward of ``base_dist`` through ``transform`` (forward
    direction)."""

    _params = ("base_dist",)

    def __init__(self, base_dist, transform):
        self.base_dist = base_dist
        self.transform = transform
        base_event = base_dist.batch_shape + base_dist.event_shape
        out = transform.forward_shape(base_event)
        ev = max(transform.codomain_event_dim,
                 len(base_dist.event_shape) + (len(out) - len(base_event)))
        split = len(out) - ev
        super().__init__(out[:split], out[split:])

    @property
    def reparametrized(self):
        return self.base_dist.reparametrized

    @property
    def support(self):
        """The transform's codomain when it declares one, else the base's
        support (identity- or affine-like transforms), so that a
        transformed latent gets the bijector onto the image."""
        cod = self.transform.codomain
        return cod if cod is not None else self.base_dist.support

    def sample(self, generator, sample_shape=()):
        return self.transform.forward(
            self.base_dist.sample(generator, sample_shape))

    @in_float64
    def log_prob(self, x):
        u = self.transform.inverse(x)
        lp = self.base_dist.log_prob(u)
        ldj = self.transform.log_det_jacobian(u)
        # lp is reduced over the base's event dims and ldj over the
        # transform's domain_event_dim; dims that became event dims of this
        # distribution on top of those still need summing
        lp_extra = self.event_ndim - (
            len(self.base_dist.event_shape)
            + self.transform.codomain_event_dim
            - self.transform.domain_event_dim)
        if lp_extra > 0:
            lp = torch.sum(lp, dim=tuple(range(-lp_extra, 0)))
        ldj_extra = self.event_ndim - self.transform.codomain_event_dim
        if ldj_extra > 0:
            ldj = torch.sum(ldj, dim=tuple(range(-ldj_extra, 0)))
        return lp - ldj
