"""Discrete distribution families.

Counterpart of ``bayesic_tpu/dist/discrete.py``.  Discrete sites have no
bijector, so they can only be observed: ``core/logjoint`` refuses a latent
one (``support.is_discrete``).  Counts are cast to float before
``lgamma``/``xlogy``, as in the JAX package, so integer observations work;
draws come back as int32 on the generator's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import constraints
from .continuous import _common, _param_on, _standard_gamma, _uniform
from .distribution import (Distribution, _shape, as_param, broadcast_shapes,
                           in_float64)

__all__ = ["Bernoulli", "Binomial", "Categorical", "OrderedLogistic",
           "Poisson", "Geometric", "NegativeBinomial", "Multinomial"]


def _float(x):
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def _logits_from_probs(probs):
    probs = torch.as_tensor(probs, dtype=torch.float32) \
        if not isinstance(probs, torch.Tensor) else probs
    return torch.log(probs) - torch.log1p(-probs)


def _logits(probs, logits):
    if (probs is None) == (logits is None):
        raise ValueError("pass exactly one of probs/logits")
    return as_param(logits) if logits is not None \
        else _logits_from_probs(probs)


class Bernoulli(Distribution):
    """``Bernoulli(probs=p)`` or ``Bernoulli(logits=l)``; held as logits."""

    _params = ("logits",)
    support = constraints.boolean
    reparametrized = False

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

    @property
    def mean(self):
        return self.probs

    @property
    def variance(self):
        p = self.probs
        return p * (1.0 - p)


class Binomial(Distribution):
    _params = ("total_count", "logits")
    reparametrized = False

    def __init__(self, total_count, probs=None, logits=None):
        self.logits = _logits(probs, logits)
        self.total_count = _float(total_count)
        super().__init__(broadcast_shapes(_shape(self.total_count),
                                          _shape(self.logits)))

    @property
    def support(self):
        return constraints.integer_interval(0, self.total_count)

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, generator, sample_shape=()):
        shape = self.shape(sample_shape)
        n = _param_on(self.total_count, shape, generator)
        p = _param_on(self.probs, shape, generator)
        return torch.binomial(n, p, generator=generator).to(torch.int32)

    @in_float64
    def log_prob(self, x):
        x = _float(x)
        n = self.total_count
        log_comb = (torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                    - torch.lgamma(n - x + 1.0))
        # x log p + (n - x) log(1 - p) in logits form
        return log_comb + x * self.logits - n * F.softplus(self.logits)

    @property
    def mean(self):
        return self.total_count * self.probs

    @property
    def variance(self):
        p = self.probs
        return self.total_count * p * (1.0 - p)


class Categorical(Distribution):
    """``Categorical(probs=p)`` or ``Categorical(logits=l)`` over the last
    axis; held as logits (``log p`` for probs, as in the JAX package)."""

    _params = ("logits",)
    _param_event_ndims = {"logits": 1}
    reparametrized = False

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
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.logits = self.logits.expand(batch_shape
                                        + (self.num_categories,))
        new._batch_shape = batch_shape
        return new

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

    @property
    def mean(self):
        k = torch.arange(self.num_categories, dtype=self.logits.dtype,
                         device=self.logits.device)
        return torch.sum(self.probs * k, -1)


class OrderedLogistic(Categorical):
    """Ordinal regression likelihood: a latent logistic variable at
    ``predictor`` cut into ``K`` ordered categories by ``K-1`` ascending
    ``cutpoints``.

    ``P(Y = k) = sigmoid(c_k - eta) - sigmoid(c_{k-1} - eta)`` with
    ``c_{-1} = -inf`` and ``c_{K-1} = +inf``, computed in log space through
    ``sigmoid(a) - sigmoid(b) = sigmoid(a) sigmoid(-b) (1 - e^{b-a})``, so
    extreme predictors keep their linear logistic tails, and non-ascending
    cutpoints give NaN (the log of a negative difference) rather than a
    silently clipped density."""

    def __init__(self, predictor, cutpoints):
        pred = as_param(predictor)[..., None]
        cp = as_param(cutpoints)
        d = cp - pred                                          # (..., K-1)
        pad = torch.full(d.shape[:-1] + (1,), float("inf"), dtype=d.dtype,
                         device=d.device)
        upper = torch.cat([d, pad], -1)                        # c_k - eta
        lower = torch.cat([-pad, d], -1)                       # c_{k-1} - eta
        # the inf pads make the edge categories exact
        # (logsigmoid(inf) = 0, expm1(-inf) = -1)
        logits = (F.logsigmoid(upper) + F.logsigmoid(-lower)
                  + torch.log(-torch.expm1(lower - upper)))
        super().__init__(logits=logits)


class Poisson(Distribution):
    _params = ("rate",)
    support = constraints.nonnegative_integer
    reparametrized = False

    def __init__(self, rate):
        self.rate = as_param(rate)
        super().__init__(_shape(self.rate))

    def sample(self, generator, sample_shape=()):
        rate = _param_on(self.rate, self.shape(sample_shape), generator)
        return torch.poisson(rate, generator=generator).to(torch.int32)

    @in_float64
    def log_prob(self, x):
        xf, rate = _common(_float(x), self.rate)
        return torch.special.xlogy(xf, rate) - rate - torch.lgamma(xf + 1.0)

    @property
    def mean(self):
        return self.rate

    @property
    def variance(self):
        return self.rate


class Geometric(Distribution):
    """Number of failures before the first success; support {0, 1, ...}."""

    _params = ("logits",)
    support = constraints.nonnegative_integer
    reparametrized = False

    def __init__(self, probs=None, logits=None):
        self.logits = _logits(probs, logits)
        super().__init__(_shape(self.logits))

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, generator, sample_shape=()):
        u = _uniform(generator, self.shape(sample_shape), low=1e-7)
        # floor(log U / log(1 - p)) with log(1 - p) = -softplus(logits)
        return torch.floor(torch.log(u) / -F.softplus(self.logits)).to(
            torch.int32)

    @in_float64
    def log_prob(self, x):
        # k log(1 - p) + log p
        return -_float(x) * F.softplus(self.logits) \
            - F.softplus(-self.logits)

    @property
    def mean(self):
        p = self.probs
        return (1.0 - p) / p

    @property
    def variance(self):
        p = self.probs
        return (1.0 - p) / (p * p)


class NegativeBinomial(Distribution):
    """Failures before the r-th success:
    P(K = k) = C(k + r - 1, k) (1 - p)^r p^k with p = sigmoid(logits)."""

    _params = ("total_count", "logits")
    support = constraints.nonnegative_integer
    reparametrized = False

    def __init__(self, total_count, probs=None, logits=None):
        self.logits = _logits(probs, logits)
        self.total_count = _float(total_count)
        super().__init__(broadcast_shapes(_shape(self.total_count),
                                          _shape(self.logits)))

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, generator, sample_shape=()):
        # Gamma-Poisson mixture: lam ~ Gamma(r, (1 - p) / p), K ~ Poisson(lam)
        shape = self.shape(sample_shape)
        g = _standard_gamma(_param_on(self.total_count, shape, generator),
                            generator)
        lam = g * _param_on(torch.exp(self.logits), shape, generator)
        return torch.poisson(lam, generator=generator).to(torch.int32)

    @in_float64
    def log_prob(self, x):
        x = _float(x)
        r = self.total_count
        log_comb = torch.lgamma(x + r) - torch.lgamma(r) \
            - torch.lgamma(x + 1.0)
        # k log p + r log(1 - p)
        return (log_comb + x * -F.softplus(-self.logits)
                + r * -F.softplus(self.logits))

    @property
    def mean(self):
        return self.total_count * torch.exp(self.logits)

    @property
    def variance(self):
        return self.mean / torch.sigmoid(-self.logits)


class Multinomial(Distribution):
    """Counts over K categories from ``total_count`` trials; event dim 1."""

    _params = ("logits",)
    _param_event_ndims = {"logits": 1}
    reparametrized = False

    def __init__(self, total_count, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs/logits")
        self.total_count = int(total_count)
        self.logits = as_param(logits) if logits is not None \
            else torch.log(as_param(probs))
        super().__init__(tuple(self.logits.shape[:-1]),
                         (self.logits.shape[-1],))

    @property
    def support(self):
        return constraints.nonnegative_integer  # per coordinate; sums to n

    @property
    def probs(self):
        return torch.softmax(self.logits, -1)

    def sample(self, generator, sample_shape=()):
        # a chain of binomial splits over the K categories
        k = self.logits.shape[-1]
        shape = tuple(sample_shape) + self.batch_shape
        p = _param_on(self.probs, shape + (k,), generator)
        remaining = torch.full(shape, float(self.total_count),
                               device=generator.device)
        rem_p = torch.ones(shape, device=generator.device)
        counts = []
        for i in range(k - 1):
            cond_p = torch.clamp(p[..., i] / torch.clamp(rem_p, min=1e-12),
                                 0.0, 1.0)
            c = torch.binomial(remaining, cond_p, generator=generator)
            counts.append(c)
            remaining = remaining - c
            rem_p = rem_p - p[..., i]
        counts.append(remaining)
        return torch.stack(counts, -1).to(torch.int32)

    @in_float64
    def log_prob(self, x):
        x = _float(x)
        logp = self.logits - torch.logsumexp(self.logits, -1, keepdim=True)
        return (torch.lgamma(torch.tensor(self.total_count + 1.0,
                                          dtype=x.dtype))
                - torch.sum(torch.lgamma(x + 1.0), -1)
                + torch.sum(x * logp, -1))

    @property
    def mean(self):
        return self.total_count * self.probs
