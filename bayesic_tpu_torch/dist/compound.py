"""Compound and overdispersed count families, the circular von Mises, the
Gaussian random walk, and the censoring and truncation wrappers.

Counterpart of ``bayesic_tpu/dist/compound.py``.  The one rejection
sampler (von Mises, Best & Fisher 1979) runs a fixed number of masked
proposal rounds and the generic truncation's bisection a fixed number of
steps, so no loop reads a value back to the host to decide whether to go
on.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from .continuous import _common, _dirichlet, _param_on, _uniform, _where
from .discrete import NegativeBinomial, Poisson, _float
from .distribution import (Distribution, _shape, as_param, broadcast_shapes,
                           in_float64)

__all__ = ["BetaBinomial", "Censored", "DirichletMultinomial",
           "GaussianRandomWalk", "Truncated",
           "VonMises", "ZeroInflatedDistribution", "ZeroInflatedPoisson",
           "ZeroInflatedNegativeBinomial"]


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _binomial_chain(generator, n, p):
    """Counts over the last axis of the probabilities ``p`` from ``n``
    trials (a float tensor of p's batch shape): a chain of conditional
    binomial draws on the generator's device."""
    rem_n = n
    rem_p = torch.ones_like(n)
    counts = []
    for j in range(p.shape[-1] - 1):
        pj = torch.clamp(p[..., j] / torch.clamp(rem_p, min=1e-37), 0.0, 1.0)
        cj = torch.binomial(rem_n, pj, generator=generator)
        counts.append(cj)
        rem_n = rem_n - cj
        rem_p = rem_p - p[..., j]
    counts.append(rem_n)
    return torch.stack(counts, -1).to(torch.int32)


class BetaBinomial(Distribution):
    """K ~ Binomial(n, p) with p ~ Beta(a, b) marginalised:
    P(k) = C(n, k) B(k + a, n - k + b) / B(a, b)."""

    _params = ("concentration1", "concentration0", "total_count")
    support = constraints.nonnegative_integer
    reparametrized = False

    def __init__(self, concentration1, concentration0, total_count):
        self.concentration1 = as_param(concentration1)
        self.concentration0 = as_param(concentration0)
        self.total_count = _float(total_count)
        super().__init__(broadcast_shapes(
            _shape(self.concentration1), _shape(self.concentration0),
            _shape(self.total_count)))

    def sample(self, generator, sample_shape=()):
        shape = self.shape(sample_shape)
        conc = torch.stack([
            _param_on(self.concentration1, shape, generator),
            _param_on(self.concentration0, shape, generator)], -1)
        p = _dirichlet(conc, generator)[..., 0]
        n = _param_on(self.total_count, shape, generator)
        return torch.binomial(n, p, generator=generator).to(torch.int32)

    @in_float64
    def log_prob(self, x):
        x = _float(x)
        n, a, b = self.total_count, self.concentration1, self.concentration0
        log_comb = (torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                    - torch.lgamma(n - x + 1.0))
        return log_comb + _betaln(x + a, n - x + b) - _betaln(a, b)

    @property
    def mean(self):
        a, b = self.concentration1, self.concentration0
        return self.total_count * a / (a + b)

    @property
    def variance(self):
        a, b = self.concentration1, self.concentration0
        n, s = self.total_count, self.concentration1 + self.concentration0
        return n * a * b * (n + s) / (s * s * (s + 1.0))


class DirichletMultinomial(Distribution):
    """counts ~ Multinomial(n, p) with p ~ Dirichlet(alpha) marginalised."""

    _params = ("concentration", "total_count")
    _param_event_ndims = {"concentration": 1}
    reparametrized = False

    def __init__(self, concentration, total_count):
        self.concentration = as_param(concentration)
        self.total_count = _float(total_count)
        super().__init__(
            broadcast_shapes(tuple(self.concentration.shape[:-1]),
                             _shape(self.total_count)),
            tuple(self.concentration.shape[-1:]))

    @property
    def support(self):
        return constraints.nonnegative_integer

    def sample(self, generator, sample_shape=()):
        """A Dirichlet draw, then a chain of conditional binomials (batched
        total counts work)."""
        shape = tuple(sample_shape) + self.batch_shape
        alpha = _param_on(self.concentration, shape + self.event_shape,
                          generator)
        p = _dirichlet(alpha, generator)
        n = _param_on(self.total_count, shape, generator)
        return _binomial_chain(generator, n, p)

    @in_float64
    def log_prob(self, x):
        x = _float(x)
        alpha = self.concentration
        n = self.total_count
        a0 = torch.sum(alpha, -1)
        return (torch.lgamma(n + 1.0) + torch.lgamma(a0)
                - torch.lgamma(n + a0)
                + torch.sum(torch.lgamma(x + alpha) - torch.lgamma(x + 1.0)
                            - torch.lgamma(alpha), -1))

    @property
    def mean(self):
        alpha = self.concentration
        n = self.total_count
        n = n[..., None] if n.dim() else n
        return n * alpha / torch.sum(alpha, -1, keepdim=True)


class GaussianRandomWalk(Distribution):
    """x_t = x_{t-1} + N(0, scale), x_0 ~ N(0, scale); event (num_steps,)."""

    _params = ("scale",)
    support = constraints.real_vector

    def __init__(self, scale=1.0, num_steps=1):
        self.scale = as_param(scale)
        self.num_steps = int(num_steps)
        super().__init__(_shape(self.scale), (self.num_steps,))

    def _scale_ev(self):
        return self.scale[..., None] if self.scale.dim() else self.scale

    def sample(self, generator, sample_shape=()):
        steps = torch.randn(self.shape(sample_shape), generator=generator,
                            device=generator.device)
        return self._scale_ev() * torch.cumsum(steps, -1)

    @in_float64
    def log_prob(self, x):
        scale = self._scale_ev()
        diffs = torch.diff(x, dim=-1, prepend=torch.zeros_like(x[..., :1]))
        z = diffs / scale
        return torch.sum(-0.5 * z * z - torch.log(scale)
                         - 0.5 * math.log(2 * math.pi), -1)

    @property
    def mean(self):
        return torch.zeros(self.batch_shape + self.event_shape,
                           device=self.scale.device)

    @property
    def variance(self):
        t = torch.arange(1, self.num_steps + 1, dtype=torch.float32,
                         device=self.scale.device)
        return self._scale_ev() ** 2 * t


class VonMises(Distribution):
    """Circular distribution on (-pi, pi]; density
    exp(kappa cos(x - loc)) / (2 pi I0(kappa))."""

    _params = ("loc", "concentration")
    support = constraints.interval(-math.pi, math.pi)
    reparametrized = False
    _REJECTION_ROUNDS = 32   # acceptance >= ~0.58: failure < 1e-11

    def __init__(self, loc, concentration):
        self.loc = as_param(loc)
        self.concentration = as_param(concentration)
        super().__init__(broadcast_shapes(_shape(self.loc),
                                          _shape(self.concentration)))

    def sample(self, generator, sample_shape=()):
        """Best & Fisher (1979) wrapped-Cauchy rejection over a fixed
        number of masked proposal rounds."""
        shape = self.shape(sample_shape)
        kappa = _param_on(self.concentration, shape, generator)
        # rho = (tau - sqrt(2 tau)) / (2 kappa) cancels in float32 below
        # kappa ~ 3e-4; the acceptance test is exact for any rho in (0, 1),
        # so the small-kappa series rho = k/2 + k^3/8 keeps it stable
        kk = torch.clamp(kappa, min=1e-6)
        tau = 1.0 + torch.sqrt(1.0 + 4.0 * kk ** 2)
        rho_exact = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kk)
        rho = torch.where(kk < 0.05, kk / 2.0 + kk ** 3 / 8.0, rho_exact)
        r = (1.0 + rho ** 2) / (2.0 * rho)
        x = torch.zeros(shape, device=generator.device)
        done = torch.zeros(shape, dtype=torch.bool, device=generator.device)
        for _ in range(self._REJECTION_ROUNDS):
            u1 = _uniform(generator, shape)
            u2 = _uniform(generator, shape)
            u3 = _uniform(generator, shape)
            z = torch.cos(math.pi * u1)
            f = (1.0 + r * z) / (r + z)
            c = kappa * (r - f)
            accept = (c * (2.0 - c) - u2 > 0) | (
                torch.log(c / torch.clamp(u2, min=1e-37)) + 1.0 - c >= 0)
            theta = torch.sign(u3 - 0.5) * torch.acos(
                torch.clamp(f, -1.0, 1.0))
            x = torch.where(done | ~accept, x, theta)
            done = done | accept
        # kappa ~ 0 is the uniform distribution on the circle (total
        # variation <= kappa / 2 < 5e-7 at the threshold)
        uni = math.pi * (2.0 * _uniform(generator, shape) - 1.0)
        x = torch.where(kappa < 1e-6, uni, x)
        out = x + _param_on(self.loc, shape, generator)
        return torch.remainder(out + math.pi, 2.0 * math.pi) - math.pi

    @in_float64
    def log_prob(self, x):
        kappa = self.concentration
        # log I0(k) = log(i0e(k)) + k, which does not overflow
        return (kappa * torch.cos(x - self.loc) - math.log(2 * math.pi)
                - torch.log(torch.special.i0e(kappa)) - kappa)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        k = self.concentration
        return 1.0 - torch.special.i1e(k) / torch.special.i0e(k)


class ZeroInflatedDistribution(Distribution):
    """Mixture of a point mass at zero (probability ``gate``) and any count
    ``base_dist``: P(0) = gate + (1 - gate) P_base(0);
    P(k > 0) = (1 - gate) P_base(k)."""

    _params = ("base_dist", "gate")
    reparametrized = False

    def __init__(self, base_dist, gate=None, gate_logits=None):
        if (gate is None) == (gate_logits is None):
            raise ValueError("pass exactly one of gate/gate_logits")
        self.base_dist = base_dist
        self.gate = as_param(gate) if gate is not None \
            else torch.sigmoid(as_param(gate_logits))
        super().__init__(broadcast_shapes(_shape(self.gate),
                                          base_dist.batch_shape))

    @property
    def support(self):
        return self.base_dist.support

    def sample(self, generator, sample_shape=()):
        base = self.base_dist.sample(generator, sample_shape)
        u = _uniform(generator, tuple(base.shape))
        return torch.where(u < self.gate, torch.zeros_like(base), base)

    @in_float64
    def log_prob(self, x):
        base_lp = self.base_dist.log_prob(x)
        log_gate = torch.log(self.gate)
        log1m = torch.log1p(-self.gate)
        at_zero = torch.logaddexp(*_common(log_gate, log1m + base_lp))
        return _where(x == 0, at_zero, log1m + base_lp)

    @property
    def mean(self):
        return (1.0 - self.gate) * self.base_dist.mean

    @property
    def variance(self):
        m, v = self.base_dist.mean, self.base_dist.variance
        return (1.0 - self.gate) * (v + self.gate * m * m)


def ZeroInflatedPoisson(gate, rate):
    return ZeroInflatedDistribution(Poisson(rate), gate=gate)


def ZeroInflatedNegativeBinomial(gate, total_count, probs=None, logits=None):
    return ZeroInflatedDistribution(
        NegativeBinomial(total_count, probs=probs, logits=logits), gate=gate)


class Censored(Distribution):
    """Censoring wrapper: observations recorded at a bound carry that
    tail's probability mass (Type-I censoring: survival analysis,
    detection limits).

    ``log_prob``: interior x -> the base density; x <= lower -> log
    F(lower); x >= upper -> log(1 - F(upper)).  Needs ``base_dist.cdf``.
    ``sample`` draws from the base and clips to the bounds (the observable
    quantity)."""

    _params = ("base_dist", "lower", "upper")
    reparametrized = False

    def __init__(self, base_dist, lower=None, upper=None):
        if lower is None and upper is None:
            raise ValueError("Censored needs at least one bound")
        if not hasattr(base_dist, "cdf"):
            raise ValueError(
                f"{type(base_dist).__name__} has no cdf; censoring needs it")
        self.base_dist = base_dist
        self.lower = None if lower is None else as_param(lower)
        self.upper = None if upper is None else as_param(upper)
        shapes = [base_dist.batch_shape] + [
            _shape(b) for b in (self.lower, self.upper) if b is not None]
        super().__init__(broadcast_shapes(*shapes), base_dist.event_shape)

    @property
    def support(self):
        return self.base_dist.support

    def sample(self, generator, sample_shape=()):
        x = self.base_dist.sample(generator, sample_shape)
        if self.lower is not None:
            x = torch.maximum(*_common(x, self.lower))
        if self.upper is not None:
            x = torch.minimum(*_common(x, self.upper))
        return x

    @in_float64
    def log_prob(self, x):
        # the base density at a value pushed inside the bounds, so that the
        # where never sees a NaN or inf gradient at a bound
        safe = x
        if self.lower is not None:
            safe = torch.maximum(*_common(safe, self.lower + 1e-6))
        if self.upper is not None:
            safe = torch.minimum(*_common(safe, self.upper - 1e-6))
        lp = self.base_dist.log_prob(safe)
        if self.lower is not None:
            mass = torch.clamp(self.base_dist.cdf(self.lower), 1e-37, 1.0)
            lp = _where(x <= self.lower, torch.log(mass), lp)
        if self.upper is not None:
            sf = torch.clamp(1.0 - self.base_dist.cdf(self.upper), 1e-37, 1.0)
            lp = _where(x >= self.upper, torch.log(sf), lp)
        return lp


class Truncated(Distribution):
    """Truncation of any scalar continuous ``base_dist`` with a ``cdf``:
    the density renormalized to [lower, upper], sampled by the inverse cdf
    of a uniform on [F(lower), F(upper)] (``base_dist.icdf``, else 60
    bisection steps on the cdf).

    For a truncated Normal prefer ``TruncatedNormal``."""

    _params = ("base_dist", "lower", "upper")
    _BISECTION_STEPS = 60

    def __init__(self, base_dist, lower=-math.inf, upper=math.inf):
        if not hasattr(base_dist, "cdf"):
            raise ValueError(
                f"{type(base_dist).__name__} has no cdf; truncation "
                "needs it")
        self.base_dist = base_dist
        self.lower = as_param(lower)
        self.upper = as_param(upper)
        super().__init__(broadcast_shapes(
            base_dist.batch_shape, _shape(self.lower), _shape(self.upper)),
            base_dist.event_shape)

    @property
    def support(self):
        return constraints.interval(self.lower, self.upper)

    def _bounds_cdf(self):
        lo_ok = torch.isfinite(self.lower)
        hi_ok = torch.isfinite(self.upper)
        flo = _where(lo_ok, self.base_dist.cdf(
            _where(lo_ok, self.lower, 0.0)), 0.0)
        fhi = _where(hi_ok, self.base_dist.cdf(
            _where(hi_ok, self.upper, 0.0)), 1.0)
        return flo, fhi

    def sample(self, generator, sample_shape=()):
        flo, fhi = self._bounds_cdf()
        shape = self.shape(sample_shape)
        u = 1e-7 + (1.0 - 2e-7) * _uniform(generator, shape)
        q = flo + u * (fhi - flo)
        if hasattr(self.base_dist, "icdf"):
            x = self.base_dist.icdf(q)
        else:
            lo = _where(torch.isfinite(self.lower), self.lower, -1e10)
            hi = _where(torch.isfinite(self.upper), self.upper, 1e10)
            lo, hi, q = _common(lo, hi, q)
            lo, hi = lo.expand(shape), hi.expand(shape)
            for _ in range(self._BISECTION_STEPS):
                mid = 0.5 * (lo + hi)
                below = self.base_dist.cdf(mid) < q
                lo = torch.where(below, mid, lo)
                hi = torch.where(below, hi, mid)
            x = 0.5 * (lo + hi)
        x = torch.maximum(*_common(x, self.lower))
        return torch.minimum(*_common(x, self.upper))

    @in_float64
    def log_prob(self, x):
        flo, fhi = self._bounds_cdf()
        log_norm = torch.log(torch.clamp(fhi - flo, 1e-37, 1.0))
        inside = (x >= self.lower) & (x <= self.upper)
        return _where(inside, self.base_dist.log_prob(x) - log_norm,
                      float("-inf"))
