"""Scalar continuous distribution families.

Counterpart of ``bayesic_tpu/dist/continuous.py``.  This is the port's own
code, not ``torch.distributions``.  A family that the JAX package samples
pathwise samples pathwise here too: Normal-like families by location and
scale, Gamma, Beta and their relatives through the implicit gradients of
``torch._standard_gamma`` and of ``torch._sample_dirichlet`` (by
``torch._dirichlet_grad``).  Every draw lands on the generator's device;
every density, moment and cdf computes on the device of its tensors
(Python-float parameters are 0-dim tensors, which broadcast against
tensors on any device), the log-densities and cdfs in float64 inside
(``in_float64``).
"""

from __future__ import annotations

import math

import torch

from . import constraints
from ._special import betainc
from .distribution import (Distribution, _shape, as_param, broadcast_shapes,
                           in_float64)

__all__ = [
    "Normal",
    "LogNormal",
    "HalfNormal",
    "Cauchy",
    "HalfCauchy",
    "StudentT",
    "Laplace",
    "Exponential",
    "Gamma",
    "InverseGamma",
    "Beta",
    "Uniform",
    "TruncatedNormal",
    "Weibull",
    "Gumbel",
    "Pareto",
    "Chi2",
]

_LOG_2PI = math.log(2.0 * math.pi)
_EULER = 0.5772156649015329
_TINY = torch.finfo(torch.float32).tiny
_SQRT_HALF = math.sqrt(0.5)


def _log(a):
    return torch.log(a) if isinstance(a, torch.Tensor) else math.log(a)


def _bshape(*args):
    return broadcast_shapes(*(_shape(a) for a in args))


def _expand(a, shape):
    return as_param(a).expand(shape)


def _common(*xs):
    """``xs`` on one device: that of the first tensor that is not a 0-dim
    CPU tensor.  A 0-dim CPU parameter (a Python float's) broadcasts in
    arithmetic against tensors on any device; ``where``, ``maximum`` and
    the special functions get their operands moved here instead."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)
                and (x.dim() > 0 or x.device.type != "cpu")), None)
    if dev is None:
        return xs
    return tuple(x.to(dev) if isinstance(x, torch.Tensor)
                 and x.device != dev else x for x in xs)


def _where(cond, a, b):
    return torch.where(*_common(cond, a, b))


def _param_on(a, shape, generator):
    """A parameter broadcast to ``shape`` on the generator's device, in a
    floating dtype, contiguous (the samplers that take one value per
    draw)."""
    a = as_param(a)
    dtype = a.dtype if a.is_floating_point() else torch.float32
    return a.to(device=generator.device, dtype=dtype).expand(
        shape).contiguous()


def _uniform(generator, shape, low=0.0):
    """U(low, 1) float32 draws on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + (1.0 - low) * u if low else u


def _normal(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


def _exponential(generator, shape):
    """Exp(1) draws, kept off 0 (the support is open)."""
    return torch.clamp(torch.empty(shape, device=generator.device)
                       .exponential_(generator=generator), min=_TINY)


class _Dirichlet(torch.autograd.Function):
    """Dirichlet draws with implicit (pathwise) gradients in the
    concentration, as ``torch.distributions.Dirichlet.rsample`` gives them
    (``torch._sample_dirichlet`` alone has no derivative)."""

    @staticmethod
    def forward(ctx, conc, generator):
        x = torch._sample_dirichlet(conc, generator=generator)
        ctx.save_for_backward(x, conc)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, conc = ctx.saved_tensors
        total = conc.sum(-1, True).expand_as(conc)
        dx = torch._dirichlet_grad(x, conc, total)
        return dx * (grad - (x * grad).sum(-1, True)), None


def _dirichlet(conc, generator):
    return _Dirichlet.apply(conc, generator)


def _ndtr(x):
    """The standard normal cdf through erfc: ``torch.special.ndtr`` works
    as 0.5 (1 + erf), which rounds to 0 below about -5.9 in float32 (and
    -8.3 in float64), where the JAX package's ndtr keeps the tail."""
    return 0.5 * torch.special.erfc(-x * _SQRT_HALF)


def _standard_gamma(conc, generator):
    """Gamma(conc, 1) draws with implicit (pathwise) gradients in
    ``conc``, kept off 0 where float32 underflows."""
    return torch.clamp(torch._standard_gamma(conc, generator=generator),
                       min=_TINY)


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

    @property
    def mean(self):
        return _expand(self.loc, self.batch_shape)

    @property
    def variance(self):
        return _expand(as_param(self.scale) ** 2, self.batch_shape)

    def entropy(self):
        return _expand(0.5 * (1.0 + _LOG_2PI) + torch.log(
            as_param(self.scale)), self.batch_shape)

    def cdf(self, x):
        return _ndtr((x - self.loc) / self.scale)

    def icdf(self, q):
        return self.loc + self.scale * torch.special.ndtri(q)


class LogNormal(Distribution):
    _params = ("loc", "scale")
    support = constraints.positive

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = as_param(loc), as_param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, generator, sample_shape=()):
        eps = _normal(generator, self.shape(sample_shape))
        return torch.exp(self.loc + self.scale * eps)

    @in_float64
    def log_prob(self, x):
        logx = torch.log(x)
        z = (logx - self.loc) / self.scale
        return (-0.5 * z * z - torch.log(self.scale) - 0.5 * _LOG_2PI
                - logx)

    @property
    def mean(self):
        return torch.exp(self.loc + 0.5 * self.scale ** 2)

    @property
    def variance(self):
        s2 = self.scale ** 2
        return (torch.exp(s2) - 1.0) * torch.exp(2.0 * self.loc + s2)

    @in_float64
    def cdf(self, x):
        return _ndtr((torch.log(x) - self.loc) / self.scale)

    @in_float64
    def icdf(self, q):
        return torch.exp(self.loc + self.scale * torch.special.ndtri(q))


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

    @property
    def mean(self):
        return as_param(self.scale) * math.sqrt(2.0 / math.pi)

    @property
    def variance(self):
        return as_param(self.scale) ** 2 * (1.0 - 2.0 / math.pi)

    def cdf(self, x):
        return 2.0 * _ndtr(x / self.scale) - 1.0


class Cauchy(Distribution):
    _params = ("loc", "scale")

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = as_param(loc), as_param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, generator, sample_shape=()):
        u = _uniform(generator, self.shape(sample_shape))
        return self.loc + self.scale * torch.tan(math.pi * (u - 0.5))

    @in_float64
    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -math.log(math.pi) - torch.log(self.scale) - torch.log1p(z * z)

    @in_float64
    def cdf(self, x):
        return 0.5 + torch.atan((x - self.loc) / self.scale) / math.pi

    @in_float64
    def icdf(self, q):
        return self.loc + self.scale * torch.tan(math.pi * (q - 0.5))


class HalfCauchy(Distribution):
    _params = ("scale",)
    support = constraints.positive

    def __init__(self, scale=1.0):
        self.scale = as_param(scale)
        super().__init__(_bshape(self.scale))

    def sample(self, generator, sample_shape=()):
        # tan(pi u / 2) with u in (0, 1]: |tan(pi (u - 1/2))| in law, and
        # never 0 (the support is open)
        u = 1.0 - _uniform(generator, self.shape(sample_shape))
        return self.scale * torch.tan(0.5 * math.pi * u)

    @in_float64
    def log_prob(self, x):
        z = x / self.scale
        return (math.log(2.0 / math.pi) - torch.log(self.scale)
                - torch.log1p(z * z))

    @in_float64
    def cdf(self, x):
        return 2.0 * torch.atan(x / self.scale) / math.pi


class StudentT(Distribution):
    _params = ("df", "loc", "scale")

    def __init__(self, df, loc=0.0, scale=1.0):
        self.df, self.loc, self.scale = (as_param(df), as_param(loc),
                                         as_param(scale))
        super().__init__(_bshape(self.df, self.loc, self.scale))

    def sample(self, generator, sample_shape=()):
        # loc and scale are pathwise; df is not
        shape = self.shape(sample_shape)
        df = _param_on(self.df, shape, generator).detach()
        g = _standard_gamma(0.5 * df, generator)
        t = _normal(generator, shape) * torch.sqrt(0.5 * df / g)
        return self.loc + self.scale * t

    @in_float64
    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        half = 0.5 * (self.df + 1.0)
        return (torch.lgamma(half) - torch.lgamma(0.5 * self.df)
                - 0.5 * torch.log(self.df * math.pi) - torch.log(self.scale)
                - half * torch.log1p(z * z / self.df))

    @property
    def mean(self):
        return _where(self.df > 1, self.loc, math.nan)

    @property
    def variance(self):
        v = self.scale ** 2 * self.df / (self.df - 2.0)
        return _where(self.df > 2, v, math.nan)

    @in_float64
    def cdf(self, x):
        z = (x - self.loc) / self.scale
        ib = betainc(0.5 * self.df, 0.5, self.df / (self.df + z * z))
        return torch.where(z >= 0, 1.0 - 0.5 * ib, 0.5 * ib)


class Laplace(Distribution):
    _params = ("loc", "scale")

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = as_param(loc), as_param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, generator, sample_shape=()):
        # the difference of two Exp(1) draws is standard Laplace
        shape = self.shape(sample_shape)
        eps = _exponential(generator, shape) - _exponential(generator, shape)
        return self.loc + self.scale * eps

    @in_float64
    def log_prob(self, x):
        z = torch.abs(x - self.loc) / self.scale
        return -z - torch.log(2.0 * self.scale)

    @property
    def mean(self):
        return _expand(self.loc, self.batch_shape)

    @property
    def variance(self):
        return 2.0 * self.scale ** 2

    @in_float64
    def cdf(self, x):
        z = (x - self.loc) / self.scale
        return torch.where(z < 0, 0.5 * torch.exp(z),
                           1.0 - 0.5 * torch.exp(-z))


class Exponential(Distribution):
    _params = ("rate",)
    support = constraints.positive

    def __init__(self, rate=1.0):
        self.rate = as_param(rate)
        super().__init__(_bshape(self.rate))

    def sample(self, generator, sample_shape=()):
        return _exponential(generator, self.shape(sample_shape)) / self.rate

    @in_float64
    def log_prob(self, x):
        return torch.log(self.rate) - self.rate * x

    @property
    def mean(self):
        return 1.0 / self.rate

    @property
    def variance(self):
        return 1.0 / self.rate ** 2

    def entropy(self):
        return 1.0 - torch.log(self.rate)

    @in_float64
    def cdf(self, x):
        return -torch.expm1(-self.rate * x)

    @in_float64
    def icdf(self, q):
        return -torch.log1p(-q) / self.rate


class Gamma(Distribution):
    """Shape/rate parameterization.  Sampling is pathwise in
    ``concentration`` through ``torch._standard_gamma``'s implicit
    gradients."""

    _params = ("concentration", "rate")
    support = constraints.positive

    def __init__(self, concentration, rate=1.0):
        self.concentration, self.rate = as_param(concentration), \
            as_param(rate)
        super().__init__(_bshape(self.concentration, self.rate))

    def sample(self, generator, sample_shape=()):
        conc = _param_on(self.concentration, self.shape(sample_shape),
                         generator)
        return _standard_gamma(conc, generator) / self.rate

    @in_float64
    def log_prob(self, x):
        a, b = self.concentration, self.rate
        return (a * torch.log(b) + (a - 1.0) * torch.log(x) - b * x
                - torch.lgamma(a))

    @property
    def mean(self):
        return self.concentration / self.rate

    @property
    def variance(self):
        return self.concentration / self.rate ** 2

    @in_float64
    def cdf(self, x):
        return torch.special.gammainc(*_common(self.concentration,
                                               self.rate * x))


class InverseGamma(Distribution):
    _params = ("concentration", "scale")
    support = constraints.positive

    def __init__(self, concentration, scale=1.0):
        self.concentration, self.scale = as_param(concentration), \
            as_param(scale)
        super().__init__(_bshape(self.concentration, self.scale))

    def sample(self, generator, sample_shape=()):
        conc = _param_on(self.concentration, self.shape(sample_shape),
                         generator)
        return self.scale / _standard_gamma(conc, generator)

    @in_float64
    def log_prob(self, x):
        a, b = self.concentration, self.scale
        return (a * torch.log(b) - (a + 1.0) * torch.log(x) - b / x
                - torch.lgamma(a))

    @property
    def mean(self):
        a = self.concentration
        return _where(a > 1, self.scale / (a - 1.0), math.nan)


class Beta(Distribution):
    _params = ("concentration1", "concentration0")
    support = constraints.unit_interval

    def __init__(self, concentration1, concentration0):
        self.concentration1 = as_param(concentration1)
        self.concentration0 = as_param(concentration0)
        super().__init__(_bshape(self.concentration1, self.concentration0))

    def sample(self, generator, sample_shape=()):
        # a two-component Dirichlet: pathwise in both concentrations
        shape = self.shape(sample_shape)
        conc = torch.stack([_param_on(self.concentration1, shape, generator),
                            _param_on(self.concentration0, shape,
                                      generator)], -1)
        return _dirichlet(conc, generator)[..., 0]

    @in_float64
    def log_prob(self, x):
        a, b = self.concentration1, self.concentration0
        return ((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x)
                - (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)))

    @property
    def mean(self):
        a, b = self.concentration1, self.concentration0
        return a / (a + b)

    @property
    def variance(self):
        a, b = self.concentration1, self.concentration0
        t = a + b
        return a * b / (t * t * (t + 1.0))

    @in_float64
    def cdf(self, x):
        return betainc(self.concentration1, self.concentration0, x)


class Uniform(Distribution):
    _params = ("low", "high")

    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = as_param(low), as_param(high)
        super().__init__(_bshape(self.low, self.high))

    @property
    def support(self):
        return constraints.interval(self.low, self.high)

    def sample(self, generator, sample_shape=()):
        u = _uniform(generator, self.shape(sample_shape))
        return self.low + (self.high - self.low) * u

    @in_float64
    def log_prob(self, x):
        lp = -torch.log(self.high - self.low)
        inside = (x >= self.low) & (x <= self.high)
        return _where(inside, lp, float("-inf"))

    @property
    def mean(self):
        return 0.5 * (self.low + self.high)

    @property
    def variance(self):
        return (self.high - self.low) ** 2 / 12.0

    @in_float64
    def cdf(self, x):
        return torch.clamp((x - self.low) / (self.high - self.low), 0.0, 1.0)

    @in_float64
    def icdf(self, q):
        return self.low + q * (self.high - self.low)


class TruncatedNormal(Distribution):
    """Normal(loc, scale) truncated to [low, high] (either may be +-inf)."""

    _params = ("loc", "scale", "low", "high")

    def __init__(self, loc=0.0, scale=1.0, low=-math.inf, high=math.inf):
        self.loc, self.scale = as_param(loc), as_param(scale)
        self.low, self.high = as_param(low), as_param(high)
        super().__init__(_bshape(self.loc, self.scale, self.low, self.high))

    @property
    def support(self):
        return constraints.interval(self.low, self.high)

    def _alpha_beta(self):
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        return a, b

    def sample(self, generator, sample_shape=()):
        """Inverse cdf in float64 on the side of the window away from the
        far upper tail (a window above the mean is drawn as its mirror
        image below it), so windows many scales out keep their mass."""
        a, b = self._alpha_beta()
        shape = self.shape(sample_shape)
        a64, b64 = a.double(), b.double()
        u = torch.rand(shape, generator=generator, device=generator.device,
                       dtype=torch.float64)
        a64, b64, u = _common(a64, b64, u)
        flip = a64 > 0
        lo = torch.where(flip, -b64, a64)
        hi = torch.where(flip, -a64, b64)
        plo, phi = _ndtr(lo), _ndtr(hi)
        z = torch.special.ndtri(plo + u * (phi - plo))
        z = torch.where(flip, -z, z)
        z = torch.minimum(torch.maximum(z, a64), b64)
        return self.loc + self.scale * z.to(torch.float32)

    @in_float64
    def log_prob(self, x):
        a, b = self._alpha_beta()
        z = (x - self.loc) / self.scale
        log_ndtr = torch.special.log_ndtr

        # the mass ndtr(b) - ndtr(a) on whichever side conditions better:
        # the cdf form cancels in float32 for windows far above the mean
        # (log_ndtr ~ -1e-19 rounds to 1 through exp), where the survival
        # form sf(a) - sf(b) has well-scaled logs
        def log_diff(log_big, log_small):
            return log_big + torch.log1p(
                -torch.exp(torch.clamp(log_small - log_big, max=0.0)))

        log_mass_cdf = log_diff(log_ndtr(b), log_ndtr(a))
        log_mass_sf = log_diff(log_ndtr(-a), log_ndtr(-b))
        log_norm = _where(a > 0, log_mass_sf, log_mass_cdf)
        lp = -0.5 * z * z - 0.5 * _LOG_2PI - torch.log(self.scale) - log_norm
        inside = (x >= self.low) & (x <= self.high)
        return _where(inside, lp, float("-inf"))


class Weibull(Distribution):
    _params = ("scale", "concentration")
    support = constraints.positive

    def __init__(self, scale, concentration):
        self.scale, self.concentration = as_param(scale), \
            as_param(concentration)
        super().__init__(_bshape(self.scale, self.concentration))

    def sample(self, generator, sample_shape=()):
        u = _uniform(generator, self.shape(sample_shape), low=1e-7)
        return self.scale * (-torch.log(u)) ** (1.0 / self.concentration)

    @in_float64
    def log_prob(self, x):
        k, lam = self.concentration, self.scale
        z = x / lam
        return torch.log(k / lam) + (k - 1.0) * torch.log(z) - z ** k

    @property
    def mean(self):
        return self.scale * torch.exp(
            torch.lgamma(1.0 + 1.0 / self.concentration))

    @in_float64
    def cdf(self, x):
        return -torch.expm1(-((x / self.scale) ** self.concentration))

    @in_float64
    def icdf(self, q):
        return self.scale * (-torch.log1p(-q)) ** (1.0 / self.concentration)


class Gumbel(Distribution):
    _params = ("loc", "scale")

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = as_param(loc), as_param(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, generator, sample_shape=()):
        u = torch.clamp(_uniform(generator, self.shape(sample_shape)),
                        min=_TINY)
        return self.loc - self.scale * torch.log(-torch.log(u))

    @in_float64
    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)

    @property
    def mean(self):
        return self.loc + self.scale * _EULER

    @property
    def variance(self):
        return (math.pi ** 2 / 6.0) * self.scale ** 2

    @in_float64
    def cdf(self, x):
        return torch.exp(-torch.exp(-(x - self.loc) / self.scale))

    @in_float64
    def icdf(self, q):
        return self.loc - self.scale * torch.log(-torch.log(q))


class Pareto(Distribution):
    """P(X > x) = (scale / x)^alpha for x >= scale."""

    _params = ("scale", "alpha")

    def __init__(self, scale, alpha):
        self.scale, self.alpha = as_param(scale), as_param(alpha)
        super().__init__(_bshape(self.scale, self.alpha))

    @property
    def support(self):
        return constraints.greater_than(self.scale)

    def sample(self, generator, sample_shape=()):
        e = _exponential(generator, self.shape(sample_shape))
        x = self.scale * torch.exp(e / self.alpha)
        # float32 rounds a draw within one ulp of the scale (probability
        # ~alpha 2^-24) onto it; the support is open there
        lo = torch.nextafter(*_common(as_param(self.scale).detach(),
                                      x.new_tensor(math.inf)))
        return torch.maximum(*_common(x, lo))

    @in_float64
    def log_prob(self, x):
        return (torch.log(self.alpha) + self.alpha * torch.log(self.scale)
                - (self.alpha + 1.0) * torch.log(x))

    @property
    def mean(self):
        return _where(self.alpha > 1,
                      self.alpha * self.scale / (self.alpha - 1.0), math.inf)

    @in_float64
    def cdf(self, x):
        return 1.0 - (self.scale / x) ** self.alpha


class Chi2(Gamma):
    def __init__(self, df):
        # df is derived (df = 2 concentration), so the parameters stay
        # exactly Gamma's
        super().__init__(0.5 * as_param(df), 0.5)

    @property
    def df(self):
        return 2.0 * self.concentration

