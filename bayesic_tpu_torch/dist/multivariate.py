"""Multivariate families: MultivariateNormal, MultivariateStudentT,
MatrixNormal, Wishart, InverseWishart, Dirichlet, LKJCholesky.

Counterpart of ``bayesic_tpu/dist/multivariate.py``.  The linear algebra is
Cholesky-based (triangular solves, no explicit inverses), batched over
leading dims, and free of in-place writes, so the generic ``MCMC`` can run
a constrained matrix latent under ``vmap``.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from ._special import cholesky, multigammaln
from .continuous import _param_on, _standard_gamma
from .distribution import (Distribution, as_param, broadcast_shapes,
                           in_float64)

__all__ = ["MultivariateNormal", "MultivariateStudentT", "MatrixNormal",
           "Wishart", "InverseWishart", "Dirichlet", "LKJCholesky"]

_LOG_2PI = math.log(2.0 * math.pi)


def _solve_lower(tril, rhs):
    """tril^-1 rhs for lower-triangular ``tril``, batch dims broadcast."""
    batch = broadcast_shapes(tuple(tril.shape[:-2]), tuple(rhs.shape[:-2]))
    tril = tril.expand(batch + tuple(tril.shape[-2:]))
    rhs = rhs.expand(batch + tuple(rhs.shape[-2:]))
    return torch.linalg.solve_triangular(tril, rhs, upper=False)


def _half_log_det(tril):
    return torch.sum(torch.log(torch.diagonal(tril, dim1=-2, dim2=-1)), -1)


def _gram(tril):
    return tril @ tril.transpose(-1, -2)


def _right(a, n):
    """``a`` with ``n`` trailing unit dims, to broadcast against event
    dims; a 0-dim parameter (a float's, on the CPU) stays 0-dim, which
    broadcasts against tensors on any device."""
    return a.reshape(tuple(a.shape) + (1,) * n) if a.dim() else a


class MultivariateNormal(Distribution):
    """MVN parameterized by ``loc`` and lower-Cholesky ``scale_tril`` (or
    ``covariance_matrix``, factorized once at construction)."""

    _params = ("loc", "scale_tril")
    _param_event_ndims = {"loc": 1, "scale_tril": 2}
    support = constraints.real_vector

    def __init__(self, loc, scale_tril=None, covariance_matrix=None):
        if (scale_tril is None) == (covariance_matrix is None):
            raise ValueError("pass exactly one of scale_tril/covariance_matrix")
        if scale_tril is None:
            scale_tril = cholesky(as_param(covariance_matrix))
        self.loc = as_param(loc)
        self.scale_tril = as_param(scale_tril)
        d = self.scale_tril.shape[-1]
        batch = broadcast_shapes(tuple(self.loc.shape[:-1]),
                                 tuple(self.scale_tril.shape[:-2]))
        super().__init__(batch, (d,))

    def sample(self, generator, sample_shape=()):
        eps = torch.randn(self.shape(sample_shape), generator=generator,
                          device=generator.device, dtype=torch.float32)
        return self.loc + (self.scale_tril @ eps[..., None])[..., 0]

    @in_float64
    def log_prob(self, x):
        z = _solve_lower(self.scale_tril, (x - self.loc)[..., None])[..., 0]
        d = self.event_shape[0]
        return (-0.5 * torch.sum(z * z, -1) - _half_log_det(self.scale_tril)
                - 0.5 * d * _LOG_2PI)

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape + self.event_shape)

    @property
    def covariance(self):
        return _gram(self.scale_tril)

    @property
    def variance(self):
        return torch.sum(self.scale_tril ** 2, -1)

    def entropy(self):
        d = self.event_shape[0]
        return 0.5 * d * (1.0 + _LOG_2PI) + _half_log_det(self.scale_tril)


class Dirichlet(Distribution):
    _params = ("concentration",)
    _param_event_ndims = {"concentration": 1}
    support = constraints.simplex

    def __init__(self, concentration):
        self.concentration = torch.as_tensor(concentration,
                                             dtype=torch.float32)
        shape = tuple(self.concentration.shape)
        super().__init__(shape[:-1], shape[-1:])

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

    @property
    def mean(self):
        return self.concentration / torch.sum(self.concentration, -1,
                                              keepdim=True)

    @property
    def variance(self):
        a = self.concentration
        a0 = torch.sum(a, -1, keepdim=True)
        m = a / a0
        return m * (1.0 - m) / (a0 + 1.0)


class LKJCholesky(Distribution):
    """LKJ prior over Cholesky factors of correlation matrices.

    Density over the strict-lower coordinates of ``L``:
    ``p(L) ∝ prod_{i=2..d} L_ii^(d - i + 2 eta - 2)`` with the closed-form
    normalizer; samples by the onion method."""

    _params = ("concentration",)
    support = constraints.corr_cholesky
    reparametrized = False

    def __init__(self, dimension, concentration=1.0):
        self.dimension = int(dimension)
        self.concentration = as_param(concentration)
        super().__init__(tuple(self.concentration.shape),
                         (self.dimension, self.dimension))

    def sample(self, generator, sample_shape=()):
        d = self.dimension
        shape = tuple(sample_shape) + self.batch_shape
        dev = generator.device
        eta = _param_on(self.concentration, shape, generator)
        # row directions: normalized strict-lower Gaussian rows
        lower = torch.tril(torch.ones(d, d, dtype=torch.bool, device=dev), -1)
        z = torch.where(lower, torch.randn(shape + (d, d),
                                           generator=generator, device=dev),
                        0.0)
        norm = torch.sqrt(torch.sum(z * z, -1, keepdim=True))
        u = torch.where(lower, z / torch.clamp(norm, min=1e-30), 0.0)
        # squared radii y_k ~ Beta(k/2, eta + (d-1-k)/2) for rows 1..d-1
        k = torch.arange(1, d, dtype=torch.float32, device=dev)
        a = (0.5 * k).expand(shape + (d - 1,))
        b = eta[..., None] + 0.5 * (d - 1 - k)
        y = torch._sample_dirichlet(
            torch.stack([a, b], -1).contiguous(), generator=generator)[..., 0]
        rows = torch.cat([torch.zeros(shape + (1,), device=dev), y], -1)
        eye = torch.eye(d, dtype=torch.bool, device=dev)
        return torch.where(eye, torch.sqrt(1.0 - rows)[..., None],
                           u * torch.sqrt(rows)[..., None])

    @in_float64
    def log_prob(self, x):
        d = self.dimension
        eta = self.concentration
        diag = torch.diagonal(x, dim1=-2, dim2=-1)[..., 1:]
        order = torch.arange(2, d + 1, dtype=x.dtype, device=x.device)
        unnorm = torch.sum((d - order + 2.0 * _right(eta, 1) - 2.0)
                           * torch.log(diag), -1)
        # log normalizer of the LKJ density over the correlation matrix,
        # with the L -> R Jacobian folded into the exponent above
        k = torch.arange(1, d, dtype=x.dtype, device=x.device)
        log_c = torch.sum(
            0.5 * k * math.log(math.pi)
            + torch.lgamma(_right(eta, 1) + 0.5 * (d - 1 - k))
            - torch.lgamma(_right(eta, 1) + 0.5 * (d - 1)), -1)
        return unnorm - log_c


class MultivariateStudentT(Distribution):
    """Multivariate Student-t with ``df`` degrees of freedom, location
    ``loc`` and lower-Cholesky ``scale_tril``.  Sampling is the Gaussian
    scale mixture ``x = loc + L z sqrt(df / g)``, ``g ~ chi2(df)``,
    pathwise through the gamma sampler's implicit gradients."""

    _params = ("df", "loc", "scale_tril")
    _param_event_ndims = {"df": 0, "loc": 1, "scale_tril": 2}
    support = constraints.real_vector

    def __init__(self, df, loc, scale_tril):
        self.df = as_param(df)
        self.loc = as_param(loc)
        self.scale_tril = as_param(scale_tril)
        d = self.scale_tril.shape[-1]
        batch = broadcast_shapes(tuple(self.df.shape),
                                 tuple(self.loc.shape[:-1]),
                                 tuple(self.scale_tril.shape[:-2]))
        super().__init__(batch, (d,))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        z = torch.randn(shape + self.event_shape, generator=generator,
                        device=generator.device)
        df = _param_on(self.df, shape, generator)
        g = 2.0 * _standard_gamma(0.5 * df, generator)          # chi2(df)
        y = (self.scale_tril @ z[..., None])[..., 0]
        return self.loc + y * torch.sqrt(df / g)[..., None]

    @in_float64
    def log_prob(self, x):
        d = self.event_shape[0]
        z = _solve_lower(self.scale_tril, (x - self.loc)[..., None])[..., 0]
        quad = torch.sum(z * z, -1)
        df = self.df
        return (torch.lgamma(0.5 * (df + d)) - torch.lgamma(0.5 * df)
                - 0.5 * d * (torch.log(df) + math.log(math.pi))
                - _half_log_det(self.scale_tril)
                - 0.5 * (df + d) * torch.log1p(quad / df))

    @property
    def mean(self):
        # defined for df > 1
        return self.loc.expand(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        # defined for df > 2
        fac = _right(self.df / (self.df - 2.0), 1)
        return fac * torch.sum(self.scale_tril ** 2, -1)


class MatrixNormal(Distribution):
    """Matrix-variate normal MN(loc, U, V) with row covariance
    ``U = R R^T`` (``scale_tril_row``) and column covariance ``V = C C^T``
    (``scale_tril_column``).  ``log_prob`` takes two batched triangular
    solves, ``tr(V^-1 D^T U^-1 D) = ||R^-1 D C^-T||_F^2``."""

    _params = ("loc", "scale_tril_row", "scale_tril_column")
    _param_event_ndims = {"loc": 2, "scale_tril_row": 2,
                          "scale_tril_column": 2}
    support = constraints.real_matrix

    def __init__(self, loc, scale_tril_row, scale_tril_column):
        self.loc = as_param(loc)
        self.scale_tril_row = as_param(scale_tril_row)
        self.scale_tril_column = as_param(scale_tril_column)
        n = self.scale_tril_row.shape[-1]
        p = self.scale_tril_column.shape[-1]
        batch = broadcast_shapes(tuple(self.loc.shape[:-2]),
                                 tuple(self.scale_tril_row.shape[:-2]),
                                 tuple(self.scale_tril_column.shape[:-2]))
        super().__init__(batch, (n, p))

    def sample(self, generator, sample_shape=()):
        z = torch.randn(self.shape(sample_shape), generator=generator,
                        device=generator.device)
        return self.loc + self.scale_tril_row @ z \
            @ self.scale_tril_column.transpose(-1, -2)

    @in_float64
    def log_prob(self, x):
        n, p = self.event_shape
        e = _solve_lower(self.scale_tril_row, x - self.loc)       # R^-1 D
        f = _solve_lower(self.scale_tril_column, e.transpose(-1, -2))
        quad = torch.sum(f * f, (-2, -1))
        return (-0.5 * quad - p * _half_log_det(self.scale_tril_row)
                - n * _half_log_det(self.scale_tril_column)
                - 0.5 * n * p * _LOG_2PI)

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        u_diag = torch.sum(self.scale_tril_row ** 2, -1)
        v_diag = torch.sum(self.scale_tril_column ** 2, -1)
        return u_diag[..., :, None] * v_diag[..., None, :]


def _bartlett(generator, df, scale_tril, d, shape):
    """Lower-triangular Bartlett factor B with W = B B^T ~ Wishart(df, S),
    S = scale_tril scale_tril^T: B = L A, A lower-triangular with
    A_ii = sqrt(chi2(df - i)) and A_ij ~ N(0, 1) below the diagonal.  The
    gamma draws carry implicit gradients, so the sampler is pathwise."""
    dev = generator.device
    z = torch.randn(shape + (d, d), generator=generator, device=dev)
    lower = torch.tril(torch.ones(d, d, dtype=torch.bool, device=dev), -1)
    i = torch.arange(d, dtype=torch.float32, device=dev)
    half_df = (0.5 * (df[..., None] - i)).contiguous()       # chi2(df - i) / 2
    diag = torch.sqrt(2.0 * _standard_gamma(half_df, generator))
    eye = torch.eye(d, dtype=torch.bool, device=dev)
    a = torch.where(eye, diag[..., None], torch.where(lower, z, 0.0))
    return scale_tril @ a


class Wishart(Distribution):
    """Wishart(df, S) over symmetric positive-definite matrices,
    parameterized by the lower-Cholesky factor ``scale_tril`` of S.
    Sampling uses the Bartlett decomposition; ``log_prob`` is
    Cholesky-only: ``tr(S^-1 W) = ||L_s^-1 L_w||_F^2``."""

    _params = ("df", "scale_tril")
    _param_event_ndims = {"df": 0, "scale_tril": 2}
    support = constraints.positive_definite

    def __init__(self, df, scale_tril):
        self.df = as_param(df)
        self.scale_tril = as_param(scale_tril)
        d = self.scale_tril.shape[-1]
        batch = broadcast_shapes(tuple(self.df.shape),
                                 tuple(self.scale_tril.shape[:-2]))
        super().__init__(batch, (d, d))

    def sample(self, generator, sample_shape=()):
        d = self.event_shape[0]
        shape = tuple(sample_shape) + self.batch_shape
        df = _param_on(self.df, shape, generator)
        tril = self.scale_tril.expand(shape + (d, d))
        b = _bartlett(generator, df, tril, d, shape)
        return _gram(b)

    @in_float64
    def log_prob(self, x):
        d = self.event_shape[0]
        df = self.df
        lw = cholesky(x)
        m = _solve_lower(self.scale_tril, lw)
        trace = torch.sum(m * m, (-2, -1))
        logdet_w = 2.0 * _half_log_det(lw)
        logdet_s = 2.0 * _half_log_det(self.scale_tril)
        return (0.5 * (df - d - 1.0) * logdet_w - 0.5 * trace
                - 0.5 * df * (d * math.log(2.0) + logdet_s)
                - multigammaln(0.5 * df, d))

    @property
    def mean(self):
        return _right(self.df, 2) * _gram(self.scale_tril)

    @property
    def variance(self):
        s = _gram(self.scale_tril)
        diag = torch.diagonal(s, dim1=-2, dim2=-1)
        return _right(self.df, 2) * (
            s * s + diag[..., :, None] * diag[..., None, :])


class InverseWishart(Distribution):
    """InverseWishart(df, Psi) over SPD matrices, parameterized by the
    lower-Cholesky factor ``scale_tril`` of Psi.  Sampling inverts a
    Bartlett factor of Wishart(df, Psi^-1) without forming Psi^-1:
    ``W = L A^-T A^-1 L^T`` with A the identity-scale Bartlett factor."""

    _params = ("df", "scale_tril")
    _param_event_ndims = {"df": 0, "scale_tril": 2}
    support = constraints.positive_definite

    def __init__(self, df, scale_tril):
        self.df = as_param(df)
        self.scale_tril = as_param(scale_tril)
        d = self.scale_tril.shape[-1]
        batch = broadcast_shapes(tuple(self.df.shape),
                                 tuple(self.scale_tril.shape[:-2]))
        super().__init__(batch, (d, d))

    def sample(self, generator, sample_shape=()):
        d = self.event_shape[0]
        shape = tuple(sample_shape) + self.batch_shape
        df = _param_on(self.df, shape, generator)
        eye = torch.eye(d, device=generator.device).expand(shape + (d, d))
        a = _bartlett(generator, df, eye, d, shape)
        # B = L A^-T (B^T = A^-1 L^T: solve A B^T = L^T); W = B B^T
        tril = self.scale_tril.to(generator.device).expand(shape + (d, d))
        bt = _solve_lower(a, tril.transpose(-1, -2))
        return _gram(bt.transpose(-1, -2))

    @in_float64
    def log_prob(self, x):
        d = self.event_shape[0]
        df = self.df
        lw = cholesky(x)
        # tr(Psi W^-1) = ||L_w^-1 L_psi||_F^2
        m = _solve_lower(lw, self.scale_tril)
        trace = torch.sum(m * m, (-2, -1))
        logdet_w = 2.0 * _half_log_det(lw)
        logdet_psi = 2.0 * _half_log_det(self.scale_tril)
        return (0.5 * df * logdet_psi - 0.5 * trace
                - 0.5 * (df + d + 1.0) * logdet_w
                - 0.5 * df * d * math.log(2.0)
                - multigammaln(0.5 * df, d))

    @property
    def mean(self):
        # defined for df > d + 1
        d = self.event_shape[0]
        return _gram(self.scale_tril) / _right(self.df - d - 1.0, 2)

    @property
    def variance(self):
        # defined for df > d + 3 (the marginal variances)
        d = self.event_shape[0]
        psi = _gram(self.scale_tril)
        df = _right(self.df, 2)
        diag = torch.diagonal(psi, dim1=-2, dim2=-1)
        num = (df - d + 1.0) * psi * psi \
            + (df - d - 1.0) * diag[..., :, None] * diag[..., None, :]
        den = (df - d) * (df - d - 1.0) ** 2 * (df - d - 3.0)
        return num / den
