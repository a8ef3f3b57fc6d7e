"""Bijective transforms between unconstrained space and distribution
supports, with log-abs-det-Jacobians.

Counterpart of ``bayesic_tpu/dist/transforms.py``.  Conventions:

* ``forward(u)`` maps unconstrained -> constrained; ``inverse(x)`` the reverse.
* ``log_det_jacobian(u)`` returns ``log |det dF/du|`` with the transform's
  ``domain_event_dim`` rightmost dims reduced away.
* Shape-changing transforms implement ``forward_shape``/``inverse_shape``.

Every transform is written without in-place writes or data-dependent
control flow, so ``torch.func.vmap`` and ``grad`` run through it (the
generic ``MCMC`` evaluates the log-joint under both), and every constant
it makes lies on its input's device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import constraints
from ._special import cholesky

__all__ = [
    "Transform",
    "Identity",
    "Exp",
    "Softplus",
    "Sigmoid",
    "Interval",
    "Affine",
    "Ordered",
    "StickBreaking",
    "CorrCholesky",
    "LowerCholeskyTransform",
    "PositiveDefiniteTransform",
    "Chain",
    "biject_to",
]


def _log(a):
    return torch.log(a) if isinstance(a, torch.Tensor) else math.log(a)


def _tril_side(n):
    """m with m(m+1)/2 == n (a packed lower triangle with its diagonal)."""
    m = int((-1.0 + math.sqrt(1.0 + 8.0 * n)) / 2.0)
    if m * (m + 1) // 2 != n:
        raise ValueError(f"{n} is not a triangular number")
    return m


def _strict_tril_side(n):
    """m with m(m-1)/2 == n (a packed strict lower triangle)."""
    m = int((1.0 + math.sqrt(1.0 + 8.0 * n)) / 2.0)
    if m * (m - 1) // 2 != n:
        raise ValueError(f"bad corr-cholesky vector length {n}")
    return m


def _unpack(vec, m, offset):
    """The (m, m) matrix whose lower triangle from ``offset`` (0 with the
    diagonal, -1 without) holds ``vec`` row by row (``torch.tril_indices``
    order, the JAX package's ``jnp.tril_indices``) and whose other entries
    are 0.  A gather, not an indexed write, so it runs under vmap."""
    row, col = torch.tril_indices(m, m, offset=offset, device=vec.device)
    slot = torch.zeros(m * m, dtype=torch.long, device=vec.device)
    slot = slot.scatter(0, row * m + col,
                        torch.arange(1, row.numel() + 1, device=vec.device))
    padded = torch.cat([torch.zeros_like(vec[..., :1]), vec], -1)
    return torch.index_select(padded, -1, slot).reshape(
        vec.shape[:-1] + (m, m))


def _pack(mat, offset):
    m = mat.shape[-1]
    row, col = torch.tril_indices(m, m, offset=offset, device=mat.device)
    return torch.index_select(mat.flatten(-2), -1, row * m + col)


def _diag_positions(m, device):
    """Positions of the diagonal entries in a packed lower triangle:
    entry (k, k) sits at k(k+1)/2 + k."""
    k = torch.arange(m, device=device)
    return k * (k + 1) // 2 + k


class Transform:
    """Base bijector."""

    domain_event_dim: int = 0
    codomain_event_dim: int = 0

    @property
    def codomain(self):
        """Constraint describing the image of ``forward``, or ``None`` when
        it is the whole domain (identity, affine); used by
        ``TransformedDistribution.support``."""
        return None

    def forward(self, u):
        raise NotImplementedError

    def inverse(self, x):
        raise NotImplementedError

    def log_det_jacobian(self, u):
        raise NotImplementedError

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)

    def __call__(self, u):
        return self.forward(u)

    def __repr__(self):
        return self.__class__.__name__ + "()"


class Identity(Transform):
    """Passes any value through unchanged, including a dict of tensors
    (a ``param`` site whose value is a module's parameters)."""

    def forward(self, u):
        return u

    def inverse(self, x):
        return x

    def log_det_jacobian(self, u):
        return torch.zeros_like(u)


class Exp(Transform):
    @property
    def codomain(self):
        return constraints.positive

    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        x = torch.as_tensor(x)
        return torch.log(x if x.is_floating_point() else x.float())

    def log_det_jacobian(self, u):
        return u


class Softplus(Transform):
    @property
    def codomain(self):
        return constraints.positive

    def forward(self, u):
        return F.softplus(u)

    def inverse(self, x):
        # log(e^x - 1), computed stably
        return x + torch.log(-torch.expm1(-x))

    def log_det_jacobian(self, u):
        return F.logsigmoid(u)


class Sigmoid(Transform):
    @property
    def codomain(self):
        return constraints.unit_interval

    def forward(self, u):
        return torch.sigmoid(u)

    def inverse(self, x):
        return torch.log(x) - torch.log1p(-x)

    def log_det_jacobian(self, u):
        return F.logsigmoid(u) + F.logsigmoid(-u)


class Interval(Transform):
    """R -> (low, high) by a scaled sigmoid."""

    def __init__(self, low, high):
        self.low = low
        self.high = high

    @property
    def codomain(self):
        return constraints.interval(self.low, self.high)

    def forward(self, u):
        return self.low + (self.high - self.low) * torch.sigmoid(u)

    def inverse(self, x):
        z = (x - self.low) / (self.high - self.low)
        return torch.log(z) - torch.log1p(-z)

    def log_det_jacobian(self, u):
        return (_log(self.high - self.low) + F.logsigmoid(u)
                + F.logsigmoid(-u))

    def __repr__(self):
        return f"Interval({self.low}, {self.high})"


class Affine(Transform):
    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def forward(self, u):
        return self.loc + self.scale * u

    def inverse(self, x):
        return (x - self.loc) / self.scale

    def log_det_jacobian(self, u):
        scale = self.scale
        log_abs = torch.log(torch.abs(scale)) \
            if isinstance(scale, torch.Tensor) else math.log(abs(scale))
        return torch.zeros_like(u) + log_abs

    def __repr__(self):
        return f"Affine(loc={self.loc}, scale={self.scale})"


class Ordered(Transform):
    """R^n -> strictly increasing vectors: x0 = u0, x_k = x_{k-1} + exp(u_k)."""

    domain_event_dim = 1
    codomain_event_dim = 1

    @property
    def codomain(self):
        return constraints.ordered

    def forward(self, u):
        first = u[..., :1]
        rest = torch.cumsum(torch.exp(u[..., 1:]), -1)
        return torch.cat([first, first + rest], -1)

    def inverse(self, x):
        first = x[..., :1]
        diffs = torch.log(x[..., 1:] - x[..., :-1])
        return torch.cat([first, diffs], -1)

    def log_det_jacobian(self, u):
        return torch.sum(u[..., 1:], -1)


class StickBreaking(Transform):
    """R^{K-1} -> K-simplex by stick breaking:
    z_k = sigmoid(u_k - log(K-1-k)), x_k = z_k prod_{j<k} (1 - z_j), and
    x_{K-1} the remainder.  The offsets put u = 0 on the uniform simplex."""

    domain_event_dim = 1
    codomain_event_dim = 1

    @property
    def codomain(self):
        return constraints.simplex

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    @staticmethod
    def _offsets(u):
        # log(K-1-k) for k = 0..K-2, K-1 = u.shape[-1]
        k = u.shape[-1]
        return torch.log(torch.arange(k, 0, -1, dtype=u.dtype,
                                      device=u.device))

    def forward(self, u):
        t = u - self._offsets(u)
        z = torch.sigmoid(t)
        # exclusive remainders prod_{j<k} (1 - z_j), in log space
        log_rem = torch.cat([torch.zeros_like(t[..., :1]),
                             torch.cumsum(F.logsigmoid(-t), -1)], -1)
        return torch.cat([z * torch.exp(log_rem[..., :-1]),
                          torch.exp(log_rem[..., -1:])], -1)

    def inverse(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        rem = 1.0 - torch.cat([torch.zeros_like(x[..., :1]),
                               torch.cumsum(x[..., :-1], -1)], -1)[..., :-1]
        z = torch.clamp(x[..., :-1] / rem, 1e-30, 1.0 - 1e-7)
        return torch.log(z) - torch.log1p(-z) + self._offsets(z)

    def log_det_jacobian(self, u):
        t = u - self._offsets(u)
        log1mz = F.logsigmoid(-t)
        log_rem_excl = torch.cat([torch.zeros_like(t[..., :1]),
                                  torch.cumsum(log1mz[..., :-1], -1)], -1)
        return torch.sum(F.logsigmoid(t) + log1mz + log_rem_excl, -1)


class CorrCholesky(Transform):
    """R^{m(m-1)/2} -> Cholesky factor of a correlation matrix.

    The strict lower triangle is filled with tanh(u); each row is then
    stick-broken on its squared norm, so rows have unit norm and a
    positive diagonal (the Stan construction)."""

    domain_event_dim = 1
    codomain_event_dim = 2

    @property
    def codomain(self):
        return constraints.corr_cholesky

    def forward_shape(self, shape):
        m = _strict_tril_side(shape[-1])
        return tuple(shape[:-1]) + (m, m)

    def inverse_shape(self, shape):
        m = shape[-1]
        return tuple(shape[:-2]) + (m * (m - 1) // 2,)

    @staticmethod
    def _tmat(u):
        m = _strict_tril_side(u.shape[-1])
        return _unpack(torch.tanh(u), m, -1), m

    def forward(self, u):
        t, m = self._tmat(u)
        # s_ij = prod_{k<j} (1 - t_ik^2), an exclusive cumprod along each
        # row; t is 0 off the strict lower triangle, so it holds there too
        one_minus_t2 = 1.0 - t * t
        s = torch.cat([torch.ones_like(one_minus_t2[..., :, :1]),
                       torch.cumprod(one_minus_t2[..., :, :-1], -1)], -1)
        eye = torch.eye(m, dtype=torch.bool, device=u.device)
        lower = torch.tril(torch.ones(m, m, dtype=torch.bool,
                                      device=u.device), -1)
        root = torch.sqrt(s)
        return torch.where(lower, t * root, torch.where(eye, root, 0.0))

    def inverse(self, x):
        sq = x * x
        s = 1.0 - torch.cat([torch.zeros_like(sq[..., :, :1]),
                             torch.cumsum(sq[..., :, :-1], -1)], -1)
        t = x / torch.sqrt(torch.clamp(s, min=1e-30))
        return torch.atanh(torch.clamp(_pack(t, -1), -1 + 1e-7, 1 - 1e-7))

    def log_det_jacobian(self, u):
        t, m = self._tmat(u)
        # log(1 - t^2) is exactly 0 off the strict lower triangle, so the
        # per-row exclusive cumsum gives log s_ij wherever it is needed
        log1mt2 = torch.log(torch.clamp(1.0 - t * t, min=1e-30))
        log_s = torch.cat([torch.zeros_like(log1mt2[..., :, :1]),
                           torch.cumsum(log1mt2[..., :, :-1], -1)], -1)
        lower = torch.tril(torch.ones(m, m, dtype=torch.bool,
                                      device=u.device), -1)
        per_entry = torch.where(lower, log1mt2 + 0.5 * log_s, 0.0)
        return torch.sum(per_entry, (-2, -1))


class LowerCholeskyTransform(Transform):
    """R^{m(m+1)/2} -> lower-triangular (m, m) with a positive (exp'd)
    diagonal.  The packed vector holds the lower triangle row by row
    (``torch.tril_indices`` order, the JAX package's ``jnp.tril_indices``),
    so entry (k, k) sits at k(k+1)/2 + k."""

    domain_event_dim = 1
    codomain_event_dim = 2

    @property
    def codomain(self):
        return constraints.lower_cholesky

    def forward_shape(self, shape):
        m = _tril_side(shape[-1])
        return tuple(shape[:-1]) + (m, m)

    def inverse_shape(self, shape):
        m = shape[-1]
        return tuple(shape[:-2]) + (m * (m + 1) // 2,)

    def forward(self, u):
        m = _tril_side(u.shape[-1])
        is_diag = torch.zeros(u.shape[-1], dtype=torch.bool,
                              device=u.device)
        is_diag = is_diag.index_fill(0, _diag_positions(m, u.device), True)
        # exp only where it is kept: the other branch's gradient would
        # otherwise be 0 * exp(u), NaN where exp(u) overflows
        vec = torch.where(is_diag, torch.exp(torch.where(is_diag, u, 0.0)), u)
        return _unpack(vec, m, 0)

    def inverse(self, x):
        m = x.shape[-1]
        vec = _pack(x, 0)
        is_diag = torch.zeros(vec.shape[-1], dtype=torch.bool,
                              device=x.device)
        is_diag = is_diag.index_fill(0, _diag_positions(m, x.device), True)
        return torch.where(is_diag, torch.log(torch.where(is_diag, vec, 1.0)),
                           vec)

    def log_det_jacobian(self, u):
        m = _tril_side(u.shape[-1])
        return torch.sum(torch.index_select(
            u, -1, _diag_positions(m, u.device)), -1)


class PositiveDefiniteTransform(Transform):
    """R^{m(m+1)/2} -> symmetric positive-definite, by W = L L^T with L the
    ``LowerCholeskyTransform`` image.  The log-det adds the Jacobian of the
    outer-product map on lower-triangular coordinates,
    ``|det dW/dL| = 2^m prod_i L_ii^{m-i+1}`` (i 1-based), to the
    lower-Cholesky one; both are linear in the diagonal coordinates of
    ``u``."""

    domain_event_dim = 1
    codomain_event_dim = 2

    def __init__(self):
        self._chol = LowerCholeskyTransform()

    @property
    def codomain(self):
        return constraints.positive_definite

    def forward_shape(self, shape):
        return self._chol.forward_shape(shape)

    def inverse_shape(self, shape):
        return self._chol.inverse_shape(shape)

    def forward(self, u):
        tril = self._chol.forward(u)
        return tril @ tril.transpose(-1, -2)

    def inverse(self, x):
        return self._chol.inverse(cholesky(x))

    def log_det_jacobian(self, u):
        m = _tril_side(u.shape[-1])
        diag = torch.index_select(u, -1, _diag_positions(m, u.device))
        # lower-Cholesky ldj: sum_i u_ii; outer-product ldj: m log 2 +
        # sum_i (m - i + 1) log L_ii with log L_ii = u_ii
        weights = torch.arange(m, 0, -1, dtype=u.dtype, device=u.device) + 1.0
        return m * math.log(2.0) + torch.sum(weights * diag, -1)


class Chain(Transform):
    """Compose transforms: ``forward`` applies them left to right."""

    def __init__(self, *parts):
        self.parts = parts
        self.domain_event_dim = max(
            (p.domain_event_dim for p in parts), default=0)
        self.codomain_event_dim = max(
            (p.codomain_event_dim for p in parts), default=0)

    @property
    def codomain(self):
        return self.parts[-1].codomain if self.parts else None

    def forward(self, u):
        for p in self.parts:
            u = p.forward(u)
        return u

    def inverse(self, x):
        for p in reversed(self.parts):
            x = p.inverse(x)
        return x

    def log_det_jacobian(self, u):
        total = 0.0
        for p in self.parts:
            ldj = p.log_det_jacobian(u)
            reduce_dims = self.domain_event_dim - p.domain_event_dim
            if reduce_dims > 0:
                ldj = torch.sum(ldj, tuple(range(-reduce_dims, 0)))
            total = total + ldj
            u = p.forward(u)
        return total

    def forward_shape(self, shape):
        for p in self.parts:
            shape = p.forward_shape(shape)
        return shape

    def inverse_shape(self, shape):
        for p in reversed(self.parts):
            shape = p.inverse_shape(shape)
        return shape

    def __repr__(self):
        return "Chain(" + ", ".join(map(repr, self.parts)) + ")"


def biject_to(constraint):
    """Map a Constraint to a Transform from unconstrained space onto it
    (the JAX package's registry)."""
    c = constraints
    if isinstance(constraint, (c._Real, c._RealVector)):
        return Identity()
    if isinstance(constraint, (c._Positive, c._Nonnegative)):
        return Exp()
    if isinstance(constraint, c._GreaterThan):
        return Chain(Exp(), Affine(constraint.low, 1.0))
    if isinstance(constraint, c._UnitInterval):
        return Sigmoid()
    if isinstance(constraint, c._Interval):
        return Interval(constraint.low, constraint.high)
    if isinstance(constraint, c._Simplex):
        return StickBreaking()
    if isinstance(constraint, c._Ordered):
        return Ordered()
    if isinstance(constraint, c._CorrCholesky):
        return CorrCholesky()
    if isinstance(constraint, c._LowerCholesky):
        return LowerCholeskyTransform()
    if isinstance(constraint, c._RealMatrix):
        return Identity()
    if isinstance(constraint, c._PositiveDefinite):
        return PositiveDefiniteTransform()
    raise ValueError(
        f"No bijector for constraint {constraint!r} "
        f"(discrete constraints cannot be latent sites)."
    )
