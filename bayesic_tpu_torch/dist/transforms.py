"""Bijective transforms between unconstrained space and distribution
supports, with log-abs-det-Jacobians (the subset the ported paths need).

Counterpart of ``bayesic_tpu/dist/transforms.py``.  Conventions:

* ``forward(u)`` maps unconstrained -> constrained; ``inverse(x)`` the reverse.
* ``log_det_jacobian(u)`` returns ``log |det dF/du|``: elementwise for the
  scalar transforms, one value per event for ``StickBreaking`` and
  ``LowerCholeskyTransform``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import constraints

__all__ = ["Transform", "Identity", "Exp", "StickBreaking",
           "LowerCholeskyTransform", "biject_to"]


class Transform:
    """Base bijector."""

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
    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        return torch.log(torch.as_tensor(x, dtype=torch.float32))

    def log_det_jacobian(self, u):
        return u


class StickBreaking(Transform):
    """R^{K-1} -> K-simplex by stick breaking:
    z_k = sigmoid(u_k - log(K-1-k)), x_k = z_k prod_{j<k} (1 - z_j), and
    x_{K-1} the remainder.  The offsets put u = 0 on the uniform simplex."""

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


class LowerCholeskyTransform(Transform):
    """R^{m(m+1)/2} -> lower-triangular (m, m) with a positive (exp'd)
    diagonal.  The packed vector holds the lower triangle row by row
    (``torch.tril_indices`` order, the JAX package's ``jnp.tril_indices``),
    so entry (k, k) sits at k(k+1)/2 + k."""

    @staticmethod
    def _side(n):
        m = int((-1.0 + math.sqrt(1.0 + 8.0 * n)) / 2.0)
        if m * (m + 1) // 2 != n:
            raise ValueError(f"{n} is not a triangular number")
        return m

    def forward_shape(self, shape):
        m = self._side(shape[-1])
        return tuple(shape[:-1]) + (m, m)

    def inverse_shape(self, shape):
        m = shape[-1]
        return tuple(shape[:-2]) + (m * (m + 1) // 2,)

    def forward(self, u):
        m = self._side(u.shape[-1])
        row, col = torch.tril_indices(m, m, device=u.device)
        mat = u.new_zeros(u.shape[:-1] + (m, m))
        mat[..., row, col] = torch.where(row == col, torch.exp(u), u)
        return mat

    def inverse(self, x):
        m = x.shape[-1]
        row, col = torch.tril_indices(m, m, device=x.device)
        vec = x[..., row, col]
        return torch.where(row == col, torch.log(vec), vec)

    def log_det_jacobian(self, u):
        m = self._side(u.shape[-1])
        pos = torch.tensor([k * (k + 1) // 2 + k for k in range(m)],
                           device=u.device)
        return torch.sum(u[..., pos], -1)


def biject_to(constraint):
    """Map a Constraint to a Transform from unconstrained space onto it."""
    if isinstance(constraint, constraints._Real):
        return Identity()
    if isinstance(constraint, constraints._Positive):
        return Exp()
    if isinstance(constraint, constraints._Simplex):
        return StickBreaking()
    if isinstance(constraint, constraints._LowerCholesky):
        return LowerCholeskyTransform()
    raise ValueError(
        f"No bijector for constraint {constraint!r} "
        f"(only real, positive, simplex and lower_cholesky are ported)."
    )
