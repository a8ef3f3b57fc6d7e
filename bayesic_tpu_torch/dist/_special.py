"""Functions the families need in a form torch does not provide: the
regularized incomplete beta function, the multivariate log-gamma without
``torch.mvlgamma``'s domain check, and a Cholesky factor without
``torch.linalg.cholesky``'s check (each check reads a value back to the
host, a sync a call on the card)."""

from __future__ import annotations

import math

import torch

# continued-fraction terms (each of two half-steps): with the symmetry
# swap the fraction converges within a few sqrt(max(a, b)) terms; 100
# reach float64 precision for a and b up to 10^4 (against scipy)
BETAINC_TERMS = 100
_TINY = 1e-300


def betainc(a, b, x):
    """I_x(a, b), batched over the broadcast of its arguments, by the
    modified Lentz continued fraction (Numerical Recipes' ``betacf``) with
    the swap I_x(a, b) = 1 - I_{1-x}(b, a) above the mean.  Runs in float64
    with a fixed number of terms (no value goes back to the host to decide
    when to stop) and returns the dtype of ``x``."""
    out_dtype = x.dtype if isinstance(x, torch.Tensor) else torch.float32
    ref = next((t for t in (x, a, b) if isinstance(t, torch.Tensor)), None)
    device = ref.device if ref is not None else None

    def f64(t):
        return torch.as_tensor(t, dtype=torch.float64, device=device)

    a, b, x = torch.broadcast_tensors(f64(a), f64(b), f64(x))
    swap = x > (a + 1.0) / (a + b + 2.0)
    p = torch.where(swap, b, a)
    q = torch.where(swap, a, b)
    xs = torch.clamp(torch.where(swap, 1.0 - x, x), 0.0, 1.0)
    # x^p (1-x)^q / (p B(p, q)); log(0) at the ends gives front = 0
    log_front = (torch.special.xlogy(p, xs) + torch.special.xlog1py(q, -xs)
                 - (torch.lgamma(p) + torch.lgamma(q) - torch.lgamma(p + q))
                 - torch.log(p))
    front = torch.exp(log_front)

    def fix(v):
        return torch.where(torch.abs(v) < _TINY, _TINY, v)

    qab, qap, qam = p + q, p + 1.0, p - 1.0
    c = torch.ones_like(xs)
    d = 1.0 / fix(1.0 - qab * xs / qap)
    h = d
    for m in range(1, BETAINC_TERMS + 1):
        m2 = 2.0 * m
        num = m * (q - m) * xs / ((qam + m2) * (p + m2))
        d = 1.0 / fix(1.0 + num * d)
        c = fix(1.0 + num / c)
        h = h * d * c
        num = -(p + m) * (qab + m) * xs / ((p + m2) * (qap + m2))
        d = 1.0 / fix(1.0 + num * d)
        c = fix(1.0 + num / c)
        h = h * d * c
    res = front * h
    res = torch.where(swap, 1.0 - res, res)
    res = torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, res))
    return res.to(out_dtype)


def multigammaln(a, d):
    """log Gamma_d(a) = d(d-1)/4 log(pi) + sum_{j<d} lgamma(a - j/2)."""
    a = torch.as_tensor(a)
    j = torch.arange(d, dtype=a.dtype, device=a.device)
    return (0.25 * d * (d - 1) * math.log(math.pi)
            + torch.sum(torch.lgamma(a[..., None] - 0.5 * j), -1))


def cholesky(x):
    """Lower Cholesky factor, NaN where ``x`` is not positive definite (as
    the JAX package's ``jnp.linalg.cholesky``)."""
    chol, info = torch.linalg.cholesky_ex(x)
    return torch.where((info == 0)[..., None, None], chol, float("nan"))
