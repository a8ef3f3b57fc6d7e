"""Model comparison: WAIC and PSIS-LOO cross-validation.

Counterpart of ``bayesic_tpu/utils/compare.py`` (a copy: the port imports
nothing of the JAX package), on the pointwise log-likelihood of
:func:`bayesic_tpu_torch.infer.loglik.log_likelihood`:

* :func:`waic`: the widely applicable information criterion (Watanabe
  2010; the Gelman/Hwang/Vehtari 2014 form).
* :func:`psis_loo`: Pareto-smoothed importance-sampling leave-one-out
  cross-validation (Vehtari, Gelman & Gabry 2017), with each datapoint's
  Pareto shape k.
* :func:`compare`: models ranked by elpd with paired difference SEs.

Host-side diagnostics, run once a fit: the inputs (torch tensors on any
device, or numpy arrays) are brought to the host and everything computes
in float64 numpy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

__all__ = ["ELPDResult", "waic", "psis_loo", "compare"]


class ELPDResult(NamedTuple):
    """Expected log pointwise predictive density estimate."""

    elpd: float            # sum over datapoints
    se: float              # sqrt(N * var(pointwise))
    p_eff: float           # effective number of parameters
    pointwise: np.ndarray  # (N,) per-datapoint elpd contributions
    pareto_k: Optional[np.ndarray]  # (N,) PSIS shape diagnostic (LOO only)
    n_samples: int
    n_points: int
    method: str            # "waic" | "psis_loo"


def _host(a):
    """A torch tensor (any device) or array-like -> a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _as_matrix(loglik):
    """dict of (S, *batch) arrays or a single array -> (S, N) matrix."""
    if isinstance(loglik, dict):
        parts = [_host(v).reshape(_host(v).shape[0], -1)
                 for v in loglik.values()]
        ll = np.concatenate(parts, axis=1)
    else:
        ll = _host(loglik)
        ll = ll.reshape(ll.shape[0], -1)
    if not np.all(np.isfinite(ll)):
        raise ValueError("log-likelihood matrix contains non-finite values")
    return ll.astype(np.float64)


def _logsumexp(a, axis=0):
    amax = np.max(a, axis=axis, keepdims=True)
    out = np.log(np.sum(np.exp(a - amax), axis=axis)) + np.squeeze(amax, axis)
    return out


def waic(loglik) -> ELPDResult:
    """WAIC from a (num_samples, num_points) pointwise log-likelihood
    matrix (or dict of per-site arrays, flattened and concatenated).

    elpd_i = lppd_i − p_i with lppd_i = log mean_s exp(ll_si) and
    p_i = var_s(ll_si); se = sqrt(N · var_i(elpd_i)).
    """
    ll = _as_matrix(loglik)
    s, n = ll.shape
    lppd = _logsumexp(ll, axis=0) - np.log(s)
    p = np.var(ll, axis=0, ddof=1)
    pointwise = lppd - p
    return ELPDResult(
        elpd=float(pointwise.sum()),
        se=float(np.sqrt(n * np.var(pointwise, ddof=1))) if n > 1 else 0.0,
        p_eff=float(p.sum()), pointwise=pointwise, pareto_k=None,
        n_samples=s, n_points=n, method="waic",
    )


def _gpd_fit(x):
    """Generalized-Pareto (k, sigma) fit to sorted exceedances ``x`` by the
    Zhang & Stephens (2009) quadrature posterior mean, with the weak prior
    of Vehtari et al. (2017).  k > 0 is a heavy tail."""
    n = x.shape[0]
    prior_bs, prior_k = 3.0, 10.0
    m = 30 + int(np.sqrt(n))
    bs = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    bs /= prior_bs * x[int(n / 4 + 0.5) - 1]
    bs += 1.0 / x[-1]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        ks = np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)   # (m,)
        logl = n * (np.log(-(bs / ks)) - ks - 1.0)              # profile lik
        logl = np.where(np.isfinite(logl), logl, -np.inf)
        w = 1.0 / np.sum(np.exp(logl[None, :] - logl[:, None]), axis=1)
        w = np.where(np.isfinite(w), w, 0.0)
    b_post = np.sum(bs * w) / np.sum(w)
    k_post = np.mean(np.log1p(-b_post * x))
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)   # prior shrink
    sigma = -k_post / b_post
    return k_post, sigma


def _gpd_inv_cdf(p, k, sigma):
    """Quantile function of GPD(k, sigma) (location 0)."""
    if abs(k) < 1e-12:
        return -sigma * np.log1p(-p)
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def _psis_smooth_one(lw):
    """Smooth one column of raw log importance weights in place.
    Returns (smoothed normalized log-weights, pareto_k)."""
    s = lw.shape[0]
    lw = lw - lw.max()
    tail_len = int(np.ceil(min(0.2 * s, 3.0 * np.sqrt(s))))
    if tail_len < 5:
        return lw - _logsumexp(lw), np.inf
    order = np.argsort(lw)
    tail_ids = order[-tail_len:]
    cutoff = max(lw[order[-tail_len - 1]], np.log(np.finfo(float).tiny))
    exp_cutoff = np.exp(cutoff)
    x = np.exp(lw[tail_ids]) - exp_cutoff          # ascending exceedances
    if np.unique(x).size < 2 or x[-1] <= 0:
        return lw - _logsumexp(lw), np.inf
    k, sigma = _gpd_fit(x)
    if np.isfinite(k) and sigma > 0:
        sti = (np.arange(tail_len) + 0.5) / tail_len
        smoothed = _gpd_inv_cdf(sti, k, sigma) + exp_cutoff
        lw = lw.copy()
        lw[tail_ids] = np.log(smoothed)
    elif not np.isfinite(k):
        # a NaN fit means the tail was too pathological to smooth —
        # report inf so the k > 0.7 reliability check FLAGS the point
        # (NaN compared > 0.7 is False and would pass silently)
        k = np.inf
    lw = np.minimum(lw, 0.0)          # no draw outweighs the raw maximum
    return lw - _logsumexp(lw), float(k)


def psis_loo(loglik) -> ELPDResult:
    """PSIS-LOO elpd from a (num_samples, num_points) pointwise
    log-likelihood matrix.  Raw importance ratios are 1/p(y_i|θ_s); the
    largest-weight tail is replaced by expected order statistics of a
    fitted generalized Pareto (Vehtari et al. 2017).

    ``pareto_k[i] > 0.7`` flags an unreliable datapoint (the importance
    distribution has too heavy a tail there).
    """
    ll = _as_matrix(loglik)
    s, n = ll.shape
    pointwise = np.empty(n)
    ks = np.empty(n)
    p_eff_terms = _logsumexp(ll, axis=0) - np.log(s)   # lppd_i
    for i in range(n):
        lw, k = _psis_smooth_one(-ll[:, i])
        pointwise[i] = _logsumexp(lw + ll[:, i], axis=0)
        ks[i] = k
    return ELPDResult(
        elpd=float(pointwise.sum()),
        se=float(np.sqrt(n * np.var(pointwise, ddof=1))) if n > 1 else 0.0,
        p_eff=float(np.sum(p_eff_terms - pointwise)),
        pointwise=pointwise, pareto_k=ks, n_samples=s, n_points=n,
        method="psis_loo",
    )


def compare(results: dict) -> list:
    """Rank models by elpd.  ``results`` maps name -> ELPDResult (all fitted
    to the SAME data, so pointwise arrays align).  Returns rows
    ``{name, elpd, se, p_eff, d_elpd, d_se, rank}`` sorted best-first;
    ``d_se`` is the PAIRED std error of the pointwise differences vs the
    best model (the honest uncertainty for "is A better than B").
    """
    if not results:
        return []
    n_pts = {r.n_points for r in results.values()}
    if len(n_pts) != 1:
        raise ValueError(f"models scored on different data: n_points={n_pts}")
    items = sorted(results.items(), key=lambda kv: kv[1].elpd, reverse=True)
    best = items[0][1]
    rows = []
    for rank, (name, r) in enumerate(items):
        diff = best.pointwise - r.pointwise
        n = r.n_points
        rows.append({
            "name": name, "rank": rank, "elpd": r.elpd, "se": r.se,
            "p_eff": r.p_eff, "method": r.method,
            "d_elpd": float(diff.sum()),
            "d_se": float(np.sqrt(n * np.var(diff, ddof=1))) if n > 1
            else 0.0,
            "warn_k": (int(np.sum(r.pareto_k > 0.7))
                       if r.pareto_k is not None else None),
        })
    return rows
