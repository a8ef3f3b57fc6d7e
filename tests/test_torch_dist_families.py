"""Parity of the port's distribution families with ``bayesic_tpu.dist``:
the same seeded numpy parameters and points through both packages.

Limits: rtol 1e-5 / atol 1e-6 for values, rtol 1e-4 / atol 1e-5 for
values that go through ``gammainc``, the incomplete beta, ``i0e``/``i1e``,
``ndtri`` or the multivariate log-gamma.  The family-by-family parity
runs in float64 in both packages (JAX under ``jax.enable_x64``): XLA's
float32 ``lgamma`` on the CPU is off by up to ~6e-6 absolute on [3, 10]
against scipy, so a float32 log-density near 0 that sums lgamma terms
cannot meet atol 1e-6 against it whatever the port computes
(``test_float32_lgamma_error_is_jaxs``).  Sampling: 20,000 float32 draws
of every family, the sample mean (and variance, where the fourth moment
is finite) within 5 standard errors of the analytic value; the JAX
package's draws go through the same check where the analytic value is
this file's own formula (``JAX_DRAWS``; eager JAX sampling of the whole
catalog costs ~23 s of compiles on the CPU, so the others are left to
the JAX package's own tests).
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.dist as tdist

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
SP_RTOL, SP_ATOL = 1e-4, 1e-5
N = 64            # points per log_prob / moment case
DRAWS = 20_000


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _f64(p):
    """Float arrays of a parameter dict (or one array) in float64."""
    if isinstance(p, dict):
        return {k: _f64(v) for k, v in p.items()}
    return p.astype(np.float64) if np.issubdtype(p.dtype, np.floating) \
        else p


def _f32(x):
    return np.asarray(x, np.float32)


def _tril(rng, n, d, jitter=0.5):
    a = rng.normal(size=(n, d, d)) * 0.4
    t = np.tril(a, -1) + np.eye(d) * rng.uniform(jitter, 1.5, size=(n, 1, d))
    return _f32(t)


def _spd(rng, n, d):
    a = rng.normal(size=(n, d, d))
    return _f32(a @ np.swapaxes(a, -1, -2) / d + np.eye(d))


def _corr_chol(rng, n, d):
    """Lower-triangular, positive diagonal, unit rows."""
    t = np.tril(rng.normal(size=(n, d, d)), -1) \
        + np.eye(d) * rng.uniform(0.3, 1.5, size=(n, 1, d))
    return _f32(t / np.linalg.norm(t, axis=-1, keepdims=True))


def _sorted_cuts(rng, n, k):
    return _f32(np.sort(rng.normal(size=(n, k)) * 1.5, -1))


def _counts(rng, n, total, k):
    p = rng.dirichlet(np.ones(k), size=n)
    return _f32(np.stack([rng.multinomial(int(t), pp)
                          for t, pp in zip(np.broadcast_to(total, (n,)),
                                           p)]))


class Spec:
    """One family: ``params(rng, n)`` -> dict of numpy arrays (a batch of
    n), ``build(m, a, p)`` the distribution from module ``m`` (either
    package's ``dist``) with arrays made by ``a``, ``points(rng, p)`` the
    values for log_prob and cdf (a batch of n), ``special`` the members
    whose values go through the special functions, ``moments(p)`` the
    analytic (mean, variance or None) where the class defines none,
    ``quartiles(p)`` for heavy tails, ``sample_params`` the parameters of
    the sampling check."""

    def __init__(self, name, params, build, points, special=(),
                 moments=None, quartiles=None, sample_params=None,
                 var_ok=True):
        self.name = name
        self.params = params
        self.build = build
        self.points = points
        self.special = set(special)
        self.moments = moments
        self.quartiles = quartiles
        self.sample_params = lambda rng: (sample_params or params)(rng, 2)
        self.var_ok = var_ok


def U(lo, hi):
    return lambda rng, n: _f32(rng.uniform(lo, hi, n))


def _p(**fns):
    def params(rng, n):
        return {k: f(rng, n) for k, f in fns.items()}
    return params


def _phi(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _Phi(z):
    return 0.5 * np.vectorize(math.erfc)(-np.asarray(z, float)
                                         / math.sqrt(2))


def _trunc_normal_moments(p):
    """Moments of N(loc, scale) truncated to [low, high] in closed form."""
    mu, sd = p["loc"].astype(float), p["scale"].astype(float)
    a, b = (p["low"] - mu) / sd, (p["high"] - mu) / sd
    # the mass on the side of the mean that keeps it: a window far above
    # the mean has Phi(b) - Phi(a) = 0 in float64
    z = np.where(a > 0, _Phi(-a) - _Phi(-b), _Phi(b) - _Phi(a))
    r = (_phi(a) - _phi(b)) / z
    return mu + sd * r, sd * sd * (1 + (a * _phi(a) - b * _phi(b)) / z
                                   - r * r)


def _ig_moments(p):
    a, b = p["c"].astype(float), p["s"].astype(float)
    return b / (a - 1), b * b / ((a - 1) ** 2 * (a - 2))


def _weibull_var(p):
    k, lam = p["k"].astype(float), p["s"].astype(float)
    g1, g2 = math.gamma, math.gamma
    m = np.array([lam_ * g1(1 + 1 / k_) for k_, lam_ in zip(k, lam)])
    m2 = np.array([lam_ ** 2 * g2(1 + 2 / k_) for k_, lam_ in zip(k, lam)])
    return m, m2 - m * m


def _pareto_moments(p):
    a, s = p["a"].astype(float), p["s"].astype(float)
    return a * s / (a - 1), s * s * a / ((a - 1) ** 2 * (a - 2))


def _ordered_logistic_moments(p):
    jd = jdist.OrderedLogistic(_j(p["eta"]), _j(p["cut"]))
    pr = np.asarray(jd.probs, float)
    k = np.arange(pr.shape[-1])
    m = (pr * k).sum(-1)
    return m, (pr * k * k).sum(-1) - m * m


def _multinomial_var(p):
    pr = np.asarray(p["probs"], float)
    pr = pr / pr.sum(-1, keepdims=True)
    return 10 * pr, 10 * pr * (1 - pr)


def _dm_moments(p):
    a = p["alpha"].astype(float)
    n = p["n"].astype(float)[:, None]
    a0 = a.sum(-1, keepdims=True)
    pr = a / a0
    return n * pr, n * pr * (1 - pr) * (n + a0) / (1 + a0)


def _mvt_var(p):
    df = p["df"].astype(float)[:, None]
    s = (p["L"].astype(float) ** 2).sum(-1)
    return p["loc"], df / (df - 2) * s


def _censored_moments(p):
    """Moments of clip(N(loc, scale), lo, hi) in closed form."""
    mu, sd = p["loc"].astype(float), p["scale"].astype(float)
    lo, hi = p["lo"].astype(float), p["hi"].astype(float)
    a, b = (lo - mu) / sd, (hi - mu) / sd
    fa, fb, pa, pb = _Phi(a), _Phi(b), _phi(a), _phi(b)
    mass = fb - fa
    m1 = lo * fa + hi * (1 - fb) + mu * mass + sd * (pa - pb)
    m2 = (lo * lo * fa + hi * hi * (1 - fb) + (mu * mu + sd * sd) * mass
          + 2 * mu * sd * (pa - pb) + sd * sd * (a * pa - b * pb))
    return m1, m2 - m1 * m1


def _trunc_moments(p):
    return _trunc_normal_moments(dict(loc=p["loc"], scale=p["scale"],
                                      low=p["lo"], high=p["hi"]))


def _lognormal_td_moments(p):
    loc, s = p["loc"].astype(float), p["scale"].astype(float)
    return np.exp(loc + s * s / 2), (np.exp(s * s) - 1) * np.exp(
        2 * loc + s * s)


SPECS = [
    # -- continuous ------------------------------------------------------
    Spec("Normal", _p(loc=U(-2, 2), scale=U(0.3, 2)),
         lambda m, a, p: m.Normal(a(p["loc"]), a(p["scale"])),
         lambda r, p: _f32(r.normal(size=len(p["loc"])) * 2),
         special={"icdf"}),
    Spec("LogNormal", _p(loc=U(-1, 1), scale=U(0.2, 1)),
         lambda m, a, p: m.LogNormal(a(p["loc"]), a(p["scale"])),
         lambda r, p: _f32(r.lognormal(size=len(p["loc"]))),
         special={"icdf"}),
    Spec("HalfNormal", _p(scale=U(0.3, 2)),
         lambda m, a, p: m.HalfNormal(a(p["scale"])),
         lambda r, p: _f32(np.abs(r.normal(size=len(p["scale"])))),
         special={"icdf"}),
    Spec("Cauchy", _p(loc=U(-2, 2), scale=U(0.3, 2)),
         lambda m, a, p: m.Cauchy(a(p["loc"]), a(p["scale"])),
         lambda r, p: _f32(r.normal(size=len(p["loc"])) * 3),
         quartiles=lambda p: p["loc"][:, None] + p["scale"][:, None]
         * np.tan(np.pi * (np.array([0.25, 0.5, 0.75]) - 0.5))),
    Spec("HalfCauchy", _p(scale=U(0.3, 2)),
         lambda m, a, p: m.HalfCauchy(a(p["scale"])),
         lambda r, p: _f32(np.abs(r.normal(size=len(p["scale"])) * 3)),
         quartiles=lambda p: p["scale"][:, None]
         * np.tan(np.pi * np.array([0.25, 0.5, 0.75]) / 2)),
    Spec("StudentT", _p(df=U(0.5, 8), loc=U(-2, 2), scale=U(0.3, 2)),
         lambda m, a, p: m.StudentT(a(p["df"]), a(p["loc"]), a(p["scale"])),
         lambda r, p: _f32(r.normal(size=len(p["df"])) * 3),
         special={"cdf"},
         sample_params=_p(df=U(6, 9), loc=U(-2, 2), scale=U(0.3, 2))),
    Spec("Laplace", _p(loc=U(-2, 2), scale=U(0.3, 2)),
         lambda m, a, p: m.Laplace(a(p["loc"]), a(p["scale"])),
         lambda r, p: _f32(r.normal(size=len(p["loc"])) * 2)),
    Spec("Exponential", _p(rate=U(0.3, 3)),
         lambda m, a, p: m.Exponential(a(p["rate"])),
         lambda r, p: _f32(r.exponential(size=len(p["rate"])))),
    Spec("Gamma", _p(c=U(0.2, 5), r=U(0.3, 3)),
         lambda m, a, p: m.Gamma(a(p["c"]), a(p["r"])),
         lambda r, p: _f32(r.gamma(2.0, size=len(p["c"]))),
         special={"cdf"}),
    Spec("InverseGamma", _p(c=U(0.5, 5), s=U(0.3, 3)),
         lambda m, a, p: m.InverseGamma(a(p["c"]), a(p["s"])),
         lambda r, p: _f32(1.0 / r.gamma(2.0, size=len(p["c"]))),
         moments=_ig_moments, sample_params=_p(c=U(6, 9), s=U(0.5, 2))),
    Spec("Beta", _p(a=U(0.3, 5), b=U(0.3, 5)),
         lambda m, a, p: m.Beta(a(p["a"]), a(p["b"])),
         lambda r, p: _f32(r.uniform(0.01, 0.99, len(p["a"]))),
         special={"cdf"}),
    Spec("Uniform", _p(lo=U(-2, 0), hi=U(0.5, 3)),
         lambda m, a, p: m.Uniform(a(p["lo"]), a(p["hi"])),
         lambda r, p: _f32(r.uniform(-2.5, 3.5, len(p["lo"])))),
    Spec("TruncatedNormal",
         _p(loc=U(-1, 1), scale=U(0.5, 2), low=U(-2, -0.5), high=U(0, 2)),
         lambda m, a, p: m.TruncatedNormal(a(p["loc"]), a(p["scale"]),
                                           a(p["low"]), a(p["high"])),
         lambda r, p: _f32(r.uniform(-2.5, 2.5, len(p["loc"]))),
         moments=_trunc_normal_moments),
    Spec("Weibull", _p(s=U(0.5, 2), k=U(0.5, 3)),
         lambda m, a, p: m.Weibull(a(p["s"]), a(p["k"])),
         lambda r, p: _f32(r.exponential(size=len(p["s"])) + 0.01),
         moments=_weibull_var, sample_params=_p(s=U(0.5, 2), k=U(1, 3))),
    Spec("Gumbel", _p(loc=U(-2, 2), scale=U(0.3, 2)),
         lambda m, a, p: m.Gumbel(a(p["loc"]), a(p["scale"])),
         lambda r, p: _f32(r.normal(size=len(p["loc"])) * 2)),
    Spec("Pareto", _p(s=U(0.5, 2), a=U(1.5, 4)),
         lambda m, a, p: m.Pareto(a(p["s"]), a(p["a"])),
         lambda r, p: _f32(p["s"] * (1.0 + r.exponential(size=len(p["s"])))),
         moments=_pareto_moments, sample_params=_p(s=U(0.5, 2), a=U(5, 8))),
    Spec("Chi2", _p(df=U(0.5, 8)),
         lambda m, a, p: m.Chi2(a(p["df"])),
         lambda r, p: _f32(r.gamma(2.0, size=len(p["df"]))),
         special={"cdf"}),
    # -- discrete --------------------------------------------------------
    Spec("Bernoulli", _p(p=U(0.05, 0.95)),
         lambda m, a, p: m.Bernoulli(probs=a(p["p"])),
         lambda r, p: _f32(r.integers(0, 2, len(p["p"])))),
    Spec("Binomial", _p(n=lambda r, n: _f32(r.integers(1, 20, n)),
                        p=U(0.05, 0.95)),
         lambda m, a, p: m.Binomial(a(p["n"]), probs=a(p["p"])),
         lambda r, p: _f32(np.floor(r.uniform(0, 1, len(p["n"]))
                                    * (p["n"] + 1)))),
    Spec("Categorical",
         _p(probs=lambda r, n: _f32(r.dirichlet(np.ones(4), n))),
         lambda m, a, p: m.Categorical(probs=a(p["probs"])),
         lambda r, p: r.integers(0, 4, len(p["probs"])).astype(np.int32),
         moments=lambda p: (None, None)),
    Spec("OrderedLogistic",
         _p(eta=U(-2, 2), cut=lambda r, n: _sorted_cuts(r, n, 3)),
         lambda m, a, p: m.OrderedLogistic(a(p["eta"]), a(p["cut"])),
         lambda r, p: r.integers(0, 4, len(p["eta"])).astype(np.int32),
         moments=_ordered_logistic_moments),
    Spec("Poisson", _p(rate=U(0.5, 8)),
         lambda m, a, p: m.Poisson(a(p["rate"])),
         lambda r, p: _f32(r.poisson(3.0, len(p["rate"])))),
    Spec("Geometric", _p(p=U(0.1, 0.9)),
         lambda m, a, p: m.Geometric(probs=a(p["p"])),
         lambda r, p: _f32(r.geometric(0.4, len(p["p"])) - 1)),
    Spec("NegativeBinomial", _p(r=U(0.5, 6), p=U(0.1, 0.8)),
         lambda m, a, p: m.NegativeBinomial(a(p["r"]), probs=a(p["p"])),
         lambda r, p: _f32(r.poisson(3.0, len(p["r"])))),
    Spec("Multinomial",
         _p(probs=lambda r, n: _f32(r.dirichlet(np.ones(3) * 2, n))),
         lambda m, a, p: m.Multinomial(10, probs=a(p["probs"])),
         lambda r, p: _counts(r, len(p["probs"]), 10, 3),
         moments=_multinomial_var),
    # -- multivariate ------------------------------------------------------
    Spec("MultivariateNormal",
         _p(loc=lambda r, n: _f32(r.normal(size=(n, 3))),
            L=lambda r, n: _tril(r, n, 3)),
         lambda m, a, p: m.MultivariateNormal(a(p["loc"]),
                                              scale_tril=a(p["L"])),
         lambda r, p: _f32(r.normal(size=(len(p["loc"]), 3)) * 2)),
    Spec("Dirichlet",
         _p(alpha=lambda r, n: _f32(r.uniform(0.5, 4, (n, 3)))),
         lambda m, a, p: m.Dirichlet(a(p["alpha"])),
         lambda r, p: _f32(r.dirichlet(np.ones(3), len(p["alpha"])))),
    Spec("LKJCholesky", _p(eta=U(0.5, 4)),
         lambda m, a, p: m.LKJCholesky(3, a(p["eta"])),
         lambda r, p: _corr_chol(r, len(p["eta"]), 3),
         moments=lambda p: (None, None)),
    Spec("MultivariateStudentT",
         _p(df=U(3, 9), loc=lambda r, n: _f32(r.normal(size=(n, 3))),
            L=lambda r, n: _tril(r, n, 3)),
         lambda m, a, p: m.MultivariateStudentT(a(p["df"]), a(p["loc"]),
                                                a(p["L"])),
         lambda r, p: _f32(r.normal(size=(len(p["df"]), 3)) * 2),
         moments=_mvt_var,
         sample_params=_p(df=U(7, 9),
                          loc=lambda r, n: _f32(r.normal(size=(n, 3))),
                          L=lambda r, n: _tril(r, n, 3))),
    Spec("MatrixNormal",
         _p(loc=lambda r, n: _f32(r.normal(size=(n, 2, 3))),
            R=lambda r, n: _tril(r, n, 2), C=lambda r, n: _tril(r, n, 3)),
         lambda m, a, p: m.MatrixNormal(a(p["loc"]), a(p["R"]), a(p["C"])),
         lambda r, p: _f32(r.normal(size=(len(p["loc"]), 2, 3)))),
    # sampled at df well above d: at df ~ d a Bartlett diagonal entry
    # chi2(df - d + 1) is near 0 often enough that float32 draws come out
    # singular in both packages
    Spec("Wishart", _p(df=U(3, 8), L=lambda r, n: _tril(r, n, 3)),
         lambda m, a, p: m.Wishart(a(p["df"]), a(p["L"])),
         lambda r, p: _spd(r, len(p["df"]), 3),
         special={"log_prob"},
         sample_params=_p(df=U(6, 9), L=lambda r, n: _tril(r, n, 3))),
    Spec("InverseWishart", _p(df=U(7.5, 10), L=lambda r, n: _tril(r, n, 3)),
         lambda m, a, p: m.InverseWishart(a(p["df"]), a(p["L"])),
         lambda r, p: _spd(r, len(p["df"]), 3),
         special={"log_prob"},
         sample_params=_p(df=U(12, 14), L=lambda r, n: _tril(r, n, 3))),
    # -- compound ----------------------------------------------------------
    Spec("BetaBinomial",
         _p(a=U(0.5, 4), b=U(0.5, 4),
            n=lambda r, n: _f32(r.integers(1, 15, n))),
         lambda m, a, p: m.BetaBinomial(a(p["a"]), a(p["b"]), a(p["n"])),
         lambda r, p: _f32(np.floor(r.uniform(0, 1, len(p["n"]))
                                    * (p["n"] + 1)))),
    Spec("DirichletMultinomial",
         _p(alpha=lambda r, n: _f32(r.uniform(0.5, 4, (n, 3))),
            n=lambda r, n: _f32(r.integers(1, 12, n))),
         lambda m, a, p: m.DirichletMultinomial(a(p["alpha"]), a(p["n"])),
         lambda r, p: _counts(r, len(p["n"]), p["n"].astype(int), 3),
         moments=_dm_moments),
    Spec("GaussianRandomWalk", _p(s=U(0.3, 2)),
         lambda m, a, p: m.GaussianRandomWalk(a(p["s"]), num_steps=5),
         lambda r, p: _f32(np.cumsum(r.normal(size=(len(p["s"]), 5)), -1))),
    Spec("VonMises", _p(loc=U(-2, 2), k=U(0.01, 10)),
         lambda m, a, p: m.VonMises(a(p["loc"]), a(p["k"])),
         lambda r, p: _f32(r.uniform(-np.pi, np.pi, len(p["loc"]))),
         special={"log_prob", "variance"}),
    Spec("ZeroInflatedDistribution", _p(g=U(0.05, 0.8), rate=U(0.5, 6)),
         lambda m, a, p: m.ZeroInflatedDistribution(m.Poisson(a(p["rate"])),
                                                    gate=a(p["g"])),
         lambda r, p: _f32(r.poisson(1.0, len(p["g"])))),
    Spec("ZeroInflatedPoisson", _p(g=U(0.05, 0.8), rate=U(0.5, 6)),
         lambda m, a, p: m.ZeroInflatedPoisson(a(p["g"]), a(p["rate"])),
         lambda r, p: _f32(r.poisson(1.0, len(p["g"])))),
    Spec("ZeroInflatedNegativeBinomial",
         _p(g=U(0.05, 0.8), r=U(0.5, 6), p=U(0.1, 0.8)),
         lambda m, a, p: m.ZeroInflatedNegativeBinomial(
             a(p["g"]), a(p["r"]), probs=a(p["p"])),
         lambda r, p: _f32(r.poisson(1.5, len(p["g"])))),
    Spec("Censored",
         _p(loc=U(-1, 1), scale=U(0.5, 2), lo=U(-2, -0.5), hi=U(0.5, 2)),
         lambda m, a, p: m.Censored(m.Normal(a(p["loc"]), a(p["scale"])),
                                    lower=a(p["lo"]), upper=a(p["hi"])),
         lambda r, p: _f32(np.clip(r.normal(size=len(p["loc"])) * 2,
                                   p["lo"], p["hi"])),
         moments=_censored_moments),
    Spec("Truncated",
         _p(loc=U(-1, 1), scale=U(0.5, 2), lo=U(-2, -0.5), hi=U(0.5, 2)),
         lambda m, a, p: m.Truncated(m.Normal(a(p["loc"]), a(p["scale"])),
                                     lower=a(p["lo"]), upper=a(p["hi"])),
         lambda r, p: _f32(r.uniform(-2.5, 2.5, len(p["loc"]))),
         moments=_trunc_moments),
    Spec("Delta", _p(v=U(-2, 2)),
         lambda m, a, p: m.Delta(a(p["v"])),
         lambda r, p: np.where(r.uniform(size=len(p["v"])) < 0.5, p["v"],
                               p["v"] + 1).astype(np.float32)),
    Spec("TransformedDistribution", _p(loc=U(-1, 1), scale=U(0.2, 1)),
         lambda m, a, p: m.TransformedDistribution(
             m.Normal(a(p["loc"]), a(p["scale"])), m.transforms.Exp()),
         lambda r, p: _f32(r.lognormal(size=len(p["loc"]))),
         moments=_lognormal_td_moments),
]
BY_NAME = {s.name: s for s in SPECS}
# families whose analytic moments or quartiles are this file's formulas:
# the JAX package's draws check the formulas too
JAX_DRAWS = {"HalfCauchy", "Weibull", "Pareto", "TruncatedNormal",
             "Censored", "TransformedDistribution"}
NEW_FAMILIES = sorted(set(jdist.__all__) - {
    "constraints", "biject_to", "Distribution", "Independent",
    "MixtureSameFamily", "HiddenMarkovModel", "LinearGaussianStateSpace"})


def test_all_exports_match_jax():
    want = set(jdist.__all__) - {"HiddenMarkovModel",
                                 "LinearGaussianStateSpace"}
    assert want <= set(tdist.__all__)
    for name in want:
        assert hasattr(tdist, name), name
    # every family of the JAX package but the two state-space models has a
    # spec here
    assert set(NEW_FAMILIES) <= set(BY_NAME)


def _pair(spec, rng, n=N):
    """Both packages' distributions (eagerly, for their static
    attributes)."""
    p = spec.params(rng, n)
    return p, spec.build(jdist, _j, p), spec.build(tdist, _t, p)


def _close(got, want, special, what):
    rtol, atol = (SP_RTOL, SP_ATOL) if what in special else (RTOL, ATOL)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape)
                               if want.shape != got.shape else want,
                               rtol=rtol, atol=atol, equal_nan=True,
                               err_msg=what)


MEMBERS = ("mean", "variance", "entropy", "cdf", "icdf")


def _member(d, member, arg):
    """``d``'s member (a property, ``entropy()``, or a method of ``arg``),
    None where the class does not define it."""
    try:
        attr = getattr(d, member)
        if member == "entropy":
            return attr()
        return attr(arg) if member in ("cdf", "icdf") else attr
    except (NotImplementedError, AttributeError):
        return None


_REFERENCE = {}


def _reference(name):
    """The family's float64 inputs and the JAX package's log_prob and
    members on them.  Every family's come from one jitted program under
    ``jax.enable_x64``, made at first use: eager JAX compiles every
    primitive on first use, and one program per family pays XLA's fixed
    cost per compile 46 times."""
    if not _REFERENCE:
        inputs, shapes = {}, {}
        for spec in SPECS:
            rng = np.random.default_rng(zlib.crc32(spec.name.encode()))
            p = _f64(spec.params(rng, N))
            x = _f64(spec.points(rng, p))
            inputs[spec.name] = (p, x, rng.uniform(0.02, 0.98, x.shape))

        def f(inputs):
            out = {}
            for spec in SPECS:
                p, x, q = inputs[spec.name]
                d = spec.build(jdist, lambda v: v, p)
                shapes[spec.name] = (d.batch_shape, d.event_shape)
                res = {"log_prob": d.log_prob(x)}
                for m in MEMBERS:
                    res[m] = _member(d, m, {"cdf": x, "icdf": q}.get(m))
                out[spec.name] = res
            return out

        with jax.enable_x64(True):
            out = jax.jit(f)(inputs)
        for spec in SPECS:
            res = {k: None if v is None else np.asarray(v)
                   for k, v in out[spec.name].items()}
            _REFERENCE[spec.name] = inputs[spec.name] + (
                res, dict(zip(("batch", "event"), shapes[spec.name])))
    return _REFERENCE[name]


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_log_prob_matches_jax(name):
    spec = BY_NAME[name]
    p, x, _, want, shapes = _reference(name)
    td = spec.build(tdist, _t, p)
    assert td.batch_shape == tuple(shapes["batch"])
    assert td.event_shape == tuple(shapes["event"])
    got = td.log_prob(_t(x))
    assert tuple(got.shape) == want["log_prob"].shape
    _close(got, want["log_prob"], spec.special, "log_prob")


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_members_match_jax(name):
    """mean, variance, entropy, cdf and icdf where the JAX class defines
    them, and absent where it does not."""
    spec = BY_NAME[name]
    p, x, q, want, _ = _reference(name)
    td = spec.build(tdist, _t, p)
    for m in MEMBERS:
        got = _member(td, m, _t({"cdf": x, "icdf": q}.get(m, x)))
        assert (want[m] is None) == (got is None), m
        if got is not None:
            _close(got, want[m], spec.special, m)


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_support_bijector_and_reparametrized(name):
    spec = BY_NAME[name]
    _, jd, td = _pair(spec, np.random.default_rng(3), n=3)
    assert td.reparametrized == jd.reparametrized
    assert type(td.support).__name__ == type(jd.support).__name__
    assert td.support.is_discrete == jd.support.is_discrete
    try:
        jt = type(jdist.biject_to(jd.support)).__name__
    except ValueError:
        with pytest.raises(ValueError):
            tdist.biject_to(td.support)
        return
    assert type(tdist.biject_to(td.support)).__name__ == jt


def _support_ok(d, x):
    ok = np.asarray(d.support(x))
    return bool(ok.all())


def _moment_checks(spec, p, jd, xs_list):
    """Both packages' sample means (and variances) against the analytic."""
    if spec.quartiles is not None:
        want = spec.quartiles(p)
        for xs in xs_list:
            got = np.quantile(xs, [0.25, 0.5, 0.75], axis=0).T
            np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
        return
    if spec.moments is not None:
        mean, var = spec.moments(p)
    else:
        mean = np.asarray(jd.mean, float)
        var = _member(jd, "variance", None)
        var = None if var is None else np.asarray(var, float)
    if spec.name == "LKJCholesky":
        eta = p["eta"].astype(float)
        for xs in xs_list:
            r = np.einsum("...ij,...kj->...ik", xs, xs)[..., 1, 0]
            se = r.std(0) / math.sqrt(len(r))
            assert np.all(np.abs(r.mean(0)) < 5 * se + 1e-3)
            r2 = r * r
            want = 1.0 / (2 * eta + 3 - 1)
            assert np.all(np.abs(r2.mean(0) - want)
                          < 5 * r2.std(0) / math.sqrt(len(r2)) + 1e-3)
        return
    if mean is None:        # Categorical: the class mean
        mean = np.asarray(jd.mean, float)
    if spec.name == "VonMises":
        for xs in xs_list:
            c = np.cos(xs - p["loc"])
            assert np.all(np.abs(c.mean(0) - (1 - var))
                          < 5 * c.std(0) / math.sqrt(len(c)) + 1e-4)
        return
    for xs in xs_list:
        n = xs.shape[0]
        m = xs.mean(0)
        sd = xs.std(0)
        tol = 5 * sd / math.sqrt(n) + 1e-6
        assert np.all(np.abs(m - mean) < tol), (m, mean, tol)
        if var is not None and spec.var_ok:
            dev2 = (xs - mean) ** 2
            vtol = 5 * dev2.std(0) / math.sqrt(n) + 1e-6
            assert np.all(np.abs(dev2.mean(0) - var) < vtol), \
                (dev2.mean(0), var, vtol)


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_sampling_shape_support_and_moments(name):
    spec = BY_NAME[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 2)
    p = spec.sample_params(rng)
    jd, td = spec.build(jdist, _j, p), spec.build(tdist, _t, p)
    gen = torch.Generator().manual_seed(5)
    xt = td.sample(gen, (DRAWS,))
    want_shape = (DRAWS,) + tuple(jd.batch_shape) + tuple(jd.event_shape)
    assert tuple(xt.shape) == want_shape
    assert xt.device.type == "cpu"
    if name != "Delta":
        assert _support_ok(td, xt)
    xs = [np.asarray(xt, np.float64)]
    if name in JAX_DRAWS:
        xj = jax.jit(lambda k: jd.sample(k, (DRAWS,)))(jax.random.PRNGKey(5))
        assert tuple(xj.shape) == want_shape and _support_ok(jd, xj)
        xs.append(np.asarray(xj, np.float64))
    if name == "Delta":
        for x in xs:
            np.testing.assert_array_equal(x, np.broadcast_to(p["v"],
                                                             x.shape))
        return
    _moment_checks(spec, p, jd, xs)


@pytest.mark.parametrize("name", [
    "Normal", "LogNormal", "Gamma", "Beta", "StudentT", "Laplace",
    "Uniform", "TruncatedNormal", "Weibull", "Pareto", "Chi2",
    "InverseGamma", "MultivariateNormal", "Wishart", "InverseWishart",
    "GaussianRandomWalk", "Truncated", "TransformedDistribution",
    "MatrixNormal", "MultivariateStudentT", "Dirichlet", "Gumbel",
    "Exponential", "Cauchy", "HalfCauchy", "HalfNormal"])
def test_reparametrized_families_sample_pathwise(name):
    """A family that the JAX package samples pathwise gives draws with a
    finite gradient with respect to its parameters."""
    spec = BY_NAME[name]
    assert getattr(jdist, name).reparametrized is not False
    p = spec.sample_params(np.random.default_rng(4))
    leaves = {k: torch.as_tensor(v).requires_grad_(True)
              for k, v in p.items() if np.issubdtype(v.dtype, np.floating)}
    td = spec.build(tdist, lambda v: next(
        (t for k, t in leaves.items() if p[k] is v), _t(v)), p)
    x = td.sample(torch.Generator().manual_seed(1), (64,))
    assert x.requires_grad
    grads = torch.autograd.grad(x.sum(), list(leaves.values()),
                                allow_unused=True)
    assert any(g is not None for g in grads)
    assert all(torch.isfinite(g).all() for g in grads if g is not None)


def test_pathwise_gradient_values():
    """d/d loc E[Normal(loc, 1)] = 1 and d/da E[Gamma(a, 1)] = 1, the
    limits of JAX ``tests/test_dist.py::test_reparam_gradients``."""
    loc = torch.tensor(0.3, requires_grad=True)
    x = tdist.Normal(loc, 1.0).sample(torch.Generator().manual_seed(0),
                                      (4096,))
    (g,) = torch.autograd.grad(x.mean(), loc)
    assert abs(float(g) - 1.0) < 1e-4
    conc = torch.tensor(3.0, requires_grad=True)
    x = tdist.Gamma(conc, 1.0).sample(torch.Generator().manual_seed(0),
                                      (4096,))
    (g,) = torch.autograd.grad(x.mean(), conc)
    assert abs(float(g) - 1.0) < 0.05


# -- broadcasting and expanded shapes --------------------------------------

@pytest.mark.parametrize("name,shapes,x_shape", [
    ("StudentT", ((3, 1), (4,), ()), (3, 4)),
    ("Gamma", ((2, 1, 3), ()), (5, 1)),
    ("VonMises", ((), (3,)), (2, 3)),
    ("NegativeBinomial", ((3,), (2, 1)), (2, 3)),
])
def test_broadcasting_matches_jax(name, shapes, x_shape):
    rng = np.random.default_rng(7)
    lows = {"StudentT": (1.0, -1.0, 0.5), "Gamma": (0.5, 0.5),
            "VonMises": (-1.0, 0.1), "NegativeBinomial": (0.5, 0.1)}[name]
    args = [_f32(lo + rng.uniform(0, 2, s)) for lo, s in zip(lows, shapes)]
    if name == "NegativeBinomial":
        args[1] = np.clip(args[1], 0.05, 0.9)
    kw = {}
    if name == "NegativeBinomial":
        kw = {"probs": args.pop()}
    jd = getattr(jdist, name)(*map(_j, args), **{k: _j(v)
                                                for k, v in kw.items()})
    td = getattr(tdist, name)(*map(_t, args), **{k: _t(v)
                                                for k, v in kw.items()})
    if name == "NegativeBinomial":
        x = _f32(rng.integers(0, 3, x_shape))
    elif name == "Gamma":
        x = _f32(rng.uniform(0.1, 3, x_shape))
    else:
        x = _f32(rng.uniform(-1, 1.5, x_shape))
    want = np.asarray(jax.jit(jd.log_prob)(_j(x)))
    got = td.log_prob(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=SP_RTOL if name == "VonMises"
                               else RTOL, atol=ATOL)
    full = (2,) + np.broadcast_shapes(x.shape, tuple(jd.batch_shape))
    je, te = jd.expand(full), td.expand(full)
    assert te.batch_shape == tuple(je.batch_shape) == full
    x2 = np.broadcast_to(x, full).copy()
    np.testing.assert_allclose(te.log_prob(_t(x2)).numpy(),
                               np.asarray(jax.jit(je.log_prob)(_j(x2))),
                               rtol=SP_RTOL if name == "VonMises" else RTOL,
                               atol=ATOL)


SCALAR_FAMILIES = [s.name for s in SPECS if not s.name.startswith((
    "Multi", "Matrix", "Wishart", "InverseWishart", "LKJ", "Dirichlet",
    "Categorical", "OrderedLogistic", "GaussianRandomWalk", "Delta"))]


@pytest.mark.parametrize("name", SCALAR_FAMILIES)
def test_broadcast_and_expand_equal_explicit_parameters(name):
    """Parameters of shapes (n, 1) and (n,) against points (n, 5) and the
    same family expanded to (2, n, 5) give the values of the parameters
    broadcast by hand (the element-wise values are held to JAX above)."""
    spec = BY_NAME[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 9)
    p = spec.params(rng, 4)
    x = np.stack([spec.points(rng, p) for _ in range(5)], -1)     # (4, 5)
    col = {k: v[:, None] for k, v in p.items()}
    full = {k: np.ascontiguousarray(np.broadcast_to(v[:, None], (4, 5)))
            for k, v in p.items()}
    got = spec.build(tdist, _t, col).log_prob(_t(x))
    want = spec.build(tdist, _t, full).log_prob(_t(x))
    assert tuple(got.shape) == (4, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    e = spec.build(tdist, _t, col).expand((2, 4, 5))
    assert e.batch_shape == (2, 4, 5)
    x2 = np.broadcast_to(x, (2, 4, 5)).copy()
    np.testing.assert_allclose(e.log_prob(_t(x2)).numpy(),
                               np.broadcast_to(want.numpy(), (2, 4, 5)),
                               rtol=RTOL, atol=ATOL)


def test_wrappers_expand_like_jax():
    """Wrappers expand their base (JAX
    ``tests/test_compound.py::test_wrapper_distributions_expand``)."""
    c = tdist.Censored(tdist.Normal(0.0, 1.0), lower=0.0).expand((5,))
    assert c.batch_shape == (5,)
    assert tuple(c.sample(torch.Generator().manual_seed(0)).shape) == (5,)
    t = tdist.Truncated(tdist.Normal(0.0, 2.0), lower=-1.0).expand((4,))
    assert tuple(t.log_prob(torch.zeros(4)).shape) == (4,)
    z = tdist.ZeroInflatedPoisson(0.2, 3.0).expand((7,))
    assert tuple(z.log_prob(torch.zeros(7, dtype=torch.int32)).shape) == (7,)
    mv = tdist.MultivariateNormal(torch.zeros(3), scale_tril=torch.eye(3))
    e = mv.expand((4,))
    assert e.batch_shape == (4,) and e.event_shape == (3,)
    assert tuple(e.sample(torch.Generator().manual_seed(0)).shape) == (4, 3)
    ol = tdist.OrderedLogistic(torch.tensor(0.3), torch.tensor([-1.0, 1.0]))
    assert isinstance(ol.expand((2,)), tdist.OrderedLogistic)


FLOAT_PARAM_COUNTS = [
    ("Poisson", (2.5,), {}), ("Binomial", (5.0,), {"probs": 0.3}),
    ("NegativeBinomial", (3.0,), {"probs": 0.4}),
    ("Geometric", (), {"logits": 0.2}), ("BetaBinomial", (2.0, 3.0, 5), {})]
FLOAT_PARAM_REALS = [
    ("HalfCauchy", (5.0,), {}), ("StudentT", (3.0, 0.0, 1.0), {}),
    ("Gamma", (2.0, 0.1), {}), ("Chi2", (3.0,), {}),
    ("Uniform", (0.0, 2.0), {})]


def test_float_parameters_and_int_counts():
    """Python-float parameters and integer observations (counts cast to
    float before lgamma/xlogy, JAX ``discrete.py:211``)."""
    k = np.arange(6, dtype=np.int32)
    x = np.linspace(0.1, 3.0, 7).astype(np.float32)

    def jax_side(k, x):
        return ([getattr(jdist, n)(*a, **kw).log_prob(k)
                 for n, a, kw in FLOAT_PARAM_COUNTS],
                [getattr(jdist, n)(*a, **kw).log_prob(x)
                 for n, a, kw in FLOAT_PARAM_REALS])

    want_k, want_x = jax.jit(jax_side)(jnp.asarray(k), jnp.asarray(x))
    for (n, a, kw), want in zip(FLOAT_PARAM_COUNTS, want_k):
        got = getattr(tdist, n)(*a, **kw).log_prob(torch.as_tensor(k))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    for (n, a, kw), want in zip(FLOAT_PARAM_REALS, want_x):
        got = getattr(tdist, n)(*a, **kw).log_prob(torch.as_tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_float32_lgamma_error_is_jaxs():
    """Why the parity above runs in float64: on [3, 10] XLA's float32
    lgamma on the CPU is off by more than 1e-6 absolute against the
    float64 value, torch's is not; a float32 Beta log-density near 0 then
    differs from the exact one by about JAX's lgamma error."""
    x = np.linspace(3.0, 10.0, 4001).astype(np.float32)
    exact = np.array([math.lgamma(float(v)) for v in x])
    err_jax = np.max(np.abs(np.asarray(jax.lax.lgamma(jnp.asarray(x)))
                            - exact))
    err_port = np.max(np.abs(torch.lgamma(torch.as_tensor(x)).numpy()
                             - exact))
    assert err_jax > 1e-6 > err_port
    a, b = np.float32(4.3), np.float32(6.7)
    xs = np.linspace(0.05, 0.95, 37).astype(np.float32)
    exact_lp = np.array([
        (float(a) - 1) * math.log(float(v)) + (float(b) - 1)
        * math.log1p(-float(v)) - (math.lgamma(float(a))
                                   + math.lgamma(float(b))
                                   - math.lgamma(float(a) + float(b)))
        for v in xs])
    port = tdist.Beta(torch.tensor(a), torch.tensor(b)).log_prob(
        torch.as_tensor(xs)).numpy()
    assert np.max(np.abs(port - exact_lp)) < 2e-6


# -- float32 edge cases that the JAX package's tests pin -------------------

def test_truncated_normal_far_tails():
    """JAX ``tests/test_compound.py::test_truncated_normal_support_and_tails``:
    -inf outside the window, finite and right far in the tail."""
    d = tdist.TruncatedNormal(0.0, 1.0, low=0.0, high=1.0)
    assert float(d.log_prob(torch.tensor(-5.0))) == -np.inf
    assert float(d.log_prob(torch.tensor(2.0))) == -np.inf
    far = tdist.TruncatedNormal(0.0, 1.0, low=9.0, high=10.0)
    lp = float(far.log_prob(torch.tensor(9.1)))
    ref = (-0.5 * 9.1 ** 2 - 0.5 * math.log(2 * math.pi)
           - math.log(0.5 * math.erfc(9.0 / math.sqrt(2))
                      - 0.5 * math.erfc(10.0 / math.sqrt(2))))
    np.testing.assert_allclose(lp, ref, rtol=1e-3)
    np.testing.assert_allclose(lp, float(jax.jit(
        lambda v: jdist.TruncatedNormal(0.0, 1.0, low=9.0, high=10.0)
        .log_prob(v))(jnp.asarray(9.1))), rtol=RTOL)
    # the sampler keeps its mass far in the tail too
    x = far.sample(torch.Generator().manual_seed(0), (20_000,))
    assert bool(((x >= 9.0) & (x <= 10.0)).all())
    mean = float(_trunc_normal_moments(dict(
        loc=np.zeros(1), scale=np.ones(1), low=np.full(1, 9.0),
        high=np.full(1, 10.0)))[0][0])
    assert abs(float(x.mean()) - mean) < 5 * float(x.std()) / math.sqrt(
        20_000)


def test_ordered_logistic_extreme_predictor_and_bad_cutpoints():
    """JAX ``tests/test_dist.py:314``/``:328``: the tail category's
    log-prob is the linear logistic tail at an extreme predictor, and
    non-ascending cutpoints give NaN."""
    cp = [-1.0, 0.5, 2.0]
    d = tdist.OrderedLogistic(torch.tensor(40.0), torch.tensor(cp))
    np.testing.assert_allclose(float(d.log_prob(torch.tensor(0))), -41.0,
                               atol=1e-3)
    assert torch.isfinite(d.log_prob(torch.arange(4))).all()
    np.testing.assert_allclose(float(d.probs.sum(-1)), 1.0, rtol=1e-6)
    want = jax.jit(lambda c, k: jdist.OrderedLogistic(40.0, c).log_prob(k))(
        jnp.asarray(cp), jnp.arange(4))
    np.testing.assert_allclose(d.log_prob(torch.arange(4)).numpy(),
                               np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    bad = tdist.OrderedLogistic(torch.tensor(0.0), torch.tensor([1.0, -1.0]))
    assert torch.isnan(bad.log_prob(torch.arange(3))).any()


def test_von_mises_small_kappa():
    """JAX ``tests/test_compound.py::test_von_mises_small_kappa``: at tiny
    kappa the draws are near uniform on the circle, not a point mass."""
    for kappa in (0.0, 1e-5, 1e-4, 1e-2):
        x = tdist.VonMises(0.5, kappa).sample(
            torch.Generator().manual_seed(7), (20_000,)).numpy()
        assert x.std() > 1.5
        assert np.abs(np.exp(1j * x).mean()) < 0.05 + kappa
        assert np.all((x >= -np.pi) & (x <= np.pi))


@pytest.mark.parametrize("conc,rate", [(0.05, 0.05), (0.05, 10.0),
                                       (10.0, 0.05), (10.0, 10.0),
                                       (0.7, 3.3), (4.2, 0.2)])
def test_gamma_log_prob_finite_on_support(conc, rate):
    """JAX ``tests/test_properties.py::test_gamma_logprob_finite_on_support``
    at the corners of its range."""
    xs = torch.tensor([1e-6, 1e-3, 0.1, 1.0, 10.0, 100.0])
    lp = tdist.Gamma(conc, rate).log_prob(xs)
    assert torch.isfinite(lp).all()
    np.testing.assert_allclose(lp.numpy(), np.asarray(jdist.Gamma(
        conc, rate).log_prob(jnp.asarray(xs.numpy()))), rtol=RTOL, atol=1e-5)


def test_truncated_bisection_and_censored_mass():
    """``Truncated`` without an icdf samples by bisection on the cdf;
    ``Censored`` puts the tail mass at its bounds."""
    base = tdist.Gamma(2.0, 1.0)
    assert not hasattr(base, "icdf")
    d = tdist.Truncated(base, lower=0.5, upper=3.0)
    x = d.sample(torch.Generator().manual_seed(3), (20_000,))
    assert bool(((x >= 0.5) & (x <= 3.0)).all())
    # the sample cdf at a midpoint against the truncated cdf
    f = base.cdf(torch.tensor([0.5, 1.5, 3.0]))
    want = float((f[1] - f[0]) / (f[2] - f[0]))
    got = float((x <= 1.5).float().mean())
    assert abs(got - want) < 5 * math.sqrt(want * (1 - want) / 20_000)
    c = tdist.Censored(tdist.Normal(0.0, 1.0), lower=-0.5, upper=1.0)
    xc = c.sample(torch.Generator().manual_seed(4), (20_000,))
    at_lo = float((xc == -0.5).float().mean())
    p_lo = float(tdist.Normal(0.0, 1.0).cdf(torch.tensor(-0.5)))
    assert abs(at_lo - p_lo) < 5 * math.sqrt(p_lo * (1 - p_lo) / 20_000)
