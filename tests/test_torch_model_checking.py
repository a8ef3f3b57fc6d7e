"""Parity of the port's model-checking tools with the JAX package's:
``Predictive``, ``log_likelihood``, ``utils.compare`` (WAIC, PSIS-LOO,
``compare``), ``utils.sbc`` and ``utils.metrics.MetricsLogger``, on the
same seeded numpy inputs through both packages.

Tolerances: ``log_likelihood`` at rtol 1e-5 (float32, as both packages
evaluate); WAIC, PSIS-LOO (k-hat and elpd) and ``compare`` at rtol 1e-10
on the same float64 matrices; SBC ranks equal and p-values at rtol 1e-12
when ``prior_fn``/``run_fn`` depend on the simulation index alone;
predictive draws in law within 4 Monte-Carlo standard errors."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import bayesic_tpu.core as jcore
import bayesic_tpu.dist as jdist
import bayesic_tpu_torch as bt
import bayesic_tpu_torch.core as tcore
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.infer import log_likelihood as j_loglik
from bayesic_tpu.infer.predictive import Predictive as JPredictive
from bayesic_tpu.utils import compare as jcmp
from bayesic_tpu.utils import metrics as jmetrics
from bayesic_tpu.utils import sbc as jsbc
from bayesic_tpu_torch.infer import log_likelihood as t_loglik
from bayesic_tpu_torch.infer.predictive import Predictive as TPredictive
from bayesic_tpu_torch.utils import compare as tcmp
from bayesic_tpu_torch.utils import metrics as tmetrics
from bayesic_tpu_torch.utils import sbc as tsbc

torch.set_num_threads(2)

J = dict(core=jcore, dist=jdist, a=jnp.asarray, exp=jnp.exp)
T = dict(core=tcore, dist=tdist, a=torch.as_tensor, exp=torch.exp)

X = np.array([0.5, -1.0, 2.0, 0.0, 1.2], np.float32)
Y = np.array([0.2, 0.4, 1.5, -0.3, 0.9], np.float32)


def _regression(pk):
    """w ~ N(0, 1), s ~ HalfNormal(1), y_i ~ N(w x_i, s) in a plate, and a
    deterministic site."""
    core, dist, a = pk["core"], pk["dist"], pk["a"]

    def model(x, y=None):
        w = core.sample("w", dist.Normal(0.0, 1.0))
        s = core.sample("s", dist.HalfNormal(1.0))
        core.deterministic("w2", w * w)
        with core.plate("data", x.shape[0]):
            core.sample("obs", dist.Normal(w * x, s), obs=y)

    return model


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# Predictive
# ---------------------------------------------------------------------------

def test_predictive_sites_and_shapes_match_jax():
    samples = {"w": np.array([0.1, -0.3, 0.7], np.float32),
               "s": np.array([0.5, 1.0, 2.0], np.float32)}
    jargs, targs = (jnp.asarray(X), jnp.asarray(Y)), \
        (torch.as_tensor(X), torch.as_tensor(Y))
    for ret in (None, ("obs",), ("w2", "obs")):
        jout = JPredictive(_regression(J),
                           {k: jnp.asarray(v) for k, v in samples.items()},
                           model_args=jargs, return_sites=ret)(
            jax.random.PRNGKey(0))
        tout = TPredictive(_regression(T),
                           {k: torch.as_tensor(v) for k, v in samples.items()},
                           model_args=targs, return_sites=ret)(
            torch.Generator().manual_seed(0))
        assert set(tout) == set(jout)
        for k in jout:
            assert tuple(tout[k].shape) == tuple(jout[k].shape)
        if "w2" in tout:     # deterministic sites recorded exactly
            np.testing.assert_allclose(_np(tout["w2"]), samples["w"] ** 2,
                                       rtol=1e-6)
            np.testing.assert_allclose(np.asarray(jout["w2"]),
                                       samples["w"] ** 2, rtol=1e-6)
    # prior predictive: every site, num_samples draws
    jp = JPredictive(_regression(J), num_samples=7, model_args=jargs)(
        jax.random.PRNGKey(1))
    tp = TPredictive(_regression(T), num_samples=7, model_args=targs)(
        torch.Generator().manual_seed(1))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    with pytest.raises(ValueError, match="num_samples"):
        TPredictive(_regression(T))


def test_predictive_draws_in_law():
    """Posterior predictive obs ~ N(w x, s) given the draws; prior
    predictive obs has variance x^2 + E[s^2] = x^2 + 1."""
    n = 4000
    rng = np.random.default_rng(2)
    w = rng.normal(0.8, 0.1, n).astype(np.float32)
    s = np.full(n, 0.3, np.float32)
    out = TPredictive(_regression(T), {"w": torch.as_tensor(w),
                                       "s": torch.as_tensor(s)},
                      model_args=(torch.as_tensor(X),))(
        torch.Generator().manual_seed(3))
    obs = _np(out["obs"])
    mean_want = w.mean() * X
    sd_want = np.sqrt(0.01 * X ** 2 + 0.09)
    assert np.all(np.abs(obs.mean(0) - mean_want)
                  < 4 * sd_want / np.sqrt(n))
    prior = TPredictive(_regression(T), num_samples=n,
                        model_args=(torch.as_tensor(X),))(
        torch.Generator().manual_seed(4))
    var = _np(prior["obs"]).var(0)
    want = X.astype(np.float64) ** 2 + 1.0
    # var of a sample variance ~ 2 sigma^4 / n (heavier: a mixture)
    assert np.all(np.abs(var - want) < 4 * np.sqrt(6.0 / n) * want)


# ---------------------------------------------------------------------------
# log_likelihood
# ---------------------------------------------------------------------------

def test_log_likelihood_matches_jax_and_analytic():
    samples = {"w": np.array([0.1, -0.3, 0.7], np.float32),
               "s": np.array([0.5, 1.0, 2.0], np.float32)}
    jll = j_loglik(_regression(J),
                   {k: jnp.asarray(v) for k, v in samples.items()},
                   model_args=(jnp.asarray(X), jnp.asarray(Y)))
    tll = t_loglik(_regression(T),
                   {k: torch.as_tensor(v) for k, v in samples.items()},
                   model_args=(torch.as_tensor(X), torch.as_tensor(Y)))
    assert set(tll) == set(jll) == {"obs"}
    assert tuple(tll["obs"].shape) == (3, 5)
    np.testing.assert_allclose(_np(tll["obs"]), np.asarray(jll["obs"]),
                               rtol=1e-5)
    want = st.norm.logpdf(Y[None, :], samples["w"][:, None] * X[None, :],
                          samples["s"][:, None])
    np.testing.assert_allclose(_np(tll["obs"]), want, rtol=1e-5)
    assert bt.log_likelihood is t_loglik


def test_log_likelihood_missing_latent_and_errors():
    y = torch.tensor([0.2, 0.4])

    def model(y):
        mu = tcore.sample("mu", tdist.Normal(0.0, 1.0))
        tau = tcore.sample("tau", tdist.HalfNormal(1.0))
        tcore.sample("obs", tdist.Normal(mu, tau).expand((2,)).to_event(1),
                     obs=y)

    ll = t_loglik(model, {"mu": torch.zeros(5)}, model_args=(y,),
                  generator=torch.Generator().manual_seed(3))
    assert ll["obs"].shape == (5,)
    assert np.all(np.isfinite(_np(ll["obs"])))
    # tau differs draw to draw: each draw's prior sample is its own
    assert len(set(_np(ll["obs"]).tolist())) == 5
    with pytest.raises(ValueError, match="empty"):
        t_loglik(model, {}, model_args=(y,))

    def no_obs():
        tcore.sample("mu", tdist.Normal(0.0, 1.0))

    with pytest.raises(ValueError, match="no observed"):
        t_loglik(no_obs, {"mu": torch.zeros(2)})


# ---------------------------------------------------------------------------
# WAIC, PSIS-LOO, compare
# ---------------------------------------------------------------------------

def _normal_normal(seed=1, n=30, s=4000, tau0=2.0, sigma=1.0):
    """The JAX test's conjugate setup (test_compare.py:80): the pointwise
    log-likelihood of exact posterior draws, and the exact LOO elpd."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0.7, sigma, size=n)

    def post(ys):
        prec = 1.0 / tau0 ** 2 + len(ys) / sigma ** 2
        return (ys.sum() / sigma ** 2) / prec, np.sqrt(1.0 / prec)

    mu_n, s_n = post(y)
    draws = rng.normal(mu_n, s_n, size=s)
    ll = st.norm.logpdf(y[None, :], draws[:, None], sigma)
    exact = 0.0
    for i in range(n):
        m_i, s_i = post(np.delete(y, i))
        exact += st.norm.logpdf(y[i], m_i, np.sqrt(s_i ** 2 + sigma ** 2))
    return ll, exact


def _same(tr, jr):
    for f in ("elpd", "se", "p_eff"):
        np.testing.assert_allclose(getattr(tr, f), getattr(jr, f),
                                   rtol=1e-10)
    np.testing.assert_allclose(tr.pointwise, jr.pointwise, rtol=1e-10)
    if jr.pareto_k is None:
        assert tr.pareto_k is None
    else:
        np.testing.assert_allclose(tr.pareto_k, jr.pareto_k, rtol=1e-10)
    assert (tr.n_samples, tr.n_points, tr.method) == \
        (jr.n_samples, jr.n_points, jr.method)


@pytest.mark.parametrize("case", ["conjugate", "heavy", "dict"])
def test_waic_psis_loo_match_jax(case):
    if case == "conjugate":
        ll, _ = _normal_normal(seed=7)
    elif case == "heavy":
        # a Student-t spread puts some points' k-hat above 0.7
        rng = np.random.default_rng(9)
        ll = -0.5 * rng.standard_t(2.0, size=(800, 12)) ** 2
    else:
        rng = np.random.default_rng(10)
        ll = {"a": rng.normal(-1.0, 0.3, (300, 4)),
              "b": rng.normal(-2.0, 0.5, (300, 2, 3))}
    tin = {k: torch.as_tensor(v) for k, v in ll.items()} \
        if isinstance(ll, dict) else torch.as_tensor(ll)
    _same(tcmp.waic(tin), jcmp.waic(ll))
    _same(tcmp.psis_loo(tin), jcmp.psis_loo(ll))
    _same(tcmp.psis_loo(ll), jcmp.psis_loo(ll))           # numpy input too
    x = np.sort(np.random.default_rng(4).pareto(3.0, 500))
    np.testing.assert_allclose(tcmp._gpd_fit(x), jcmp._gpd_fit(x),
                               rtol=1e-10)


def test_psis_loo_against_exact_conjugate_loo():
    ll, exact = _normal_normal()
    r = tcmp.psis_loo(torch.as_tensor(ll))
    assert np.all(r.pareto_k < 0.7)
    assert 0.3 < r.p_eff < 3.0
    assert abs(r.elpd - exact) < 0.5, (r.elpd, exact)


def test_compare_matches_jax_and_rejects_mismatched_data():
    rng = np.random.default_rng(3)
    n, s, sigma = 40, 2000, 1.0
    y = rng.normal(0.0, sigma, size=n)
    draws = rng.normal(y.mean(), sigma / np.sqrt(n), size=s)
    good = st.norm.logpdf(y[None, :], draws[:, None], sigma)
    bad = st.norm.logpdf(y[None, :], draws[:, None] + 3.0, sigma)
    trows = tcmp.compare({"good": tcmp.psis_loo(good),
                          "bad": tcmp.waic(bad)})
    jrows = jcmp.compare({"good": jcmp.psis_loo(good),
                          "bad": jcmp.waic(bad)})
    assert [r["name"] for r in trows] == ["good", "bad"]
    for tr, jr in zip(trows, jrows):
        assert tr.keys() == jr.keys()
        for k in tr:
            if isinstance(jr[k], float):
                np.testing.assert_allclose(tr[k], jr[k], rtol=1e-10)
            else:
                assert tr[k] == jr[k]
    assert trows[1]["d_elpd"] > 5 * trows[1]["d_se"]
    assert tcmp.compare({}) == []
    with pytest.raises(ValueError, match="different data"):
        tcmp.compare({"a": tcmp.waic(rng.normal(size=(50, 10))),
                      "b": tcmp.waic(rng.normal(size=(50, 11)))})
    with pytest.raises(ValueError, match="non-finite"):
        tcmp.waic(np.full((5, 3), np.nan))


# ---------------------------------------------------------------------------
# SBC
# ---------------------------------------------------------------------------

def _indexed_fns(kind):
    """prior_fn / run_fn that draw from numpy seeded by a call counter
    (the simulation index), ignoring the key or generator, so both
    packages see the same simulations."""
    count = {"prior": 0, "run": 0}

    def prior_fn(_):
        rng = np.random.default_rng(1000 + count["prior"])
        count["prior"] += 1
        mu = rng.normal() * 2.0
        return {"mu": np.float64(mu),
                "v": rng.normal(size=2)}, mu + rng.normal(size=16)

    def run_fn(_, y):
        rng = np.random.default_rng(5000 + count["run"])
        count["run"] += 1
        post_var = 1.0 / (0.25 + 16.0)
        shift = 0.3 if kind == "shift" else 0.0
        mu = post_var * y.sum() + shift + np.sqrt(post_var) * rng.normal(
            size=99)
        return {"mu": mu, "v": rng.normal(size=(99, 2))}

    return prior_fn, run_fn


@pytest.mark.parametrize("kind,bins,thin", [("exact", 10, 1),
                                            ("shift", 7, 2)])
def test_sbc_matches_jax(kind, bins, thin):
    jres = jsbc.sbc(*_indexed_fns(kind), num_sims=60, num_bins=bins,
                    thin=thin, key=jax.random.PRNGKey(0))
    tres = tsbc.sbc(*_indexed_fns(kind), num_sims=60, num_bins=bins,
                    thin=thin, generator=torch.Generator().manual_seed(0))
    assert tres.num_bins == jres.num_bins
    for k in jres.ranks:
        np.testing.assert_array_equal(tres.ranks[k], jres.ranks[k])
        np.testing.assert_allclose(tres.pvalues[k], jres.pvalues[k],
                                   rtol=1e-12)
    np.testing.assert_allclose(tres.min_pvalue(), jres.min_pvalue(),
                               rtol=1e-12)


def _t_prior(generator):
    mu = torch.randn((), generator=generator, dtype=torch.float64) * 2.0
    y = mu + torch.randn(16, generator=generator, dtype=torch.float64)
    return {"mu": mu}, y


def _t_exact(generator, y, n=99, inflate=1.0, shift=0.0):
    post_var = 1.0 / (0.25 + 16.0)
    return {"mu": post_var * y.sum() + shift + post_var ** 0.5 * inflate
            * torch.randn(n, generator=generator, dtype=torch.float64)}


def test_sbc_calibrated_and_biased_samplers():
    """The JAX test's cases (test_sbc.py): the exact conjugate sampler
    passes uniformity, a shifted and an underdispersed one are caught."""
    res = tsbc.sbc(_t_prior, _t_exact, num_sims=200, num_bins=10,
                   generator=torch.Generator().manual_seed(0))
    assert res.ranks["mu"].shape == (200,)
    assert res.min_pvalue() > 0.01
    res = tsbc.sbc(_t_prior, lambda g, y: _t_exact(g, y, shift=0.3),
                   num_sims=200, num_bins=10,
                   generator=torch.Generator().manual_seed(1))
    assert res.min_pvalue() < 1e-3
    res = tsbc.sbc(_t_prior, lambda g, y: _t_exact(g, y, inflate=0.4),
                   num_sims=200, num_bins=10,
                   generator=torch.Generator().manual_seed(2))
    assert res.min_pvalue() < 1e-3


# ---------------------------------------------------------------------------
# MetricsLogger
# ---------------------------------------------------------------------------

def test_metrics_logger_records_match_jax(tmp_path):
    recs = []
    for mod, name in ((jmetrics, "jax"), (tmetrics, "torch")):
        buf = io.StringIO()
        path = tmp_path / f"{name}.jsonl"
        log = mod.MetricsLogger(path=str(path), stream=buf,
                                tensorboard_dir=str(tmp_path / f"tb_{name}"))
        assert log.enabled
        log.log(1, loss=3.5, lr=np.float32(0.01), note="warm")
        log.log(2, loss=torch.tensor(2.25) if name == "torch" else 2.25,
                elbo=-1)
        log.close()
        lines = path.read_text().splitlines()
        assert buf.getvalue().splitlines() == lines
        recs.append([{k: v for k, v in json.loads(s).items() if k != "t"}
                     for s in lines])
    assert recs[0] == recs[1]
    off = tmetrics.MetricsLogger(path=str(tmp_path / "off.jsonl"),
                                 enabled=False)
    off.log(1, loss=1.0)
    off.close()
    assert not (tmp_path / "off.jsonl").exists()


def test_profile_trace_writes_a_trace(tmp_path):
    with tmetrics.profile_trace(tmp_path / "prof"):
        with tmetrics.named_scope("step"):
            torch.ones(8).sum()
    assert list((tmp_path / "prof").iterdir())
