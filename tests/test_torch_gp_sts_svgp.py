"""Parity of the port's GP, structural time series and SVGP models
(``models/{gp,sts,svgp}.py``) with ``bayesic_tpu.models``.

The same numpy data and points go through both packages, in float64 (JAX
under ``jax.enable_x64``, each JAX side jitted).  Limits: rtol 1e-9 (atol
1e-12 where values cross zero) for the STS system matrices, its forecast
and decomposition given JAX's series, the GP marginal likelihood and the
SVGP's optimal q and predictions; rtol 1e-9 for the three models'
log-densities (the SVGP's at a fixed subsample index) and rtol 1e-8 /
atol 1e-10 for their gradients against JAX's ``build_logjoint``.  One
short run of each model's entry point on the CPU checks that it runs
and returns finite results of the right shapes; the posterior gates run
on the card (``chip_smoke.py`` phase 31).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.core.logjoint import build_logjoint as jbuild
from bayesic_tpu.models import gp as jgp
from bayesic_tpu.models import sts as jsts
from bayesic_tpu.models import svgp as jsvgp
from bayesic_tpu_torch.core.logjoint import build_logjoint as tbuild
from bayesic_tpu_torch.models import gp as tgp
from bayesic_tpu_torch.models import sts as tsts
from bayesic_tpu_torch.models import svgp as tsvgp

torch.set_num_threads(2)
RTOL, ATOL = 1e-9, 1e-12
GRAD_RTOL, GRAD_ATOL = 1e-8, 1e-10


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _f64(*xs):
    return [torch.tensor(np.asarray(x), dtype=torch.float64) for x in xs]


def _density_parity(jmodel_fn, tmodel, points, subsample=None):
    """JAX's and the port's log-density and gradient at ``points`` (a dict
    of (n, *shape) float64 arrays), in float64; ``jmodel_fn()`` builds the
    JAX model (under x64, so that its data stay float64)."""
    with jax.enable_x64(True):
        _, jld, _, _ = jbuild(jmodel_fn())
        jsub = None if subsample is None else {
            k: jnp.asarray(v) for k, v in subsample.items()}
        want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(
            lambda u: jld(u, subsample=jsub))))(
                {k: jnp.asarray(v) for k, v in points.items()})
        want_v, want_g = np.asarray(want_v), jax.tree.map(np.asarray,
                                                          want_g)
    _, tld, _, _ = tbuild(tmodel, rng_key=torch.Generator().manual_seed(0))
    tsub = None if subsample is None else {
        k: torch.tensor(v) for k, v in subsample.items()}
    got_g, got_v = torch.func.vmap(torch.func.grad_and_value(
        lambda u: tld(u, subsample=tsub)))(
            {k: torch.tensor(v) for k, v in points.items()})
    _close(got_v, want_v)
    for k in points:
        _close(got_g[k], want_g[k], rtol=GRAD_RTOL, atol=GRAD_ATOL)


# -- structural time series -------------------------------------------------

def test_sts_system_matrices():
    """tests/test_sts.py:16's seasonal rotation, and equal to JAX's."""
    f, h = tsts._system_matrices(4)
    jf, jh = jsts._system_matrices(4)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(h, jh)
    z = np.array([1.0, 0.5, 0.3, -0.2, 0.1])
    z2 = f @ z
    assert z2[0] == pytest.approx(1.5) and z2[1] == pytest.approx(0.5)
    assert z2[2] == pytest.approx(-(0.3 - 0.2 + 0.1))
    assert (h @ z)[0] == pytest.approx(1.3)


def _sts_series(cfg):
    with jax.enable_x64(True):
        lg = jsts.make_lgss(cfg, cfg.sigma_level, cfg.sigma_slope,
                            cfg.sigma_seas, cfg.sigma_obs)
        return np.asarray(lg.sample(jax.random.PRNGKey(cfg.seed)))


def test_sts_forecast_and_decompose_given_jax_series():
    cfg = tsts.Config(t_len=20, season=7, horizon=9, seed=5, device="cpu")
    jcfg = jsts.Config(t_len=20, season=7, horizon=9, seed=5)
    x = _sts_series(jcfg)
    scales = (0.2, 0.03, 0.1, 0.25)
    with jax.enable_x64(True):
        want_f = jax.tree.map(np.asarray, jax.jit(
            lambda xx: jsts.forecast(xx, jcfg, *scales))(jnp.asarray(x)))
        want_d = jax.tree.map(np.asarray, jax.jit(
            lambda xx: jsts.decompose(xx, jcfg, *scales))(jnp.asarray(x)))
    xt, *st = _f64(x, *scales)
    got_m, got_s = tsts.forecast(xt, cfg, *st)
    _close(got_m, want_f[0])
    _close(got_s, want_f[1])
    got_d = tsts.decompose(xt, cfg, *st)
    for k in want_d:
        _close(got_d[k], want_d[k])


def test_sts_log_density_and_grad_match_jax():
    cfg = tsts.Config(t_len=20, seed=2, device="cpu")
    jcfg = jsts.Config(t_len=20, seed=2)
    x = _sts_series(jcfg)
    rng = np.random.default_rng(3)
    pts = {k: rng.normal(-2.0, 0.5, 3) for k in (
        "sigma_level", "sigma_slope", "sigma_seas", "sigma_obs")}
    _density_parity(lambda: jsts.make_model(jnp.asarray(x), jcfg),
                    tsts.make_model(torch.tensor(x), cfg), pts)


def test_sts_run_smoke():
    cfg = tsts.Config(t_len=10, season=4, num_warmup=4, num_samples=4,
                      num_chains=2, horizon=5, device="cpu")
    out = tsts.run(cfg)
    assert set(out["samples"]) == {"sigma_level", "sigma_slope",
                                   "sigma_seas", "sigma_obs"}
    assert out["samples"]["sigma_obs"].shape == (2, 4)
    assert out["forecast_mean"].shape == (5,)
    assert np.all(out["forecast_std"] > 0)
    assert np.all(np.isfinite(out["trend"]))


# -- GP regression ----------------------------------------------------------

def test_gp_data_kernel_and_log_marginal_match_jax():
    cfg = tgp.Config(n=40, device="cpu")
    jcfg = jgp.Config(n=40)
    x, y, f = tgp.make_data(cfg)
    jx, jy, jf = jgp.make_data(jcfg)
    for a, b in ((x, jx), (y, jy), (f, jf)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    xd, yd = _f64(jx, jy)
    with jax.enable_x64(True):
        args = (jnp.asarray(xd.numpy()), jnp.asarray(yd.numpy()))
        want = [float(jax.jit(lambda a, b, ls=ls: jgp.log_marginal(
            a, b, ls, 1.0, 0.2))(*args)) for ls in (0.05, 0.4, 3.0)]
        want_k = np.asarray(jgp.rbf(args[0], args[0], 0.4, 1.0))
        jmean, jcov = jgp.analytic_posterior(*args, jcfg)
    got = [float(tgp.log_marginal(xd, yd, ls, 1.0, 0.2))
           for ls in (0.05, 0.4, 3.0)]
    _close(got, want)
    _close(tgp.rbf(xd, xd, 0.4, 1.0), want_k)
    mean, cov = tgp.analytic_posterior(xd, yd, cfg)
    _close(mean, jmean)
    _close(cov, jcov)


def test_gp_log_density_and_grad_match_jax():
    cfg = tgp.Config(n=32, device="cpu")
    jcfg = jgp.Config(n=32)
    xd, yd, _ = _f64(*jgp.make_data(jcfg))
    tmodel, _ = tgp.make_model(xd, yd, cfg)
    pts = {"z": np.random.default_rng(4).standard_normal((3, 32))}
    _density_parity(lambda: jgp.make_model(jnp.asarray(xd.numpy()),
                                           jnp.asarray(yd.numpy()), jcfg)[0],
                    tmodel, pts)


def test_gp_factor_in_float64_where_jax_float32_fails():
    """A fault of the reference the port does not copy: at its default n
    256 the JAX package's float32 chol_K is NaN (K's smallest eigenvalue
    is the jitter), so its gp.run returns NaN there.  The port factors in
    float64 and returns the exact factor in float32."""
    jcfg, cfg = jgp.Config(), tgp.Config(device="cpu")
    jx, _, _ = jgp.make_data(jcfg)
    assert not np.all(np.isfinite(np.asarray(jgp.chol_K(jx, jcfg))))
    x, _, _ = tgp.make_data(cfg)
    got = tgp.chol_K(x, cfg)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    with jax.enable_x64(True):
        want = np.asarray(jgp.chol_K(jnp.asarray(x.numpy(), jnp.float64),
                                     jcfg))
    _close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sampler", ["ess", "nuts"])
def test_gp_run_smoke(sampler):
    cfg = tgp.Config(n=16, num_samples=8, num_burnin=6, num_chains=2,
                     device="cpu")
    out = tgp.run(cfg, sampler=sampler)
    assert out["f_mean"].shape == (16,)
    assert np.isfinite(out["max_mean_err"]) and np.isfinite(
        out["rmse_truth"])


# -- sparse variational GP --------------------------------------------------

def test_svgp_log_density_at_a_subsample_and_grad_match_jax():
    cfg = tsvgp.Config(n=256, num_inducing=16, batch=32, device="cpu")
    jcfg = jsvgp.Config(n=256, num_inducing=16, batch=32)
    xd, yd, _ = _f64(*jsvgp.make_data(jcfg))
    tmodel, _, _ = tsvgp.make_model(xd, yd, cfg)
    idx = np.random.default_rng(5).choice(256, 32, replace=False)
    pts = {"v": 0.3 * np.random.default_rng(6).standard_normal((3, 16))}
    _density_parity(lambda: jsvgp.make_model(
        jnp.asarray(xd.numpy()), jnp.asarray(yd.numpy()), jcfg)[0],
        tmodel, pts, subsample={"data__idx": idx})


def test_svgp_optimal_q_and_predict_match_jax():
    cfg = tsvgp.Config(n=128, num_inducing=12, batch=128, device="cpu")
    jcfg = jsvgp.Config(n=128, num_inducing=12, batch=128)
    xd, yd, _ = _f64(*jsvgp.make_data(jcfg))
    x_new = np.linspace(-2.5, 2.5, 9)
    with jax.enable_x64(True):
        jx, jy = jnp.asarray(xd.numpy()), jnp.asarray(yd.numpy())
        _, jproject, _ = jsvgp.make_model(jx, jy, jcfg)
        want_q = jsvgp.optimal_q(jx, jy, jcfg, jproject)
        want_p = jsvgp.predict(want_q[0], want_q[1], jproject, x_new, jcfg)
    _, tproject, _ = tsvgp.make_model(xd, yd, cfg)
    got_q = tsvgp.optimal_q(xd, yd, cfg, tproject)
    got_p = tsvgp.predict(got_q[0], got_q[1], tproject,
                          torch.tensor(x_new), cfg)
    for got, want in zip(got_q + got_p, want_q + want_p):
        _close(got, want, rtol=1e-8, atol=1e-11)


def test_svgp_svi_given_jax_noise_matches_jax():
    """run_svi's engine on the SVGP: 300 full-rank SVI steps at
    tests/test_svgp.py:19's sizes, each fed the noise JAX's SVI.step
    draws from its key, end where JAX's run_svi(PRNGKey(0)) ends (float32
    on both sides: rtol 1e-4 / atol 1e-5)."""
    steps = 300
    jcfg = jsvgp.Config(n=256, num_inducing=16, batch=256, steps=steps)
    want = jsvgp.run_svi(jcfg, jax.random.PRNGKey(0))
    key, _ = jax.random.split(jax.random.PRNGKey(0))      # SVI.init's

    def body(k, _):
        k, k_q, _ = jax.random.split(k, 3)               # SVI.step's
        return k, jax.random.normal(k_q, (1, 16))

    eps = np.asarray(jax.jit(lambda k: jax.lax.scan(
        body, k, None, length=steps)[1])(key))
    cfg = tsvgp.Config(n=256, num_inducing=16, batch=256, steps=steps,
                       device="cpu")
    x, y, _ = tsvgp.make_data(cfg)
    model, _, _ = tsvgp.make_model(x, y, cfg)
    svi = tsvgp.SVI(model, tsvgp.FullRankGuide, tsvgp.Adam(
        tsvgp.cosine_decay_schedule(cfg.lr, steps)), device="cpu")
    state = svi.init(torch.Generator().manual_seed(0))
    for i in range(steps):
        state, _ = svi.step(state, eps=torch.tensor(eps[i]))
    mean = svi.guide.stats(state.params)[0]["v"]
    cov = svi.guide.covariance(state.params)
    _close(mean.detach(), want["v_mean"], rtol=1e-4, atol=1e-5)
    _close(cov.detach(), want["v_cov"], rtol=1e-4, atol=1e-5)


def test_svgp_run_smoke():
    cfg = tsvgp.Config(n=256, num_inducing=8, batch=64, steps=30,
                       device="cpu")
    out = tsvgp.run_svi(cfg)
    assert out["losses"].shape == (30,) and np.all(np.isfinite(
        out["losses"]))
    assert out["v_cov"].shape == (8, 8)
    np.testing.assert_allclose(out["v_cov"], out["v_cov"].T, atol=1e-6)
    assert np.isfinite(out["rmse_truth"])
