"""Parity of the port's MAP/Laplace (``infer/laplace.py``) and SVGD
(``infer/svgd.py``) with the JAX package.

The MAP run starts both packages from the same point: the loss trace and
the final iterate of the port's ``Adam`` against ``optax.adam`` at rtol
1e-4 (200 float32 steps).  ``Laplace`` fitted from the same start: the
mean at atol 1e-5, ``cov`` and the evidence at rtol 1e-4, draws given the
same normals at rtol 1e-4.  One SVGD update from the same particles and
mini-batches: the kernel, repulsion and bandwidth at rtol 1e-5, the new
particles after two Adam steps at rtol 1e-5 (atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.core import plate as jplate, sample as jsample
from bayesic_tpu.infer import laplace as jlap
from bayesic_tpu.infer import svgd as jsvgd
from bayesic_tpu.infer.svi.elbo import draw_subsample as jdraw_subsample
from bayesic_tpu_torch.core import plate as tplate, sample as tsample
from bayesic_tpu_torch.infer import laplace as tlap
from bayesic_tpu_torch.infer import svgd as tsvgd
from bayesic_tpu_torch.infer.svi import Adam

torch.set_num_threads(2)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _linreg(sample, dist, arr, seed=1, n=40, sigma=0.5, prior_sd=2.0):
    """tests/test_laplace.py:17's linear-Gaussian model."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, n).astype(np.float32) + 0.5
    y = (1.2 * x - 0.4 + rng.normal(0, sigma, n)).astype(np.float32)
    xa, ya = arr(x), arr(y)

    def model():
        w = sample("w", dist.Normal(0.0, prior_sd))
        b = sample("b", dist.Normal(0.0, prior_sd))
        sample("obs", dist.Normal(w * xa + b, sigma).to_event(1), obs=ya)
    return model


def _halfnormal(sample, dist, arr):
    y = np.abs(np.random.default_rng(2).normal(0, 1.3, 80)).astype(
        np.float32)
    ya = arr(y)

    def model():
        s = sample("s", dist.HalfNormal(5.0))
        sample("obs", dist.HalfNormal(s).expand((80,)).to_event(1), obs=ya)
    return model


MODELS = {"linreg": (_linreg, {"b": 0.3, "w": -0.2}),
          "halfnormal": (_halfnormal, {"s": 0.1})}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_map_iterates_match_jax_adam(name):
    make, init = MODELS[name]
    ji = {k: jnp.asarray(np.float32(v)) for k, v in init.items()}
    ti = {k: torch.tensor(np.float32(v)) for k, v in init.items()}
    jr = jlap.map_estimate(make(jsample, jdist, jnp.asarray), num_steps=200,
                           init=ji)
    tr = tlap.map_estimate(make(tsample, tdist, torch.tensor), num_steps=200,
                           init=ti)
    _close(tr.losses, jr.losses, rtol=1e-4)
    for k in init:
        _close(tr.uparams[k], jr.uparams[k], rtol=1e-4, atol=1e-6)
        _close(tr.params[k], jr.params[k], rtol=1e-4, atol=1e-6)
    _close(tr.log_joint, jr.log_joint, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_laplace_cov_and_evidence_match_jax(name):
    make, init = MODELS[name]
    ji = {k: jnp.asarray(np.float32(v)) for k, v in init.items()}
    ti = {k: torch.tensor(np.float32(v)) for k, v in init.items()}
    jl = jlap.Laplace(make(jsample, jdist, jnp.asarray)).fit(
        num_steps=300, init=ji)
    tl = tlap.Laplace(make(tsample, tdist, torch.tensor),
                      device="cpu").fit(num_steps=300, init=ti)
    _close(tl.mean, jl.mean, rtol=1e-4, atol=1e-5)
    _close(tl.cov, jl.cov, rtol=1e-4, atol=1e-8)
    _close(tl.log_evidence, jl.log_evidence, rtol=1e-4)
    key = jax.random.PRNGKey(5)
    z = jax.random.normal(key, (64, tl.mean.shape[0]), jnp.float32)
    _close(tl.sample_unconstrained(None, normals=torch.tensor(np.array(z))),
           jl.sample_unconstrained(key, 64), rtol=1e-4, atol=1e-5)
    draws = tl.sample_posterior(None, normals=torch.tensor(np.array(z)))
    assert set(draws) == set(init)
    if name == "halfnormal":
        assert bool((draws["s"] > 0).all())


def test_laplace_is_exact_on_the_linear_gaussian_model():
    """tests/test_laplace.py:49's oracle, float64 closed forms."""
    sigma, prior_sd = 0.5, 2.0
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 1.0, 40).astype(np.float32) + 0.5
    y = (1.2 * x - 0.4 + rng.normal(0, sigma, 40)).astype(np.float32)
    xm = np.stack([np.ones_like(x), x], 1).astype(np.float64)
    cov = np.linalg.inv(xm.T @ xm / sigma**2 + np.eye(2) / prior_sd**2)
    mean = cov @ (xm.T @ y.astype(np.float64)) / sigma**2
    lap = tlap.Laplace(_linreg(tsample, tdist, torch.tensor),
                       device="cpu").fit(num_steps=1000)
    _close(lap.mean, mean, rtol=0, atol=5e-3)
    _close(lap.cov, cov, rtol=0.02, atol=1e-5)


# -- SVGD ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 8])
def test_rbf_matches_jax_including_the_even_median(n):
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    jk, jrep, jh = jsvgd._rbf(jnp.asarray(x))
    tk, trep, th = tsvgd._rbf(torch.tensor(x))
    _close(th, jh)
    _close(tk, jk)
    _close(trep, jrep, atol=1e-5)


def _sub_model(sample, plate, dist, arr):
    """tests/test_svgd.py:55's subsampled plate."""
    y = arr(np.random.default_rng(2).normal(-0.5, 1.0, 256)
            .astype(np.float32))

    def model():
        mu = sample("mu", dist.Normal(0.0, 2.0))
        with plate("data", 256, subsample_size=64) as idx:
            sample("obs", dist.Normal(mu, 1.0), obs=y[idx])
    return model


def test_svgd_update_matches_jax_from_the_same_particles_and_batch():
    n = 16
    js = jsvgd.SVGD(_sub_model(jsample, jplate, jdist, jnp.asarray),
                    num_particles=n, optimizer=optax.adam(3e-2))
    ts = tsvgd.SVGD(_sub_model(tsample, tplate, tdist, torch.tensor),
                    num_particles=n, optimizer=Adam(3e-2), device="cpu")
    x = np.random.default_rng(3).normal(size=(n, 1)).astype(np.float32)
    jx, jopt = jnp.asarray(x), js.optimizer.init(jnp.asarray(x))
    tx, topt = torch.tensor(x), ts.optimizer.init(torch.tensor(x))
    @jax.jit
    def jstep(jx, jopt, t):
        # the body of the JAX SVGD.run step, and the mini-batches it draws
        kb = jax.random.fold_in(jax.random.PRNGKey(4), t)
        keys = jax.vmap(lambda i: jax.random.fold_in(kb, i))(jnp.arange(n))
        grads = jax.vmap(js._grad_logp)(jx, keys)
        k, rep, h = jsvgd._rbf(jx)
        phi = (k @ grads + rep) / n
        updates, jopt = js.optimizer.update(-phi, jopt, jx)
        idx = jax.vmap(lambda kk: jdraw_subsample(js.info, kk)["data__idx"]
                       )(keys)
        return optax.apply_updates(jx, updates), jopt, phi, h, idx

    for t in range(2):
        jx, jopt, phi, h, idx = jstep(jx, jopt, t)
        tx, topt, pn, th = ts.step(tx, topt, {"data__idx": torch.tensor(
            np.array(idx))})
        _close(th, h)
        _close(pn, jnp.sqrt(jnp.mean(phi * phi)), rtol=1e-4)
        _close(tx, jx)


def test_svgd_run_recovers_subsampled_posterior_mean():
    """tests/test_svgd.py:55's gate (|mean - ybar| < 0.1) at 32 particles
    and 400 steps."""
    ts = tsvgd.SVGD(_sub_model(tsample, tplate, tdist, torch.tensor),
                    num_particles=32, num_steps=400, optimizer=Adam(3e-2),
                    device="cpu")
    res = ts.run(2)
    y = np.random.default_rng(2).normal(-0.5, 1.0, 256).astype(np.float32)
    assert abs(float(res.samples["mu"].mean()) - float(y.mean())) < 0.1
    assert torch.isfinite(res.extra["phi_norm"]).all()
    assert res.unconstrained.shape == (32, 1)
