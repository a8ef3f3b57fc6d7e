"""Parity of the port's resampling (``parallel/resample.py``) and tempered
SMC engine (``infer/smc``) with the JAX package.

Weights, particles and log-likelihoods are made with numpy and go to both
packages; the JAX shared uniform u0 is read from its key and handed to the
port, so both resample with the same offset.  Tolerances: prefix sums
atol 1e-6 (rtol 1e-6), the ancestors exactly equal; one SMC stage's beta,
evidence increment and ESS rtol 1e-5, the resample decision equal.  An
evidence oracle (a conjugate normal model with a closed-form log Z) holds
the whole loop.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.infer.smc import SMC as JSMC
from bayesic_tpu.models import gmm as jgmm
from bayesic_tpu.parallel import resample as jres
from bayesic_tpu_torch import dist, interop
from bayesic_tpu_torch.core import sample
from bayesic_tpu_torch.infer.smc import SMC, stage_draws
from bayesic_tpu_torch.models import gmm as tgmm
from bayesic_tpu_torch.parallel import resample as tres

torch.set_num_threads(2)


def test_weights_ess_and_compensated_cumsum_match_jax():
    rng = np.random.default_rng(0)
    lw = rng.normal(0, 3, 5000).astype(np.float32)
    for f in ("normalize_log_weights", "effective_sample_size"):
        np.testing.assert_allclose(
            getattr(tres, f)(torch.as_tensor(lw)).numpy(),
            np.asarray(getattr(jres, f)(jnp.asarray(lw))), rtol=1e-5)
    w = rng.uniform(0, 1, 5000).astype(np.float32) / 5000
    for n in (700, 5000):
        got = tres.compensated_cumsum(torch.as_tensor(w[:n])).numpy()
        want = np.asarray(jres.compensated_cumsum(jnp.asarray(w[:n])))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, np.cumsum(w[:n].astype(np.float64)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_out", [None, 333])
def test_systematic_ancestors_match_jax_with_the_same_u0(num_out):
    rng = np.random.default_rng(1)
    lw = rng.normal(0, 2, 3000).astype(np.float32)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jres.systematic_ancestors(key, jnp.asarray(lw),
                                                    num_out))
        u0 = float(jax.random.uniform(key))
        got = tres.systematic_ancestors(u0, torch.as_tensor(lw), num_out)
        np.testing.assert_array_equal(got.numpy(), want)
    parts, idx = tres.systematic_resample(
        torch.Generator().manual_seed(0), torch.as_tensor(lw),
        {"a": torch.arange(3000)})
    assert torch.equal(parts["a"], idx)


def _gmm_pair(n_data=100, particles=64):
    cfg = tgmm.Config(num_data=n_data, num_particles=particles,
                      mutation_steps=2, leapfrog_steps=3)
    x, _ = tgmm.make_data(cfg)
    jcfg = jgmm.Config(num_data=n_data, num_particles=particles)
    jsmc = JSMC(jgmm.make_model(jcfg, jgmm.make_data(jcfg)[0]),
                num_particles=particles)
    tsmc = tgmm.make_smc(cfg, torch.as_tensor(x), "generic")
    return jsmc, tsmc


@pytest.mark.parametrize("beta", [0.0, 0.4])
def test_one_stage_matches_jax_arithmetic(beta):
    """The stage's temperature, evidence increment, ESS and resampling
    decision from the same particles, carried weights and draws."""
    jsmc, tsmc = _gmm_pair()
    rng = np.random.default_rng(2)
    q = rng.normal(0, 0.6, (64, tsmc.dim)).astype(np.float32)
    log_w = rng.normal(0, 0.5 if beta else 0.0, 64).astype(np.float32)
    ll_j = np.asarray(jax.vmap(
        lambda qq: jsmc.logdensity.parts(jsmc._unravel(qq))[1])(
            jnp.asarray(q)))
    ll_t = tsmc._loglik(interop.smc_particles(q, tsmc.dim))
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-5)
    nb_j = float(jsmc._next_beta(jnp.float32(beta), jnp.asarray(ll_j),
                                 jnp.asarray(log_w)))
    delta = nb_j - beta
    inc_j = float(jax.scipy.special.logsumexp(
        jres.normalize_log_weights(jnp.asarray(log_w)) + delta * ll_j))
    ess_j = float(jres.effective_sample_size(jnp.asarray(log_w)
                                             + delta * ll_j))
    draws = stage_draws(torch.Generator().manual_seed(3), 64, tsmc.dim,
                        tsmc.mutation_steps)
    out = tsmc.stage(torch.as_tensor(q), torch.as_tensor(log_w),
                     torch.tensor(beta), None, torch.tensor(0.2), draws)
    np.testing.assert_allclose(float(out[2]), nb_j, rtol=1e-5)
    np.testing.assert_allclose(float(out[3]), inc_j, rtol=1e-5)
    resampled = bool((out[1] == 0).all())
    assert resampled == (ess_j < 0.5 * 64)
    ess_t = tres.effective_sample_size(torch.as_tensor(log_w)
                                       + (float(out[2]) - beta) * ll_t)
    np.testing.assert_allclose(float(ess_t), ess_j, rtol=1e-4)
    assert 0.0 < float(out[5]) <= 1.0 and float(out[4]) > 0.0


def test_stage_draws_order_and_range():
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    a = stage_draws(g1, 50, 4, 3)
    u0 = torch.rand((), generator=g2)
    mom = torch.randn((3, 50, 4), generator=g2)
    assert float(a.u0) == float(u0) and torch.equal(a.mom, mom)
    assert a.log_u.shape == (50, 3) and bool((a.log_u < 0).all())
    assert bool(torch.isfinite(a.log_u).all())


def test_evidence_oracle_normal_model():
    """mu ~ N(0, 1), y_i ~ N(mu, 1): log Z is closed form; the SMC
    estimate at 2000 particles lands within 0.1 of it, with a posterior
    mean within 0.05 of the exact one."""
    y = np.random.default_rng(4).normal(0.8, 1.0, 20).astype(np.float32)
    n, s = len(y), float(y.sum())
    log_z = (-0.5 * n * math.log(2 * math.pi) - 0.5 * math.log(n + 1)
             - 0.5 * float((y ** 2).sum()) + 0.5 * s * s / (n + 1))
    yt = torch.as_tensor(y)

    def model():
        mu = sample("mu", dist.Normal(0.0, 1.0))
        sample("obs", dist.Normal(mu, 1.0).expand((n,)).to_event(1), obs=yt)

    res = SMC(model, num_particles=2000, device="cpu").run(0)
    assert res.num_stages >= 2
    assert abs(float(res.log_evidence) - log_z) < 0.1
    post = float((torch.exp(res.log_weights) * res.particles["mu"]).sum())
    assert abs(post - s / (n + 1)) < 0.05
    draws = SMC.equal_weight_samples(res, 0.5, 500)
    assert draws["mu"].shape == (500,)


def test_nudge_and_precondition_options():
    cfg = tgmm.Config(num_data=50, num_particles=128, mutation_steps=2,
                      leapfrog_steps=3)
    x = torch.as_tensor(tgmm.make_data(cfg)[0])
    for kw in (dict(step_adapt="nudge"), dict(precondition=True)):
        res = tgmm.make_smc(cfg, x, "generic", **kw).run(1)
        assert torch.isfinite(res.log_evidence) and res.num_stages >= 2
    with pytest.raises(ValueError, match="step_adapt"):
        SMC(tgmm.make_model(cfg, x), step_adapt="other", device="cpu")
