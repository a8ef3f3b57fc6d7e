"""Parity of the port's further MCMC samplers (``infer/mcmc/ess.py``,
``infer/mcmc/tempering.py``, ``infer/sgmcmc.py``) and of
``MCMC.warmup_and_sample`` with the JAX package.

Each transition core takes its draws as inputs: the tests draw what the
JAX function draws from its key and hand the same numbers to the port.
Inputs come from numpy with a seed.  Tolerances: float32 on both sides,
rtol 1e-5 (atol 1e-6 where values cross zero) for one update of anything
and for the evidence estimates; accept, swap and shrink-count decisions
must be equal; ``warmup_and_sample`` must equal ``run`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.core import plate as jplate, sample as jsample
from bayesic_tpu.infer.mcmc import ess as jess
from bayesic_tpu.infer.mcmc import tempering as jpt
from bayesic_tpu.infer import sgmcmc as jsg
from bayesic_tpu.infer.svi.elbo import draw_subsample as jdraw_subsample
from bayesic_tpu_torch.core import plate as tplate, sample as tsample
from bayesic_tpu_torch.infer import sgmcmc as tsg
from bayesic_tpu_torch.infer.mcmc import MCMC
from bayesic_tpu_torch.infer.mcmc import ess as tess
from bayesic_tpu_torch.infer.mcmc import tempering as tpt

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _np(x):
    return np.array(x)


def _logistic(sample, dist, x, y):
    """The whitened logistic regression of tests/test_ess_sampler.py:48."""
    def model():
        w = sample("w", dist.Normal(0.0, 1.0).expand((x.shape[1],))
                   .to_event(1))
        sample("obs", dist.Bernoulli(logits=x @ w).to_event(1), obs=y)
    return model


def _logistic_data(n=96, d=3, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_true = np.linspace(1.0, -1.0, d).astype(np.float32)
    p = 1 / (1 + np.exp(-x @ w_true))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return x, y


# -- elliptical slice ---------------------------------------------------------

def test_ess_transition_matches_jax_given_its_draws():
    x, y = _logistic_data()
    js = jess.EllipticalSlice(_logistic(jsample, jdist, jnp.asarray(x),
                                        jnp.asarray(y)), num_chains=6)
    ts = tess.EllipticalSlice(_logistic(tsample, tdist, torch.tensor(x),
                                        torch.tensor(y)), num_chains=6,
                              device="cpu")
    rng = np.random.default_rng(2)
    q = rng.normal(size=(6, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    ll = jax.jit(jax.vmap(js._loglik))(q)
    _close(ts._loglik(torch.tensor(q)), ll)
    jq, jll, jit = jax.jit(jax.vmap(js._transition))(keys, q, ll)

    def draws(key):
        k_nu, k_u, k_theta, k_shrink = jax.random.split(key, 4)
        shrink = jax.vmap(jax.random.uniform)(
            jax.random.split(k_shrink, tess._SHRINK_ITERS))
        return (jax.random.normal(k_nu, (3,)),
                jnp.log(jax.random.uniform(k_u)),
                jax.random.uniform(k_theta), shrink)

    nu, log_u, theta_u, shrink = map(torch.tensor, map(
        _np, jax.jit(jax.vmap(draws))(keys)))
    tq, tll, tit = tess.ess_core(ts._loglik, torch.tensor(q),
                                 torch.tensor(_np(ll)), nu, log_u, theta_u,
                                 shrink)
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    _close(tq, jq)
    _close(tll, jll)
    assert int(tit.max()) > 0


def test_ess_rejects_non_whitened_prior_like_jax():
    def make(sample, dist):
        def model():
            sample("mu", dist.Normal(3.0, 2.0))
        return model
    with pytest.raises(ValueError, match="standard-normal"):
        jess.EllipticalSlice(make(jsample, jdist))
    with pytest.raises(ValueError, match="standard-normal"):
        tess.EllipticalSlice(make(tsample, tdist), device="cpu")


def test_ess_run_recovers_conjugate_posterior():
    """tests/test_ess_sampler.py:15's oracle at 8 chains x 150 draws: the
    mean within 4 SE (ESS-discounted by 4), the sd within 15%."""
    rng = np.random.default_rng(0)
    y = torch.tensor(rng.normal(1.0, 1.0, 64).astype(np.float32))

    def model():
        z = tsample("z", tdist.Normal(0.0, 1.0))
        tsample("obs", tdist.Normal(2.0 * z, 1.0).expand((64,)).to_event(1),
                obs=y)
    prec = 1.0 + 4.0 * 64
    res = tess.EllipticalSlice(model, num_samples=150, num_burnin=40,
                               num_chains=8, device="cpu").run(0)
    z = res.samples["z"].reshape(-1).numpy()
    assert abs(z.mean() - 2.0 * float(y.sum()) / prec) \
        < 4 * np.sqrt(4.0 / z.size) / np.sqrt(prec)
    np.testing.assert_allclose(z.std(), prec ** -0.5, rtol=0.15)
    assert res.extra["shrink_iters"].shape == (8, 150)
    assert int(res.extra["shrink_iters"].max()) < tess._SHRINK_ITERS


# -- parallel tempering --------------------------------------------------------

@pytest.mark.parametrize("k, beta_min", [(1, 0.05), (5, 0.05), (8, 0.01)])
def test_geometric_ladder_equal(k, beta_min):
    np.testing.assert_array_equal(tpt.geometric_ladder(k, beta_min).numpy(),
                                  np.asarray(jpt.geometric_ladder(k,
                                                                  beta_min)))


def _pt_pair(c=4, k=4):
    x, y = _logistic_data(n=40, d=2, seed=3)
    jp = jpt.ParallelTempering(_logistic(jsample, jdist, jnp.asarray(x),
                                         jnp.asarray(y)), num_replicas=k,
                               num_chains=c, num_leapfrog=5)
    tp = tpt.ParallelTempering(_logistic(tsample, tdist, torch.tensor(x),
                                         torch.tensor(y)), num_replicas=k,
                               num_chains=c, num_leapfrog=5, device="cpu")
    return jp, tp


def test_pt_hmc_transition_matches_jax_given_its_draws():
    c, k = 4, 4
    jp, tp = _pt_pair(c, k)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(c, k, 2)).astype(np.float32)
    eps = rng.uniform(0.1, 0.6, k).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, (k, 2)).astype(np.float32)
    kc = jax.random.split(jax.random.PRNGKey(6), c * k).reshape(c, k, -1)
    run = jax.jit(jax.vmap(jax.vmap(jp._hmc_transition),
                           in_axes=(0, 0, None, None, None)))
    jq, jacc = run(kc, q, jp.betas, eps, inv)

    def draws(key):
        k_mom, k_acc = jax.random.split(key)
        return jax.random.normal(k_mom, (2,)), jax.random.uniform(k_acc)

    mom, u = jax.jit(jax.vmap(jax.vmap(draws)))(kc)
    tq, tacc = tpt.hmc_core(tp._pe_grad, torch.tensor(q), tp.betas,
                            torch.tensor(eps), torch.tensor(inv),
                            torch.tensor(_np(mom)), torch.tensor(_np(u)), 5)
    _close(tq, jq)
    _close(tacc, jacc, rtol=1e-4)
    assert 0 < int((tq != torch.tensor(q)).any(-1).sum()) < c * k
    lp, ll = tp._parts(tq)
    jlp, jll = jax.jit(jax.vmap(jax.vmap(jp._parts)))(jq)
    _close(lp, jlp)
    _close(ll, jll)


@pytest.mark.parametrize("k", [4, 5])
@pytest.mark.parametrize("parity", [0, 1])
def test_pt_swap_matches_jax_given_its_draws(k, parity):
    c = 6
    betas = jpt.geometric_ladder(k, 0.05)
    rng = np.random.default_rng(10 + k + parity)
    q = rng.normal(size=(c, k, 3)).astype(np.float32)
    lp = rng.normal(size=(c, k)).astype(np.float32)
    ll = rng.normal(-3.0, 2.0, size=(c, k)).astype(np.float32)
    jp = types_ns(betas=betas, K=k, num_chains=c)
    key = jax.random.PRNGKey(7 + parity)
    jst, jacc = jpt.ParallelTempering._swap(
        jp, key, jpt._PTState(q, lp, ll), parity)
    u = jax.random.uniform(key, (c, k // 2 + 1))
    tst, tacc = tpt.swap_core(tpt._PTState(*map(torch.tensor, (q, lp, ll))),
                              torch.tensor(_np(betas)), parity,
                              torch.tensor(_np(u)))
    for a, b in zip(tst, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert 0 < float(tacc.sum())


def types_ns(**kw):
    import types
    return types.SimpleNamespace(**kw)


def test_pt_evidence_estimates_match_jax():
    rng = np.random.default_rng(12)
    betas = np.concatenate([np.asarray(jpt.geometric_ladder(6, 0.01)),
                            np.zeros(1, np.float32)])
    lls = rng.normal(-40.0, 5.0, size=(50, 4, 7)).astype(np.float32)
    _close(tpt._ti_evidence(torch.tensor(betas), torch.tensor(lls)),
           jpt._ti_evidence(jnp.asarray(betas), jnp.asarray(lls)))
    _close(tpt._stepping_stone(torch.tensor(betas), torch.tensor(lls)),
           jpt._stepping_stone(jnp.asarray(betas), jnp.asarray(lls)))


def test_pt_run_shapes_and_ladder_checks():
    _, tp = _pt_pair(c=4, k=3)
    tp.num_warmup, tp.num_samples = 30, 20
    res = tp.run(0)
    assert res.samples["w"].shape == (4, 20, 2)
    assert res.extra["swap_accept"].shape == (2,)
    assert torch.isfinite(res.extra["log_evidence_ss"])
    with pytest.raises(ValueError, match="descend from 1.0"):
        tpt.ParallelTempering(lambda: None, betas=[0.5, 1.0], device="cpu")


# -- SG-MCMC -----------------------------------------------------------------

SIGMA, TAU, N = 1.0, 2.0, 256


def _sg_model(sample, plate, dist):
    def model(x):
        mu = sample("mu", dist.Normal(0.0, TAU))
        with plate("data", x.shape[0], subsample_size=64) as idx:
            sample("obs", dist.Normal(mu, SIGMA), obs=x[idx])
    return model


@pytest.mark.parametrize("method", ["sgld", "psgld", "sghmc"])
def test_sg_update_matches_jax_given_gradient_and_noise(method):
    x = np.random.default_rng(0).normal(0.7, SIGMA, N).astype(np.float32)
    kw = dict(method=method, step_size=3e-3, num_chains=5)
    js = jsg.SGMCMC(_sg_model(jsample, jplate, jdist), model_args=(
        jnp.asarray(x),), **kw)
    ts = tsg.SGMCMC(_sg_model(tsample, tplate, tdist), model_args=(
        torch.tensor(x),), device="cpu", **kw)
    rng = np.random.default_rng(1)
    q = rng.normal(0.5, 0.3, (5, 1)).astype(np.float32)
    aux = rng.uniform(0.1, 2.0, (5, 1)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    t = 7
    (jq, jaux), jgn = jax.jit(jax.vmap(
        lambda k, qq, aa: js._transition(k, (qq, aa), t)))(keys, q, aux)

    def draws(qq, key):
        key_b, key_n = jax.random.split(key)
        return (jdraw_subsample(js.info, key_b)["data__idx"],
                jax.random.normal(key_n, (1,)),
                js._grad_logp(qq, key_b)[1])

    idx, noise, jg = jax.jit(jax.vmap(draws))(q, keys)
    g = ts.grad_logp(torch.tensor(q), {"data__idx": torch.tensor(_np(idx))})
    _close(g, jg, rtol=1e-5, atol=1e-4)
    tq, taux, tgn = tsg.sg_update(method, torch.tensor(q), torch.tensor(aux),
                                  torch.tensor(_np(jg)),
                                  torch.tensor(_np(noise)),
                                  ts._step_at(t))
    _close(tq, jq)
    _close(tgn, jgn)
    if method != "sgld":
        _close(taux, jaux)


def test_sg_step_decay_schedule_matches_jax():
    x = np.zeros(N, np.float32)
    kw = dict(method="sgld", step_decay=(1e-2, 10.0, 0.55))
    js = jsg.SGMCMC(_sg_model(jsample, jplate, jdist), model_args=(
        jnp.asarray(x),), **kw)
    ts = tsg.SGMCMC(_sg_model(tsample, tplate, tdist), model_args=(
        torch.tensor(x),), device="cpu", **kw)
    for t in (0, 1, 99, 100, 3500, 123456):
        got = ts._step_at(t)
        assert got.dtype == torch.float32
        # float32 on both sides; XLA's and torch's pow may part by an ulp
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(js._step_at(jnp.asarray(t))),
                                   rtol=3e-7)


def test_sg_thinning_shapes_and_final_step():
    x = torch.tensor(np.random.default_rng(0).normal(0.7, SIGMA, N)
                     .astype(np.float32))
    s = tsg.SGMCMC(_sg_model(tsample, tplate, tdist), method="sgld",
                   step_decay=(1e-2, 10.0, 0.55), num_chains=3,
                   num_burnin=20, num_samples=40, thin=5, model_args=(x,),
                   device="cpu")
    res = s.run(2)
    assert res.samples["mu"].shape == (3, 40)
    assert res.unconstrained.shape == (3, 40, 1)
    assert res.extra["grad_norm"].shape == (3, 40)
    np.testing.assert_allclose(float(res.extra["final_step_size"]),
                               1e-2 / (10.0 + 20 + 200) ** 0.55, rtol=1e-5)
    assert torch.isfinite(res.unconstrained).all()


# -- MCMC.warmup_and_sample ----------------------------------------------------

def _normal_model(y):
    y = torch.as_tensor(y, dtype=torch.float32)

    def model():
        mu = tsample("mu", tdist.Normal(torch.zeros(2), 2.0).to_event(1))
        tsample("obs", tdist.Normal(mu, 1.0).expand(tuple(y.shape))
                .to_event(2), obs=y)
    return model


@pytest.mark.parametrize("shared", [False, True])
def test_warmup_and_sample_equals_run_bit_for_bit(shared):
    model = _normal_model(np.random.default_rng(12).normal(size=(4, 2)))

    def mk():
        return MCMC(model, num_warmup=25, num_samples=10, num_chains=3,
                    max_depth=4, thin=2, shared_adapt=shared, device="cpu")
    res = mk().run(5)
    fn = mk().warmup_and_sample(5)
    run_all, carry0 = mk().warmup_and_sample(5, with_states=True)
    for raw in (fn(), run_all(carry0)):
        qs, divs, accs, depths, nsteps, step_size, inv_mass = raw
        assert qs.shape == (10, 3, 2)
        np.testing.assert_array_equal(qs.transpose(0, 1).numpy(),
                                      res.unconstrained.numpy())
        for a, k in ((divs, "diverging"), (accs, "accept_prob"),
                     (depths, "tree_depth"), (nsteps, "num_steps")):
            np.testing.assert_array_equal(a.transpose(0, 1).numpy(),
                                          res.extra[k].numpy())
        np.testing.assert_array_equal(step_size.numpy(),
                                      res.extra["step_size"].numpy())
        np.testing.assert_array_equal(inv_mass.numpy(),
                                      res.extra["inv_mass"].numpy())


def test_warmup_and_sample_batched_transition_equals_run():
    """The hier NUTS path (``batched_transition``, its plain version on the
    CPU) through ``warmup_and_sample`` and ``run``: the same bits."""
    from bayesic_tpu_torch.models import hier_logistic as hl
    rng = np.random.default_rng(0)
    j, f, n = 3, 2, 40
    x = torch.tensor(rng.normal(size=(n, f)).astype(np.float32))
    group = torch.tensor(rng.integers(0, j, n))
    y = torch.tensor((rng.uniform(size=n) < 0.5).astype(np.float32))

    def mk():
        return hl.fused_nuts_mcmc(j, f, x, y, group, num_warmup=20,
                                  num_samples=6, num_chains=2,
                                  max_doublings=3)
    res = mk().run(3)
    qs = mk().warmup_and_sample(3)()[0]
    np.testing.assert_array_equal(qs.transpose(0, 1).numpy(),
                                  res.unconstrained.numpy())


def test_unravel_is_accepted_on_the_potential_path():
    prec = torch.tensor([1.0, 4.0])

    def pag(q):
        return 0.5 * torch.sum(prec * q * q, -1), prec * q

    def unravel(q):
        return {"a": q[..., 0], "b": q[..., 1]}

    m = MCMC(potential_and_grad=pag, example_q=torch.zeros(2),
             unravel=unravel, num_warmup=10, num_samples=5, num_chains=2,
             max_depth=3)
    assert m._unravel is unravel
    a = m.run(1).unconstrained
    b = MCMC(potential_and_grad=pag, example_q=torch.zeros(2),
             num_warmup=10, num_samples=5, num_chains=2,
             max_depth=3).run(1).unconstrained
    np.testing.assert_array_equal(a.numpy(), b.numpy())
