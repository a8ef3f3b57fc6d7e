"""Parity of the port's MCMC stack (``infer/mcmc``: metrics, integrators,
adaptation, NUTS, HMC, ``MCMC`` and its streams) with the JAX package.

Inputs come from numpy with a seed and go to both packages; where a JAX
function draws from a key, the test draws the same numbers with that key
and hands them to the port's function, which takes its randomness as an
input.  Tolerances: float32 arithmetic on both sides, rtol 1e-5 (atol 1e-6
where values cross zero) for one step of anything, rtol 1e-4 for
sequences of 50 adaptation steps; tree depth, step counts, divergence and
acceptance flags and ``build_schedule``'s arrays must be equal.
``MCMC``'s end-to-end check is the analytic posterior mean of a conjugate
model, within 4 MCSE.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.infer.mcmc as jm
import bayesic_tpu_torch.dist as dist
import bayesic_tpu_torch.infer.mcmc as tm
from bayesic_tpu.infer.mcmc import adapt as jadapt
from bayesic_tpu_torch.core import sample
from bayesic_tpu_torch.core.logjoint import (build_logjoint, init_to_prior,
                                             init_to_uniform)
from bayesic_tpu_torch.infer.mcmc import streams as ts
from bayesic_tpu_torch.infer.svi import unraveler
from bayesic_tpu_torch.utils import diagnostics as tdiag

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return (a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32)


# -- (a) metrics, integrators, adaptation ------------------------------------

@pytest.mark.parametrize("dense", [False, True])
def test_metrics_match_jax(dense):
    rng = np.random.default_rng(0)
    c, d = 5, 4
    p = rng.normal(size=(c, d)).astype(np.float32)
    inv = _spd(rng, d) if dense else rng.uniform(0.5, 2, d).astype(
        np.float32)
    ti, tp = torch.as_tensor(inv), torch.as_tensor(p)
    # batched over chains, one shared metric
    jke = jax.vmap(lambda x: jm.kinetic_energy(jnp.asarray(inv), x))(p)
    jv = jax.vmap(lambda x: jm.velocity(jnp.asarray(inv), x))(p)
    _close(tm.kinetic_energy(ti, tp, dense), jke)
    _close(tm.velocity(ti, tp, dense), jv)
    _close(tm.mass_sqrt(ti, dense),
           jm.metrics.mass_sqrt(jnp.asarray(inv)), rtol=1e-4)
    # a metric per chain
    invs = np.stack([inv * (1 + 0.1 * i) for i in range(c)])
    jke = jax.vmap(jm.kinetic_energy)(invs, p)
    _close(tm.kinetic_energy(torch.as_tensor(invs), tp, dense), jke)
    # momentum from the normals a key gives
    key = jax.random.PRNGKey(3)
    want = jm.sample_momentum(key, jnp.asarray(inv), jnp.zeros(d))
    eps = jax.random.normal(key, (d,), jnp.float32)
    _close(tm.sample_momentum(torch.as_tensor(np.array(eps)), ti, dense),
           want, rtol=1e-4)
    # single chain: the rank rule of the JAX package
    _close(tm.kinetic_energy(ti, tp[0]), jm.kinetic_energy(inv, p[0]))


def _gauss(prec):
    tprec = torch.as_tensor(prec)

    def jpg(q):
        return 0.5 * jnp.sum(prec * q * q), prec * q

    def tpg(q):
        return 0.5 * torch.sum(tprec * q * q, -1), tprec * q

    return jpg, tpg


def test_leapfrog_matches_jax():
    rng = np.random.default_rng(1)
    c, d = 4, 6
    prec = rng.uniform(0.5, 3, d).astype(np.float32)
    jpg, tpg = _gauss(prec)
    q, p = (rng.normal(size=(c, d)).astype(np.float32) for _ in range(2))
    inv = rng.uniform(0.5, 2, d).astype(np.float32)
    steps = np.array([0.1, 0.2, 0.3, 0.4], np.float32)   # one per chain
    jstep = jm.make_leapfrog(jpg)
    pe, g = jax.vmap(jpg)(q)
    want = jax.vmap(jstep, in_axes=(0, 0, None))(
        jm.IntegratorState(q, p, pe, g), steps, inv)
    tq = torch.as_tensor(q)
    tpe, tg = tpg(tq)
    got = tm.make_leapfrog(tpg)(
        tm.IntegratorState(tq, torch.as_tensor(p), tpe, tg),
        torch.as_tensor(steps), torch.as_tensor(inv))
    for a, b in zip(got, want):
        _close(a, b)


def test_dual_averaging_sequence_matches_jax():
    rng = np.random.default_rng(2)
    accs = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    jst = jax.vmap(jm.da_init)(jnp.asarray([0.1, 0.5, 1.0]))
    tst = tm.da_init(torch.tensor([0.1, 0.5, 1.0]))
    for a in accs:
        jst = jax.vmap(lambda s, x: jm.da_update(s, x, target=0.85))(jst, a)
        tst = tm.da_update(tst, torch.as_tensor(a), target=0.85)
    for a, b in zip(tst, jst):
        _close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dense", [False, True])
def test_welford_matches_jax(dense):
    rng = np.random.default_rng(4)
    d = 3
    xs = rng.normal(size=(40, d)).astype(np.float32) * [1.0, 2.0, 0.5]
    jst = jm.welford_init(d, dense=dense)
    tst = tm.welford_init(d, dense=dense)
    for x in xs[:30]:
        jst = jm.welford_update(jst, jnp.asarray(x))
        tst = tm.welford_update(tst, torch.as_tensor(x))
    jst = jadapt.welford_update_batch(jst, jnp.asarray(xs[30:]))
    tst = tm.welford_update_batch(tst, torch.as_tensor(xs[30:]))
    for a, b in zip(tst, jst):
        _close(a, b, rtol=1e-4, atol=1e-5)
    for reg in (True, False):
        _close(tm.welford_finalize(tst, reg), jm.welford_finalize(jst, reg),
               rtol=1e-4, atol=1e-6)
    # one estimate per chain, as per-chain adaptation keeps them
    chains = rng.normal(size=(10, 4, d)).astype(np.float32)
    jst = jax.vmap(lambda _: jm.welford_init(d, dense=dense))(jnp.arange(4))
    tst = tm.welford_init(d, dense=dense, batch=(4,))
    for x in chains:
        jst = jax.vmap(jm.welford_update)(jst, jnp.asarray(x))
        tst = tm.welford_update(tst, torch.as_tensor(x))
    _close(tm.welford_finalize(tst), jax.vmap(jm.welford_finalize)(jst),
           rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("num_warmup", [0, 19, 60, 150, 200, 1000, 1234])
def test_build_schedule_equal(num_warmup):
    for a, b in zip(tm.build_schedule(num_warmup),
                    jm.build_schedule(num_warmup)):
        np.testing.assert_array_equal(a, b)


def test_find_reasonable_step_size_matches_jax():
    rng = np.random.default_rng(5)
    d = 5
    prec = rng.uniform(5.0, 50.0, d).astype(np.float32)
    jpg, tpg = _gauss(prec)
    inv = np.ones(d, np.float32)
    for i in range(3):
        q = rng.normal(size=d).astype(np.float32) * 0.3
        key = jax.random.PRNGKey(i)
        want = jm.find_reasonable_step_size(
            jpg, jm.kinetic_energy, jm.make_leapfrog(jpg), jnp.asarray(q),
            key, jnp.asarray(inv))
        eps = np.array(jax.random.normal(key, (d,), jnp.float32))
        got = tm.find_reasonable_step_size(
            tpg, tm.kinetic_energy, tm.make_leapfrog(tpg),
            torch.as_tensor(q)[None], torch.as_tensor(eps)[None],
            torch.as_tensor(inv))
        _close(got[0], want)


# -- the transition kernels against the JAX per-chain kernels ---------------

def _jax_nuts_draws(keys, d, kk):
    """The draws of one ``bayesic_tpu`` NUTS step per key, laid out as the
    port's pre-drawn streams (``infer/mcmc/nuts.py`` step: momentum key,
    then per doubling a direction, subtree and merge key)."""
    def one(key):
        key_mom, key_tree = jax.random.split(key)
        sign, lua, lul = [], [], []
        for j in range(kk):
            k_dir, k_sub, k_acc = jax.random.split(
                jax.random.fold_in(key_tree, j), 3)
            sign.append(jnp.where(jax.random.bernoulli(k_dir), 1.0, -1.0))
            lua.append(jnp.log(jax.random.uniform(k_acc)))
            lul.append(jnp.log(jax.vmap(lambda i: jax.random.uniform(
                jax.random.fold_in(k_sub, i)))(jnp.arange(1 << j))))
        return (jax.random.normal(key_mom, (d,), jnp.float32),
                jnp.stack(sign), jnp.stack(lua),
                jnp.concatenate(lul + [jnp.zeros(1)]))

    return [np.array(a, np.float32) for a in jax.jit(jax.vmap(one))(keys)]


@pytest.mark.parametrize("dense", [False, True])
def test_nuts_core_matches_jax_nuts_kernel(dense):
    """``nuts_core`` fed the draws of ``bayesic_tpu``'s per-chain NUTS
    kernel builds the same tree: one core serves both JAX copies."""
    rng = np.random.default_rng(6)
    c, d, kk = 4, 6, 6
    prec = rng.uniform(0.5, 4.0, d).astype(np.float32)
    jpg, tpg = _gauss(prec)
    inv = _spd(rng, d) if dense else rng.uniform(0.5, 1.5, d).astype(
        np.float32)
    q = rng.normal(size=(c, d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), c)
    pe, g = jax.vmap(jpg)(q)
    kernel = jm.make_nuts_kernel(jpg, max_depth=kk)
    jst, jinfo = jax.vmap(kernel, in_axes=(0, 0, None, None))(
        keys, jm.IntegratorState(q, jnp.zeros_like(q), pe, g), 0.3, inv)
    draws = _jax_nuts_draws(keys, d, kk)
    tq = torch.as_tensor(q)
    tpe, tg = tpg(tq)
    step = tm.make_nuts_kernel(tpg, max_depth=kk, dense=dense)
    tst, tinfo = step(tm.NUTSStreams(*map(torch.as_tensor, draws)),
                      tm.IntegratorState(tq, torch.zeros_like(tq), tpe, tg),
                      0.3, torch.as_tensor(inv))
    for name in ("depth", "num_steps", "diverging", "is_accepted"):
        np.testing.assert_array_equal(getattr(tinfo, name).numpy(),
                                      np.asarray(getattr(jinfo, name)))
    _close(tst.q, jst.q)
    _close(tst.pe, jst.pe)
    _close(tinfo.energy, jinfo.energy)
    _close(tinfo.accept_prob, jinfo.accept_prob, rtol=1e-4)
    assert len(set(tinfo.depth.tolist())) > 1 or tinfo.depth[0] > 1


def test_hmc_matches_jax_hmc_kernel():
    rng = np.random.default_rng(8)
    c, d = 6, 5
    prec = rng.uniform(0.5, 4.0, d).astype(np.float32)
    jpg, tpg = _gauss(prec)
    q = rng.normal(size=(c, d)).astype(np.float32)
    inv = np.ones(d, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), c)
    pe, g = jax.vmap(jpg)(q)
    kernel = jm.make_hmc_kernel(jpg, num_steps=7)
    jst, jinfo = jax.vmap(kernel, in_axes=(0, 0, None, None))(
        keys, jm.IntegratorState(q, jnp.zeros_like(q), pe, g), 0.45, inv)
    mom, lua = [], []
    for k in keys:
        k_mom, k_acc = jax.random.split(k)
        mom.append(np.asarray(jax.random.normal(k_mom, (d,), jnp.float32)))
        lua.append([np.log(float(jax.random.uniform(k_acc)))])
    streams = tm.NUTSStreams(torch.as_tensor(np.stack(mom)), None,
                             torch.as_tensor(np.asarray(lua, np.float32)),
                             None)
    tq = torch.as_tensor(q)
    tpe, tg = tpg(tq)
    tst, tinfo = tm.make_hmc_kernel(tpg, num_steps=7)(
        streams, tm.IntegratorState(tq, torch.zeros_like(tq), tpe, tg), 0.45,
        torch.as_tensor(inv))
    np.testing.assert_array_equal(tinfo.is_accepted.numpy(),
                                  np.asarray(jinfo.is_accepted))
    _close(tst.q, jst.q)
    _close(tinfo.accept_prob, jinfo.accept_prob, rtol=1e-4)


# -- streams keyed by logical chain index ------------------------------------

def test_streams_are_keyed_by_chain():
    key = ts.StreamKey(seed=123, phase=ts.SAMPLE, t=7)
    full = ts.nuts_streams(key, 8, 5, 4)
    part = ts.nuts_streams(key, torch.tensor([6, 2]), 5, 4)
    for a, b in zip(part, full):
        np.testing.assert_array_equal(a.numpy(), b[[6, 2]].numpy())
    other = ts.nuts_streams(key._replace(t=8), 8, 5, 4)
    assert not torch.equal(other.mom, full.mom)
    assert set(full.sign_dir.unique().tolist()) == {-1.0, 1.0}
    for lu in (full.log_u_acc, full.log_u_leaf):
        assert bool((lu < 0).all()) and bool(torch.isfinite(lu).all())
    # the open interval holds at the extreme words too
    bits = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64)
    u = ts.open_uniform(bits)
    assert 0.0 < float(u[0]) and float(u[1]) < 1.0
    mom = ts.nuts_streams(key, 400, 50, 1).mom
    assert abs(float(mom.mean())) < 0.02 and abs(float(mom.std()) - 1) < 0.02


def _normal_model(y, prior_sd=2.0):
    y = torch.as_tensor(y)

    def model():
        mu = sample("mu", dist.Normal(0.0, prior_sd).expand((2,))
                    .to_event(1))
        sample("obs", dist.Normal(mu, 1.0).expand((y.shape[0], 2))
               .to_event(2), obs=y)

    return model


def test_logical_chain_streams_do_not_depend_on_chain_count():
    """With per-chain adaptation, chain c's draws depend only on (seed, c):
    the first 8 chains of a 16-chain run equal an 8-chain run."""
    model = _normal_model(np.random.default_rng(10).normal(size=(5, 2)))
    runs = [tm.MCMC(model, num_warmup=20, num_samples=10, num_chains=n,
                    max_depth=5, shared_adapt=False, device="cpu").run(4)
            for n in (16, 8)]
    np.testing.assert_array_equal(runs[0].unconstrained[:8].numpy(),
                                  runs[1].unconstrained.numpy())
    np.testing.assert_array_equal(runs[0].extra["step_size"][:8].numpy(),
                                  runs[1].extra["step_size"].numpy())
    assert not torch.equal(runs[0].unconstrained[8:],
                           runs[0].unconstrained[:8])


def test_batched_transition_requires_shared_adapt():
    with pytest.raises(ValueError, match="shared_adapt"):
        tm.MCMC(potential_and_grad=lambda q: (q.sum(-1), q),
                example_q=torch.zeros(4), shared_adapt=False,
                batched_transition=lambda *a: a)


# -- MCMC end to end ----------------------------------------------------------

@pytest.mark.parametrize("shared_adapt", [True, False])
def test_conjugate_normal_posterior_mean(shared_adapt):
    """mu ~ N(0, 2^2 I), y_i ~ N(mu, I): the posterior mean is
    sum(y) / (n + 1/4); the sampler must land within 4 MCSE of it."""
    y = np.random.default_rng(11).normal(1.5, 1.0, (20, 2)).astype(
        np.float32)
    mcmc = tm.MCMC(_normal_model(y), num_warmup=150, num_samples=150,
                   num_chains=4, max_depth=5, shared_adapt=shared_adapt,
                   device="cpu")
    res = mcmc.run(0)
    mu = res.samples["mu"]
    assert mu.shape == (4, 150, 2)
    post_mean = y.sum(0) / (20 + 0.25)
    post_sd = np.sqrt(1.0 / (20 + 0.25))
    stats = tm.MCMC.summary(res)["mu"]
    err = np.abs(stats["mean"].numpy() - post_mean)
    np.testing.assert_array_less(err, 4 * stats["mcse"].numpy())
    np.testing.assert_allclose(stats["std"].numpy(), post_sd, rtol=0.2)
    assert float(stats["rhat"].max()) < 1.05
    assert int(res.extra["diverging"].sum()) == 0
    assert res.extra["tree_depth"].dtype == torch.int32


def test_run_segmented_equals_run_and_hmc_runs():
    model = _normal_model(np.random.default_rng(12).normal(size=(4, 2)))
    mk = lambda: tm.MCMC(model, num_warmup=40, num_samples=12,  # noqa: E731
                         num_chains=3, max_depth=4, thin=2,
                         shared_adapt=True, device="cpu")
    a, b = mk().run(5), mk().run_segmented(5, warmup_chunk=15,
                                           sample_chunk=5)
    np.testing.assert_array_equal(a.unconstrained.numpy(),
                                  b.unconstrained.numpy())
    assert a.unconstrained.shape == (3, 12, 2)
    h = tm.MCMC(model, kernel="hmc", hmc_num_steps=5, num_warmup=30,
                num_samples=20, num_chains=2, device="cpu").run(1)
    assert torch.isfinite(h.samples["mu"]).all()
    assert int(h.extra["tree_depth"].abs().sum()) == 0


def test_potential_path_and_init_params():
    prec = torch.tensor([1.0, 4.0, 9.0])

    def pag(q):
        return 0.5 * torch.sum(prec * q * q, -1), prec * q

    init = torch.full((3, 3), 0.5)
    mcmc = tm.MCMC(potential_and_grad=pag, example_q=torch.zeros(3),
                   num_warmup=60, num_samples=60, num_chains=3,
                   max_depth=5, init_params=init)
    res = mcmc.run(2)
    assert res.samples["q"].shape == (3, 60, 3)
    sd = res.samples["q"].reshape(-1, 3).std(0)
    np.testing.assert_allclose(sd.numpy(), 1 / np.sqrt(prec.numpy()),
                               rtol=0.35)
    with pytest.raises(ValueError, match="init_params"):
        tm.MCMC(potential_and_grad=pag, example_q=torch.zeros(3),
                num_chains=2, init_params=init)


def test_unraveler_and_inits():
    def model():
        sample("a", dist.Normal(0.0, 1.0).expand((2, 3)).to_event(2))
        sample("b", dist.Normal(5.0, 0.1))

    info, logdensity, _, _ = build_logjoint(model)
    dim, unravel, ravel = unraveler(info)
    assert dim == 7
    flat = torch.arange(14.0).reshape(2, 7)
    parts = unravel(flat)
    assert parts["a"].shape == (2, 2, 3) and parts["b"].shape == (2,)
    np.testing.assert_array_equal(ravel(parts).numpy(), flat.numpy())
    u = init_to_uniform(info, uniforms=torch.tensor([[0.0] * 6 + [1.0]]))
    assert float(u["a"].min()) == -2.0 and float(u["b"][0]) == 2.0
    g = init_to_uniform(info, torch.Generator().manual_seed(0), radius=0.5)
    assert float(g["a"].abs().max()) <= 0.5 and g["b"].shape == ()
    p = init_to_prior(model, info, rng_key=torch.Generator().manual_seed(1))
    assert abs(float(p["b"]) - 5.0) < 1.0
    assert torch.isfinite(logdensity(p))


def test_ess_of_mcmc_output_is_positive():
    model = _normal_model(np.zeros((3, 2), np.float32))
    res = tm.MCMC(model, num_warmup=50, num_samples=40, num_chains=2,
                  max_depth=5, device="cpu").run(3)
    e = tdiag.ess(res.samples["mu"])
    assert e.shape == (2,) and bool((e > 0).all())
    assert math.isfinite(float(tdiag.split_rhat(res.samples["mu"]).max()))
