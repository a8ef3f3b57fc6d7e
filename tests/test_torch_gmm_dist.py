"""Parity of the port's GMM distributions and the stick-breaking bijector
(``dist/``), and of ``logdensity.parts`` on the GMM model, with the JAX
package.  Inputs are made with numpy and go to both packages; values in
float32 on both sides, rtol 1e-5 unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.core.logjoint import build_logjoint as j_build
from bayesic_tpu.models import gmm as jgmm
from bayesic_tpu_torch.core.logjoint import build_logjoint as t_build
from bayesic_tpu_torch.core.logjoint import init_population
from bayesic_tpu_torch.models import gmm as tgmm

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _simplex(*shape):
    g = RNG.gamma(1.5, size=shape)
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


def test_dirichlet_log_prob_shapes_and_samples():
    conc = RNG.uniform(0.5, 3.0, (4, 3)).astype(np.float32)
    x = _simplex(4, 3)
    t = tdist.Dirichlet(torch.as_tensor(conc))
    assert t.batch_shape == (4,) and t.event_shape == (3,)
    _close(t.log_prob(torch.as_tensor(x)),
           jdist.Dirichlet(jnp.asarray(conc)).log_prob(jnp.asarray(x)))
    e = tdist.Dirichlet(torch.ones(3)).expand((5, 2))
    assert e.batch_shape == (5, 2) and e.shape((7,)) == (7, 5, 2, 3)
    s = t.sample(torch.Generator().manual_seed(0), (4000,))
    assert s.shape == (4000, 4, 3)
    assert bool(tdist.constraints.simplex(s).all())
    # the mean of 4000 draws: conc / sum(conc), within 5 standard errors
    mean = conc / conc.sum(-1, keepdims=True)
    se = np.sqrt(mean * (1 - mean) / (conc.sum(-1, keepdims=True) + 1)
                 / 4000)
    assert np.all(np.abs(s.mean(0).numpy() - mean) < 5 * se)


def test_categorical_log_prob_probs_expand_sample():
    logits = RNG.normal(size=(5, 4)).astype(np.float32)
    x = RNG.integers(0, 4, (3, 5))
    t = tdist.Categorical(logits=torch.as_tensor(logits))
    j = jdist.Categorical(logits=jnp.asarray(logits))
    _close(t.log_prob(torch.as_tensor(x)), j.log_prob(jnp.asarray(x)))
    _close(t.probs, j.probs)
    _close(t.log_probs_normalized(), j.log_probs_normalized())
    p = _simplex(4)
    _close(tdist.Categorical(probs=torch.as_tensor(p)).logits, np.log(p))
    assert t.expand((2, 5)).batch_shape == (2, 5)
    assert t.support.is_discrete
    s = t.sample(torch.Generator().manual_seed(1), (6,))
    assert s.shape == (6, 5) and int(s.min()) >= 0 and int(s.max()) < 4


def _mixtures(k=3, d=2, n=50):
    w = _simplex(k)
    mus = RNG.normal(0, 2, (k, d)).astype(np.float32)
    sig = RNG.uniform(0.5, 1.5, k).astype(np.float32)
    x = RNG.normal(0, 2, (n, d)).astype(np.float32)

    def make(dist, arr):
        comps = dist.Independent(dist.Normal(arr(mus), arr(sig)[:, None]), 1)
        return dist.MixtureSameFamily(dist.Categorical(probs=arr(w)), comps)

    return (make(tdist, torch.as_tensor), make(jdist, jnp.asarray), x)


def test_mixture_log_prob_expand_sample():
    t, j, x = _mixtures()
    assert t.batch_shape == () and t.event_shape == (2,)
    _close(t.log_prob(torch.as_tensor(x)), j.log_prob(jnp.asarray(x)))
    te, je = t.expand((50,)).to_event(1), j.expand((50,)).to_event(1)
    assert te.batch_shape == () and te.event_shape == (50, 2)
    _close(te.log_prob(torch.as_tensor(x)), je.log_prob(jnp.asarray(x)))
    s = t.sample(torch.Generator().manual_seed(2), (7, 3))
    assert s.shape == (7, 3, 2)
    with pytest.raises(ValueError, match="categories"):
        tdist.MixtureSameFamily(tdist.Categorical(logits=torch.zeros(4)),
                                t.components)


def test_stick_breaking_matches_jax():
    sb_t, sb_j = tdist.StickBreaking(), jdist.transforms.StickBreaking()
    assert isinstance(tdist.biject_to(tdist.constraints.simplex),
                      tdist.StickBreaking)
    u = RNG.normal(0, 1.5, (6, 4)).astype(np.float32)
    x = sb_t.forward(torch.as_tensor(u))
    _close(x, sb_j.forward(jnp.asarray(u)))
    _close(x.sum(-1), np.ones(6))
    _close(sb_t.log_det_jacobian(torch.as_tensor(u)),
           sb_j.log_det_jacobian(jnp.asarray(u)), rtol=1e-5, atol=1e-5)
    _close(sb_t.inverse(x), u, rtol=1e-4, atol=1e-4)
    s = _simplex(6, 5)
    _close(sb_t.inverse(torch.as_tensor(s)), sb_j.inverse(jnp.asarray(s)),
           rtol=1e-4, atol=1e-4)
    assert sb_t.forward_shape((6, 4)) == (6, 5)
    assert sb_t.inverse_shape((6, 5)) == (6, 4)
    # ldj is log|det| of the Jacobian of the first K-1 coordinates
    jac = torch.autograd.functional.jacobian(
        lambda v: sb_t.forward(v)[:-1], torch.as_tensor(u[0]))
    _close(torch.linalg.slogdet(jac)[1],
           sb_t.log_det_jacobian(torch.as_tensor(u[0])), rtol=1e-4,
           atol=1e-4)


def test_logdensity_parts_on_the_gmm_match_jax():
    """(log prior + Jacobians, log likelihood) of the GMM model at the same
    unconstrained values on both sides; ``prior`` equals the first part."""
    cfg = tgmm.Config(num_data=100)
    x, _ = tgmm.make_data(cfg)
    jcfg = jgmm.Config(num_data=100)
    jx, _ = jgmm.make_data(jcfg)
    np.testing.assert_array_equal(np.asarray(jx), x)
    info_t, ld_t, _, _ = t_build(tgmm.make_model(cfg, torch.as_tensor(x)))
    info_j, ld_j, _, _ = j_build(jgmm.make_model(jcfg, jx))
    assert info_t.latent_names == info_j.latent_names \
        == ("weights", "mus", "sigma")
    assert info_t.unconstrained_shapes == {"weights": (2,), "mus": (3, 2),
                                           "sigma": (3,)}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        u = {n: rng.normal(0, 0.7, s).astype(np.float32)
             for n, s in info_t.unconstrained_shapes.items()}
        lp_t, ll_t = ld_t.parts({n: torch.as_tensor(v)
                                 for n, v in u.items()})
        lp_j, ll_j = ld_j.parts({n: jnp.asarray(v) for n, v in u.items()})
        _close(lp_t, lp_j)
        _close(ll_t, ll_j)
        _close(ld_t.prior({n: torch.as_tensor(v) for n, v in u.items()}),
               lp_j)
        _close(ld_t({n: torch.as_tensor(v) for n, v in u.items()}),
               float(lp_j) + float(ll_j))


def test_init_population_draws_the_prior():
    cfg = tgmm.Config(num_data=20)
    x, _ = tgmm.make_data(cfg)
    model = tgmm.make_model(cfg, torch.as_tensor(x))
    info = t_build(model)[0]
    u = init_population(model, info, 3000,
                        rng_key=torch.Generator().manual_seed(3))
    assert {n: tuple(v.shape) for n, v in u.items()} == {
        "weights": (3000, 2), "mus": (3000, 3, 2), "sigma": (3000, 3)}
    w = info.transforms["weights"].forward(u["weights"])
    # Dirichlet(1) weights have mean 1/3 each (sd 0.236 / sqrt(3000))
    assert np.all(np.abs(w.mean(0).numpy() - 1 / 3) < 0.03)
    # mus ~ N(0, 5): sd 5 within 5%
    assert abs(float(u["mus"].std()) - 5.0) < 0.25


def test_init_population_dependent_prior_matches_jax():
    """``b ~ N(a, 0.1)``: each particle's ``b`` is drawn around its own
    ``a``, as the JAX ``SMC._init_particles`` draws it (one key per
    particle), so corr(a, b) ~ 1/sqrt(1.01) = 0.995 on both sides (within
    0.02 at 4,096 particles); the GMM keeps the one-trace path."""
    import jax

    from bayesic_tpu.core import sample as j_sample
    from bayesic_tpu.infer.smc import SMC as JSMC
    from bayesic_tpu_torch.core import sample as t_sample
    from bayesic_tpu_torch.core.logjoint import priors_fixed

    def j_model():
        a = j_sample("a", jdist.Normal(0.0, 1.0))
        b = j_sample("b", jdist.Normal(a, 0.1))
        j_sample("y", jdist.Normal(b, 1.0), obs=0.5)

    def t_model():
        a = t_sample("a", tdist.Normal(0.0, 1.0))
        b = t_sample("b", tdist.Normal(a, 0.1))
        t_sample("y", tdist.Normal(b, 1.0), obs=torch.tensor(0.5))

    n = 4096
    q = np.asarray(JSMC(j_model, num_particles=n)
                   ._init_particles(jax.random.PRNGKey(0)))
    want = np.corrcoef(q[:, 0], q[:, 1])[0, 1]
    info = t_build(t_model)[0]
    assert not priors_fixed(t_model, info)
    u = init_population(t_model, info, n,
                        rng_key=torch.Generator().manual_seed(0))
    assert u["a"].shape == (n,) and u["b"].shape == (n,)
    got = np.corrcoef(u["a"].numpy(), u["b"].numpy())[0, 1]
    assert abs(want - 0.995) < 0.01 and abs(got - want) < 0.02
    assert abs(float(u["a"].std()) - 1.0) < 0.05

    x, _ = tgmm.make_data(tgmm.Config(num_data=20))
    model = tgmm.make_model(tgmm.Config(num_data=20), torch.as_tensor(x))
    assert priors_fixed(model, t_build(model)[0])
