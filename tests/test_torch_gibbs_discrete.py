"""Parity of the port's ``infer_discrete`` and ``DiscreteGibbs`` (NUTS
within Gibbs) with the JAX package.

``infer_discrete`` is held to Bayes' rule (the oracle of the JAX package's
tests/test_infer_discrete.py): assignment frequencies within 4 SE.  One
Gibbs transition is held to the JAX ``_chain_step`` given the draws that
function makes from its key (the Gumbel noise of ``sample_enum`` and the
NUTS draws): equal assignments, tree depths and divergence flags, states
at rtol 1e-5 (atol 1e-6), accept statistics at rtol 1e-4, float32 on both
sides.  A short ``DiscreteGibbs`` run is held to the analytic p(z | y)
within 4 MCSE-style SE.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.core as jcore
import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.core as tcore
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.infer.mcmc import DiscreteGibbs as JGibbs
from bayesic_tpu.infer.mcmc import IntegratorState as JState
from bayesic_tpu_torch.infer import infer_discrete
from bayesic_tpu_torch.infer.mcmc import DiscreteGibbs as TGibbs
from bayesic_tpu_torch.infer.mcmc import IntegratorState as TState
from bayesic_tpu_torch.infer.mcmc import NUTSStreams

torch.set_num_threads(2)

J = types.SimpleNamespace(core=jcore, dist=jdist, arr=jnp.asarray)
T = types.SimpleNamespace(core=tcore, dist=tdist,
                          arr=lambda a: torch.as_tensor(np.asarray(a)))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _mixture(ns, n=40, seed=0):
    """tests/test_infer_discrete.py:20: two components at -2 and 2."""
    mus = np.array([-2.0, 2.0], np.float32)
    rng = np.random.default_rng(seed)
    z_true = rng.integers(0, 2, n)
    x = (mus[z_true] + 0.5 * rng.normal(size=n)).astype(np.float32)
    xa = ns.arr(x)

    def model():
        mu = ns.core.sample("mu", ns.dist.Normal(0.0, 5.0).expand((2,))
                            .to_event(1))
        z = ns.core.sample("z", ns.dist.Categorical(
            logits=ns.arr(np.zeros(2, np.float32))), sample_shape=(n,),
            infer={"enumerate": True})
        ns.core.sample("obs", ns.dist.Normal(mu[z], 0.5), obs=xa)
    return model, x, mus


def test_infer_discrete_matches_bayes_rule():
    model, x, mus = _mixture(T)
    s = 2000
    out = infer_discrete(model, {"mu": torch.tensor(mus).expand(s, 2)}, 3)
    z = out["z"].numpy()
    assert z.shape == (s, 40) and out["z"].dtype == torch.int32
    lp0 = -0.5 * ((x - mus[0]) / 0.5) ** 2
    lp1 = -0.5 * ((x - mus[1]) / 0.5) ** 2
    p1 = 1.0 / (1.0 + np.exp(lp0 - lp1))
    se = np.sqrt(p1 * (1 - p1) / s) + 1e-9
    assert np.all(np.abs(z.mean(0) - p1) <= 4 * se + 1e-6)
    # keyed by draw index: the first draws do not depend on the count
    few = infer_discrete(model, {"mu": torch.tensor(mus).expand(10, 2)}, 3)
    np.testing.assert_array_equal(few["z"].numpy(), z[:10])


def test_infer_discrete_two_dependent_sites_joint():
    """tests/test_infer_discrete.py:49: the joint of two dependent scalar
    sites against brute force, 4,000 draws, every cell within 4 SE."""
    table = torch.tensor([[0.0, 1.0], [1.0, 0.0]])

    def model():
        tcore.sample("c", tdist.Normal(0.0, 1.0))
        a = tcore.sample("a", tdist.Categorical(
            logits=torch.tensor([0.0, 0.5])), infer={"enumerate": True})
        b = tcore.sample("b", tdist.Categorical(logits=table[a]),
                         infer={"enumerate": True})
        tcore.sample("obs", tdist.Normal(a + b * 1.0, 0.8),
                     obs=torch.tensor(1.3))
    s = 4000
    d = infer_discrete(model, {"c": torch.zeros(s)}, 1)
    a, b = d["a"].numpy(), d["b"].numpy()
    la = np.log(np.exp([0.0, 0.5]) / np.exp([0.0, 0.5]).sum())
    lb = np.log(np.exp([[0.0, 1.0], [1.0, 0.0]])
                / np.exp([[0.0, 1.0], [1.0, 0.0]]).sum(1, keepdims=True))
    joint = np.array([[la[i] + lb[i, j] - 0.5 * ((1.3 - i - j) / 0.8) ** 2
                       for j in range(2)] for i in range(2)])
    pj = np.exp(joint - joint.max())
    pj /= pj.sum()
    for i in range(2):
        for j in range(2):
            emp = ((a == i) & (b == j)).mean()
            assert abs(emp - pj[i, j]) < 4 * np.sqrt(pj[i, j] / s)


def test_infer_discrete_needs_enumerated_sites():
    def model():
        tcore.sample("mu", tdist.Normal(0.0, 1.0))
    with pytest.raises(ValueError, match="no enumerated"):
        infer_discrete(model, {"mu": torch.zeros(3)}, 0)


@pytest.mark.parametrize("layout", ["switch_first", "assign_first",
                                    "apart"])
def test_discrete_draws_refuse_a_plate_summed_by_a_scalar_site(layout):
    """A scalar enumerated site eliminated after a plate-local one it
    interacts with sums that site's plate away: sample_enum (as the JAX
    package's) couples the plate's elements, so infer_discrete and
    DiscreteGibbs refuse the model, naming both sites.  A scalar site
    that does not touch the plate ("apart") is drawn exactly and
    accepted."""
    y = torch.tensor([0.3, -1.2, 0.8])

    def model():
        mu = tcore.sample("mu", tdist.Normal(0.0, 1.0))
        if layout == "switch_first":
            s = tcore.sample("switch", tdist.Bernoulli(0.7),
                             infer={"enumerate": True})
        a = tcore.sample("assign", tdist.Bernoulli(torch.full((3,), 0.4)),
                         infer={"enumerate": True})
        if layout != "switch_first":
            s = tcore.sample("switch", tdist.Bernoulli(0.7),
                             infer={"enumerate": True})
        if layout == "apart":
            tcore.sample("obs_s", tdist.Normal(s * 0.5, 1.0),
                         obs=torch.tensor(0.2))
            s = 0.0
        tcore.sample("obs", tdist.Normal(a * 2.0 + s * 0.5 + mu, 1.0),
                     obs=y)

    _, ld, _, _ = tcore.build_logjoint(model)
    z = ld.sample_enum({"mu": torch.tensor(0.1)},
                       gumbels=lambda name, shape: torch.zeros(shape))
    if layout == "apart":
        assert z["assign"].shape == (3,)
        assert infer_discrete(model, {"mu": torch.zeros(4)}, 0)[
            "assign"].shape == (4, 3)
        TGibbs(model, device="cpu")
        return
    assert z["assign"].shape == (3,)
    with pytest.raises(ValueError, match="'assign'.*'switch'"):
        infer_discrete(model, {"mu": torch.zeros(4)}, 0)
    with pytest.raises(ValueError, match="'assign'.*'switch'"):
        TGibbs(model, device="cpu")


# -- one Gibbs transition against the JAX _chain_step ------------------------

def _gibbs_model(ns, n=20, seed=0):
    """tests/test_gibbs.py:42 at n points."""
    rng = np.random.default_rng(seed)
    y = np.concatenate([rng.normal(-2.0, 0.5, n // 2),
                        rng.normal(2.0, 0.5, n - n // 2)]).astype(np.float32)
    ya = ns.arr(y)

    def model():
        mu = ns.core.sample("mu", ns.dist.Normal(
            ns.arr(np.float32([-1.0, 1.0])), 2.0).to_event(1))
        with ns.core.plate("data", n):
            z = ns.core.sample("z", ns.dist.Categorical(
                ns.arr(np.float32([0.5, 0.5]))), sample_shape=(n,),
                infer={"enumerate": True})
            ns.core.sample("obs", ns.dist.Normal(mu[z], 0.5), obs=ya)
    return model


def _jax_nuts_draws(key, d, kk):
    """The draws of one JAX NUTS step from ``key``, laid out as the port's
    ``NUTSStreams`` (as tests/test_torch_mcmc.py lays them out)."""
    key_mom, key_tree = jax.random.split(key)
    sign, lua, lul = [], [], []
    for j in range(kk):
        k_dir, k_sub, k_acc = jax.random.split(
            jax.random.fold_in(key_tree, j), 3)
        sign.append(jnp.where(jax.random.bernoulli(k_dir), 1.0, -1.0))
        lua.append(jnp.log(jax.random.uniform(k_acc)))
        lul.append(jnp.log(jax.vmap(lambda i: jax.random.uniform(
            jax.random.fold_in(k_sub, i)))(jnp.arange(1 << j))))
    return (jax.random.normal(key_mom, (d,), jnp.float32), jnp.stack(sign),
            jnp.stack(lua), jnp.concatenate(lul + [jnp.zeros(1)]))


def test_gibbs_transition_matches_jax_given_its_draws():
    c, n, kk = 3, 12, 3
    jg = JGibbs(_gibbs_model(J, n), max_depth=kk, num_chains=c)
    tg = TGibbs(_gibbs_model(T, n), max_depth=kk, num_chains=c,
                device="cpu")
    rng = np.random.default_rng(5)
    q = rng.normal(0.0, 1.5, (c, 2)).astype(np.float32)
    z0 = rng.integers(0, 2, (c, n)).astype(np.int32)
    eps = np.float32([0.05, 0.1, 0.2])
    inv = rng.uniform(0.5, 1.5, (c, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), c)
    pe, g = jax.jit(jax.vmap(lambda qq, zz: jg._pag({"z": zz})(qq)))(q, z0)
    jst, jz, jinfo = jax.jit(jax.vmap(jg._chain_step))(
        keys, JState(q, jnp.zeros_like(q), pe, g), {"z": z0}, eps, inv)

    def draws(key):
        kz, kh = jax.random.split(key)
        return (jax.random.gumbel(jax.random.fold_in(kz, 0), (n, 2),
                                  jnp.float32),) + _jax_nuts_draws(kh, 2, kk)

    gum, *nuts = (torch.tensor(np.array(a))
                  for a in jax.jit(jax.vmap(draws))(keys))
    tq = torch.tensor(q)
    st, tz, tinfo = tg.gibbs_step(
        TState(tq, torch.zeros_like(tq), torch.zeros(c), torch.zeros(c, 2)),
        torch.tensor(eps), torch.tensor(inv), {"z": gum},
        NUTSStreams(*nuts))
    np.testing.assert_array_equal(tz["z"].numpy(), np.asarray(jz["z"]))
    for name in ("depth", "num_steps", "diverging"):
        np.testing.assert_array_equal(getattr(tinfo, name).numpy(),
                                      np.asarray(getattr(jinfo, name)))
    _close(st.q, jst.q)
    _close(st.pe, jst.pe)
    _close(tinfo.accept_prob, jinfo.accept_prob, rtol=1e-4)


def test_gibbs_scalar_site_matches_analytic():
    """tests/test_gibbs.py:14 cut to 4 chains x 100 draws: p(z = 1 | y)
    within 4 SE (ESS-discounted by 4) of the closed form."""
    from scipy.stats import norm

    def model():
        z = tcore.sample("z", tdist.Bernoulli(0.3),
                         infer={"enumerate": True})
        mu = tcore.sample("mu", tdist.Normal(0.0, 1.0))
        tcore.sample("obs", tdist.Normal(mu + 2.0 * z, 1.0),
                     obs=torch.tensor(1.3))
    l1 = 0.3 * norm(2.0, np.sqrt(2.0)).pdf(1.3)
    l0 = 0.7 * norm(0.0, np.sqrt(2.0)).pdf(1.3)
    want = l1 / (l0 + l1)
    res = TGibbs(model, num_warmup=40, num_samples=100, num_chains=4,
                 max_depth=5, device="cpu").run(0)
    got = float(res.samples["z"].float().mean())
    assert abs(got - want) < 4 * np.sqrt(4 * want * (1 - want) / 400)
    assert res.samples["z"].shape == (4, 100)
    assert res.unconstrained.shape == (4, 100, 1)


def test_gibbs_requires_enum_sites():
    def model():
        tcore.sample("mu", tdist.Normal(0.0, 1.0))
    with pytest.raises(ValueError, match="enumerate"):
        TGibbs(model, device="cpu")
