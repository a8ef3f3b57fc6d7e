"""Parity of the port's ``HiddenMarkovModel`` (``dist/hmm.py``) with
``bayesic_tpu.dist.HiddenMarkovModel``.

Inputs come from numpy with a seed; float32 on both sides, each JAX side
jitted.  Limits: rtol 1e-5 for ``log_prob`` against JAX and against
brute-force enumeration of every path; the Viterbi path equal to JAX's;
``sample`` and ``posterior_sample`` given JAX's Gumbel and emission draws
equal to JAX's draws (integers exactly, emissions rtol 1e-6); the DSL
model of tests/test_hmm.py:106 (an expanded HMM observed site): the
log-density rtol 1e-5 and its gradient rtol 1e-4 / atol 1e-5 against
JAX's ``build_logjoint``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.core import sample as jsample
from bayesic_tpu.core.logjoint import build_logjoint as jbuild
from bayesic_tpu_torch.core import sample as tsample
from bayesic_tpu_torch.core.logjoint import build_logjoint as tbuild

torch.set_num_threads(2)
K, T = 3, 5
LOCS = np.array([-2.0, 0.0, 2.0], np.float32)


def _logits(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(K).astype(np.float32),
            rng.standard_normal((K, K)).astype(np.float32))


def _pair(seed, t_len=T):
    init, trans = _logits(seed)
    j = jdist.HiddenMarkovModel(jnp.asarray(init), jnp.asarray(trans),
                                jdist.Normal(jnp.asarray(LOCS), 0.7), t_len)
    t = tdist.HiddenMarkovModel(torch.tensor(init), torch.tensor(trans),
                                tdist.Normal(torch.tensor(LOCS), 0.7), t_len)
    return j, t, init, trans


def _brute_log_prob(init, trans, x):
    """log p(x) by summing p(x, z) over all K^T paths, in float64."""
    li = init - np.log(np.sum(np.exp(init)))
    lt = trans - np.log(np.sum(np.exp(trans), -1, keepdims=True))
    lps = []
    for path in itertools.product(range(K), repeat=x.shape[0]):
        lp = li[path[0]] + sum(lt[a, b] for a, b in zip(path[:-1], path[1:]))
        lp += sum(-0.5 * ((x[t] - LOCS[k]) / 0.7) ** 2 - np.log(0.7)
                  - 0.5 * np.log(2 * np.pi) for t, k in enumerate(path))
        lps.append(lp)
    lps = np.asarray(lps)
    return lps.max() + np.log(np.sum(np.exp(lps - lps.max())))


def test_log_prob_matches_jax_and_enumeration_batched():
    jh, th, init, trans = _pair(0)
    xs = np.random.default_rng(1).normal(0, 2, (4, 2, T)).astype(np.float32)
    want = np.asarray(jax.jit(jh.log_prob)(jnp.asarray(xs)))
    got = th.log_prob(torch.tensor(xs))
    assert tuple(got.shape) == (4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    for idx in ((0, 0), (1, 0), (3, 1)):
        ref = _brute_log_prob(init.astype(np.float64),
                              trans.astype(np.float64),
                              xs[idx].astype(np.float64))
        np.testing.assert_allclose(float(got[idx]), ref, rtol=1e-5)


def test_viterbi_matches_jax():
    jh, th, _, _ = _pair(7, t_len=9)
    rng = np.random.default_rng(3)
    viterbi = jax.jit(jh.posterior_mode)
    for _ in range(4):
        x = rng.normal(0, 2, 9).astype(np.float32)
        want = np.asarray(viterbi(jnp.asarray(x)))
        got = th.posterior_mode(torch.tensor(x))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_given_jax_draws():
    jh, th, _, _ = _pair(8, t_len=6)
    key = jax.random.PRNGKey(6)
    shape = (3, 2)
    want = np.asarray(jax.jit(lambda k: jh.sample(k, shape))(key))
    k_state, k_obs = jax.random.split(key)
    gumbels = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(k_state, t), shape + (K,))) for t in range(6)])
    obs = np.asarray(jdist.Normal(jnp.asarray(LOCS), 0.7).sample(
        k_obs, (6,) + shape))
    got = th.sample(None, shape, gumbels=torch.tensor(gumbels),
                    obs_draws=torch.tensor(obs))
    assert tuple(got.shape) == (3, 2, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_posterior_sample_given_jax_gumbels():
    jh, th, _, _ = _pair(9, t_len=7)
    x = np.random.default_rng(4).normal(0, 2, 7).astype(np.float32)
    key = jax.random.PRNGKey(5)
    for shape in ((), (40,)):
        want = np.asarray(jax.jit(
            lambda k, xx: jh.posterior_sample(k, xx, shape))(
                key, jnp.asarray(x)))
        gumbels = np.stack([np.asarray(jax.random.gumbel(
            jax.random.fold_in(key, t), shape + (K,))) for t in range(7)])
        got = th.posterior_sample(None, torch.tensor(x), shape,
                                  gumbels=torch.tensor(gumbels))
        assert tuple(got.shape) == shape + (7,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_own_draws_have_the_right_shapes():
    _, th, _, _ = _pair(2)
    gen = torch.Generator().manual_seed(0)
    xs = th.expand((4,)).sample(gen, (3,))
    assert tuple(xs.shape) == (3, 4, T)
    zs = th.posterior_sample(gen, xs[0, 0], (6,))
    assert tuple(zs.shape) == (6, T)
    assert int(zs.min()) >= 0 and int(zs.max()) < K


def _nuts_model(sample, dist, data, asarray):
    """tests/test_hmm.py:106's model: emission locs of 40 iid chains."""
    init = asarray(np.log([0.5, 0.5]).astype(np.float32))
    trans = asarray(np.log([[0.9, 0.1], [0.1, 0.9]]).astype(np.float32))

    def model():
        locs = sample("locs", dist.Normal(0.0, 3.0).expand((2,))
                      .to_event(1))
        hmm = dist.HiddenMarkovModel(init, trans, dist.Normal(locs, 0.5), 12)
        sample("obs", hmm.expand((40,)).to_event(1), obs=data)

    return model


def test_model_log_density_and_grad_match_jax():
    data = np.random.default_rng(11).normal(0, 1.6, (40, 12)).astype(
        np.float32)
    _, jld, _, _ = jbuild(_nuts_model(jsample, jdist, jnp.asarray(data),
                                      jnp.asarray))
    _, tld, _, _ = tbuild(_nuts_model(tsample, tdist, torch.tensor(data),
                                      torch.tensor),
                          rng_key=torch.Generator().manual_seed(0))
    pts = np.random.default_rng(12).normal(0, 1.5, (3, 2)).astype(np.float32)
    want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda q: jld({"locs": q}))))(jnp.asarray(pts))
    got_g, got_v = torch.func.vmap(torch.func.grad_and_value(
        lambda q: tld({"locs": q})))(torch.tensor(pts))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-5)


def test_validation_errors():
    obs = tdist.Normal(torch.tensor(LOCS), 0.7)
    with pytest.raises(ValueError, match="batched HMMs"):
        tdist.HiddenMarkovModel(torch.zeros((2, K)), torch.zeros((K, K)),
                                obs, T)
    with pytest.raises(ValueError, match="transition_logits"):
        tdist.HiddenMarkovModel(torch.zeros(K), torch.zeros((K, K + 1)),
                                obs, T)
    with pytest.raises(ValueError, match="one emission law per state"):
        tdist.HiddenMarkovModel(torch.zeros(K), torch.zeros((K, K)),
                                tdist.Normal(torch.zeros((2, K)), 1.0), T)
    hmm = tdist.HiddenMarkovModel(torch.zeros(K), torch.zeros((K, K)), obs,
                                  T)
    ex = hmm.expand((4,))
    assert ex.batch_shape == (4,) and ex.event_shape == (T,)
    assert ex.initial_logits is hmm.initial_logits
