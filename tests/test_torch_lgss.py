"""Parity of the port's ``LinearGaussianStateSpace`` (``dist/lgss.py``)
with ``bayesic_tpu.dist.LinearGaussianStateSpace``.

Everything runs in float64 in both packages (JAX under
``jax.enable_x64``, each JAX side jitted).  Limits: rtol 1e-9 (atol 1e-12
where an entry crosses zero) for the filtered and smoothed marginals,
``log_prob`` and its gradients against JAX, for each method and with and
without an observation mask; rtol 1e-9 for draws given JAX's noise; rtol
1e-8 between the port's parallel and sequential schedules (the two
algorithms round differently).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu_torch.dist.lgss import associative_scan

torch.set_num_threads(2)
RTOL, ATOL = 1e-9, 1e-12
SCHEDULE_RTOL = 1e-8
T_LEN = 21                   # odd: both branches of the scan's recursion
MASK = np.array([True, False, True, True, False, True, True, False]
                * 2 + [True] * 5)


def _system(d=3, e=2, seed=1):
    """tests/test_lgss.py's system."""
    rng = np.random.default_rng(seed)
    f = 0.9 * np.eye(d) + 0.05 * rng.standard_normal((d, d))
    q = 0.1 * np.eye(d)
    h = rng.standard_normal((e, d))
    r = 0.2 * np.eye(e)
    m0 = rng.standard_normal(d)
    p0 = np.eye(d)
    return m0, p0, f, q, h, r


def _series(t_len=T_LEN, e=2, seed=3):
    return np.random.default_rng(seed).standard_normal((t_len, e))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@functools.lru_cache(maxsize=None)
def _jax_fn(method):
    """JAX's filter, smooth, log_prob and its gradient w.r.t. the initial
    mean, F, Q and R, jitted once a method (the mask is an argument)."""
    def fn(m0, p0, f, q, h, r, xx, mask):
        def build(m0, f, q, r):
            return jdist.LinearGaussianStateSpace(
                m0, p0, f, q, h, r, xx.shape[0], method=method,
                observed_mask=mask)

        lp, grads = jax.value_and_grad(
            lambda *a: build(*a).log_prob(xx), argnums=(0, 1, 2, 3))(
                m0, f, q, r)
        lg = build(m0, f, q, r)
        return lg.filter(xx), lg.smooth(xx), lp, grads

    return jax.jit(fn)


def _jax_all(params, x, method, mask):
    if mask is None:
        mask = np.ones(x.shape[0], bool)
    with jax.enable_x64(True):
        out = _jax_fn(method)(*(jnp.asarray(a) for a in params + (x, mask)))
        return jax.tree.map(np.asarray, out)


def _port_all(params, x, method, mask):
    m0, p0, f, q, h, r = (torch.tensor(a) for a in params)
    leaves = [a.clone().requires_grad_(True) for a in (m0, f, q, r)]
    lg = tdist.LinearGaussianStateSpace(
        leaves[0], p0, leaves[1], leaves[2], h, leaves[3], x.shape[0],
        method=method,
        observed_mask=None if mask is None else torch.tensor(mask))
    xt = torch.tensor(x)
    lp = lg.log_prob(xt)
    grads = torch.autograd.grad(lp, leaves)
    with torch.no_grad():
        return (lg.filter(xt), lg.smooth(xt), lp.detach(), grads)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("method", ["sequential", "parallel"])
def test_filter_smooth_log_prob_and_grads_match_jax(method, masked):
    params = _system()
    x = _series()
    mask = MASK if masked else None
    if masked:
        x = np.where(MASK[:, None], x, np.nan)    # placeholders never used
    (jfm, jfp), (jsm, jsp), jlp, jg = _jax_all(params, x, method, mask)
    (tfm, tfp), (tsm, tsp), tlp, tg = _port_all(params, x, method, mask)
    _close(tfm, jfm)
    _close(tfp, jfp)
    _close(tsm, jsm)
    _close(tsp, jsp)
    _close(tlp, jlp)
    assert np.isfinite(float(tlp))
    for got, want in zip(tg, jg):
        _close(got, want)


def test_parallel_equals_sequential():
    params = _system(seed=2)
    x = _series(seed=4)
    outs = {}
    for method in ("sequential", "parallel"):
        for mask in (None, MASK):
            outs[method, mask is None] = _port_all(params, x, method, mask)

    def sym(g):
        return 0.5 * (g + g.T)

    for full in (True, False):
        seq, par = outs["sequential", full], outs["parallel", full]
        for a, b in zip(par[:2], seq[:2]):
            for u, v in zip(a, b):
                _close(u, v, rtol=SCHEDULE_RTOL, atol=1e-11)
        _close(par[2], seq[2], rtol=SCHEDULE_RTOL)
        # Q and R enter the two schedules through different products:
        # their gradients agree on symmetric directions (the sym part)
        for i, (u, v) in enumerate(zip(par[3], seq[3])):
            if i >= 2:
                u, v = sym(u), sym(v)
            _close(u, v, rtol=SCHEDULE_RTOL, atol=1e-11)


def test_auto_picks_parallel_from_16_steps():
    m0, p0, f, q, h, r = _system()
    for t_len, want in ((15, False), (16, True)):
        lg = tdist.LinearGaussianStateSpace(m0, p0, f, q, h, r, t_len)
        assert lg._parallel() is want


def test_associative_scan_matches_lax_order():
    """A non-commutative combine (2 x 2 matrix products) over odd and even
    lengths, forward and reversed: equal to lax.associative_scan."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 8, 13):
        a = rng.standard_normal((n, 2, 2))
        for reverse in (False, True):
            with jax.enable_x64(True):
                want = jax.jit(lambda e: jax.lax.associative_scan(
                    lambda u, v: u @ v, e, reverse=reverse))(jnp.asarray(a))
            got, = associative_scan(lambda u, v: (u[0] @ v[0],),
                                    (torch.tensor(a),), reverse=reverse)
            _close(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("method", ["sequential", "parallel"])
def test_posterior_sample_and_sample_given_jax_noise(method):
    params = _system(seed=3)
    x = _series(t_len=9, seed=6)
    m0, p0, f, q, h, r = params
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        jlg = jdist.LinearGaussianStateSpace(
            *(jnp.asarray(a) for a in params), 9, method=method)
        want_z = np.asarray(jax.jit(
            lambda k, xx: jlg.posterior_sample(k, xx, (5, 2)))(
                key, jnp.asarray(x)))
        eps = np.asarray(jax.random.normal(key, (9, 10, 3)))
        want_x = np.asarray(jax.jit(lambda k: jlg.sample(k, (4,)))(key))
        k_z, k_x = jax.random.split(key)
        eps_z = np.asarray(jax.random.normal(k_z, (9, 4, 3)))
        nus = np.asarray(jax.random.normal(k_x, (9, 4, 2)))
    tlg = tdist.LinearGaussianStateSpace(
        *(torch.tensor(a) for a in params), 9, method=method)
    got_z = tlg.posterior_sample(None, torch.tensor(x), (5, 2),
                                 eps=torch.tensor(eps))
    assert tuple(got_z.shape) == (5, 2, 9, 3)
    _close(got_z, want_z)
    got_x = tlg.sample(None, (4,), eps=torch.tensor(eps_z),
                       nus=torch.tensor(nus))
    assert tuple(got_x.shape) == (4, 9, 2)
    _close(got_x, want_x)


def test_vmap_grad_over_parameter_sets():
    """The generic MCMC's form: torch.func.vmap(grad) of log_prob over 4
    transition matrices (the parallel schedule), each equal to JAX's
    gradient."""
    params = _system()
    m0, p0, f, q, h, r = params
    x = _series()
    rng = np.random.default_rng(7)
    fs = f[None] + 0.05 * rng.standard_normal((4, 3, 3))
    want = [_jax_all((m0, p0, fm, q, h, r), x, "parallel", None)[3][1]
            for fm in fs]
    xt = torch.tensor(x)

    def tlp(fm):
        return tdist.LinearGaussianStateSpace(
            torch.tensor(m0), torch.tensor(p0), fm, torch.tensor(q),
            torch.tensor(h), torch.tensor(r), T_LEN).log_prob(xt)

    got = torch.func.vmap(torch.func.grad(tlp))(torch.tensor(fs))
    _close(got, np.stack(want))


@pytest.mark.parametrize("method", ["sequential", "parallel"])
def test_non_pd_proposal_gives_non_finite_log_prob(method):
    """A bad proposal (negative variances) makes JAX's Cholesky NaN, which
    NUTS counts as a divergence; the port must give a non-finite value
    too, not raise."""
    m0, p0, f, q, h, r = _system()
    x = torch.tensor(_series())
    for q_bad, r_bad in ((-q, r), (q, -r)):
        lg = tdist.LinearGaussianStateSpace(
            *(torch.tensor(a) for a in (m0, p0, f, q_bad, h, r_bad)), T_LEN,
            method=method)
        assert not np.isfinite(float(lg.log_prob(x)))
    fb = torch.tensor(f).requires_grad_(True)
    lg = tdist.LinearGaussianStateSpace(
        *(torch.tensor(a) for a in (m0, p0)), fb,
        *(torch.tensor(a) for a in (-q, h, r)), T_LEN, method=method)
    g, = torch.autograd.grad(lg.log_prob(x), fb)   # no exception
    assert g.shape == (3, 3)
    # a singular innovation covariance (two equal rows of H, R = 0): the
    # solves give NaN / inf, forward and backward, without raising
    h_sing = np.stack([h[0], h[0]])
    fb = torch.tensor(f).requires_grad_(True)
    lg = tdist.LinearGaussianStateSpace(
        *(torch.tensor(a) for a in (m0, p0)), fb,
        *(torch.tensor(a) for a in (q, h_sing, 0.0 * r)), T_LEN,
        method=method)
    lp = lg.log_prob(x)
    assert not np.isfinite(float(lp.detach()))
    torch.autograd.grad(lp, fb)


def test_batched_log_prob_expand_and_mean():
    m0, p0, f, q, h, r = _system(seed=5)
    xs = np.random.default_rng(8).standard_normal((3, 2, 12, 2))
    tlg = tdist.LinearGaussianStateSpace(
        *(torch.tensor(a) for a in (m0, p0, f, q, h, r)), 12)
    with jax.enable_x64(True):
        jlg = jdist.LinearGaussianStateSpace(
            *(jnp.asarray(a) for a in (m0, p0, f, q, h, r)), 12)
        want = np.asarray(jax.jit(jlg.log_prob)(jnp.asarray(xs)))
        want_mean = np.asarray(jlg.mean)
    got = tlg.log_prob(torch.tensor(xs))
    assert tuple(got.shape) == (3, 2)
    _close(got, want)
    _close(tlg.mean, want_mean)
    ex = tlg.expand((3,))
    assert ex.batch_shape == (3,) and ex.event_shape == (12, 2)
    assert ex.transition_matrix is tlg.transition_matrix
    assert tuple(ex.mean.shape) == (3, 12, 2)


def test_validation_errors():
    z2, e2 = torch.zeros(2), torch.eye(2)
    with pytest.raises(ValueError, match="batched LGSSMs"):
        tdist.LinearGaussianStateSpace(torch.zeros((2, 2)), e2, e2, e2, e2,
                                       e2, 4)
    with pytest.raises(ValueError, match="observation_matrix"):
        tdist.LinearGaussianStateSpace(z2, e2, e2, e2, torch.ones((1, 3)),
                                       torch.eye(1), 4)
    with pytest.raises(ValueError, match="method"):
        tdist.LinearGaussianStateSpace(z2, e2, e2, e2, torch.ones((1, 2)),
                                       torch.eye(1), 4, method="bogus")
    with pytest.raises(ValueError, match="observed_mask"):
        tdist.LinearGaussianStateSpace(z2, e2, e2, e2, torch.ones((1, 2)),
                                       torch.eye(1), 4,
                                       observed_mask=torch.ones(3, dtype=bool))
    lg = tdist.LinearGaussianStateSpace(z2, e2, e2, e2, torch.ones((1, 2)),
                                        torch.eye(1), 4)
    with pytest.raises(ValueError, match="event shape"):
        lg.log_prob(torch.zeros((5, 1)))
    with pytest.raises(ValueError, match="single path"):
        lg.filter(torch.zeros((2, 4, 1)))
