"""Parity of the port's ``pathfinder`` (``infer/pathfinder.py``) with
``bayesic_tpu.infer.pathfinder`` and ``optax.lbfgs``.

Float64 on both sides (JAX under ``jax.enable_x64``, each JAX side
jitted).  Limits: rtol 1e-9 / atol 1e-12 for the masked two-loop inverse
Hessian, for each L-BFGS + zoom line-search step restarted from JAX's
state (the new iterate, the memory, the step size; the line-search step
counts equal), and for the per-iterate Gaussians and ELBOs given JAX's
noise; end to end, tests/test_pathfinder.py:34's gates (mean atol 0.03,
cov rtol 0.25 / atol 2e-4, ``pareto_k`` < 0.7, best ELBO within 0.1 of
log Z).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.stats import multivariate_normal

import bayesic_tpu_torch.dist as tdist
from bayesic_tpu_torch.core import sample as tsample

# the modules (each package's infer/__init__ exports the function under
# the module's name)
jpf = importlib.import_module("bayesic_tpu.infer.pathfinder")
tpf = importlib.import_module("bayesic_tpu_torch.infer.pathfinder")

torch.set_num_threads(2)
RTOL, ATOL = 1e-9, 1e-12


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_two_loop_dense_matches_jax():
    """Random windows with invalid (masked) pairs, negative-curvature and
    near-zero-curvature pairs."""
    rng = np.random.default_rng(0)
    p, j, dim = 6, 5, 4
    s = rng.standard_normal((p, j, dim))
    y = s @ np.diag([1.0, 2.0, 0.5, 3.0]) + 0.1 * rng.standard_normal(
        (p, j, dim))
    y[1, 2] = -s[1, 2]                              # sy < 0
    y[2, 4] = 1e-13 * rng.standard_normal(dim)      # sy ~ 0
    valid = rng.uniform(size=(p, j)) > 0.3
    valid[3] = False                                # no pair: gamma = 1
    with jax.enable_x64(True):
        want_h, want_g = jax.jit(jax.vmap(
            lambda a, b, v: jpf._two_loop_dense(a, b, v, dim)))(
                jnp.asarray(s), jnp.asarray(y), jnp.asarray(valid))
    got_h, got_g = tpf._two_loop_dense(torch.tensor(s), torch.tensor(y),
                                       torch.tensor(valid), dim)
    _close(got_h, want_h)
    _close(got_g, want_g)


def _rosenbrock_j(q):
    return jnp.sum(100.0 * (q[1:] - q[:-1] ** 2) ** 2 + (1.0 - q[:-1]) ** 2)


def _rosenbrock_t(q):
    return torch.sum(100.0 * (q[1:] - q[:-1] ** 2) ** 2
                     + (1.0 - q[:-1]) ** 2)


def _quartic_j(q):
    return jnp.sum(0.25 * q ** 4 + 0.5 * (q - jnp.arange(q.shape[0])) ** 2)


def _quartic_t(q):
    return torch.sum(0.25 * q ** 4 + 0.5 * (
        q - torch.arange(q.shape[0], dtype=q.dtype)) ** 2)


@pytest.mark.parametrize("target", ["rosenbrock", "quartic"])
def test_lbfgs_zoom_steps_match_optax(target):
    """optax.lbfgs(memory_size=6) as the JAX pathfinder steps it, three
    paths, 12 steps: each port step starts from JAX's state (so rounding
    cannot compound) and must give JAX's next iterate, memory and step
    size; the three paths run as one batch with their own line searches."""
    fj, ft = {"rosenbrock": (_rosenbrock_j, _rosenbrock_t),
              "quartic": (_quartic_j, _quartic_t)}[target]
    history, dim, paths = 6, 3, 3
    starts = np.random.default_rng(1).uniform(-2, 2, (paths, dim))
    with jax.enable_x64(True):
        opt = optax.lbfgs(memory_size=history)
        vg = jax.value_and_grad(fj)

        @jax.jit
        def step(q, state):
            value, grad = vg(q)
            updates, state = opt.update(grad, state, q, value=value,
                                        grad=grad, value_fn=fj)
            q_new = optax.apply_updates(q, updates)
            q_new = jnp.where(jnp.all(jnp.isfinite(q_new)), q_new, q)
            return q_new, state

        traj = []
        for q0 in starts:
            q, state = jnp.asarray(q0), opt.init(jnp.asarray(q0))
            rows = []
            for _ in range(12):
                q_new, state_new = step(q, state)
                rows.append(jax.tree.map(np.asarray,
                                         (q, state, q_new, state_new)))
                q, state = q_new, state_new
            traj.append(rows)

    tvg = torch.func.vmap(torch.func.grad_and_value(ft))

    def value_and_grad(q):
        g, v = tvg(q)
        return v, g

    checked_zoom = 0
    for k in range(12):
        rows = [traj[i][k] for i in range(paths)]
        lb = [r[1][0] for r in rows]
        state = tpf.LBFGSState(
            int(lb[0].count),
            *(torch.tensor(np.stack([getattr(s, f) for s in lb]))
              for f in ("params", "updates", "diff_params_memory",
                        "diff_updates_memory", "weights_memory")))
        q = torch.tensor(np.stack([r[0] for r in rows]))
        q_new, _, new, stepsize, counts = tpf.lbfgs_step(value_and_grad, q,
                                                         state)
        lb_new = [r[3][0] for r in rows]
        ls_new = [r[3][2] for r in rows]
        _close(q_new, np.stack([r[2] for r in rows]))
        _close(new.diff_params,
               np.stack([s.diff_params_memory for s in lb_new]))
        _close(new.weights, np.stack([s.weights_memory for s in lb_new]))
        _close(stepsize, np.stack([s.learning_rate for s in ls_new]))
        np.testing.assert_array_equal(
            counts.numpy(),
            np.stack([s.info.num_linesearch_steps for s in ls_new]))
        checked_zoom += int((counts > 1).sum())
    assert checked_zoom > 0           # the zoom phase ran somewhere


def test_gaussians_and_elbos_match_jax():
    """The per-iterate Gaussians and ELBOs (the JAX pathfinder's elbo_at,
    restated here on its module's helpers) given JAX's noise, on a
    recorded path with invalid early windows."""
    rng = np.random.default_rng(2)
    dim, history, n_it, e = 3, 4, 7, 16
    prec = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 0.5]])
    thetas = np.cumsum(rng.standard_normal((n_it + 1, dim)) * 0.3, 0)
    grads = thetas @ prec + 0.01 * rng.standard_normal((n_it + 1, dim))

    def logp_j(x):
        return -0.5 * x @ prec @ x

    with jax.enable_x64(True):
        eps = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (e, dim)))

        key = jax.random.PRNGKey(3)
        th, gr = jnp.asarray(thetas), jnp.asarray(grads)

        def elbo_at(k):
            pad_s = jnp.concatenate([jnp.zeros((history, dim)),
                                     th[1:] - th[:-1]])
            pad_y = jnp.concatenate([jnp.zeros((history, dim)),
                                     gr[1:] - gr[:-1]])
            s_win = jax.lax.dynamic_slice(pad_s, (k, 0), (history, dim))
            y_win = jax.lax.dynamic_slice(pad_y, (k, 0), (history, dim))
            valid = jnp.arange(history) >= (history - k)
            h, _ = jpf._two_loop_dense(s_win, y_win, valid, dim)
            mean = th[k] - h @ gr[k]
            chol = jnp.linalg.cholesky(h)
            ok = jnp.all(jnp.isfinite(chol)) & jnp.all(jnp.isfinite(mean))
            chol_safe = jnp.where(ok, chol, jnp.eye(dim))
            mean_safe = jnp.where(ok, mean, jnp.zeros(dim))
            xs, logq = jpf._mvn_sample_logq(key, mean_safe, chol_safe, e)
            elbo = jnp.mean(jax.vmap(logp_j)(xs) - logq)
            return (jnp.where(ok & jnp.isfinite(elbo), elbo, -jnp.inf),
                    mean_safe, chol_safe)

        want = jax.tree.map(np.asarray, jax.jit(jax.vmap(elbo_at))(
            jnp.arange(1, n_it + 1)))
    mean, chol, ok = tpf._gaussians(torch.tensor(thetas)[None],
                                    torch.tensor(grads)[None], history)
    prec_t = torch.tensor(prec)
    elbos = tpf._elbos(lambda x: -0.5 * torch.sum((x @ prec_t) * x, -1),
                       mean, chol, ok, torch.tensor(eps)[None])
    _close(mean[0], want[1])
    _close(chol[0], want[2])
    _close(elbos[0], want[0])


def _linreg(dtype=torch.float64):
    """tests/test_pathfinder.py:15's conjugate linear regression."""
    rng = np.random.default_rng(1)
    n = 60
    x = rng.normal(0.0, 1.0, n).astype(np.float32) + 1.0
    sigma = 0.5
    y = (1.5 * x - 0.7 + rng.normal(0, sigma, n)).astype(np.float32)
    xt, yt = torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=dtype)

    def model():
        w = tsample("w", tdist.Normal(0.0, 2.0))
        b = tsample("b", tdist.Normal(0.0, 2.0))
        tsample("obs", tdist.Normal(w * xt + b, sigma).to_event(1), obs=yt)

    xd = np.stack([x, np.ones_like(x)], 1).astype(np.float64)
    prec = xd.T @ xd / sigma**2 + np.eye(2) / 4.0
    cov = np.linalg.inv(prec)
    mean = cov @ (xd.T @ y) / sigma**2
    log_z = multivariate_normal(
        np.zeros(n), xd @ (4.0 * np.eye(2)) @ xd.T
        + sigma**2 * np.eye(n)).logpdf(y)
    return model, mean, cov, log_z


def _draws(paths, dim, elbo_draws, samples, seed):
    rng = np.random.default_rng(seed)
    return tpf.PathfinderDraws(
        torch.tensor(rng.uniform(size=(paths, dim))),
        torch.tensor(rng.standard_normal((paths, elbo_draws, dim))),
        torch.tensor(rng.standard_normal((paths, samples, dim))), seed)


def test_gaussian_posterior_gates():
    model, mean, cov, log_z = _linreg()
    res = tpf.pathfinder(model, num_paths=4, maxiter=40, num_samples=4000,
                         device="cpu", draws=_draws(4, 2, 32, 4000, 0))
    got = torch.stack([res.samples["w"], res.samples["b"]], 1).numpy()
    np.testing.assert_allclose(got.mean(0), mean, atol=0.03)
    np.testing.assert_allclose(np.cov(got.T), cov, rtol=0.25, atol=2e-4)
    assert res.pareto_k < 0.7
    np.testing.assert_allclose(res.elbo.numpy(), log_z, atol=0.1)
    assert res.unconstrained.shape == (4000, 2)
    assert res.best_iter.shape == (4,) and int(res.best_iter.min()) >= 1


def test_own_draws_float32_and_distinct_seed_rows():
    """Drawn from the generator (float32): the first rows are distinct
    (resampling without replacement from a healthy pool)."""
    model, mean, _, _ = _linreg(torch.float32)
    res = tpf.pathfinder(model, torch.Generator().manual_seed(3),
                         num_paths=4, maxiter=40, num_samples=64,
                         device="cpu")
    rows = res.unconstrained.numpy()
    assert rows.dtype == np.float32
    assert np.unique(rows, axis=0).shape[0] == rows.shape[0]
    np.testing.assert_allclose(rows.mean(0), mean, atol=0.1)


def test_all_paths_failed_raises():
    bad = torch.tensor([float("nan"), float("nan")])

    def model():
        mu = tsample("mu", tdist.Normal(0.0, 1.0))
        tsample("obs", tdist.Normal(mu + torch.zeros(2), 1.0).to_event(1),
                obs=bad)

    with pytest.raises(ValueError, match="all paths failed"):
        tpf.pathfinder(model, torch.Generator().manual_seed(0), num_paths=2,
                       maxiter=10, num_samples=16, device="cpu")
