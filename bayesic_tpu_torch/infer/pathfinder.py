"""Pathfinder: quasi-Newton variational inference (Zhang, Carpenter,
Gelman & Vehtari 2022), the fast approximation and MCMC initializer.

Counterpart of ``bayesic_tpu/infer/pathfinder.py``.  L-BFGS runs on the
negative unconstrained log-joint; every iterate, with the local L-BFGS
inverse-Hessian estimate, defines a Gaussian ``N(theta_k - H_k g_k,
H_k)``.  A Monte-Carlo ELBO picks the best per path, and pooled draws from
the paths are importance-resampled with Pareto-smoothed weights.

The JAX package runs ``optax.lbfgs(memory_size=history)``: optax 0.2.6's
``scale_by_lbfgs`` (its first step capped by the reciprocal gradient norm)
chained with ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')``.  Both are ported here by hand
(``lbfgs_direction``, ``zoom_linesearch``; ``torch.optim.LBFGS`` is
another algorithm).  The JAX paths run in lockstep under ``vmap``, each
line search a ``while_loop`` that freezes a finished path; here the paths
are one (P, dim) batch with per-path done masks, every line-search step
one batched gradient evaluation and one host read of the masks.

Every draw is an input: ``PathfinderDraws`` holds the initial uniforms,
the ELBO noise, the final draws' noise and the resampling seed, drawn
from the generator when not given.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.logjoint import default_device, init_to_uniform
from ..dist._special import cholesky
from ..utils.compare import _psis_smooth_one
from .mcmc.mcmc import flat_model

__all__ = ["pathfinder", "PathfinderResult", "PathfinderDraws"]

_LOG_2PI = math.log(2.0 * math.pi)
# optax.lbfgs's zoom line search (optax/_src/alias.py, linesearch.py)
_MAX_LS_STEPS = 20
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
_INCREASE, _INTERVAL_THRESHOLD = 2.0, 1e-5


class PathfinderResult(NamedTuple):
    samples: dict        # site -> (num_samples, *event) constrained draws
    logq: torch.Tensor   # (num_samples,) proposal log-density of each draw
    logp: torch.Tensor   # (num_samples,) joint log-density of each draw
    pareto_k: float      # PSIS tail diagnostic of the importance weights
    elbo: torch.Tensor   # (num_paths,) best per-path ELBO estimate
    best_iter: torch.Tensor  # (num_paths,) argmax iterate index per path
    unconstrained: torch.Tensor = None  # (num_samples, dim) flat draws —
    #   feed the first num_chains rows to MCMC(init_params=...) to warm
    #   start NUTS from the pathfinder approximation


class PathfinderDraws(NamedTuple):
    """The randomness of one ``pathfinder`` call (the JAX package draws
    each from its own key): ``init`` (P, dim) U(0, 1) for
    ``init_to_uniform``; ``elbo`` (P, num_elbo_draws, dim) and ``final``
    (P, num_samples, dim) standard normals, one block a path; and the
    numpy seed of the importance resampling."""
    init: torch.Tensor
    elbo: torch.Tensor
    final: torch.Tensor
    resample_seed: int


# -- L-BFGS (optax.scale_by_lbfgs) ------------------------------------------

class LBFGSState(NamedTuple):
    """``optax.ScaleByLBFGSState`` for a batch of P paths: the update count
    (shared), the last params and gradients (P, dim), and the memory of
    differences (P, m, dim) and their weights (P, m)."""
    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor
    diff_updates: torch.Tensor
    weights: torch.Tensor


def lbfgs_init(params, memory_size):
    p, dim = params.shape
    z = torch.zeros((p, memory_size, dim), dtype=params.dtype,
                    device=params.device)
    return LBFGSState(0, torch.zeros_like(params), torch.zeros_like(params),
                      z, z.clone(), torch.zeros(
                          (p, memory_size), dtype=params.dtype,
                          device=params.device))


def _vdot(a, b):
    return torch.sum(a * b, -1)


def lbfgs_direction(grad, state: LBFGSState, params):
    """``scale_by_lbfgs(memory_size, scale_init_precond=True).update``:
    stores the newest difference pair, then returns ``P_k grad`` (the
    two-loop recursion over the memory from the newest pair back) and the
    new state."""
    m = state.weights.shape[1]
    idx = state.count % m
    prev = (state.count - 1) % m
    first = state.count == 0
    diff_p = params - state.params
    diff_u = grad - state.updates
    vdot = _vdot(diff_u, diff_p)
    weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
    if first:
        diff_p, diff_u = torch.zeros_like(diff_p), torch.zeros_like(diff_u)
        weight = torch.zeros_like(weight)
    dw, du, rho = (state.diff_params.clone(), state.diff_updates.clone(),
                   state.weights.clone())
    dw[:, prev], du[:, prev], rho[:, prev] = diff_p, diff_u, weight

    num = _vdot(diff_u, diff_p)
    den = _vdot(diff_u, diff_u)
    scale = torch.where(den > 0.0, num / den, 1.0)
    if first:
        # the first step: the capped reciprocal gradient norm
        scale = torch.minimum(torch.ones_like(scale),
                              1.0 / torch.sqrt(_vdot(grad, grad)))

    order = [(idx + i) % m for i in range(m)]
    vec, alphas = grad, {}
    for i in reversed(order):
        alphas[i] = rho[:, i] * _vdot(dw[:, i], vec)
        vec = vec + (-alphas[i])[:, None] * du[:, i]
    vec = scale[:, None] * vec
    for i in order:
        beta = rho[:, i] * _vdot(du[:, i], vec)
        vec = vec + (alphas[i] - beta)[:, None] * dw[:, i]
    return vec, LBFGSState(state.count + 1, params, grad, dw, du, rho)


# -- zoom line search (optax.zoom_linesearch) --------------------------------

def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where none exists."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v1 = fb - fa - fpa * db
    v2 = fc - fa - fpa * dc
    aa = (dc ** 2 * v1 + (-(db ** 2)) * v2) / denom
    bb = ((-(dc ** 3)) * v1 + db ** 3 * v2) / denom
    radical = bb * bb - 3.0 * aa * fpa
    return a + (-bb + torch.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    bb = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * bb)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    dec = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - _APPROX_DEC_RTOL * torch.abs(value_init)
    dec = torch.minimum(torch.maximum(approx, delta), dec)
    dec = torch.clamp(dec, min=0.0)
    return torch.where(torch.isnan(dec), math.inf, dec)


def _curvature_error(slope, slope_init):
    curv = torch.clamp(torch.abs(slope) - _CURV_RTOL * torch.abs(slope_init),
                       min=0.0)
    return torch.where(torch.isnan(curv), math.inf, curv)


def zoom_linesearch(value_and_grad, params, updates, value, grad,
                    max_steps=_MAX_LS_STEPS):
    """``optax.scale_by_zoom_linesearch(max_steps, initial_guess_strategy=
    'one')`` on P paths at once: the step size (P,) along ``updates``
    from ``params`` that satisfies the sufficient-decrease and curvature
    criteria (or the safe / last step where the search fails), and the
    line-search steps each path took.  ``value_and_grad`` maps (P, dim)
    to ((P,), (P, dim)).  A path whose search has ended keeps its state,
    as ``vmap`` of the JAX ``while_loop`` keeps it."""
    slope0 = _vdot(updates, grad)
    zero = torch.zeros_like(value)
    st = dict(stepsize=zero, value=value, slope=slope0, low=zero,
              value_low=value, slope_low=slope0, high=zero, value_high=value,
              slope_high=slope0, cubic_ref=zero, value_cubic_ref=value,
              safe_stepsize=zero, safe_value=value)
    false = torch.zeros_like(value, dtype=torch.bool)
    found, done, failed = false, false, false
    counts = torch.zeros_like(value, dtype=torch.int64)
    for it in range(max_steps):
        active = ~(done | failed)
        if it and not bool(active.any()):
            break
        # the new point: the interval search's or the zoom's
        low, high = st["low"], st["high"]
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mc = _cubicmin(low, st["value_low"], st["slope_low"], high,
                       st["value_high"], st["cubic_ref"],
                       st["value_cubic_ref"])
        use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, st["value_low"], st["slope_low"], high,
                      st["value_high"])
        use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (
            mq < right - 0.1 * delta)
        middle = torch.where(use_cubic, mc, st["cubic_ref"])
        middle = torch.where(use_quad, mq, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0,
                             middle)
        search = (torch.ones_like(value) if it == 0
                  else _INCREASE * st["stepsize"])
        t = torch.where(found, middle, search)

        v, g = value_and_grad(params + t[:, None] * updates)
        s = _vdot(g, updates)
        dec = _decrease_error(t, v, s, value, slope0)
        curv = _curvature_error(s, slope0)
        ok = torch.maximum(dec, curv) <= 0.0
        safe_dec = dec <= 0.0
        last = it + 1 >= max_steps

        # interval search (Algorithm 3.5 of Nocedal & Wright)
        hi_new = (dec > 0.0) | ((v >= st["value"]) & (it > 0))
        lo_new = (s >= 0.0) & ~hi_new
        s_low = torch.where(lo_new, t, st["stepsize"])
        s_vlow = torch.where(lo_new, v, st["value"])
        s_slow = torch.where(lo_new, s, st["slope"])
        s_high = torch.where(lo_new, st["stepsize"], t)
        s_vhigh = torch.where(lo_new, st["value"], v)
        s_shigh = torch.where(lo_new, st["slope"], s)
        s_found = hi_new | lo_new | ok
        s_safe_t = torch.where(safe_dec, t, st["safe_stepsize"])
        s_safe_v = torch.where(safe_dec, v, st["safe_value"])

        # zoom (Algorithm 3.6)
        upd_safe = safe_dec & (v < st["safe_value"])
        z_safe_t = torch.where(upd_safe, t, st["safe_stepsize"])
        z_safe_v = torch.where(upd_safe, v, st["safe_value"])
        to_mid = (dec > 0.0) | (v >= st["value_low"])
        to_low = (s * (high - low) >= 0.0) & ~to_mid
        z_high = torch.where(to_low, low, torch.where(to_mid, t, high))
        z_vhigh = torch.where(to_low, st["value_low"],
                              torch.where(to_mid, v, st["value_high"]))
        z_shigh = torch.where(to_low, st["slope_low"],
                              torch.where(to_mid, s, st["slope_high"]))
        z_low = torch.where(~to_mid, t, low)
        z_vlow = torch.where(~to_mid, v, st["value_low"])
        z_slow = torch.where(~to_mid, s, st["slope_low"])
        hi_moved = to_mid | to_low
        z_cref = torch.where(hi_moved, high, low)
        z_vcref = torch.where(hi_moved, st["value_high"], st["value_low"])
        z_failed = (last | ((delta <= _INTERVAL_THRESHOLD) & (z_safe_t > 0.0))
                    ) & ~ok

        def pick(zoom, srch):
            return torch.where(found, zoom, srch)

        new = dict(
            stepsize=t, value=v, slope=s,
            low=pick(z_low, s_low), value_low=pick(z_vlow, s_vlow),
            slope_low=pick(z_slow, s_slow), high=pick(z_high, s_high),
            value_high=pick(z_vhigh, s_vhigh),
            slope_high=pick(z_shigh, s_shigh),
            cubic_ref=pick(z_cref, s_low),
            value_cubic_ref=pick(z_vcref, s_vlow),
            safe_stepsize=pick(z_safe_t, s_safe_t),
            safe_value=pick(z_safe_v, s_safe_v))
        new_found = pick(found, s_found)
        new_failed = pick(z_failed, last & ~ok)
        # a failed search takes the safe step, or stays where the domain
        # ended (_try_safe_step)
        take_safe = new_failed & ((new["safe_stepsize"] > 0.0)
                                  | torch.isinf(dec))
        new["stepsize"] = torch.where(take_safe, new["safe_stepsize"], t)
        new["value"] = torch.where(take_safe, new["safe_value"], v)
        st = {k: torch.where(active, new[k], st[k]) for k in st}
        found = torch.where(active, new_found, found)
        done = torch.where(active, ok, done)
        failed = torch.where(active, new_failed, failed)
        counts = counts + active.to(torch.int64)
    return st["stepsize"], counts


def lbfgs_step(value_and_grad, q, state: LBFGSState):
    """One ``optax.lbfgs`` update of every path from ``q`` (P, dim) as the
    JAX pathfinder takes it: the value and gradient at ``q``, the L-BFGS
    direction, the zoom line search, the step, and the guard that keeps a
    path whose new point is not finite at ``q``.  Returns ``(q_new, grad,
    state, stepsize, line-search steps)``; ``grad`` is the gradient at
    ``q``."""
    value, grad = value_and_grad(q)
    precond, state = lbfgs_direction(grad, state, q)
    updates = -1.0 * precond
    stepsize, counts = zoom_linesearch(value_and_grad, q, updates, value,
                                       grad)
    q_new = q + stepsize[:, None] * updates
    bad = ~torch.all(torch.isfinite(q_new), -1)
    return (torch.where(bad[:, None], q, q_new), grad, state, stepsize,
            counts)


# -- the Gaussian of an iterate ---------------------------------------------

def _two_loop_dense(s_win, y_win, valid, dim):
    """Dense inverse-Hessian from a window of (s, y) pairs (..., J, dim)
    via the masked two-loop recursion applied to the identity's rows.
    Invalid pairs have rho = 0 and drop out as exact no-ops.  Returns
    ``(H (..., dim, dim), gamma (...))``."""
    sy = _vdot(s_win, y_win)                              # (..., J)
    yy = _vdot(y_win, y_win)
    ss = _vdot(s_win, s_win)
    ok = valid & (sy > 1e-10 * torch.sqrt(ss * yy) + 1e-30)
    rho = torch.where(ok, 1.0 / torch.where(ok, sy, 1.0), 0.0)
    j = sy.shape[-1]
    idx = torch.arange(j, device=sy.device)
    last = torch.argmax(torch.where(ok, idx, -1), -1, keepdim=True)
    gamma = torch.where(
        ok.any(-1),
        torch.gather(sy, -1, last)[..., 0]
        / torch.clamp(torch.gather(yy, -1, last)[..., 0], min=1e-30), 1.0)
    # each row of q is H applied to one unit vector
    q = torch.eye(dim, dtype=s_win.dtype, device=s_win.device).expand(
        tuple(sy.shape[:-1]) + (dim, dim))
    alphas = [None] * j
    for i in range(j - 1, -1, -1):
        alphas[i] = rho[..., i, None] * (q @ s_win[..., i, :, None])[..., 0]
        q = q - alphas[i][..., None] * y_win[..., i, None, :]
    r = gamma[..., None, None] * q
    for i in range(j):
        b = rho[..., i, None] * (r @ y_win[..., i, :, None])[..., 0]
        r = r + s_win[..., i, None, :] * (alphas[i] - b)[..., None]
    return 0.5 * (r + r.transpose(-1, -2)), gamma


def _mvn_sample_logq(eps, mean, chol):
    """Draws mean + eps L^T (..., n, dim) and their log-density."""
    dim = mean.shape[-1]
    xs = mean[..., None, :] + eps @ chol.transpose(-1, -2)
    half_logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                     dim2=-1)), -1)
    logq = (-0.5 * torch.sum(eps * eps, -1) - half_logdet[..., None]
            - 0.5 * dim * _LOG_2PI)
    return xs, logq


def _gaussians(thetas, grads, history):
    """Each path's Gaussian at every iterate k = 1..L from the last
    ``history`` pairs before it: thetas, grads (P, L + 1, dim) ->
    (mean (P, L, dim), chol (P, L, dim, dim), ok (P, L)), mean 0 and
    chol I where the Cholesky or the mean is not finite."""
    p, n, dim = thetas.shape
    pad = torch.zeros((p, history, dim), dtype=thetas.dtype,
                      device=thetas.device)
    pad_s = torch.cat([pad, thetas[:, 1:] - thetas[:, :-1]], 1)
    pad_y = torch.cat([pad, grads[:, 1:] - grads[:, :-1]], 1)
    ks = torch.arange(1, n, device=thetas.device)
    win = ks[:, None] + torch.arange(history, device=thetas.device)
    valid = torch.arange(history, device=thetas.device) >= (
        history - ks[:, None])                            # (L, J)
    h, _ = _two_loop_dense(pad_s[:, win], pad_y[:, win], valid, dim)
    mean = thetas[:, 1:] - (h @ grads[:, 1:, :, None])[..., 0]
    chol = cholesky(h)
    ok = (torch.all(torch.isfinite(chol).flatten(-2), -1)
          & torch.all(torch.isfinite(mean), -1))
    eye = torch.eye(dim, dtype=h.dtype, device=h.device)
    return (torch.where(ok[..., None], mean, 0.0),
            torch.where(ok[..., None, None], chol, eye), ok)


def _elbos(logp_fn, mean, chol, ok, eps):
    """The Monte-Carlo ELBO of each iterate's Gaussian on the path's one
    block of noise ``eps`` (P, E, dim); -inf where not finite."""
    xs, logq = _mvn_sample_logq(eps[:, None], mean, chol)  # (P, L, E, .)
    logp = logp_fn(xs.reshape(-1, xs.shape[-1])).reshape(logq.shape)
    elbo = torch.mean(logp - logq, -1)
    return torch.where(ok & torch.isfinite(elbo), elbo, -math.inf)


def _draws(gen, num_paths, dim, num_elbo_draws, num_samples, dtype, device):
    def normal(shape):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=dtype).to(device)

    init = torch.rand((num_paths, dim), generator=gen, device=gen.device,
                      dtype=dtype).to(device)
    elbo = normal((num_paths, num_elbo_draws, dim))
    final = normal((num_paths, num_samples, dim))
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             device=gen.device))
    return PathfinderDraws(init, elbo, final, seed)


def pathfinder(model, rng_key=None, *, num_paths=4, maxiter=60, history=6,
               num_elbo_draws=32, num_samples=1000, init_radius=2.0,
               model_args=(), model_kwargs=None, psis=True, device=None,
               draws: PathfinderDraws = None) -> PathfinderResult:
    """Multi-path Pathfinder over ``model``'s unconstrained posterior.

    Returns :class:`PathfinderResult` with ``num_samples`` constrained
    draws, importance-resampled (with PSIS smoothing when ``psis=True``)
    from the pooled best-per-path Gaussians; ``pareto_k`` > 0.7 flags an
    unreliable approximation (``utils.compare.psis_loo``'s contract).
    ``rng_key`` is a ``torch.Generator`` that draws ``draws`` when they
    are not given.  ``device`` as in ``MCMC``: by default the device of
    the first tensor of ``model_args``, else ``"cuda"``; the paths run
    there in the dtype of ``draws.init`` (float32 when drawn here)."""
    device = default_device(device, model_args)
    fm = flat_model(model, model_args, model_kwargs, device)
    dim = fm.dim
    if draws is None:
        if rng_key is None:
            raise ValueError("pathfinder needs rng_key or draws")
        draws = _draws(rng_key, num_paths, dim, num_elbo_draws, num_samples,
                       torch.float32, device)
    init = torch.as_tensor(draws.init, device=device)
    q = fm.ravel(init_to_uniform(fm.info, uniforms=init,
                                 radius=init_radius))
    dtype = q.dtype

    def neg_logp(qq):
        return -fm.logdensity(fm.unravel(qq))

    vg = torch.func.vmap(torch.func.grad_and_value(neg_logp))

    def value_and_grad(qq):
        g, v = vg(qq)
        return v, g

    logp_fn = torch.func.vmap(lambda x: -neg_logp(x))

    state = lbfgs_init(q, history)
    thetas, grads = [], []
    for _ in range(maxiter + 1):
        q_new, g, state, _, _ = lbfgs_step(value_and_grad, q, state)
        thetas.append(q)
        grads.append(g)
        q = q_new
    thetas, grads = torch.stack(thetas, 1), torch.stack(grads, 1)

    mean, chol, ok = _gaussians(thetas, grads, history)
    elbos = _elbos(logp_fn, mean, chol, ok,
                   torch.as_tensor(draws.elbo, dtype=dtype, device=device))
    best = torch.argmax(elbos, -1)                       # (P,)
    rows = torch.arange(best.shape[0], device=device)
    xs, logq = _mvn_sample_logq(
        torch.as_tensor(draws.final, dtype=dtype, device=device),
        mean[rows, best], chol[rows, best])
    logp = logp_fn(xs.reshape(-1, dim)).reshape(logq.shape)
    best_elbo, best_iter = elbos[rows, best], best + 1

    xs = xs.reshape(-1, dim)
    # the pooled proposal is the mixture of the per-path Gaussians drawn
    # equally; the per-path logq as the proposal density is the paper's
    # (slightly conservative) per-path weighting
    logq, logp = logq.reshape(-1), logp.reshape(-1)
    lw = (logp - logq).cpu().numpy().astype(np.float64)
    finite = np.isfinite(lw)
    if not np.any(finite):
        raise ValueError(
            "pathfinder: all paths failed — every pooled draw has a "
            "non-finite importance log-weight (the L-BFGS paths diverged "
            "or the target density is non-finite at every draw).  Check "
            "the model/initialization, or increase num_paths/maxiter.")
    lw = np.where(finite, lw, -np.inf)
    if psis:
        lw_s, k_hat = _psis_smooth_one(lw.copy())
    else:
        lw_s = lw - (np.max(lw) + np.log(np.sum(np.exp(lw - np.max(lw)))))
        k_hat = float("nan")
    w = np.exp(lw_s - lw_s.max())
    w = w / w.sum()
    rng = np.random.default_rng(int(draws.resample_seed))
    # importance resampling WITHOUT replacement when the positive-weight
    # pool allows it: the first num_chains rows of `unconstrained` seed
    # MCMC chains (MCMC(init_params=...)), and duplicate seed points
    # weaken between-chain diagnostics; with-replacement draws are kept
    # only as the degenerate-weight fallback.
    n_pos = int(np.count_nonzero(w))
    idx = rng.choice(lw.shape[0], size=num_samples,
                     replace=n_pos < num_samples, p=w)
    idx_t = torch.as_tensor(idx, device=device)
    chosen = xs[idx_t]
    return PathfinderResult(
        samples=fm.constrain(chosen),
        logq=logq[idx_t],
        logp=logp[idx_t],
        pareto_k=float(k_hat),
        elbo=best_elbo,
        best_iter=best_iter,
        unconstrained=chosen,
    )
