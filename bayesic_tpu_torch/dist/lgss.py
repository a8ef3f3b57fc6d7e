"""Linear-Gaussian state-space model: the marginal likelihood by the Kalman
filter, with a temporally parallel filter and smoother.

Counterpart of ``bayesic_tpu/dist/lgss.py``.  The Gaussian state path is
marginalised inside ``log_prob`` (the prediction-error decomposition), so
a model with linear-Gaussian dynamics carries no latent path.

The filter and the RTS smoother are associative operators (Särkkä &
García-Fernández, "Temporal Parallelization of Bayesian Smoothers", IEEE
TAC 2021) run through :func:`associative_scan`, a port of
``lax.associative_scan``'s odd/even recursion: log2(T) rounds of batched
(D, D) solves and matmuls in place of T dependent steps (on the card the
sequential filter is ~15 eager launches a step).  The sequential filter
is the small-T path and the oracle.

Model (time-invariant):

    z_0 ~ N(initial_mean, initial_cov)
    z_t = F z_{t-1} + eps_t,   eps_t ~ N(0, Q)       t = 1..T-1
    x_t = H z_t     + nu_t,    nu_t  ~ N(0, R)       t = 0..T-1

Event shape ``(num_steps, obs_dim)``.  A factorisation or solve that fails
on a bad proposal gives NaN, as in the JAX package, never an exception
(``cholesky_ex``, ``lu_factor_ex``), and nothing is written in place, so the
generic ``MCMC`` runs the density under ``torch.func.vmap(grad)``.
"""

from __future__ import annotations

import math

import torch

from . import constraints
from ._special import cholesky
from .distribution import Distribution, _float_dtype, broadcast_shapes

__all__ = ["LinearGaussianStateSpace", "associative_scan"]

_LOG_2PI = math.log(2.0 * math.pi)


def _interleave(a, b):
    """``a[0], b[0], a[1], b[1], ...`` along axis 0; ``a`` may be one
    longer than ``b``."""
    n = b.shape[0]
    if a.shape[0] == n:
        return torch.stack([a, b], 1).reshape((2 * n,) + tuple(b.shape[1:]))
    head, last = a.split([n, 1])
    return torch.cat([torch.stack([head, b], 1).reshape(
        (2 * n,) + tuple(b.shape[1:])), last])


def _pairs(e):
    """(e[0:-1:2], e[1::2], e[-1:] or None) by split and unbind, whose
    backward is one op each (a strided slice's backward zero-fills the
    whole input, two launches a slice)."""
    n = e.shape[0]
    last = None
    if n % 2:
        e, last = e.split([n - 1, 1])
    evens, odds = e.reshape((n // 2, 2) + tuple(e.shape[1:])).unbind(1)
    return evens, odds, last


def associative_scan(fn, elems, reverse=False):
    """``lax.associative_scan(fn, elems, reverse=reverse)`` over axis 0 of
    a tuple of tensors, by the same odd/even recursion
    (``jax/_src/lax/control_flow/loops.py``), so each prefix is combined
    in JAX's order.  ``fn(a, b)`` takes two tuples of batched elements, a
    earlier than b in scan order; with ``reverse=True`` the scan runs from
    the end, so ``a`` is the later element in time."""
    elems = [torch.flip(e, (0,)) if reverse else e for e in elems]

    def scan(elems):
        n = elems[0].shape[0]
        if n < 2:
            return elems
        parts = [_pairs(e) for e in elems]
        odd = scan(list(fn(tuple(p[0] for p in parts),
                           tuple(p[1] for p in parts))))
        firsts, tails = zip(*(p[0].split([1, n // 2 - 1]) for p in parts))
        if n % 2 == 0:
            # odd[:-1] with elems[2::2]
            even = fn(tuple(o.split([n // 2 - 1, 1])[0] for o in odd),
                      tails)
        else:
            even = fn(tuple(odd), tuple(torch.cat([t, p[2]])
                                        for t, p in zip(tails, parts)))
        return [_interleave(torch.cat([f, r]), o)
                for f, r, o in zip(firsts, even, odd)]

    out = scan(elems)
    return tuple(torch.flip(e, (0,)) if reverse else e for e in out)


def _solve(a, b):
    """a^-1 b by LU, NaN or inf where ``a`` is singular: no host check and
    no exception, in the backward pass too (``linalg.solve_ex``'s backward
    raises on a singular matrix)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    return torch.linalg.lu_solve(lu, piv, b)


def _t(a):
    return a.transpose(-1, -2)


def _sym(a):
    return 0.5 * (a + _t(a))


def _mvn_logpdf(x, mean, cov):
    """N(x; mean, cov) log-density by a Cholesky solve; x, mean (..., E).
    NaN where ``cov`` is not positive definite."""
    d = x.shape[-1]
    chol = cholesky(cov)
    w = torch.linalg.solve_triangular(chol, (x - mean)[..., None],
                                      upper=False)[..., 0]
    return (-0.5 * torch.sum(w * w, -1)
            - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                        -1)
            - 0.5 * d * _LOG_2PI)


class LinearGaussianStateSpace(Distribution):
    """``LinearGaussianStateSpace(initial_mean (D,), initial_cov (D, D),
    transition_matrix F (D, D), transition_cov Q (D, D),
    observation_matrix H (E, D), observation_cov R (E, E), num_steps)``.

    ``method``: ``"parallel"`` (associative scan), ``"sequential"``, or
    ``"auto"`` (parallel for ``num_steps >= 16``).  ``observed_mask``
    (num_steps,) bool marks the observed steps: a missing step adds no
    update and no term, and its values (NaN allowed) are never used.
    Batch LGSSMs: construct per instance and ``vmap``; ``log_prob`` takes
    leading batch dims on ``x`` for iid copies of one chain.  The
    parameters are float64 if one of them is, else float32."""

    _params = ("initial_mean", "initial_cov", "transition_matrix",
               "transition_cov", "observation_matrix", "observation_cov",
               "observed_mask")
    reparametrized = True
    support = constraints.real_vector

    def __init__(self, initial_mean, initial_cov, transition_matrix,
                 transition_cov, observation_matrix, observation_cov,
                 num_steps, method="auto", observed_mask=None):
        m0 = torch.as_tensor(initial_mean)
        if m0.dim() != 1:
            raise ValueError(
                "batched LGSSMs are not supported directly; vmap over "
                "per-instance constructions instead"
            )
        d = m0.shape[0]
        p0 = torch.as_tensor(initial_cov, device=m0.device)
        f = torch.as_tensor(transition_matrix, device=m0.device)
        q = torch.as_tensor(transition_cov, device=m0.device)
        h = torch.as_tensor(observation_matrix, device=m0.device)
        r = torch.as_tensor(observation_cov, device=m0.device)
        e = h.shape[0]
        for name, arr, want in (
            ("initial_cov", p0, (d, d)),
            ("transition_matrix", f, (d, d)),
            ("transition_cov", q, (d, d)),
            ("observation_matrix", h, (e, d)),
            ("observation_cov", r, (e, e)),
        ):
            if tuple(arr.shape) != want:
                raise ValueError(f"{name} must have shape {want}, got "
                                 f"{tuple(arr.shape)}")
        if method not in ("auto", "parallel", "sequential"):
            raise ValueError(f"method must be 'auto', 'parallel' or "
                             f"'sequential', got {method!r}")
        dtype = _float_dtype(m0, p0, f, q, h, r)
        (self.initial_mean, self.initial_cov, self.transition_matrix,
         self.transition_cov, self.observation_matrix,
         self.observation_cov) = (a.to(dtype) for a in (m0, p0, f, q, h, r))
        self.num_steps = int(num_steps)
        self.method = method
        if observed_mask is None:
            observed_mask = torch.ones(self.num_steps, dtype=torch.bool,
                                       device=m0.device)
        observed_mask = torch.as_tensor(observed_mask, dtype=torch.bool,
                                        device=m0.device)
        if tuple(observed_mask.shape) != (self.num_steps,):
            raise ValueError(f"observed_mask must have shape "
                             f"({self.num_steps},), got "
                             f"{tuple(observed_mask.shape)}")
        self.observed_mask = observed_mask
        super().__init__((), (self.num_steps, e))

    # ------------------------------------------------------------------
    @property
    def state_dim(self):
        return self.initial_mean.shape[0]

    @property
    def obs_dim(self):
        return self.observation_matrix.shape[0]

    def _parallel(self):
        return (self.method == "parallel"
                or (self.method == "auto" and self.num_steps >= 16))

    def expand(self, batch_shape):
        """iid batch of the SAME chain (params shared, not broadcast)."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._batch_shape = broadcast_shapes(self.batch_shape,
                                            tuple(batch_shape))
        return new

    def _x_safe(self, x):
        """Zero masked rows so NaN placeholders never reach the algebra."""
        return torch.where(self.observed_mask[:, None], x.to(
            self.initial_mean.dtype), 0.0)

    # -- filtering -------------------------------------------------------
    def _filter_seq(self, x):
        """Sequential Kalman filter: x (T, E) -> (filtered means (T, D),
        filtered covs (T, D, D))."""
        f, q = self.transition_matrix, self.transition_cov
        h, r = self.observation_matrix, self.observation_cov
        x = self._x_safe(x)
        mask = self.observed_mask

        def update(mp, pp, y, obs):
            s = h @ pp @ h.T + r
            k = _t(_solve(s, h @ pp))                  # pp H^T s^-1
            m = mp + k @ (y - h @ mp)
            p = _sym(pp - k @ s @ k.T)
            # missing observation: the filtered marginal IS the predictive
            return torch.where(obs, m, mp), torch.where(obs, p, pp)

        m, p = update(self.initial_mean, self.initial_cov, x[0], mask[0])
        ms, ps = [m], [p]
        for t in range(1, x.shape[0]):
            mp = f @ m
            pp = _sym(f @ p @ f.T + q)
            m, p = update(mp, pp, x[t], mask[t])
            ms.append(m)
            ps.append(p)
        return torch.stack(ms), torch.stack(ps)

    def _filter_par(self, x):
        """Parallel Kalman filter (Särkkä & García-Fernández 2021, §III):
        per-step five-tuples (A, b, C, eta, J) combined associatively; the
        prefix composite at t has b = filtered mean, C = filtered cov."""
        f, q = self.transition_matrix, self.transition_cov
        h, r = self.observation_matrix, self.observation_cov
        d = self.state_dim
        x = self._x_safe(x)
        mask = self.observed_mask
        eye = torch.eye(d, dtype=f.dtype, device=f.device)

        # generic element (t >= 1): transition by F/Q then observe y_t
        s = h @ q @ h.T + r                            # (E, E)
        k = _t(_solve(s, h @ q))                       # Q H^T S^-1 (D, E)
        ikh = eye - k @ h
        a_g = ikh @ f
        c_g = _sym(ikh @ q)
        fthsi = _t(_solve(s, h @ f))                   # F^T H^T S^-1
        j_g = fthsi @ (h @ f)

        bs = x[1:] @ k.T                               # (T-1, D)
        etas = x[1:] @ fthsi.T

        # first element: the prior N(m0, P0) updated by y_0
        m0, p0 = self.initial_mean, self.initial_cov
        s0 = h @ p0 @ h.T + r
        k0 = _t(_solve(s0, h @ p0))
        b0 = m0 + k0 @ (x[0] - h @ m0)
        c0 = _sym(p0 - k0 @ s0 @ k0.T)

        # a missing step's element is the pure transition (F, 0, Q, 0, 0)
        # (b and eta are 0 already: masked rows of x are zeroed); at t = 0
        # the composite reduces to the prior
        m_g = mask[1:, None, None]
        b0 = torch.where(mask[0], b0, m0)
        c0 = torch.where(mask[0], c0, p0)
        zero_d = torch.zeros_like(f)
        # the five parts of each element side by side in one (T, D, 3D + 2)
        # tensor, [A | b | C | eta | J], so that the scan slices, joins and
        # interleaves one tensor a round, not five
        first = torch.cat([zero_d, b0[:, None], c0, torch.zeros_like(b0)[:,
                           None], zero_d], -1)
        rest = torch.cat([torch.where(m_g, a_g, f), bs[..., None],
                          torch.where(m_g, c_g, q), etas[..., None],
                          torch.where(m_g, j_g, zero_d)], -1)

        sizes = [d, 1, d, 1, d]

        def combine(u, v):
            a_i, b_i, c_i, eta_i, j_i = u[0].split(sizes, -1)
            a_j, b_j, c_j, eta_j, j_j = v[0].split(sizes, -1)
            # A_j (I + C_i J_j)^-1 = solve((I + C_i J_j)^T, A_j^T)^T, and
            # (I + C_i J_j)^T = I + J_j C_i (C, J symmetric); one LU for
            # the three right-hand sides A_j^T, J_j A_i, eta_j - J_j b_i
            # (batched (n, D, k) products by bmm: matmul's broadcasting
            # adds expand and reshape nodes to every product's backward)
            mm = torch.bmm
            m = eye + mm(j_j, c_i)
            ja, jb = mm(j_j, torch.cat([a_i, b_i], -1)).split([d, 1], -1)
            s_a, s_rest = _solve(m, torch.cat([_t(a_j), ja, eta_j - jb],
                                              -1)).split([d, d + 1], -1)
            aji = _t(s_a)                              # A_j (I + C_i J_j)^-1
            a, b, aci = mm(aji, torch.cat([a_i, b_i + mm(c_i, eta_j), c_i],
                                          -1)).split([d, 1, d], -1)
            c = _sym(mm(aci, _t(a_j)) + c_j)
            j, eta = mm(_t(a_i), s_rest).split([d, 1], -1)
            return (torch.cat([a, b + b_j, c, eta + eta_i, _sym(j + j_i)],
                              -1),)

        out, = associative_scan(combine, (torch.cat([first[None], rest]),))
        return out[..., d], out[..., d + 1:2 * d + 1]

    def _filter(self, x):
        return (self._filter_par(x) if self._parallel()
                else self._filter_seq(x))

    def filter(self, x):
        """Filtered marginals p(z_t | x_{0:t}): x (T, E) ->
        (means (T, D), covs (T, D, D))."""
        x = torch.as_tensor(x)
        if tuple(x.shape) != self.event_shape:
            raise ValueError(f"filter expects a single path shaped "
                             f"{self.event_shape}, got {tuple(x.shape)}")
        return self._filter(x)

    # -- densities ---------------------------------------------------------
    def _log_prob_one(self, x):
        f, q = self.transition_matrix, self.transition_cov
        h, r = self.observation_matrix, self.observation_cov
        x = self._x_safe(x)
        ms, ps = self._filter(x)
        # prediction-error decomposition from the prefix filter outputs:
        # step t's predictive uses filtered t-1
        mp = torch.cat([self.initial_mean[None], ms[:-1] @ f.T])
        pp = torch.cat([self.initial_cov[None], f @ ps[:-1] @ f.T + q])
        s = h @ pp @ h.T + r                           # (T, E, E)
        terms = _mvn_logpdf(x, mp @ h.T, s)
        return torch.sum(torch.where(self.observed_mask, terms, 0.0), 0)

    def log_prob(self, x):
        x = torch.as_tensor(x)
        batch = tuple(x.shape[:-2])
        if tuple(x.shape[-2:]) != self.event_shape:
            raise ValueError(f"event shape mismatch: expected trailing "
                             f"{self.event_shape}, got {tuple(x.shape)}")
        if not batch:
            return self._log_prob_one(x)
        flat = x.reshape((-1,) + self.event_shape)
        return torch.func.vmap(self._log_prob_one)(flat).reshape(batch)

    # -- sampling ------------------------------------------------------------
    def sample(self, generator, sample_shape=(), eps=None, nus=None):
        """Draws (*sample_shape, *batch_shape, T, E).  ``eps`` (T, n, D) and
        ``nus`` (T, n, E), n the product of the draw shape, are the state
        and observation noise when given (the JAX package's
        ``normal(k_z, ...)`` and ``normal(k_x, ...)``); else they come
        from ``generator``."""
        shape = tuple(sample_shape) + self.batch_shape
        n = math.prod(shape)
        f, q = self.transition_matrix, self.transition_cov
        h, r = self.observation_matrix, self.observation_cov
        dt, dev = f.dtype, f.device
        if eps is None:
            eps = torch.randn((self.num_steps, n, self.state_dim),
                              generator=generator, device=generator.device,
                              dtype=dt)
        if nus is None:
            nus = torch.randn((self.num_steps, n, self.obs_dim),
                              generator=generator, device=generator.device,
                              dtype=dt)
        eps = torch.as_tensor(eps, dtype=dt, device=dev)
        nus = torch.as_tensor(nus, dtype=dt, device=dev)
        lq, lr, l0 = cholesky(q), cholesky(r), cholesky(self.initial_cov)
        zs = [self.initial_mean + eps[0] @ l0.T]
        for t in range(1, self.num_steps):
            zs.append(zs[-1] @ f.T + eps[t] @ lq.T)
        x = torch.stack(zs) @ h.T + nus @ lr.T         # (T, n, E)
        return x.movedim(0, 1).reshape(shape + self.event_shape)

    # -- posterior inference -------------------------------------------------
    def _backward_pieces(self, ms, ps):
        """Predictive covs Pp_{t+1} and the smoother gains G_t =
        P_t F^T Pp_{t+1}^-1, t < T-1."""
        f, q = self.transition_matrix, self.transition_cov
        pp = f @ ps[:-1] @ f.T + q                     # (T-1, D, D)
        gs = _t(_solve(_t(pp), f @ _t(ps[:-1])))
        return pp, gs

    def smooth(self, x):
        """RTS-smoothed marginals p(z_t | x_{0:T-1}): x (T, E) ->
        (means (T, D), covs (T, D, D)).  Parallel path: associative
        composition of the backward conditionals z_t | z_{t+1} ~
        N(E_t z_{t+1} + g_t, L_t) (Särkkä & García-Fernández 2021, §IV)."""
        ms, ps = self.filter(x)
        f = self.transition_matrix
        pp, gs = self._backward_pieces(ms, ps)
        e_el = gs
        g_el = ms[:-1] - (gs @ (ms[:-1] @ f.T)[..., None])[..., 0]
        l_el = _sym(ps[:-1] - gs @ pp @ _t(gs))

        if not self._parallel():
            m, p = ms[-1], ps[-1]
            sm, sp = [m], [p]
            for t in range(self.num_steps - 2, -1, -1):
                m = e_el[t] @ m + g_el[t]
                p = _sym(e_el[t] @ p @ e_el[t].T + l_el[t])
                sm.append(m)
                sp.append(p)
            return torch.stack(sm[::-1]), torch.stack(sp[::-1])

        # the terminal element is the degenerate conditional = the filtered
        # marginal at T-1, so the suffix composite at t IS the smoothed
        # marginal
        e_all = torch.cat([e_el, torch.zeros_like(f)[None]])
        g_all = torch.cat([g_el, ms[-1][None]])
        l_all = torch.cat([l_el, ps[-1][None]])

        def combine(u, v):
            # reverse=True feeds the LATER element as the left operand: u is
            # the suffix composite, v the earlier conditional; the wanted
            # composition is v then u
            e_j, g_j, l_j = u
            e_i, g_i, l_i = v
            e = e_i @ e_j
            g = (e_i @ g_j[..., None])[..., 0] + g_i
            l_ = _sym(e_i @ l_j @ _t(e_i) + l_i)
            return e, g, l_

        _, sm, sp = associative_scan(combine, (e_all, g_all, l_all),
                                     reverse=True)
        return sm, sp

    def posterior_sample(self, generator, x, sample_shape=(), eps=None):
        """Exact joint posterior draws of the state path given x (T, E):
        forward filter, backward sample; returns (*sample_shape, T, D).
        ``eps`` (T, n, D), n the product of ``sample_shape``, is the noise
        when given (the JAX package's ``normal(key, ...)``)."""
        ms, ps = self.filter(x)
        f = self.transition_matrix
        shape = tuple(sample_shape)
        n = math.prod(shape)
        d = self.state_dim
        if eps is None:
            eps = torch.randn((self.num_steps, n, d), generator=generator,
                              device=generator.device, dtype=f.dtype)
        eps = torch.as_tensor(eps, dtype=f.dtype, device=f.device)
        z = ms[-1] + eps[-1] @ cholesky(ps[-1]).T
        pp, gs = self._backward_pieces(ms, ps)
        covs = _sym(ps[:-1] - gs @ pp @ _t(gs))
        jitter = 1e-9 * torch.eye(d, dtype=f.dtype, device=f.device)
        chols = cholesky(covs + jitter)
        zs = [z]
        for t in range(self.num_steps - 2, -1, -1):
            mean = ms[t] + (z - ms[t] @ f.T) @ gs[t].T
            z = mean + eps[t] @ chols[t].T
            zs.append(z)
        z = torch.stack(zs[::-1])                      # (T, n, D)
        return z.movedim(0, 1).reshape(shape + (self.num_steps, d))

    @property
    def mean(self):
        """Marginal observation means (T, E)."""
        m = self.initial_mean
        ms = [m]
        for _ in range(self.num_steps - 1):
            m = self.transition_matrix @ m
            ms.append(m)
        out = torch.stack(ms) @ self.observation_matrix.T
        return out.expand(self.batch_shape + self.event_shape)
