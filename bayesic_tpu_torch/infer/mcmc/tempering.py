"""Parallel tempering (replica exchange) MCMC.

Counterpart of ``bayesic_tpu/infer/mcmc/tempering.py``: K replicas target
``prior * lik^beta_k`` on a ladder ``1 = beta_0 >= ... >= beta_{K-1}``,
each moves by static-trajectory HMC, and adjacent rungs exchange states by
the Metropolis swap rule ``log a = (beta_i - beta_j)(ll_j - ll_i)``.  Hot
rungs cross energy barriers; swaps carry what they find to the cold rung,
whose marginal is the posterior.

As in the JAX package: replicas and chains are tensor axes (C, K, ...)
moved in lockstep; step t proposes swaps on the pairs that start at
parity t % 2 (deterministic even-odd pairing); a swap moves only ``q``
and the cached ``(log prior, log lik)``, while each rung keeps its step
size and mass; each transition re-derives the potential and gradient at
its own beta.  Warmup adapts a dual-averaging step size and a diagonal
Welford mass per rung, pooled over the chains.

Every draw is an input: :func:`hmc_core` takes the momentum normals and
the accept uniforms, :func:`swap_core` the ``(C, K // 2 + 1)`` swap
uniforms (one per pair, shared by both members), drawn from the streams
keyed by ``(seed, phase, t, chain)`` (``streams.py``, lanes over the
rungs).  ``chain_sharding`` splits the chains over a mesh axis: the
rungs of a chain stay on one rank, so swaps need no collective; the
warmup's pooled statistics and the evidence estimates all-gather the
chains' rows and reduce them as one process would.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ...core.logjoint import default_device, init_to_uniform
from ...parallel.mesh import all_gather, local_chains
from .adapt import (build_schedule, da_init, da_update, welford_finalize,
                    welford_init, welford_update_batch)
from .mcmc import constrained_draws, flat_model
from .streams import (INIT, PT_ACCEPT, PT_MOMENTUM, PT_SWAP, SAMPLE, WARMUP,
                      StreamKey, init_uniforms, normals, uniforms)

__all__ = ["ParallelTempering", "PTResult", "geometric_ladder", "hmc_core",
           "swap_core"]


class PTResult(NamedTuple):
    samples: dict                # site -> (chains, num_samples, *event)
    extra: dict                  # swap_accept (K-1,), step_size (K,), ...
    unconstrained: torch.Tensor  # (chains, num_samples, dim) cold rung
    chains: Any = None           # (chains,) global indices of the rows


class _PTState(NamedTuple):
    q: torch.Tensor    # (C, K, dim)
    lp: torch.Tensor   # (C, K) log prior (+ Jacobians)
    ll: torch.Tensor   # (C, K) log likelihood


def _ti_evidence(betas, lls):
    """Thermodynamic integration: log Z = int_0^1 E_beta[loglik] d beta,
    trapezoid over the ladder (ascending).  ``lls`` (S, C, K).  Covers only
    [min(betas), 1]: a ladder that reaches beta = 0 gives the whole
    marginal likelihood."""
    mean_ll = torch.mean(lls, dim=(0, 1))
    order = torch.argsort(betas, stable=True)
    b, m = betas[order], mean_ll[order]
    return torch.sum(0.5 * (m[1:] + m[:-1]) * (b[1:] - b[:-1]))


def _stepping_stone(betas, lls):
    """Stepping stone (Xie et al. 2011): log Z = sum_k log
    E_{beta_k}[exp((beta_{k+1} - beta_k) ll)], adjacent rungs ascending,
    each expectation from the lower rung's S*C draws."""
    order = torch.argsort(betas, stable=True)
    b = betas[order]
    ll_sorted = lls[:, :, order].reshape(-1, betas.shape[0])
    n = ll_sorted.shape[0]
    delta = b[1:] - b[:-1]
    terms = torch.logsumexp(delta[None, :] * ll_sorted[:, :-1], 0) \
        - math.log(n)
    return torch.sum(terms)


def geometric_ladder(num_replicas, beta_min=0.05, device=None):
    """beta_k = beta_min^(k/(K-1)), the usual ladder for tempering the
    likelihood (float32, computed in float64 on the host as numpy does)."""
    if num_replicas == 1:
        return torch.ones((1,), device=device)
    k = np.arange(num_replicas) / (num_replicas - 1)
    return torch.as_tensor(np.asarray(beta_min ** k, np.float32),
                           device=device)


def hmc_core(pe_grad, q0, beta, eps, inv_mass, mom, u_acc, num_leapfrog):
    """One static-trajectory HMC transition of every (chain, rung) on U =
    -(lp + beta ll), the potential and gradient recomputed at the start
    (``q0`` may have been swapped in).

    ``q0`` (C, K, D); ``beta``, ``eps`` (K,); ``inv_mass`` (K, D); ``mom``
    (C, K, D) standard normals; ``u_acc`` (C, K) accept uniforms (accept
    when u < the accept probability).  ``pe_grad(q, beta)`` maps (C, K, D)
    and (K,) to (C, K), (C, K, D).  Returns ``(q1, accept_prob)``."""
    pe0, grad0 = pe_grad(q0, beta)
    p0 = mom / torch.sqrt(inv_mass)
    h0 = pe0 + 0.5 * torch.sum(inv_mass * p0 * p0, -1)
    e = eps[:, None]
    q, p, grad, pe = q0, p0, grad0, pe0
    for _ in range(num_leapfrog):
        p_half = p - 0.5 * e * grad
        q = q + e * inv_mass * p_half
        pe, grad = pe_grad(q, beta)
        p = p_half - 0.5 * e * grad
    h1 = pe + 0.5 * torch.sum(inv_mass * p * p, -1)
    delta = torch.where(torch.isnan(h1 - h0), float("inf"), h1 - h0)
    accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
    accept = u_acc < accept_prob
    return torch.where(accept[..., None], q, q0), accept_prob


def swap_core(state: _PTState, betas, parity, u):
    """Even-odd adjacent swaps at ``parity`` (0 or 1): pair (k, k+1) for k
    = parity, parity + 2, ...  ``u`` (C, K // 2 + 1): one uniform per pair,
    shared by both members (pair index min(k, partner) // 2).  Returns the
    swapped state and the per-pair accept indicator, counted at each
    pair's lower rung (C, K)."""
    k_count = betas.shape[0]
    k_idx = torch.arange(k_count, device=betas.device)
    down = torch.where((k_idx % 2) == parity, k_idx + 1, k_idx - 1)
    partner = torch.clamp(down, 0, k_count - 1)
    valid = partner != k_idx
    ll_p = state.ll[:, partner]
    log_a = (betas[None, :] - betas[partner][None, :]) * (ll_p - state.ll)
    u_k = u[:, torch.minimum(k_idx, partner) // 2]
    do_swap = valid[None, :] & (torch.log(u_k) < log_a)

    def sel(a):
        mask = do_swap.reshape(do_swap.shape + (1,) * (a.dim() - 2))
        return torch.where(mask, a[:, partner], a)

    lower = valid & (k_idx < partner)
    pair_acc = torch.where(lower[None, :], do_swap.to(state.ll.dtype), 0.0)
    return _PTState(sel(state.q), sel(state.lp), sel(state.ll)), pair_acc


class ParallelTempering:
    """``ParallelTempering(model, num_replicas=8, ...)``; ``betas`` must
    descend from 1.0 (the cold rung, whose draws are returned).  ``device``
    as in ``MCMC``; ``chain_sharding`` as in the module docstring."""

    def __init__(self, model=None, *, num_replicas=8, betas=None,
                 beta_min=0.05, num_warmup=500, num_samples=1000,
                 num_chains=8, num_leapfrog=16, target_accept=0.8,
                 init_step_size=0.1, model_args=(), model_kwargs=None,
                 chain_sharding=None, device=None):
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.num_leapfrog = int(num_leapfrog)
        self.target_accept = float(target_accept)
        self.init_step_size = float(init_step_size)
        self.chain_sharding = chain_sharding
        self.device = default_device(device, model_args)
        if betas is not None:
            b = np.asarray(torch.as_tensor(betas, dtype=torch.float32).cpu())
            # samples come from rung 0: the ladder must not increase from
            # the cold rung beta = 1 (a flat all-1 ladder is legal)
            if abs(float(b[0]) - 1.0) > 1e-6 or np.any(np.diff(b) > 0):
                raise ValueError(
                    "betas must descend from 1.0 (cold rung first), e.g. "
                    "concatenate([geometric_ladder(K-1), zeros(1)]); got "
                    f"{b.tolist()}")
            self.betas = torch.as_tensor(b, device=self.device)
        else:
            self.betas = geometric_ladder(num_replicas, beta_min,
                                          self.device)
        self.K = int(self.betas.shape[0])
        self.chains = local_chains(self.num_chains, chain_sharding,
                                   self.device)

        fm = flat_model(model, model_args, model_kwargs, self.device)
        self.info, self.dim = fm.info, fm.dim
        dim = fm.dim
        self._ravel, self._constrain = fm.ravel, fm.constrain
        parts, unravel_fn = fm.logdensity.parts, fm.unravel
        parts_flat = torch.func.vmap(lambda q: parts(unravel_fn(q)))

        def neg_tempered(q, beta):
            lp, ll = parts(unravel_fn(q))
            return -(lp + beta * ll)

        vg = torch.func.vmap(torch.func.grad_and_value(neg_tempered))

        def parts_q(q):
            lp, ll = parts_flat(q.reshape(-1, dim))
            return lp.reshape(q.shape[:-1]), ll.reshape(q.shape[:-1])

        def pe_grad(q, beta):
            c = q.shape[0]
            g, pe = vg(q.reshape(-1, dim), beta.expand(c, -1).reshape(-1))
            return pe.reshape(q.shape[:-1]), g.reshape(q.shape)

        self._parts = parts_q
        self._pe_grad = pe_grad

    def _pooled(self, x):
        if self.chain_sharding is None:
            return x
        return all_gather(x, *self.chain_sharding)

    # ------------------------------------------------------------------
    def _draws(self, key):
        """One step's momenta (C, K, D), accept uniforms (C, K) and swap
        uniforms (C, K // 2 + 1)."""
        c, k, d, dev = self.chains, self.K, self.dim, self.device
        return (normals(key, c, k * d, PT_MOMENTUM, dev).reshape(-1, k, d),
                uniforms(key, c, k, PT_ACCEPT, dev),
                uniforms(key, c, k // 2 + 1, PT_SWAP, dev))

    def _step(self, key, state, eps_k, inv_mass, parity):
        mom, u_acc, u_swap = self._draws(key)
        q1, acc = hmc_core(self._pe_grad, state.q, self.betas, eps_k,
                           inv_mass, mom, u_acc, self.num_leapfrog)
        lp, ll = self._parts(q1)
        return swap_core(_PTState(q1, lp, ll), self.betas, parity, u_swap) \
            + (acc,)

    def _init_state(self, seed):
        u = init_uniforms(StreamKey(seed, INIT, 0), self.chains,
                          self.K * self.dim, self.device)
        q = self._ravel(init_to_uniform(
            self.info, uniforms=u.reshape(-1, self.K, self.dim)))
        lp, ll = self._parts(q)
        return _PTState(q, lp, ll)

    def run(self, seed) -> PTResult:
        """Warmup (per-rung step size and mass adaptation, with swaps),
        then sampling, from the integer ``seed``."""
        in_slow, window_end = build_schedule(self.num_warmup)
        state = self._init_state(seed)
        k, dev = self.K, self.device
        da = da_init(torch.full((k,), self.init_step_size, device=dev))
        wf = welford_init(self.dim, batch=(k,), device=dev)
        inv_mass = torch.ones((k, self.dim), device=dev)
        for t in range(self.num_warmup):
            eps_k = torch.exp(da.log_step)
            state, _, acc = self._step(StreamKey(seed, WARMUP, t), state,
                                       eps_k, inv_mass, t % 2)
            da = da_update(da, torch.mean(self._pooled(acc), 0),
                           target=self.target_accept)
            if in_slow[t]:
                wf = _welford_rungs(wf, self._pooled(state.q))
            if window_end[t]:
                inv_mass = welford_finalize(wf)
                wf = welford_init(self.dim, batch=(k,), device=dev)
                da = da_init(torch.exp(da.log_step))
        eps_k = torch.exp(da.log_step_avg)
        qs, accs, swaps, lls = [], [], [], []
        for t in range(self.num_samples):
            state, pair_acc, acc = self._step(StreamKey(seed, SAMPLE, t),
                                              state, eps_k, inv_mass, t % 2)
            qs.append(state.q[:, 0, :])
            accs.append(torch.mean(self._pooled(acc), 0))
            swaps.append(torch.mean(self._pooled(pair_acc), 0))
            lls.append(state.ll)
        qs = torch.stack(qs, 1)                 # (chains, samples, dim)
        lls = self._pooled(torch.stack(lls, 1)).transpose(0, 1)
        samples = constrained_draws(self._constrain, qs)
        # each pair is proposed every other step: rate = 2 * mean
        swap_rate = 2.0 * torch.mean(torch.stack(swaps), 0)[:k - 1]
        extra = {
            "accept_prob": torch.mean(torch.stack(accs), 0),
            "swap_accept": swap_rate,
            "step_size": eps_k,
            "betas": self.betas,
            "log_evidence_ti": _ti_evidence(self.betas, lls),
            "log_evidence_ss": _stepping_stone(self.betas, lls),
        }
        return PTResult(samples, extra, qs, self.chains)


def _welford_rungs(wf, q):
    """Each rung's Welford state updated with its column of the chains'
    states ``q`` (C, K, D): the JAX package's ``vmap(welford_update_batch,
    in_axes=(0, 1))``."""
    rungs = [welford_update_batch(type(wf)(*(x[i] for x in wf)), q[:, i])
             for i in range(q.shape[1])]
    return type(wf)(*(torch.stack(xs) for xs in zip(*rungs)))
