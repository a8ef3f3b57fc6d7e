"""Adaptive tempered SMC with systematic resampling and HMC mutation.

Counterpart of ``bayesic_tpu/infer/smc/smc.py``.  Each stage:

1. picks the next temperature by a fixed 26-step bisection so that the
   *conditional* ESS (Zhou, Johansen & Aston 2016: the incremental weights'
   degradation against the carried weights) is ``ess_target * N``;
2. adds the evidence increment log sum_i W_i lik_i^dbeta and reweights;
3. computes systematic resampling every stage and selects it where the
   ESS falls below ``resample_threshold * N``;
4. mutates with K HMC transitions targeting prior * lik^beta, the step size
   adapted across them by dual averaging (or the legacy ``"nudge"``).

Particles are a flat (N, dim) tensor in unconstrained space.  The stages
run as a plain Python loop with one host read of beta per stage: the JAX
package's chunked ``lax.scan`` over stages exists for its remote-TPU relay
and is not ported.

Randomness: each stage draws, in this order and from the run's generator,
the resampling uniform u0, the momenta (K, N, dim) as standard normals and
the MH log-uniforms (N, K) from 23-bit uniforms (strictly inside (0, 1)).
Every mutation path (the generic engine, the hand-fused likelihood hooks
and a whole-stage ``batched_mutation``) consumes the same draws, so one
seed gives common random numbers across the paths.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...core.logjoint import build_logjoint, default_device, init_population
from ...parallel.resample import (effective_sample_size,
                                  normalize_log_weights,
                                  systematic_ancestors)
from ..mcmc.adapt import DualAveragingState, da_update
from ..svi.guides import unraveler

__all__ = ["SMC", "SMCResult", "stage_draws"]


class SMCResult(NamedTuple):
    particles: dict              # constrained, (N, *event)
    log_weights: torch.Tensor    # final normalized log weights (N,)
    log_evidence: torch.Tensor   # marginal-likelihood estimate
    num_stages: int
    accept_rate: torch.Tensor    # final-stage mean accept probability
    unconstrained: torch.Tensor  # (N, dim)


class StageDraws(NamedTuple):
    u0: torch.Tensor      # () resampling offset in [0, 1)
    mom: torch.Tensor     # (K, N, dim) standard normals
    log_u: torch.Tensor   # (N, K) strictly negative


def stage_draws(generator, n, dim, k):
    """One stage's randomness, drawn in the fixed order u0, momenta,
    log-uniforms on the generator's device."""
    dev = generator.device
    u0 = torch.rand((), generator=generator, device=dev)
    mom = torch.randn((k, n, dim), generator=generator, device=dev)
    bits = torch.randint(0, 1 << 23, (n, k), generator=generator,
                         device=dev)
    log_u = torch.log((bits.to(torch.float32) + 0.5) * (1.0 / (1 << 23)))
    return StageDraws(u0, mom, log_u)


class SMC:
    """See the module docstring.  ``device`` is where the particles live;
    None means the device of the first tensor among ``model_args``, else
    ``"cuda"``.  Hooks, each on flat (N, dim) particles:

    * ``batched_loglik(qs) -> (N,)``: the likelihood (differentiated by
      autograd when no gradient hook is given);
    * ``batched_loglik_grad(qs) -> ((N,), (N, dim))``: its value and
      gradient in one call;
    * ``batched_mutation(q, beta, step_size, m_inv, mom, log_u) -> (q',
      ll', accept, next_step)``: a whole stage's mutation, returning the
      final particles' log-likelihood for the next stage's reweight.

    After ``run``, :meth:`equal_weight_samples` gives plain posterior
    draws."""

    @staticmethod
    def equal_weight_samples(result: SMCResult, u0, num_samples=None):
        """Resample the final weighted population to equally weighted draws
        (systematic; ``u0`` a uniform or a ``torch.Generator``)."""
        idx = systematic_ancestors(u0, result.log_weights, num_samples)
        return {k: v[idx.to(v.device)] for k, v in result.particles.items()}

    def __init__(self, model, num_particles=1024, ess_target=0.5,
                 resample_threshold=0.5, mutation_steps=5,
                 hmc_leapfrog_steps=5, max_stages=100, init_step_size=0.2,
                 target_accept=0.65, model_args=(), model_kwargs=None,
                 batched_loglik=None, batched_loglik_grad=None,
                 batched_mutation=None, precondition=False, step_adapt="da",
                 device=None):
        self.model = model
        self.n = int(num_particles)
        self.ess_target = float(ess_target)
        self.resample_threshold = float(resample_threshold)
        self.mutation_steps = int(mutation_steps)
        self.leapfrog_steps = int(hmc_leapfrog_steps)
        self.max_stages = int(max_stages)
        self.init_step_size = float(init_step_size)
        self.target_accept = float(target_accept)
        # diagonal mass from the weighted particle variance; off by default
        # (on multimodal targets the cross-mode variance inflates it)
        self.precondition = bool(precondition)
        # "da": a fresh dual-averaging run across each stage's K
        # transitions, shrinking toward the carried step, its average
        # carried on; "nudge": step * exp(0.5 (accept - target)) once per
        # stage
        if step_adapt not in ("da", "nudge"):
            raise ValueError(f"step_adapt must be 'da' or 'nudge', got "
                             f"{step_adapt!r}")
        self.step_adapt = step_adapt
        self._model_args = tuple(model_args)
        self._model_kwargs = model_kwargs or {}
        self.device = default_device(device, self._model_args)

        self.info, logdensity, constrain, _ = build_logjoint(
            model, *self._model_args,
            rng_key=torch.Generator(device=self.device).manual_seed(0),
            **self._model_kwargs)
        self.dim, self._unravel, self._ravel = unraveler(self.info)
        self._constrain = constrain
        parts, prior = logdensity.parts, logdensity.prior
        unravel = self._unravel
        self._parts_batched = torch.func.vmap(lambda q: parts(unravel(q)))
        self._logprior = torch.func.vmap(lambda q: prior(unravel(q)))
        self._logprior_vg = torch.func.vmap(
            torch.func.grad_and_value(lambda q: prior(unravel(q))))

        def neg_tempered(q, beta):
            lp, ll = parts(unravel(q))
            return -(lp + beta * ll)

        self._tempered_vg = torch.func.vmap(
            torch.func.grad_and_value(neg_tempered), in_dims=(0, None))
        self._loglik_hook = batched_loglik
        self._loglik_vg = batched_loglik_grad
        self._batched_mutation = batched_mutation

    # ------------------------------------------------------------------
    def _loglik(self, qs):
        if self._loglik_hook is not None:
            return self._loglik_hook(qs)
        return self._parts_batched(qs)[1]

    def _init_particles(self, generator):
        u = init_population(self.model, self.info, self.n, *self._model_args,
                            rng_key=generator, **self._model_kwargs)
        return self._ravel(u).to(torch.float32)

    def _next_beta(self, beta, loglik, log_w):
        """Bisection: the largest dbeta that keeps the conditional ESS,
        N (sum W v)^2 / sum W v^2 with v = lik^dbeta, at ess_target N."""
        target = self.ess_target * self.n
        logw_n = normalize_log_weights(log_w)
        log_n = math.log(float(self.n))

        def ess_at(delta):
            num = 2.0 * torch.logsumexp(logw_n + delta * loglik, 0)
            den = torch.logsumexp(logw_n + 2.0 * delta * loglik, 0)
            return torch.exp(log_n + num - den)

        lo, hi = torch.zeros_like(beta), 1.0 - beta
        hi0 = hi
        full_ok = ess_at(hi0) >= target       # even beta = 1 keeps the ESS
        for _ in range(26):
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        delta = torch.where(full_ok, hi0, lo)
        return torch.clamp(beta + delta, max=1.0)

    def _pe_and_grad(self, qs, beta):
        """Potential -(log prior + beta ll) and its gradient, (N,), (N,
        dim), through the hooks when given."""
        if self._loglik_vg is not None:
            glp, lp = self._logprior_vg(qs)
            ll, gll = self._loglik_vg(qs)
            return -(lp + beta * ll), -(glp + beta * gll)
        if self._loglik_hook is not None:
            x = qs.detach().requires_grad_()
            with torch.enable_grad():
                pe = -(self._logprior(x) + beta * self._loglik_hook(x))
                (g,) = torch.autograd.grad(pe.sum(), x)
            return pe.detach(), g
        g, pe = self._tempered_vg(qs, beta)
        return pe, g

    def _mutate(self, q, beta, step_size, m_inv, mom, log_u):
        """K HMC transitions of every particle on the stage's draws.
        Returns (q', mean accept, next-stage step size)."""
        if m_inv is None:
            m_inv = torch.ones(self.dim, dtype=q.dtype, device=q.device)
        sqrt_m = 1.0 / torch.sqrt(m_inv)
        pe, g = self._pe_and_grad(q, beta)
        log_eps0 = torch.log(step_size)
        zero = torch.zeros_like(log_eps0)
        # mu = log(carried step): track where the last stage settled
        da = DualAveragingState(log_eps0, log_eps0, zero, zero, log_eps0)
        acc_sum = torch.zeros_like(log_eps0)
        for t in range(self.mutation_steps):
            eps = torch.exp(da.log_step)
            p0 = mom[t] * sqrt_m
            h0 = pe + 0.5 * torch.sum(p0 * p0 * m_inv, -1)
            qq, pp, gg = q, p0, g
            for _ in range(self.leapfrog_steps):
                pp = pp - 0.5 * eps * gg
                qq = qq + eps * m_inv * pp
                pe1, gg = self._pe_and_grad(qq, beta)
                pp = pp - 0.5 * eps * gg
            delta = pe1 + 0.5 * torch.sum(pp * pp * m_inv, -1) - h0
            delta = torch.where(torch.isnan(delta), math.inf, delta)
            log_a = torch.clamp(-delta, max=0.0)
            a = torch.exp(log_a)
            take = log_u[:, t] < log_a
            q = torch.where(take[:, None], qq, q)
            g = torch.where(take[:, None], gg, g)
            pe = torch.where(take, pe1, pe)
            if self.step_adapt == "da":
                da = da_update(da, a.mean(), target=self.target_accept,
                               t0=2.0)
            acc_sum = acc_sum + a.mean()
        accept = acc_sum / self.mutation_steps
        if self.step_adapt == "da":
            next_step = torch.exp(da.log_step_avg)
        else:
            next_step = step_size * torch.exp(
                0.5 * (accept - self.target_accept))
        return q, accept, torch.clamp(next_step, 1e-5, 2.0)

    def stage(self, q, log_w, beta, ll, step_size, draws: StageDraws):
        """One tempering stage.  ``ll`` is loglik(q) when a
        ``batched_mutation`` keeps it current, else None (evaluated here).
        Returns (q, log_w, beta', log evidence increment, step size, accept,
        ll)."""
        if ll is None:
            ll = self._loglik(q)
        new_beta = self._next_beta(beta, ll, log_w)
        delta = new_beta - beta
        log_ev_inc = torch.logsumexp(normalize_log_weights(log_w)
                                     + delta * ll, 0)
        log_w = log_w + delta * ll
        # resampling computed every stage, selected where the ESS is low
        do_res = effective_sample_size(log_w) \
            < self.resample_threshold * self.n
        anc = systematic_ancestors(draws.u0, log_w)
        q = torch.where(do_res, q[anc], q)
        ll = torch.where(do_res, ll[anc], ll)
        log_w = torch.where(do_res, torch.zeros_like(log_w), log_w)
        m_inv = None
        if self.precondition:
            w_n = torch.exp(normalize_log_weights(log_w))
            mean = torch.sum(w_n[:, None] * q, 0)
            var = torch.sum(w_n[:, None] * (q - mean) ** 2, 0)
            m_inv = torch.clamp(var, 1e-8, 1e8)
        if self._batched_mutation is not None:
            q, ll, accept, step_size = self._batched_mutation(
                q, new_beta, step_size, m_inv, draws.mom, draws.log_u)
        else:
            q, accept, step_size = self._mutate(q, new_beta, step_size,
                                                m_inv, draws.mom,
                                                draws.log_u)
            ll = None
        return q, log_w, new_beta, log_ev_inc, step_size, accept, ll

    # ------------------------------------------------------------------
    def run(self, seed) -> SMCResult:
        """Run the tempering loop.  ``seed`` is an int or a
        ``torch.Generator`` on the particles' device; it gives the initial
        population and every stage's draws."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(int(seed))
        f32 = dict(dtype=torch.float32, device=self.device)
        q = self._init_particles(gen)
        ll = self._loglik(q) if self._batched_mutation is not None else None
        log_w = torch.zeros(self.n, **f32)
        beta = torch.zeros((), **f32)
        log_ev = torch.zeros((), **f32)
        step = torch.tensor(self.init_step_size, **f32)
        accept = torch.ones((), **f32)
        stage = 0
        while stage < self.max_stages:
            draws = stage_draws(gen, self.n, self.dim, self.mutation_steps)
            q, log_w, beta, inc, step, accept, ll = self.stage(
                q, log_w, beta, ll, step, draws)
            log_ev = log_ev + inc
            stage += 1
            if float(beta) >= 1.0:           # the stage's one host read
                break
        return SMCResult(self._constrain(self._unravel(q)),
                         normalize_log_weights(log_w), log_ev, stage,
                         accept, q)
