"""NUTS within Gibbs for models with enumerable discrete latents.

Counterpart of ``bayesic_tpu/infer/mcmc/gibbs.py`` (NumPyro's
``DiscreteHMCGibbs``).  NUTS on an enumerated model marginalises the
discrete sites in every leapfrog step; this driver alternates instead:

  1. ``z ~ p(z | u, data)``: one exact joint conditional draw of every
     enumerated site by the log-joint's ``sample_enum`` (one enumeration a
     transition);
  2. one NUTS transition of the continuous sites on ``p(u, z, data)`` with
     z fixed (every leapfrog step a plain replay).

Both moves leave ``p(u, z | data)`` invariant.  Chains advance in lockstep
over a leading chain axis, with per-chain adaptation (a dual-averaging
step size and a diagonal Welford mass each) as in the JAX driver; the
conditional potential and ``sample_enum`` run under ``torch.func.vmap``
over the chains, each chain with its own z.  Every draw is an input: the
Gumbel noise of ``sample_enum`` and the NUTS streams come from the streams
keyed by ``(seed, phase, t, chain)`` (``streams.py``), so
``chain_sharding`` runs a rank's share of the chains by their global
indices with no collective.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ...core.logjoint import default_device, init_to_uniform
from ...parallel.mesh import local_chains
from .adapt import (build_schedule, da_init, da_update, welford_finalize,
                    welford_init, welford_update)
from .integrators import IntegratorState
from .mcmc import constrained_draws, flat_model
from .nuts import make_nuts_kernel
from .streams import (GUMBEL, INIT, SAMPLE, WARMUP, StreamKey, gumbels,
                      init_uniforms, nuts_streams)

__all__ = ["DiscreteGibbs", "GibbsResult"]


class GibbsResult(NamedTuple):
    samples: dict                # continuous (constrained) and discrete
    extra: dict                  # diverging, accept_prob, step_size, ...
    unconstrained: torch.Tensor  # (chains, samples, dim) continuous part
    chains: Any = None           # (chains,) global indices of the rows


class DiscreteGibbs:
    """NUTS within Gibbs over a model whose discrete latents are marked
    ``infer={"enumerate": True}`` (subsample-free models only: the
    conditionals under mini-batch scaling are not the true ones), where
    ``sample_enum``'s draw is exact: a model with a plate-local site
    eliminated before a lower-rank site it interacts with is refused
    (there the JAX package couples the plate's elements and targets
    another posterior).  ``device`` as in ``MCMC``; ``chain_sharding`` (a
    ``parallel.mesh.Sharding`` or ``(mesh, axis)``) splits the chains over
    a mesh axis."""

    def __init__(self, model, *, num_warmup=1000, num_samples=1000,
                 num_chains=4, max_depth=8, target_accept=0.8,
                 init_step_size=0.1, model_args=(), model_kwargs=None,
                 chain_sharding=None, device=None):
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.max_depth = int(max_depth)
        self.target_accept = float(target_accept)
        self.init_step_size = float(init_step_size)
        self.chain_sharding = chain_sharding
        self.device = default_device(device, model_args)
        self.chains = local_chains(self.num_chains, chain_sharding,
                                   self.device)

        fm = flat_model(model, model_args, model_kwargs, self.device)
        info, logdensity, unravel = fm.info, fm.logdensity, fm.unravel
        if not info.enum_sites:
            raise ValueError(
                "DiscreteGibbs needs enumerated discrete sites "
                "(infer={'enumerate': True}); for fully continuous models "
                "use MCMC.")
        if info.subsample_sites:
            raise ValueError(
                "DiscreteGibbs requires a subsample-free model (exact "
                "conditionals need full plates).")
        gen = torch.Generator(device=self.device).manual_seed(0)
        logdensity.require_exact_enum(init_to_uniform(info, gen),
                                      "DiscreteGibbs")
        self.info, self.dim = info, fm.dim
        self._unravel, self._ravel = unravel, fm.ravel
        self._constrain = fm.constrain
        given = logdensity.given_enum
        self._vg = torch.func.vmap(torch.func.grad_and_value(
            lambda q, z: -given(unravel(q), z)))
        self._sample_enum = torch.func.vmap(
            lambda q, g: logdensity.sample_enum(unravel(q), gumbels=g))

    def _pag(self, z):
        """The potential and gradient of every chain given its z."""
        def pag(q):
            g, pe = self._vg(q, z)
            return pe, g
        return pag

    def _gumbels(self, key):
        out = {}
        for e, n in enumerate(sorted(self.info.enum_sites)):
            shape = tuple(self.info.enum_shapes[n]) \
                + (self.info.enum_sites[n],)
            out[n] = gumbels(key, self.chains, math.prod(shape),
                             GUMBEL + e, self.device) \
                .reshape((-1,) + shape)
        return out

    def gibbs_step(self, state, eps, inv_mass, gumbel, streams):
        """One Gibbs sweep of every chain given its draws: ``z`` from its
        exact conditional with the Gumbel noise ``gumbel`` (dict site ->
        (C, *site shape, K)), then one NUTS transition of the continuous
        sites given z on the ``NUTSStreams`` ``streams``.  Returns
        ``(state, z, info)``."""
        z = self._sample_enum(state.q, gumbel)
        pag = self._pag(z)
        # z changed: the cached potential and gradient are stale
        pe, grad = pag(state.q)
        state = IntegratorState(state.q, state.p, pe, grad)
        state, info = make_nuts_kernel(pag, max_depth=self.max_depth)(
            streams, state, eps, inv_mass)
        return state, z, info

    def _sweep(self, seed, phase, t, state, eps, inv_mass):
        key = StreamKey(seed, phase, t)
        return self.gibbs_step(
            state, eps, inv_mass, self._gumbels(key),
            nuts_streams(key, self.chains, self.dim, self.max_depth,
                         self.device))

    def _initial_state(self, seed):
        # the potential and gradient are those of each step's fresh z, so
        # the initial state carries none
        u = init_uniforms(StreamKey(seed, INIT, 0), self.chains, self.dim,
                          self.device)
        q = self._ravel(init_to_uniform(self.info, uniforms=u))
        zero = torch.zeros_like(q)
        return IntegratorState(q, zero, zero[:, 0], zero)

    def run(self, seed) -> GibbsResult:
        """Warmup (per-chain adaptation) then sampling from the integer
        ``seed``."""
        in_slow, window_end = build_schedule(self.num_warmup)
        n, dev = self.chains.shape[0], self.device
        state = self._initial_state(seed)
        da = da_init(torch.full((n,), self.init_step_size, device=dev))
        wf = welford_init(self.dim, batch=(n,), device=dev)
        inv_mass = torch.ones((n, self.dim), device=dev)
        for t in range(self.num_warmup):
            state, _, info = self._sweep(seed, WARMUP, t, state,
                                         torch.exp(da.log_step), inv_mass)
            da = da_update(da, info.accept_prob, target=self.target_accept)
            if in_slow[t]:
                wf = welford_update(wf, state.q)
            if window_end[t]:
                inv_mass = welford_finalize(wf)
                wf = welford_init(self.dim, batch=(n,), device=dev)
                da = da_init(torch.exp(da.log_step))
        step_size = torch.exp(da.log_step_avg)
        qs, zs, divs, accs = [], [], [], []
        for t in range(self.num_samples):
            state, z, info = self._sweep(seed, SAMPLE, t, state, step_size,
                                         inv_mass)
            qs.append(state.q)
            zs.append(z)
            divs.append(info.diverging)
            accs.append(info.accept_prob)
        qs = torch.stack(qs, 1)                 # (chains, samples, dim)
        samples = constrained_draws(self._constrain, qs)
        for name in zs[0]:
            samples[name] = torch.stack([z[name] for z in zs], 1)
        extra = {"diverging": torch.stack(divs, 1),
                 "accept_prob": torch.stack(accs, 1),
                 "step_size": step_size, "inv_mass": inv_mass}
        return GibbsResult(samples, extra, qs, self.chains)
