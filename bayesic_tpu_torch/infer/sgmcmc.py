"""Stochastic-gradient MCMC: SGLD, pSGLD and SGHMC.

Counterpart of ``bayesic_tpu/infer/sgmcmc.py``: the mini-batch sampler for
models too large for full-batch NUTS.  The gradient of the log-joint is
estimated on a subsampled plate (``svi.elbo.draw_subsample`` and the
plate's N/B scale, as in the ELBO), and the chain injects calibrated
Gaussian noise instead of a Metropolis correction:

  SGLD   (Welling & Teh 2011):   q += (e/2) grad + N(0, e)
  pSGLD  (Li et al. 2016):       RMSProp-preconditioned SGLD
  SGHMC  (Chen et al. 2014):     v = (1-a) v + e grad + N(0, 2a e);  q += v

All chains move in lockstep over a leading chain axis; each step's
gradients are one batched call of ``torch.func.vmap`` over the chains, each
chain on its own mini-batch.  Every draw is an input of :func:`sg_update`
(the noise) and of ``draw_subsample`` (the uniforms that make the
mini-batch), drawn from the streams keyed by ``(seed, phase, t, chain)``
(``infer/mcmc/streams.py``); ``chain_sharding`` therefore runs a rank's
share of the chains by their global indices with no collective.  Without a
Metropolis correction the stationary law is exact only as the step goes to
0: ``step_decay`` gives the polynomial schedule.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..core.logjoint import default_device, init_to_uniform
from ..parallel.mesh import local_chains
from .mcmc.mcmc import constrained_draws, flat_model
from .mcmc.streams import (INIT, SAMPLE, SG_NOISE, StreamKey, init_uniforms,
                           normals, subsample_uniforms)
from .svi.elbo import draw_subsample

__all__ = ["SGMCMC", "SGMCMCResult", "sg_update"]


class SGMCMCResult(NamedTuple):
    samples: dict                # site -> (chains, kept, *event)
    unconstrained: torch.Tensor  # (chains, kept, dim)
    extra: dict                  # grad_norm trace, step sizes
    chains: Any = None           # (chains,) global indices of the rows


def sg_update(method, q, aux, g, noise, eps, friction=0.1,
              rmsprop_decay=0.99, rmsprop_eps=1e-5):
    """One update of every chain: ``q``, ``aux`` (momentum for sghmc, the
    RMS accumulator for psgld), ``g`` (the log-density's gradient) and
    ``noise`` (standard normals) are (C, D); ``eps`` the step.  Returns
    ``(q', aux', grad_norm (C,))``."""
    gn = torch.sqrt(torch.sum(g * g, -1))
    if method == "sgld":
        return q + 0.5 * eps * g + torch.sqrt(eps) * noise, aux, gn
    if method == "psgld":
        vsq = rmsprop_decay * aux + (1 - rmsprop_decay) * g * g
        prec = 1.0 / (torch.sqrt(vsq) + rmsprop_eps)
        return (q + 0.5 * eps * prec * g + torch.sqrt(eps * prec) * noise,
                vsq, gn)
    # sghmc: v in the per-step displacement parameterization
    a = friction
    v = (1.0 - a) * aux + eps * g + torch.sqrt(2.0 * a * eps) * noise
    return q + v, v, gn


class SGMCMC:
    """``SGMCMC(model, method="sgld" | "psgld" | "sghmc", ...)``.

    ``step_size`` is the step; with ``step_decay=(a, b, gamma)`` the step at
    t is ``a / (b + t)**gamma`` in float32 (Welling & Teh's schedule;
    ``step_size`` ignored).  ``device`` as in ``MCMC``; ``chain_sharding``
    (a ``parallel.mesh.Sharding`` or ``(mesh, axis)``) splits the chains
    over a mesh axis."""

    def __init__(self, model=None, *, method="sgld", num_samples=1000,
                 num_burnin=500, num_chains=4, thin=1, step_size=1e-3,
                 step_decay: Optional[tuple] = None, friction=0.1,
                 rmsprop_decay=0.99, rmsprop_eps=1e-5,
                 model_args=(), model_kwargs=None, chain_sharding=None,
                 device=None):
        if method not in ("sgld", "psgld", "sghmc"):
            raise ValueError(f"unknown method {method!r}")
        self.method = method
        self.num_samples = int(num_samples)
        self.num_burnin = int(num_burnin)
        self.num_chains = int(num_chains)
        self.thin = int(thin)
        self.step_size = float(step_size)
        self.step_decay = step_decay
        self.friction = float(friction)
        self.rmsprop_decay = float(rmsprop_decay)
        self.rmsprop_eps = float(rmsprop_eps)
        self.chain_sharding = chain_sharding
        self.device = default_device(device, model_args)
        self.chains = local_chains(self.num_chains, chain_sharding,
                                   self.device)

        fm = flat_model(model, model_args, model_kwargs, self.device)
        self.info, self.dim = fm.info, fm.dim
        self._ravel, self._constrain = fm.ravel, fm.constrain
        logdensity, unravel_fn = fm.logdensity, fm.unravel
        full = torch.func.vmap(torch.func.grad(
            lambda q: logdensity(unravel_fn(q))))
        sub = torch.func.vmap(torch.func.grad(
            lambda q, s: logdensity(unravel_fn(q), subsample=s)))
        self._grad_full, self._grad_sub = full, sub

    def _step_at(self, t):
        if self.step_decay is None:
            return torch.tensor(self.step_size, device=self.device)
        a, b, gamma = self.step_decay
        tf = torch.tensor(float(t), dtype=torch.float32, device=self.device)
        # a true float32 division: torch's ``number / tensor`` multiplies
        # by the reciprocal, one rounding more than the JAX package's
        return torch.div(torch.tensor(a, dtype=torch.float32,
                                      device=self.device), (b + tf) ** gamma)

    def grad_logp(self, q, subsample=None):
        """The log-density's gradient at every chain's ``q`` (C, D), each
        chain on its own mini-batch ``subsample`` (dict plate -> (C, B)
        indices; None for a model without a subsampled plate)."""
        if subsample is None:
            return self._grad_full(q)
        return self._grad_sub(q, subsample)

    def _one(self, seed, q, aux, t):
        key = StreamKey(seed, SAMPLE, t)
        sub = None
        if self.info.has_subsample:
            sub = draw_subsample(self.info, None, uniforms=subsample_uniforms(
                self.info, key, self.chains, self.device))
        g = self.grad_logp(q, sub)
        noise = normals(key, self.chains, self.dim, SG_NOISE, self.device)
        return sg_update(self.method, q, aux, g, noise, self._step_at(t),
                         self.friction, self.rmsprop_decay, self.rmsprop_eps)

    def run(self, seed) -> SGMCMCResult:
        """``num_burnin`` steps, then ``num_samples`` kept draws, one every
        ``thin`` steps, from the integer ``seed``."""
        u = init_uniforms(StreamKey(seed, INIT, 0), self.chains, self.dim,
                          self.device)
        q = self._ravel(init_to_uniform(self.info, uniforms=u))
        aux = torch.ones_like(q) if self.method == "psgld" \
            else torch.zeros_like(q)
        for t in range(self.num_burnin):
            q, aux, _ = self._one(seed, q, aux, t)
        qs, gns = [], []
        for i in range(self.num_samples):
            for j in range(self.thin):
                q, aux, gn = self._one(seed, q, aux,
                                       self.num_burnin + i * self.thin + j)
            qs.append(q)
            gns.append(gn)
        qs = torch.stack(qs, 1)                 # (chains, kept, dim)
        samples = constrained_draws(self._constrain, qs)
        total = self.num_burnin + self.num_samples * self.thin
        extra = {"grad_norm": torch.stack(gns, 1),
                 "final_step_size": self._step_at(total),
                 "method": self.method}
        return SGMCMCResult(samples, qs, extra, self.chains)
