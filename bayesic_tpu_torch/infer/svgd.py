"""Stein variational gradient descent (Liu & Wang 2016).

Counterpart of ``bayesic_tpu/infer/svgd.py``: N interacting particles
descend the KL to the posterior along

    phi(x_i) = (1/N) sum_j [ k(x_j, x_i) grad_j log p(x_j)
                             + grad_j k(x_j, x_i) ]

with an RBF kernel and the median-heuristic bandwidth.  The update is two
(N, N) x (N, D) products and an (N, N) distance matrix; the particles'
gradients are one batched ``torch.func.vmap`` call, each particle on its
own mini-batch when the model subsamples a plate (``draw_subsample`` on
the uniforms of the streams keyed by ``(seed, phase, t, particle)``,
``infer/mcmc/streams.py``).  The optimizer is the port's ``Adam``
(``optax.adam``'s arithmetic), a Python loop of steps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.logjoint import default_device, init_to_uniform
from .mcmc.mcmc import flat_model
from .mcmc.streams import (INIT, SAMPLE, StreamKey, init_uniforms,
                           subsample_uniforms)
from .svi.elbo import draw_subsample
from .svi.svi import Adam

__all__ = ["SVGD", "SVGDResult"]


class SVGDResult(NamedTuple):
    samples: dict                # site -> (num_particles, *event)
    unconstrained: torch.Tensor  # (num_particles, dim)
    extra: dict                  # phi_norm trace, final bandwidth


def _median(x):
    """The median of all of ``x``'s values as ``jnp.median`` takes it:
    the mean of the two middle values of an even count (``torch.median``
    returns the lower one)."""
    v, _ = torch.sort(x.reshape(-1))
    n = v.shape[0]
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def _rbf(x):
    """Kernel matrix, the repulsion sum_j grad_{x_j} k(x_j, x_i) and the
    bandwidth.  For k = exp(-||xi - xj||^2 / h): grad_j k(x_j, x_i) = 2/h
    (x_i - x_j) k, so the summed repulsion is (2/h) (x_i sum_j K_ij - (K
    x)_i)."""
    n = x.shape[0]
    sq = torch.sum(x * x, -1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)
    h = torch.clamp(_median(d2) / math.log(n + 1.0), min=1e-8)
    k = torch.exp(-d2 / h)
    rep = (2.0 / h) * (x * torch.sum(k, 1, keepdim=True) - k @ x)
    return k, rep, h


class SVGD:
    """``SVGD(model, num_particles=64, optimizer=Adam(1e-2))``; ``device``
    as in ``MCMC``."""

    def __init__(self, model=None, *, num_particles=64, optimizer=None,
                 num_steps=1000, model_args=(), model_kwargs=None,
                 device=None):
        self.num_particles = int(num_particles)
        self.num_steps = int(num_steps)
        self.optimizer = optimizer or Adam(1e-2)
        self.device = default_device(device, model_args)
        fm = flat_model(model, model_args, model_kwargs, self.device)
        self.info, self.dim = fm.info, fm.dim
        self._ravel, self._constrain = fm.ravel, fm.constrain
        logdensity, unravel_fn = fm.logdensity, fm.unravel
        self._grad_full = torch.func.vmap(torch.func.grad(
            lambda q: logdensity(unravel_fn(q))))
        self._grad_sub = torch.func.vmap(torch.func.grad(
            lambda q, s: logdensity(unravel_fn(q), subsample=s)))
        self._particles = torch.arange(self.num_particles, device=self.device)

    def step(self, x, opt_state, subsample=None):
        """One SVGD update of the particles ``x`` (N, D), each particle's
        gradient on its mini-batch ``subsample`` (dict plate -> (N, B)
        indices; None without a subsampled plate).  Returns ``(x',
        opt_state', phi_norm, bandwidth)``."""
        grads = self._grad_full(x) if subsample is None \
            else self._grad_sub(x, subsample)
        k, rep, h = _rbf(x)
        phi = (k @ grads + rep) / self.num_particles
        # Adam minimises: pass -phi to ascend the Stein direction
        x, opt_state = self.optimizer.update(-phi, opt_state, x)
        return x, opt_state, torch.sqrt(torch.mean(phi * phi)), h

    def run(self, seed) -> SVGDResult:
        """``num_steps`` updates from the integer ``seed``."""
        u = init_uniforms(StreamKey(seed, INIT, 0), self._particles,
                          self.dim, self.device)
        x = self._ravel(init_to_uniform(self.info, uniforms=u))
        opt = self.optimizer.init(x)
        phin, h = [], None
        for t in range(self.num_steps):
            sub = None
            if self.info.has_subsample:
                sub = draw_subsample(self.info, None, uniforms=(
                    subsample_uniforms(self.info, StreamKey(seed, SAMPLE, t),
                                       self._particles, self.device)))
            x, opt, pn, h = self.step(x, opt, sub)
            phin.append(pn)
        cons = self._constrain(x)
        return SVGDResult(cons, x, {"phi_norm": torch.stack(phin),
                                    "bandwidth": h})
