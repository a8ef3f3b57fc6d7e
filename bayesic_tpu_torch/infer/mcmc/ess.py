"""Elliptical slice sampling (Murray, Adams & MacKay 2010).

Counterpart of ``bayesic_tpu/infer/mcmc/ess.py``: the tuning-free sampler
for models whose unconstrained prior is standard normal (the whitened or
non-centred form; ``LocScaleReparam`` gives it) and whose likelihood may be
anything.  Proposals move on the ellipse through the current state and a
prior draw, and the slice shrinkage accepts exactly.

The reference algorithm's shrink loop is data-dependent; as in the JAX
package every chain runs a fixed ``_SHRINK_ITERS`` iterations with a done
mask, all chains in lockstep over a leading chain axis.  Every draw of a
transition is an input of :func:`ess_core`: the prior draw, the slice
level, the first angle and one uniform per shrink iteration, drawn up
front from the streams keyed by ``(seed, phase, t, chain)``
(``streams.py``).  So the loop stops as soon as every chain has accepted
without changing any result; each iteration costs one host read of the
done mask.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ...core.logjoint import default_device, init_to_uniform
from ...parallel.mesh import local_chains
from .mcmc import constrained_draws, flat_model
from .streams import (ESS_ANGLE, ESS_NU, ESS_SHRINK, ESS_SLICE, INIT, SAMPLE,
                      StreamKey, init_uniforms, normals, uniforms)

__all__ = ["EllipticalSlice", "ESSResult", "ess_core"]

_SHRINK_ITERS = 30
_TWO_PI = 2.0 * math.pi


class ESSResult(NamedTuple):
    samples: dict                # site -> (chains, num_samples, *event)
    unconstrained: torch.Tensor  # (chains, num_samples, dim)
    extra: dict                  # shrink-iteration counts
    chains: Any = None           # (chains,) global indices of the rows


def ess_core(loglik, q, ll, nu, log_u, theta_u, shrink_u):
    """One elliptical-slice update of every chain.

    ``q``, ``nu`` (C, D): the states and the prior draws; ``ll`` (C,) the
    states' log-likelihoods; ``log_u`` (C,) the log of the slice uniform;
    ``theta_u`` (C,) the uniform of the first angle, ``shrink_u`` (C,
    _SHRINK_ITERS) one uniform per shrink iteration, each in [0, 1) (the
    JAX package's ``uniform(key, (), lo, hi)`` is ``max(lo, lo + u (hi -
    lo))``).  ``loglik`` maps (C, D) -> (C,).  Returns ``(q', ll',
    iters)``, iters the misses before the accept (int32).  The loop stops
    once every chain has accepted."""
    log_y = ll + log_u
    theta = torch.clamp(theta_u * _TWO_PI, min=0.0)
    lo, hi = theta - _TWO_PI, theta
    q_cur, ll_cur = q, ll
    done = torch.zeros_like(ll, dtype=torch.bool)
    iters = torch.zeros_like(ll, dtype=torch.int32)
    for i in range(shrink_u.shape[1]):
        prop = q * torch.cos(theta)[:, None] + nu * torch.sin(theta)[:, None]
        ll_prop = loglik(prop)
        accept = (ll_prop > log_y) & ~done
        q_cur = torch.where(accept[:, None], prop, q_cur)
        ll_cur = torch.where(accept, ll_prop, ll_cur)
        done = done | accept
        # shrink the bracket toward 0 on a miss
        lo = torch.where(~done & (theta < 0), theta, lo)
        hi = torch.where(~done & (theta >= 0), theta, hi)
        theta_new = torch.maximum(lo, shrink_u[:, i] * (hi - lo) + lo)
        theta = torch.where(done, theta, theta_new)
        iters = iters + (~done).to(torch.int32)
        # a chain that is done never changes again, and the later
        # iterations' uniforms are its own: stopping changes nothing
        if bool(done.all()):
            break
    return q_cur, ll_cur, iters


class EllipticalSlice:
    """``EllipticalSlice(model, num_samples=1000, num_chains=8)``.

    Every latent site's unconstrained prior must be (iid) standard normal;
    checked at build time by probing ``logdensity.parts`` against the
    analytic N(0, I) log-density at three points.  ``device`` as in
    ``MCMC``; ``chain_sharding`` (a ``parallel.mesh.Sharding`` or ``(mesh,
    axis)``) splits the chains over a mesh axis: this rank runs its share
    by their global indices (``ESSResult.chains``), with no collective,
    and its draws are the unsharded run's rows bit for bit."""

    def __init__(self, model=None, *, num_samples=1000, num_burnin=200,
                 num_chains=8, model_args=(), model_kwargs=None,
                 chain_sharding=None, device=None, _check_prior=True):
        self.num_samples = int(num_samples)
        self.num_burnin = int(num_burnin)
        self.num_chains = int(num_chains)
        self.chain_sharding = chain_sharding
        self.device = default_device(device, model_args)
        self.chains = local_chains(self.num_chains, chain_sharding,
                                   self.device)

        fm = flat_model(model, model_args, model_kwargs, self.device)
        self.info, self.dim = fm.info, fm.dim
        self._ravel, self._constrain = fm.ravel, fm.constrain
        logdensity, unravel_fn = fm.logdensity, fm.unravel
        parts = logdensity.parts
        self._loglik = torch.func.vmap(lambda q: parts(unravel_fn(q))[1])

        if _check_prior:
            gen = torch.Generator().manual_seed(0)
            for _ in range(3):
                q = torch.randn(self.dim, generator=gen).to(self.device)
                got = float(logdensity.prior(unravel_fn(q)))
                want = float(torch.sum(-0.5 * q * q
                                       - 0.5 * math.log(2 * math.pi)))
                if abs(got - want) > 1e-3 * max(1.0, abs(want)):
                    raise ValueError(
                        "EllipticalSlice requires a standard-normal "
                        "unconstrained prior on every site (whitened / "
                        "non-centered form; see LocScaleReparam). "
                        f"log-prior at a probe point was {got:.4f}, "
                        f"expected {want:.4f}.")

    def _sweep(self, seed, q, ll, t):
        key = StreamKey(seed, SAMPLE, t)
        dev = self.device
        return ess_core(
            self._loglik, q, ll,
            normals(key, self.chains, self.dim, ESS_NU, dev),
            torch.log(uniforms(key, self.chains, 1, ESS_SLICE, dev)[:, 0]),
            uniforms(key, self.chains, 1, ESS_ANGLE, dev)[:, 0],
            uniforms(key, self.chains, _SHRINK_ITERS, ESS_SHRINK, dev))

    def run(self, seed) -> ESSResult:
        """``num_burnin`` then ``num_samples`` kept updates from the
        integer ``seed``."""
        u = init_uniforms(StreamKey(seed, INIT, 0), self.chains, self.dim,
                          self.device)
        q = self._ravel(init_to_uniform(self.info, uniforms=u))
        ll = self._loglik(q)
        for t in range(self.num_burnin):
            q, ll, _ = self._sweep(seed, q, ll, t)
        qs, iters = [], []
        for t in range(self.num_burnin, self.num_burnin + self.num_samples):
            q, ll, it = self._sweep(seed, q, ll, t)
            qs.append(q)
            iters.append(it)
        qs = torch.stack(qs, 1)                 # (chains, samples, dim)
        samples = constrained_draws(self._constrain, qs)
        return ESSResult(samples, qs,
                         {"shrink_iters": torch.stack(iters, 1)},
                         self.chains)
