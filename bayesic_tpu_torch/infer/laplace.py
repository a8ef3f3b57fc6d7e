"""MAP estimation and the Laplace (quadratic) posterior approximation.

Counterpart of ``bayesic_tpu/infer/laplace.py``: optimize the
unconstrained log-joint (MAP), then fit a Gaussian at the mode.  The
unconstrained density carries the change-of-variable Jacobians, so the
evidence estimate and the covariance are computed in the right space, and
are exact on linear-Gaussian models.  The optimization is a Python loop of
the port's ``Adam`` (``optax.adam``'s arithmetic) over autograd's gradient
of the flat potential; the Hessian is one ``torch.func.hessian`` call
(dense (d, d), for the d of up to ~10^3 this is meant for).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..core.logjoint import (Potential, build_logjoint, default_device,
                             init_to_prior)
from .svi.svi import Adam

__all__ = ["MAPResult", "map_estimate", "Laplace"]


class MAPResult(NamedTuple):
    uparams: Any           # unconstrained MAP point (site dict)
    params: Any            # constrained MAP point (site dict)
    log_joint: torch.Tensor  # log-density at the mode (unconstrained)
    losses: torch.Tensor   # per-step negative log-joint trace


def _setup(model, model_args, model_kwargs, key, init, device):
    model_kwargs = model_kwargs or {}
    gen = torch.Generator(device=device).manual_seed(0)
    info, logdensity, constrain, _ = build_logjoint(
        model, *model_args, rng_key=gen, **model_kwargs)
    if init is None:
        init = init_to_prior(model, info, *model_args,
                             rng_key=key if key is not None else gen,
                             **model_kwargs)
    return info, Potential(logdensity, init), constrain


def map_estimate(model, model_args=(), model_kwargs=None, optimizer=None,
                 num_steps=1000, key=None, init=None,
                 device=None) -> MAPResult:
    """Maximum-a-posteriori point in unconstrained space by ``num_steps``
    steps of ``optimizer`` (``Adam(0.05)`` by default).  ``init`` (site
    dict, unconstrained) defaults to a prior draw from the
    ``torch.Generator`` ``key`` (seeded 0 on ``device`` if None);
    ``device`` as in ``MCMC``."""
    device = default_device(device, model_args,
                            list((init or {}).values()))
    optimizer = Adam(0.05) if optimizer is None else optimizer
    info, pot, constrain = _setup(model, model_args, model_kwargs, key, init,
                                  device)
    q = pot.example_flat.detach()
    opt_state = optimizer.init(q)
    vg = torch.func.grad_and_value(pot)
    losses = []
    for _ in range(int(num_steps)):
        g, loss = vg(q)
        q, opt_state = optimizer.update(g, opt_state, q)
        losses.append(loss)
    losses = torch.stack(losses) if losses else torch.zeros(0)
    uparams = pot.unravel(q)
    return MAPResult(uparams=uparams, params=constrain(uparams),
                     log_joint=-pot(q), losses=losses)


class Laplace:
    """Laplace approximation: N(q_map, H^{-1}) in unconstrained space, H
    the Hessian of the negative log-joint at the mode.

    ``fit`` returns self with ``log_evidence`` (log p(q*) + (d/2) log 2 pi
    - (1/2) log det H, exact on linear-Gaussian models), ``mean`` / ``cov``
    (unconstrained moments, flat vector view) and
    ``sample_posterior(key, n)`` (constrained draws)."""

    def __init__(self, model, model_args=(), model_kwargs=None,
                 device=None):
        self.model = model
        self._args = model_args
        self._kwargs = model_kwargs or {}
        self.device = default_device(device, model_args)
        self._fitted = False

    def fit(self, key=None, optimizer=None, num_steps=1000, init=None):
        res = map_estimate(self.model, self._args, self._kwargs,
                           optimizer=optimizer, num_steps=num_steps,
                           key=key, init=init, device=self.device)
        _, pot, constrain = _setup(self.model, self._args, self._kwargs,
                                   key, res.uparams, self.device)
        self._pot, self._constrain = pot, constrain
        q = pot.example_flat.detach()
        h = torch.func.hessian(pot)(q)
        # guard the autodiff's tiny asymmetry
        h = 0.5 * (h + h.T)
        chol_h, _ = torch.linalg.cholesky_ex(h)
        d = q.shape[0]
        half_logdet_h = torch.sum(torch.log(torch.diagonal(chol_h)))
        self.map_result = res
        self.mean = q
        self._chol_h = chol_h
        self.log_evidence = float(res.log_joint + 0.5 * d
                                  * math.log(2.0 * math.pi) - half_logdet_h)
        self._fitted = True
        return self

    @property
    def cov(self):
        """Unconstrained posterior covariance H^{-1} (dense)."""
        eye = torch.eye(self.mean.shape[0], dtype=self.mean.dtype,
                        device=self.mean.device)
        inv_l = torch.linalg.solve_triangular(self._chol_h, eye, upper=False)
        return inv_l.T @ inv_l

    def sample_unconstrained(self, key, num_samples=1000, normals=None):
        """(num_samples, d) draws; ``normals`` (num_samples, d) standard
        normals in place of draws from the ``torch.Generator`` ``key``."""
        z = normals if normals is not None else torch.randn(
            (num_samples, self.mean.shape[0]), generator=key,
            device=key.device, dtype=self.mean.dtype)
        # cov = L^{-T} L^{-1}  =>  draws = mean + L^{-T} z
        dq = torch.linalg.solve_triangular(self._chol_h.T, z.T,
                                           upper=True).T
        return self.mean[None, :] + dq

    def sample_posterior(self, key, num_samples=1000, normals=None):
        """Constrained-space posterior draws (dict of sites, leading sample
        dimension), as ``SVI.sample_posterior`` gives them."""
        if not self._fitted:
            raise RuntimeError("call fit() first")
        qs = self.sample_unconstrained(key, num_samples, normals)
        return self._constrain(self._pot.unravel(qs))
