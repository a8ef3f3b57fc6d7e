"""Posterior and prior predictive sampling.

Counterpart of ``bayesic_tpu/infer/predictive.py``: posterior draws (from
an SVI guide, MCMC samples or SMC particles) are pushed back through the
generative model to sample its observed and deterministic sites.  The
JAX package maps one replay over the draws with ``vmap``; the handlers
here run eagerly, so the draws are replayed one after another.
"""

from __future__ import annotations

import torch

from ..core import handlers
from .svi.svi import tree_leaves

__all__ = ["Predictive"]


class Predictive:
    """Predictive sampler.

    ``posterior_samples`` is a dict of *constrained* latent values with a
    leading sample dimension (``MCMCResult.samples`` reshaped to ``(num,
    ...)``, or ``svi.sample_posterior(...)``).  Call it with a
    ``torch.Generator`` (on the model's device) to get samples of every
    site the draws do not fix: observed sites are resampled from their
    likelihood (``uncondition``), deterministic sites recorded, latents
    missing from the draws drawn from the prior.  Without posterior samples
    (``num_samples=``) it is the prior predictive.  ``return_sites``
    restricts the output to those sites."""

    def __init__(self, model, posterior_samples=None, num_samples=None,
                 model_args=(), model_kwargs=None, return_sites=None):
        self.model = model
        self.posterior_samples = posterior_samples or {}
        if posterior_samples:
            self.num_samples = tree_leaves(posterior_samples)[0].shape[0]
        else:
            if num_samples is None:
                raise ValueError(
                    "pass posterior_samples or num_samples (prior "
                    "predictive)")
            self.num_samples = int(num_samples)
        self._args = model_args
        self._kwargs = model_kwargs or {}
        self.return_sites = return_sites

    def _one(self, i, generator):
        data = {name: vals[i]
                for name, vals in self.posterior_samples.items()}
        tr = handlers.trace(
            handlers.substitute(
                handlers.seed(handlers.uncondition(self.model),
                              rng_key=generator),
                data=data)
        ).get_trace(*self._args, **self._kwargs)
        out = {}
        for name, site in tr.items():
            if site["type"] in ("sample", "deterministic") \
                    and name not in data:
                out[name] = torch.as_tensor(site["value"])
        if self.return_sites is not None:
            out = {n: v for n, v in out.items() if n in self.return_sites}
        return out

    def __call__(self, generator):
        """A dict site -> (num_samples, *site shape) tensor; the draws come
        from ``generator`` in turn, one replay a sample."""
        draws = [self._one(i, generator) for i in range(self.num_samples)]
        return {n: torch.stack([d[n] for d in draws]) for n in draws[0]}
