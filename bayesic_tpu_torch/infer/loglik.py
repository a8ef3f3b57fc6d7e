"""Pointwise log-likelihood of observed sites under posterior draws.

Counterpart of ``bayesic_tpu/infer/loglik.py``: every observed site's
log-density at each posterior draw, per datapoint (plate or batch
element), the input of the WAIC / PSIS-LOO diagnostics in
:mod:`bayesic_tpu_torch.utils.compare`.  ``log_prob`` sums event
dimensions, so a site declared with ``.to_event(k)`` gives ONE term per
remaining batch element; declare the datapoint dimension with ``plate``
or the batch shape to get per-observation terms.
"""

from __future__ import annotations

import torch

from ..core import handlers
from .svi.svi import tree_leaves

__all__ = ["log_likelihood"]


def log_likelihood(model, posterior_samples, model_args=(),
                   model_kwargs=None, sites=None, generator=None):
    """Per-draw, per-datapoint log-likelihood of each observed site.

    ``posterior_samples``: a dict of *constrained* latent values with a
    leading sample dimension.  ``sites``: optional names of the observed
    sites to evaluate.  ``generator``: a ``torch.Generator`` on the model's
    device, only drawn from when the model has latent sites the samples do
    not cover (drawn from the prior per draw, in turn; one seeded with 0 on
    the samples' device if None).

    Returns a dict site -> (num_samples, *batch_shape) tensor of
    log-densities without the subsample scale (a training-time correction;
    run on the full data)."""
    leaves = tree_leaves(posterior_samples) if posterior_samples else []
    if not leaves:
        raise ValueError("posterior_samples is empty")
    num = leaves[0].shape[0]
    model_kwargs = model_kwargs or {}
    if generator is None:
        generator = torch.Generator(leaves[0].device).manual_seed(0)

    def one(i):
        data = {n: v[i] for n, v in posterior_samples.items()}
        tr = handlers.trace(
            handlers.substitute(handlers.seed(model, rng_key=generator),
                                data=data)
        ).get_trace(*model_args, **model_kwargs)
        out = {}
        for name, site in tr.items():
            if site["type"] != "sample" or not site["is_observed"]:
                continue
            if sites is not None and name not in sites:
                continue
            out[name] = site["dist"].log_prob(site["value"])
        if not out:
            raise ValueError(
                "model has no observed sample sites (pass obs= or wrap in "
                "handlers.condition)")
        return out

    draws = [one(i) for i in range(num)]
    return {n: torch.stack([d[n] for d in draws]) for n in draws[0]}
