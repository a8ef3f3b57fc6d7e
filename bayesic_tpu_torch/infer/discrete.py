"""Posterior recovery of enumerated discrete sites (``infer_discrete``).

Counterpart of ``bayesic_tpu/infer/discrete.py``: inference runs on the
marginalised model (NUTS, SVI and SMC never see the discrete sites); this
module draws them back from their exact conditionals given each posterior
draw of the continuous latents, all draws at once under
``torch.func.vmap``.  The Gumbel noise of draw i comes from the stream
keyed by ``(seed, site, i)`` (``infer/mcmc/streams.py``), so a draw does
not depend on how many are made beside it.
"""

from __future__ import annotations

import math

import torch

from ..core.logjoint import build_logjoint, default_device
from .mcmc.streams import SAMPLE, StreamKey, gumbels as gumbel_stream

__all__ = ["infer_discrete"]


def infer_discrete(model, samples, rng_key, model_args=(),
                   model_kwargs=None):
    """``samples``: dict site -> (S, *event) **constrained** posterior draws
    of the continuous latents (``MCMCResult.samples`` reshaped to one
    leading draw axis).  Returns dict enum-site -> (S, *site shape) int32
    draws from p(z | theta_s, data), one exact joint conditional draw per
    posterior sample.  ``rng_key`` is an integer seed.  Raises for a model
    where that draw would not be exact: a plate-local site eliminated
    before a lower-rank site it interacts with (``sample_enum``; the JAX
    package draws one assignment for the whole plate there)."""
    device = default_device(None, list(samples.values()), model_args)
    info, logdensity, _, _ = build_logjoint(
        model, *model_args,
        rng_key=torch.Generator(device=device).manual_seed(0),
        **(model_kwargs or {}))
    if not info.enum_sites:
        raise ValueError("model has no enumerated discrete sites")
    names = list(info.latent_names)
    missing = [n for n in names if n not in samples]
    if missing:
        raise ValueError(f"samples missing latent sites {missing}")
    vals = {n: torch.as_tensor(samples[n], device=device) for n in names}
    logdensity.require_exact_enum(
        {n: info.transforms[n].inverse(vals[n][0]) for n in names},
        "infer_discrete")
    num = vals[names[0]].shape[0]
    draws = torch.arange(num, device=device)
    gumbels = {}
    for e, n in enumerate(sorted(info.enum_sites)):
        shape = tuple(info.enum_shapes[n]) + (info.enum_sites[n],)
        gumbels[n] = gumbel_stream(
            StreamKey(int(rng_key), SAMPLE, e), draws, math.prod(shape),
            device=device).reshape((num,) + shape)

    def one(v, g):
        u = {n: info.transforms[n].inverse(v[n]) for n in names}
        return logdensity.sample_enum(u, gumbels=g)

    return torch.func.vmap(one)(vals, gumbels)
