"""Reparameterizers: rewrite latent sites into better-conditioned forms.

Counterpart of ``bayesic_tpu/core/reparam.py``.  Hierarchical posteriors
(8-schools) need a non-centered parameterization for NUTS to mix; the
``reparam`` handler rewrites selected sites instead of the user writing
``theta = mu + tau * theta_raw`` by hand.

Usage::

    model_nc = reparam(model, config={"theta": LocScaleReparam()})
    MCMC(model=model_nc, ...).run(seed)

The rewritten site becomes a ``deterministic`` record (returned by
``postprocess``); a new latent ``{name}_decentered`` site carries the
density.
"""

from __future__ import annotations

import torch

from ..dist.distribution import Independent
from .handlers import Handler
from .primitives import sample as _sample

__all__ = ["Reparam", "LocScaleReparam", "reparam"]


class Reparam:
    """Interface: ``apply(name, dist) -> value``.  May call the DSL
    primitives to add latent sites; the ``reparam`` handler records the
    original site itself as deterministic."""

    def apply(self, name, d):
        raise NotImplementedError


def _split_loc_scale(d):
    """(inner loc-scale distribution, independent ndims), seeing through
    ``Independent`` wrappers; raises if the family has no loc/scale."""
    ndims = 0
    while isinstance(d, Independent):
        ndims += d.ndims
        d = d.base_dist
    if not (hasattr(d, "loc") and hasattr(d, "scale")):
        raise ValueError(
            f"LocScaleReparam needs a loc/scale family, got {type(d).__name__}"
        )
    return d, ndims


def _like(value, ref):
    """``value`` broadcast to the shape of the parameter ``ref`` it
    replaces (a Python float's shape is ())."""
    value = torch.as_tensor(value)
    return value.expand(ref.shape) if isinstance(ref, torch.Tensor) \
        else value


def _with_loc_scale(d, new_loc, new_scale):
    """Copy of a loc-scale distribution with replaced loc and scale, each
    broadcast to the original's shape (other parameters, e.g. StudentT's
    df, are kept)."""
    new = object.__new__(type(d))
    new.__dict__.update(d.__dict__)
    new.loc = _like(new_loc, d.loc)
    new.scale = _like(new_scale, d.scale)
    return new


class LocScaleReparam(Reparam):
    """Non-centering: ``x ~ F(loc, scale)`` becomes
    ``x_decentered ~ F(c loc, scale^c)``,
    ``x = (1 - c) loc + scale^(1 - c) x_decentered`` with ``centered`` c in
    [0, 1] (0, the default, fully non-centered; 1 a no-op)."""

    def __init__(self, centered=0.0):
        self.centered = float(centered)

    def apply(self, name, d):
        inner, ndims = _split_loc_scale(d)
        loc, scale = inner.loc, inner.scale
        c = self.centered
        scale_t = torch.as_tensor(scale)
        base = _with_loc_scale(
            inner, c * torch.as_tensor(loc),
            scale_t ** c if c else torch.ones_like(scale_t))
        if ndims:
            base = Independent(base, ndims)
        raw = _sample(f"{name}_decentered", base)
        if c:
            return (1.0 - c) * loc + scale_t ** (1.0 - c) * raw
        return loc + scale * raw


class reparam(Handler):
    """Handler applying ``config`` (site name -> Reparam) to sample sites.
    Wrap the model directly (``reparam`` innermost), so that the rewrite
    runs before ``seed``/``substitute`` and the decentered site goes
    through the whole stack; the original site then continues through the
    outer handlers as a deterministic record."""

    def __init__(self, fn=None, config=None):
        super().__init__(fn)
        self.config = config or {}

    def process_message(self, msg):
        if (msg["type"] == "sample" and not msg["is_observed"]
                and msg["value"] is None and msg["name"] in self.config):
            msg["value"] = self.config[msg["name"]].apply(msg["name"],
                                                          msg["dist"])
            msg["type"] = "deterministic"
