"""Textual model-structure rendering: inspect what the DSL traced before
running inference.

Counterpart of ``bayesic_tpu/core/render.py``; the same model gives the
same text in both packages.  ``render_model(model, *args)`` traces the
model once and returns one line per site: kind, distribution, batch and
event shapes, plates, observed/enumerated flags and a latent's bijector,
the information the log-joint compiler acts on.
"""

from __future__ import annotations

import torch

from ..dist.transforms import biject_to
from . import handlers

__all__ = ["render_model"]


def _shape_str(shape):
    return "()" if not shape else str(tuple(int(s) for s in shape))


def _value_shape(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else \
        tuple(torch.as_tensor(v).shape)


def render_model(model, *args, rng_key=None, **kwargs):
    """A multi-line description of ``model``'s trace (returned, not
    printed).  Pure introspection: one discovery trace from ``rng_key``
    (a ``torch.Generator``; a CPU one seeded with 0 by default)."""
    gen = rng_key if rng_key is not None else torch.Generator().manual_seed(0)
    tr = handlers.trace(
        handlers.seed(model, rng_key=gen)
    ).get_trace(*args, **kwargs)

    lines = []
    for name, site in tr.items():
        kind = site["type"]
        if kind == "sample":
            d = site["dist"]
            head = f"{type(d).__name__}{_shape_str(d.batch_shape)}"
            if d.event_shape:
                head += f" ev{_shape_str(d.event_shape)}"
            tags = []
            if site["is_observed"]:
                tags.append("obs")
            elif site.get("infer", {}).get("enumerate"):
                tags.append("enum")
            else:
                try:
                    tags.append(f"biject={type(biject_to(d.support)).__name__}")
                except ValueError:
                    tags.append("discrete")
            if site.get("plates"):
                tags.append(
                    "plates=" + ",".join(p.name for p in site["plates"]))
            scale = site.get("scale", 1.0)
            if not isinstance(scale, (int, float)) or scale != 1.0:
                tags.append(f"scale={scale}")
            val_shape = _shape_str(_value_shape(site["value"]))
            lines.append(
                f"  sample {name:<20} ~ {head:<28} -> {val_shape:<10} "
                f"[{' '.join(tags)}]")
        elif kind == "param":
            val_shape = _shape_str(_value_shape(site["value"]))
            lines.append(
                f"  param  {name:<20} {val_shape:<10} "
                f"[constraint={site['constraint']!r}]")
        elif kind == "deterministic":
            val_shape = _shape_str(_value_shape(site["value"]))
            lines.append(f"  det    {name:<20} {val_shape}")
        elif kind == "subsample":
            size, sub = site["size"], site["subsample_size"]
            lines.append(
                f"  plate  {name[:-5]:<20} size={size}"
                + (f" subsample={sub}" if sub else ""))
    fn_name = getattr(model, "__name__", type(model).__name__)
    return "\n".join([f"model {fn_name}:"] + lines)
