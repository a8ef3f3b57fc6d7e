"""Effect handlers: seed / trace / substitute / condition / scale / mask /
block / uncondition.

Counterpart of ``bayesic_tpu/core/handlers.py``.  ``seed`` holds one
``torch.Generator`` and hands it to every sample and subsample site in site
order, so the draws are deterministic given the generator's state.
(The JAX package derives one key per site with ``fold_in``; per-site
streams that do not depend on order come with the MCMC port.)
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .primitives import HANDLER_STACK

__all__ = ["Handler", "seed", "trace", "substitute", "condition", "scale",
           "block", "uncondition", "mask"]


class Handler:
    """Base effect handler; wraps a callable and interposes on messages while
    the wrapped call is executing."""

    def __init__(self, fn=None):
        self.fn = fn

    def __enter__(self):
        HANDLER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        if HANDLER_STACK[-1] is not self:
            raise RuntimeError("handler exited out of order")
        HANDLER_STACK.pop()
        return False

    def __call__(self, *args, **kwargs):
        with self:
            return self.fn(*args, **kwargs)

    def process_message(self, msg):
        pass

    def postprocess_message(self, msg):
        pass


class seed(Handler):
    """Give sample/subsample sites that have no value the generator
    ``rng_key`` (a ``torch.Generator``) to draw from."""

    def __init__(self, fn=None, rng_key=None):
        super().__init__(fn)
        if rng_key is None:
            raise ValueError("seed needs rng_key (a torch.Generator)")
        self.rng_key = rng_key

    def process_message(self, msg):
        if msg["type"] in ("sample", "subsample") and msg["value"] is None \
                and msg["key"] is None:
            msg["key"] = self.rng_key


class trace(Handler):
    """Record every message into an OrderedDict keyed by site name."""

    def __enter__(self):
        self.sites = OrderedDict()
        return super().__enter__()

    def postprocess_message(self, msg):
        name = msg["name"]
        if name in self.sites:
            raise ValueError(f"duplicate site name {name!r}")
        self.sites[name] = msg.copy()

    def get_trace(self, *args, **kwargs):
        self(*args, **kwargs)
        return self.sites


class substitute(Handler):
    """Force site values from ``data`` (dict name -> value). Applies to
    sample, subsample, and param sites; observedness is unchanged."""

    def __init__(self, fn=None, data=None):
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg):
        if msg["type"] in ("sample", "subsample", "param") \
                and msg["name"] in self.data and msg["value"] is None:
            msg["value"] = self.data[msg["name"]]
            msg["is_substituted"] = True


class condition(Handler):
    """Like substitute but marks the site observed (likelihood term)."""

    def __init__(self, fn=None, data=None):
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] in self.data \
                and msg["value"] is None:
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True


class scale(Handler):
    """Multiply log-density contributions of enclosed sites by ``factor``."""

    def __init__(self, fn=None, factor=1.0):
        super().__init__(fn)
        self.factor = factor

    def process_message(self, msg):
        if msg["type"] in ("sample", "factor"):
            msg["scale"] = msg["scale"] * self.factor


class uncondition(Handler):
    """Strip observations so likelihood sites resample from their
    distributions (posterior-predictive replay)."""

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["is_observed"]:
            msg["is_observed"] = False
            msg["value"] = None


class mask(Handler):
    """Exclude density contributions elementwise where ``mask`` is False.
    The mask broadcasts against each enclosed site's ``log_prob``; nested
    masks compose by logical AND.  Sampling is unaffected."""

    def __init__(self, fn=None, mask=None):
        super().__init__(fn)
        if mask is None:
            raise ValueError("mask handler needs mask=")
        self.mask = mask

    def process_message(self, msg):
        if msg["type"] in ("sample", "factor"):
            prev = msg.get("mask")
            msg["mask"] = self.mask if prev is None \
                else torch.logical_and(prev, self.mask)


class block(Handler):
    """Hide matching sites from outer handlers (e.g. keep guide sites out of
    an outer model trace)."""

    def __init__(self, fn=None, hide_fn=None, hide=None):
        super().__init__(fn)
        if hide_fn is None:
            hide_set = set(hide or [])
            hide_fn = (lambda msg: msg["name"] in hide_set) if hide_set \
                else (lambda msg: True)
        self.hide_fn = hide_fn

    def process_message(self, msg):
        if self.hide_fn(msg):
            msg["stop"] = True
