"""Model-DSL primitives: ``sample``, ``plate``, ``param``,
``deterministic``, ``factor``.

Counterpart of ``bayesic_tpu/core/primitives.py``.  A model is an ordinary
Python function that calls these primitives; handlers (handlers.py)
intercept the messages to seed, trace, substitute or condition it.  JAX
runs the handlers once, while tracing; PyTorch runs eagerly, so here the
handler stack is replayed in Python on every call of the log-joint.
"""

from __future__ import annotations

import torch

from ..dist import constraints
from ..dist.distribution import Distribution

__all__ = ["sample", "plate", "param", "deterministic", "factor",
           "apply_stack", "HANDLER_STACK"]

# Innermost handler is last.  Module-level, as in the JAX package: handlers
# are entered and left around one model call on one thread.
HANDLER_STACK: list = []


def _new_msg(type_, name, **kw):
    msg = dict(
        type=type_,
        name=name,
        value=None,
        is_observed=False,
        scale=1.0,
        key=None,           # a torch.Generator once a seed handler ran
        plates=(),          # tuple of active plate handlers
        stop=False,
        dist=None,
    )
    msg.update(kw)
    return msg


def apply_stack(msg):
    """Run a message through the handler stack: innermost handlers first for
    ``process_message``, then the default behavior, then ``postprocess`` in
    reverse order."""
    pointer = 0
    for pointer, handler in enumerate(reversed(HANDLER_STACK)):
        handler.process_message(msg)
        if msg["stop"]:
            break
    default_process(msg)
    for handler in HANDLER_STACK[len(HANDLER_STACK) - pointer - 1:]:
        handler.postprocess_message(msg)
    return msg


def default_process(msg):
    if msg["value"] is not None:
        return
    t = msg["type"]
    if t == "sample":
        if msg["key"] is None:
            raise RuntimeError(
                f"sample site {msg['name']!r} has no value and no generator "
                f"— wrap the model in handlers.seed(...) or pass obs=."
            )
        msg["value"] = msg["dist"].sample(msg["key"],
                                          msg.get("sample_shape", ()))
    elif t == "subsample":
        size, ssize = msg["size"], msg["subsample_size"]
        gen = msg["key"]
        if ssize is None or ssize >= size:
            device = gen.device if gen is not None else None
            msg["value"] = torch.arange(size, device=device)
        else:
            if gen is None:
                raise RuntimeError(
                    f"plate {msg['name']!r} subsampling needs a generator — "
                    f"wrap the model in handlers.seed(...)."
                )
            if msg.get("replacement", True):
                # with-replacement draw: unbiased ELBO terms in O(B)
                msg["value"] = torch.randint(0, size, (ssize,),
                                             generator=gen, device=gen.device)
            else:
                msg["value"] = torch.randperm(size, generator=gen,
                                              device=gen.device)[:ssize]
    elif t == "param":
        msg["value"] = msg["init_value"]
    elif t in ("deterministic", "factor"):
        pass
    else:
        raise ValueError(f"unknown message type {t!r}")


def sample(name, fn, obs=None, rng_key=None, sample_shape=(), infer=None):
    """Declare a random variable ``name`` with distribution ``fn``; if
    ``obs`` is given the site is an observed likelihood term.  ``rng_key``
    is a ``torch.Generator``.  ``infer`` carries inference hints and is
    recorded in the trace; ``build_logjoint`` sums a discrete latent site
    marked ``{"enumerate": True}`` out of the density."""
    if not isinstance(fn, Distribution):
        raise TypeError(f"sample({name!r}): fn must be a Distribution")
    if not HANDLER_STACK and obs is None and rng_key is None:
        raise RuntimeError(
            f"sample({name!r}) outside any handler needs rng_key="
        )
    msg = _new_msg(
        "sample", name, dist=fn, value=obs,
        is_observed=obs is not None, key=rng_key, sample_shape=sample_shape,
        infer=infer or {},
    )
    apply_stack(msg)
    return msg["value"]


def param(name, init_value=None, constraint=constraints.real):
    """Declare a learnable parameter site.  ``init_value`` is a tensor or a
    dict of tensors (e.g. a module's parameters)."""
    msg = _new_msg("param", name, init_value=init_value, constraint=constraint)
    apply_stack(msg)
    return msg["value"]


def deterministic(name, value):
    """Record a derived quantity in the trace."""
    msg = _new_msg("deterministic", name, value=value)
    apply_stack(msg)
    return msg["value"]


def factor(name, log_factor):
    """Add an arbitrary term to the joint log-density."""
    msg = _new_msg("factor", name, value=log_factor)
    apply_stack(msg)
    return msg["value"]


class plate:
    """Conditionally-independent batch dimension with optional mini-batch
    subsampling.

    Usage::

        with plate("data", size=N, subsample_size=B) as idx:
            sample("obs", dist.Normal(mu[idx], 1.0), obs=y[idx])

    Sites sampled inside get ``scale *= size / len(idx)`` so subsampled
    log-densities are unbiased estimates of the full-data ones.  The
    subsample indices are themselves a (substitutable) site named
    ``"{name}__idx"`` so a replayed log-joint sees the same mini-batch.
    """

    def __init__(self, name, size, subsample_size=None, dim=None,
                 replacement=True):
        self.name = name
        self.size = int(size)
        self.subsample_size = (
            None if subsample_size is None else int(subsample_size)
        )
        if dim not in (None, -1):
            raise NotImplementedError(
                "plate(dim=...) is not supported; batch dims are "
                "right-aligned (the dim=-1 convention)"
            )
        self.dim = dim
        self.replacement = replacement
        self.indices = None

    @property
    def scale(self):
        if self.subsample_size is None or self.subsample_size >= self.size:
            return 1.0
        return self.size / self.subsample_size

    def __enter__(self):
        if self.indices is None:
            # first entry emits the index site; re-entry reuses the same
            # indices, so one plate object sees one consistent mini-batch
            msg = _new_msg(
                "subsample", self.name + "__idx", size=self.size,
                subsample_size=self.subsample_size,
                replacement=self.replacement,
            )
            apply_stack(msg)
            self.indices = msg["value"]
        HANDLER_STACK.append(self)
        return self.indices

    def __exit__(self, *exc):
        if HANDLER_STACK[-1] is not self:
            raise RuntimeError(f"plate {self.name!r} exited out of order")
        HANDLER_STACK.pop()
        return False

    # -- as a handler on the stack ----------------------------------------
    def process_message(self, msg):
        if msg["type"] in ("sample", "factor"):
            msg["scale"] = msg["scale"] * self.scale
            msg["plates"] = msg["plates"] + (self,)

    def postprocess_message(self, msg):
        pass
