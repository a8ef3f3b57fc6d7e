"""SVI driver: optimization loop over the ELBO.

Counterpart of ``bayesic_tpu/infer/svi/svi.py``.  The JAX driver compiles
the whole run into one ``lax.scan``; here a Python loop runs the steps,
autograd replaces ``jax.value_and_grad``, and ``Adam`` below replaces
``optax.adam``.  Each step replays the model's handler stack on the host,
so on a GPU this path is bound by the host; the fused trainer in
``ops/fused_vae.py`` is the fast path for the DLGM.

Parameters are nested dicts (and lists, a flow guide's layers) of
tensors.  A model with ``param`` sites gets ``{"guide": guide_params,
"model": {name: unconstrained value}}``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ...core.logjoint import build_logjoint, default_device, init_to_prior
from .elbo import draw_subsample, make_elbo
from .guides import Guide

__all__ = ["Adam", "AdamState", "SVIState", "SVIResult", "SVI",
           "cosine_decay_schedule", "tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts (of equal keys),
    tuples and lists (of equal lengths)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if type(tree) in (tuple, list):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if type(tree) in (tuple, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _tree_unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def cosine_decay_schedule(lr0, total):
    """``optax.cosine_decay_schedule(lr0, total)`` (alpha 0): the rate at
    the 0-based update count ``t`` is ``lr0 * (1 + cos(pi min(t/T, 1)))/2``."""
    lr0, total = float(lr0), int(total)

    def schedule(t):
        frac = min(float(t) / total, 1.0)
        return lr0 * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` on nested dicts of tensors: takes
    gradients of the loss (descent direction) and returns new tensors.
    ``lr`` is a number or a schedule, a function of the 0-based update
    count, read before the count advances, as optax reads it."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        zeros = tree_map(torch.zeros_like, params)
        return AdamState(0, zeros, tree_map(torch.zeros_like, params))

    def update(self, grads, state, params):
        """Returns ``(new_params, new_state)``."""
        b1, b2 = self.b1, self.b2
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        t = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1.0 - b2) * g * g,
                      state.nu, grads)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        new = tree_map(
            lambda p, m, v: p - lr * (m / bc1)
            / (torch.sqrt(v / bc2) + self.eps), params, mu, nu)
        return new, AdamState(t, mu, nu)


class SVIState(NamedTuple):
    params: Any
    opt_state: Any
    key: torch.Generator
    step: int


class SVIResult(NamedTuple):
    params: Any
    losses: torch.Tensor     # negative ELBO per step
    state: SVIState


class SVI:
    """``SVI(model, guide, Adam(lr), model_args=(x,))``.

    ``device`` is where the parameters live and the model's draws land
    while it is inspected.  ``None`` means the device of the first tensor
    in ``model_args``, or ``"cuda"`` if there is none.  Generators passed
    to ``init``/``run`` must live on that device too.
    ``grad_transform``, when given, maps the gradient tree before the
    optimizer sees it (clipping, or a data-parallel all-reduce).
    ``iwae``/``dreg``: the importance-weighted bound and its
    doubly-reparameterized gradient (``make_elbo``)."""

    def __init__(self, model, guide, optimizer, model_args=(),
                 model_kwargs=None, num_particles=1, stl=True, iwae=False,
                 dreg=False, device=None, grad_transform=None):
        self.model = model
        self.optimizer = optimizer
        self.grad_transform = grad_transform
        self.num_particles = int(num_particles)
        self.device = default_device(device, model_args)
        model_kwargs = model_kwargs or {}
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.info, self.logdensity, self.constrain, self.postprocess = \
            build_logjoint(model, *model_args, rng_key=gen, **model_kwargs)
        if isinstance(guide, Guide):
            self.guide = guide
        else:
            self.guide = guide(self.info)  # class or factory taking info
        self.elbo = make_elbo(self.logdensity, self.guide,
                              num_particles=num_particles, stl=stl,
                              info=self.info, iwae=iwae, dreg=dreg)
        self.iwae, self.dreg = bool(iwae), bool(dreg)
        self._model_args = model_args
        self._model_kwargs = model_kwargs

    # -- functional stepping ----------------------------------------------
    @property
    def has_model_params(self):
        return bool(self.info.param_names)

    def init(self, generator, init_loc_from_prior=False) -> SVIState:
        """Guide params from ``generator``; ``init_loc_from_prior`` puts the
        guide's loc at one prior draw of the model (``init_to_prior``, from
        the same generator)."""
        if init_loc_from_prior:
            loc = init_to_prior(self.model, self.info, *self._model_args,
                                rng_key=generator, **self._model_kwargs)
            guide_params = self.guide.init(generator, loc=loc)
        else:
            guide_params = self.guide.init(generator)
        if self.has_model_params:
            params = {"guide": guide_params,
                      "model": dict(self.info.param_init)}
        else:
            params = guide_params
        params = tree_map(lambda p: p.detach().to(self.device,
                                                  torch.float32), params)
        opt_state = self.optimizer.init(params)
        return SVIState(params, opt_state, generator, 0)

    def _split_params(self, params):
        if self.has_model_params:
            return params["guide"], params["model"]
        return params, None

    def model_params(self, params):
        """Constrained values of the model's learnable `param` sites."""
        _, mp = self._split_params(params)
        if mp is None:
            return {}
        return {
            n: self.info.param_transforms[n].forward(mp[n])
            for n in self.info.param_names
        }

    def guide_params(self, params):
        gp, _ = self._split_params(params)
        return gp

    def step(self, state: SVIState, model_args=None, subsample=None,
             eps=None):
        """One Adam step on the negative ELBO.  ``subsample`` forces the
        ``"{plate}__idx"`` index arrays instead of drawing them from the
        state's generator; ``eps`` hands the guide its noise (as
        ``ctx["eps"]``).  Returns ``(new_state, loss)``."""
        if subsample is None and self.info.has_subsample:
            subsample = draw_subsample(self.info, state.key)
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state.params)
        gp, mp = self._split_params(params)
        loss = -self.elbo(gp, state.key, subsample=subsample,
                          model_args=model_args, model_params=mp, eps=eps)
        leaves = tree_leaves(params)
        grads = _tree_unflatten(params,
                                torch.autograd.grad(loss, leaves))
        if self.grad_transform is not None:
            grads = self.grad_transform(grads)
        new_params, opt_state = self.optimizer.update(
            grads, state.opt_state, state.params)
        return (SVIState(new_params, opt_state, state.key, state.step + 1),
                loss.detach())

    def run(self, generator, num_steps, model_args=None,
            state=None) -> SVIResult:
        """Run ``num_steps`` steps in a Python loop; no host sync between
        steps (losses stay on the device until the caller reads them)."""
        if state is None:
            state = self.init(generator)
        losses = []
        for _ in range(int(num_steps)):
            state, loss = self.step(state, model_args=model_args)
            losses.append(loss)
        return SVIResult(state.params, torch.stack(losses), state)

    # -- posterior access ---------------------------------------------------
    def posterior_stats(self, params):
        """Unconstrained-space posterior mean/std per latent site."""
        return self.guide.stats(self.guide_params(params))

    def sample_posterior(self, params, generator, num_samples=1000):
        """``num_samples`` guide draws, constrained: a dict of
        (num_samples, *site shape) tensors.  The constrain map runs under
        ``torch.func.vmap`` over the draws."""
        uparams, _ = self.guide.sample_and_log_prob(
            self.guide_params(params), generator, (int(num_samples),))
        return torch.func.vmap(self.constrain)(uparams)
