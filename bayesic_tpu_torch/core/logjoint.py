"""Joint log-prob compiler: model graph -> log-density in unconstrained
space.

Counterpart of ``bayesic_tpu/core/logjoint.py`` without discrete
enumeration (a latent site marked ``infer={"enumerate": True}`` raises).
The compiler traces the model once to discover its sites, then returns
closures that replay it under ``substitute``.  JAX replays at trace time
only; PyTorch is eager, so every call of ``logdensity`` replays the
handler stack in Python.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..dist.transforms import biject_to
from . import handlers

__all__ = ["ModelInfo", "inspect_model", "build_logjoint", "Potential",
           "init_to_prior", "init_population", "priors_fixed",
           "init_to_uniform", "default_device"]


class ModelInfo(NamedTuple):
    """Static description of a model's site graph (one discovery trace)."""

    latent_names: tuple
    observed_names: tuple
    deterministic_names: tuple
    transforms: dict          # latent name -> Transform (R^n -> support)
    site_shapes: dict         # latent name -> constrained shape
    unconstrained_shapes: dict  # latent name -> unconstrained shape
    has_subsample: bool
    subsample_sites: dict     # "{plate}__idx" -> (size, ssize, replacement)
    param_names: tuple        # learnable model params (`param` sites)
    param_transforms: dict    # param name -> Transform
    param_init: dict          # param name -> unconstrained init value

    @property
    def unconstrained_dim(self):
        return sum(math.prod(s) for s in self.unconstrained_shapes.values())


def default_device(device, *candidates):
    """``device`` if given; else the device of the first tensor among the
    ``candidates`` (each a tensor, a sequence of values, or None); else
    ``"cuda"``: an engine runs where its data lies, and on the card when
    nothing says otherwise."""
    if device is not None:
        return torch.device(device)
    for c in candidates:
        for v in (c if isinstance(c, (tuple, list)) else (c,)):
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cuda")


def _default_generator():
    return torch.Generator().manual_seed(0)


def _model_trace(model, args, kwargs, generator):
    return handlers.trace(
        handlers.seed(model, rng_key=generator)
    ).get_trace(*args, **kwargs)


def inspect_model(model, *args, rng_key=None, **kwargs) -> ModelInfo:
    """Trace ``model`` once.  ``rng_key`` is a ``torch.Generator`` on the
    device the model's draws must land on (CPU generator by default)."""
    gen = rng_key if rng_key is not None else _default_generator()
    tr = _model_trace(model, args, kwargs, gen)
    latents, observed, deterministics = [], [], []
    transforms, shapes, ushapes, subsample_sites = {}, {}, {}, {}
    param_names, param_transforms, param_init = [], {}, {}
    has_subsample = False
    for name, site in tr.items():
        if site["type"] == "sample":
            if site["is_observed"]:
                observed.append(name)
                continue
            if site.get("infer", {}).get("enumerate"):
                raise ValueError(
                    f"latent site {name!r} is marked infer={{'enumerate': "
                    f"True}}; discrete enumeration is not ported.")
            if site["dist"].support.is_discrete:
                raise ValueError(
                    f"latent site {name!r} is discrete — observe it "
                    f"(enumeration is not ported)."
                )
            latents.append(name)
            t = biject_to(site["dist"].support)
            transforms[name] = t
            shapes[name] = tuple(site["value"].shape)
            ushapes[name] = t.inverse_shape(shapes[name])
        elif site["type"] == "deterministic":
            deterministics.append(name)
        elif site["type"] == "subsample":
            if site["subsample_size"] is not None \
                    and site["subsample_size"] < site["size"]:
                has_subsample = True
                subsample_sites[name] = (
                    site["size"], site["subsample_size"],
                    site.get("replacement", True),
                )
        elif site["type"] == "param":
            t = biject_to(site["constraint"])
            param_transforms[name] = t
            if site["value"] is None:
                raise ValueError(f"param site {name!r} needs init_value=")
            param_init[name] = t.inverse(site["value"])
            param_names.append(name)
    return ModelInfo(
        tuple(latents), tuple(observed), tuple(deterministics), transforms,
        shapes, ushapes, has_subsample, subsample_sites, tuple(param_names),
        param_transforms, param_init,
    )


def init_to_prior(model, info, *args, rng_key=None, **kwargs):
    """Initial unconstrained params from one prior draw (``rng_key`` a
    ``torch.Generator``; a CPU generator seeded with 0 by default)."""
    gen = rng_key if rng_key is not None else _default_generator()
    tr = _model_trace(model, args, kwargs, gen)
    return {n: info.transforms[n].inverse(tr[n]["value"])
            for n in info.latent_names}


def priors_fixed(model, info, *args, device="cpu", **kwargs):
    """Whether no latent site's prior depends on another latent's draw.

    Two traces from generators seeded apart draw different latents; a
    site whose distribution is fixed gives the first trace's value the
    same log density under both.  Neither trace touches the caller's
    generator."""
    traces = [_model_trace(model, args, kwargs,
                           torch.Generator(device=device).manual_seed(s))
              for s in (0, 1)]
    for n in info.latent_names:
        d0, d1 = traces[0][n]["dist"], traces[1][n]["dist"]
        value = traces[0][n]["value"]
        if d0.batch_shape != d1.batch_shape \
                or not torch.equal(d0.log_prob(value), d1.log_prob(value)):
            return False
    return True


def init_population(model, info, num, *args, rng_key=None, **kwargs):
    """``num`` unconstrained prior draws: a dict of (num, *shape) tensors.

    When every latent's prior is fixed (``priors_fixed``, the GMM's case)
    one trace gives each site's distribution, sampled with sample shape
    (num,) and mapped through the site's inverse transform.  Otherwise
    each draw gets its own trace, in order from ``rng_key``, so a site
    such as ``b ~ N(a, 0.1)`` is drawn around its own particle's ``a``:
    the JAX package's semantics (one key per particle folded into
    ``init_to_prior``), at one model trace per particle."""
    gen = rng_key if rng_key is not None else _default_generator()
    if not priors_fixed(model, info, *args, device=gen.device, **kwargs):
        draws = [init_to_prior(model, info, *args, rng_key=gen, **kwargs)
                 for _ in range(int(num))]
        return {n: torch.stack([d[n] for d in draws])
                for n in info.latent_names}
    tr = _model_trace(model, args, kwargs, gen)
    return {n: info.transforms[n].inverse(tr[n]["dist"].sample(gen, (num,)))
            for n in info.latent_names}


def init_to_uniform(info, rng_key=None, radius=2.0, uniforms=None):
    """Stan-style init: u ~ Uniform(-radius, radius) per coordinate.

    The U(0, 1) draws come from the ``torch.Generator`` ``rng_key``, one
    site after another, or are given as ``uniforms`` (..., dim) in the
    flat order of ``infer.svi.unraveler`` — ``MCMC`` passes per-chain
    streams so, leading chain axes and all, each chain's init depends on its
    logical index only."""
    if uniforms is None:
        if rng_key is None:
            raise ValueError("init_to_uniform needs rng_key or uniforms")
        uniforms = torch.cat([
            torch.rand(math.prod(info.unconstrained_shapes[n]),
                       generator=rng_key, device=rng_key.device)
            for n in info.latent_names])
    from ..infer.svi.guides import unraveler

    _, unravel, _ = unraveler(info)
    return unravel(radius * (2.0 * uniforms - 1.0))


def build_logjoint(model, *args, rng_key=None, **kwargs):
    """Compile ``model`` into callables on tensors.

    Returns ``(info, logdensity, constrain, postprocess)`` where

    * ``logdensity(uparams, rng_key=None, subsample=None, model_args=None,
      model_kwargs=None, params=None) -> scalar``: joint log-density (model
      density + change-of-variable Jacobians) at the unconstrained dict
      ``uparams``.  ``rng_key`` (a ``torch.Generator``) only matters for
      models with subsampled plates when ``subsample`` does not force the
      ``"{plate}__idx"`` index arrays.  ``params`` gives unconstrained
      values of the model's ``param`` sites.
      ``logdensity.parts`` takes the same arguments and returns ``(log
      prior + Jacobians, log likelihood)``, the split tempered SMC needs;
      ``logdensity.prior`` the first of the two alone.
    * ``constrain(uparams) -> dict``: latent values in the support.
    * ``postprocess(uparams, rng_key=None, params=None) -> dict``:
      constrained latents plus the deterministic sites (full replay).

    ``rng_key`` here is the generator of the discovery trace; it fixes the
    device of the draws made while inspecting the model.
    """
    info = inspect_model(model, *args, rng_key=rng_key, **kwargs)
    # draws that a replay without its own generator needs (unforced
    # subsample indices) come from a generator reset to one seed per call,
    # so such replays see one fixed mini-batch, as with PRNGKey(0) in JAX
    gen0 = torch.Generator(
        device=rng_key.device if rng_key is not None else "cpu")

    def _replay(uparams, rng_key, subsample, model_args=None,
                model_kwargs=None, params=None):
        values = {
            n: info.transforms[n].forward(uparams[n])
            for n in info.latent_names
        }
        data = dict(values)
        if subsample:
            data.update(subsample)
        if params is not None:
            data.update({
                n: info.param_transforms[n].forward(params[n])
                for n in info.param_names
            })
        gen = rng_key if rng_key is not None else gen0.manual_seed(0)
        call_args = args if model_args is None else model_args
        call_kwargs = kwargs if model_kwargs is None else model_kwargs
        tr = handlers.trace(
            handlers.substitute(
                handlers.seed(model, rng_key=gen), data=data
            )
        ).get_trace(*call_args, **call_kwargs)
        return tr, values

    def _apply_mask(site, lp):
        # handlers.mask: excluded terms contribute exactly zero
        m = site.get("mask")
        return lp if m is None else torch.where(m, lp, torch.zeros_like(lp))

    def _factor(site):
        return site["scale"] * torch.sum(
            _apply_mask(site, torch.as_tensor(site["value"])))

    def _accumulate(tr, uparams):
        total = 0.0
        for name, site in tr.items():
            if site["type"] == "factor":
                total = total + _factor(site)
            if site["type"] != "sample":
                continue
            lp = _apply_mask(site, site["dist"].log_prob(site["value"]))
            total = total + site["scale"] * torch.sum(lp)
            if name in info.transforms:
                ldj = _apply_mask(site, info.transforms[name]
                                  .log_det_jacobian(uparams[name]))
                total = total + site["scale"] * torch.sum(ldj)
        return total

    def logdensity(uparams, rng_key=None, subsample=None, model_args=None,
                   model_kwargs=None, params=None):
        tr, _ = _replay(uparams, rng_key, subsample, model_args,
                        model_kwargs, params)
        return _accumulate(tr, uparams)

    def _parts(uparams, rng_key, subsample, model_args, model_kwargs,
               params, lik):
        tr, _ = _replay(uparams, rng_key, subsample, model_args,
                        model_kwargs, params)
        log_prior, log_lik = 0.0, 0.0
        for name, site in tr.items():
            if site["type"] == "factor" and lik:
                log_lik = log_lik + _factor(site)
            if site["type"] != "sample" or (site["is_observed"]
                                            and not lik):
                continue
            lp = site["scale"] * torch.sum(
                _apply_mask(site, site["dist"].log_prob(site["value"])))
            if site["is_observed"]:
                log_lik = log_lik + lp
            else:
                ldj = _apply_mask(site, info.transforms[name]
                                  .log_det_jacobian(uparams[name]))
                log_prior = log_prior + lp + site["scale"] * torch.sum(ldj)
        return log_prior, log_lik

    def logdensity_parts(uparams, rng_key=None, subsample=None,
                         model_args=None, model_kwargs=None, params=None):
        """(log prior + Jacobians, log likelihood): observed sites and
        factors make the likelihood, latent sites and their Jacobians the
        prior."""
        return _parts(uparams, rng_key, subsample, model_args, model_kwargs,
                      params, True)

    def logdensity_prior(uparams, rng_key=None, subsample=None,
                         model_args=None, model_kwargs=None, params=None):
        """The first of ``parts`` alone.  PyTorch runs eagerly and would
        evaluate a likelihood that is then dropped (XLA drops it when
        compiling the JAX package's ``parts(...)[0]``), so it is not
        evaluated at all."""
        return _parts(uparams, rng_key, subsample, model_args, model_kwargs,
                      params, False)[0]

    def constrain(uparams):
        return {
            n: info.transforms[n].forward(uparams[n])
            for n in info.latent_names
        }

    def postprocess(uparams, rng_key=None, params=None):
        """``params``: unconstrained values of the model's ``param`` sites;
        without them a deterministic site downstream of a trained param
        would be recomputed from the init values."""
        tr, values = _replay(uparams, rng_key, None, params=params)
        out = dict(values)
        for n in info.deterministic_names:
            out[n] = tr[n]["value"]
        return out

    logdensity.parts = logdensity_parts
    logdensity.prior = logdensity_prior
    return info, logdensity, constrain, postprocess


def _flatten(tree):
    """Leaves of a pytree of tensors in ``jax.flatten_util.ravel_pytree``'s
    order (dict keys sorted, sequences in order) and a rebuilder."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def build(leaves):
            out, i = {}, 0
            for k, (sub, rebuild) in zip(keys, parts):
                out[k] = rebuild(leaves[i:i + len(sub)])
                i += len(sub)
            return out
        return [leaf for sub, _ in parts for leaf in sub], build
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]

        def build(leaves):
            out, i = [], 0
            for sub, rebuild in parts:
                out.append(rebuild(leaves[i:i + len(sub)]))
                i += len(sub)
            return type(tree)(out)
        return [leaf for sub, _ in parts for leaf in sub], build
    return [torch.as_tensor(tree)], lambda leaves: leaves[0]


class Potential:
    """Flat-vector view of a log-joint for HMC/NUTS: the negative
    log-density over one raveled parameter vector.  The vector's order is
    the JAX package's ``ravel_pytree`` of the same ``uparams`` (dict keys
    sorted), so one flat vector means the same point in both packages."""

    def __init__(self, logdensity, uparams_example):
        leaves, build = _flatten(uparams_example)
        shapes = [tuple(x.shape) for x in leaves]
        sizes = [math.prod(s) for s in shapes]
        self.example_flat = torch.cat([x.reshape(-1) for x in leaves])
        self.dim = int(self.example_flat.shape[0])
        self._logdensity = logdensity

        def unravel(flat):
            chunks = torch.split(flat, sizes, dim=-1)
            batch = tuple(flat.shape[:-1])
            return build([c.reshape(batch + s)
                          for c, s in zip(chunks, shapes)])

        self.unravel = unravel

    def __call__(self, q, **kw):
        return -self._logdensity(self.unravel(q), **kw)

    def value_and_grad(self, q, **kw):
        grad, value = torch.func.grad_and_value(
            lambda qq: self(qq, **kw))(q)
        return value, grad
