"""Joint log-prob compiler: model graph -> log-density in unconstrained
space.

Counterpart of ``bayesic_tpu/core/logjoint.py``, discrete enumeration
included: a discrete latent site marked ``infer={"enumerate": True}`` is
summed out of the density by vectorized variable elimination, and
``logdensity.sample_enum`` draws it back from its conditional (exact
but for one elimination pattern, see ``sample_enum``).
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
    enum_sites: dict = None   # enumerated discrete site -> support size
    enum_shapes: dict = None  # enumerated site -> natural (non-enum) shape
    enum_pad: int = 0         # max natural value rank across all sites (P)

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
    enum_sites, enum_shapes = {}, {}
    has_subsample = False
    enum_pad = max([torch.as_tensor(site["value"]).dim()
                    for site in tr.values()
                    if site["type"] in ("sample", "factor")], default=0)
    for name, site in tr.items():
        if site["type"] == "sample":
            if site["is_observed"]:
                observed.append(name)
                continue
            if site.get("infer", {}).get("enumerate"):
                enum_sites[name] = _enum_support_size(name, site["dist"])
                enum_shapes[name] = tuple(site["value"].shape)
                continue
            if site["dist"].support.is_discrete:
                raise ValueError(
                    f"latent site {name!r} is discrete — marginalise it "
                    f"(MixtureSameFamily), observe it, or mark it "
                    f"infer={{'enumerate': True}} (scalar sites)."
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
        param_transforms, param_init, enum_sites, enum_shapes, enum_pad,
    )


def _enum_support_size(name, d):
    """Support size of an enumerable discrete site (scalar or
    plate-batched; a batched site is marginalised per element)."""
    if hasattr(d, "num_categories"):
        return int(d.num_categories)
    from ..dist import constraints as _c

    if isinstance(d.support, _c._Boolean):
        return 2
    raise ValueError(
        f"cannot enumerate {name!r}: support size unknown for "
        f"{type(d).__name__} (Categorical/Bernoulli supported)"
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
      ``logdensity.prior`` the first of the two alone.  With enumerated
      sites the density and both parts are marginal over them;
      ``logdensity.sample_enum(uparams, rng_key, gumbels=)`` draws them
      from their conditional (``logdensity.require_exact_enum`` refuses
      the models where that draw is not exact) and
      ``logdensity.given_enum(uparams, enum_values)`` conditions the
      density on them.
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

    # -- vectorized discrete enumeration -----------------------------------
    # Each enumerated site e gets a leading enumeration axis of its own:
    # its substituted value is arange(K_e) shaped (K_e, 1...[E-1-e ones],
    # 1...[P ones]), so every enum axis and the natural (model) dims
    # broadcast through ONE replay; the enum axes are then marginalised by
    # variable elimination.  A batched (plate-local) site is marginalised
    # per plate element: its dependent terms' batch shapes must
    # right-align with the site's.
    enum_names = sorted(info.enum_sites)
    n_enum, pad_rank = len(enum_names), info.enum_pad

    def _rank(e):
        return len(info.enum_shapes[enum_names[e]])

    def _enum_assign(device):
        out = {}
        for e, n in enumerate(enum_names):
            k = info.enum_sites[n]
            out[n] = torch.arange(k, dtype=torch.int32, device=device) \
                .reshape((k,) + (1,) * (n_enum - 1 - e) + (1,) * pad_rank)
        return out

    def _collect_terms(tr, uparams):
        """(lp, scale, is_lik) per sample/factor term, left-padded to rank
        E+P: enum axis e sits at position e, the natural dims right-aligned
        in the trailing P slots."""
        full_rank = n_enum + pad_rank
        terms = []

        def pad(x):
            x = torch.as_tensor(x)
            if x.dim() > full_rank:
                raise ValueError(
                    f"enumeration produced a log-prob of rank {x.dim()} > "
                    f"{full_rank}; model shapes must stay within the "
                    "discovery-trace ranks")
            return x.reshape((1,) * (full_rank - x.dim()) + tuple(x.shape))

        for name, site in tr.items():
            if site["type"] == "sample":
                lp = _apply_mask(site, site["dist"].log_prob(site["value"]))
                terms.append((pad(lp), site["scale"], site["is_observed"]))
                if name in info.transforms:
                    ldj = _apply_mask(site, info.transforms[name]
                                      .log_det_jacobian(uparams[name]))
                    terms.append((pad(ldj), site["scale"], False))
            elif site["type"] == "factor":
                lp = _apply_mask(site, torch.as_tensor(site["value"]))
                terms.append((pad(lp), site["scale"], True))
        return terms

    # The elimination order matters when scalar and plate-local sites
    # interact: a scalar site's elimination sums the plate axes, so a
    # still-live plate-local axis would be coupled across elements.
    # Plate-local sites (higher natural rank) go first; their per-element
    # marginals then sum correctly under the later scalar eliminations.
    elim_order = sorted(range(n_enum), key=lambda i: (-_rank(i), -i))

    def _check_no_cross_plate(involved, e):
        for lp, *_ in involved:
            for f in range(n_enum):
                if f != e and lp.shape[f] != 1 and _rank(f) > 0 \
                        and _rank(e) != _rank(f):
                    raise ValueError(
                        "enumerated plate-local sites interacting across "
                        "plates of different ranks are unsupported "
                        f"({enum_names[e]!r} with {enum_names[f]!r})")

    def _plate_sum(involved, r):
        """Sum the natural axes left of a rank-``r`` site's plate dims:
        they belong to independent plates and sum freely."""
        red = tuple(range(n_enum, n_enum + pad_rank - r))
        if not red:
            return involved
        return [(torch.sum(lp, dim=red, keepdim=True), s)
                for lp, s in involved]

    def _combine(involved):
        combined = involved[0][0]
        for lp, _ in involved[1:]:
            combined = combined + lp
        return combined

    def _eliminate(terms):
        """Marginalise the enum axes: for each axis (in ``elim_order``), sum
        the involved terms' natural dims down to the site's own plate dims,
        add them and logsumexp the axis away.  n scalar sites of K values
        cost n eliminations of one K-vector each, not K^n replays."""
        terms = list(terms)
        for e in elim_order:
            involved = [t for t in terms if t[0].shape[e] != 1]
            if not involved:
                continue
            _check_no_cross_plate(involved, e)
            rest = [t for t in terms if t[0].shape[e] == 1]
            involved = _plate_sum(involved, _rank(e))
            s0 = involved[0][1]
            if all(s == s0 for _, s in involved):
                terms = rest + [(torch.logsumexp(_combine(involved), e,
                                                 keepdim=True), s0)]
                continue
            if _rank(e):
                raise ValueError(
                    f"enumerated site {enum_names[e]!r} is plate-local "
                    "but its dependent terms carry different plate "
                    "scales; keep the site and its dependents in the "
                    "same (sub)sampled plate")
            # scalar site, mixed scales (a prior outside a subsampled
            # plate): the scales apply to the fully reduced terms
            red_all = tuple(range(n_enum, n_enum + pad_rank))
            combined = None
            for lp, s in involved:
                v = s * (torch.sum(lp, dim=red_all, keepdim=True)
                         if red_all else lp)
                combined = v if combined is None else combined + v
            terms = rest + [(torch.logsumexp(combined, e, keepdim=True),
                             1.0)]
        total = 0.0
        for lp, s in terms:
            total = total + s * torch.sum(lp)
        return total

    def _enum_terms(uparams, rng_key, subsample, model_args, model_kwargs,
                    params):
        # the enum values live with the latents (else the model's
        # arguments, else the discovery trace's draws)
        cands = [v for v in list((uparams or {}).values())
                 + list(args if model_args is None else model_args)
                 if isinstance(v, torch.Tensor)]
        sub = dict(subsample or {})
        sub.update(_enum_assign(cands[0].device if cands else gen0.device))
        tr, _ = _replay(uparams, rng_key, sub, model_args, model_kwargs,
                        params)
        return _collect_terms(tr, uparams)

    def logdensity(uparams, rng_key=None, subsample=None, model_args=None,
                   model_kwargs=None, params=None):
        if enum_names:
            terms = _enum_terms(uparams, rng_key, subsample, model_args,
                                model_kwargs, params)
            return _eliminate([(lp, s) for lp, s, _ in terms])
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
        prior.  With enumerated sites both parts are marginal: the prior
        is log sum_z p(theta, z) and the likelihood the full marginal joint
        minus it, so the two always add up to the marginal joint."""
        if enum_names:
            terms = _enum_terms(uparams, rng_key, subsample, model_args,
                                model_kwargs, params)
            log_prior = _eliminate([(lp, s) for lp, s, lik in terms
                                    if not lik])
            log_full = _eliminate([(lp, s) for lp, s, _ in terms])
            return log_prior, log_full - log_prior
        return _parts(uparams, rng_key, subsample, model_args, model_kwargs,
                      params, True)

    def logdensity_prior(uparams, rng_key=None, subsample=None,
                         model_args=None, model_kwargs=None, params=None):
        """The first of ``parts`` alone.  PyTorch runs eagerly and would
        evaluate a likelihood that is then dropped (XLA drops it when
        compiling the JAX package's ``parts(...)[0]``), so it is not
        evaluated at all."""
        if enum_names:
            return logdensity_parts(uparams, rng_key, subsample, model_args,
                                    model_kwargs, params)[0]
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

    # -- posterior draws of the enumerated sites (infer_discrete) ----------
    def _index_enum_axis(lp, axis, idx, r_e):
        """``lp`` at the sampled assignment ``idx`` (the site's
        natural-shape int tensor) of an earlier site along its enum axis,
        the axis kept with size 1."""
        if lp.shape[axis] == 1:
            return lp
        idxp = idx.long().reshape(
            (1,) * (n_enum + pad_rank - r_e) + tuple(idx.shape))
        tgt = list(lp.shape)
        tgt[axis] = 1
        return torch.take_along_dim(lp, idxp.expand(tgt), dim=axis)

    def enum_conditionals(uparams, rng_key=None, model_args=None,
                          model_kwargs=None, params=None):
        """``step(out, pos)``: the conditional logits (*site shape, K) of
        the ``pos``-th site of ``elim_order`` given the draws ``out`` of
        the sites before it (one replay for all of them), and the later
        sites of lower rank whose elimination summed its plate away
        (empty where the logits are the exact conditional)."""
        terms = _enum_terms(uparams, rng_key, None, model_args,
                            model_kwargs, params)
        # each term's scale applies up front (handlers.scale tempering
        # tempers the conditionals as it tempers the density); a
        # subsample-free model has no N/B plate scales left
        base = [(lp * s, 1.0) for lp, s, _ in terms]

        def step(out, pos):
            e = elim_order[pos]
            r_e = _rank(e)
            cur, coupled = list(base), []
            # index the sites already drawn at their draws
            for e2 in elim_order[:pos]:
                cur = [(_index_enum_axis(lp, e2, out[enum_names[e2]],
                                         _rank(e2)), s) for lp, s in cur]
            # eliminate the sites not yet drawn, in _eliminate's order
            for f in elim_order[pos + 1:]:
                involved = [t for t in cur if t[0].shape[f] != 1]
                if not involved:
                    continue
                if _rank(f) < r_e and any(t[0].shape[e] != 1
                                          for t in involved):
                    coupled.append(enum_names[f])
                rest = [t for t in cur if t[0].shape[f] == 1]
                involved = _plate_sum(involved, _rank(f))
                cur = rest + [(torch.logsumexp(_combine(involved), f,
                                               keepdim=True),
                               involved[0][1])]
            # the conditional logits over axis e (per plate element for a
            # batched site); the terms without e are constants
            logits = _combine(_plate_sum(
                [t for t in cur if t[0].shape[e] != 1], r_e))
            keep = (e,) + tuple(range(n_enum + pad_rank - r_e,
                                      n_enum + pad_rank))
            logits = logits.reshape(tuple(logits.shape[a] for a in keep))
            return torch.movedim(logits, 0, -1), coupled

        return step

    def sample_enum(uparams, rng_key=None, model_args=None,
                    model_kwargs=None, params=None, gumbels=None):
        """Joint posterior draw of every enumerated site given the
        continuous latents ``uparams``: ancestral sampling in the
        elimination order, each conditional obtained by indexing
        the sites already drawn and eliminating the rest.  The draw is
        the exact joint conditional except where a plate-local site is
        eliminated before a lower-rank site it interacts with: that
        site's plate is then summed away, which couples its elements (one
        assignment for the whole plate where its logits come out (1,
        K)), as in the JAX package (``require_exact_enum`` detects it;
        ``infer_discrete`` and ``DiscreteGibbs`` refuse such models).  A
        site's draw is the argmax of its logits (*site shape, K) plus
        Gumbel noise (what ``jax.random.categorical`` adds): when
        ``gumbels`` is given (randomness as an input) ``gumbels[name]`` of
        that shape, or ``gumbels(name, shape)`` if it is callable; else
        drawn from the ``torch.Generator`` ``rng_key`` site after site.
        Needs a subsample-free model: the conditionals under mini-batch
        scaling are not the true ones."""
        if not enum_names:
            return {}
        if info.subsample_sites:
            raise ValueError(
                "sample_enum requires a subsample-free model; rebuild the "
                "log-joint with full plates to recover discrete sites")
        step = enum_conditionals(uparams, rng_key, model_args, model_kwargs,
                                 params)
        out = {}
        for pos, e in enumerate(elim_order):
            name = enum_names[e]
            logits, _ = step(out, pos)
            if callable(gumbels):
                g = gumbels(name, tuple(logits.shape))
            elif gumbels is not None:
                # a scalar site eliminated after a plate-local one sums
                # the plate away (as in the JAX package), which leaves
                # size-1 plate dims: such logits take the leading noise
                g = gumbels[name][tuple(slice(0, n) for n in logits.shape)]
            else:
                u = torch.rand(logits.shape, generator=rng_key,
                               device=rng_key.device, dtype=logits.dtype)
                g = -torch.log(-torch.log(u))
            out[name] = torch.argmax(logits + g, -1).to(torch.int32)
        return out

    def require_exact_enum(uparams, who):
        """Raise a ``ValueError`` naming the sites where ``sample_enum``
        is not an exact joint conditional draw: a plate-local site
        eliminated before a lower-rank site it interacts with has its
        plate summed away in that site's elimination, which couples the
        plate's elements (the logits come out (1, K), one assignment for
        the whole plate, unless another term restores the plate dims), as
        in the JAX package; an exact draw needs the reverse order.  The
        answer depends on shapes only: any ``uparams`` will do."""
        step = enum_conditionals(uparams)
        out = {}
        for pos, e in enumerate(elim_order):
            name = enum_names[e]
            logits, coupled = step(out, pos)
            if coupled:
                raise ValueError(
                    f"{who} cannot draw the enumerated site {name!r} "
                    "exactly: it is eliminated before the lower-rank "
                    f"site(s) {coupled} it interacts with, which sum its "
                    "plate away and couple the plate's elements")
            out[name] = torch.zeros(logits.shape[:-1], dtype=torch.int32,
                                    device=logits.device)

    def logdensity_given_enum(uparams, enum_values, rng_key=None,
                              subsample=None, model_args=None,
                              model_kwargs=None, params=None):
        """Joint log-density with the enumerated sites conditioned at
        ``enum_values`` (int tensors in each site's natural shape) rather
        than marginalised: the density p(u, z, data) that NUTS within
        Gibbs (infer/mcmc/gibbs.py) alternates against.  One plain
        replay, no enumeration broadcast."""
        sub = dict(subsample or {})
        sub.update({n: torch.as_tensor(v).to(torch.int32)
                    for n, v in enum_values.items()})
        tr, _ = _replay(uparams, rng_key, sub, model_args, model_kwargs,
                        params)
        return _accumulate(tr, uparams)

    logdensity.parts = logdensity_parts
    logdensity.prior = logdensity_prior
    logdensity.sample_enum = sample_enum
    logdensity.require_exact_enum = require_exact_enum
    logdensity.given_enum = logdensity_given_enum
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
