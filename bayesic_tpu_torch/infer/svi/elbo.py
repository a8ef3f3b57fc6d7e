"""Reparameterized ELBO estimators (single- or multi-particle, STL, IWAE,
DReG).

Counterpart of ``bayesic_tpu/infer/svi/elbo.py``.  The mini-batch scale
factor lives in the log-joint (plate handler); this module draws the shared
mini-batch indices once per step so every particle sees the same batch.
Sticking-the-landing (``stl=True``) detaches q's parameters inside log q,
which drops the score term of the gradient.  ``.detach()`` stands where the
JAX package calls ``jax.lax.stop_gradient``, and nowhere else.
"""

from __future__ import annotations

import math

import torch

__all__ = ["draw_subsample", "make_elbo"]


def draw_subsample(info, generator, uniforms=None):
    """Draw one index array per subsampled plate (shared across particles),
    on the generator's device.  Honors the plate's ``replacement`` flag.

    ``uniforms`` (a dict plate -> (..., n) open uniforms, as
    ``infer.mcmc.streams.subsample_uniforms`` draws them) takes the place
    of the generator: each leading index gets its own mini-batch,
    ``floor(u * size)`` with replacement (n the subsample size), else the
    first ``subsample size`` places of the uniforms' sort order (n the
    plate size, a uniform permutation)."""
    out = {}
    for name, (size, ssize, replacement) in sorted(
            info.subsample_sites.items()):
        if uniforms is not None:
            u = uniforms[name]
            out[name] = torch.clamp((u * size).long(), max=size - 1) \
                if replacement else torch.argsort(u, -1)[..., :ssize]
        elif replacement:
            out[name] = torch.randint(0, size, (ssize,), generator=generator,
                                      device=generator.device)
        else:
            out[name] = torch.randperm(size, generator=generator,
                                       device=generator.device)[:ssize]
    return out


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def make_elbo(logdensity, guide, num_particles=1, stl=True, info=None,
              iwae=False, dreg=False):
    """Returns ``elbo(params, generator, subsample=None, model_args=None,
    model_params=None, eps=None) -> scalar`` (a stochastic lower bound
    estimate; maximise it).  ``eps``, when given, reaches the guide as
    ``ctx["eps"]``: a guide that reads it uses that noise instead of
    drawing from ``generator``.

    ``iwae=True`` returns the importance-weighted bound
    ``logsumexp_k(log p - log q) - log K`` (Burda et al. 2016), with the
    total-derivative gradient; sticking-the-landing is off then (dropping
    the score term is unbiased only for the K = 1 bound).

    ``dreg=True`` (with ``iwae=True``) keeps that value and switches to the
    doubly-reparameterized gradient (Tucker et al. 2019): guide-parameter
    gradients are path-only with weights w~^2, model-parameter gradients
    keep weights w~ (w~ the normalized importance weights)."""
    if num_particles < 1:
        raise ValueError("num_particles must be >= 1")
    if iwae and num_particles < 2:
        raise ValueError("iwae=True needs num_particles >= 2")
    if dreg and not iwae:
        raise ValueError("dreg=True requires iwae=True")
    log_k = math.log(num_particles)

    def elbo(params, generator, subsample=None, model_args=None,
             model_params=None, eps=None):
        ctx = {"subsample": subsample, "model_args": model_args, "eps": eps}
        uparams, logq = guide.sample_and_log_prob(
            params, generator, (num_particles,),
            stop_gradient_q=(stl and not iwae) or dreg, ctx=ctx)

        def logp_of(mp):
            return torch.stack([
                logdensity({k: u[i] for k, u in uparams.items()},
                           subsample=subsample, model_args=model_args,
                           params=mp)
                for i in range(num_particles)
            ])

        logw = logp_of(model_params) - logq   # dreg: q's params stopped
        if iwae and dreg:
            w_tilde = torch.softmax(logw.detach(), dim=0)
            if model_params is not None:
                # z-path-only copy: the model's params stopped, so the
                # w~^2 - w~ correction gives them no gradient
                logw_path = logp_of(_detach(model_params)) - logq
            else:
                logw_path = logw
            surrogate = torch.sum(w_tilde * logw
                                  + (w_tilde ** 2 - w_tilde) * logw_path)
            value = torch.logsumexp(logw.detach(), dim=0) - log_k
            return value + surrogate - surrogate.detach()
        if iwae:
            return torch.logsumexp(logw, dim=0) - log_k
        return torch.mean(logw)

    return elbo
