"""Reparameterized ELBO estimator (single- or multi-particle, STL).

Counterpart of ``bayesic_tpu/infer/svi/elbo.py`` without IWAE and DReG.
The mini-batch scale factor lives in the log-joint (plate handler); this
module draws the shared mini-batch indices once per step so every particle
sees the same batch.  Sticking-the-landing (``stl=True``) detaches q's
parameters inside log q, which drops the score term of the gradient.
"""

from __future__ import annotations

import torch

__all__ = ["draw_subsample", "make_elbo"]


def draw_subsample(info, generator):
    """Draw one index array per subsampled plate (shared across particles),
    on the generator's device.  Honors the plate's ``replacement`` flag."""
    out = {}
    for name, (size, ssize, replacement) in sorted(
            info.subsample_sites.items()):
        if replacement:
            out[name] = torch.randint(0, size, (ssize,), generator=generator,
                                      device=generator.device)
        else:
            out[name] = torch.randperm(size, generator=generator,
                                       device=generator.device)[:ssize]
    return out


def make_elbo(logdensity, guide, num_particles=1, stl=True, info=None):
    """Returns ``elbo(params, generator, subsample=None, model_args=None,
    model_params=None, eps=None) -> scalar`` (a stochastic lower bound
    estimate; maximise it).  ``eps``, when given, reaches the guide as
    ``ctx["eps"]``: a guide that reads it uses that noise instead of
    drawing from ``generator``."""
    if num_particles < 1:
        raise ValueError("num_particles must be >= 1")

    def elbo(params, generator, subsample=None, model_args=None,
             model_params=None, eps=None):
        ctx = {"subsample": subsample, "model_args": model_args, "eps": eps}
        uparams, logq = guide.sample_and_log_prob(
            params, generator, (num_particles,), stop_gradient_q=stl,
            ctx=ctx)
        logp = torch.stack([
            logdensity({k: u[i] for k, u in uparams.items()},
                       subsample=subsample, model_args=model_args,
                       params=model_params)
            for i in range(num_particles)
        ])
        return torch.mean(logp - logq)

    return elbo
