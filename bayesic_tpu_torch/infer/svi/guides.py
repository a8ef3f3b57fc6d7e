"""Variational guides over a model's unconstrained latent space.

Counterpart of ``bayesic_tpu/infer/svi/guides.py``; the DLGM path needs the
interface and the amortized ``NeuralGuide``, the hierarchical-logistic path
the ``MeanFieldGuide``, the linear regression also the ``FullRankGuide``;
``MCMC`` needs ``unraveler``.
"""

from __future__ import annotations

import math

import torch

from ...dist.transforms import LowerCholeskyTransform

__all__ = ["unraveler", "Guide", "MeanFieldGuide", "FullRankGuide",
           "NeuralGuide"]

_LOG_2PI = math.log(2.0 * math.pi)


def unraveler(info):
    """(dim, unravel, ravel) for ``info.unconstrained_shapes``; ``unravel``
    and ``ravel`` keep any leading batch dims of their input."""
    names = list(info.latent_names)
    shapes = [tuple(info.unconstrained_shapes[n]) for n in names]
    sizes = [math.prod(s) for s in shapes]
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    dim = offsets[-1]

    def unravel(flat):
        batch = tuple(flat.shape[:-1])
        return {
            n: flat[..., o:o + s].reshape(batch + shape)
            for n, o, s, shape in zip(names, offsets, sizes, shapes)
        }

    def ravel(uparams):
        some = uparams[names[0]]
        batch = tuple(some.shape[:some.dim() - len(shapes[0])])
        return torch.cat(
            [uparams[n].reshape(batch + (s,)) for n, s in zip(names, sizes)],
            dim=-1,
        )

    return dim, unravel, ravel


class Guide:
    """Interface: ``init(generator) -> params``;
    ``sample_and_log_prob(params, generator, sample_shape) -> (uparams dict
    with leading sample dims, logq)``."""

    def init(self, generator):
        raise NotImplementedError

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        """``ctx`` (optional dict with keys ``subsample``/``model_args``/
        ``eps``) carries the per-step mini-batch context so amortized guides
        can encode the same batch the model sees; ``eps``, when not None,
        is noise injected in place of draws from ``generator``."""
        raise NotImplementedError


class MeanFieldGuide(Guide):
    """Diagonal Gaussian q(u) = N(loc, diag(exp(log_scale))^2) over the flat
    unconstrained vector (``unraveler`` order)."""

    def __init__(self, info, init_scale=0.1):
        self.dim, self.unravel, self.ravel = unraveler(info)
        self.init_scale = float(init_scale)

    def init(self, generator, loc=None):
        """``loc`` 0 unless given (a flat vector or a dict of sites);
        ``log_scale`` log(init_scale).  Draws nothing; the params land on
        the generator's device."""
        device = generator.device
        if loc is None:
            loc = torch.zeros(self.dim, device=device)
        elif isinstance(loc, dict):
            loc = self.ravel(loc)
        return {"loc": torch.as_tensor(loc, dtype=torch.float32,
                                       device=device),
                "log_scale": torch.full((self.dim,),
                                        math.log(self.init_scale),
                                        device=device)}

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        shape = tuple(sample_shape) + (self.dim,)
        eps = (ctx or {}).get("eps")
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=generator.device)
        else:
            eps = eps.expand(shape)
        flat = params["loc"] + torch.exp(params["log_scale"]) * eps
        loc, ls = params["loc"], params["log_scale"]
        if stop_gradient_q:
            loc, ls = loc.detach(), ls.detach()
        z = (flat - loc) * torch.exp(-ls)
        logq = torch.sum(-0.5 * z * z - ls - 0.5 * _LOG_2PI, -1)
        return self.unravel(flat), logq

    def entropy(self, params):
        return torch.sum(params["log_scale"]) \
            + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def stats(self, params):
        """Unconstrained-space posterior mean/std per site."""
        return (self.unravel(params["loc"]),
                self.unravel(torch.exp(params["log_scale"])))


class FullRankGuide(Guide):
    """Full-covariance Gaussian q(u) = N(loc, L L^T) over the flat
    unconstrained vector, L from a packed lower-Cholesky vector with a
    log diagonal (``LowerCholeskyTransform``)."""

    def __init__(self, info, init_scale=0.1):
        self.dim, self.unravel, self.ravel = unraveler(info)
        self.init_scale = float(init_scale)
        self._tril = LowerCholeskyTransform()
        self._nvec = self.dim * (self.dim + 1) // 2

    def init(self, generator, loc=None):
        """``loc`` 0 unless given (a flat vector or a dict of sites); the
        packed L has diagonal log(init_scale) and zeros elsewhere.  Draws
        nothing; the params land on the generator's device."""
        device = generator.device
        if loc is None:
            loc = torch.zeros(self.dim, device=device)
        elif isinstance(loc, dict):
            loc = self.ravel(loc)
        vec = torch.zeros(self._nvec, device=device)
        pos = [k * (k + 1) // 2 + k for k in range(self.dim)]
        vec[pos] = math.log(self.init_scale)
        return {"loc": torch.as_tensor(loc, dtype=torch.float32,
                                       device=device),
                "scale_tril_vec": vec}

    def _chol(self, params):
        return self._tril.forward(params["scale_tril_vec"])

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        shape = tuple(sample_shape) + (self.dim,)
        eps = (ctx or {}).get("eps")
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=generator.device)
        else:
            eps = eps.expand(shape)
        flat = params["loc"] + eps @ self._chol(params).T
        loc, vec = params["loc"], params["scale_tril_vec"]
        if stop_gradient_q:
            loc, vec = loc.detach(), vec.detach()
        q_chol = self._tril.forward(vec)
        diff = flat - loc
        z = torch.linalg.solve_triangular(
            q_chol.expand(diff.shape[:-1] + q_chol.shape), diff[..., None],
            upper=False)[..., 0]
        half_logdet = torch.sum(torch.log(torch.diagonal(q_chol)))
        logq = (-0.5 * torch.sum(z * z, -1) - half_logdet
                - 0.5 * self.dim * _LOG_2PI)
        return self.unravel(flat), logq

    def entropy(self, params):
        return torch.sum(torch.log(torch.diagonal(self._chol(params)))) \
            + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def stats(self, params):
        """Unconstrained-space posterior mean/std per site."""
        chol = self._chol(params)
        std = torch.sqrt(torch.sum(chol * chol, -1))
        return self.unravel(params["loc"]), self.unravel(std)

    def covariance(self, params):
        chol = self._chol(params)
        return chol @ chol.T


class NeuralGuide(Guide):
    """Adapter for amortized guides: the user supplies
    ``init_fn(generator) -> params`` and ``sample_fn(params, generator,
    sample_shape, stop_gradient_q, ctx) -> (uparams, logq)`` (typically an
    encoder ``nn.Module`` applied with ``torch.func.functional_call``)."""

    def __init__(self, init_fn, sample_fn):
        self._init_fn = init_fn
        self._sample_fn = sample_fn

    def init(self, generator):
        return self._init_fn(generator)

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        return self._sample_fn(params, generator, sample_shape,
                               stop_gradient_q, ctx)
