"""Variational guides over a model's unconstrained latent space.

Counterpart of ``bayesic_tpu/infer/svi/guides.py``; the DLGM path needs the
interface and the amortized ``NeuralGuide``; ``MCMC`` needs ``unraveler``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["unraveler", "Guide", "NeuralGuide"]


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
