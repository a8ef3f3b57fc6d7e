"""Variational guides over a model's unconstrained latent space.

Counterpart of ``bayesic_tpu/infer/svi/guides.py``; the DLGM path needs the
interface and the amortized ``NeuralGuide``.
"""

from __future__ import annotations

__all__ = ["Guide", "NeuralGuide"]


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
