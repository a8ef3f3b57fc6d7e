"""Normalizing-flow variational guide (inverse autoregressive flow).

Counterpart of ``bayesic_tpu/infer/svi/flows.py``: q(u) is a
diagonal-Gaussian base pushed through a stack of gated IAF layers (Kingma
et al. 2016) with MADE-masked (Germain et al. 2015) MLP conditioners.
Sampling and the density at the guide's own samples both run the forward
(parallel) direction: one masked product per conditioner layer.

Layer k (u is the running vector, flipped before and after odd layers):

    (m, s) = MADE_k(u)          # s_j, m_j depend only on u_{<j}
    g      = sigmoid(s + 2)     # +2: near-identity init (g ~ 0.88)
    u      = g * u + (1 - g) * m
    logdet += sum(log g)

log q(u_K) = log N(eps; 0, I) - sum(base log_scale) - sum_k logdet_k.

``FlowGuide(..., stl=True)`` evaluates log q at the sample with the
params detached, through the sequential inverse (``log_prob_at``: dim
conditioner passes a layer); the value is unchanged and only the gradient
differs.  With ``stl=False`` (the default) ``stop_gradient_q`` is ignored.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .guides import _LOG_2PI, Guide, unraveler
from .svi import tree_map

__all__ = ["FlowGuide"]


def _made_masks(dim, hidden):
    """MADE masks for the conditioner dim -> hidden... -> 2*dim, as numpy
    float32: input degrees 1..D, hidden degrees cycling 1..max(D-1, 1);
    output j may depend on inputs of degree < j + 1 (strict), for both the
    m and s heads.  Returns ([W masks], out_mask (h_last, 2 dim))."""
    d_in = np.arange(1, dim + 1)
    masks = []
    prev = d_in
    for h in hidden:
        d_h = (np.arange(h) % max(dim - 1, 1)) + 1
        masks.append((d_h[None, :] >= prev[:, None]).astype(np.float32))
        prev = d_h
    out_mask = (d_in[None, None, :] > prev[:, None, None]).astype(np.float32)
    out_mask = np.broadcast_to(out_mask, (len(prev), 2, dim))
    return masks, out_mask.reshape(len(prev), 2 * dim)


class FlowGuide(Guide):
    """``FlowGuide(info, num_flows=2, hidden=(64, 64))``: an IAF posterior.
    Params: ``{"loc", "log_scale", "flows": [layer dicts with w{i}, b{i},
    w_out, b_out]}``, kernels (in, out) as in the JAX package.

    ``stats(params, generator, num_draws)`` is Monte Carlo (the
    pushforward has no closed-form moments)."""

    def __init__(self, info, num_flows=2, hidden=(64, 64), init_scale=0.1,
                 stl=False):
        self.dim, self.unravel, self.ravel = unraveler(info)
        self.num_flows = int(num_flows)
        self.hidden = tuple(int(h) for h in hidden)
        self.init_scale = float(init_scale)
        self.stl = bool(stl)
        self._masks_np, self._out_mask_np = _made_masks(self.dim,
                                                        self.hidden)
        self._mask_cache = {}

    def _masks(self, like):
        """The masks as tensors of ``like``'s dtype and device."""
        key = (like.dtype, like.device)
        if key not in self._mask_cache:
            conv = lambda a: torch.as_tensor(  # noqa: E731
                np.ascontiguousarray(a), dtype=like.dtype,
                device=like.device)
            self._mask_cache[key] = ([conv(m) for m in self._masks_np],
                                     conv(self._out_mask_np))
        return self._mask_cache[key]

    # ------------------------------------------------------------------
    def init(self, generator, loc=None):
        """Hidden kernels N(0, 1/fan_in) from ``generator`` (layer by layer,
        in order), zero biases, and a zero output head: every flow starts
        at (m = 0, s = 0), u <- sigmoid(2) u."""
        device = generator.device
        if loc is None:
            loc = torch.zeros(self.dim, device=device)
        elif isinstance(loc, dict):
            loc = self.ravel(loc)
        flows = []
        widths = (self.dim,) + self.hidden
        for _ in range(self.num_flows):
            layer = {}
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
                layer[f"w{i}"] = torch.randn(
                    (a, b), generator=generator, device=device) / math.sqrt(a)
                layer[f"b{i}"] = torch.zeros(b, device=device)
            layer["w_out"] = torch.zeros((widths[-1], 2 * self.dim),
                                         device=device)
            layer["b_out"] = torch.zeros(2 * self.dim, device=device)
            flows.append(layer)
        return {"loc": torch.as_tensor(loc, dtype=torch.float32,
                                       device=device),
                "log_scale": torch.full((self.dim,),
                                        math.log(self.init_scale),
                                        device=device),
                "flows": flows}

    def _conditioner(self, layer, u):
        masks, out_mask = self._masks(u)
        h = u
        for i, mask in enumerate(masks):
            h = torch.tanh(h @ (layer[f"w{i}"] * mask) + layer[f"b{i}"])
        out = h @ (layer["w_out"] * out_mask) + layer["b_out"]
        return out[..., :self.dim], out[..., self.dim:]

    def _push(self, params, eps):
        """Base sample + flow stack: eps (..., dim) -> (u, logq)."""
        u = params["loc"] + torch.exp(params["log_scale"]) * eps
        logq = torch.sum(-0.5 * eps * eps - 0.5 * _LOG_2PI
                         - params["log_scale"], -1)
        for k, layer in enumerate(params["flows"]):
            if k % 2 == 1:
                u = torch.flip(u, (-1,))
            m, s = self._conditioner(layer, u)
            g = torch.sigmoid(s + 2.0)
            u = g * u + (1.0 - g) * m
            logq = logq - torch.sum(torch.log(g), -1)
            if k % 2 == 1:
                u = torch.flip(u, (-1,))
        return u, logq

    def _inverse_layer(self, layer, y):
        """Invert one gated-IAF layer: solve u from y = g(u) u + (1 - g(u))
        m(u) one coordinate after another.  The conditioner is strictly
        autoregressive, so once u_{<j} is known (m_j, s_j) are exact and
        u_j has a closed form."""
        u = torch.zeros_like(y)
        eye = torch.eye(self.dim, dtype=y.dtype, device=y.device)
        for j in range(self.dim):
            m, s = self._conditioner(layer, u)
            g = torch.sigmoid(s + 2.0)
            uj = (y[..., j] - (1.0 - g[..., j]) * m[..., j]) / g[..., j]
            oh = eye[j]
            u = u * (1.0 - oh) + uj[..., None] * oh
        return u

    def log_prob_at(self, params, u):
        """log q_params(u) at any point, through the sequential inverse (the
        STL path; also for diagnostics)."""
        logdet = 0.0
        for k in range(self.num_flows - 1, -1, -1):
            layer = params["flows"][k]
            if k % 2 == 1:
                u = torch.flip(u, (-1,))
            u = self._inverse_layer(layer, u)
            m, s = self._conditioner(layer, u)
            g = torch.sigmoid(s + 2.0)
            logdet = logdet + torch.sum(torch.log(g), -1)
            if k % 2 == 1:
                u = torch.flip(u, (-1,))
        eps = (u - params["loc"]) * torch.exp(-params["log_scale"])
        return torch.sum(-0.5 * eps * eps - 0.5 * _LOG_2PI
                         - params["log_scale"], -1) - logdet

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        shape = tuple(sample_shape) + (self.dim,)
        eps = (ctx or {}).get("eps")
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=generator.device,
                              dtype=params["loc"].dtype)
        else:
            eps = eps.expand(shape)
        flat, logq = self._push(params, eps)
        if stop_gradient_q and self.stl:
            # STL: log q at the sample with the params detached; the
            # inverse at the same values recovers eps, so only the
            # gradient differs from _push's logq
            logq = self.log_prob_at(tree_map(torch.Tensor.detach, params),
                                    flat)
        return self.unravel(flat), logq

    # ------------------------------------------------------------------
    def stats(self, params, generator=None, num_draws=4096):
        """Monte-Carlo unconstrained mean/std per site (``generator``: a
        generator on the params' device; one seeded with 0 if None)."""
        if generator is None:
            generator = torch.Generator(
                params["loc"].device).manual_seed(0)
        eps = torch.randn((int(num_draws), self.dim), generator=generator,
                          device=generator.device, dtype=params["loc"].dtype)
        flat, _ = self._push(params, eps)
        return (self.unravel(torch.mean(flat, 0)),
                self.unravel(torch.std(flat, 0, unbiased=False)))
