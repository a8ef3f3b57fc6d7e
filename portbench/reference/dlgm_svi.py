"""Plain reference of the DLGM's SVI step: the model, the amortized guide,
the stick-the-landing ELBO by autograd, and optax's Adam.

Model: z ~ N(0, I) (B, Z); x ~ N(tanh(z W1d + b1d) W2d + b2d, sigma^2),
sigma = exp(usig).  Guide: h = tanh(x W1e + b1e), q(z) = N(h Wmu + bmu,
exp(clip(h Wsig + bsig, -6, 3))^2).  Loss = -(N / B) [log p(z) + log p(x |
z) - log q(z)] on a batch of B rows drawn with replacement, z = mu + e^ls
eps, the guide's parameters stopped inside log q (stick the landing).
Parameters keep the (in, out) layout.  Float32 with TF32 off unless the
caller asks for the control's precision."""

from __future__ import annotations

import math

import torch

from .philox import vae_streams

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def neg_elbo(p, xb, eps, scale):
    h1 = torch.tanh(xb @ p["w1e"] + p["b1e"])
    mu = h1 @ p["wmu"] + p["bmu"]
    ls = torch.clamp(h1 @ p["wsig"] + p["bsig"], -6.0, 3.0)
    z = mu + torch.exp(ls) * eps
    mx = torch.tanh(z @ p["w1d"] + p["b1d"]) @ p["w2d"] + p["b2d"]
    usig = p["usig"][0, 0]
    log_prior = torch.sum(-0.5 * z * z - _HALF_LOG_2PI)
    r = (xb - mx) * torch.exp(-usig)
    log_lik = torch.sum(-0.5 * r * r - usig - _HALF_LOG_2PI)
    zq = (z - mu.detach()) * torch.exp(-ls.detach())
    log_q = torch.sum(-0.5 * zq * zq - ls.detach() - _HALF_LOG_2PI)
    return -scale * (log_prior + log_lik - log_q)


def train(x, params, *, seed, steps, lr, batch, m=None, v=None, t0=0,
          tf32=False):
    """``steps`` SVI steps from ``params`` and Adam's moments ``m``, ``v``
    (zero by default) after ``t0`` steps, on the trainer's streams of
    ``seed`` from step ``t0``.  Returns ``(losses (steps,), [params after
    each step], gradients of the first step)``, the gradients those of the
    loss as Adam receives them."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        n = x.shape[0]
        z = params["wmu"].shape[1]
        idx, eps = vae_streams(seed, t0, steps, batch, n, z, x.device)
        p = {k: val.detach().clone() for k, val in params.items()}
        m = {k: (torch.zeros_like(val) if m is None else m[k].clone())
             for k, val in p.items()}
        v = {k: (torch.zeros_like(val) if v is None else v[k].clone())
             for k, val in p.items()}
        losses, path, first = [], [], None
        for t in range(t0 + 1, t0 + steps + 1):
            leaves = {k: val.requires_grad_() for k, val in p.items()}
            loss = neg_elbo(leaves, x[idx[t - t0 - 1]], eps[t - t0 - 1],
                            n / batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            g = dict(zip(leaves, grads))
            if first is None:
                first = g
            losses.append(loss.detach())
            with torch.no_grad():
                bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
                for k in p:
                    m[k] = B1 * m[k] + (1.0 - B1) * g[k]
                    v[k] = B2 * v[k] + (1.0 - B2) * g[k] * g[k]
                    p[k] = p[k].detach() - lr * (m[k] / bc1) / (
                        torch.sqrt(v[k] / bc2) + ADAM_EPS)
            path.append({k: val.detach().clone() for k, val in p.items()})
        return torch.stack(losses), path, first
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
