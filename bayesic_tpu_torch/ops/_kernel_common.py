"""Plain PyTorch twins of the device helpers in ``csrc/kernel_common.cuh``.

Counterpart of ``bayesic_tpu/ops/_kernel_common.py``.  The TPU kernels draw
from the core PRNG; the Hopper kernels draw from Philox4x32-10 (Salmon et
al., SC'11), a counter-based generator, so every draw is a pure function of
``(seed, counter)``.  The functions here compute the same bits and the same
uniform/normal/Adam recipes on tensors, so a test can rebuild the kernel's
streams on any device and compare.

Counter layout of the fused DLGM trainer: ``(step_lo, row, lane,
step_hi)`` with key ``(seed_lo, seed_hi)``.  Lane 0 gives the row's
mini-batch index, lane ``1 + l`` the latent noise ``eps[row, l]``.

Counter layout of the fused hierarchical-logistic trainer
(``hier_streams``): one draw block per step, ``(step_lo, 0, lane,
step_hi)`` with the same key.  Lane 0 gives the step's circular block
offset ``min(floor(u n), n - 1)``, lane ``1 + p`` the noise ``eps[p]`` of
flat parameter ``p``: the DLGM layout with a single row.  The fused
linear-regression trainer reads the same streams (its lane 0 goes unused).

The whole-run trainers keep at most 2048 losses (``loss_thin``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["philox4x32_10", "uniform24", "kernel_uniform_index",
           "box_muller", "philox_streams", "hier_streams", "adam_leaf",
           "loss_thin", "thin_losses"]

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
LN_B1 = math.log(0.9)
LN_B2 = math.log(0.999)


def _mulhilo(m, a):
    """(hi, lo) 32-bit halves of the 64-bit product ``m * a`` for uint32
    values held in int64 tensors, split in 16-bit pieces so no partial
    product leaves the int64 range."""
    p_lo = m * (a & 0xFFFF)                  # < 2^48
    p_hi = m * (a >> 16)                     # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)       # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on broadcastable int64 tensors holding uint32 values.
    Returns the four output words (int64 tensors in [0, 2^32))."""
    c = [torch.as_tensor(v, dtype=torch.int64) for v in (c0, c1, c2, c3)]
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c


def uniform24(bits):
    """U[0,1) from the top 24 bits of a 32-bit word (as the TPU recipe)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def kernel_uniform_index(u, n):
    """Row index ``min(floor(u*n), n-1)`` of a with-replacement draw."""
    return torch.clamp((u * n).to(torch.int64), max=n - 1)


def box_muller(u1, u2):
    """One normal from two uniforms (u1 kept off zero), cosine branch."""
    u1 = torch.clamp(u1, min=1e-7)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * math.pi) * u2)


def philox_streams(seed, t0, steps, batch, n, z, device="cpu"):
    """The fused trainer's in-kernel streams for steps ``t0 .. t0+steps-1``:
    ``(idx (steps, batch) int64, eps (steps, batch, z) float32)``."""
    t = torch.arange(t0, t0 + steps, dtype=torch.int64,
                     device=device).view(-1, 1, 1)
    row = torch.arange(batch, dtype=torch.int64, device=device).view(1, -1, 1)
    lane = torch.arange(1 + z, dtype=torch.int64, device=device).view(1, 1, -1)
    seed = int(seed)
    w = philox4x32_10(t & _MASK32, row, lane, t >> 32,
                      seed & _MASK32, (seed >> 32) & _MASK32)
    idx = kernel_uniform_index(uniform24(w[0][:, :, 0]), n)
    eps = box_muller(uniform24(w[0][:, :, 1:]), uniform24(w[1][:, :, 1:]))
    return idx, eps


def hier_streams(seed, t0, steps, n, dim, device="cpu"):
    """The fused hier trainer's in-kernel streams for steps ``t0 ..
    t0+steps-1``: ``(off (steps,) int64, eps (steps, dim) float32)``."""
    off, eps = philox_streams(seed, t0, steps, 1, n, dim, device)
    return off[:, 0], eps[:, 0]


def adam_leaf(p, m, v, g, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam update for ONE leaf on loss = -elbo (g is d elbo, so
    descend on -g), with the bias correction ``1 - exp(t ln b)`` that the
    kernels use.  ``t`` is the 1-based global step."""
    bc1 = 1.0 - math.exp(float(t) * math.log(b1))
    bc2 = 1.0 - math.exp(float(t) * math.log(b2))
    g = -g
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return p - lr * upd, m, v


def loss_thin(steps):
    """Loss-trace thinning of the JAX whole-run kernels: at most 2048
    entries; entry k holds the loss of the last step i with i // thin ==
    k."""
    return -(-steps // min(steps, 2048))


def thin_losses(losses, steps):
    """The per-step ``losses`` (steps,) thinned as the kernels write them."""
    thin = loss_thin(steps)
    keep = torch.clamp(torch.arange(-(-steps // thin)) * thin + thin - 1,
                       max=steps - 1)
    return losses[keep.to(losses.device)]
