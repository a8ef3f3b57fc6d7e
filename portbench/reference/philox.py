"""Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
values, and the float recipes the port's kernels document for their
in-kernel streams.  The references rebuild the program's random streams
from the seed with these, so they judge the same draws the program made.

* The fused DLGM trainer: counter ``(step_lo, row, lane, step_hi)``, key
  ``(seed_lo, seed_hi)``; lane 0 gives the row's mini-batch index
  ``min(floor(u24 n), n - 1)``, lane ``1 + l`` the noise of latent ``l``
  by Box-Muller (cosine branch) on word 0 and word 1.
* NUTS: counter ``(t, chain, lane, phase << 8 | kind)``, key the seed;
  momenta by Box-Muller on an open uniform of word 0 and a 24-bit uniform
  of word 1; directions from word 0's top bit; log-uniforms of open
  uniforms; the chains' initial points from open uniforms of word 0 at
  phase 0, step 0, kind 4.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m, a):
    p_lo = m * (a & 0xFFFF)
    p_hi = m * (a >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox(c0, c1, c2, c3, key):
    """The four output words of Philox4x32-10 at broadcastable counters,
    with the 64-bit ``key``."""
    c = [torch.as_tensor(v, dtype=torch.int64) for v in (c0, c1, c2, c3)]
    k0, k1 = int(key) & MASK32, (int(key) >> 32) & MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
    return c


def u24(bits):
    """[0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def open_u23(bits):
    """(0, 1) from the top 23 bits, never 0 and never 1."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def vae_streams(seed, t0, steps, batch, n, z, device):
    """The fused DLGM trainer's draws for steps ``t0 .. t0 + steps - 1``:
    ``(idx (steps, batch) int64, eps (steps, batch, z) float32)``."""
    t = torch.arange(t0, t0 + steps, dtype=torch.int64,
                     device=device).view(-1, 1, 1)
    row = torch.arange(batch, dtype=torch.int64, device=device).view(1, -1, 1)
    lane = torch.arange(1 + z, dtype=torch.int64, device=device).view(1, 1, -1)
    w = philox(t & MASK32, row, lane, t >> 32, seed)
    idx = torch.clamp((u24(w[0][:, :, 0]) * n).to(torch.int64), max=n - 1)
    u1 = torch.clamp(u24(w[0][:, :, 1:]), min=1e-7)
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * math.pi) * u24(w[1][:, :, 1:]))
    return idx, eps


_MOMENTUM, _DIRECTION, _MERGE, _LEAF, _INIT = range(5)


def nuts_streams(seed, phase, t, chains, dim, depth, device):
    """One NUTS transition's draws for logical ``chains`` (int64 (C,)) at
    the per-chain steps ``t`` ((C,) or a number): momenta (C, dim),
    direction signs (C, depth), merge and leaf log-uniforms (C, depth),
    (C, 2^depth)."""
    chains = torch.as_tensor(chains, dtype=torch.int64, device=device)
    t = torch.as_tensor(t, dtype=torch.int64, device=device)
    t = t.expand(chains.shape)[:, None]
    sizes = (dim, depth, depth, 1 << depth)
    lanes = torch.cat([torch.arange(s, dtype=torch.int64, device=device)
                       for s in sizes])
    kinds = torch.cat([torch.full((s,), k, dtype=torch.int64, device=device)
                       for s, k in zip(sizes, (_MOMENTUM, _DIRECTION,
                                               _MERGE, _LEAF))])
    w0, w1, _, _ = philox(t & MASK32, chains[:, None], lanes[None, :],
                          ((int(phase) << 8) | kinds)[None, :], seed)
    m0, d0, a0, l0 = torch.split(w0, sizes, dim=1)
    mom = torch.sqrt(-2.0 * torch.log(open_u23(m0))) * torch.cos(
        (2.0 * math.pi) * u24(w1[:, :dim]))
    sign = torch.where((d0 >> 31) == 1, 1.0, -1.0)
    return mom, sign, torch.log(open_u23(a0)), torch.log(open_u23(l0))


def init_uniforms(seed, chains, dim, device):
    """The open uniforms (C, dim) that the chains' initial points are
    drawn from, for logical ``chains`` (int64 (C,))."""
    chains = torch.as_tensor(chains, dtype=torch.int64, device=device)
    lanes = torch.arange(dim, dtype=torch.int64, device=device)
    w0 = philox(0, chains[:, None], lanes[None, :], _INIT, seed)[0]
    return open_u23(w0)
