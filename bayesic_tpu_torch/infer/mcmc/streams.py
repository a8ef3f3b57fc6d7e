"""Per-chain random streams keyed by logical chain index.

The JAX ``MCMC`` folds the logical chain index into every key
(``bayesic_tpu/infer/mcmc/mcmc.py``), so neither the chain count nor any
blocking of the chains changes a chain's draws.  Here every draw is one
Philox4x32-10 word block (``ops/_kernel_common.philox4x32_10``) with

    counter = (t, chain, lane, phase << 8 | kind),  key = seed,

where ``phase`` is init, warmup or sample, ``t`` the transition's absolute
step in that phase, and ``kind`` names the stream (momentum, doubling
directions, merge and leaf uniforms, init uniforms; the other samplers'
streams from ``ESS_NU`` on, a subsampled plate's from ``SUBSAMPLE``).
Chain c's draws are therefore a function of ``(seed, phase, t, c)``
alone.  The words are
computed with torch integer ops on the chains' device.

Uniforms are ``((bits >> 9) + 0.5) / 2^23``: strictly inside (0, 1) in
float32 (24 bits would round the largest to 1.0), so their logs are finite
and strictly negative (the JAX package clamps at 1e-38 for the same
reason).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...ops._kernel_common import philox4x32_10, uniform24

__all__ = ["StreamKey", "NUTSStreams", "INIT", "WARMUP", "SAMPLE",
           "open_uniform", "init_uniforms", "nuts_streams", "uniforms",
           "normals", "gumbels", "subsample_uniforms"]

INIT, WARMUP, SAMPLE = 0, 1, 2
_MOMENTUM, _DIRECTION, _MERGE, _LEAF, _INIT = range(5)
# the streams of elliptical slice, tempering, SG-MCMC, SVGD and the
# enumerated sites' draws; a subsampled plate i draws kind SUBSAMPLE + i
(ESS_NU, ESS_SLICE, ESS_ANGLE, ESS_SHRINK, PT_MOMENTUM, PT_ACCEPT, PT_SWAP,
 SG_NOISE, GUMBEL) = range(5, 14)
SUBSAMPLE = 32
_MASK32 = 0xFFFFFFFF


class StreamKey(NamedTuple):
    """Names the draws of one transition (or of the init, t = 0)."""

    seed: int
    phase: int
    t: int


class NUTSStreams(NamedTuple):
    """The pre-drawn randomness of one NUTS/HMC transition, per chain."""

    mom: torch.Tensor         # (C, D) standard normals
    sign_dir: torch.Tensor    # (C, K) exactly +-1
    log_u_acc: torch.Tensor   # (C, K) strictly negative
    log_u_leaf: torch.Tensor  # (C, 2**K) strictly negative


def open_uniform(bits):
    """U(0, 1) from the top 23 bits of a word, never 0 and never 1."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def _words(key: StreamKey, chains, lanes, kinds):
    seed = int(key.seed)
    c3 = (int(key.phase) << 8) | kinds
    return philox4x32_10(int(key.t) & _MASK32, chains[:, None],
                         lanes[None, :], c3[None, :], seed & _MASK32,
                         (seed >> 32) & _MASK32)


def _chains(chains, device):
    if isinstance(chains, int):
        return torch.arange(chains, dtype=torch.int64, device=device)
    return torch.as_tensor(chains, dtype=torch.int64, device=device)


def init_uniforms(key: StreamKey, chains, dim, device="cpu"):
    """(C, dim) open uniforms for the chains' initial points."""
    chains = _chains(chains, device)
    lanes = torch.arange(dim, dtype=torch.int64, device=device)
    w = _words(key, chains, lanes, torch.full_like(lanes, _INIT))
    return open_uniform(w[0])


def nuts_streams(key: StreamKey, chains, dim, max_doublings,
                 device="cpu") -> NUTSStreams:
    """Every draw of one transition for ``chains`` (a count, meaning
    0..count-1, or a tensor of logical indices): momentum normals (D
    lanes), direction signs and merge uniforms (K lanes each) and leaf
    uniforms (2^K lanes), from one Philox evaluation."""
    chains = _chains(chains, device)
    k, n_leaf = int(max_doublings), 1 << int(max_doublings)
    sizes = (dim, k, k, n_leaf)
    lanes = torch.cat([torch.arange(s, dtype=torch.int64, device=device)
                       for s in sizes])
    kinds = torch.cat([torch.full((s,), kind, dtype=torch.int64,
                                  device=device)
                       for s, kind in zip(sizes, (_MOMENTUM, _DIRECTION,
                                                  _MERGE, _LEAF))])
    w0, w1, _, _ = _words(key, chains, lanes, kinds)
    m_w0, d_w0, a_w0, l_w0 = torch.split(w0, sizes, dim=1)
    # Box-Muller, cosine branch, on an open u1
    mom = torch.sqrt(-2.0 * torch.log(open_uniform(m_w0))) * torch.cos(
        (2.0 * math.pi) * uniform24(w1[:, :dim]))
    sign_dir = torch.where((d_w0 >> 31) == 1, 1.0, -1.0)
    return NUTSStreams(mom, sign_dir, torch.log(open_uniform(a_w0)),
                       torch.log(open_uniform(l_w0)))


def uniforms(key: StreamKey, chains, n, kind, device="cpu"):
    """(C, n) open uniforms of the stream ``kind``, lanes 0..n-1."""
    chains = _chains(chains, device)
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    return open_uniform(_words(key, chains, lanes,
                               torch.full_like(lanes, kind))[0])


def normals(key: StreamKey, chains, n, kind, device="cpu"):
    """(C, n) standard normals of the stream ``kind`` (Box-Muller, cosine
    branch, on an open u1, as the momenta)."""
    chains = _chains(chains, device)
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    w0, w1, _, _ = _words(key, chains, lanes, torch.full_like(lanes, kind))
    return torch.sqrt(-2.0 * torch.log(open_uniform(w0))) * torch.cos(
        (2.0 * math.pi) * uniform24(w1))


def gumbels(key: StreamKey, chains, n, kind=GUMBEL, device="cpu"):
    """(C, n) standard Gumbel draws -log(-log u) of the stream ``kind``."""
    return -torch.log(-torch.log(uniforms(key, chains, n, kind, device)))


def subsample_uniforms(info, key: StreamKey, chains, device="cpu"):
    """The uniforms ``svi.elbo.draw_subsample`` turns into each chain's
    mini-batch indices: per subsampled plate (sorted by name, the i-th
    drawing kind SUBSAMPLE + i), (C, subsample size) with replacement,
    else (C, plate size)."""
    out = {}
    for i, (name, (size, ssize, replacement)) in enumerate(
            sorted(info.subsample_sites.items())):
        out[name] = uniforms(key, chains, ssize if replacement else size,
                             SUBSAMPLE + i, device)
    return out
