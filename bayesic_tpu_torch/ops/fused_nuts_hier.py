"""Fused NUTS transition for the hierarchical-logistic posterior: one launch
runs a whole NUTS transition for every chain.

Counterpart of ``bayesic_tpu/ops/fused_nuts_hier.py``.  The workload is the
full-batch centered model of ``models/hier_logistic.py``: per chain the
D = 2 + J + F dims (mu, log tau, theta[J], beta[F]) under a Bernoulli
likelihood of N rows,

    pe(q) = mu^2/50 + tau^2/8 + (J-1) log tau + |theta - mu|^2/(2 tau^2)
            + |beta|^2/2 + sum_n softplus(l_n) - y_n l_n + const,
    l_n = theta[g_n] + x_n . beta.

On a CUDA tensor ``fused_hier_nuts_transition`` runs the hand-written
kernel (``csrc/fused_nuts_hier.cu``, the tree of ``csrc/nuts_tree.cuh``);
on a CPU tensor the plain version, ``reference_transition``: the port's
one NUTS core (``infer/mcmc/nuts.nuts_core``) over ``hier_potential``.
Nothing falls back: on a CUDA tensor the kernel runs or the call raises.
As in ``ops/fused_nuts.py``, ``fused_hier_nuts_transition`` takes the
pre-drawn streams (the parity entry) and
``fused_hier_nuts_transition_keyed`` a ``StreamKey``, from which the
kernel makes the same draws as ``nuts_streams`` (``csrc/nuts_draws.cuh``):
what ``make_batched_transition_hier`` runs.

The rows are sorted by group once (``hier_data``), which leaves the
likelihood unchanged, and laid out there for the kernel: cut into chunks
of at most ``depth`` rows that never cross a group (``_chunk_counts``),
their count padded to a multiple of B = ``CHUNK_THREADS``; chunk
c = m B + t holds its row i at position (m depth + i) B + t, x as
``xc[m, i, :, t]`` and y as one bit a position (the kernel copies both
into shared memory where they fit; ``csrc/fused_nuts_hier.cu`` says
why).  The JAX package's 128-lane padding with auxiliary dims
redrawn every transition, its design matrix and its bf16 splits are TPU
workarounds and are not ported: the chains carry the real D dims, so the
U-turn statistic covers every dim (the JAX ``turn_mask`` does the same for
its real lanes), and every product is fp32.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..infer.mcmc.integrators import IntegratorState
from ..infer.mcmc.nuts import NUTSInfo, nuts_core
from ..infer.mcmc.streams import NUTSStreams, nuts_streams
from . import _build
from .fused_nuts import (_call_transition, _check_rows, _check_state,
                         _doublings, _key_words, _ptr, _raise, _stream)

__all__ = ["HierData", "hier_data", "hier_potential", "reference_transition",
           "fused_hier_nuts_potential", "fused_hier_nuts_transition",
           "fused_hier_nuts_transition_keyed", "make_batched_transition_hier",
           "hier_geometry", "MAX_FEATURES", "CHUNK_THREADS"]

_LOG_2PI = math.log(2.0 * math.pi)
MAX_FEATURES = 8        # MAXF of csrc/fused_nuts_hier.cu
CHUNK_THREADS = 1024    # chunks a block of the layout holds (kChunkBlock)
THREADS = 512           # threads a block of the kernel (kHierThreads)

# launches of the transition kernel (either entry); one launch is one NUTS
# transition of every chain
LAUNCHES = 0


class HierData(NamedTuple):
    """The likelihood's rows, sorted by group, and the kernel's layout of
    them (``hier_data``)."""

    x: torch.Tensor        # (N, F) float32
    y: torch.Tensor        # (N,) float32, 0/1
    group: torch.Tensor    # (N,) int64, non-decreasing
    offsets: torch.Tensor  # (J+1,) int32: group j holds rows off[j]..off[j+1]
    xc: torch.Tensor       # (nch // B, depth, F, B) float32: x of row i of
    #                        chunk m B + t at [m, i, :, t]
    ybits: torch.Tensor    # (depth * nch // 32,) int32: bit p % 32 of word
    #                        p // 32 is y at position p = (m depth + i) B + t
    chunks: torch.Tensor   # (3, nch) int32: first row, rows and group of
    #                        each chunk; nch a multiple of B, the chunks past
    #                        the last group's empty
    chunk_off: torch.Tensor  # (J+1,) int32: group j holds chunks
    #                          chunk_off[j]..chunk_off[j+1]


def _chunk_counts(counts, threads):
    """Each group's chunk count, ceil(n_g / depth) at the rows a chunk
    (``depth``) that gives a thread of the kernel the fewest rows,
    ceil(chunks / threads) x depth (the fewest chunks among equals), with
    at most ``threads`` + J chunks.  Depth ceil(N / threads) (or the
    largest group, if less) always qualifies, and no depth past twice it
    gives fewer rows, so the search stops there."""
    nz = counts[counts > 0]
    if nz.size == 0:
        return np.zeros_like(counts)
    even = min(int(nz.max()), -(-int(nz.sum()) // threads))
    best = (math.inf,)
    for depth in range(1, 2 * even + 1):
        n_ch = int(np.sum(-(-nz // depth)))
        if n_ch <= threads + counts.size:
            best = min(best, (-(-n_ch // threads) * depth, n_ch, depth))
    return -(-counts // best[2])


def _layout(counts, threads=CHUNK_THREADS):
    """(chunks (3, nch), chunk_off (J+1,), depth) of groups of ``counts``
    rows (int64 numpy): each group cut into its ``_chunk_counts`` chunks,
    whose rows differ by at most one, the first ones longer."""
    k = _chunk_counts(counts, threads)
    n_ch = int(k.sum())
    nch = max(1, -(-n_ch // threads)) * threads
    grp = np.repeat(np.arange(counts.size), k)
    first = np.concatenate([[0], np.cumsum(k)])
    idx = np.arange(n_ch) - first[grp]            # chunk index in its group
    base, extra = counts[grp] // k[grp], counts[grp] % k[grp]
    rows = base + (idx < extra)
    row_off = np.concatenate([[0], np.cumsum(counts)])
    start = row_off[grp] + idx * base + np.minimum(idx, extra)
    chunks = np.zeros((3, nch), np.int64)
    chunks[:, :n_ch] = start, rows, grp
    chunks[0, n_ch:] = row_off[-1]
    depth = max(1, int(rows.max()) if n_ch else 1)
    return chunks, first, depth


def _positions(chunks, depth, b=CHUNK_THREADS):
    """Each sorted row's position (m depth + i) b + t in the layout: row i
    of chunk m b + t."""
    start, rows = chunks[0], chunks[1]
    cid = np.repeat(np.arange(rows.size), rows)
    i = np.arange(int(rows.sum())) - start[cid]
    return (cid // b * depth + i) * b + cid % b


def hier_data(x, y, group, num_groups):
    """Sort the rows by group (stable), build the group offsets and the
    kernel's layout of the rows, on ``x``'s device."""
    g = torch.as_tensor(group, device=x.device).long()
    if g.numel() and (int(g.min()) < 0 or int(g.max()) >= num_groups):
        raise ValueError(f"group ids must lie in 0..{num_groups - 1}")
    order = torch.argsort(g, stable=True)
    counts = torch.bincount(g, minlength=int(num_groups))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    y = torch.as_tensor(y, device=x.device)
    xs = x[order].to(torch.float32).contiguous()
    ys = y[order].to(torch.float32).contiguous()
    if not bool(((ys == 0) | (ys == 1)).all()):
        raise ValueError("y must be 0 or 1")
    chunks, chunk_off, depth = _layout(counts.cpu().numpy())
    pos = _positions(chunks, depth)
    b, nch = CHUNK_THREADS, chunks.shape[1]
    xc = xs.new_zeros((nch // b * depth, b, xs.shape[1]))
    xc.view(-1, xs.shape[1])[torch.as_tensor(pos, device=x.device)] = xs
    xc = xc.view(nch // b, depth, b, -1).transpose(2, 3).contiguous()
    bits = np.zeros(depth * nch, np.uint8)
    bits[pos] = ys.cpu().numpy() > 0.5
    ybits = np.packbits(bits, bitorder="little").view("<i4")
    dev = dict(dtype=torch.int32, device=x.device)
    return HierData(xs, ys, g[order], offsets.to(torch.int32).contiguous(),
                    xc, torch.as_tensor(ybits.copy(), **dev),
                    torch.as_tensor(chunks, **dev),
                    torch.as_tensor(chunk_off, **dev))


def _dims(data):
    return data.offsets.numel() - 1, data.x.shape[1]


def hier_potential(data: HierData):
    """``pg(q (C, D)) -> (pe (C,), grad (C, D))`` of the centered posterior,
    with the hand-derived gradient."""
    j, f = _dims(data)
    const = math.log(5.0) + 0.5 * _LOG_2PI * (2 + j + f)
    x, y, group = data.x, data.y, data.group

    def pg(q):
        mu, u = q[:, 0:1], q[:, 1:2]
        th, be = q[:, 2:2 + j], q[:, 2 + j:]
        tau2, inv_t2 = torch.exp(2.0 * u), torch.exp(-2.0 * u)
        dth = th - mu
        s1 = torch.sum(dth, 1, keepdim=True)
        s2 = torch.sum(dth * dth, 1, keepdim=True)
        logits = th[:, group] + be @ x.T                          # (C, N)
        sp = torch.clamp(logits, min=0.0) \
            + torch.log1p(torch.exp(-torch.abs(logits)))
        prior = (0.5 * mu * mu / 25.0 + 0.125 * tau2 + (j - 1.0) * u
                 + 0.5 * s2 * inv_t2
                 + 0.5 * torch.sum(be * be, 1, keepdim=True))
        pe = prior[:, 0] + torch.sum(sp - y * logits, 1) + const
        dpl = torch.sigmoid(logits) - y
        g_th = torch.zeros_like(th).index_add_(1, group, dpl) + dth * inv_t2
        grad = torch.cat([mu / 25.0 - s1 * inv_t2,
                          0.25 * tau2 + (j - 1.0) - s2 * inv_t2,
                          g_th, dpl @ x + be], 1)
        return pe, grad

    return pg


def reference_transition(q, pe, grad, mom, sign_dir, log_u_acc, log_u_leaf,
                         eps, inv_mass, data: HierData, *, max_doublings,
                         divergence_threshold=1000.0):
    """The plain version of the kernel: ``nuts_core`` over
    ``hier_potential``, with the kernel's argument and output layout
    (per-chain outputs as (N, 1))."""
    out = nuts_core(hier_potential(data), q, pe.reshape(-1), grad,
                    NUTSStreams(mom, sign_dir, log_u_acc, log_u_leaf),
                    eps, inv_mass.reshape(-1), max_doublings,
                    divergence_threshold)
    q2, pe2, g2 = out[:3]
    return (q2, pe2[:, None], g2) + tuple(s[:, None] for s in out[3:])


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

def _depth_nch(data):
    return data.xc.shape[1], data.chunks.shape[-1]


def _check_data(q, data):
    j, f = _dims(data)
    n_obs = data.x.shape[0]
    depth, nch = _depth_nch(data)
    for k, t, shape, dtype in (
            ("x", data.x, (n_obs, f), torch.float32),
            ("y", data.y, (n_obs,), torch.float32),
            ("offsets", data.offsets, (j + 1,), torch.int32),
            ("xc", data.xc, (nch // CHUNK_THREADS, depth, f, CHUNK_THREADS),
             torch.float32),
            ("ybits", data.ybits, (depth * nch // 32,), torch.int32),
            ("chunks", data.chunks, (3, nch), torch.int32),
            ("chunk_off", data.chunk_off, (j + 1,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{k}: want contiguous {dtype} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if nch < CHUNK_THREADS or nch % CHUNK_THREADS or depth < 1:
        raise ValueError(f"chunks: want a multiple of {CHUNK_THREADS} "
                         f"chunks and xc one row deep or more, got {nch}, "
                         f"{depth}")
    if (data.xc.data_ptr() | data.ybits.data_ptr()) % 16:
        raise ValueError("xc and ybits must be 16-byte aligned")
    if f > MAX_FEATURES:
        raise ValueError(f"the kernel takes F <= {MAX_FEATURES}, got {f}")
    if q.dim() != 2 or q.shape[1] != 2 + j + f:
        raise ValueError(f"q must be (N, 2 + J + F) = (N, {2 + j + f})")
    return j, f


def hier_geometry(data: HierData, max_doublings=6):
    """The kernel's launch at this shape: ``{"threads", "smem_bytes",
    "chunks", "depth", "instance"}`` of a transition at ``max_doublings``
    (0: of ``fused_hier_nuts_potential``); instance ``"resident"`` (the
    rows copied into shared memory) or ``"l2"`` (read from device memory).
    Raises where no instance fits."""
    j, f = _dims(data)
    depth, nch = _depth_nch(data)
    out = (ctypes.c_int * 3)()
    _raise(_build.load().fused_hier_nuts_geometry(j, f, int(max_doublings),
                                                  depth, nch, out),
           f"fused_hier_nuts_geometry (J={j}, F={f}, K={max_doublings})")
    return {"threads": out[0], "smem_bytes": out[1], "chunks": nch,
            "depth": depth, "instance": "resident" if out[2] else "l2"}


def fused_hier_nuts_potential(q, data: HierData):
    """pe (N, 1) and grad (N, D) at q (N, D).  On a CUDA tensor this runs
    the kernel's own device function (the check entry that isolates the
    potential from the tree); on a CPU tensor ``hier_potential``."""
    if q.device.type == "cpu":
        pe, grad = hier_potential(data)(q)
        return pe[:, None], grad
    if q.device.type != "cuda":
        raise ValueError(f"fused_hier_nuts_potential: unsupported device "
                         f"{q.device}")
    j, f = _check_data(q, data)
    depth, nch = _depth_nch(data)
    _check_rows(q.shape[0], q=(q, 2 + j + f))
    lib = _build.load()
    pe = torch.empty((q.shape[0], 1), dtype=torch.float32, device=q.device)
    grad = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.fused_hier_nuts_potential(
            *map(_ptr, (q, data.xc, data.ybits, data.chunks, data.chunk_off,
                        pe, grad)), q.shape[0], j, f,
            depth, nch, _stream(q.device))
    _raise(err, "fused_hier_nuts_potential")
    return pe, grad


def _transition(entry, q, pe, grad, eps, inv_mass, data, kk,
                divergence_threshold, streams=(), key=()):
    """Check, then run one transition through ``entry``: the injected one
    with ``streams`` (mom, sign_dir, log_u_acc, log_u_leaf) or the keyed
    one with ``key``'s words."""
    global LAUNCHES
    j, f = _check_data(q, data)
    depth, nch = _depth_nch(data)
    widths = (q.shape[1], kk, kk, 1 << kk)
    eps = _check_state(q, pe, grad, eps, inv_mass, **dict(zip(
        ("mom", "sign_dir", "log_u_acc", "log_u_leaf"),
        zip(streams, widths))))
    hier_geometry(data, kk)               # raises where no instance fits
    outs = _call_transition(
        getattr(_build.load(), entry), q,
        (q, pe.contiguous(), grad, *streams, eps, inv_mass.contiguous(),
         data.xc, data.ybits, data.chunks, data.chunk_off),
        (q.shape[0], j, f, kk, depth, nch, float(divergence_threshold)), key)
    LAUNCHES += 1
    return outs


def fused_hier_nuts_transition(q, pe, grad, mom, sign_dir, log_u_acc,
                               log_u_leaf, eps, inv_mass, data: HierData, *,
                               max_doublings=6, divergence_threshold=1000.0):
    """One NUTS transition of every chain, from pre-drawn streams.

    q/grad/mom (N, D) with D = 2 + J + F; pe (N, 1); sign_dir (N, K) of
    +-1; log_u_acc (N, K) and log_u_leaf (N, 2^K) strictly negative
    log-uniforms, K = ``max_doublings``; eps the step size (a float, or a
    one-element tensor on q's device, which avoids a host sync); inv_mass
    (D,) or (1, D); ``data`` from ``hier_data``.

    Returns ``(q', pe', grad', accept_stat, diverging, depth, num_steps,
    h0)``, the per-chain values as (N, 1) float32.
    """
    if q.device.type == "cpu":
        return reference_transition(
            q, pe, grad, mom, sign_dir, log_u_acc, log_u_leaf, eps, inv_mass,
            data, max_doublings=max_doublings,
            divergence_threshold=divergence_threshold)
    if q.device.type != "cuda":
        raise ValueError(f"fused_hier_nuts_transition: unsupported device "
                         f"{q.device}")
    return _transition("fused_hier_nuts_transition", q, pe, grad, eps,
                       inv_mass, data, _doublings(max_doublings),
                       divergence_threshold,
                       streams=(mom, sign_dir, log_u_acc, log_u_leaf))


def fused_hier_nuts_transition_keyed(q, pe, grad, key, eps, inv_mass,
                                     data: HierData, *, max_doublings=6,
                                     divergence_threshold=1000.0):
    """One NUTS transition of every chain, its draws made from ``key`` (a
    ``streams.StreamKey``) for logical chains 0..N-1, as
    ``nuts_streams(key, N, D, K)`` makes them: in the kernel on a CUDA
    tensor, by ``nuts_streams`` and ``reference_transition`` on a CPU
    tensor.  Other arguments and the outputs as
    ``fused_hier_nuts_transition``."""
    if q.device.type == "cpu":
        n, d = q.shape
        return reference_transition(
            q, pe, grad, *nuts_streams(key, n, d, int(max_doublings),
                                       q.device),
            eps, inv_mass, data, max_doublings=max_doublings,
            divergence_threshold=divergence_threshold)
    if q.device.type != "cuda":
        raise ValueError(f"fused_hier_nuts_transition_keyed: unsupported "
                         f"device {q.device}")
    return _transition("fused_hier_nuts_transition_keyed", q, pe, grad, eps,
                       inv_mass, data, _doublings(max_doublings),
                       divergence_threshold, key=_key_words(key))


# ---------------------------------------------------------------------------
# MCMC integration: a batched_transition for infer/mcmc/mcmc.py
# ---------------------------------------------------------------------------

def make_batched_transition_hier(x, y, group, num_groups, *,
                                 max_doublings=6):
    """A ``batched_transition(key, states, step_size, inv_mass)`` for
    ``MCMC`` over the centered hier-logistic model (``models/
    hier_logistic.make_model(..., centered=True)``), running
    ``fused_hier_nuts_transition_keyed``: the kernel draws each
    transition's per-chain streams from ``key`` by logical chain index, so
    the host draws nothing.  Requires ``shared_adapt=True``.  The rows are
    sorted by group here, once."""
    data = hier_data(x, y, group, num_groups)
    kk = int(max_doublings)

    def transition(key, states, step_size, inv_mass):
        n = states.q.shape[0]
        q2, pe2, g2, acc, div, depth, nsteps, h0 = \
            fused_hier_nuts_transition_keyed(
                states.q, states.pe.reshape(n, 1), states.grad, key,
                step_size, inv_mass, data, max_doublings=kk)
        new_states = IntegratorState(q2, torch.zeros_like(q2), pe2[:, 0], g2)
        info = NUTSInfo(
            accept_prob=acc[:, 0], diverging=div[:, 0] > 0.5,
            depth=depth[:, 0].to(torch.int32),
            num_steps=nsteps[:, 0].to(torch.int32), energy=h0[:, 0],
            is_accepted=torch.any(q2 != states.q, dim=-1))
        return new_states, info

    return transition
