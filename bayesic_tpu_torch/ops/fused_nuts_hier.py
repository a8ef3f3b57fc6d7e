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
likelihood unchanged and lets the kernel walk each group's rows as one
contiguous run.  The JAX package's 128-lane padding with auxiliary dims
redrawn every transition, its design matrix and its bf16 splits are TPU
workarounds and are not ported: the chains carry the real D dims, so the
U-turn statistic covers every dim (the JAX ``turn_mask`` does the same for
its real lanes), and every product is fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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
           "MAX_FEATURES"]

_LOG_2PI = math.log(2.0 * math.pi)
MAX_FEATURES = 8        # MAXF of csrc/fused_nuts_hier.cu

# launches of the transition kernel (either entry); one launch is one NUTS
# transition of every chain
LAUNCHES = 0


class HierData(NamedTuple):
    """The likelihood's rows, sorted by group."""

    x: torch.Tensor        # (N, F) float32
    y: torch.Tensor        # (N,) float32, 0/1
    group: torch.Tensor    # (N,) int64, non-decreasing
    offsets: torch.Tensor  # (J+1,) int32: group j holds rows off[j]..off[j+1]


def hier_data(x, y, group, num_groups):
    """Sort the rows by group (stable) and build the group offsets, on
    ``x``'s device."""
    g = torch.as_tensor(group, device=x.device).long()
    if g.numel() and (int(g.min()) < 0 or int(g.max()) >= num_groups):
        raise ValueError(f"group ids must lie in 0..{num_groups - 1}")
    order = torch.argsort(g, stable=True)
    counts = torch.bincount(g, minlength=int(num_groups))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    y = torch.as_tensor(y, device=x.device)
    return HierData(x[order].to(torch.float32).contiguous(),
                    y[order].to(torch.float32).contiguous(), g[order],
                    offsets.to(torch.int32).contiguous())


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

def _check_data(q, data):
    j, f = _dims(data)
    n_obs = data.x.shape[0]
    for k, t, shape, dtype in (
            ("x", data.x, (n_obs, f), torch.float32),
            ("y", data.y, (n_obs,), torch.float32),
            ("offsets", data.offsets, (j + 1,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{k}: want contiguous {dtype} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if f > MAX_FEATURES:
        raise ValueError(f"the kernel takes F <= {MAX_FEATURES}, got {f}")
    if q.dim() != 2 or q.shape[1] != 2 + j + f:
        raise ValueError(f"q must be (N, 2 + J + F) = (N, {2 + j + f})")
    return j, f


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
    _check_rows(q.shape[0], q=(q, 2 + j + f))
    lib = _build.load()
    pe = torch.empty((q.shape[0], 1), dtype=torch.float32, device=q.device)
    grad = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.fused_hier_nuts_potential(
            _ptr(q), _ptr(data.x), _ptr(data.y), _ptr(data.offsets),
            _ptr(pe), _ptr(grad), q.shape[0], j, f, _stream(q.device))
    _raise(err, "fused_hier_nuts_potential")
    return pe, grad


def _transition(entry, q, pe, grad, eps, inv_mass, data, kk,
                divergence_threshold, streams=(), key=()):
    """Check, then run one transition through ``entry``: the injected one
    with ``streams`` (mom, sign_dir, log_u_acc, log_u_leaf) or the keyed
    one with ``key``'s words."""
    global LAUNCHES
    j, f = _check_data(q, data)
    widths = (q.shape[1], kk, kk, 1 << kk)
    eps = _check_state(q, pe, grad, eps, inv_mass, **dict(zip(
        ("mom", "sign_dir", "log_u_acc", "log_u_leaf"),
        zip(streams, widths))))
    lib = _build.load()
    if lib.fused_hier_nuts_smem_bytes(j, f, kk) == 0:
        raise ValueError(f"shape too large for one block's shared memory: "
                         f"J={j}, F={f}, K={kk}")
    outs = _call_transition(
        getattr(lib, entry), q,
        (q, pe.contiguous(), grad, *streams, eps, inv_mass.contiguous(),
         data.x, data.y, data.offsets),
        (q.shape[0], j, f, kk, float(divergence_threshold)), key)
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
