"""Iterative multinomial NUTS over a batch of chains.

Counterpart of ``bayesic_tpu/infer/mcmc/nuts.py`` and of the transition
core of ``bayesic_tpu/ops/fused_nuts.py`` (``_nuts_transition_core``).  JAX
keeps two copies of the tree algorithm: one per chain under vmap that draws
its own uniforms, one in lockstep over a block with pre-drawn streams.  The
port has one, :func:`nuts_core`: all chains advance in lockstep over a
leading chain axis, a chain that has stopped is masked, and every random
input is pre-drawn (``streams.NUTSStreams``).  The generic ``MCMC`` runs it
with any batched potential; ``ops/fused_nuts.reference_transition`` runs it
with the dense DLGM potential and is the oracle of the CUDA kernel.

The tree: the trajectory doubles up to ``max_depth`` times in the
direction ``sign_dir[:, j]``; each doubling builds a subtree of 2^j
leaves, one leapfrog per leaf, with a progressive multinomial proposal
(weight exp(-dH)) and U-turn checks against O(max_depth) checkpoint slots:
even leaf ``n`` is stored at slot ``popcount(n)``; odd leaf ``n`` with
``t`` trailing one-bits checks slots ``popcount(n)-t .. popcount(n)-1``,
the left ends of the balanced subtrees that end at ``n``.  A clean subtree
merges by the biased progressive rule, then the full span is checked for a
U-turn.  The first evaluated leaf of a subtree is always taken (its
conditional multinomial weight is 1), so the proposal never keeps the
subtree's placeholder.  Leaf and doubling counters are shared by all
chains, so slot arithmetic is plain Python integers; per chain the loop
stops when the chain turns or diverges, and the batch stops when no chain
is left (one host sync per leaf).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .integrators import IntegratorState, per_chain
from .metrics import kinetic_energy, sample_momentum, velocity

__all__ = ["NUTSInfo", "nuts_core", "make_nuts_kernel"]


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean leaf acceptance statistic (for DA)
    diverging: torch.Tensor
    depth: torch.Tensor        # tree depth reached
    num_steps: torch.Tensor    # leapfrog evaluations this transition
    energy: torch.Tensor       # H at trajectory start
    is_accepted: torch.Tensor  # proposal != initial point


def _popcount(n):
    return bin(n).count("1")


def _is_turning(q_l, v_l, q_r, v_r, sign):
    """U-turn on the time-ordered span.  ``sign`` (C, 1) corrects a span
    given in build order: a backward subtree visits later times first, so
    its build-order displacement is minus the time-order one."""
    dq = (q_r - q_l) * sign
    return torch.minimum(torch.sum(dq * v_l, -1),
                         torch.sum(dq * v_r, -1)) < 0.0


def _sel(mask, new, old):
    """Per-chain select over tuples of (C, ...) tensors."""
    return tuple(torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)
                 for n, o in zip(new, old))


def nuts_core(potential_and_grad, q, pe, grad, streams, step_size, inv_mass,
              max_depth, divergence_threshold=1000.0, dense=False):
    """One multinomial-NUTS transition for every chain.

    ``q``, ``grad`` (C, D); ``pe`` (C,); ``streams`` a ``NUTSStreams`` with
    momentum normals (C, D), direction signs (C, K), merge log-uniforms
    (C, K) and leaf log-uniforms (C, 2^K), K >= ``max_depth``;
    ``step_size`` a scalar or (C,); ``inv_mass`` a diagonal (D,) / (C, D)
    or, with ``dense``, (D, D) / (C, D, D).  ``potential_and_grad(q)``
    returns (pe (C,), grad (C, D)).

    Returns ``(q', pe', grad', accept_stat, diverging, depth, num_steps,
    h0)``, the per-chain scalars as float (C,) tensors (diverging 0/1).
    """
    mom, sign_dir, log_u_acc, log_u_leaf = streams
    c = q.shape[0]
    eps = per_chain(step_size, q)
    p0 = sample_momentum(mom, inv_mass, dense)
    h0 = pe + kinetic_energy(inv_mass, p0, dense)
    zero = torch.zeros(c, dtype=q.dtype, device=q.device)
    no = torch.zeros(c, dtype=torch.bool, device=q.device)

    left = right = (q, p0, grad)
    prop = (q, pe, grad)
    log_w = zero                     # log weight of the root leaf: exp(0)
    sum_acc = n_leaves = depth = zero
    turning = diverging = no
    for dstep in range(max_depth):
        traj_active = ~(turning | diverging)
        if not bool(traj_active.any()):
            break
        go_right = sign_dir[:, dstep] > 0.0
        sign_w = torch.where(go_right, 1.0, -1.0).to(q.dtype)[:, None]
        eps_w = sign_w * eps
        st = _sel(go_right, right, left)
        n_sub = 1 << dstep
        leaf_base = n_sub - 1

        # subtree state.  A chain's leaf values count only while it is
        # active (mask m); once m drops it never rises in this subtree, and
        # then the subtree's state, proposal and weight are never read (the
        # merge needs an active, clean chain), so only the sums are masked.
        s_prop = (st[0], zero, st[2])
        s_logw = torch.full_like(zero, -float("inf"))
        s_acc = s_cnt = zero
        s_turn = s_div = no
        ck_q, ck_v = [None] * max_depth, [None] * max_depth
        for i in range(n_sub):
            m = traj_active & ~(s_turn | s_div)
            if not bool(m.any()):
                break
            st_q, st_p, st_g = st
            p_half = st_p - (0.5 * eps_w) * st_g
            q_new = st_q + eps_w * velocity(inv_mass, p_half, dense)
            pe_new, g_new = potential_and_grad(q_new)
            p_new = p_half - (0.5 * eps_w) * g_new
            delta = pe_new + kinetic_energy(inv_mass, p_new, dense) - h0
            delta = torch.where(torch.isnan(delta), float("inf"), delta)
            leaf_logw = -delta
            new_logw = torch.logaddexp(s_logw, leaf_logw)
            # progressive multinomial take; the first leaf unconditionally
            fresh = s_logw < -1e37
            take = fresh | (log_u_leaf[:, leaf_base + i]
                            < leaf_logw - new_logw)
            s_prop = _sel(take, (q_new, pe_new, g_new), s_prop)
            s_acc = s_acc + torch.where(
                m, torch.clamp(torch.exp(-delta), max=1.0), 0.0)
            s_cnt = s_cnt + m.to(q.dtype)
            v_new = velocity(inv_mass, p_new, dense)
            if i % 2 == 0:
                ck_q[_popcount(i)] = q_new
                ck_v[_popcount(i)] = v_new
                turn = no
            else:
                idx_max = _popcount(i) - 1
                idx_min = idx_max - (_popcount(i ^ (i + 1)) - 1) + 1
                turn = no
                for s_ in range(idx_min, idx_max + 1):
                    turn = turn | _is_turning(ck_q[s_], ck_v[s_], q_new,
                                              v_new, sign_w)
            st = (q_new, p_new, g_new)
            s_logw = new_logw
            s_turn = s_turn | (m & turn)
            s_div = s_div | (m & (delta > divergence_threshold))

        bad = s_turn | s_div
        ok = traj_active & ~bad
        # biased progressive merge, in log space
        log_acc = torch.clamp(s_logw - log_w, max=0.0)
        take2 = ok & (log_u_acc[:, dstep] < log_acc)
        prop = _sel(take2, s_prop, prop)
        log_w = torch.where(ok, torch.logaddexp(log_w, s_logw), log_w)
        right = _sel(ok & go_right, st, right)
        left = _sel(ok & ~go_right, st, left)
        full_turn = _is_turning(left[0], velocity(inv_mass, left[1], dense),
                                right[0], velocity(inv_mass, right[1], dense),
                                1.0)
        turning = turning | (traj_active & (s_turn | (~bad & full_turn)))
        diverging = diverging | (traj_active & s_div)
        active = traj_active.to(q.dtype)
        sum_acc = sum_acc + active * s_acc
        n_leaves = n_leaves + active * s_cnt
        depth = depth + active
    accept_stat = sum_acc / torch.clamp(n_leaves, min=1.0)
    return (prop[0], prop[1], prop[2], accept_stat, diverging.to(q.dtype),
            depth, n_leaves, h0)


def make_nuts_kernel(potential_and_grad, max_depth=10,
                     divergence_threshold=1000.0, dense=False):
    """Returns ``step(streams, state, step_size, inv_mass) -> (state,
    info)`` over all chains at once; ``state`` is an
    :class:`IntegratorState` (momentum ignored on input)."""

    def step(streams, state: IntegratorState, step_size, inv_mass):
        q2, pe2, g2, acc, div, depth, nsteps, h0 = nuts_core(
            potential_and_grad, state.q, state.pe, state.grad, streams,
            step_size, inv_mass, max_depth, divergence_threshold, dense)
        info = NUTSInfo(acc, div > 0.5, depth.to(torch.int32),
                        nsteps.to(torch.int32), h0,
                        torch.any(q2 != state.q, dim=-1))
        return IntegratorState(q2, torch.zeros_like(q2), pe2, g2), info

    return step
