"""Plain reference of one multinomial-NUTS transition on the DLGM's local
posterior, for a batch of chains, each on its own draws.

Potential of chain c's latents q (nb * Z) under a fixed decoder (W1, b1,
W2, b2) and rows x (nb, D):

    pe(q) = |q|^2 / 2 + |x - (tanh(z W1 + b1) W2 + b2)|^2 / (2 sigma^2)
            + (nb Z + nb D) log(2 pi) / 2 + nb D log sigma,  z = q (nb, Z).

The transition (Betancourt 2017's multinomial NUTS, iterative): momenta
p = m / sqrt(inv_mass) from the chain's normals m; the trajectory doubles
up to K times in the direction of the chain's sign for that doubling; a
subtree of 2^j leaves takes one leapfrog a leaf, proposes by the
progressive multinomial rule on exp(-dH) (its first leaf always, leaf i
against the leaf uniform of slot 2^j - 1 + i), and checks U-turns against
checkpoints (even leaf i stored at slot popcount(i); odd leaf i checks
the slots of the balanced subtrees that end at it); a clean subtree is
merged by the biased progressive rule against the merge uniform of its
doubling, then the whole span is checked for a U-turn.  A leaf whose
energy error exceeds 1000 diverges.  The accept statistic is the mean of
min(1, exp(-dH)) over the leaves built while the chain was active.

Float32 with TF32 off; ``tf32=True`` is the control's precision."""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def make_potential(w1, b1, w2, b2, x, sigma):
    nb, d = x.shape
    z_dim = w1.shape[0]
    inv_s2 = 1.0 / (sigma * sigma)
    const = 0.5 * _LOG_2PI * (nb * z_dim + nb * d) + nb * d * math.log(sigma)

    def pg(q):
        c = q.shape[0]
        a = torch.tanh(q.reshape(c, nb, z_dim) @ w1 + b1)
        res = a @ w2 + b2 - x
        pe = (0.5 * torch.sum(q * q, 1)
              + 0.5 * inv_s2 * torch.sum(res * res, (1, 2)) + const)
        da = ((res * inv_s2) @ w2.T) * (1.0 - a * a)
        return pe, q + (da @ w1.T).reshape(c, -1)

    return pg


def _turning(q_l, v_l, q_r, v_r, sign):
    dq = (q_r - q_l) * sign
    return torch.minimum(torch.sum(dq * v_l, 1), torch.sum(dq * v_r, 1)) < 0


def _pick(mask, new, old):
    return tuple(torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)
                 for n, o in zip(new, old))


def transition(pg, q, mom, sign, log_u_acc, log_u_leaf, eps, inv_mass,
               depth_max, threshold=1000.0):
    """One transition of every row of q (C, D).  Returns ``(q', accept
    statistic (C,), leapfrogs (C,))``."""
    c = q.shape[0]
    pe, g = pg(q)
    p0 = mom / torch.sqrt(inv_mass)
    h0 = pe + 0.5 * torch.sum(p0 * p0 * inv_mass, 1)
    no = torch.zeros(c, dtype=torch.bool, device=q.device)
    zero = torch.zeros(c, device=q.device)
    left = right = (q, p0, g)
    prop = q
    log_w = zero
    turning = diverging = no
    sum_acc = n_leaves = zero
    for j in range(depth_max):
        active = ~(turning | diverging)
        if not bool(active.any()):
            break
        fwd = sign[:, j] > 0
        sgn = torch.where(fwd, 1.0, -1.0)[:, None]
        step = sgn * eps
        cur = _pick(fwd, right, left)
        s_prop, s_logw = cur[0], torch.full_like(zero, -math.inf)
        s_acc = s_cnt = zero
        s_turn = s_div = no
        ck_q, ck_v = {}, {}
        for i in range(1 << j):
            live = active & ~(s_turn | s_div)
            if not bool(live.any()):
                break
            qq, pp, gg = cur
            ph = pp - 0.5 * step * gg
            qn = qq + step * inv_mass * ph
            pen, gn = pg(qn)
            pn = ph - 0.5 * step * gn
            dh = pen + 0.5 * torch.sum(pn * pn * inv_mass, 1) - h0
            dh = torch.where(torch.isnan(dh), math.inf, dh)
            new_logw = torch.logaddexp(s_logw, -dh)
            take = (s_logw < -1e37) | (
                log_u_leaf[:, (1 << j) - 1 + i] < -dh - new_logw)
            s_prop = torch.where(take[:, None], qn, s_prop)
            s_acc = s_acc + torch.where(
                live, torch.clamp(torch.exp(-dh), max=1.0), 0.0)
            s_cnt = s_cnt + live.float()
            vn = inv_mass * pn
            turn = no
            ones = bin(i).count("1")
            if i % 2 == 0:
                ck_q[ones], ck_v[ones] = qn, vn
            else:
                hi = ones - 1
                lo = hi - (bin(i ^ (i + 1)).count("1") - 1) + 1
                for s in range(lo, hi + 1):
                    turn = turn | _turning(ck_q[s], ck_v[s], qn, vn, sgn)
            cur = (qn, pn, gn)
            s_logw = new_logw
            s_turn = s_turn | (live & turn)
            s_div = s_div | (live & (dh > threshold))
        bad = s_turn | s_div
        ok = active & ~bad
        take = ok & (log_u_acc[:, j] < torch.clamp(s_logw - log_w, max=0.0))
        prop = torch.where(take[:, None], s_prop, prop)
        log_w = torch.where(ok, torch.logaddexp(log_w, s_logw), log_w)
        right = _pick(ok & fwd, cur, right)
        left = _pick(ok & ~fwd, cur, left)
        full = _turning(left[0], inv_mass * left[1], right[0],
                        inv_mass * right[1], 1.0)
        turning = turning | (active & (s_turn | (~bad & full)))
        diverging = diverging | (active & s_div)
        sum_acc = sum_acc + active.float() * s_acc
        n_leaves = n_leaves + active.float() * s_cnt
    return prop, sum_acc / torch.clamp(n_leaves, min=1.0), n_leaves
