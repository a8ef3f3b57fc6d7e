"""The GMM kernels' log2-domain point loop (``csrc/gmm_lik.cuh``
``points_log2``, run by the SMC mutation kernel and the three likelihood
kernels), emulated in numpy float32 in the kernels' order.

A CUDA kernel cannot run on the CPU, and its ``.approx`` functions have no
CPU counterpart, so the tests hold this emulation against float64 with
every ex2, lg2 and rcp moved to its PTX ISA bound in one direction or the
other.  The order is the kernels': x in tiles of shared memory; in each,
lane l takes the points l, l + 32, ...; a lane's chunks of ``chunk``
points each end in one lg2 of the product of their sums, the maxes summed
apart; a butterfly of xor shuffles adds the lanes.  As in the kernels, the
value's sums (``value``) and the gradient's (``grad``) can each be left
out; the sums kept do not depend on which are.
"""

import numpy as np

# the PTX ISA's documented bounds of the kernels' approximate functions:
# ex2.approx.ftz.f32 within 2 ulp (relative 2^-22), lg2.approx.ftz.f32
# within 2^-22 absolute, rcp.approx.ftz.f32 within 1 ulp (relative 2^-23)
EX2_REL, LG2_ABS, RCP_REL = 2.0 ** -22, 2.0 ** -22, 2.0 ** -23
F32 = np.float32
LOG2E = F32(np.log2(np.e))
LN2 = F32(np.log(2.0))
HALF_LOG_2PI = F32(0.5 * np.log(2 * np.pi))


def fma(a, b, c):
    """fmaf: the float32 product is exact in float64, one rounding (twice,
    float64 then float32, a half-ulp apart at worst)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def butterfly(v):
    """warp_sum over the last axis (32 lanes): xor shuffles 16 .. 1."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v


def points_log2(c2, h2, mu, x, sign, chunk, tile_points=None, value=True,
                grad=True):
    """The per-particle sums of ``points_log2`` over the points x (N, D),
    summed across the lanes: ``(ll2 (P,), r (P, K), rq (P, K), rdx (P, K,
    D))``, ll2 the log-likelihood in log2 units (None without ``value``),
    the other three None without ``grad``.  c2, h2 (P, K) are the
    components' log2-domain constants, mu (P, K, D) their means; every ex2,
    lg2 and rcp is moved by ``sign`` times its bound.  ``tile_points``: the
    points of one shared-memory tile (all of x if None)."""
    c2, h2, mu, x = (np.asarray(a, F32) for a in (c2, h2, mu, x))
    p, k = c2.shape
    n, d = x.shape
    tile = n if tile_points is None else tile_points
    ll2 = np.zeros((p, 32), F32)
    r = np.zeros((p, 32, k), F32)
    rq = np.zeros((p, 32, k), F32)
    rdx = np.zeros((p, 32, k, d), F32)
    for t0 in range(0, n, tile):
        xt = x[t0:t0 + tile]
        cnt = xt.shape[0]
        last = (cnt - 1 - np.arange(32)) // 32    # a lane's last iteration
        prod = np.ones((p, 32), F32)
        for it in range(-(-cnt // 32)):
            idx = np.minimum(np.arange(32) + 32 * it, cnt - 1)
            live = np.broadcast_to(it <= last, (p, 32))
            dx = (xt[idx][None, :, None, :] - mu[:, None]).astype(F32)
            qd = np.zeros((p, 32, k), F32)
            for j in range(d):
                qd = fma(dx[..., j], dx[..., j], qd)
            lk = fma(-qd, h2[:, None], c2[:, None])
            mx = lk.max(-1)
            e = (np.exp2(np.asarray(lk - mx[..., None], np.float64))
                 * (1 + sign * EX2_REL)).astype(F32)
            se = np.zeros((p, 32), F32)
            for kk in range(k):
                se = (se + e[..., kk]).astype(F32)
            if value:
                prod = np.where(live, prod * se, prod).astype(F32)
                ll2 = np.where(live, ll2 + mx, ll2).astype(F32)
            if grad:
                inv = (1.0 / np.asarray(se, np.float64)
                       * (1 + sign * RCP_REL)).astype(F32)
                rr = (e * inv[..., None]).astype(F32)
                r = np.where(live[..., None], r + rr, r).astype(F32)
                rq = np.where(live[..., None], fma(rr, qd, rq), rq)
                rdx = np.where(live[..., None, None],
                               fma(rr[..., None], dx, rdx), rdx)
            if value:
                end = live & ((it % chunk == chunk - 1) | (it == last))
                lg = (np.log2(np.asarray(prod, np.float64))
                      + sign * LG2_ABS).astype(F32)
                ll2 = np.where(end, ll2 + lg, ll2).astype(F32)
                prod = np.where(end, F32(1), prod)
    sums = (butterfly(ll2)[:, 0],
            butterfly(np.moveaxis(r, 1, -1))[..., 0],
            butterfly(np.moveaxis(rq, 1, -1))[..., 0],
            butterfly(np.moveaxis(rdx, 1, -1))[..., 0])
    return (sums[0] if value else None,) + (sums[1:] if grad
                                            else (None,) * 3)
