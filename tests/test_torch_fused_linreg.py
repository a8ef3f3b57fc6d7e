"""Parity of the port's fused linreg trainer (``ops/fused_linreg.py``) with
the JAX package's.

Data come from the linreg numpy recipe (repeated here, so this file
imports only ``bayesic_tpu.ops`` of the JAX package); parameters and noise
are made with numpy and go to both packages.  The JAX side runs its plain
functions (``gram``, ``_step_math``, ``reference_train``, which its Pallas
kernel's interpret mode also runs) on its 128-lane layout; ``interop`` maps
the lanes to the port's flat (D+1,) vectors.  Tolerances: the Gram matrix
rtol 1e-6 (both float64 sums rounded to float32); one step's elbo rtol
2e-5 and gradients rtol 2e-4 / atol 2e-3 (the JAX test's own, against
autodiff: u^T G u is a difference of large terms); 200-step trajectories
rtol 1e-4 (float32 sums in another order, compounded over the steps), and
atol 1e-5 of the leaf's largest entry for the parameters and moments (a
gradient entry near zero carries the rounding of the large terms it
cancels).

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``
(also at D 1, 2, 63 and 126 and at step counts around the ring's length),
``test_kernel_repeats_bit_for_bit`` and ``test_kernel_split_run_is_whole``
are marked ``gpu`` and skip here.  What the CPU can check of it:
``test_kernel_arithmetic_precision`` emulates its step in numpy float32 in
the kernel's own order (the row sums split over the lanes of a row, the
butterflies, the Adam form on the producers' schedule, ex2/sqrt/rcp at
their PTX ISA error bounds in both directions) against float64 for 200
steps at the bench shape, and ``test_kernel_layout`` reads the layout's
constants from the source and checks that every row of G, every
parameter and every entry of G has one owner at every D.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.ops import fused_linreg as jfl
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.ops import _kernel_common as kc
from bayesic_tpu_torch.ops import fused_linreg as tfl

torch.set_num_threads(2)

N, D, NOISE = 512, 16, 0.5
P = D + 1


def _data(n=N, d=D, seed=0):
    """``models/linreg.make_data``'s recipe."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    w = rng.normal(0, 1, d).astype(np.float32)
    b = np.float32(rng.normal(0, 1))
    y = (x @ w + b + rng.normal(0, NOISE, n)).astype(np.float32)
    return x, y


def _params(seed, p=P):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, p).astype(np.float32),
            rng.normal(-2.0, 0.3, p).astype(np.float32),
            rng.normal(0, 1, p).astype(np.float32))


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def test_gram_matches_jax():
    x, y = _data()
    got = tfl.gram(*_t(x, y))
    want = np.asarray(jfl.gram(jfl.pack_data(x, y)))[:D + 2, :D + 2]
    assert got.dtype == torch.float32 and got.shape == (D + 2, D + 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.equal(got, got.T)


def test_step_math_matches_jax_lanes():
    x, y = _data()
    loc, ls, eps = _params(0)
    jl, jls, jeps = (jnp.asarray(a) for a in interop.flat_to_lanes(
        _t(loc, ls, eps)))
    jelbo, jg_loc, jg_ls = jfl._step_math(jl, jls, jfl.gram(jfl.pack_data(
        x, y)), N, jeps, D, NOISE)
    elbo, g_loc, g_ls = tfl._step_math(*_t(loc, ls), tfl.gram(*_t(x, y)), N,
                                       torch.as_tensor(eps), NOISE)
    np.testing.assert_allclose(float(elbo), float(jelbo), rtol=2e-5)
    for got, want in ((g_loc, jg_loc), (g_ls, jg_ls)):
        want = interop.lanes_to_flat([np.asarray(want)], P)[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-3)


def test_reference_train_matches_jax_200_steps():
    """200 steps of the port's plain trainer against the JAX
    ``reference_train`` on one noise stream, from a mid-run state (t0 = 7,
    nonzero Adam moments)."""
    x, y = _data()
    steps, t0, total = 200, 7, 300
    rng = np.random.default_rng(2)
    eps = rng.normal(size=(steps, P)).astype(np.float32)
    loc, ls, _ = _params(3)
    m1, m2 = (0.01 * rng.normal(size=(2, P))).astype(np.float32)
    v1, v2 = (1e-4 * rng.random((2, P))).astype(np.float32)
    flat = _t(loc, ls, m1, m2, v1, v2)
    lanes = [jnp.asarray(a) for a in interop.flat_to_lanes(flat)]
    eps_lanes = np.zeros((steps, 1, 128), np.float32)
    eps_lanes[:, 0, :P] = eps
    want = jfl.reference_train(
        jfl.pack_data(x, y), D, NOISE, lanes[0], lanes[1], tuple(lanes[2:]),
        eps_stream=jnp.asarray(eps_lanes), lr0=0.05, lr_total=total, t0=t0)
    got = tfl.reference_train(
        tfl.gram(*_t(x, y)), N, NOISE, flat[0], flat[1], flat[2:],
        eps_stream=torch.as_tensor(eps), lr0=0.05, lr_total=total, t0=t0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-4)
    want_flat = interop.lanes_to_flat(
        [np.asarray(want[0]), np.asarray(want[1]),
         *map(np.asarray, want[2])], P)
    for g, w in zip((got[0], got[1], *got[2]), want_flat):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


def test_cpu_fused_train_runs_the_kernels_streams():
    """On the CPU ``fused_train`` runs the plain trainer over the kernel's
    own Philox streams (the hier layout: lane 1 + p is parameter p's
    noise), continues them from ``t0`` and thins the losses by the
    kernel's rule; it launches nothing."""
    x, y = _t(*_data(n=64, d=3))
    g = tfl.gram(x, y)
    eps = kc.hier_streams(11, 5, 4, 1, 4)[1]
    w = kc.philox4x32_10(6, 0, 3, 0, 11, 0)
    np.testing.assert_allclose(float(eps[1, 2]), float(kc.box_muller(
        kc.uniform24(w[0]), kc.uniform24(w[1]))), rtol=1e-6)
    loc, ls, opt = tfl.init_params(3)
    before = tfl.LAUNCHES
    a = tfl.fused_train(g, 64, NOISE, loc, ls, opt, steps=4, lr0=0.05,
                        lr_total=20, seed=11, t0=5)
    b = tfl.reference_train(g, 64, NOISE, loc, ls, opt, eps_stream=eps,
                            lr0=0.05, lr_total=20, t0=5)
    assert tfl.LAUNCHES == before
    torch.testing.assert_close(a[3], b[3], rtol=0, atol=0)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    long = tfl.fused_train(g, 64, NOISE, loc, ls, steps=2100, lr0=0.05)
    assert long[3].shape == (1050,)          # thin 2


def test_wrapper_checks():
    """Shapes and devices the kernel does not take raise in the wrapper
    (its checks run before any launch, so they are tested here)."""
    x, y = _t(*_data(n=64, d=3))
    g = tfl.gram(x, y)
    loc, ls, opt = tfl.init_params(3)
    assert tfl._check(g, loc, ls, opt) == 3
    with pytest.raises(ValueError, match="ls"):
        tfl._check(g, loc, ls[:-1], opt)
    with pytest.raises(ValueError, match="Gram"):
        tfl._check(g.double(), loc, ls, opt)
    wide = torch.zeros(tfl.MAX_DIM + 3, tfl.MAX_DIM + 3)
    p = tfl.MAX_DIM + 2
    with pytest.raises(ValueError, match="D <="):
        tfl._check(wide, *tfl.init_params(p - 1)[:2],
                   tuple(torch.zeros(p) for _ in range(4)))
    with pytest.raises(ValueError, match="unsupported device"):
        tfl.fused_train(g.to("meta"), 64, NOISE, loc, ls, opt, steps=1,
                        lr0=0.1)


# the kernel's arithmetic: PTX ISA bounds of the .approx functions (ex2:
# 2^-22 relative; sqrt, rcp: taken as 2^-22 and 2^-23 relative), the
# float32 constants of the producers' schedule
EX2_REL, SQRT_REL, RCP_REL = 2.0 ** -22, 2.0 ** -22, 2.0 ** -23
_F32 = np.float32
_CU = Path(tfl.__file__).resolve().parents[1] / "csrc" / "fused_linreg.cu"


def _consts():
    src = _CU.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("KL", "NPW", "R", "BATCH", "MAXD2", "MAXU")}


def _fma(a, b, c):
    """fmaf: the float32 product is exact in float64, one rounding (twice,
    float64 then float32, a half-ulp apart at worst)."""
    return (np.asarray(a, np.float64) * b + c).astype(_F32)


def _approx(x64, rel, sign):
    return (np.asarray(x64, np.float64) * (1.0 + sign * rel)).astype(_F32)


def _butterfly(v):
    """An xor butterfly over the last axis, offsets 1, 2, ... (each lane
    adds its partner's value to its own); returns lane 0's sum."""
    v = v.astype(_F32)
    lanes = np.arange(v.shape[-1])
    o = 1
    while o < v.shape[-1]:
        v = (v + v[..., lanes ^ o]).astype(_F32)
        o <<= 1
    return v[..., 0]


def _schedule(t, lr0, lr_total):
    """The producers' (lr / bc1, 1 / bc2) of step t, in float32."""
    frac = min(_F32(_F32(t) / _F32(lr_total)), _F32(1))
    cos = _F32(np.cos(np.float64(_F32(_F32(np.pi) * frac))))
    lr = _F32(_F32(_F32(lr0) * _F32(0.5)) * _F32(1 + cos))
    tt = _F32(t + 1)
    bc1 = _F32(1 - _F32(np.exp(np.float64(_F32(tt * _F32(kc.LN_B1))))))
    bc2 = _F32(1 - _F32(np.exp(np.float64(_F32(tt * _F32(kc.LN_B2))))))
    return _F32(lr / bc1), _F32(_F32(1) / bc2)


def _emulated_train(g, n, loc, ls, eps, lr0, lr_total, sign):
    """The kernel's steps in numpy float32, every .approx at its bound in
    direction ``sign``; one loss per step (the injected mode)."""
    c = _consts()
    kl = c["KL"]
    d2 = g.shape[0]
    p = d2 - 1
    rows_per_warp = 32 // kl
    nmax, cw, _ = _geometry(c, d2 - 2)
    gp = np.zeros((cw * rows_per_warp, c["MAXU"]), _F32)
    gp[:d2, :d2] = g
    inv_s2 = _F32(1.0 / (NOISE * NOISE))
    ll_const = _F32(n * (np.log(NOISE) + tfl._C))
    log2e = _F32(np.log2(np.e))

    def ex2(x):
        return _approx(np.exp2(np.asarray(_F32(x * log2e), np.float64)),
                       EX2_REL, sign)

    def adam(q, m, v, grad, c1, c2):
        grad = -grad
        m = _fma(_F32(0.9), m, _F32(_F32(0.1) * grad))
        v = _fma(_F32(0.999), v, _F32(_F32(_F32(0.001) * grad) * grad))
        s = _approx(np.sqrt(np.asarray(_F32(v * c2), np.float64)), SQRT_REL,
                    sign)
        r = _approx(1.0 / np.asarray(_F32(s + _F32(1e-8)), np.float64),
                    RCP_REL, sign)
        return _fma(-_F32(c1 * m), r, q), m, v

    loc, ls = loc.astype(_F32), ls.astype(_F32)
    m1, m2, v1, v2 = (np.zeros(p, _F32) for _ in range(4))
    els, emls = ex2(ls), ex2(-ls)
    losses = []
    for i in range(eps.shape[0]):
        e = eps[i].astype(_F32)
        z = _fma(els, e, loc)
        u = np.zeros(c["MAXU"], _F32)
        u[:p], u[p] = z, -1
        # lane j of a row: chunks j, j + KL, ... in four accumulators
        part = np.zeros((gp.shape[0], kl), _F32)
        for j in range(kl):
            acc = np.zeros((gp.shape[0], 4), _F32)
            for k in range(nmax):
                col = 4 * (j + kl * k)
                acc = _fma(gp[:, col:col + 4], u[col:col + 4], acc)
            part[:, j] = (_F32(acc[:, 0] + acc[:, 1])
                          + _F32(acc[:, 2] + acc[:, 3]))
        gu = _butterfly(part)
        # the loss: a row's lane 0 in each warp, the warps in order
        q_row = np.zeros(gp.shape[0], _F32)
        q_row[:d2] = _F32(u[:d2] * gu[:d2])
        pq_row = np.zeros(gp.shape[0], _F32)
        pq_row[:p] = (_F32(_F32(_F32(-0.5) * z) * z)
                      - _F32(-ls - _F32(_F32(_F32(0.5) * e) * e)))
        lanes = np.zeros((cw, 32), _F32)
        q, pq = _F32(0), _F32(0)
        for arr in (q_row, pq_row):
            lanes[:] = 0
            lanes[:, ::kl] = arr.reshape(cw, rows_per_warp)
            sums = _butterfly(lanes)
            tot = _F32(0)
            for w in range(cw):
                tot = _F32(tot + sums[w])
            q, pq = (tot, pq) if arr is q_row else (q, tot)
        losses.append(_F32(_fma(_F32(_F32(0.5) * inv_s2), q, ll_const) - pq))
        # the STL gradient and Adam
        g_z = _fma(-inv_s2, gu[:p], _fma(e, emls, -z))
        g_ls = _F32(g_z * _F32(e * els))
        c1, c2 = _schedule(i, lr0, lr_total)
        loc, m1, v1 = adam(loc, m1, v1, g_z, c1, c2)
        ls, m2, v2 = adam(ls, m2, v2, g_ls, c1, c2)
        els, emls = ex2(ls), ex2(-ls)
    return loc, ls, (m1, m2, v1, v2), np.asarray(losses)


def test_kernel_arithmetic_precision():
    """200 steps of the kernel's arithmetic, emulated in float32 with each
    .approx at its bound in both directions, at N 16,384, D 64 (the bench
    shape): the losses within rtol 1e-4 and loc and log-scale within rtol
    1e-4 / atol 1e-5 of the float64 plain trainer (the GPU test's limits
    against the float32 plain version)."""
    n, d = 16384, 64
    p = d + 1
    x, y = _t(*_data(n, d))
    g = tfl.gram(x, y)
    loc, ls, _ = _params(5, p)
    eps = np.random.default_rng(4).normal(size=(200, p)).astype(np.float32)
    want = tfl.reference_train(
        g.double(), n, NOISE, *_t(loc.astype(np.float64),
                                  ls.astype(np.float64)),
        tuple(torch.zeros(p, dtype=torch.float64) for _ in range(4)),
        eps_stream=torch.as_tensor(eps, dtype=torch.float64), lr0=0.05,
        lr_total=300)
    for sign in (1.0, -1.0):
        got = _emulated_train(g.numpy(), n, loc, ls, eps, 0.05, 300, sign)
        np.testing.assert_allclose(got[3], want[3].numpy(), rtol=1e-4)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-5)


def _geometry(c, d):
    """The kernel's block at D = ``d`` (``launch`` and ``cw_max`` in the
    source): float4 chunks a lane, consumer warps, threads."""
    d2, kl, rpw = d + 2, c["KL"], 32 // c["KL"]
    nc = -(-(-(-d2 // 4)) // kl)
    cw = -(-min(4 * kl * nc, c["MAXD2"]) // rpw)
    return nc, cw, 32 * (cw + c["NPW"])


def test_kernel_layout():
    """The kernel's constants (read from the source) place every row of G
    on KL lanes of one consumer warp, give every parameter one writer lane
    (lane 0 of its row) and every entry of G one register, for every D
    from 1 to MAX_DIM; the block fits 1,024 threads, with a producer warp
    or more on each SM sub-partition, and the ring holds two batches."""
    c = _consts()
    kl = c["KL"]
    ncmax = -(-c["MAXD2"] // (4 * kl))
    assert c["MAXD2"] == tfl.MAX_DIM + 2 and 4 * kl * ncmax <= c["MAXU"]
    assert c["R"] % c["BATCH"] == 0 and c["R"] // c["BATCH"] >= 2
    assert c["NPW"] >= 4
    for d in range(1, tfl.MAX_DIM + 1):
        d2, p = d + 2, d + 1
        nc, cw, threads = _geometry(c, d)
        assert nc <= ncmax and threads <= 1024
        held = np.zeros((d2, d2), int)
        writers = np.zeros(p, int)
        lanes_of = np.zeros(d2, int)
        for w in range(cw):
            for lane in range(32):
                j = lane % kl
                r = w * (32 // kl) + lane // kl
                assert r < c["MAXU"]
                if r >= d2:
                    continue
                lanes_of[r] += 1
                if j == 0 and r < p:
                    writers[r] += 1
                for k in range(nc):
                    cols = 4 * (j + kl * k) + np.arange(4)
                    held[r, cols[cols < d2]] += 1
        assert (lanes_of == kl).all(), d
        assert (writers == 1).all(), d
        assert (held == 1).all(), d


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _injected_vs_plain(dev, n, d, steps, seed):
    """The kernel against the float32 plain trainer on one injected stream
    and on its Philox streams, from a random state at D = ``d``."""
    p = d + 1
    x, y = (t.to(dev) for t in _t(*_data(n, d)))
    g = tfl.gram(x, y)
    loc, ls, _ = (t.to(dev) for t in _t(*_params(seed, p)))
    zeros = tuple(torch.zeros(p, device=dev) for _ in range(4))
    eps = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(steps, p)).astype(np.float32), device=dev)
    kw = dict(eps_stream=eps, lr0=0.05, lr_total=steps + 10)
    got = tfl.fused_train_injected(g, n, NOISE, loc, ls, zeros, **kw)
    want = tfl.reference_train(g, n, NOISE, loc, ls, zeros, **kw)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    got = tfl.fused_train(g, n, NOISE, loc, ls, zeros, steps=steps, lr0=0.05,
                          seed=seed)
    eps = kc.hier_streams(seed, 0, steps, 1, p, device=dev)[1]
    want = tfl.reference_train(g, n, NOISE, loc, ls, zeros, eps_stream=eps,
                               lr0=0.05, lr_total=steps)
    torch.testing.assert_close(got[3], kc.thin_losses(want[3], steps),
                               rtol=1e-4, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card, at D = 64 and N = 16,384: one injected step's loss
    and gradients (read off Adam's first moment) against the float64 plain
    step (the float32 kernel's u^T G u cancels), a 200-step injected
    trajectory against the float32 plain version (rtol 1e-4) and a Philox
    run against the plain version on the rebuilt streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    n, d = 16384, 64
    p = d + 1
    x, y = (t.to(dev) for t in _t(*_data(n, d)))
    g = tfl.gram(x, y)
    rng = np.random.default_rng(4)
    loc, ls, eps1 = (t.to(dev) for t in _t(*_params(5, p)))
    zeros = tuple(torch.zeros(p, device=dev) for _ in range(4))
    _, _, (m1, m2, _, _), l1 = tfl.fused_train_injected(
        g, n, NOISE, loc, ls, zeros, eps_stream=eps1[None], lr0=0.05,
        lr_total=10)
    elbo, g_loc, g_ls = tfl._step_math(loc.double(), ls.double(), g.double(),
                                       n, eps1.double(), NOISE)
    torch.testing.assert_close(l1[0].double(), -elbo, rtol=1e-5, atol=0)
    for got, want in ((-m1 / 0.1, g_loc), (-m2 / 0.1, g_ls)):
        torch.testing.assert_close(got.double(), want, rtol=2e-4,
                                   atol=2e-3)
    eps = torch.as_tensor(rng.normal(size=(200, p)).astype(np.float32),
                          device=dev)
    kw = dict(eps_stream=eps, lr0=0.05, lr_total=300)
    before = tfl.LAUNCHES
    got = tfl.fused_train_injected(g, n, NOISE, loc, ls, zeros, **kw)
    torch.cuda.synchronize()
    assert tfl.LAUNCHES == before + 1
    want = tfl.reference_train(g, n, NOISE, loc, ls, zeros, **kw)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    got = tfl.fused_train(g, n, NOISE, loc, ls, zeros, steps=40, lr0=0.05,
                          seed=9)
    eps = kc.hier_streams(9, 0, 40, 1, p, device=dev)[1]
    want = tfl.reference_train(g, n, NOISE, loc, ls, zeros, eps_stream=eps,
                               lr0=0.05, lr_total=40)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
    # the layout's edges: one warp (D 1, 2), a ragged last warp (D 63), the
    # widest D; step counts around the ring's length
    ring = _consts()["R"]
    for dd, steps in ((1, ring + 1), (2, ring + 1), (63, ring + 1),
                      (126, ring + 1), (d, 1), (d, ring - 1), (d, ring + 1),
                      (d, 1001)):
        _injected_vs_plain(dev, n, dd, steps, seed=dd + steps)


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit():
    """Two launches on the same inputs give the same bits: no atomics, the
    sums in a fixed order."""
    dev = _gpu()
    n, d = 16384, 64
    x, y = (t.to(dev) for t in _t(*_data(n, d)))
    g = tfl.gram(x, y)
    loc, ls, _ = (t.to(dev) for t in _t(*_params(5, d + 1)))
    a, b = (tfl.fused_train(g, n, NOISE, loc, ls, steps=3000, lr0=0.05,
                            seed=3) for _ in range(2))
    for u, v in zip((a[0], a[1], *a[2], a[3]), (b[0], b[1], *b[2], b[3])):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_kernel_split_run_is_whole():
    """A 200-step run split as 100 + 100 (the second call at t0 = 100, one
    lr_total) ends on the whole run's parameters and moments bit for bit:
    the schedule, the bias corrections and the Philox counter continue
    from t0, and the state crosses the calls unrounded."""
    dev = _gpu()
    n, d = 16384, 64
    x, y = (t.to(dev) for t in _t(*_data(n, d)))
    g = tfl.gram(x, y)
    loc, ls, _ = (t.to(dev) for t in _t(*_params(5, d + 1)))
    kw = dict(lr0=0.05, lr_total=200, seed=12)
    whole = tfl.fused_train(g, n, NOISE, loc, ls, steps=200, **kw)
    half = tfl.fused_train(g, n, NOISE, loc, ls, steps=100, **kw)
    half = tfl.fused_train(g, n, NOISE, half[0], half[1], half[2],
                           steps=100, t0=100, **kw)
    for u, v in zip((whole[0], whole[1], *whole[2]),
                    (half[0], half[1], *half[2])):
        assert torch.equal(u, v)
