"""Parity of the port's fused hier-logistic trainer (``ops/fused_hier.py``)
with the JAX package's, and of its step math with autograd of the port's
DSL model.

Data come from the shared numpy recipe; parameters, block offsets and
noise are made with numpy and go to both packages.  The JAX side runs its
plain functions (``_step_math`` and ``reference_train``, which its Pallas
kernel's interpret mode also runs) on its 128-lane layout; ``interop`` maps
the lanes to the port's flat vectors.  Tolerances: one step's elbo rtol
2e-5 and gradients rtol 2e-4 / atol 2e-4 (the JAX test's own, against
autograd); 50-step trajectories losses rtol 1e-4, parameters and Adam
moments rtol 1e-4 / atol 1e-5 (float32 sums in another order, compounded
over the steps); the two entry points' posterior means as the JAX test
compares its pair.

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``
(at the bench shape, J 1, the largest J, F 1 and 8, a batch that is not a
multiple of the consumer threads, B = N, wrapped offsets and the instance
that reads its rows from L2), ``test_kernel_repeats_bit_for_bit`` and
``test_kernel_split_run_is_whole`` are marked ``gpu`` and skip here.  What
the CPU can check of it: ``test_kernel_arithmetic_precision`` emulates its
steps in numpy float32 in the kernel's own order (each consumer thread's
rows and lg2 chunks, the warps' sums, the tiles' group segments, the Adam
form on the producers' float64 schedule, ex2/lg2/rcp/sqrt at their PTX
ISA error bounds in both directions) against float64 for 50 steps at the bench shape
and holds it to ``chip_smoke.py`` phase 12's limits, and
``test_group_lists_cover_each_window_row_once`` rebuilds the kernel's
per-tile group order on ``pack_rows``' layout.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmm_log2_emulation as emu
from bayesic_tpu.ops import fused_hier as jfh
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.infer.svi import SVI, Adam, MeanFieldGuide
from bayesic_tpu_torch.models import hier_logistic as thl
from bayesic_tpu_torch.ops import _kernel_common as kc
from bayesic_tpu_torch.ops import fused_hier as tfh

torch.set_num_threads(2)

# the JAX trainer is specialised to J = 50 groups of F = 5 features
J, F, NPG, B = jfh.J, jfh.D, 40, 256
P = 2 + J + F


def _data(num_groups=J, num_features=F, obs_per_group=NPG):
    x, y, group, _ = thl.make_data(thl.Config(
        num_groups=num_groups, num_features=num_features,
        obs_per_group=obs_per_group))
    return x, y, group


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _params(seed, p=P):
    rng = np.random.default_rng(seed)
    loc = rng.normal(0, 0.5, p).astype(np.float32)
    ls = rng.normal(-2.0, 0.3, p).astype(np.float32)
    eps = rng.normal(0, 1, p).astype(np.float32)
    return loc, ls, eps


def test_step_math_matches_jax_lanes():
    x, y, group = _data()
    n = x.shape[0]
    loc, ls, eps = _params(0)
    off = 1937            # wraps around the end of the data
    packed = jfh.pack_data(x, y, group)
    xb = jnp.concatenate([packed, packed[:B]], 0)[off:off + B]
    jl, jls, jeps = interop.flat_to_lanes(_t(loc, ls, eps))
    jelbo, jg_loc, jg_ls = jfh._step_math(jnp.asarray(jl), jnp.asarray(jls),
                                          xb, jnp.asarray(jeps), n / B)
    tx, ty, tg = _t(x, y, group)
    xb_t, yb_t, gb_t = tfh._block(tx, ty.float(), tg, off, B)
    elbo, g_loc, g_ls = tfh._step_math(*_t(loc, ls), xb_t, yb_t, gb_t,
                                       torch.as_tensor(eps), n / B, J)
    np.testing.assert_allclose(float(elbo), float(jelbo), rtol=2e-5)
    for got, want in ((g_loc, jg_loc), (g_ls, jg_ls)):
        want = interop.lanes_to_flat([np.asarray(want)], P)[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("shape", [(8, 3), (J, F)])
def test_step_math_matches_dsl_autograd(shape):
    """The hand-derived step against autograd of the port's generic
    pipeline: the DSL model (non-centered, forced block mini-batch) under
    the ``MeanFieldGuide`` STL ELBO with the same noise."""
    j, f = shape
    x, y, group = _t(*_data(j, f))
    n, p = x.shape[0], 2 + j + f
    loc, ls, eps = _t(*_params(1, p))
    off = n - 17
    svi = SVI(thl.make_model(j, f, B), MeanFieldGuide, Adam(0.01),
              model_args=(x, y, group))
    params = {"loc": loc.clone().requires_grad_(True),
              "log_scale": ls.clone().requires_grad_(True)}
    idx = (off + torch.arange(B)) % n
    elbo = svi.elbo(params, None, subsample={"data__idx": idx},
                    eps=eps[None])
    g_loc, g_ls = torch.autograd.grad(elbo, [params["loc"],
                                             params["log_scale"]])
    want = tfh._step_math(loc, ls, *tfh._block(x, y.float(), group, off, B),
                          eps, n / B, j)
    np.testing.assert_allclose(float(want[0]), float(elbo.detach()),
                               rtol=2e-5)
    np.testing.assert_allclose(want[1].numpy(), g_loc.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(want[2].numpy(), g_ls.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_reference_train_matches_jax_50_steps():
    """50 steps of the port's plain trainer against the JAX
    ``reference_train`` on the same shuffled rows, offsets and noise,
    starting from a mid-run state (t0 = 3, nonzero Adam moments)."""
    x, y, group = _data()
    n, steps, t0, total = x.shape[0], 50, 3, 60
    rng = np.random.default_rng(2)
    perm = rng.permutation(n)
    x, y, group = x[perm], y[perm], group[perm]
    offs = rng.integers(0, n, steps)
    eps = rng.normal(size=(steps, P)).astype(np.float32)
    loc, ls, _ = _params(3)
    m1, m2 = (0.01 * rng.normal(size=(2, P))).astype(np.float32)
    v1, v2 = (1e-4 * rng.random((2, P))).astype(np.float32)
    flat = _t(loc, ls, m1, m2, v1, v2)
    lanes = [jnp.asarray(a) for a in interop.flat_to_lanes(flat)]
    eps_lanes = np.zeros((steps, 1, 128), np.float32)
    eps_lanes[:, 0, :P] = eps
    want = jfh.reference_train(
        jfh.pack_data(x, y, group), lanes[0], lanes[1], tuple(lanes[2:]),
        off_stream=jnp.asarray(offs), eps_stream=jnp.asarray(eps_lanes),
        lr0=0.03, lr_total=total, batch=B, t0=t0)
    got = tfh.reference_train(
        *_t(x, y, group), flat[0], flat[1], flat[2:],
        off_stream=torch.as_tensor(offs), eps_stream=torch.as_tensor(eps),
        lr0=0.03, lr_total=total, batch=B, t0=t0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-4)
    want_flat = interop.lanes_to_flat(
        [np.asarray(want[0]), np.asarray(want[1]),
         *map(np.asarray, want[2])], P)
    for g, w in zip((got[0], got[1], *got[2]), want_flat):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_cpu_fused_train_runs_the_kernels_streams():
    """On the CPU ``fused_train`` runs the plain trainer over the kernel's
    own Philox streams (``hier_streams``: counter (step_lo, 0, lane,
    step_hi)), continues them from ``t0`` and thins the losses by the
    kernel's rule; it launches nothing."""
    x, y, group = _t(*_data(8, 3))
    n, p = x.shape[0], 2 + 8 + 3
    off, eps = kc.hier_streams(11, 5, 4, n, p)
    w = kc.philox4x32_10(6, 0, torch.tensor([0, 3]), 0, 11, 0)
    assert int(off[1]) == int(kc.kernel_uniform_index(
        kc.uniform24(w[0][0]), n))
    np.testing.assert_allclose(float(eps[1, 2]), float(kc.box_muller(
        kc.uniform24(w[0][1]), kc.uniform24(w[1][1]))), rtol=1e-6)
    loc, ls, opt = tfh.init_params(8, 3)
    before = tfh.LAUNCHES
    a = tfh.fused_train(x, y, group, loc, ls, opt, steps=4, lr0=0.03,
                        lr_total=20, seed=11, batch=64, t0=5)
    b = tfh.reference_train(x, y, group, loc, ls, opt, off_stream=off,
                            eps_stream=eps, lr0=0.03, lr_total=20, batch=64,
                            t0=5)
    assert tfh.LAUNCHES == before
    torch.testing.assert_close(a[3], b[3], rtol=0, atol=0)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert tfh._thin(4100) == 3 and tfh._thin(2048) == 1


def test_entry_points_agree_on_the_posterior():
    """``run_svi`` (the generic engine) and ``run_svi_fused`` (the plain
    trainer here) on one small config: the JAX test's comparison of its
    two trainers, and both recover the generating beta."""
    cfg = thl.Config(num_groups=8, obs_per_group=40, num_features=3,
                     batch_size=64, svi_steps=800, device="cpu")
    gen = thl.run_svi(cfg)
    fus = thl.run_svi_fused(cfg)
    for out in (gen, fus):
        ls_ = out["losses"]
        assert np.isfinite(ls_).all()
        assert ls_[-50:].mean() < ls_[:50].mean()
    np.testing.assert_allclose(float(fus["mean_u"]["mu"]),
                               float(gen["mean_u"]["mu"]), atol=0.15)
    np.testing.assert_allclose(fus["mean_u"]["beta"].numpy(),
                               gen["mean_u"]["beta"].numpy(), atol=0.1)
    np.testing.assert_allclose(fus["mean_u"]["theta_raw"].numpy(),
                               gen["mean_u"]["theta_raw"].numpy(), atol=0.35)
    np.testing.assert_allclose(fus["mean_u"]["beta"].numpy(),
                               gen["truth"]["beta"], atol=0.25)
    gap = abs(gen["losses"][-100:].mean() - fus["losses"][-100:].mean())
    assert gap < 0.05 * abs(gen["losses"][-100:].mean())


def test_wrapper_checks():
    """Shapes and devices the kernel does not take raise in the wrapper
    (its checks run before any launch, so they are tested here)."""
    x, y, group = _t(*_data(8, 3))
    loc, ls, opt = tfh.init_params(8, 3)
    assert tfh._check(x, y, group, loc, ls, opt, 64) == (x.shape[0], 3, 8)
    with pytest.raises(ValueError, match="ls"):
        tfh._check(x, y, group, loc, ls[:-1], opt, 64)
    with pytest.raises(ValueError, match="batch"):
        tfh._check(x, y, group, loc, ls, opt, x.shape[0] + 1)
    with pytest.raises(ValueError, match="group"):
        tfh._check(x, y, group[:-1], loc, ls, opt, 64)
    wide = torch.zeros(x.shape[0], tfh.MAX_FEATURES + 1)
    p = 2 + 8 + wide.shape[1]
    with pytest.raises(ValueError, match="F <="):
        tfh._check(wide, y, group, *tfh.init_params(8, wide.shape[1])[:2],
                   tuple(torch.zeros(p) for _ in range(4)), 64)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfh.fused_train(meta, y, group, loc, ls, opt, steps=1, lr0=0.1)


# the kernel's constants, read from its source: consumer warps (one row a
# consumer thread at a time) and the rows a thread multiplies before a lg2
_CSRC = Path(tfh.__file__).resolve().parents[1] / "csrc"


def _consts():
    src = (_CSRC / "fused_hier.cu").read_text()
    lik = (_CSRC / "gmm_lik.cuh").read_text()
    cw = int(re.search(r"constexpr int CW = (\d+);", src).group(1))
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", lik).group(1))
    return cw, chunk


def _window(tiles, off, batch):
    """The window's tiles as the kernel stages them, ``(nt, F + 2, 32)``,
    and its rows' positions there: row r at tile (s0 + r) // 32, lane
    (s0 + r) % 32, s0 = off % 32."""
    c0, s0 = off // 32, off % 32
    return tiles[c0:c0 + (s0 + batch - 1) // 32 + 1], s0


def _segment_sums(order, d, j, cw, dtype=np.float32):
    """The kernel's group partials: ``order`` (nt, 32) the tiles' group-order
    words, ``d`` (nt, 32) their rows' values (zeros outside the window).
    Warp w takes tiles w, w + cw, ...; in each, position l of the group
    order gathers the d of lane ``order[l] & 31``, a Hillis-Steele scan adds
    each segment (from position ``(order[l] >> 5) & 31``; the rounds past
    the longest segment, which the kernel skips, add nothing), and the
    segment's last position (bit 10) adds its total to the warp's partial of
    group ``(order[l] >> 11) & 1023``.  Returns ``(cw, j)`` partials."""
    part = np.zeros((cw, j), dtype)
    lanes = np.arange(32)
    for tt in range(len(d)):
        o_ = order[tt]
        x = d[tt][o_ & 31].astype(dtype)
        lo = lanes - ((o_ >> 5) & 31)
        for o in (1, 2, 4, 8, 16):
            u = np.concatenate([np.zeros(o, dtype), x[:-o]])
            x = np.where(o <= lo, (x + u).astype(dtype), x)
        tail = (o_ & 1024) != 0
        w, g = tt % cw, (o_[tail] >> 11) & 1023
        part[w, g] = (part[w, g] + x[tail]).astype(dtype)
    return part


def _warp_totals(vals):
    """publish: each value's 32 lanes (last axis) in four accumulators,
    lane l into l % 4 in lane order, then (a0 + a1) + (a2 + a3)."""
    acc = np.zeros(vals.shape[:-1] + (4,), _F32)
    for lane in range(32):
        acc[..., lane % 4] = (acc[..., lane % 4] + vals[..., lane]
                              ).astype(_F32)
    return (_F32(acc[..., 0] + acc[..., 1])
            + _F32(acc[..., 2] + acc[..., 3])).astype(_F32)


@pytest.mark.parametrize("case", ["bench", "wrapped", "one group", "B = N",
                                  "B = 1"])
def test_group_lists_cover_each_window_row_once(case):
    """``pack_rows`` gives every window position its row, and the kernel's
    per-tile group order (rebuilt here as the kernel reads it) adds every
    row of the window once to its group's partials and nothing else:
    summing exact weights over the segments gives each group's sum over its
    window rows, at windows that wrap past the end of the data, a window of
    a single group, B = N and B = 1."""
    rng = np.random.default_rng(7)
    n, j, f, batch = 10_000, 50, 5, 1024
    group = rng.integers(0, j, n)
    if case == "one group":
        group = np.sort(group)
    batch = {"B = N": n, "B = 1": 1, "one group": 128}.get(case, batch)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, 2, n)
    tiles = tfh.pack_rows(*_t(x, y.astype(np.float32), group), batch).numpy()
    assert tiles.shape == ((n + batch - 2) // 32 + 1, f + 2, 32)
    offs = {"bench": [0, 31, 4321], "wrapped": [n - 1, n - 33, n - 500],
            "one group": [int(np.searchsorted(group, 0)) + 3,
                          int(np.searchsorted(group, 30)) + 10],
            "B = N": [0, 17, n - 1], "B = 1": [0, n - 1]}[case]
    for off in offs:
        rows = (off + np.arange(batch)) % n
        win, s0 = _window(tiles, off, batch)
        q = s0 + np.arange(batch)
        np.testing.assert_array_equal(win[q // 32, :f, q % 32], x[rows])
        yg = win[q // 32, f, q % 32].view(np.int32)
        np.testing.assert_array_equal(yg >> 1, group[rows])
        np.testing.assert_array_equal(yg & 1, y[rows])
        if case == "one group":
            assert len(np.unique(group[rows])) == 1
        weight = np.zeros(win.shape[0] * 32)
        weight[q] = rows + 1.0                    # exact in float64
        part = _segment_sums(win[:, f + 1].view(np.int32),
                             weight.reshape(-1, 32), j, 8, np.float64)
        want = np.zeros(j)
        np.add.at(want, group[rows], rows + 1.0)
        np.testing.assert_array_equal(part.sum(0), want)


# the PTX ISA bounds of the .approx functions (ex2 2 ulp, lg2 2^-22
# absolute, rcp 1 ulp; sqrt taken as 2^-22 relative, as for the linreg
# trainer)
SQRT_REL = 2.0 ** -22
_F32 = np.float32


def _approx(x64, rel, sign):
    return (np.asarray(x64, np.float64) * (1.0 + sign * rel)).astype(_F32)


def _schedule(t, lr0, lr_total):
    """The producers' (lr / bc1, 1 / bc2) of step t: the schedule in
    float64, rounded to float32."""
    lr = lr0 * 0.5 * (1 + np.cos(np.pi * min(t / lr_total, 1.0)))
    bc1 = -np.expm1((t + 1) * kc.LN_B1)
    bc2 = -np.expm1((t + 1) * kc.LN_B2)
    return _F32(lr / bc1), _F32(1 / bc2)


def _emulated_train(x, y, group, j, loc, ls, offs, eps, lr0, lr_total,
                    batch, sign):
    """The kernel's steps in numpy float32 in its order, every .approx at
    its bound in direction ``sign``; one loss per step (the injected
    mode).  Returns ``(loc, ls, losses, first step's (g_loc, g_ls), Adam
    moments (m1, m2, v1, v2))``."""
    cw, chunk = _consts()
    n, f = x.shape
    p = 2 + j + f
    scale = _F32(n / batch)
    fma = emu.fma
    c = _F32(tfh._C)
    tiles = tfh.pack_rows(*_t(x, y.astype(np.float32), group), batch).numpy()

    def ex2(v):          # exp(v) as ex2.approx of v log2 e
        return _approx(np.exp2(np.asarray(_F32(v * emu.LOG2E), np.float64)),
                       emu.EX2_REL, sign)

    def rcp(v):
        return _approx(1.0 / np.asarray(v, np.float64), emu.RCP_REL, sign)

    def adam(q, m, v, grad, c1, c2):
        grad = -grad
        m = fma(_F32(0.9), m, _F32(_F32(0.1) * grad))
        v = fma(_F32(0.999), v, _F32(_F32(_F32(0.001) * grad) * grad))
        s = _approx(np.sqrt(np.asarray(_F32(v * c2), np.float64)), SQRT_REL,
                    sign)
        r = rcp(_F32(s + _F32(1e-8)))
        return fma(-_F32(c1 * m), r, q), m, v

    m1, m2, v1, v2 = (np.zeros(p, _F32) for _ in range(4))
    loc, ls = loc.astype(_F32), ls.astype(_F32)
    els, emls = ex2(ls), ex2(-ls)
    losses, first = [], None
    for i in range(len(offs)):
        e = eps[i].astype(_F32)
        z = fma(els, e, loc)
        tau = ex2(z[1])
        term = np.concatenate([
            [_F32(_F32(_F32(-z[0] * z[0]) / _F32(50)) - _F32(np.log(5.0)))
             - c],
            [_F32(_F32(_F32(tfh._TAU_CONST) - _F32(tau * tau) / _F32(8))
                  + z[1])],
            _F32(_F32(_F32(-0.5) * z[2:]) * z[2:]) - c])
        tq = _F32(term - _F32(_F32(-ls - _F32(_F32(0.5) * e) * e) - c))
        # warp w takes tiles w, w + cw, ...: (m, warp, lane) by tile step
        win, s0 = _window(tiles, int(offs[i]), batch)
        nt = len(win)
        steps_m = -(-nt // cw)
        grid = np.zeros((steps_m * cw, f + 2, 32), _F32)
        grid[:nt] = win
        grid = grid.reshape(steps_m, cw, f + 2, 32)
        tt = np.arange(steps_m * cw).reshape(steps_m, cw, 1)
        r = 32 * tt + np.arange(32) - s0
        live = (r >= 0) & (r < batch)
        has = np.broadcast_to(tt < nt, live.shape)   # a thread's tiles
        xv = np.moveaxis(grid[:, :, :f], 2, -1)
        yg = grid[:, :, f].view(np.int32)
        g, yv = yg >> 1, (yg & 1) == 1
        th = z[2 + np.minimum(g, j - 1)]
        lgt = fma(tau, th, z[0])
        for k in range(f):
            lgt = fma(xv[..., k], z[2 + j + k], lgt)
        lv = np.where(yv, -lgt, lgt)
        ee = ex2(-np.abs(lgt))
        opl = _F32(1 + ee)
        rc = rcp(opl)
        sg = np.where(lv >= 0, rc, _F32(ee * rc))
        d = np.where(live, np.where(yv, -sg, sg), 0).astype(_F32)
        lin, lik2, sd, sth = (np.zeros((cw, 32), _F32) for _ in range(4))
        sx = np.zeros((f, cw, 32), _F32)
        prod = np.ones((cw, 32), _F32)
        for m in range(steps_m):
            on = live[m]
            lin = np.where(on, lin + np.maximum(lv[m], 0), lin).astype(_F32)
            prod = np.where(on, prod * opl[m], prod).astype(_F32)
            sd = _F32(sd + d[m])
            sth = fma(th[m], d[m], sth)
            for k in range(f):
                sx[k] = fma(d[m], xv[m, ..., k], sx[k])
            # a chunk's lg2, on the threads that had a tile in it
            end = has[m] & ((m % chunk == chunk - 1)
                            | ~has[min(m + 1, steps_m - 1)]
                            | (m == steps_m - 1))
            lg = (np.log2(np.asarray(prod, np.float64))
                  + sign * emu.LG2_ABS).astype(_F32)
            lik2 = np.where(end, lik2 + lg, lik2).astype(_F32)
            prod = np.where(end, _F32(1), prod)
        own = np.zeros(cw * 32, _F32)
        own[:p] = tq
        vals = np.stack([fma(emu.LN2, lik2, lin), own.reshape(cw, 32), sd,
                         sth, *sx])
        red = _warp_totals(vals)                     # (values, warps)
        tot = np.zeros(len(vals), _F32)
        for w in range(cw):                          # warps in order
            tot = _F32(tot + red[:, w])
        losses.append(fma(scale, tot[0], -tot[1]))
        part = _segment_sums(win[:, f + 1].view(np.int32),
                             d.reshape(-1, 32)[:nt], j, cw)
        seg = np.zeros(j, _F32)
        for w in range(cw):
            seg = _F32(seg + part[w])
        gz = np.empty(p, _F32)
        gz[0] = fma(-scale, tot[2], _F32(-z[0] * _F32(0.04)))
        gz[1] = fma(tau, _F32(-scale * tot[3]),
                    fma(_F32(_F32(-0.25) * tau), tau, _F32(1)))
        gz[2:2 + j] = fma(tau, _F32(-scale * seg), -z[2:2 + j])
        gz[2 + j:] = fma(-scale, tot[4:], -z[2 + j:])
        gz = fma(e, emls, gz)
        g_ls = _F32(gz * _F32(e * els))
        if first is None:
            first = (gz, g_ls)
        c1, c2 = _schedule(i, lr0, lr_total)
        loc, m1, v1 = adam(loc, m1, v1, gz, c1, c2)
        ls, m2, v2 = adam(ls, m2, v2, g_ls, c1, c2)
        els, emls = ex2(ls), ex2(-ls)
    return loc, ls, np.asarray(losses), first, (m1, m2, v1, v2)


def test_kernel_arithmetic_precision():
    """50 steps of the kernel's arithmetic, emulated in float32 with each
    .approx at its bound in both directions, at the bench shape (N 10,000,
    J 50, F 5, B 1,024), against a float64 plain step and trajectory, to
    ``chip_smoke.py`` phase 12's limits: the first step's loss within rel
    1e-5 and its gradients within 1e-4 rel + 1e-5 of the largest; the
    50-step losses within rel 1e-5; loc and log-scale within the ``gpu``
    test's rtol 1e-4 / atol 1e-5."""
    x, y, group = _data(obs_per_group=200)
    n, batch, steps = x.shape[0], 1024, 50
    rng = np.random.default_rng(12)
    perm = rng.permutation(n)
    x, y, group = x[perm], y[perm].astype(np.int64), group[perm]
    loc = rng.normal(0, 0.5, P).astype(np.float32)
    ls = rng.normal(-2.0, 0.3, P).astype(np.float32)
    offs = rng.integers(0, n, steps)
    offs[1] = n - 100                          # a window that wraps
    eps = rng.normal(size=(steps, P)).astype(np.float32)
    d64 = dict(dtype=torch.float64)
    xt, yt, gt = (torch.as_tensor(x, **d64), torch.as_tensor(y, **d64),
                  torch.as_tensor(group))
    zeros = tuple(torch.zeros(P, **d64) for _ in range(4))
    want = tfh.reference_train(
        xt, yt, gt, torch.as_tensor(loc, **d64), torch.as_tensor(ls, **d64),
        zeros, off_stream=torch.as_tensor(offs),
        eps_stream=torch.as_tensor(eps, **d64), lr0=0.03, lr_total=3000,
        batch=batch)
    elbo, g_loc, g_ls = tfh._step_math(
        torch.as_tensor(loc, **d64), torch.as_tensor(ls, **d64),
        *tfh._block(xt, yt, gt, int(offs[0]), batch),
        torch.as_tensor(eps[0], **d64), n / batch, J)
    for sign in (1.0, -1.0):
        got = _emulated_train(x, y, group, J, loc, ls, offs, eps, 0.03, 3000,
                              batch, sign)
        assert abs(got[2][0] + float(elbo)) <= 1e-5 * abs(float(elbo))
        for g_, w_ in zip(got[3], (g_loc.numpy(), g_ls.numpy())):
            tol = 1e-4 * np.abs(w_) + 1e-5 * np.abs(w_).max()
            assert (np.abs(g_ - w_) <= tol).all(), np.abs(g_ - w_) / tol
        np.testing.assert_allclose(got[2], want[3].numpy(), rtol=1e-5)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (J, F, rows a group, B): the bench shape; one group; the largest J the
# wrapper takes (2 + J + F = 1,024); F 1 and F 8; a batch that is not a
# multiple of the consumer threads; B = N (the rows read from L2); a
# bench-data batch too large to stage
GPU_SHAPES = {"bench": (J, F, 200, 1024), "J 1": (1, 3, 500, 256),
              "J max": (1020, 2, 2, 512), "F 1": (20, 1, 30, 300),
              "F 8": (20, 8, 30, 300), "B odd": (J, F, 40, 777),
              "B = N": (J, F, 40, 2000), "L2": (J, F, 200, 4096)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(GPU_SHAPES))
def test_kernel_matches_plain(shape):
    """On a CUDA card: one injected step's gradients (read off Adam's first
    moment), a 30-step injected trajectory whose first offsets wrap past
    the end of the data, and a 40-step Philox run equal the plain version
    on the card (rtol 1e-4), at each shape of ``GPU_SHAPES``; the launch
    takes the staged instance exactly where its slots fit."""
    dev = _card()
    j, f, npg, b = GPU_SHAPES[shape]
    x, y, group = (a.to(dev) for a in _t(*_data(j, f, npg)))
    n, p = x.shape[0], 2 + j + f
    geo = tfh.geometry(f, j, b)
    assert (geo["instance"] == "l2") == (shape in ("B = N", "L2"))
    rng = np.random.default_rng(4)
    loc, ls, opt = tfh.init_params(j, f, device=dev)
    for steps in (1, 30):
        offs = rng.integers(0, n, steps)
        offs[:3] = (n - 1, n - b // 2, n - 31)[:steps]
        offs = torch.as_tensor(offs, device=dev)
        eps = torch.as_tensor(rng.normal(size=(steps, p)).astype(np.float32),
                              device=dev)
        kw = dict(off_stream=offs, eps_stream=eps, lr0=0.03, lr_total=60,
                  batch=b)
        before = tfh.LAUNCHES
        got = tfh.fused_train_injected(x, y, group, loc, ls, opt, **kw)
        torch.cuda.synchronize()
        assert tfh.LAUNCHES == before + 1
        want = tfh.reference_train(x, y, group, loc, ls, opt, **kw)
        torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
        for g, w in zip((got[0], got[1], *got[2]),
                        (want[0], want[1], *want[2])):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    got = tfh.fused_train(x, y, group, loc, ls, opt, steps=40, lr0=0.03,
                          seed=9, batch=b)
    off, eps = kc.hier_streams(9, 0, 40, n, p, device=dev)
    want = tfh.reference_train(x, y, group, loc, ls, opt, off_stream=off,
                               eps_stream=eps, lr0=0.03, lr_total=40,
                               batch=b)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["bench", "L2"])
def test_kernel_repeats_bit_for_bit(shape):
    """Two launches of the same run give the same bits: no float atomics,
    and the groups' lists in a fixed order."""
    dev = _card()
    j, f, npg, b = GPU_SHAPES[shape]
    x, y, group = (a.to(dev) for a in _t(*_data(j, f, npg)))
    start = tfh.init_params(j, f, device=dev)
    runs = [tfh.fused_train(x, y, group, *start, steps=300, lr0=0.03,
                            seed=5, batch=b) for _ in range(2)]
    for a, b_ in zip((runs[0][0], runs[0][1], *runs[0][2], runs[0][3]),
                     (runs[1][0], runs[1][1], *runs[1][2], runs[1][3])):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_kernel_split_run_is_whole():
    """A run split at t0 (the second call continuing the schedule, the bias
    correction and the Philox counter from t0) equals the whole run bit for
    bit."""
    dev = _card()
    j, f, npg, b = GPU_SHAPES["bench"]
    x, y, group = (a.to(dev) for a in _t(*_data(j, f, npg)))
    loc, ls, opt = tfh.init_params(j, f, device=dev)
    kw = dict(lr0=0.03, lr_total=200, seed=3, batch=b)
    whole = tfh.fused_train(x, y, group, loc, ls, opt, steps=200, **kw)
    a = tfh.fused_train(x, y, group, loc, ls, opt, steps=70, **kw)
    b_ = tfh.fused_train(x, y, group, a[0], a[1], a[2], steps=130, t0=70,
                         **kw)
    for u, v in zip((whole[0], whole[1], *whole[2]), (b_[0], b_[1], *b_[2])):
        assert torch.equal(u, v)
    assert torch.equal(whole[3], torch.cat([a[3], b_[3]]))
