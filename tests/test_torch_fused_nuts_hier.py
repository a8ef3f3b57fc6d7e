"""Parity of the port's fused hier-logistic NUTS transition
(``ops/fused_nuts_hier.py``) with the JAX package.

Data come from the shared numpy recipe; chain states, momenta and the
transition's random streams are made with numpy and go to both packages.
The JAX side runs its plain functions: the lane-packed potential at
``mm_dtype=float32`` and the shared transition core
``_nuts_transition_core`` (what its Pallas kernel runs in interpret mode)
with ``turn_mask`` on the real lanes.  Its pad lanes are set to zero in q
and in the momentum: a pad's force is -q_pad = 0, so the pads stay at 0
and add nothing to any energy, and the 128-lane transition is the
D-dimensional one the port runs.  Tolerances: potential pe rtol 1e-5,
grad within 1e-4 * max|grad| (float32 sums over the rows in another
order); one transition: equal depth, num_steps and diverging, q' / pe' /
h0 rtol 1e-5 (q' with atol 1e-5); the fused and generic posteriors as the
JAX test compares its pair.

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``
is marked ``gpu`` and skips here.  What the kernel adds on the CPU's side
is held here: ``hier_data``'s chunk layout of the rows (every row once, no
chunk across a group, y packed and unpacked), and the kernel's row loop,
emulated in numpy float32 in its chunk order with every ex2, lg2 and rcp
moved to its PTX ISA bound (``tests/gmm_log2_emulation.py``'s constants),
against float64: pe rel 1e-5, grad within 1e-4 of max|grad|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmm_log2_emulation as emu
from bayesic_tpu.ops import fused_nuts as jfn
from bayesic_tpu.ops import fused_nuts_hier as jfnh
from bayesic_tpu_torch.infer.mcmc import MCMC, StreamKey, nuts_streams
from bayesic_tpu_torch.models import hier_logistic as thl
from bayesic_tpu_torch.ops import fused_nuts_hier as tfnh

torch.set_num_threads(2)

J, NPG, F = 8, 40, 3
D = 2 + J + F
C, K = 8, 5
KCHUNK = 16              # rows a lg2 (kChunk of csrc/gmm_lik.cuh)


def _data(num_groups=J, obs_per_group=NPG, num_features=F):
    x, y, group, _ = thl.make_data(thl.Config(
        num_groups=num_groups, obs_per_group=obs_per_group,
        num_features=num_features))
    return x, y, group


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _skewed(npg, num_features=F, seed=7):
    """x, y, group of groups of ``npg`` rows, shuffled, from a seed."""
    rng = np.random.default_rng(seed)
    group = np.repeat(np.arange(len(npg)), npg)
    rng.shuffle(group)
    x = rng.normal(size=(group.size, num_features)).astype(np.float32)
    y = (rng.random(group.size) < 0.5).astype(np.float32)
    return x, y, group


def _streams(seed, c=C, kk=K, scale=0.4):
    """A start point near the posterior's bulk, momenta and the streams,
    as ``make_batched_transition_hier`` hands them to the kernel: exact
    +-1 signs and strictly negative log-uniforms."""
    rng = np.random.default_rng(seed)
    q = (scale * rng.normal(size=(c, D))).astype(np.float32)
    q[:, 0] += 0.5                         # mu
    q[:, 2:2 + J] += 0.5                   # theta around mu
    mom = rng.normal(size=(c, D)).astype(np.float32)
    sign = np.where(rng.random((c, kk)) < 0.5, 1.0, -1.0).astype(np.float32)
    lua = np.log(np.maximum(rng.random((c, kk)), 1e-38)).astype(np.float32)
    lul = np.log(np.maximum(rng.random((c, 1 << kk)), 1e-38)) \
        .astype(np.float32)
    return q, mom, sign, lua, lul


def _lanes(a, fill=0.0):
    out = np.full((a.shape[0], 128), fill, np.float32)
    out[:, :D] = a
    return jnp.asarray(out)


def _jax_pg():
    x, y, group = _data()
    design = jfnh.build_design(x, y, group, J)
    return jfnh.make_hier_potential(*design, J, F, mm_dtype=jnp.float32)


def _port_data():
    return tfnh.hier_data(*_t(*_data()), J)


def test_hier_data_sorts_rows_by_group():
    x, y, group = _data()
    rng = np.random.default_rng(0)
    perm = rng.permutation(x.shape[0])
    data = tfnh.hier_data(*_t(x[perm], y[perm], group[perm]), J)
    assert data.offsets.dtype == torch.int32
    np.testing.assert_array_equal(data.offsets.numpy(),
                                  np.arange(J + 1) * NPG)
    assert bool(torch.all(data.group[1:] >= data.group[:-1]))
    for j in range(J):
        rows = slice(j * NPG, (j + 1) * NPG)
        want = np.sort(x[perm][group[perm] == j], axis=0)
        np.testing.assert_array_equal(np.sort(data.x[rows].numpy(), axis=0),
                                      want)
    with pytest.raises(ValueError, match="group ids"):
        tfnh.hier_data(*_t(x, y, group), J - 1)


def _positions(data):
    """Each sorted row's position (m depth + i) B + t in the kernel's
    layout (row i of chunk m B + t, B = ``CHUNK_THREADS``)."""
    return tfnh._positions(data.chunks.numpy(), tfnh._depth_nch(data)[0])


def _x_at_positions(data):
    """The layout's x, one row of F a position."""
    return data.xc.numpy().transpose(0, 1, 3, 2).reshape(-1, data.x.shape[1])


@pytest.mark.parametrize("npg", [[40] * J, [1, 0, 3, 977, 2, 50, 1200, 7],
                                 [3] * 1099 + [70_000]])
def test_hier_data_chunks_cover_every_row_once(npg):
    """Every sorted row lies in exactly one chunk, no chunk crosses a group
    or holds more than ``depth`` rows, the chunks number at most B + J (B
    = ``CHUNK_THREADS``; a multiple of B with the empty ones), the rows of
    the chunks c, c + B, c + 2B, ... (a share of one thread's) are at most
    (1 + ceil(J / B)) ceil(N / B), a group's chunks differ by at most one
    row, and the same input gives the same layout; also past B groups,
    one of them over 65,536 rows."""
    j, b = len(npg), tfnh.CHUNK_THREADS
    x, y, group = _skewed(npg)
    n = group.size
    data = tfnh.hier_data(*_t(x, y, group), j)
    depth, nch = tfnh._depth_nch(data)
    start, rows, grp = data.chunks.numpy()
    assert nch % b == 0
    assert int((rows > 0).sum()) <= b + j
    assert rows.max() == depth
    assert nch // b * depth <= (1 + -(-j // b)) * -(-n // b)
    cover = np.zeros(n, int)
    off = data.chunk_off.numpy()
    for g in range(j):
        for c in range(off[g], off[g + 1]):
            assert grp[c] == g and 0 < rows[c] <= depth
            cover[start[c]:start[c] + rows[c]] += 1
            assert bool(torch.all(data.group[start[c]:start[c] + rows[c]]
                                  == g))
        sizes = rows[off[g]:off[g + 1]]
        assert sizes.sum() == npg[g]
        assert sizes.size == 0 or np.ptp(sizes) <= 1
    assert (cover == 1).all() and (rows[off[-1]:] == 0).all()
    np.testing.assert_array_equal(_x_at_positions(data)[_positions(data)],
                                  data.x.numpy())
    again = tfnh.hier_data(*_t(x, y, group), j)
    for got, want in zip(data, again):
        assert torch.equal(got, want)


def test_hier_data_packed_y_round_trips():
    """The bits of ``ybits`` at each row's position are its y, every other
    bit is 0, and a y outside {0, 1} raises."""
    data = _port_data()
    bits = np.unpackbits(data.ybits.numpy().view(np.uint8),
                         bitorder="little")
    pos = _positions(data)
    np.testing.assert_array_equal(bits[pos], data.y.numpy())
    assert bits.sum() == data.y.sum()
    x, y, group = _data()
    with pytest.raises(ValueError, match="0 or 1"):
        tfnh.hier_data(*_t(x, y + 0.5, group), J)


def _emulated_potential(data, q, sign):
    """pe and grad of ``csrc/fused_nuts_hier.cu``'s HierPotential in numpy
    float32, in its order: thread t of ``THREADS`` takes chunks t,
    t + THREADS, ...; each row's logit is an fma chain, exp(-|l|) an ex2,
    the sigmoid an rcp of 1 + e, log1p a lg2 of the product of up to
    ``KCHUNK`` rows' 1 + e, every one moved by ``sign`` times its bound;
    the lanes' sums are warp butterflies, the likelihood's then a butterfly
    over the warps, the beta gradient's added in warp order; a group's
    theta gradient sums its chunks in order."""
    f32, fma = emu.F32, emu.fma
    b, nt = tfnh.CHUNK_THREADS, tfnh.THREADS
    depth, nch = tfnh._depth_nch(data)
    xc = data.xc.numpy()                              # (M, depth, F, B)
    bits = np.unpackbits(data.ybits.numpy().view(np.uint8),
                         bitorder="little").reshape(-1, depth, b)
    _, rows, grp = data.chunks.numpy()
    off = data.chunk_off.numpy()
    j, f = tfnh._dims(data)
    c_n = q.shape[0]
    q = q.astype(f32)
    bk = q[:, 2 + j:]
    lin = np.zeros((c_n, nt), f32)
    lik2 = np.zeros((c_n, nt), f32)
    gb = np.zeros((c_n, nt, f), f32)
    tp = np.zeros((c_n, nch), f32)
    for c in np.arange(nch).reshape(-1, nt):          # one chunk a thread
        m, t = c // b, c % b
        th = q[:, 2 + grp[c]]
        s = np.zeros((c_n, nt), f32)
        prod = np.ones((c_n, nt), f32)
        for i in range(depth):
            on = i < rows[c]
            l = th
            xv = xc[m, i, :, t].T                             # (f, nt)
            for k in range(f):
                l = fma(xv[k][None], bk[:, k:k + 1], l)
            yv = bits[m, i, t].astype(bool)[None]
            lv = np.where(yv, -l, l)
            a = (np.abs(l) * emu.LOG2E).astype(f32)
            e = (np.exp2(-np.asarray(a, np.float64))
                 * (1 + sign * emu.EX2_REL)).astype(f32)
            opl = (1 + e).astype(f32)
            rc = (1.0 / np.asarray(opl, np.float64)
                  * (1 + sign * emu.RCP_REL)).astype(f32)
            sg = np.where(lv >= 0, rc, (e * rc).astype(f32))
            d = np.where(yv, -sg, sg)
            prod = np.where(on, (prod * opl).astype(f32), prod)
            lin = np.where(on, (lin + np.maximum(lv, 0)).astype(f32), lin)
            s = np.where(on, (s + d).astype(f32), s)
            gb = np.where(on[..., None], fma(d[..., None], xv.T[None], gb),
                          gb)
            end = on & ((i % KCHUNK == KCHUNK - 1) | (i == rows[c] - 1))
            lg = (np.log2(np.asarray(prod, np.float64))
                  + sign * emu.LG2_ABS).astype(f32)
            lik2 = np.where(end, (lik2 + lg).astype(f32), lik2)
            prod = np.where(end, f32(1), prod)
        tp[:, c] = s
    warps = nt // 32
    lw = emu.butterfly(fma(emu.LN2, lik2, lin).reshape(c_n, warps, 32))
    bw = emu.butterfly(np.moveaxis(gb.reshape(c_n, warps, 32, f), 2, -1))
    lik = emu.butterfly(np.pad(lw[:, :, 0], ((0, 0), (0, 32 - warps))))[:, 0]
    gbeta = np.zeros((c_n, f), f32)
    for w in range(warps):
        gbeta = (gbeta + bw[:, w, :, 0]).astype(f32)
    gth = np.zeros((c_n, j), f32)
    for g in range(j):
        for c in range(off[g], off[g + 1]):
            gth[:, g] = (gth[:, g] + tp[:, c]).astype(f32)
    return lik, gth, gbeta


def _f64_likelihood(data, q):
    """The likelihood's value and its theta and beta gradients in
    float64."""
    j, _ = tfnh._dims(data)
    x = data.x.numpy().astype(np.float64)
    y = data.y.numpy().astype(np.float64)
    grp = data.group.numpy()
    q = q.astype(np.float64)
    l = q[:, 2 + grp] + q[:, 2 + j:] @ x.T
    lik = np.sum(np.logaddexp(0.0, l) - y * l, 1)
    d = 1.0 / (1.0 + np.exp(-l)) - y
    gth = np.stack([d[:, grp == g].sum(1) for g in range(j)], 1)
    return lik, gth, d @ x


@pytest.mark.parametrize("shape", [(J, NPG, F), (50, 400, 5)])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_row_loop_arithmetic_precision(shape, sign):
    """The kernel's SFU row loop, emulated in float32 at the PTX ISA bounds
    of ex2, lg2 and rcp in its chunk order, against float64: the
    likelihood (which pe adds to a float32 prior) to rel 1e-5 of pe, the
    theta and beta gradients within 1e-4 of max|grad|; at the test shape
    (one row a chunk) and at 20,000 rows (20 rows a chunk, two lg2 a
    chunk)."""
    j, npg, f = shape
    x, y, group = _data(j, npg, f)
    data = tfnh.hier_data(*_t(x, y, group), j)
    assert tfnh._depth_nch(data)[0] == (1 if npg == NPG else 20)
    rng = np.random.default_rng(11)
    q = (0.5 + 0.4 * rng.normal(size=(4, 2 + j + f))).astype(np.float32)
    lik, gth, gbeta = _emulated_potential(data, q, sign)
    want_lik, want_gth, want_gb = _f64_likelihood(data, q)
    pe, grad = tfnh.hier_potential(data)(torch.as_tensor(q))   # scales
    np.testing.assert_allclose(lik, want_lik, rtol=0,
                               atol=1e-5 * float(pe.abs().min()))
    np.testing.assert_allclose(np.concatenate([gth, gbeta], 1),
                               np.concatenate([want_gth, want_gb], 1),
                               rtol=0, atol=1e-4 * float(grad.abs().max()))


def test_potential_matches_jax_and_autograd():
    """pe and grad against the JAX lane-packed potential (pads at zero)
    and against autograd of the port's centered DSL model."""
    q = _streams(1)[0] * 2.0
    jpe, jg = _jax_pg()(_lanes(q))
    pe, g = tfnh.fused_hier_nuts_potential(torch.as_tensor(q), _port_data())
    assert pe.shape == (C, 1) and g.shape == (C, D)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg)[:, :D], rtol=0,
                               atol=1e-4 * scale)
    mcmc = MCMC(thl.make_model(J, F, None, centered=True), num_chains=C,
                model_args=_t(*_data()))
    ape, ag = mcmc._potential_and_grad(torch.as_tensor(q))
    np.testing.assert_allclose(pe[:, 0].numpy(), ape.detach().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), ag.detach().numpy(), rtol=0,
                               atol=1e-4 * scale)


def _compare(got, want):
    names = ("q", "pe", "grad", "accept", "diverging", "depth", "num_steps",
             "h0")
    got = [np.asarray(a).reshape(C, -1) for a in got]
    want = [np.asarray(a).reshape(C, -1) for a in want]
    want[0], want[2] = want[0][:, :D], want[2][:, :D]
    for i in (4, 5, 6):
        np.testing.assert_array_equal(got[i], want[i], err_msg=names[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5,
                               err_msg="q")
    for i in (1, 7):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5,
                                   err_msg=names[i])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-6,
                               err_msg="accept")


@pytest.mark.parametrize("eps", [0.02, 0.08, 2.0])
def test_reference_transition_matches_jax_core(eps):
    """One whole transition of ``reference_transition`` against the JAX
    core over the lane-packed potential with zeroed pads and the U-turn
    mask on the real lanes.  eps 2.0 makes every chain diverge."""
    q, mom, sign, lua, lul = _streams(2)
    rng = np.random.default_rng(3)
    inv_mass = rng.uniform(0.5, 1.5, (1, D)).astype(np.float32)
    jpg = _jax_pg()
    jq = _lanes(q)
    jpe, jg = jpg(jq)
    turn_mask = jnp.asarray((np.arange(128) < D)[None].astype(np.float32))
    want = jfn._nuts_transition_core(
        jq, jpe, jg, _lanes(mom), jnp.asarray(sign), jnp.asarray(lua),
        jnp.asarray(lul), jnp.asarray(eps, jnp.float32),
        _lanes(inv_mass, 1.0), jpg, K, turn_mask=turn_mask)
    assert float(jnp.abs(want[0][:, D:]).max()) == 0.0   # pads stay at 0
    data = _port_data()
    tq = torch.as_tensor(q)
    tpe, tg = tfnh.fused_hier_nuts_potential(tq, data)
    before = tfnh.LAUNCHES
    got = tfnh.fused_hier_nuts_transition(
        tq, tpe, tg, *_t(mom, sign, lua, lul), eps,
        torch.as_tensor(inv_mass), data, max_doublings=K)
    assert tfnh.LAUNCHES == before        # a CPU tensor runs the plain path
    _compare(got, want)
    if eps > 1.0:
        assert bool(torch.all(got[4] == 1.0))
    else:
        assert bool(torch.all(got[5] >= 1.0))
        assert bool(torch.any(got[0] != tq))


def test_state_consistency_under_zero_log_u():
    """Every leaf log-uniform exactly 0: the first-leaf guard must still
    fill each subtree's proposal, so pe' == pe(q') holds."""
    data = _port_data()
    q, mom, sign, lua, _ = _streams(4)
    tq = torch.as_tensor(q)
    pe, g = tfnh.fused_hier_nuts_potential(tq, data)
    for eps in (0.02, 0.1):
        out = tfnh.reference_transition(
            tq, pe, g, *_t(mom, sign, lua), torch.zeros(C, 1 << K), eps,
            torch.ones(D), data, max_doublings=K)
        pe_chk, g_chk = tfnh.fused_hier_nuts_potential(out[0], data)
        np.testing.assert_allclose(out[1].numpy(), pe_chk.numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out[2].numpy(), g_chk.numpy())


def test_wrapper_checks():
    """Inputs the kernel does not take raise in the wrapper (its checks run
    before any launch, so they are tested here on CPU tensors)."""
    data = _port_data()
    q = torch.zeros(2, D)
    assert tfnh._check_data(q, data) == (J, F)
    with pytest.raises(ValueError, match="q must be"):
        tfnh._check_data(torch.zeros(2, D + 1), data)
    with pytest.raises(ValueError, match="offsets"):
        tfnh._check_data(q, data._replace(offsets=data.offsets.long()))
    with pytest.raises(ValueError, match="unsupported device"):
        tfnh.fused_hier_nuts_potential(q.to("meta"), data)


def test_fused_sampler_matches_generic_posterior():
    """The two NUTS entry points on one small centered posterior (8
    chains, both at most 5 doublings): ``fused_nuts_mcmc`` (plain version
    on the CPU) and ``MCMC`` on the DSL model give marginal moments within
    MC error, as ``tests/test_fused_nuts_hier.py`` checks the JAX pair."""
    j, f = 6, 2
    x, y, group = _t(*_data(j, 50, f))
    chains, warm, samp = 8, 60, 60
    mcmc_f = thl.fused_nuts_mcmc(j, f, x, y, group, num_warmup=warm,
                                 num_samples=samp, num_chains=chains,
                                 max_doublings=5)
    assert mcmc_f.batched_transition is not None
    res_f = mcmc_f.run(0)
    res_g = MCMC(thl.make_model(j, f, None, centered=True), num_warmup=warm,
                 num_samples=samp, num_chains=chains, shared_adapt=True,
                 model_args=(x, y, group), target_accept=0.85,
                 max_depth=5).run(1)
    for site in ("mu", "tau", "theta", "beta"):
        fs = res_f.samples[site].reshape(chains * samp, -1).numpy()
        gs = res_g.samples[site].reshape(chains * samp, -1).numpy()
        assert np.isfinite(fs).all() and np.isfinite(gs).all()
        se = (fs.std(0) + gs.std(0)) / np.sqrt(200.0) + 0.02
        np.testing.assert_array_less(np.abs(fs.mean(0) - gs.mean(0)),
                                     5 * se, err_msg=site)
        np.testing.assert_allclose(fs.std(0), gs.std(0), rtol=0.3,
                                   atol=0.05, err_msg=site)
    assert int(res_f.extra["tree_depth"].max()) <= 5
    assert int(res_f.extra["diverging"].sum()) < 0.15 * chains * samp


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card: the kernel's potential and one transition equal the
    plain version's on the card (discrete outputs on every chain, values to
    rtol 1e-4), at the test shape and at K = 10 (the rows resident in
    shared memory; at an odd chain count too, each chain bit for bit as in
    the even launch), and at 20,000 rows, F 5 (too many for shared memory:
    the instance that reads them from device memory); and past 1,024
    groups, skewed (2,048 chunks): J 1,100 of 2 rows beside one of 300
    (resident) and of 4 rows beside one of 5,000 (from device memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for (j, f), rows, instance in (
            ((J, F), _data(J, NPG, F), "resident"),
            ((50, 5), _data(50, 400, 5), "l2"),
            ((1100, 3), _skewed([2] * 1099 + [300]), "resident"),
            ((1100, 3), _skewed([4] * 1099 + [5000]), "l2")):
        d = 2 + j + f
        data = tfnh.hier_data(*(a.to(dev) for a in _t(*rows)), j)
        for kk in (K, 10):
            geo = tfnh.hier_geometry(data, kk)
            assert geo["instance"] == instance
            assert geo["chunks"] == (2048 if j > 1024 else 1024)
            rng = np.random.default_rng(5)
            q = torch.as_tensor(
                (0.5 + 0.2 * rng.normal(size=(C, d))).astype(np.float32),
                device=dev)
            pe, g = tfnh.fused_hier_nuts_potential(q, data)
            rpe, rg = tfnh.hier_potential(data)(q)
            torch.testing.assert_close(pe[:, 0], rpe, rtol=1e-5, atol=0)
            torch.testing.assert_close(g, rg, rtol=0,
                                       atol=1e-5 * float(rg.abs().max()))
            s = nuts_streams(StreamKey(5, 2, kk), C, d, kk, dev)
            args = (q, pe, g, *s, 0.05 if j == J else 0.01,
                    torch.ones(d, device=dev), data)
            before = tfnh.LAUNCHES
            got = tfnh.fused_hier_nuts_transition(*args, max_doublings=kk)
            torch.cuda.synchronize()
            assert tfnh.LAUNCHES == before + 1
            want = tfnh.reference_transition(*args, max_doublings=kk)
            for i in (4, 5, 6):
                torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
            for i in (0, 1, 7):
                torch.testing.assert_close(got[i], want[i], rtol=1e-4,
                                           atol=1e-4)
            odd = tfnh.fused_hier_nuts_transition(
                *(a[:C - 1] for a in args[:7]), *args[7:],
                max_doublings=kk)
            odd_pe, odd_g = tfnh.fused_hier_nuts_potential(q[:C - 1], data)
            torch.cuda.synchronize()
            for a, b in zip(odd, got):
                assert torch.equal(a, b[:C - 1])
            assert torch.equal(odd_pe, pe[:C - 1])
            assert torch.equal(odd_g, g[:C - 1])
    with pytest.raises(ValueError, match="max_doublings"):
        tfnh.fused_hier_nuts_transition(*args, max_doublings=13)
