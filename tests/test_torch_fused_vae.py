"""Parity of the port's fused DLGM trainer (``ops/fused_vae.py``) and its
device helpers (``ops/_kernel_common.py``) with the JAX package.

Inputs and noise come from numpy with a seed and go to both packages.  The
JAX side runs its plain functions and its Pallas kernel in interpret mode,
as ``tests/test_fused_vae.py`` does.  Tolerances are those of that file:
step math and hand backward rtol 2e-4 / atol 2e-5, Adam rtol 1e-5 /
atol 1e-7, 5-step trajectories losses rtol 1e-4 / atol 1e-3, params
rtol 1e-4 / atol 1e-5, Adam v rtol 1e-3 / atol 1e-6.

The kernel itself runs only on a CUDA card: the tests marked ``gpu`` skip
here.  On the CPU, ``test_operand_split_precision`` emulates the kernel's
tensor-core arithmetic (TF32 operands, split or not) at the bench widths.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.ops import _kernel_common as jkc
from bayesic_tpu.ops import fused_vae as jfv
from bayesic_tpu_torch.models import dlgm as tdlgm
from bayesic_tpu_torch.ops import _kernel_common as tkc
from bayesic_tpu_torch.ops import fused_vae as tfv

torch.set_num_threads(2)

DIMS = tfv.FusedVAEDims(n=200, d=12, h=16, z=4, b=32)


def _init(seed, dims=DIMS):
    """numpy leaves as tests/test_fused_vae.py draws them: weights
    N(0, 1/fan_in), zero biases and usig; zero Adam state."""
    rng = np.random.default_rng(seed)
    shapes = tfv.leaf_shapes(dims)
    params, m, v = {}, {}, {}
    for name in tfv.LEAVES:
        s = shapes[name]
        if name.startswith("w"):
            p = rng.normal(size=s) / np.sqrt(s[0])
        else:
            p = np.zeros(s)
        params[name] = p.astype(np.float32)
        m[name] = np.zeros(s, np.float32)
        v[name] = np.zeros(s, np.float32)
    return params, m, v


def _data(seed):
    return np.random.default_rng(seed).normal(
        size=(DIMS.n, DIMS.d)).astype(np.float32)


def _streams(seed, steps):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, DIMS.n, (steps, DIMS.b))
    eps = rng.normal(size=(steps, DIMS.b, DIMS.z)).astype(np.float32)
    return idx, eps


def _j(tree):
    return {k: jnp.asarray(a) for k, a in tree.items()}


def _t(tree):
    return {k: torch.as_tensor(a) for k, a in tree.items()}


def _np(tree):
    return {k: np.asarray(a) for k, a in tree.items()}


def test_step_math_matches_jax():
    params, _, _ = _init(0)
    x = _data(99)
    idx, eps = _streams(98, 1)
    xb, e0 = x[idx[0]], eps[0]
    scale = DIMS.n / DIMS.b
    je, jg = jfv._step_math(tuple(jnp.asarray(params[k])
                                  for k in jfv.LEAVES),
                            jnp.asarray(xb), jnp.asarray(e0), scale)
    te, tg = tfv._step_math(tuple(torch.as_tensor(params[k])
                                  for k in tfv.LEAVES),
                            torch.as_tensor(xb), torch.as_tensor(e0), scale)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    for name, a, b in zip(tfv.LEAVES, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_hand_backward_matches_autograd():
    """_step_math's hand-derived grads == autograd of its forward value
    (STL: q-params detached inside log q only)."""
    params, _, _ = _init(1)
    x = _data(97)
    idx, eps = _streams(96, 1)
    xb, e0 = torch.as_tensor(x[idx[0]]), torch.as_tensor(eps[0])
    scale = DIMS.n / DIMS.b
    p = tuple(torch.as_tensor(params[k]).requires_grad_(True)
              for k in tfv.LEAVES)
    elbo, grads = tfv._step_math(tuple(q.detach() for q in p), xb, e0,
                                 scale)

    (w1e, b1e, wmu, bmu, wsig, bsig, w1d, b1d, w2d, b2d, usig) = p
    c = tfv._C
    h1 = torch.tanh(xb @ w1e + b1e)
    mu = h1 @ wmu + bmu
    ls = torch.clamp(h1 @ wsig + bsig, -6.0, 3.0)
    z = mu + torch.exp(ls) * e0
    zz = (z - mu.detach()) * torch.exp(-ls.detach())
    logq = torch.sum(-0.5 * zz * zz - ls.detach() - c)
    mx = torch.tanh(z @ w1d + b1d) @ w2d + b2d
    s0 = usig[0, 0]
    prior = torch.sum(-0.5 * z * z - c)
    lik = torch.sum(-0.5 * (mx - xb) ** 2 * torch.exp(-2 * s0) - s0 - c)
    value = scale * (prior + lik - logq)
    np.testing.assert_allclose(float(elbo), float(value.detach()),
                               rtol=1e-5)
    auto = torch.autograd.grad(value, p)
    for name, g, ga in zip(tfv.LEAVES, grads, auto):
        np.testing.assert_allclose(g.numpy(), ga.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_adam_matches_jax():
    params, m, v = _init(2)
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=params[k].shape).astype(np.float32)
             for k in tfv.LEAVES]
    lr = 3e-3
    jp = tuple(jnp.asarray(params[k]) for k in jfv.LEAVES)
    jm = tuple(jnp.asarray(m[k]) for k in jfv.LEAVES)
    jv = tuple(jnp.asarray(v[k]) for k in jfv.LEAVES)
    jg = tuple(jnp.asarray(g) for g in grads)
    tp = tuple(torch.as_tensor(params[k]) for k in tfv.LEAVES)
    tm = tuple(torch.as_tensor(m[k]) for k in tfv.LEAVES)
    tv = tuple(torch.as_tensor(v[k]) for k in tfv.LEAVES)
    tg = tuple(torch.as_tensor(g) for g in grads)
    for t in (1.0, 2.0, 3.0):
        jp, jm, jv = jfv._adam(jp, jm, jv, jg, t, lr)
        tp, tm, tv = tfv._adam(tp, tm, tv, tg, t, lr)
    for name, a, b in zip(tfv.LEAVES, tp + tm + tv, jp + jm + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_adam_leaf_matches_jax():
    rng = np.random.default_rng(4)
    p, m, v, g = (rng.normal(size=(3, 5)).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    want = jkc.adam_leaf(*(jnp.asarray(a) for a in (p, m, v, g)), 7.0, 1e-2)
    got = tkc.adam_leaf(*(torch.as_tensor(a) for a in (p, m, v, g)), 7.0,
                        1e-2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


@pytest.fixture(scope="module")
def five_steps():
    params, m, v = _init(5)
    x = _data(95)
    idx, eps = _streams(94, 5)
    lr = 1e-2
    ref = tfv.reference_train(torch.as_tensor(x), _t(params), _t(m), _t(v),
                              idx_stream=torch.as_tensor(idx),
                              eps_stream=torch.as_tensor(eps), lr=lr)
    return dict(params=params, m=m, v=v, x=x, idx=idx, eps=eps, lr=lr,
                ref=ref)


def _assert_trajectory(got, want):
    (pg, _, vg, lg), (pw, _, vw, lw) = got, want
    np.testing.assert_allclose(np.asarray(lg), np.asarray(lw), rtol=1e-4,
                               atol=1e-3)
    for name in tfv.LEAVES:
        np.testing.assert_allclose(np.asarray(pg[name]), np.asarray(pw[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(np.asarray(vg[name]), np.asarray(vw[name]),
                                   rtol=1e-3, atol=1e-6, err_msg="v_" + name)


def test_reference_train_matches_jax_reference(five_steps):
    s = five_steps
    want = jfv.reference_train(
        jnp.asarray(s["x"]), _j(s["params"]), _j(s["m"]), _j(s["v"]),
        idx_stream=jnp.asarray(s["idx"]), eps_stream=jnp.asarray(s["eps"]),
        lr=s["lr"])
    p, m, v, loss = s["ref"]
    _assert_trajectory((_np(p), _np(m), _np(v), loss.numpy()),
                       tuple(map(_np, want[:3])) + (np.asarray(want[3]),))


def test_reference_train_matches_jax_interpret_kernel(five_steps):
    """Against the Pallas kernel itself, run in interpret mode."""
    s = five_steps
    want = jfv.fused_train_injected(
        jnp.asarray(s["x"]), _j(s["params"]), _j(s["m"]), _j(s["v"]),
        idx_stream=jnp.asarray(s["idx"]), eps_stream=jnp.asarray(s["eps"]),
        lr=s["lr"], interpret=True)
    p, m, v, loss = s["ref"]
    _assert_trajectory((_np(p), _np(m), _np(v), loss.numpy()),
                       tuple(map(_np, want[:3])) + (np.asarray(want[3]),))


def test_n_total_scales_like_jax(five_steps):
    """With ``n_total`` (a shard of a larger data set) the likelihood is
    scaled by n_total / B in both packages: the port's reference_train
    equals the JAX one at the trajectory tolerances, and the CPU dispatch
    of fused_train passes it through."""
    s = five_steps
    n_total = 7 * DIMS.n
    want = jfv.reference_train(
        jnp.asarray(s["x"]), _j(s["params"]), _j(s["m"]), _j(s["v"]),
        idx_stream=jnp.asarray(s["idx"]), eps_stream=jnp.asarray(s["eps"]),
        lr=s["lr"], n_total=n_total)
    got = tfv.reference_train(
        torch.as_tensor(s["x"]), _t(s["params"]), _t(s["m"]), _t(s["v"]),
        idx_stream=torch.as_tensor(s["idx"]),
        eps_stream=torch.as_tensor(s["eps"]), lr=s["lr"], n_total=n_total)
    _assert_trajectory(tuple(map(_np, got[:3])) + (got[3].numpy(),),
                       tuple(map(_np, want[:3])) + (np.asarray(want[3]),))
    assert not np.allclose(got[3].numpy(), s["ref"][3].numpy(), rtol=0.1)
    x = torch.as_tensor(s["x"])
    out = tfv.fused_train(x, _t(s["params"]), _t(s["m"]), _t(s["v"]),
                          steps=3, lr=s["lr"], seed=4, batch=DIMS.b,
                          n_total=n_total)
    gen = torch.Generator().manual_seed(4 * 1_000_003)
    idx = torch.randint(0, DIMS.n, (3, DIMS.b), generator=gen)
    eps = torch.randn((3, DIMS.b, DIMS.z), generator=gen)
    ref = tfv.reference_train(x, _t(s["params"]), _t(s["m"]), _t(s["v"]),
                              idx_stream=idx, eps_stream=eps, lr=s["lr"],
                              n_total=n_total)
    torch.testing.assert_close(out[3], ref[3], rtol=0, atol=0)


def test_injected_entry_on_cpu_is_reference(five_steps):
    s = five_steps
    before = tfv.LAUNCHES
    got = tfv.fused_train_injected(
        torch.as_tensor(s["x"]), _t(s["params"]), _t(s["m"]), _t(s["v"]),
        idx_stream=torch.as_tensor(s["idx"]),
        eps_stream=torch.as_tensor(s["eps"]), lr=s["lr"])
    torch.testing.assert_close(got[3], s["ref"][3], rtol=0, atol=0)
    assert tfv.LAUNCHES == before    # CPU tensors never launch


def test_fused_train_cpu_thinning_and_streams():
    """CPU dispatch: reference_train on Generator streams, losses thinned
    by the kernel's rule (entry k = last step i with i // thin == k)."""
    params, m, v = _init(6)
    x = torch.as_tensor(_data(93))
    before = tfv.LAUNCHES
    steps, seed = 2050, 11
    out = tfv.fused_train(x, _t(params), _t(m), _t(v), steps=steps,
                          lr=1e-3, seed=seed, batch=DIMS.b)
    thin = tfv._thin(steps)
    assert thin == 2 and out[3].shape == (1025,)
    gen = torch.Generator().manual_seed(seed * 1_000_003)
    idx = torch.randint(0, DIMS.n, (steps, DIMS.b), generator=gen)
    eps = torch.randn((steps, DIMS.b, DIMS.z), generator=gen)
    ref = tfv.reference_train(x, _t(params), _t(m), _t(v), idx_stream=idx,
                              eps_stream=eps, lr=1e-3)
    torch.testing.assert_close(out[3][:-1], ref[3][1:-1:2], rtol=0, atol=0)
    assert float(out[3][-1]) == float(ref[3][-1])
    for k in tfv.LEAVES:
        torch.testing.assert_close(out[0][k], ref[0][k], rtol=0, atol=0)
    # t0 moves the stream: a continuation is not a replay of step 0
    again = tfv.fused_train(x, _t(params), _t(m), _t(v), steps=3, lr=1e-3,
                            seed=seed, batch=DIMS.b, t0=5)
    first = tfv.fused_train(x, _t(params), _t(m), _t(v), steps=3, lr=1e-3,
                            seed=seed, batch=DIMS.b)
    assert not torch.equal(again[3], first[3])
    assert tfv.LAUNCHES == before


def test_wrapper_checks():
    params, m, v = _init(7)
    x = torch.as_tensor(_data(92))
    dims = tfv._check(x, _t(params), _t(m), _t(v), DIMS.b)
    assert dims == DIMS
    bad = _t(params)
    bad["w1e"] = bad["w1e"].T
    with pytest.raises(ValueError, match="w1e"):
        tfv._check(x, bad, _t(m), _t(v), DIMS.b)
    with pytest.raises(ValueError, match="multiple of"):
        tfv._check(x, _t(params), _t(m), _t(v), 30)
    with pytest.raises(ValueError, match="float32"):
        tfv._check(x.double(), _t(params), _t(m), _t(v), DIMS.b)
    with pytest.raises(ValueError, match="unsupported device"):
        tfv.fused_train(x.to("meta"), params, m, v, steps=1, lr=1e-3,
                        seed=0, batch=DIMS.b)
    flat = tfv._pack(_t(params))
    assert flat.numel() == sum(math.prod(s) for s in
                               tfv.leaf_shapes(DIMS).values())
    back = tfv._unpack(flat, DIMS)
    for k in tfv.LEAVES:
        np.testing.assert_array_equal(back[k].numpy(), params[k])


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10 known-answer vectors of the Random123 reference."""
    got = tkc.philox4x32_10(*ctr, *key)
    assert tuple(int(w) for w in got) == want


def test_philox_streams_recipe():
    """Streams of the in-kernel recipe: indices in range and near uniform,
    noise near N(0, 1), and the twin equals the word-level recipe."""
    n, b, z = 1000, 256, 8
    idx, eps = tkc.philox_streams(42, 3, 20, b, n, z)
    assert idx.shape == (20, b) and eps.shape == (20, b, z)
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    assert abs(float(idx.float().mean()) - (n - 1) / 2) < 15
    assert abs(float(eps.mean())) < 0.03
    assert abs(float(eps.std()) - 1.0) < 0.03
    # one element by hand: step 4 (t0 + 1), row 5, lane 1 + 2
    w = tkc.philox4x32_10(4, 5, 3, 0, 42, 0)
    u1 = max(float(int(w[0]) >> 8) / 2**24, 1e-7)
    u2 = float(int(w[1]) >> 8) / 2**24
    want = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)
    np.testing.assert_allclose(float(eps[1, 5, 2]), want, rtol=1e-5,
                               atol=1e-6)
    w0 = tkc.philox4x32_10(4, 5, 0, 0, 42, 0)
    assert int(idx[1, 5]) == min(int((int(w0[0]) >> 8) / 2**24 * n), n - 1)


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tc_mm(a, b, split, a_exact_lo):
    """``a @ b`` as the kernel forms it on the tensor cores.  Split: hi =
    tf32(x), lo = tf32(x - hi), lo hi + hi lo + hi hi in float32; in the
    row pass an activation's lo is kept exact (``a_exact_lo``) and the
    tensor core drops its low 13 bits.  Otherwise one TF32 pass."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al = a - ah
    if a_exact_lo:
        al = (al.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    else:
        al = _tf32(al)
    return al @ bh + ah @ _tf32(b - bh) + ah @ bh


def _emulated_step_math(params, xb, eps, scale, row_split, grad_split):
    """The kernel's step on the CPU: the row pass's seven products (an
    activation times a packed weight; split or not by ``row_split``) and
    the weight-gradient pass's four (by ``grad_split``),
    in the kernel's groupings ([Wmu | Wsig], [g_z | g_pre]); the bias
    gradients as column sums."""
    (w1e, b1e, wmu, bmu, wsig, bsig, w1d, b1d, w2d, b2d, usig) = params
    z = wmu.shape[1]
    c = tfv._C
    row = lambda a, b: _tc_mm(a, b, row_split, True)  # noqa: E731
    grad = lambda a, b: _tc_mm(a, b, grad_split, False)  # noqa: E731
    csum = lambda a: torch.sum(a, dim=0, keepdim=True)  # noqa: E731
    wms = torch.cat([wmu, wsig], 1)
    h1 = torch.tanh(row(xb, w1e) + b1e)
    mp = row(h1, wms)
    pre = mp[:, z:] + bsig
    ls = torch.clamp(pre, -6.0, 3.0)
    zl = mp[:, :z] + bmu + torch.exp(ls) * eps
    hd = torch.tanh(row(zl, w1d) + b1d)
    r = row(hd, w2d) + b2d - xb
    u = usig[0, 0]
    inv_s2 = torch.exp(-2.0 * u)
    elbo = scale * (torch.sum(-0.5 * zl * zl - c)
                    + torch.sum(-0.5 * r * r * inv_s2 - u - c)
                    - torch.sum(-ls - 0.5 * eps * eps - c))
    g_mx = -scale * r * inv_s2
    g_a1d = row(g_mx, w2d.T) * (1.0 - hd * hd)
    g_z = (row(g_a1d, w1d.T) - scale * zl
           + scale * eps * torch.exp(-ls))
    g_pre = g_z * eps * torch.exp(ls) * ((pre > -6.0) & (pre < 3.0))
    gzp = torch.cat([g_z, g_pre], 1)
    g_a1e = row(gzp, wms.T) * (1.0 - h1 * h1)
    g_wms = grad(h1.T, gzp)
    return elbo, (grad(xb.T, g_a1e), csum(g_a1e), g_wms[:, :z], csum(g_z),
                  g_wms[:, z:], csum(g_pre), grad(zl.T, g_a1d),
                  csum(g_a1d), grad(hd.T, g_mx), csum(g_mx),
                  (scale * torch.sum(r * r * inv_s2 - 1.0)).reshape(1, 1))


@pytest.mark.parametrize("row_split,grad_split,within", [
    (True, True, True), (False, False, False), (True, False, False)])
def test_operand_split_precision(row_split, grad_split, within):
    """The kernel's tensor-core arithmetic emulated at the bench widths (D
    128, H 256, Z 32, the model's init; 64 rows of the batch) against the
    plain float32 step, with chip_smoke.py phase 2's limits (each gradient
    within 1e-4 |g| + 1e-5 max|g|, the loss within rel 1e-4): the
    three-pass split holds them with more than 3x margin (worst err/tol
    ~0.05); one TF32 pass everywhere misses by ~40x, and one pass on the
    weight-gradient products alone by ~17x."""
    cfg = tdlgm.Config(num_data=4096, data_dim=128, latent_dim=32,
                       hidden=256, batch_size=64, device="cpu")
    x = torch.as_tensor(tdlgm.make_data(cfg))
    p0, _, _ = tdlgm.fused_init(cfg, torch.Generator().manual_seed(0))
    params = tuple(p0[k] for k in tfv.LEAVES)
    rng = np.random.default_rng(1)
    xb = x[torch.as_tensor(rng.integers(0, cfg.num_data, cfg.batch_size))]
    eps = torch.as_tensor(rng.standard_normal(
        (cfg.batch_size, cfg.latent_dim)).astype(np.float32))
    scale = 65_536 / cfg.batch_size
    want_e, want = tfv._step_math(params, xb, eps, scale)
    got_e, got = _emulated_step_math(params, xb, eps, scale, row_split,
                                     grad_split)
    worst = max(float(((g - w).abs()
                       / (1e-4 * w.abs() + 1e-5 * w.abs().max())).max())
                for g, w in zip(got, want))
    assert abs(float(got_e - want_e)) <= 1e-4 * abs(float(want_e))
    if within:
        assert worst <= 1.0 / 3.0, worst
    else:
        assert worst > 1.0, worst


def _ffma_design_takes(d, h, z, b):
    """Whether the earlier fp32 FFMA design took the shape: a batch in
    whole blocks of 8 rows, and those rows' buffers within the 227 KB of
    shared memory a block may hold."""
    return b % 8 == 0 and 4 * 8 * (2 * d + 3 * h + 6 * z) <= 232448


def test_kernel_takes_every_shape_of_the_ffma_design():
    """Every shape the FFMA design took over a grid of batches and widths
    passes the wrapper's check: the tensor-core kernel pads any width to
    whole tiles and keeps the row blocks of a shape too wide for shared
    memory in the device scratch, so the batch's multiple of 8 is the only
    rule left (``test_kernel_matches_plain_at_other_shapes`` runs such a
    shape on the card)."""
    taken = 0
    for b in (8, 24, 256, 1024):
        for d in (1, 7, 128, 200):
            for h in (3, 64, 256, 300):
                for z in (1, 3, 8, 32, 40):
                    if not _ffma_design_takes(d, h, z, b):
                        continue
                    taken += 1
                    dims = tfv.FusedVAEDims(50, d, h, z, b)
                    tree = {k: torch.zeros(s) for k, s in
                            tfv.leaf_shapes(dims).items()}
                    x = torch.zeros(50, d)
                    assert tfv._check(x, tree, tree, tree, b) == dims
    assert taken == 320
    assert _ffma_design_takes(2000, 1000, 8, 24)   # OTHER_SHAPES' widest


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card: the kernel's 5-step injected trajectory equals the
    plain version's on the card, and the Philox entry equals the plain
    version on the twin's streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params, m, v = _init(8)
    x = torch.as_tensor(_data(91), device=dev)
    idx, eps = _streams(90, 5)
    idx, eps = torch.as_tensor(idx, device=dev), torch.as_tensor(
        eps, device=dev)
    tp, tm, tv = ({k: a.to(dev) for k, a in _t(tree).items()}
                  for tree in (params, m, v))
    before = tfv.LAUNCHES
    got = tfv.fused_train_injected(x, tp, tm, tv, idx_stream=idx,
                                   eps_stream=eps, lr=1e-2)
    assert tfv.LAUNCHES == before + 1
    want = tfv.reference_train(x, tp, tm, tv, idx_stream=idx,
                               eps_stream=eps, lr=1e-2)
    _assert_trajectory(tuple({k: a.cpu() for k, a in t.items()}
                             for t in got[:3]) + (got[3].cpu(),),
                       tuple({k: a.cpu() for k, a in t.items()}
                             for t in want[:3]) + (want[3].cpu(),))
    got = tfv.fused_train(x, tp, tm, tv, steps=5, lr=1e-2, seed=3,
                          batch=DIMS.b)
    idx, eps = tkc.philox_streams(3, 0, 5, DIMS.b, DIMS.n, DIMS.z, dev)
    want = tfv.reference_train(x, tp, tm, tv, idx_stream=idx,
                               eps_stream=eps, lr=1e-2)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               rtol=1e-4, atol=1e-3)


# (N, D, H, Z, B) off the bench: ragged widths with a batch that is not a
# multiple of 16; wider layers; a shape whose row blocks do not fit in
# shared memory (the kernel's global instance)
OTHER_SHAPES = [(300, 7, 37, 3, 24), (500, 33, 300, 40, 40),
                (100, 2000, 1000, 8, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", OTHER_SHAPES)
def test_kernel_matches_plain_at_other_shapes(shape):
    """On a CUDA card, at shapes off the bench: one injected step's
    gradients within
    chip_smoke.py phase 2's limits (1e-4 |g| + 1e-5 max|g|, loss rel 1e-4)
    and a 5-step trajectory's losses within this file's tolerance of the
    plain version on the card.  The parameters after 5 steps are compared
    only at the test shape (``test_kernel_matches_plain``): Adam moves
    each parameter by about lr whatever its gradient's size, so at the
    wide shape (2M encoder weights from 24 rows) many entries whose
    gradients nearly cancel between steps part by up to lr when the
    float32 order of summation changes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dims = tfv.FusedVAEDims(*shape)
    params, m, v = _init(20, dims)
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.normal(size=(dims.n, dims.d))
                        .astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, dims.n, (5, dims.b)), device=dev)
    eps = torch.as_tensor(rng.normal(size=(5, dims.b, dims.z))
                          .astype(np.float32), device=dev)
    tp, tm, tv = ({k: torch.as_tensor(a, device=dev) for k, a in t.items()}
                  for t in (params, m, v))
    _, m1, _, l1 = tfv.fused_train_injected(x, tp, tm, tv,
                                            idx_stream=idx[:1],
                                            eps_stream=eps[:1], lr=1e-2)
    elbo, grads = tfv._step_math(tuple(tp[k] for k in tfv.LEAVES),
                                 x[idx[0]], eps[0], dims.n / dims.b)
    for k, g in zip(tfv.LEAVES, grads):
        err = (-m1[k] / 0.1 - g).abs()
        tol = 1e-4 * g.abs() + 1e-5 * float(g.abs().max())
        assert bool((err <= tol).all()), (k, float(err.max()))
    assert abs(float(l1[0]) + float(elbo)) <= 1e-4 * abs(float(elbo))
    got = tfv.fused_train_injected(x, tp, tm, tv, idx_stream=idx,
                                   eps_stream=eps, lr=1e-2)
    want = tfv.reference_train(x, tp, tm, tv, idx_stream=idx,
                               eps_stream=eps, lr=1e-2)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    for k in tfv.LEAVES:
        assert bool(torch.isfinite(got[0][k]).all()), k


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit():
    """On a CUDA card: two calls with the same inputs give the same bits,
    through the Philox entry and the injected one (fixed-order sums, no
    float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    dims = tfv.FusedVAEDims(2000, 128, 256, 32, 1024)
    params, m, v = _init(22, dims)
    x = torch.as_tensor(np.random.default_rng(23).normal(
        size=(dims.n, dims.d)).astype(np.float32), device=dev)
    tp, tm, tv = ({k: torch.as_tensor(a, device=dev) for k, a in t.items()}
                  for t in (params, m, v))
    idx, eps = tkc.philox_streams(5, 0, 20, dims.b, dims.n, dims.z, dev)
    for call in (
            lambda: tfv.fused_train(x, tp, tm, tv, steps=20, lr=1e-3,
                                    seed=5, batch=dims.b),
            lambda: tfv.fused_train_injected(x, tp, tm, tv, idx_stream=idx,
                                             eps_stream=eps, lr=1e-3)):
        a, b = call(), call()
        assert torch.equal(a[3], b[3])
        for ta, tb in zip(a[:3], b[:3]):
            for k in tfv.LEAVES:
                assert torch.equal(ta[k], tb[k]), k


# ---------------------------------------------------------------------------
# the bf16 compute mode (JAX mm_dtype=jnp.bfloat16): each product's operands
# rounded to bf16, float32 accumulation and elementwise math.  The two
# packages round the same float32 activations, which can part by an ulp
# before rounding, so an operand may round to the neighbouring bf16 value:
# limits are shares of each gradient leaf's max (BF16_GRAD_SHARE: 20x the
# largest seen here, 4x the largest the kernel showed against the plain
# version at the DLGM bench on an H100; the float32 mode parts from the
# bf16 one by more than 3x that), as chip_smoke.py's phase 29(a)
# ---------------------------------------------------------------------------

BF16_GRAD_SHARE = 1e-3
BF16_DIMS = (DIMS, tfv.FusedVAEDims(n=500, d=40, h=64, z=8, b=64))


def _bf16_case(dims, seed):
    rng = np.random.default_rng(seed)
    params = {k: (rng.normal(size=s) / np.sqrt(s[0]) if k.startswith("w")
                  else 0.1 * rng.normal(size=s)).astype(np.float32)
              for k, s in tfv.leaf_shapes(dims).items()}
    x = rng.normal(size=(dims.n, dims.d)).astype(np.float32)
    idx = rng.integers(0, dims.n, dims.b)
    eps = rng.normal(size=(dims.b, dims.z)).astype(np.float32)
    return params, x[idx], eps, dims.n / dims.b


@pytest.mark.parametrize("dims", BF16_DIMS, ids=["d12", "d40"])
def test_bf16_step_math_matches_jax(dims):
    params, xb, eps, scale = _bf16_case(dims, 31)
    je, jg = jfv._step_math(tuple(jnp.asarray(params[k]) for k in jfv.LEAVES),
                            jnp.asarray(xb), jnp.asarray(eps), scale,
                            mm_dtype=jnp.bfloat16)
    tp = tuple(torch.as_tensor(params[k]) for k in tfv.LEAVES)
    te, tg = tfv._step_math(tp, torch.as_tensor(xb), torch.as_tensor(eps),
                            scale, compute_dtype="bfloat16")
    _, fg = tfv._step_math(tp, torch.as_tensor(xb), torch.as_tensor(eps),
                           scale)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    gap = 0.0
    for name, a, b, f in zip(tfv.LEAVES, tg, jg, fg):
        b = np.asarray(b)
        share = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert share <= BF16_GRAD_SHARE, (name, share)
        gap = max(gap, np.abs(f.numpy() - b).max() / np.abs(b).max())
    assert gap > 3 * BF16_GRAD_SHARE      # the mode changes the gradients


def test_bf16_reference_train_matches_jax_step_math():
    """Five steps of the port's ``reference_train(compute_dtype=
    "bfloat16")`` against the JAX package's bf16 ``_step_math`` and
    ``_adam`` in a loop (its ``reference_train`` has no mode)."""
    params, m, v = _init(41)
    x = _data(42)
    idx, eps = _streams(43, 5)
    lr, scale = 1e-2, DIMS.n / DIMS.b
    jp, jm, jv = (tuple(jnp.asarray(t[k]) for k in jfv.LEAVES)
                  for t in (params, m, v))
    jl = []
    for i in range(5):
        e, g = jfv._step_math(jp, jnp.asarray(x[idx[i]]),
                              jnp.asarray(eps[i]), scale,
                              mm_dtype=jnp.bfloat16)
        jp, jm, jv = jfv._adam(jp, jm, jv, g, float(i + 1), lr)
        jl.append(-float(e))
    tp, _, tv, tl = tfv.reference_train(
        torch.as_tensor(x), _t(params), _t(m), _t(v),
        idx_stream=torch.as_tensor(idx), eps_stream=torch.as_tensor(eps),
        lr=lr, compute_dtype="bfloat16")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    for name, a, b in zip(jfv.LEAVES, jp, jv):
        # params within 1e-3 (25x the largest gap seen over three seeds;
        # five Adam steps move an entry by up to 5 lr = 0.05), Adam's v
        # within 5e-3 of the leaf's max (10x)
        assert np.abs(tp[name].numpy() - np.asarray(a)).max() <= 1e-3, name
        b = np.asarray(b)
        assert np.abs(tv[name].numpy() - b).max() <= 5e-3 * np.abs(b).max()


def test_bf16_fused_train_on_cpu_and_mode_checks():
    params, m, v = _init(44)
    x = torch.as_tensor(_data(45))
    out = tfv.fused_train(x, _t(params), _t(m), _t(v), steps=30, lr=1e-2,
                          seed=1, batch=DIMS.b, compute_dtype="bfloat16")
    f32 = tfv.fused_train(x, _t(params), _t(m), _t(v), steps=30, lr=1e-2,
                          seed=1, batch=DIMS.b)
    assert bool(torch.isfinite(out[3]).all())
    assert not torch.equal(out[3], f32[3])          # the mode is honoured
    np.testing.assert_allclose(out[3].numpy(), f32[3].numpy(), rtol=0.05)
    for bad in ("float16", "bf16", None):
        with pytest.raises(ValueError, match="compute_dtype"):
            tfv.fused_train(x, _t(params), _t(m), _t(v), steps=1, lr=1e-2,
                            seed=1, batch=DIMS.b, compute_dtype=bad)
    with pytest.raises(ValueError, match="compute_dtype"):
        tfv.reference_train(x, _t(params), _t(m), _t(v),
                            idx_stream=torch.zeros((1, 8), dtype=torch.long),
                            eps_stream=torch.zeros((1, 8, DIMS.z)), lr=1e-2,
                            compute_dtype="half")


@pytest.mark.gpu
def test_bf16_kernel_matches_plain():
    """On a CUDA card: the bf16 instance's one injected step against the
    plain bf16 version (every gradient leaf within BF16_GRAD_SHARE of its
    max, loss rel 1e-5), a 5-step trajectory's losses at rtol 1e-4, and
    ``fused_train(compute_dtype="bfloat16")`` counted in LAUNCHES_BF16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params, m, v = _init(46)
    x = torch.as_tensor(_data(47), device=dev)
    tp, tm, tv = ({k: a.to(dev) for k, a in _t(tree).items()}
                  for tree in (params, m, v))
    idx, eps = _streams(48, 5)
    idx, eps = torch.as_tensor(idx, device=dev), torch.as_tensor(
        eps, device=dev)
    dims = tfv._check(x, tp, tm, tv, DIMS.b)
    run = dict(seed=0, t0=0, thin=1, scale=DIMS.n / DIMS.b, bf16=True)
    _, m1, _, l1 = tfv._launch(x, tp, tm, tv, dims, steps=1, lr=1e-2,
                               idx=idx[:1].to(torch.int32).contiguous(),
                               eps=eps[:1].contiguous(), **run)
    elbo, grads = tfv._step_math(tuple(tp[k] for k in tfv.LEAVES),
                                 x[idx[0]], eps[0], DIMS.n / DIMS.b,
                                 "bfloat16")
    for k, g in zip(tfv.LEAVES, grads):
        share = float((-m1[k] / 0.1 - g).abs().max() / g.abs().max())
        assert share <= BF16_GRAD_SHARE, (k, share)
    assert abs(float(l1[0]) + float(elbo)) <= 1e-5 * abs(float(elbo))
    got = tfv._launch(x, tp, tm, tv, dims, steps=5, lr=1e-2,
                      idx=idx.to(torch.int32).contiguous(),
                      eps=eps.contiguous(), **run)
    want = tfv.reference_train(x, tp, tm, tv, idx_stream=idx,
                               eps_stream=eps, lr=1e-2,
                               compute_dtype="bfloat16")
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               rtol=1e-4)
    before = tfv.LAUNCHES_BF16
    out = tfv.fused_train(x, tp, tm, tv, steps=20, lr=1e-2, seed=3,
                          batch=DIMS.b, compute_dtype="bfloat16")
    assert tfv.LAUNCHES_BF16 == before + 1
    assert bool(torch.isfinite(out[3]).all())
