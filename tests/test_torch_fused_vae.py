"""Parity of the port's fused DLGM trainer (``ops/fused_vae.py``) and its
device helpers (``ops/_kernel_common.py``) with the JAX package.

Inputs and noise come from numpy with a seed and go to both packages.  The
JAX side runs its plain functions and its Pallas kernel in interpret mode,
as ``tests/test_fused_vae.py`` does.  Tolerances are those of that file:
step math and hand backward rtol 2e-4 / atol 2e-5, Adam rtol 1e-5 /
atol 1e-7, 5-step trajectories losses rtol 1e-4 / atol 1e-3, params
rtol 1e-4 / atol 1e-5, Adam v rtol 1e-3 / atol 1e-6.

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``
is marked ``gpu`` and skips here.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.ops import _kernel_common as jkc
from bayesic_tpu.ops import fused_vae as jfv
from bayesic_tpu_torch.ops import _kernel_common as tkc
from bayesic_tpu_torch.ops import fused_vae as tfv

torch.set_num_threads(2)

DIMS = tfv.FusedVAEDims(n=200, d=12, h=16, z=4, b=32)


def _init(seed):
    """numpy leaves as tests/test_fused_vae.py draws them: weights
    N(0, 1/fan_in), zero biases and usig; zero Adam state."""
    rng = np.random.default_rng(seed)
    shapes = tfv.leaf_shapes(DIMS)
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
