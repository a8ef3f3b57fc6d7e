"""Parity of the port's GMM likelihood (``ops/gmm_logprob.py``) with the JAX
package.

Inputs are made with numpy and go to both packages.  The JAX side runs as
its own tests run it (``tests/test_kernels.py``): its Pallas kernels in
interpret mode (``BAYESIC_PALLAS=interpret``) and ``jax.grad`` of its
plain reference.  Tolerances: ll rtol 2e-5 (the interpret kernels' value
products are a 3-pass bf16 split, ~f32); gradients within 2e-5 of
max|g| + 1 against ``jax.grad`` of the reference (float32 sums in another
order), and within 5e-3 of max|g| + 1 against the interpret value+grad
kernel, whose gradient products run one bf16 pass by design and whose
d/dsigma comes through a cancelling identity (its own test allows 5e-3).

The kernels themselves run only on a CUDA card: ``test_kernels_match_plain``
is marked ``gpu`` and skips here.  What the CPU can check of the three
kernels (forward, backward, value+grad), which run one log2-domain point
loop: ``test_vg_arithmetic_precision`` emulates it
(``tests/gmm_log2_emulation.py``, shared with the SMC mutation's test)
with ex2, lg2 and rcp at the PTX ISA's bounds against float64, and
``test_vg_geometry`` checks their launches against the source.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import gmm_log2_emulation as emu
from bayesic_tpu.ops import gmm_logprob as jgl
from bayesic_tpu_torch.dist import StickBreaking
from bayesic_tpu_torch.models import gmm as tgmm
from bayesic_tpu_torch.ops import gmm_logprob as tgl

torch.set_num_threads(2)

_CU = Path(tgl.__file__).resolve().parents[1] / "csrc" / "gmm_logprob.cu"
_CHUNK = int(re.search(r"kChunk = (\d+);",
                       _CU.with_name("gmm_lik.cuh").read_text()).group(1))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("BAYESIC_PALLAS", "interpret")


def _inputs(n=777, d=3, p=13, k=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    lw = rng.normal(size=(p, k))
    lw = (lw - np.log(np.exp(lw).sum(-1, keepdims=True))).astype(np.float32)
    mus = (2.0 * rng.normal(size=(p, k, d))).astype(np.float32)
    sig = np.exp(0.3 * rng.normal(size=(p, k))).astype(np.float32)
    return x, lw, mus, sig


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _jax_grads(x, lw, mus, sig, ct=None):
    ct = np.ones(lw.shape[0], np.float32) if ct is None else ct
    return jax.grad(lambda a, b, c: (jgl.gmm_loglik_reference(x, a, b, c)
                                     * ct).sum(), argnums=(0, 1, 2))(
        lw, mus, sig)


def _close_grads(got, want, atol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1.0
        np.testing.assert_allclose(g.detach().numpy() / scale, w / scale,
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [dict(), dict(n=513, d=1, p=1, k=2, seed=3),
                                   dict(n=300, d=2, p=37, k=3, seed=1)])
def test_loglik_matches_jax(pallas_interpret, shape):
    x, lw, mus, sig = _inputs(**shape)
    want = np.asarray(jgl.gmm_loglik(x, lw, mus, sig))
    np.testing.assert_allclose(
        np.asarray(jgl.gmm_loglik_reference(x, lw, mus, sig)), want,
        rtol=2e-5)
    for fn in (tgl.gmm_loglik, tgl.gmm_loglik_reference):
        got = fn(*_t(x, lw, mus, sig))
        assert got.shape == (lw.shape[0],)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


def test_backward_matches_jax(pallas_interpret):
    """Autograd through ``gmm_loglik`` with a random cotangent against
    jax.grad of the reference and of the interpret kernel's VJP; the data
    cotangent is NaN, as in the JAX package."""
    x, lw, mus, sig = _inputs(n=300, p=9)
    ct = np.random.default_rng(4).normal(size=9).astype(np.float32)
    xt, *params = _t(x, lw, mus, sig)
    xt.requires_grad_()
    for t in params:
        t.requires_grad_()
    ll = tgl.gmm_loglik(xt, *params)
    got = torch.autograd.grad(ll, [xt] + params, torch.as_tensor(ct))
    assert bool(torch.isnan(got[0]).all())
    _close_grads(got[1:], _jax_grads(x, lw, mus, sig, ct), 2e-5)
    kernel_vjp = jax.vjp(lambda a, b, c: jgl.gmm_loglik(x, a, b, c), lw, mus,
                         sig)[1](ct)
    _close_grads(got[1:], kernel_vjp, 2e-5)


def test_value_and_grad_matches_jax(pallas_interpret):
    x, lw, mus, sig = _inputs(n=777, d=2, p=300, k=3)
    ll, *grads = tgl.gmm_loglik_grad(*_t(x, lw, mus, sig))
    np.testing.assert_allclose(
        ll.numpy(), np.asarray(jgl.gmm_loglik_reference(x, lw, mus, sig)),
        rtol=2e-5)
    _close_grads(grads, _jax_grads(x, lw, mus, sig), 2e-5)
    kernel = jgl.gmm_loglik_grad(x, lw, mus, sig)
    np.testing.assert_allclose(ll.numpy(), np.asarray(kernel[0]), rtol=3e-5,
                               atol=3e-5)
    _close_grads(grads, kernel[1:], 5e-3)
    # the backward's plain version is the value+grad's times the cotangent
    ct = torch.linspace(-1.0, 2.0, 300)
    scaled = tgl.gmm_loglik_grad_reference(*_t(x, lw, mus, sig), ct)
    torch.testing.assert_close(scaled[1], ct[:, None] * grads[0])
    torch.testing.assert_close(scaled[2], ct[:, None, None] * grads[1])


def test_wrapper_checks():
    x, lw, mus, sig = _t(*_inputs(n=20, d=2, p=4, k=3))
    with pytest.raises(ValueError, match="unsupported device"):
        tgl.gmm_loglik_grad(x.to("meta"), lw.to("meta"), mus.to("meta"),
                            sig.to("meta"))
    with pytest.raises(ValueError, match="K <= 8"):
        tgl._check(x, torch.zeros(4, 9), torch.zeros(4, 9, 2),
                   torch.ones(4, 9))
    with pytest.raises(ValueError, match="mus"):
        tgl._check(x, lw, mus[:, :2], sig)


def _particles(k, d, num_data, kind, count=8):
    """x (N, D) and ``count`` float32 particles (log w, mus, sigmas) of a
    (K, D) mixture, made as the SMC mutation's precision test makes its
    flat particles: near the data's truth, from a unit-scale prior, or far
    away (log-scales ~ N(0, 3)), mapped through the model's transforms."""
    x, truth = tgmm.make_data(tgmm.Config(num_components=k, data_dim=d,
                                          num_data=num_data))
    rng = np.random.default_rng(11)
    dim = (k - 1) + k * d + k
    base = np.concatenate([
        StickBreaking().inverse(torch.as_tensor(truth["weights"],
                                                dtype=torch.float64)).numpy(),
        truth["centers"].reshape(-1), np.log(truth["scales"])])
    q = {"near": base + rng.normal(0.0, 0.03, (count, dim)),
         "prior": rng.normal(0.0, 0.5, (count, dim)),
         "far": rng.normal(0.0, 3.0, (count, dim))}[kind]
    w = StickBreaking().forward(torch.as_tensor(q[:, :k - 1])).numpy()
    lw = np.log(w).astype(np.float32)
    mus = q[:, k - 1:k - 1 + k * d].reshape(count, k, d).astype(np.float32)
    sig = np.exp(q[:, k - 1 + k * d:]).astype(np.float32)
    return x, lw, mus, sig


def _emulated(x, lw, mus, sig, sign, kernel, ct):
    """What ``kernel`` ("fwd", "bwd" or "vg") of csrc/gmm_logprob.cu
    computes, in float32 in its order, every ex2, lg2 and rcp moved by
    ``sign`` times its bound: (ll,), the three gradients times the
    cotangent ``ct`` (P,), the product last, or ll and the three
    gradients."""
    f32 = np.float32
    d = x.shape[1]
    c2 = emu.LOG2E * (lw - f32(d) * np.log(sig) - f32(d) * emu.HALF_LOG_2PI)
    h2 = f32(0.5 * np.log2(np.e)) / (sig * sig)
    ll2, r, rq, rdx = emu.points_log2(c2, h2, mus, x, sign, _CHUNK,
                                      tgl.TILE_FLOATS // d,
                                      value=kernel != "bwd",
                                      grad=kernel != "fwd")
    if kernel == "fwd":
        return (emu.LN2 * ll2,)
    inv_s2 = f32(1) / (sig * sig)
    grads = (r, rdx * inv_s2[..., None], (rq * inv_s2 - f32(d) * r) / sig)
    if kernel == "bwd":
        return tuple(ct.reshape((-1,) + (1,) * (g.ndim - 1)) * g
                     for g in grads)
    return (emu.LN2 * ll2,) + grads


@pytest.mark.parametrize("k, d, n", [(3, 2, 2000), (8, 4, 1999), (8, 4, 20)])
@pytest.mark.parametrize("kind", ["near", "prior", "far"])
def test_vg_arithmetic_precision(k, d, n, kind):
    """The likelihood kernels' arithmetic (log2-domain constants, one ex2
    per component, one rcp, the sums of kChunk points multiplied under one
    lg2 with the maxes summed apart, lanes striding over the points, the
    butterfly, the ln 2 epilogue; the forward without the gradient's sums,
    the backward without the value's and its gradients times a random
    cotangent, the product last), emulated in float32 with every
    approximate function at its PTX ISA bound in either direction: ll
    within rel 1e-5 and each gradient within 1e-4 of its max|g| of float64
    (chip_smoke phase 17's limits), for the value+grad kernel, the forward
    and the backward, at the bench's K 3, D 2, N 2,000 and at the generic
    instance's largest K 8, D 4 with N 1,999 and N 20 (lanes with no
    points)."""
    x, lw, mus, sig = _particles(k, d, n, kind)
    ct = np.random.default_rng(5).normal(size=lw.shape[0]).astype(np.float32)
    args64 = [torch.as_tensor(a, dtype=torch.float64)
              for a in (x, lw, mus, sig)]
    vg = [a.numpy() for a in tgl.gmm_loglik_grad_reference(*args64)]
    want = {"vg": vg, "fwd": vg[:1], "bwd": [
        a.numpy() for a in tgl.gmm_loglik_grad_reference(
            *args64, torch.as_tensor(ct, dtype=torch.float64))[1:]]}
    for kernel, wants in want.items():
        for sign in (1.0, -1.0):
            got = _emulated(x, lw, mus, sig, sign, kernel, ct)
            grads = zip(("dlogw", "dmus", "dsig"), got, wants)
            if kernel != "bwd":
                ll_err = np.abs(got[0] - wants[0]) / np.abs(wants[0])
                assert ll_err.max() < 1e-5, (kernel, sign, ll_err.max())
                grads = zip(("dlogw", "dmus", "dsig"), got[1:], wants[1:])
            for name, g, w in grads:
                err = np.abs(g - w).max() / np.abs(w).max()
                assert err < 1e-4, (kernel, sign, name, err)


@pytest.mark.parametrize("p, blocks", [(1, (1, 1)), (7, (1, 1)),
                                       (1001, (32, 126)),
                                       (8192, (256, 1024))])
def test_vg_geometry(p, blocks):
    """The three kernels' launches: one warp per particle, 32 a block at K
    3, D 2 and 8 at the generic instance for the value+grad kernel and the
    backward: P 1 and 7 fill one block, P 1,001 a ragged last one, P 8,192
    256 blocks at K 3, D 2; the forward's K 3, D 2 instance at its own
    threads and particles a warp; x in shared memory at its own size
    (16,000 bytes at the bench's N 2,000, D 2), in 48 KB tiles past
    TILE_FLOATS; the constants are the kernel's."""
    src = _CU.read_text()
    consts = {name: int(re.search(rf"int {name} = (\d+);", src).group(1))
              for name in ("GL_NT", "TILE_FLOATS", "FWD_NT", "FWD_W",
                           "BWD_NT", "VG_NT")}
    assert consts == dict(
        GL_NT=tgl.THREADS, TILE_FLOATS=tgl.TILE_FLOATS,
        FWD_NT=tgl.EXACT_SHAPES["fwd"][0], FWD_W=tgl.EXACT_SHAPES["fwd"][1],
        BWD_NT=tgl.EXACT_SHAPES["bwd"][0], VG_NT=tgl.EXACT_SHAPES["vg"][0])
    assert tgl.EXACT_SHAPES["bwd"][1] == tgl.EXACT_SHAPES["vg"][1] == 1
    fwd_per_block = consts["FWD_NT"] // 32 * consts["FWD_W"]
    for kernel in ("vg", "bwd", "fwd"):
        for (n, k, d), (smem, tiles) in (((2000, 3, 2), (16000, 1)),
                                         ((20, 8, 4), (320, 1)),
                                         ((20000, 3, 2), (49152, 4)),
                                         ((5000, 8, 3), (49152, 2))):
            exact = (k, d) == (3, 2)
            if kernel == "fwd" and exact:
                want = dict(threads=consts["FWD_NT"],
                            particles_per_warp=consts["FWD_W"],
                            particles_per_block=fwd_per_block,
                            blocks=-(-p // fwd_per_block))
            else:
                threads = 1024 if exact else 256
                want = dict(threads=threads, particles_per_warp=1,
                            particles_per_block=threads // 32,
                            blocks=blocks[not exact])
            g = tgl.launch_geometry(kernel, p, n, k, d)
            assert g == dict(want, smem_bytes=smem, tiles=tiles), kernel
        with pytest.raises(ValueError, match="no launch"):
            tgl.launch_geometry(kernel, p, 2000, 9, 2)
    with pytest.raises(ValueError, match="no kernel"):
        tgl.launch_geometry("mutate", p, 2000, 3, 2)


@pytest.mark.gpu
def test_kernels_match_plain():
    """On a CUDA card: forward, backward (autograd with a random
    cotangent) and value+grad kernels against their plain versions, ll
    within 1e-5 relative, gradients within 1e-4 of max|g|: at P 1, 7, 1,001
    and 8,192 by N 20, 1,999 and 2,000 at the compile-time K 3, D 2
    instances (also P 1,000 and 9 by N 2,000 and 4,097), at K 8, D 4 and K
    4, D 3 (the generic ones), and past one x tile (N 20,000 at D 2, 5,000
    at D 4).  At each shape two launches of
    each kernel agree bit for bit; the forward's ll equals the value+grad
    kernel's and the backward's gradients equal the cotangent times the
    value+grad kernel's, bit for bit (one loop in one order); the launch
    counts add up; and the library's launch of each kernel equals
    ``launch_geometry``, with at least one resident block an SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    shapes = [dict(n=n, d=2, p=p, k=3, seed=p + n)
              for p in (1, 7, 1001, 8192) for n in (20, 1999, 2000)]
    shapes += [dict(n=1999, d=4, p=1001, k=8), dict(n=20, d=4, p=7, k=8),
               dict(n=777, d=3, p=13, k=4), dict(n=2000, d=2, p=1000, k=3),
               dict(n=4097, d=2, p=9, k=3, seed=2),
               dict(n=20000, d=2, p=40, k=3), dict(n=5000, d=4, p=9, k=8)]
    for shape in shapes:
        x, lw, mus, sig = (a.to(dev) for a in _t(*_inputs(**shape)))
        p, k = lw.shape
        n, d = x.shape
        ct = torch.linspace(-1.0, 2.0, p, device=dev)
        before = dict(tgl.LAUNCHES)
        runs = []
        for _ in range(2):
            ll = tgl.gmm_loglik(x, lw, mus, sig)
            params = [t.clone().requires_grad_() for t in (lw, mus, sig)]
            bwd = torch.autograd.grad(tgl.gmm_loglik(x, *params), params, ct)
            vg = tgl.gmm_loglik_grad(x, lw, mus, sig)
            runs.append((ll, *bwd, *vg))
        torch.cuda.synchronize()
        assert tgl.LAUNCHES == dict(fwd=before["fwd"] + 4,
                                    bwd=before["bwd"] + 2,
                                    vg=before["vg"] + 2), shape
        for a, b in zip(*runs):
            assert torch.equal(a, b), shape
        ll, bwd, vg = runs[0][0], runs[0][1:4], runs[0][4:]
        assert torch.equal(ll, vg[0]), shape
        scale = (ct[:, None], ct[:, None, None], ct[:, None])
        for g, v, c in zip(bwd, vg[1:], scale):
            assert torch.equal(g, c * v), shape
        want = tgl.gmm_loglik_grad_reference(x, lw, mus, sig)
        want_ct = tgl.gmm_loglik_grad_reference(x, lw, mus, sig, ct)
        torch.testing.assert_close(ll, tgl.gmm_loglik_reference(
            x, lw, mus, sig), rtol=1e-5, atol=0)
        torch.testing.assert_close(vg[0], want[0], rtol=1e-5, atol=0)
        for g, w in list(zip(vg[1:], want[1:])) + list(zip(bwd,
                                                           want_ct[1:])):
            torch.testing.assert_close(
                g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
        for kernel in tgl.LAUNCHES:
            geo = tgl.device_geometry(kernel, p, n, k, d)
            assert geo.pop("resident_blocks") >= 1, (kernel, shape)
            assert geo == tgl.launch_geometry(kernel, p, n, k, d), kernel
