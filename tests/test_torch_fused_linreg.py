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
is marked ``gpu`` and skips here.
"""

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
