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
is marked ``gpu`` and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card: one injected step's gradients (read off Adam's first
    moment), a 30-step injected trajectory and a 40-step Philox run equal
    the plain version on the card (rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    x, y, group = (a.to(dev) for a in _t(*_data()))
    n = x.shape[0]
    rng = np.random.default_rng(4)
    loc, ls, opt = tfh.init_params(J, F, device=dev)
    for steps in (1, 30):
        offs = torch.as_tensor(rng.integers(0, n, steps), device=dev)
        eps = torch.as_tensor(rng.normal(size=(steps, P)).astype(np.float32),
                              device=dev)
        kw = dict(off_stream=offs, eps_stream=eps, lr0=0.03, lr_total=60,
                  batch=B)
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
                          seed=9, batch=B)
    off, eps = kc.hier_streams(9, 0, 40, n, P, device=dev)
    want = tfh.reference_train(x, y, group, loc, ls, opt, off_stream=off,
                               eps_stream=eps, lr0=0.03, lr_total=40,
                               batch=B)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)

