"""Parity of the port's dense MF cell pass (``ops/mf_dense.py``) with the
JAX package's kernel, run in interpret mode on the CPU, and with its own
plain version on the card.

Ratings come from the matrix-factorization numpy recipe; guide params are
made with numpy and go to both packages (``interop.mf_dense_params``).
This file imports only ``bayesic_tpu.ops`` of the JAX package, so its
``gpu`` test collects where flax is absent.  Tolerances: the JAX kernel
test's own, loss rel 2e-5 and gradients rtol 2e-4 / atol 2e-3 (float32
sums in another order); in bf16 mode loss rel 1e-4 and gradients atol
1e-3 of the leaf's largest entry (a G entry at a bf16 rounding boundary
may round the other way after float32 sums in another order).

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``
is marked ``gpu`` and skips here.
"""

import numpy as np
import pytest
import torch

from bayesic_tpu.ops import mf_dense as jmd
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.models import matrix_fact as tmf
from bayesic_tpu_torch.ops import mf_dense as tmd

torch.set_num_threads(2)
SITES = ("u", "v", "bu", "bi", "m")


def setup(nu=40, ni=25, k=4, n_ratings=1500, seed=0):
    """Statistics and off-symmetric guide params as numpy (the JAX kernel
    test's setup, with numpy noise)."""
    cfg = tmf.Config(num_users=nu, num_items=ni, num_factors=k,
                     num_ratings=n_ratings, seed=seed, device="cpu")
    users, items, ratings, _ = tmf.make_data(cfg)
    cnt, rsum, sqsum, n = tmf.dense_stats(users, items, ratings, nu, ni)
    rng = np.random.default_rng(seed + 1)
    shapes = {"u": (nu, k), "v": (ni, k), "bu": (nu,), "bi": (ni,), "m": ()}
    params = {s: ((0.2 * rng.normal(size=sh) + (3.0 if s == "m" else 0.0))
                  .astype(np.float32),
                  (np.log(0.15) + 0.2 * rng.normal(size=sh))
                  .astype(np.float32)) for s, sh in shapes.items()}
    return cfg, params, cnt, rsum, sqsum, n


def _jax_value_and_grad(params, cnt, rsum, sqsum, n, noise, mm_dtype):
    import jax.numpy as jnp

    cnt_p, rsum_p = jmd.pack_stats(jnp.asarray(cnt.numpy()),
                                   jnp.asarray(rsum.numpy()))
    jp = {s: tuple(jnp.asarray(v) for v in pair)
          for s, pair in params.items()}
    loss, grads = jmd.dense_value_and_grad(jp, cnt_p, rsum_p, sqsum, n,
                                           noise, mm_dtype=mm_dtype,
                                           interpret=True)
    return float(loss), {s: tuple(np.asarray(v) for v in grads[s])
                         for s in SITES}


def _compare(got, want, loss_rel, rtol, atol_frac=None, atol=2e-3):
    assert float(got[0]) == pytest.approx(want[0], rel=loss_rel)
    for s in SITES:
        for g, w in zip(got[1][s], want[1][s]):
            a = atol if atol_frac is None else \
                atol_frac * max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=a)


@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_value_and_grad_matches_jax_kernel(mm_dtype):
    """The port's plain pass against the JAX kernel in interpret mode, at
    the JAX test's ragged shape (users and items both short of a tile)."""
    cfg, params, cnt, rsum, sqsum, n = setup(37, 45, 3, 900)
    cp, rp = tmd.pack_stats(cnt, rsum)
    tp = interop.mf_dense_params(params)
    got = tmd.dense_value_and_grad(tp, cp, rp, sqsum, n, cfg.noise,
                                   mm_dtype=mm_dtype)
    want = _jax_value_and_grad(params, cnt, rsum, sqsum, n, cfg.noise,
                               mm_dtype)
    if mm_dtype == "float32":
        _compare(got, want, 2e-5, 2e-4)
        return
    _compare(got, want, 1e-4, 0.0, atol_frac=1e-3)
    # and within the JAX test's 3% of float32 (rounded operands only)
    f32 = tmd.dense_value_and_grad(tp, cp, rp, sqsum, n, cfg.noise)
    _compare(got, (float(f32[0]), {s: tuple(v.numpy() for v in f32[1][s])
                                   for s in SITES}), 2e-2, 0.0,
             atol_frac=3e-2)


@pytest.mark.parametrize("k", [3, 1])
def test_pack_aug_matches_jax(k):
    """The augmented factors against the JAX packing, also at K = 1 (the
    zero columns of U2a and V2a stay two wide)."""
    import jax.numpy as jnp

    _, params, cnt, _, _, _ = setup(37, 45, k, 900)
    fu, fv = tmd.pack_aug(interop.mf_dense_params(params))
    a = k + 2
    assert fu.shape == (37, 3 * a) and fv.shape == (45, 3 * a)
    jp = {s: tuple(jnp.asarray(v) for v in pair)
          for s, pair in params.items()}
    ua, wu, va, wv = (np.asarray(t) for t in jmd.pack_aug(jp, 40, 128))
    aug = jmd.AUG
    for got, want, rows in ((fu, (ua, wu), 37), (fv, (va, wv), 45)):
        np.testing.assert_allclose(got[:, :a].numpy(), want[0][:rows, :a],
                                   rtol=1e-6)
        np.testing.assert_allclose(got[:, a:2 * a].numpy(),
                                   want[1][:rows, :a], rtol=1e-6)
        np.testing.assert_allclose(got[:, 2 * a:].numpy(),
                                   want[1][:rows, aug:aug + a], rtol=1e-6)


def test_pack_stats_and_cell_grads_checks():
    _, params, cnt, rsum, _, _ = setup()
    cp, rp = tmd.pack_stats(cnt, rsum)
    assert cp.dtype == torch.bfloat16 and torch.equal(cp.float(), cnt)
    with pytest.raises(ValueError, match="256"):
        tmd.pack_stats(cnt + 300.0, rsum)
    fu, fv = tmd.pack_aug(interop.mf_dense_params(params))
    assert tmd._check(cp, rp, fu, fv) == (40, 25, 6)
    with pytest.raises(ValueError, match="bf16"):
        tmd._check(cnt, rp, fu, fv)
    with pytest.raises(ValueError, match="3A"):
        tmd._check(cp, rp, fu[:, :-1], fv)
    before = tmd.LAUNCHES
    tmd.cell_grads(cp, rp, fu, fv)
    assert tmd.LAUNCHES == before
    with pytest.raises(ValueError, match="mm_dtype"):
        tmd.cell_grads(cp, rp, fu, fv, mm_dtype="bf16")
    with pytest.raises(ValueError, match="unsupported device"):
        tmd.cell_grads(cp.to("meta"), rp, fu, fv)


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13
    dropped bits' unit to the magnitude's bits, then mask them off."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(x, y, variant):
    """``x @ y`` as the kernel forms it in one mode: "split" (float32 mode,
    3xTF32: lo hi + hi lo + hi hi, float32 sums), "tf32" (one TF32 pass) or
    "bf16" (operands rounded to bf16)."""
    if variant == "bf16":
        return tmd._bf16(x) @ tmd._bf16(y)
    xh, yh = _tf32(x), _tf32(y)
    if variant == "tf32":
        return xh @ yh
    xl, yl = _tf32(x - xh), _tf32(y - yh)
    return xl @ yh + xh @ yl + xh @ yh


def _emulated_cell_grads(cnt, rsum, fu, fv, variant):
    """The kernel's arithmetic on the CPU: every product with split or
    rounded operands, G from that mean, and the loss without var:
    sum cnt var = sum_u <Wu_u, (cnt Wv)_u>."""
    a = fu.shape[1] // 3
    cnt = cnt.to(torch.float32)
    ua, wu, va, wv = fu[:, :a], fu[:, a:], fv[:, :a], fv[:, a:]
    mean = _split_mm(ua, va.T, variant)
    g = 2.0 * (cnt * mean - rsum)
    dfu = torch.cat([_split_mm(g, va, variant),
                     _split_mm(cnt, wv, variant)], 1)
    dfv = torch.cat([_split_mm(g.T, ua, variant),
                     _split_mm(cnt.T, wu, variant)], 1)
    wu_r = tmd._bf16(wu) if variant == "bf16" else wu
    cells = torch.sum((cnt * mean - 2.0 * rsum) * mean) \
        + torch.sum(wu_r * dfu[:, a:])
    return cells, dfu, dfv


@pytest.mark.parametrize("variant,within", [("split", True),
                                            ("tf32", False),
                                            ("bf16", True)])
def test_operand_split_precision(variant, within):
    """The kernel's operand handling emulated at 300 x 201 cells, K = 16,
    against the plain version in its mode: the float32 mode's 3xTF32 split
    holds phase 23's 1e-5 of max|g| (and 1e-5 loss rel) where one TF32
    pass does not; the bf16 mode holds its 1e-3 (and 1e-5 loss rel)."""
    _, params, cnt, rsum, _, _ = setup(300, 201, 16, 30_000)
    cp, rp = tmd.pack_stats(cnt, rsum)
    fu, fv = tmd.pack_aug(interop.mf_dense_params(params))
    mm = "bfloat16" if variant == "bf16" else "float32"
    want = tmd.cell_grads_reference(cp, rp, fu, fv, mm)
    got = _emulated_cell_grads(cp, rp, fu, fv, variant)
    lim = 1e-3 if variant == "bf16" else 1e-5
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got[1:], want[1:])]
    if within:
        assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
        assert max(errs) <= lim, errs
    else:
        assert max(errs) > lim, errs


# (NU, NI, K): ragged edges on both sides, the narrowest and widest A
KERNEL_SHAPES = [(300, 201, 16), (997, 1501, 16), (130, 67, 1),
                 (257, 129, 30)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(mm_dtype, shape):
    """On a CUDA card: the cell pass at shapes of several tiles with ragged
    edges against the plain version on the card: cells rel 1e-5, every
    gradient within 1e-5 (float32) or 1e-3 (bf16: a G entry at a rounding
    boundary may round the other way) of its largest entry; a second call
    repeats the first bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    nu, ni, k = shape
    _, params, cnt, rsum, _, _ = setup(nu, ni, k, nu * ni // 2)
    cp, rp = (t.to(dev) for t in tmd.pack_stats(cnt, rsum))
    fu, fv = tmd.pack_aug(interop.mf_dense_params(params, dev))
    before = tmd.LAUNCHES
    got = tmd.cell_grads(cp, rp, fu, fv, mm_dtype=mm_dtype)
    again = tmd.cell_grads(cp, rp, fu, fv, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert tmd.LAUNCHES == before + 2
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = tmd.cell_grads_reference(cp, rp, fu, fv, mm_dtype)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    lim = 1e-5 if mm_dtype == "float32" else 1e-3
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= lim * float(w.abs().max())
