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


def test_pack_aug_matches_jax():
    import jax.numpy as jnp

    _, params, cnt, _, _, _ = setup(37, 45, 3, 900)
    fu, fv = tmd.pack_aug(interop.mf_dense_params(params))
    a = 3 + 2
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


@pytest.mark.gpu
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(mm_dtype):
    """On a CUDA card: the cell pass at a shape of several tiles with
    ragged edges (300 x 201 cells, K = 16) against the plain version on
    the card: cells rel 1e-5, every gradient within 1e-5 (float32) or 1e-3
    (bf16: a G entry at a rounding boundary may round the other way) of
    its largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    _, params, cnt, rsum, _, _ = setup(300, 201, 16, 30_000)
    cp, rp = (t.to(dev) for t in tmd.pack_stats(cnt, rsum))
    fu, fv = tmd.pack_aug(interop.mf_dense_params(params, dev))
    before = tmd.LAUNCHES
    got = tmd.cell_grads(cp, rp, fu, fv, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert tmd.LAUNCHES == before + 1
    want = tmd.cell_grads_reference(cp, rp, fu, fv, mm_dtype)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    lim = 1e-5 if mm_dtype == "float32" else 1e-3
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= lim * float(w.abs().max())
