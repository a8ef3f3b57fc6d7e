"""Parity of the port's matrix-factorization model (``models/
matrix_fact.py``) with the JAX package's: the data and the dense
statistics, the analytic dense objective and its gradients, a run of the
dense trainer, and the mini-batch model's log-density.

Inputs are made with numpy and go to both packages.  Tolerances: the
dense objective rel 2e-5 and gradients rtol 2e-4 / atol 2e-3 (the JAX
kernel test's own, float32 products in another order); the 100-step dense
trajectory rtol 1e-4 (a deterministic objective, so only rounding
compounds); the mini-batch log-density rel 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.core.logjoint import build_logjoint as j_build
from bayesic_tpu.models import matrix_fact as jmf
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.core.logjoint import build_logjoint as t_build
from bayesic_tpu_torch.infer.svi.svi import tree_leaves
from bayesic_tpu_torch.models import matrix_fact as tmf
from bayesic_tpu_torch.ops import mf_dense as tmd

torch.set_num_threads(2)
SITES = ("u", "v", "bu", "bi", "m")


def _cfgs(**kw):
    base = dict(num_users=40, num_items=25, num_factors=4, num_ratings=1500,
                seed=0)
    base.update(kw)
    return tmf.Config(**base, device="cpu"), jmf.Config(**base)


def _params(cfg, seed=1):
    rng = np.random.default_rng(seed)
    shapes = {"u": (cfg.num_users, cfg.num_factors),
              "v": (cfg.num_items, cfg.num_factors),
              "bu": (cfg.num_users,), "bi": (cfg.num_items,), "m": ()}
    return {s: ((0.2 * rng.normal(size=sh) + (3.0 if s == "m" else 0.0))
                .astype(np.float32),
                (np.log(0.15) + 0.2 * rng.normal(size=sh)).astype(np.float32))
            for s, sh in shapes.items()}


def _jax(params):
    return {s: tuple(jnp.asarray(v) for v in pair)
            for s, pair in params.items()}


def test_data_and_dense_stats_match_jax(tmp_path):
    tcfg, jcfg = _cfgs()
    tdata, jdata = tmf.make_data(tcfg), jmf.make_data(jcfg)
    for a, b in zip(tdata[:3], jdata[:3]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tmf.dense_stats(*tdata[:3], 40, 25),
                    jmf.dense_stats(*jdata[:3], 40, 25)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # data_file: the missing file is written from the same recipe and read
    # back, by the port and by the JAX package
    path = str(tmp_path / "ratings.bin")
    fcfg, jfcfg = _cfgs(data_file=path)
    for got in (tmf.make_data(fcfg), jmf.make_data(jfcfg)):
        for a, b in zip(got[:3], jdata[:3]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dense_objective_and_plain_pass_match_jax_autodiff():
    """The eager objective with autograd, and the plain cell pass with the
    hand chain rule, both against ``jax.value_and_grad`` of the JAX
    ``dense_neg_elbo`` (the ragged shape is held against the JAX kernel in
    ``test_torch_mf_dense.py``)."""
    nu, ni = 40, 25
    tcfg, _ = _cfgs()
    cnt, rsum, sqsum, n = tmf.dense_stats(*tmf.make_data(tcfg)[:3], nu, ni)
    params = _params(tcfg)
    jl, jg = jax.value_and_grad(jmf.dense_neg_elbo)(
        _jax(params), jnp.asarray(cnt.numpy()), jnp.asarray(rsum.numpy()),
        sqsum, n, tcfg.noise)
    tp = {s: tuple(t.requires_grad_(True) for t in pair)
          for s, pair in interop.mf_dense_params(params).items()}
    loss = tmf.dense_neg_elbo(tp, cnt, rsum, sqsum, n, tcfg.noise)
    g = iter(torch.autograd.grad(loss, tree_leaves(tp)))
    grads = {s: (next(g), next(g)) for s in SITES}
    cp, rp = tmd.pack_stats(cnt, rsum)
    pl, pg = tmd.dense_value_and_grad(interop.mf_dense_params(params), cp,
                                      rp, sqsum, n, tcfg.noise)
    for got_loss, got_grads in ((loss.detach(), grads), (pl, pg)):
        assert float(got_loss) == pytest.approx(float(jl), rel=2e-5)
        for s in SITES:
            for g_, w in zip(got_grads[s], jg[s]):
                np.testing.assert_allclose(g_.numpy(), np.asarray(w),
                                           rtol=2e-4, atol=2e-3)


def test_run_dense_trajectory_matches_jax():
    """100 dense Adam steps (cosine rate) from the same params: the loss
    trajectories and the final params agree."""
    tcfg, jcfg = _cfgs(steps=100, lr=0.05)
    key = jax.random.PRNGKey(1)
    p0 = jax.tree.map(np.asarray, jmf.dense_init(jcfg, key))
    data = tmf.make_data(tcfg)
    want = jmf.run_dense(jcfg, key, data=tuple(jnp.asarray(a)
                                               for a in data[:3]) + (None,))
    got = tmf.run_dense(tcfg, data=data, params=interop.mf_dense_params(p0))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["rmse"] == pytest.approx(want["rmse"], rel=1e-4)
    for s in SITES:
        np.testing.assert_allclose(got["params"][s][0].numpy(),
                                   np.asarray(want["params"][s][0]),
                                   rtol=1e-3, atol=1e-4)


def test_fused_train_tracks_run_dense_objective():
    """``mf_dense.fused_train`` (the plain pass on the CPU) and autograd of
    ``dense_neg_elbo`` under the same constant-rate Adam take the same
    steps (the JAX ``test_fused_train_matches_xla_path``)."""
    from bayesic_tpu_torch.infer.svi import Adam
    from bayesic_tpu_torch.infer.svi.svi import tree_map

    tcfg, _ = _cfgs(num_users=30, num_items=20, num_factors=3,
                    num_ratings=1200)
    cnt, rsum, sqsum, n = tmf.dense_stats(*tmf.make_data(tcfg)[:3], 30, 20)
    p0 = interop.mf_dense_params(_params(tcfg))
    pk, _, lk = tmd.fused_train(p0, cnt, rsum, sqsum, n, tcfg.noise,
                                steps=60, lr=0.02)
    opt, params = Adam(0.02), p0
    state, lx = opt.init(params), []
    for _ in range(60):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = tmf.dense_neg_elbo(p, cnt, rsum, sqsum, n, tcfg.noise)
        g = iter(torch.autograd.grad(loss, tree_leaves(p)))
        params, state = opt.update({s: (next(g), next(g)) for s in SITES},
                                   state, params)
        lx.append(float(loss.detach()))
    np.testing.assert_allclose(lk.numpy(), lx, rtol=5e-4)
    for a, b in zip(tree_leaves(pk), tree_leaves(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_minibatch_logdensity_matches_jax():
    """The mini-batch model's log-density at fixed params and a forced
    index batch; row lookups clamp out-of-range indices as ``jnp.take``
    does."""
    tcfg, jcfg = _cfgs(batch_size=64)
    users, items, ratings, _ = tmf.make_data(tcfg)
    rng = np.random.default_rng(5)
    u = {"u": rng.normal(size=(40, 4)), "v": rng.normal(size=(25, 4)),
         "bu": rng.normal(size=40), "bi": rng.normal(size=25),
         "m": np.asarray(rng.normal() + 3.0)}
    u = {s: v.astype(np.float32) for s, v in u.items()}
    idx = rng.integers(0, 1500, 64)
    tdata = tuple(torch.as_tensor(a) for a in (users, items, ratings))
    _, ld_t, _, _ = t_build(tmf.make_model(tcfg), *tdata)
    _, ld_j, _, _ = j_build(jmf.make_model(jcfg),
                            *(jnp.asarray(a) for a in (users, items,
                                                       ratings)))
    got = ld_t({s: torch.as_tensor(v) for s, v in u.items()},
               subsample={"ratings__idx": torch.as_tensor(idx)})
    want = ld_j({s: jnp.asarray(v) for s, v in u.items()},
                subsample={"ratings__idx": jnp.asarray(idx)})
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    row = tmf._rows(torch.arange(5.0), torch.tensor([-2, 1, 9]))
    assert row.tolist() == [0.0, 1.0, 4.0]


def test_run_smoke():
    """The mini-batch entry point on the smoke config: the loss falls and
    the posterior-mean predictor fits well below the ratings' spread."""
    out = tmf.run(tmf.Config(smoke=True, device="cpu"))
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-50:].mean() < out["losses"][:50].mean()
    assert out["rmse"] < 1.5 * out["noise_floor"]
