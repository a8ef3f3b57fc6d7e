"""The port's GMM tempered-SMC path (``models/gmm.py``) end to end on the
CPU, and its likelihood hooks and particle layout against the JAX package.

``run`` in each of the four modes at the smoke size must predict the data
as well as the true generating mixture (posterior-predictive gap < 0.3 nats
per point, the JAX package's ``test_gmm_smc_predictive_matches_truth``
bound) within at least 3 stages.  The hooks take the same flat particles
on both sides (rtol 1e-5 on the value, 1e-4 of max|g| on the gradient);
the JAX side runs its plain jnp path (the CPU default).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.infer.smc import SMC as JSMC
from bayesic_tpu.models import gmm as jgmm
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.models import gmm as tgmm

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", tgmm.MODES)
def test_run_smoke_each_mode(mode):
    out = tgmm.run(tgmm.Config(smoke=True, device="cpu", mode=mode))
    assert out["mode"] == mode
    assert abs(out["gap"]) < 0.3, out["gap"]
    assert out["num_stages"] >= 3
    assert 0.0 < out["accept_rate"] <= 1.0
    assert np.isfinite(out["log_evidence"])
    res = out["result"]
    assert res.unconstrained.shape == (512, 11)
    assert res.particles["weights"].shape == (512, 3)


def test_default_mode_by_device():
    out = tgmm.run(tgmm.Config(device="cpu", num_particles=64, num_data=50,
                               mutation_steps=1, leapfrog_steps=2))
    assert out["mode"] == "generic"
    with pytest.raises(ValueError, match="mode"):
        tgmm.make_smc(tgmm.Config(), torch.zeros(5, 2), "xla")


def _pair(n=150, p=32):
    cfg = tgmm.Config(num_data=n)
    xn, truth = tgmm.make_data(cfg)
    jcfg = jgmm.Config(num_data=n)
    jx, jtruth = jgmm.make_data(jcfg)
    np.testing.assert_array_equal(np.asarray(jx), xn)
    for k in truth:
        np.testing.assert_array_equal(truth[k], jtruth[k])
    jsmc = JSMC(jgmm.make_model(jcfg, jx), num_particles=p)
    tsmc = tgmm.make_smc(cfg, torch.as_tensor(xn), "generic",
                         num_particles=p)
    q = np.random.default_rng(5).normal(0, 0.6, (p, tsmc.dim)) \
        .astype(np.float32)
    return jsmc, tsmc, jx, torch.as_tensor(xn), q


def test_particle_layout_matches_jax():
    """Both packages' flat particles are (weights K-1, mus K*D, sigma K);
    the interop maps the JAX's flat and lane-padded rows to the port's
    and both constrain them to the same values."""
    jsmc, tsmc, _, _, q = _pair()
    assert jsmc.dim == tsmc.dim == 11
    assert jsmc.info.latent_names == tsmc.info.latent_names
    off, sizes = 0, {"weights": 2, "mus": 6, "sigma": 3}
    for name in tsmc.info.latent_names:
        u = tsmc._unravel(torch.as_tensor(q))[name]
        np.testing.assert_array_equal(u.reshape(32, -1).numpy(),
                                      q[:, off:off + sizes[name]])
        off += sizes[name]
    lanes = np.zeros((32, 128), np.float32)
    lanes[:, :11] = q
    for rows in (q, lanes):
        qt = interop.smc_particles(rows, tsmc.dim)
        cons_t = tsmc._constrain(tsmc._unravel(qt))
        cons_j = jax.vmap(lambda v: jsmc._constrain(jsmc._unravel(v)))(
            jnp.asarray(q))
        for name in cons_t:
            np.testing.assert_allclose(cons_t[name].numpy(),
                                       np.asarray(cons_j[name]), rtol=1e-6)


def test_likelihood_hooks_match_jax():
    jsmc, tsmc, jx, x, q = _pair()
    ll_j = jgmm.make_batched_loglik(jsmc.info, jsmc._unravel, jx)(
        jnp.asarray(q))
    ll_j2, g_j = jgmm.make_batched_loglik_grad(
        jsmc.info, jsmc._unravel, jsmc._ravel, jx)(jnp.asarray(q))
    qt = torch.as_tensor(q)
    ll_t = tgmm.make_batched_loglik(tsmc.info, tsmc._unravel, x)(qt)
    ll_t2, g_t = tgmm.make_batched_loglik_grad(
        tsmc.info, tsmc._unravel, tsmc._ravel, x)(qt)
    for got, want in ((ll_t, ll_j), (ll_t2, ll_j2)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())
    # autograd through gmm_loglik (the split mode) gives the same gradient
    qg = qt.clone().requires_grad_()
    ll = tgmm.make_batched_loglik(tsmc.info, tsmc._unravel, x)(qg)
    (g_split,) = torch.autograd.grad(ll.sum(), qg)
    np.testing.assert_allclose(g_split.numpy(), g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())


def test_predictive_loglik_matches_jax():
    """The label-invariant check on the same weighted population."""
    jsmc, tsmc, jx, x, q = _pair()
    lw = np.random.default_rng(6).normal(0, 1, 32).astype(np.float32)
    lw -= np.log(np.exp(lw).sum())
    cons_t = tsmc._constrain(tsmc._unravel(torch.as_tensor(q)))
    cons_j = jax.vmap(lambda v: jsmc._constrain(jsmc._unravel(v)))(
        jnp.asarray(q))

    class R:
        pass

    rt, rj = R(), R()
    rt.particles, rt.log_weights = cons_t, torch.as_tensor(lw)
    rj.particles, rj.log_weights = cons_j, jnp.asarray(lw)
    cfg = tgmm.Config(num_data=150)
    got = tgmm.predictive_loglik(rt, x, cfg, num_particles_eval=16)
    want = jgmm.predictive_loglik(rj, jx, jgmm.Config(num_data=150),
                                  num_particles_eval=16)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_main_prints(capsys):
    tgmm.main(["--smoke", "true", "--device", "cpu", "--mode", "fused",
               "--num-particles", "128"])
    out = capsys.readouterr().out
    assert "posterior predictive loglik" in out and "mode fused" in out
