"""Parity of the port's fused NUTS transition (``ops/fused_nuts.py``) and
its one batched NUTS core (``infer/mcmc/nuts.nuts_core``) with the JAX
package.

Inputs, decoder weights and the transition's random streams come from numpy
with a seed and go to both packages.  The JAX side runs its plain
functions: the lane-packed potential at ``mm_dtype=float32`` and the shared
transition core ``_nuts_transition_core`` (what its Pallas kernel runs in
interpret mode).  The port runs the precision it ships, fp32 throughout.
Tolerances: potential pe rtol 1e-5, grad within 1e-4 * max|grad|; one
transition: equal depth, num_steps and diverging, q' / pe' / h0 rtol 1e-5
(q' with atol 1e-5 for coordinates near zero); the posterior of the two
DLGM entry points as in ``tests/test_fused_nuts.py``.

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``
is marked ``gpu`` and skips here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.ops import fused_nuts as jfn
from bayesic_tpu_torch.infer.mcmc import MCMC, NUTSStreams, nuts_core
from bayesic_tpu_torch.models import dlgm as tdlgm
from bayesic_tpu_torch.ops import fused_nuts as tfn

torch.set_num_threads(2)

NB, LATENT, HIDDEN, DATA = 16, 8, 16, 8
D = NB * LATENT
C, K = 8, 5
SIGMA = 0.4


def _weights(seed):
    """Decoder weights (in, out) and a data batch, numpy float32."""
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(LATENT, HIDDEN)) / np.sqrt(LATENT)
    b1 = 0.1 * rng.normal(size=HIDDEN)
    w2 = rng.normal(size=(HIDDEN, DATA)) / np.sqrt(HIDDEN)
    b2 = 0.1 * rng.normal(size=DATA)
    x = rng.normal(size=(NB, DATA))
    return [a.astype(np.float32) for a in (w1, b1, w2, b2, x)]


def _streams(seed, c=C, kk=K, scale=0.5):
    """A start point, momenta and the transition's streams, as
    ``ops/fused_nuts.make_batched_transition`` draws them: exact +-1 signs
    and strictly negative log-uniforms."""
    rng = np.random.default_rng(seed)
    q = (scale * rng.normal(size=(c, D))).astype(np.float32)
    mom = rng.normal(size=(c, D)).astype(np.float32)
    sign = np.where(rng.random((c, kk)) < 0.5, 1.0, -1.0).astype(np.float32)
    lua = np.log(np.maximum(rng.random((c, kk)), 1e-38)).astype(np.float32)
    lul = np.log(np.maximum(rng.random((c, 1 << kk)), 1e-38)) \
        .astype(np.float32)
    return q, mom, sign, lua, lul


def _jax_pg(weights, c):
    w1, b1, w2, b2, x = weights
    dec = {"params": {"Dense_0": {"kernel": w1, "bias": b1},
                      "Dense_1": {"kernel": w2, "bias": b2}}}
    r = 128 // LATENT
    packed = jfn.pack_decoder(dec, LATENT, HIDDEN, DATA)
    return jfn.make_packed_potential(
        *packed, jfn.pack_x(x, LATENT, c), SIGMA, NB // r, c, NB, LATENT,
        DATA, mm_dtype=jnp.float32)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _model_potential(weights):
    """pe/grad by autograd of the port's DSL model (the generic path)."""
    w1, b1, w2, b2, x = _t(*weights)
    dec = tdlgm.Decoder(LATENT, HIDDEN, DATA)
    params = {"Dense_0.weight": w1.T, "Dense_0.bias": b1,
              "Dense_1.weight": w2.T, "Dense_1.bias": b2}
    cfg = tdlgm.Config(latent_dim=LATENT, hidden=HIDDEN, data_dim=DATA,
                       num_chains=C)
    mcmc = MCMC(tdlgm.local_posterior_model(cfg, dec, params, SIGMA, x),
                num_warmup=0, num_samples=1, num_chains=C, device="cpu")
    return mcmc._potential_and_grad


def test_dense_potential_matches_jax_and_autograd():
    weights = _weights(0)
    q = _streams(1)[0] * 1.4
    jpe, jg = _jax_pg(weights, C)(jnp.asarray(q))
    pe, g = tfn.fused_nuts_potential(torch.as_tensor(q), *_t(*weights),
                                     sigma=SIGMA)
    assert pe.shape == (C, 1) and g.shape == (C, D)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * scale)
    ape, ag = _model_potential(weights)(torch.as_tensor(q))
    np.testing.assert_allclose(pe[:, 0].numpy(), ape.detach().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), ag.detach().numpy(), rtol=0,
                               atol=1e-4 * scale)


def _gaussian(prec):
    """pe = 0.5 sum(prec q^2): (C, 1) pe for JAX, (C,) for the port."""
    def jpg(q):
        return 0.5 * jnp.sum(prec * q * q, 1, keepdims=True), prec * q

    tprec = torch.as_tensor(prec)

    def tpg(q):
        return 0.5 * torch.sum(tprec * q * q, 1), tprec * q

    return jpg, tpg


def _compare(got, want):
    names = ("q", "pe", "grad", "accept", "diverging", "depth", "num_steps",
             "h0")
    got = [np.asarray(a).reshape(C, -1) for a in got]
    want = [np.asarray(a).reshape(C, -1) for a in want]
    for i in (4, 5, 6):
        np.testing.assert_array_equal(got[i], want[i], err_msg=names[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5,
                               err_msg="q")
    for i in (1, 7):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5,
                                   err_msg=names[i])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-6,
                               err_msg="accept")


@pytest.mark.parametrize("eps", [0.05, 0.3, 80.0])
def test_core_matches_jax_core_gaussian(eps):
    """The one batched core against ``_nuts_transition_core`` on an
    anisotropic Gaussian: the same injected streams give the same tree.
    eps 80 makes every chain diverge."""
    rng = np.random.default_rng(3)
    prec = rng.uniform(0.5, 4.0, D).astype(np.float32)
    q, mom, sign, lua, lul = _streams(4)
    inv_mass = rng.uniform(0.5, 1.5, D).astype(np.float32)
    jpg, tpg = _gaussian(prec)
    jq = jnp.asarray(q)
    jpe, jg = jpg(jq)
    want = jfn._nuts_transition_core(
        jq, jpe, jg, jnp.asarray(mom), jnp.asarray(sign), jnp.asarray(lua),
        jnp.asarray(lul), jnp.asarray(eps, jnp.float32),
        jnp.asarray(inv_mass)[None], jpg, K)
    tq = torch.as_tensor(q)
    tpe, tg = tpg(tq)
    got = nuts_core(tpg, tq, tpe, tg, NUTSStreams(*_t(mom, sign, lua, lul)),
                    eps, torch.as_tensor(inv_mass), K)
    _compare(got, want)
    if eps > 10:
        assert bool(torch.all(got[4] == 1.0))
    else:
        assert bool(torch.all(got[5] >= 1.0))


@pytest.mark.parametrize("eps", [0.1, 0.35])
def test_reference_transition_matches_jax_core_dlgm(eps):
    """``reference_transition`` (the kernel's plain version) against the JAX
    core over the packed DLGM potential, from one state and one set of
    streams."""
    weights = _weights(5)
    q, mom, sign, lua, lul = _streams(6)
    inv_mass = np.full((1, D), 0.9, np.float32)
    jpg = _jax_pg(weights, C)
    jq = jnp.asarray(q)
    jpe, jg = jpg(jq)
    want = jfn._nuts_transition_core(
        jq, jpe, jg, jnp.asarray(mom), jnp.asarray(sign), jnp.asarray(lua),
        jnp.asarray(lul), jnp.asarray(eps, jnp.float32),
        jnp.asarray(inv_mass), jpg, K)
    tq = torch.as_tensor(q)
    tw = _t(*weights)
    tpe, tg = tfn.fused_nuts_potential(tq, *tw, sigma=SIGMA)
    before = tfn.LAUNCHES
    got = tfn.fused_nuts_transition(
        tq, tpe, tg, *_t(mom, sign, lua, lul), eps,
        torch.as_tensor(inv_mass), *tw, sigma=SIGMA, max_doublings=K)
    assert tfn.LAUNCHES == before        # a CPU tensor runs the plain path
    assert all(a.shape == (C, 1) for i, a in enumerate(got) if i not in
               (0, 2))
    _compare(got, want)
    assert bool(torch.any(got[0] != tq))


def test_state_consistency_under_zero_log_u():
    """The adversarial case of ``tests/test_fused_nuts.py``: every leaf
    log-uniform is exactly 0.  The first-leaf guard must still fill each
    subtree's proposal, so pe' == pe(q') holds."""
    weights = _weights(7)
    tw = _t(*weights)
    q, mom, sign, lua, lul = _streams(8)
    tq = torch.as_tensor(q)
    pe, g = tfn.fused_nuts_potential(tq, *tw, sigma=SIGMA)
    for eps in (0.05, 0.2, 0.5):
        out = tfn.reference_transition(
            tq, pe, g, *_t(mom, sign, lua), torch.zeros(C, 1 << K), eps,
            torch.ones(D), *tw, sigma=SIGMA, max_doublings=K)
        pe_chk, g_chk = tfn.fused_nuts_potential(out[0], *tw, sigma=SIGMA)
        np.testing.assert_allclose(out[1].numpy(), pe_chk.numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out[2].numpy(), g_chk.numpy())


def test_unsupported_device_and_shapes_raise():
    """Shapes the kernel does not take raise in the wrapper (its checks run
    before any launch, so they are tested here on CPU tensors)."""
    tw = _t(*_weights(0))
    q = torch.zeros(2, D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfn.fused_nuts_potential(q, *tw, sigma=SIGMA)
    q = torch.zeros(2, D)
    assert tfn._check_weights(q, *tw) == (NB, LATENT, HIDDEN, DATA)
    with pytest.raises(ValueError, match="w2"):
        tfn._check_weights(q, tw[0], tw[1], tw[2].T.contiguous(), *tw[3:])
    with pytest.raises(ValueError, match="q must be"):
        tfn._check_weights(torch.zeros(2, D + 1), *tw)
    with pytest.raises(ValueError, match="log_u_leaf"):
        tfn._check_rows(2, log_u_leaf=(torch.zeros(2, 1 << K), 1 << (K + 1)))


def _local_setup(chains, warmup, samples):
    w1, b1, w2, b2, x = _t(*_weights(9))
    dec = tdlgm.Decoder(LATENT, HIDDEN, DATA)
    params = {"Dense_0.weight": w1.T.contiguous(), "Dense_0.bias": b1,
              "Dense_1.weight": w2.T.contiguous(), "Dense_1.bias": b2}
    cfg = dataclasses.replace(
        tdlgm.Config(latent_dim=LATENT, hidden=HIDDEN, data_dim=DATA),
        num_chains=chains, num_warmup=warmup, num_samples=samples)
    return cfg, dec, params, x


def test_fused_sampler_matches_generic_posterior():
    """The two DLGM entry points on one local posterior (16 chains): the
    fused transition (plain version on the CPU) and the generic engine
    give marginal moments within MC error, as ``tests/test_fused_nuts.py``
    checks the JAX pair."""
    cfg, dec, params, x = _local_setup(16, 100, 100)
    mcmc_f, res_f = tdlgm.local_posterior_mcmc_fused(
        cfg, dec, params, SIGMA, x, max_doublings=5, run_seed=0)
    mcmc_g, res_g = tdlgm.local_posterior_mcmc(
        cfg, dec, params, SIGMA, x, 1, shared_adapt=True)
    zf = res_f.samples["z"].reshape(-1, D).numpy()
    zg = res_g.samples["z"].reshape(-1, D).numpy()
    assert np.isfinite(zf).all() and np.isfinite(zg).all()
    se = (zg.std(0) / np.sqrt(200.0) + zf.std(0) / np.sqrt(200.0)) + 0.02
    np.testing.assert_array_less(np.abs(zf.mean(0) - zg.mean(0)), 5 * se)
    np.testing.assert_allclose(zf.std(0), zg.std(0), rtol=0.25, atol=0.05)
    assert int(res_f.extra["diverging"].sum()) == 0
    assert mcmc_f.batched_transition is not None
    assert int(res_f.extra["tree_depth"].max()) <= 5


def test_dlgm_run_smoke_reports_nuts():
    """``dlgm.run`` at the smoke config (8 chains, per-chain adaptation)
    adds the NUTS half's numbers, as the JAX ``run`` does."""
    out = tdlgm.run(tdlgm.Config(smoke=True, device="cpu"))
    assert np.isfinite(out["nuts_min_ess"]) and out["nuts_min_ess"] > 0
    assert isinstance(out["nuts_divergences"], int)
    assert 0 <= out["nuts_divergences"] <= 8 * 100


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card: the kernel's potential and one transition equal the
    plain version's on the card (discrete outputs on every chain, values to
    rtol 1e-4), at the test shape and at K = 10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tw = [a.to(dev) for a in _t(*_weights(11))]
    for kk in (K, 10):
        q, mom, sign, lua, lul = _t(*_streams(12, kk=kk))
        q = q.to(dev)
        pe, g = tfn.fused_nuts_potential(q, *tw, sigma=SIGMA)
        rpe, rg = tfn.dense_potential(*tw, SIGMA)(q)
        torch.testing.assert_close(pe[:, 0], rpe, rtol=1e-5, atol=0)
        args = (q, pe, g, mom.to(dev), sign.to(dev), lua.to(dev),
                lul.to(dev), 0.2, torch.ones(D, device=dev), *tw)
        before = tfn.LAUNCHES
        got = tfn.fused_nuts_transition(*args, sigma=SIGMA, max_doublings=kk)
        torch.cuda.synchronize()
        assert tfn.LAUNCHES == before + 1
        want = tfn.reference_transition(*args, sigma=SIGMA,
                                        max_doublings=kk)
        for i in (4, 5, 6):
            torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
        for i in (0, 1, 7):
            torch.testing.assert_close(got[i], want[i], rtol=1e-4,
                                       atol=1e-4)
    with pytest.raises(ValueError, match="max_doublings"):
        tfn.fused_nuts_transition(*args, sigma=SIGMA, max_doublings=13)
    with pytest.raises(ValueError, match="inv_mass"):
        tfn.fused_nuts_transition(*args[:8], torch.ones(2, D, device=dev),
                                  *tw, sigma=SIGMA, max_doublings=10)
