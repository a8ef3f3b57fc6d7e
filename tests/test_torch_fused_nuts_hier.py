"""Parity of the port's fused hier-logistic NUTS transition
(``ops/fused_nuts_hier.py``) with the JAX package.

Data come from the shared numpy recipe; chain states, momenta and the
transition's random streams are made with numpy and go to both packages.
The JAX side runs its plain functions: the lane-packed potential at
``mm_dtype=float32`` and the shared transition core
``_nuts_transition_core`` (what its Pallas kernel runs in interpret mode)
with ``turn_mask`` on the real lanes.  Its pad lanes are set to zero in q
and in the momentum: a pad's force is -q_pad = 0, so the pads stay at 0
and add nothing to any energy, and the 128-lane transition is the
D-dimensional one the port runs.  Tolerances: potential pe rtol 1e-5,
grad within 1e-4 * max|grad| (float32 sums over the rows in another
order); one transition: equal depth, num_steps and diverging, q' / pe' /
h0 rtol 1e-5 (q' with atol 1e-5); the fused and generic posteriors as the
JAX test compares its pair.

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``
is marked ``gpu`` and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.ops import fused_nuts as jfn
from bayesic_tpu.ops import fused_nuts_hier as jfnh
from bayesic_tpu_torch.infer.mcmc import MCMC
from bayesic_tpu_torch.models import hier_logistic as thl
from bayesic_tpu_torch.ops import fused_nuts_hier as tfnh

torch.set_num_threads(2)

J, NPG, F = 8, 40, 3
D = 2 + J + F
C, K = 8, 5


def _data(num_groups=J, obs_per_group=NPG, num_features=F):
    x, y, group, _ = thl.make_data(thl.Config(
        num_groups=num_groups, obs_per_group=obs_per_group,
        num_features=num_features))
    return x, y, group


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _streams(seed, c=C, kk=K, scale=0.4):
    """A start point near the posterior's bulk, momenta and the streams,
    as ``make_batched_transition_hier`` hands them to the kernel: exact
    +-1 signs and strictly negative log-uniforms."""
    rng = np.random.default_rng(seed)
    q = (scale * rng.normal(size=(c, D))).astype(np.float32)
    q[:, 0] += 0.5                         # mu
    q[:, 2:2 + J] += 0.5                   # theta around mu
    mom = rng.normal(size=(c, D)).astype(np.float32)
    sign = np.where(rng.random((c, kk)) < 0.5, 1.0, -1.0).astype(np.float32)
    lua = np.log(np.maximum(rng.random((c, kk)), 1e-38)).astype(np.float32)
    lul = np.log(np.maximum(rng.random((c, 1 << kk)), 1e-38)) \
        .astype(np.float32)
    return q, mom, sign, lua, lul


def _lanes(a, fill=0.0):
    out = np.full((a.shape[0], 128), fill, np.float32)
    out[:, :D] = a
    return jnp.asarray(out)


def _jax_pg():
    x, y, group = _data()
    design = jfnh.build_design(x, y, group, J)
    return jfnh.make_hier_potential(*design, J, F, mm_dtype=jnp.float32)


def _port_data():
    return tfnh.hier_data(*_t(*_data()), J)


def test_hier_data_sorts_rows_by_group():
    x, y, group = _data()
    rng = np.random.default_rng(0)
    perm = rng.permutation(x.shape[0])
    data = tfnh.hier_data(*_t(x[perm], y[perm], group[perm]), J)
    assert data.offsets.dtype == torch.int32
    np.testing.assert_array_equal(data.offsets.numpy(),
                                  np.arange(J + 1) * NPG)
    assert bool(torch.all(data.group[1:] >= data.group[:-1]))
    for j in range(J):
        rows = slice(j * NPG, (j + 1) * NPG)
        want = np.sort(x[perm][group[perm] == j], axis=0)
        np.testing.assert_array_equal(np.sort(data.x[rows].numpy(), axis=0),
                                      want)
    with pytest.raises(ValueError, match="group ids"):
        tfnh.hier_data(*_t(x, y, group), J - 1)


def test_potential_matches_jax_and_autograd():
    """pe and grad against the JAX lane-packed potential (pads at zero)
    and against autograd of the port's centered DSL model."""
    q = _streams(1)[0] * 2.0
    jpe, jg = _jax_pg()(_lanes(q))
    pe, g = tfnh.fused_hier_nuts_potential(torch.as_tensor(q), _port_data())
    assert pe.shape == (C, 1) and g.shape == (C, D)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg)[:, :D], rtol=0,
                               atol=1e-4 * scale)
    mcmc = MCMC(thl.make_model(J, F, None, centered=True), num_chains=C,
                model_args=_t(*_data()))
    ape, ag = mcmc._potential_and_grad(torch.as_tensor(q))
    np.testing.assert_allclose(pe[:, 0].numpy(), ape.detach().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), ag.detach().numpy(), rtol=0,
                               atol=1e-4 * scale)


def _compare(got, want):
    names = ("q", "pe", "grad", "accept", "diverging", "depth", "num_steps",
             "h0")
    got = [np.asarray(a).reshape(C, -1) for a in got]
    want = [np.asarray(a).reshape(C, -1) for a in want]
    want[0], want[2] = want[0][:, :D], want[2][:, :D]
    for i in (4, 5, 6):
        np.testing.assert_array_equal(got[i], want[i], err_msg=names[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5,
                               err_msg="q")
    for i in (1, 7):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5,
                                   err_msg=names[i])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-6,
                               err_msg="accept")


@pytest.mark.parametrize("eps", [0.02, 0.08, 2.0])
def test_reference_transition_matches_jax_core(eps):
    """One whole transition of ``reference_transition`` against the JAX
    core over the lane-packed potential with zeroed pads and the U-turn
    mask on the real lanes.  eps 2.0 makes every chain diverge."""
    q, mom, sign, lua, lul = _streams(2)
    rng = np.random.default_rng(3)
    inv_mass = rng.uniform(0.5, 1.5, (1, D)).astype(np.float32)
    jpg = _jax_pg()
    jq = _lanes(q)
    jpe, jg = jpg(jq)
    turn_mask = jnp.asarray((np.arange(128) < D)[None].astype(np.float32))
    want = jfn._nuts_transition_core(
        jq, jpe, jg, _lanes(mom), jnp.asarray(sign), jnp.asarray(lua),
        jnp.asarray(lul), jnp.asarray(eps, jnp.float32),
        _lanes(inv_mass, 1.0), jpg, K, turn_mask=turn_mask)
    assert float(jnp.abs(want[0][:, D:]).max()) == 0.0   # pads stay at 0
    data = _port_data()
    tq = torch.as_tensor(q)
    tpe, tg = tfnh.fused_hier_nuts_potential(tq, data)
    before = tfnh.LAUNCHES
    got = tfnh.fused_hier_nuts_transition(
        tq, tpe, tg, *_t(mom, sign, lua, lul), eps,
        torch.as_tensor(inv_mass), data, max_doublings=K)
    assert tfnh.LAUNCHES == before        # a CPU tensor runs the plain path
    _compare(got, want)
    if eps > 1.0:
        assert bool(torch.all(got[4] == 1.0))
    else:
        assert bool(torch.all(got[5] >= 1.0))
        assert bool(torch.any(got[0] != tq))


def test_state_consistency_under_zero_log_u():
    """Every leaf log-uniform exactly 0: the first-leaf guard must still
    fill each subtree's proposal, so pe' == pe(q') holds."""
    data = _port_data()
    q, mom, sign, lua, _ = _streams(4)
    tq = torch.as_tensor(q)
    pe, g = tfnh.fused_hier_nuts_potential(tq, data)
    for eps in (0.02, 0.1):
        out = tfnh.reference_transition(
            tq, pe, g, *_t(mom, sign, lua), torch.zeros(C, 1 << K), eps,
            torch.ones(D), data, max_doublings=K)
        pe_chk, g_chk = tfnh.fused_hier_nuts_potential(out[0], data)
        np.testing.assert_allclose(out[1].numpy(), pe_chk.numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out[2].numpy(), g_chk.numpy())


def test_wrapper_checks():
    """Inputs the kernel does not take raise in the wrapper (its checks run
    before any launch, so they are tested here on CPU tensors)."""
    data = _port_data()
    q = torch.zeros(2, D)
    assert tfnh._check_data(q, data) == (J, F)
    with pytest.raises(ValueError, match="q must be"):
        tfnh._check_data(torch.zeros(2, D + 1), data)
    with pytest.raises(ValueError, match="offsets"):
        tfnh._check_data(q, data._replace(offsets=data.offsets.long()))
    with pytest.raises(ValueError, match="unsupported device"):
        tfnh.fused_hier_nuts_potential(q.to("meta"), data)


def test_fused_sampler_matches_generic_posterior():
    """The two NUTS entry points on one small centered posterior (8
    chains, both at most 5 doublings): ``fused_nuts_mcmc`` (plain version
    on the CPU) and ``MCMC`` on the DSL model give marginal moments within
    MC error, as ``tests/test_fused_nuts_hier.py`` checks the JAX pair."""
    j, f = 6, 2
    x, y, group = _t(*_data(j, 50, f))
    chains, warm, samp = 8, 60, 60
    mcmc_f = thl.fused_nuts_mcmc(j, f, x, y, group, num_warmup=warm,
                                 num_samples=samp, num_chains=chains,
                                 max_doublings=5)
    assert mcmc_f.batched_transition is not None
    res_f = mcmc_f.run(0)
    res_g = MCMC(thl.make_model(j, f, None, centered=True), num_warmup=warm,
                 num_samples=samp, num_chains=chains, shared_adapt=True,
                 model_args=(x, y, group), target_accept=0.85,
                 max_depth=5).run(1)
    for site in ("mu", "tau", "theta", "beta"):
        fs = res_f.samples[site].reshape(chains * samp, -1).numpy()
        gs = res_g.samples[site].reshape(chains * samp, -1).numpy()
        assert np.isfinite(fs).all() and np.isfinite(gs).all()
        se = (fs.std(0) + gs.std(0)) / np.sqrt(200.0) + 0.02
        np.testing.assert_array_less(np.abs(fs.mean(0) - gs.mean(0)),
                                     5 * se, err_msg=site)
        np.testing.assert_allclose(fs.std(0), gs.std(0), rtol=0.3,
                                   atol=0.05, err_msg=site)
    assert int(res_f.extra["tree_depth"].max()) <= 5
    assert int(res_f.extra["diverging"].sum()) < 0.15 * chains * samp


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card: the kernel's potential and one transition equal the
    plain version's on the card (discrete outputs on every chain, values to
    rtol 1e-4), at the test shape and at K = 10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    data = tfnh.hier_data(*(a.to(dev) for a in _t(*_data())), J)
    for kk in (K, 10):
        q, mom, sign, lua, lul = (a.to(dev) for a in _t(*_streams(5, kk=kk)))
        pe, g = tfnh.fused_hier_nuts_potential(q, data)
        rpe, rg = tfnh.hier_potential(data)(q)
        torch.testing.assert_close(pe[:, 0], rpe, rtol=1e-5, atol=0)
        torch.testing.assert_close(g, rg, rtol=0,
                                   atol=1e-5 * float(rg.abs().max()))
        args = (q, pe, g, mom, sign, lua, lul, 0.05,
                torch.ones(D, device=dev), data)
        before = tfnh.LAUNCHES
        got = tfnh.fused_hier_nuts_transition(*args, max_doublings=kk)
        torch.cuda.synchronize()
        assert tfnh.LAUNCHES == before + 1
        want = tfnh.reference_transition(*args, max_doublings=kk)
        for i in (4, 5, 6):
            torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
        for i in (0, 1, 7):
            torch.testing.assert_close(got[i], want[i], rtol=1e-4,
                                       atol=1e-4)
    with pytest.raises(ValueError, match="max_doublings"):
        tfnh.fused_hier_nuts_transition(*args, max_doublings=13)
