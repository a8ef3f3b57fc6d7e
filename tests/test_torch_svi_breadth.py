"""Parity of the port's SVI breadth with ``bayesic_tpu.infer.svi``: the
IWAE and DReG bounds (``make_elbo(iwae=, dreg=)``), ``LowRankGuide``,
``TraceGuide``, ``FlowGuide`` and ``SVI``'s ``posterior_stats``,
``sample_posterior`` and ``init(init_loc_from_prior=)``, on the same
seeded numpy inputs and parameters through both packages.

Tolerances: the bounds' values and gradients on fixed draws at rtol 1e-5
in float64 (JAX under ``jax.enable_x64``); the Gaussian guides' densities,
entropies, moments and covariances at rtol 1e-9 in float64; the flow's
pushforward, density and inverse at rtol 1e-9 in float64, its log-det
against autograd's Jacobian at 1e-9; the TraceGuide's log q at rtol 1e-5
(float32, as the JAX guide runs); the short IWAE run within 0.2 nats of
the analytic evidence (the JAX test's limit)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import bayesic_tpu.core as jcore
import bayesic_tpu.dist as jdist
import bayesic_tpu.infer.svi as jsvi
import bayesic_tpu_torch.core as tcore
import bayesic_tpu_torch.dist as tdist
import bayesic_tpu_torch.infer.svi as tsvi
from bayesic_tpu.dist import constraints as jcons
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.dist import constraints as tcons

torch.set_num_threads(2)

F64 = torch.float64
K = 6                   # particles of the IWAE/DReG checks
N_OBS = 12


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _data():
    return np.random.default_rng(5).normal(0.7, 1.3, N_OBS)


def _bound_model(pk):
    """mu ~ N(m0, 2) with m0 a learnable param, sig ~ LogNormal(0, 0.5),
    y ~ N(mu, sig): a real and a positive latent and a model param."""
    core, dist, a = pk["core"], pk["dist"], pk["a"]
    y = a(_data())

    def model():
        m0 = core.param("m0", a(np.float64(0.5)))
        mu = core.sample("mu", dist.Normal(m0, 2.0))
        sig = core.sample("sig", dist.LogNormal(0.0, 0.5))
        core.sample("obs", dist.Normal(mu, sig).expand((N_OBS,))
                    .to_event(1), obs=y)

    return model


JPK = dict(core=jcore, dist=jdist, a=lambda v: jnp.asarray(v))
TPK = dict(core=tcore, dist=tdist,
           a=lambda v: torch.as_tensor(np.asarray(v), dtype=F64))


class _JaxFixedGuide(jsvi.Guide):
    """A mean-field guide over the flat vector that reads its noise from
    ``eps`` (K, dim) instead of the key."""

    def __init__(self, info, eps):
        self.dim, self.unravel, _ = jsvi.unraveler(info)
        self.eps = jnp.asarray(eps)

    def sample_and_log_prob(self, params, key, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        flat = params["loc"] + jnp.exp(params["log_scale"]) * self.eps
        q = jax.lax.stop_gradient(params) if stop_gradient_q else params
        z = (flat - q["loc"]) * jnp.exp(-q["log_scale"])
        logq = jnp.sum(-0.5 * z * z - q["log_scale"]
                       - 0.5 * math.log(2 * math.pi), -1)
        return self.unravel(flat), logq


class _TorchFixedGuide(tsvi.Guide):
    def __init__(self, info, eps):
        self.dim, self.unravel, _ = tsvi.unraveler(info)
        self.eps = torch.as_tensor(eps, dtype=F64)

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        flat = params["loc"] + torch.exp(params["log_scale"]) * self.eps
        loc, ls = params["loc"], params["log_scale"]
        if stop_gradient_q:
            loc, ls = loc.detach(), ls.detach()
        z = (flat - loc) * torch.exp(-ls)
        logq = torch.sum(-0.5 * z * z - ls - 0.5 * math.log(2 * math.pi), -1)
        return self.unravel(flat), logq


def _bound_inputs():
    rng = np.random.default_rng(17)
    gp = {"loc": rng.normal(0.5, 0.3, 2), "log_scale": rng.normal(-0.7, 0.2,
                                                                   2)}
    mp = {"m0": np.float64(0.3)}
    eps = rng.standard_normal((K, 2))
    return gp, mp, eps


def _jax_bound(iwae, dreg, stl=True):
    gp, mp, eps = _bound_inputs()
    with jax.enable_x64(True):
        def f(g, m):
            info, ld, _, _ = jcore.build_logjoint(_bound_model(JPK))
            elbo = jsvi.make_elbo(ld, _JaxFixedGuide(info, eps),
                                  num_particles=K, stl=stl, iwae=iwae,
                                  dreg=dreg)
            return elbo(g, jax.random.PRNGKey(0), model_params=m)

        val, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
            jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, mp))
        return float(val), jax.tree.map(np.asarray, grads)


def _torch_bound(iwae, dreg, stl=True):
    gp, mp, eps = _bound_inputs()
    info, ld, _, _ = tcore.build_logjoint(_bound_model(TPK))
    elbo = tsvi.make_elbo(ld, _TorchFixedGuide(info, eps), num_particles=K,
                          stl=stl, iwae=iwae, dreg=dreg)
    g = {k: torch.as_tensor(v, dtype=F64).requires_grad_(True)
         for k, v in gp.items()}
    m = {k: torch.as_tensor(v, dtype=F64).requires_grad_(True)
         for k, v in mp.items()}
    val = elbo(g, torch.Generator().manual_seed(0), model_params=m)
    leaves = list(g.values()) + list(m.values())
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), ({k: _np(x) for k, x in zip(g, grads[:2])},
                        {"m0": _np(grads[2])})


@pytest.mark.parametrize("iwae,dreg", [(False, False), (True, False),
                                       (True, True)],
                         ids=["elbo", "iwae", "dreg"])
def test_bound_value_and_gradient_match_jax(iwae, dreg):
    jv, (jg, jm) = _jax_bound(iwae, dreg)
    tv, (tg, tm) = _torch_bound(iwae, dreg)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(tm["m0"], jm["m0"], rtol=1e-5, atol=1e-10)


def test_dreg_same_value_as_iwae_other_gradient():
    """DReG's surrogate has the IWAE bound's value and another guide
    gradient; the model param's gradient is the IWAE one (weights w~)."""
    v_i, (g_i, m_i) = _torch_bound(True, False)
    v_d, (g_d, m_d) = _torch_bound(True, True)
    np.testing.assert_allclose(v_d, v_i, rtol=1e-12)
    assert max(float(np.abs(g_d[k] - g_i[k]).max()) for k in g_i) > 1e-6
    np.testing.assert_allclose(m_d["m0"], m_i["m0"], rtol=1e-10)


def test_bound_value_errors():
    info, ld, _, _ = tcore.build_logjoint(_bound_model(TPK))
    guide = tsvi.MeanFieldGuide(info)
    with pytest.raises(ValueError, match="num_particles >= 2"):
        tsvi.make_elbo(ld, guide, num_particles=1, iwae=True)
    with pytest.raises(ValueError, match="requires iwae=True"):
        tsvi.make_elbo(ld, guide, num_particles=4, dreg=True)
    with pytest.raises(ValueError, match="num_particles >= 2"):
        tsvi.SVI(_bound_model(TPK), tsvi.MeanFieldGuide, tsvi.Adam(0.01),
                 iwae=True, device="cpu")


# ---------------------------------------------------------------------------
# LowRankGuide
# ---------------------------------------------------------------------------

D_LR, RANK = 7, 3


def _lr_model(pk):
    core, dist = pk["core"], pk["dist"]

    def model():
        core.sample("a", dist.Normal(0.0, 1.0).expand((3,)).to_event(1))
        core.sample("b", dist.Normal(0.0, 1.0).expand((2, 2)).to_event(2))

    return model


def _lr_params():
    rng = np.random.default_rng(11)
    return {"loc": rng.normal(0, 1, D_LR),
            "w": rng.normal(0, 0.5, (D_LR, RANK)),
            "log_diag": rng.normal(-0.5, 0.3, D_LR)}


def test_low_rank_matches_jax_and_dense_gaussian():
    p = _lr_params()
    pts = np.random.default_rng(12).normal(size=(4, 5, D_LR))
    with jax.enable_x64(True):
        jinfo, _, _, _ = jcore.build_logjoint(_lr_model(JPK))
        jg = jsvi.LowRankGuide(jinfo, rank=RANK)
        jp = jax.tree.map(jnp.asarray, p)
        j_lp = np.asarray(jg._log_prob(jp, jnp.asarray(pts)))
        j_h = float(jg.entropy(jp))
        j_loc, j_std = jax.tree.map(np.asarray, jg.stats(jp))
        j_cov = np.asarray(jg.covariance(jp))
    tinfo, _, _, _ = tcore.build_logjoint(_lr_model(TPK))
    tg = tsvi.LowRankGuide(tinfo, rank=RANK)
    tp = interop.tree_to_torch(p, dtype=F64)
    t_lp = _np(tg._log_prob(tp, torch.as_tensor(pts)))
    t_loc, t_std = tg.stats(tp)
    t_cov = _np(tg.covariance(tp))
    np.testing.assert_allclose(t_lp, j_lp, rtol=1e-9)
    np.testing.assert_allclose(float(tg.entropy(tp)), j_h, rtol=1e-9)
    np.testing.assert_allclose(t_cov, j_cov, rtol=1e-9, atol=1e-12)
    for k in j_loc:
        np.testing.assert_allclose(_np(t_loc[k]), j_loc[k], rtol=1e-12)
        np.testing.assert_allclose(_np(t_std[k]), j_std[k], rtol=1e-9)
    # against the dense N(loc, W W^T + diag(d^2))
    mvn = st.multivariate_normal(p["loc"], t_cov)
    np.testing.assert_allclose(t_lp.reshape(-1),
                               mvn.logpdf(pts.reshape(-1, D_LR)), rtol=1e-9)
    np.testing.assert_allclose(float(tg.entropy(tp)), mvn.entropy(),
                               rtol=1e-9)


def test_low_rank_sample_reads_injected_noise():
    p = _lr_params()
    tinfo, _, _, _ = tcore.build_logjoint(_lr_model(TPK))
    tg = tsvi.LowRankGuide(tinfo, rank=RANK)
    tp = interop.tree_to_torch(p, dtype=F64)
    eps = np.random.default_rng(13).normal(size=(8, D_LR + RANK))
    us, logq = tg.sample_and_log_prob(tp, None, (8,),
                                      ctx={"eps": torch.as_tensor(eps)})
    flat = p["loc"] + np.exp(p["log_diag"]) * eps[:, :D_LR] \
        + eps[:, D_LR:] @ p["w"].T
    np.testing.assert_allclose(_np(tg.ravel(us)), flat, rtol=1e-12)
    np.testing.assert_allclose(_np(logq),
                               _np(tg._log_prob(tp, torch.as_tensor(flat))),
                               rtol=1e-12)
    assert us["b"].shape == (8, 2, 2)
    # drawn: the shapes, and W off the saddle point at init
    g = torch.Generator().manual_seed(0)
    init = tg.init(g)
    assert init["w"].shape == (D_LR, RANK) and float(init["w"].abs().max()) > 0
    us, logq = tg.sample_and_log_prob(init, g, (3, 2))
    assert us["a"].shape == (3, 2, 3) and logq.shape == (3, 2)
    with pytest.raises(ValueError, match="rank"):
        tsvi.LowRankGuide(tinfo, rank=D_LR + 1)


# ---------------------------------------------------------------------------
# TraceGuide
# ---------------------------------------------------------------------------

def _tg_pair(pk, constrained):
    core, dist, a = pk["core"], pk["dist"], pk["a"]
    cons = jcons if pk is JPK32 else tcons
    y = a(np.random.default_rng(1).normal(0.0, 2.0, 30).astype(np.float32))

    if constrained:
        def model():
            s = core.sample("s", dist.HalfNormal(5.0))
            core.sample("obs", dist.Normal(0.0, s).expand((30,)).to_event(1),
                        obs=y)

        def guide():
            loc = core.param("s_loc", a(np.float32(0.5)))
            scale = core.param("s_scale", a(np.float32(0.1)),
                               constraint=cons.positive)
            core.sample("s", dist.LogNormal(loc, scale))
    else:
        def model():
            mu = core.sample("mu", dist.Normal(0.0, 10.0))
            core.sample("obs", dist.Normal(mu, 1.0).expand((30,))
                        .to_event(1), obs=y)

        def guide():
            loc = core.param("mu_loc", a(np.float32(0.2)))
            scale = core.param("mu_scale", a(np.float32(0.3)),
                               constraint=cons.positive)
            core.sample("mu", dist.Normal(loc, scale))
    return model, guide


JPK32 = dict(core=jcore, dist=jdist, a=lambda v: jnp.asarray(v))
TPK32 = dict(core=tcore, dist=tdist, a=lambda v: torch.as_tensor(v))


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["real", "positive"])
def test_trace_guide_log_q_matches_jax(constrained):
    """The port's log q at the JAX guide's own draws (the constrained latent
    pulled back with its log-det), its params from the JAX init, and its
    own draws' log q equal to log q at those draws."""
    jm, jgf = _tg_pair(JPK32, constrained)
    tm, tgf = _tg_pair(TPK32, constrained)
    jinfo, _, jconstrain, _ = jcore.build_logjoint(jm)
    jg = jsvi.TraceGuide(jgf, jinfo)
    jp = jg.init(None)
    jp = {k: v + 0.1 for k, v in jp.items()}
    ju, jlogq = jg.sample_and_log_prob(jp, jax.random.PRNGKey(3), (5,))
    jxs = jax.vmap(jconstrain)(ju)

    tinfo, _, _, _ = tcore.build_logjoint(tm)
    tg = tsvi.TraceGuide(tgf, tinfo, device="cpu")
    tp = interop.tree_to_torch(jax.tree.map(np.asarray, jp))
    for k in jp:
        np.testing.assert_allclose(_np(tg.init(torch.Generator())[k]) + 0.1,
                                   np.asarray(jp[k]), rtol=1e-6)
    for i in range(5):
        xs = {n: torch.as_tensor(np.array(v[i])) for n, v in jxs.items()}
        tu, tlogq = tg.log_prob_at(tp, xs)
        np.testing.assert_allclose(float(tlogq), float(jlogq[i]), rtol=1e-5)
        for n in tu:
            np.testing.assert_allclose(_np(tu[n]), np.asarray(ju[n][i]),
                                       rtol=1e-5, atol=1e-6)
    gen = torch.Generator().manual_seed(4)
    us, logq = tg.sample_and_log_prob(tp, gen, (4,))
    name = tinfo.latent_names[0]
    assert us[name].shape == (4,) and logq.shape == (4,)
    assert len(set(_np(us[name]).tolist())) == 4     # independent draws
    for i in range(4):
        x = tinfo.transforms[name].forward(us[name][i])
        np.testing.assert_allclose(
            float(tg.log_prob_at(tp, {name: x})[1]), float(logq[i]),
            rtol=1e-5)


def test_trace_guide_missing_latent_rejected():
    def model():
        tcore.sample("a", tdist.Normal(0.0, 1.0))
        tcore.sample("b", tdist.Normal(0.0, 1.0))

    def guide():
        tcore.sample("a", tdist.Normal(tcore.param("loc", torch.zeros(())),
                                       1.0))

    info, _, _, _ = tcore.build_logjoint(model)
    with pytest.raises(ValueError, match="does not sample"):
        tsvi.TraceGuide(guide, info, device="cpu")


def test_trace_guide_svi_recovers_posterior():
    """The JAX test's conjugate normal mean (test_predictive_guides.py:44)
    by the port's SVI with the TraceGuide, shortened."""
    y = np.random.default_rng(0).normal(2.0, 1.0, 40).astype(np.float32)

    def model():
        mu = tcore.sample("mu", tdist.Normal(0.0, 10.0))
        tcore.sample("obs", tdist.Normal(mu, 1.0).expand((40,)).to_event(1),
                     obs=torch.as_tensor(y))

    def guide():
        loc = tcore.param("mu_loc", torch.zeros(()))
        scale = tcore.param("mu_scale", torch.tensor(0.1),
                            constraint=tcons.positive)
        tcore.sample("mu", tdist.Normal(loc, scale))

    svi = tsvi.SVI(model, lambda info: tsvi.TraceGuide(guide, info,
                                                        device="cpu"),
                   tsvi.Adam(0.05), device="cpu")
    res = svi.run(torch.Generator().manual_seed(0), 600)
    post_var = 1.0 / (1.0 / 100.0 + 40)
    post_mean = post_var * float(y.sum())
    assert abs(float(res.params["mu_loc"]) - post_mean) < 0.05
    np.testing.assert_allclose(float(torch.exp(res.params["mu_scale"])),
                               math.sqrt(post_var), rtol=0.25)


# ---------------------------------------------------------------------------
# FlowGuide
# ---------------------------------------------------------------------------

def _toy(pk, d):
    core, dist = pk["core"], pk["dist"]

    def model():
        core.sample("w", dist.Normal(0.0, 1.0).expand((d,)).to_event(1))

    return model


def _flow_pair(d, num_flows, hidden, stl=False, seed=0):
    """Both packages' guides and the JAX init made non-trivial (random
    output heads and loc), carried to the port in float64."""
    with jax.enable_x64(True):
        jinfo, _, _, _ = jcore.build_logjoint(_toy(JPK, d))
        jg = jsvi.FlowGuide(jinfo, num_flows=num_flows, hidden=hidden,
                            stl=stl)
        key = jax.random.PRNGKey(seed)
        jp = jg.init(key)
        for k, layer in enumerate(jp["flows"]):
            kk = jax.random.fold_in(key, 100 + k)
            layer["w_out"] = 0.5 * jax.random.normal(kk,
                                                     layer["w_out"].shape)
            layer["b_out"] = 0.1 * jax.random.normal(
                jax.random.fold_in(kk, 1), layer["b_out"].shape)
        jp["loc"] = jax.random.normal(jax.random.fold_in(key, 7), (d,))
        jp = jax.tree.map(lambda a: np.asarray(a, np.float64), jp)
    tinfo, _, _, _ = tcore.build_logjoint(_toy(TPK, d))
    tg = tsvi.FlowGuide(tinfo, num_flows=num_flows, hidden=hidden, stl=stl)
    return jg, jp, tg, interop.tree_to_torch(jp, dtype=F64)


def test_flow_push_density_and_inverse_match_jax():
    d = 5
    jg, jp, tg, tp = _flow_pair(d, 3, (16, 16))
    eps = np.random.default_rng(3).normal(size=(7, d))
    with jax.enable_x64(True):
        jpj = jax.tree.map(jnp.asarray, jp)
        ju, jlq = jax.tree.map(np.asarray, jg._push(jpj, jnp.asarray(eps)))
        jinv = np.asarray(jg.log_prob_at(jpj, jnp.asarray(ju)))
        jm, js = jax.tree.map(np.asarray, jg._conditioner(
            jpj["flows"][1], jnp.asarray(eps)))
    tu, tlq = tg._push(tp, torch.as_tensor(eps))
    np.testing.assert_allclose(_np(tu), ju, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_np(tlq), jlq, rtol=1e-9)
    tm, ts = tg._conditioner(tp["flows"][1], torch.as_tensor(eps))
    np.testing.assert_allclose(_np(tm), jm, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_np(ts), js, rtol=1e-9, atol=1e-12)
    tinv = _np(tg.log_prob_at(tp, torch.as_tensor(np.array(ju))))
    np.testing.assert_allclose(tinv, jinv, rtol=1e-9)
    np.testing.assert_allclose(tinv, jlq, rtol=1e-9)      # exact inverse
    # the carried masks are the JAX package's
    for a, b in zip(tg._masks_np, jg._masks):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tg._out_mask_np, np.asarray(jg._out_mask))
    # round trip of the params
    back = interop.tree_to_jax(tp)
    np.testing.assert_array_equal(back["flows"][2]["w1"], jp["flows"][2]["w1"])


def test_flow_log_det_matches_autograd_jacobian():
    d = 5
    _, _, tg, tp = _flow_pair(d, 3, (16, 16), seed=1)
    eps = torch.as_tensor(np.random.default_rng(4).normal(size=(6, d)))
    _, logq = tg._push(tp, eps)
    base = torch.sum(-0.5 * eps ** 2 - 0.5 * math.log(2 * math.pi), -1)
    for i in range(eps.shape[0]):
        jac = torch.autograd.functional.jacobian(
            lambda e: tg._push(tp, e)[0], eps[i])
        _, ld = torch.linalg.slogdet(jac)
        np.testing.assert_allclose(float(logq[i]), float(base[i] - ld),
                                   rtol=1e-9, atol=1e-10)


def test_flow_layers_are_autoregressive():
    d = 6
    _, _, tg, tp = _flow_pair(d, 1, (32,), seed=2)
    u = torch.as_tensor(np.random.default_rng(5).normal(size=d))
    layer = tp["flows"][0]
    for head in (0, 1):
        jac = torch.autograd.functional.jacobian(
            lambda uu: tg._conditioner(layer, uu)[head], u)
        assert np.allclose(np.triu(_np(jac)), 0.0, atol=1e-12)


def test_flow_stl_same_value_other_gradient_and_stats():
    d = 4
    _, _, tg_std, tp = _flow_pair(d, 2, (16,), seed=3)
    tinfo, _, _, _ = tcore.build_logjoint(_toy(TPK, d))
    tg_stl = tsvi.FlowGuide(tinfo, num_flows=2, hidden=(16,), stl=True)
    eps = torch.as_tensor(np.random.default_rng(6).normal(size=(3, d)))
    out = []
    for g in (tg_std, tg_stl):
        p = {"loc": tp["loc"].clone().requires_grad_(True),
             "log_scale": tp["log_scale"].clone().requires_grad_(True),
             "flows": tp["flows"]}
        _, logq = g.sample_and_log_prob(p, None, (3,), stop_gradient_q=True,
                                        ctx={"eps": eps})
        v = torch.sum(logq)
        out.append((float(v.detach()), [_np(x) for x in torch.autograd.grad(
            v, [p["loc"], p["log_scale"]])]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-9)
    assert max(float(np.abs(a - b).max())
               for a, b in zip(out[0][1], out[1][1])) > 1e-4
    loc, std = tg_std.stats(tp, torch.Generator().manual_seed(0),
                            num_draws=20_000)
    u, _ = tg_std._push(tp, torch.randn(
        (20_000, d), generator=torch.Generator().manual_seed(0),
        dtype=F64))
    np.testing.assert_allclose(_np(loc["w"]), _np(u.mean(0)), rtol=1e-9)
    assert std["w"].shape == (d,)


# ---------------------------------------------------------------------------
# SVI: posterior access, init_loc_from_prior, an IWAE fit
# ---------------------------------------------------------------------------

def test_posterior_stats_sample_posterior_and_init_from_prior():
    y = torch.as_tensor(np.random.default_rng(8).normal(1.0, 0.5, 20),
                        dtype=torch.float32)

    def model():
        mu = tcore.sample("mu", tdist.Normal(0.0, 3.0))
        sig = tcore.sample("sig", tdist.HalfNormal(2.0))
        tcore.sample("obs", tdist.Normal(mu, sig).expand((20,)).to_event(1),
                     obs=y)

    svi = tsvi.SVI(model, tsvi.MeanFieldGuide, tsvi.Adam(0.05),
                   device="cpu")
    st0 = svi.init(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_np(st0.params["loc"]), np.zeros(2))
    st1 = svi.init(torch.Generator().manual_seed(0),
                   init_loc_from_prior=True)
    prior = tcore.init_to_prior(model, svi.info,
                                rng_key=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_np(st1.params["loc"]),
                               _np(svi.guide.ravel(prior)), rtol=1e-6)
    params = {"loc": torch.tensor([0.8, math.log(0.4)]),
              "log_scale": torch.tensor([-2.0, -3.0])}
    loc, std = svi.posterior_stats(params)
    np.testing.assert_allclose(float(loc["mu"]), 0.8)
    np.testing.assert_allclose(float(std["sig"]), math.exp(-3.0), rtol=1e-6)
    draws = svi.sample_posterior(params, torch.Generator().manual_seed(1),
                                 num_samples=4000)
    assert draws["mu"].shape == (4000,) and draws["sig"].shape == (4000,)
    assert bool((draws["sig"] > 0).all())
    assert abs(float(draws["mu"].mean()) - 0.8) < 0.01
    np.testing.assert_allclose(float(draws["sig"].log().mean()),
                               math.log(0.4), atol=0.005)


def test_sample_posterior_constrains_a_simplex_under_vmap():
    def model():
        tcore.sample("p", tdist.Dirichlet(torch.ones(3)))

    svi = tsvi.SVI(model, lambda info: tsvi.LowRankGuide(info, rank=1),
                   tsvi.Adam(0.05), device="cpu")
    st0 = svi.init(torch.Generator().manual_seed(0))
    draws = svi.sample_posterior(st0.params, torch.Generator().manual_seed(1),
                                 num_samples=50)
    assert draws["p"].shape == (50, 3)
    np.testing.assert_allclose(_np(draws["p"].sum(-1)), np.ones(50),
                               rtol=1e-6)


@pytest.mark.parametrize("dreg", [False, True], ids=["iwae", "dreg"])
def test_iwae_svi_reaches_the_evidence(dreg):
    """The JAX test's 1-D conjugate target (test_svi.py:198): mean-field is
    exact, so the trained K = 8 bound sits at the analytic log evidence."""
    rng = np.random.default_rng(3)
    n = 30
    y = rng.normal(0.5, 1.0, n).astype(np.float32)
    log_z = st.multivariate_normal.logpdf(
        y, np.zeros(n), np.eye(n) + 25.0 * np.ones((n, n)))
    yt = torch.as_tensor(y)

    def model():
        mu = tcore.sample("mu", tdist.Normal(0.0, 5.0))
        tcore.sample("obs", tdist.Normal(mu, 1.0).expand((n,)).to_event(1),
                     obs=yt)

    svi = tsvi.SVI(model, tsvi.MeanFieldGuide, tsvi.Adam(0.05),
                   num_particles=8, iwae=True, dreg=dreg, device="cpu")
    res = svi.run(torch.Generator().manual_seed(0), 700)
    losses = _np(res.losses)
    assert np.isfinite(losses).all()
    assert abs(-losses[-200:].mean() - log_z) < 0.2, (losses[-200:].mean(),
                                                     log_z)
