"""Parity of the port's hierarchical-logistic path (distributions,
``MeanFieldGuide``, the cosine schedule, the DSL model in both
parameterizations and the generic SVI step) with the JAX package, plus the
engines' device defaults.

Data come from the shared numpy recipe; parameters, mini-batch indices and
guide noise are made with numpy (or drawn by JAX and handed to the port)
and go to both packages.  Tolerances: log-probs rtol 1e-6; guide draws and
log q rtol 1e-6; schedule rtol 1e-6 / atol 1e-8 (optax's float32);
log-density rtol 1e-5 and gradients
rtol 1e-4 / atol 1e-4 (float32 sums over the rows in another order); SVI
losses rtol 1e-5 and parameters after three Adam steps rtol 1e-4 / atol
1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bayesic_tpu.dist as jdist
from bayesic_tpu.core.logjoint import build_logjoint as j_build_logjoint
from bayesic_tpu.infer.svi import SVI as JSVI
from bayesic_tpu.infer.svi import MeanFieldGuide as JMeanFieldGuide
from bayesic_tpu.infer.svi.elbo import draw_subsample as j_draw_subsample
from bayesic_tpu.models import hier_logistic as jhl
from bayesic_tpu_torch import dist as tdist
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.core import build_logjoint, sample
from bayesic_tpu_torch.core.logjoint import default_device
from bayesic_tpu_torch.infer.mcmc import MCMC
from bayesic_tpu_torch.infer.svi import (SVI, Adam, MeanFieldGuide,
                                         cosine_decay_schedule)
from bayesic_tpu_torch.models import dlgm as tdlgm
from bayesic_tpu_torch.models import hier_logistic as thl

torch.set_num_threads(2)

J, NPG, F, B = 8, 40, 3, 64
CFG = dict(num_groups=J, obs_per_group=NPG, num_features=F, batch_size=B)


def _data():
    x, y, group, _ = thl.make_data(thl.Config(**CFG, device="cpu"))
    return x, y, group


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


# -- distributions ------------------------------------------------------------

def test_halfnormal_bernoulli_and_exp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.05, 6.0, 20).astype(np.float32)
    scale = rng.uniform(0.5, 3.0, 20).astype(np.float32)
    for s in (2.0, scale):
        want = jdist.HalfNormal(s).log_prob(jnp.asarray(x))
        got = tdist.HalfNormal(torch.as_tensor(s)).log_prob(
            torch.as_tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    logits = rng.normal(0, 4.0, 20).astype(np.float32)
    obs = (rng.random(20) < 0.5).astype(np.int32)
    probs = rng.uniform(0.05, 0.95, 20).astype(np.float32)
    for kw, a in (("logits", logits), ("probs", probs)):
        want = jdist.Bernoulli(**{kw: jnp.asarray(a)}).log_prob(
            jnp.asarray(obs))
        got = tdist.Bernoulli(**{kw: torch.as_tensor(a)}).log_prob(
            torch.as_tensor(obs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    u = rng.normal(0, 1.5, 20).astype(np.float32)
    jt = jdist.biject_to(jdist.HalfNormal(2.0).support)
    tt = tdist.biject_to(tdist.HalfNormal(2.0).support)
    assert isinstance(tt, tdist.Exp)
    np.testing.assert_allclose(tt.log_det_jacobian(torch.as_tensor(u)),
                               np.asarray(jt.log_det_jacobian(u)), rtol=1e-6)
    np.testing.assert_allclose(tt.forward(torch.as_tensor(u)),
                               np.asarray(jt.forward(u)), rtol=1e-6)
    with pytest.raises(ValueError, match="exactly one"):
        tdist.Bernoulli()


def test_bernoulli_latent_is_refused():
    def model():
        sample("b", tdist.Bernoulli(probs=torch.tensor(0.3)))

    assert tdist.constraints.boolean.is_discrete
    with pytest.raises(ValueError, match="discrete"):
        build_logjoint(model)


# -- guide, schedule, Adam ----------------------------------------------------

def _info_pair(centered=False, batch=B):
    x, y, group = _data()
    jinfo, jld, _, _ = j_build_logjoint(
        jhl.make_model(J, F, batch, centered), *map(jnp.asarray,
                                                    (x, y, group)))
    tinfo, tld, _, _ = build_logjoint(
        thl.make_model(J, F, batch, centered), *_t(x, y, group))
    return jinfo, jld, tinfo, tld


def test_mean_field_guide_matches_jax():
    jinfo, _, tinfo, _ = _info_pair()
    jg, tg = JMeanFieldGuide(jinfo), MeanFieldGuide(tinfo)
    assert jg.dim == tg.dim == 2 + J + F
    rng = np.random.default_rng(1)
    params = {"loc": rng.normal(0, 0.5, tg.dim).astype(np.float32),
              "log_scale": rng.normal(-1.5, 0.3, tg.dim).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    ju, jlogq = jg.sample_and_log_prob(
        jax.tree.map(jnp.asarray, params), key, (4,), stop_gradient_q=True)
    eps = np.array(jax.random.normal(key, (4, tg.dim)))
    tu, tlogq = tg.sample_and_log_prob(
        interop.mean_field_params(params), None, (4,), stop_gradient_q=True,
        ctx={"eps": torch.as_tensor(eps)})
    for k in tinfo.latent_names:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tlogq.numpy(), np.asarray(jlogq), rtol=1e-6)
    tp = interop.mean_field_params(params)
    np.testing.assert_allclose(float(tg.entropy(tp)),
                               float(jg.entropy(params)), rtol=1e-6)
    tm, ts = tg.stats(tp)
    jm, js = jg.stats(params)
    for k in tinfo.latent_names:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]))
    back = interop.mean_field_to_jax(tp)
    np.testing.assert_array_equal(back["loc"], params["loc"])
    init = tg.init(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(init["log_scale"].numpy(),
                               np.asarray(jg.init(key)["log_scale"]))


def test_cosine_schedule_and_adam_match_optax():
    total = 40
    sched, jsched = cosine_decay_schedule(0.03, total), \
        optax.cosine_decay_schedule(0.03, total)
    for t in range(total + 6):
        # optax evaluates in float32: a few ulps of lr0 apart
        np.testing.assert_allclose(sched(t), float(jsched(t)), rtol=1e-6,
                                   atol=1e-8)
    rng = np.random.default_rng(2)
    p = {"a": rng.normal(size=5).astype(np.float32)}
    grads = [{"a": rng.normal(size=5).astype(np.float32)} for _ in range(5)]
    opt = optax.adam(optax.cosine_decay_schedule(0.03, 4))
    jp = jax.tree.map(jnp.asarray, p)
    js = opt.init(jp)
    tadam = Adam(cosine_decay_schedule(0.03, 4))
    tp = {"a": torch.as_tensor(p["a"])}
    ts = tadam.init(tp)
    for g in grads:
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = tadam.update({"a": torch.as_tensor(g["a"])}, ts, tp)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-5, atol=1e-7)


# -- the model ---------------------------------------------------------------

def test_make_data_matches_jax():
    cfg = dict(num_groups=5, obs_per_group=7, num_features=2, seed=3)
    got = thl.make_data(thl.Config(**cfg))
    want = jhl.make_data(jhl.Config(**cfg))
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    for k in ("theta", "beta", "mu", "tau"):
        np.testing.assert_array_equal(got[3][k], want[3][k])


@pytest.mark.parametrize("centered", [False, True])
def test_logdensity_and_grad_match_jax(centered):
    """Both parameterizations: non-centered with a forced mini-batch (the
    SVI model), centered on the full data (the NUTS model)."""
    batch = None if centered else B
    jinfo, jld, tinfo, tld = _info_pair(centered, batch)
    assert tinfo.latent_names == jinfo.latent_names
    assert tinfo.observed_names == jinfo.observed_names
    rng = np.random.default_rng(4)
    u = {k: rng.normal(0, 0.6, np.asarray(s, int)).astype(np.float32)
         for k, s in tinfo.unconstrained_shapes.items()}
    kw, tkw = {}, {}
    if batch:
        idx = rng.integers(0, J * NPG, B)
        kw = {"subsample": {"data__idx": jnp.asarray(idx)}}
        tkw = {"subsample": {"data__idx": torch.as_tensor(idx)}}
    jval, jgrad = jax.value_and_grad(lambda uu: jld(uu, **kw))(
        jax.tree.map(jnp.asarray, u))
    tu = {k: torch.as_tensor(v).requires_grad_(True) for k, v in u.items()}
    tval = tld(tu, **tkw)
    tgrad = torch.autograd.grad(tval, list(tu.values()))
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for k, g in zip(tu, tgrad):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_svi_steps_match_jax():
    """Three steps of the port's generic SVI (mean-field guide, Adam at a
    cosine rate) against the JAX SVI, with the mini-batches and noise the
    JAX steps drew."""
    x, y, group = _data()
    steps = 3
    jsvi = JSVI(jhl.make_model(J, F, B), JMeanFieldGuide,
                optax.adam(optax.cosine_decay_schedule(0.05, steps)),
                model_args=tuple(map(jnp.asarray, (x, y, group))))
    js = jsvi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    p0 = {"loc": rng.normal(0, 0.3, jsvi.guide.dim).astype(np.float32),
          "log_scale": np.full(jsvi.guide.dim, -1.0, np.float32)}
    js = js._replace(params=jax.tree.map(jnp.asarray, p0),
                     opt_state=jsvi.optimizer.init(
                         jax.tree.map(jnp.asarray, p0)))
    tsvi = SVI(thl.make_model(J, F, B), MeanFieldGuide,
               Adam(cosine_decay_schedule(0.05, steps)),
               model_args=_t(x, y, group))
    assert tsvi.device == torch.device("cpu")
    tp = interop.mean_field_params(p0)
    ts = tsvi.init(torch.Generator().manual_seed(0))._replace(
        params=tp, opt_state=tsvi.optimizer.init(tp))
    for i in range(steps):
        _, key_q, key_b = jax.random.split(js.key, 3)
        idx = np.array(j_draw_subsample(jsvi.info, key_b)["data__idx"])
        eps = np.array(jax.random.normal(key_q, (1, jsvi.guide.dim)))
        if i == 0:
            # the step's gradient, by autograd of the port's ELBO
            leaves = {k: v.clone().requires_grad_(True) for k, v in
                      tp.items()}
            elbo = tsvi.elbo(leaves, None, subsample={
                "data__idx": torch.as_tensor(idx)},
                eps=torch.as_tensor(eps))
            tg = torch.autograd.grad(elbo, list(leaves.values()))
            jg = jax.grad(lambda pp: jsvi.elbo(
                pp, key_q, subsample={"data__idx": jnp.asarray(idx)}))(
                js.params)
            for k, g in zip(leaves, tg):
                np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                           rtol=1e-4, atol=1e-4)
        js, jloss = jsvi.step(js)
        ts, tloss = tsvi.step(ts, subsample={
            "data__idx": torch.as_tensor(idx)}, eps=torch.as_tensor(eps))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("loc", "log_scale"):
        np.testing.assert_allclose(ts.params[k].numpy(),
                                   np.asarray(js.params[k]), rtol=1e-4,
                                   atol=1e-5)


# -- device defaults and the entry point -------------------------------------

def test_engines_default_to_cuda_unless_data_is_on_the_cpu():
    assert tdlgm.Config().device == "cuda"
    assert thl.Config().device == "cuda"
    assert default_device(None) == torch.device("cuda")
    assert default_device(None, (3, None), torch.zeros(1)) \
        == torch.device("cpu")
    assert default_device("cpu", torch.zeros(1)) == torch.device("cpu")
    x, y, group = _t(*_data())
    svi = SVI(thl.make_model(J, F, B), MeanFieldGuide, Adam(0.01),
              model_args=(x, y, group))
    mcmc = MCMC(thl.make_model(J, F, None, centered=True), num_chains=2,
                model_args=(x, y, group))
    assert svi.device == mcmc.device == torch.device("cpu")

    def pag(q):
        return 0.5 * torch.sum(q * q, -1), q

    assert MCMC(potential_and_grad=pag, example_q=np.zeros(3)).device \
        == torch.device("cuda")
    assert MCMC(potential_and_grad=pag, example_q=torch.zeros(3)).device \
        == torch.device("cpu")
    assert MCMC(potential_and_grad=pag, example_q=np.zeros(3),
                num_chains=2, init_params=torch.zeros(2, 3)).device \
        == torch.device("cpu")


def test_config_fields_match_jax():
    """The port's Config has the JAX fields and defaults, plus device."""
    jf = {f.name: f.default for f in dataclasses.fields(jhl.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(thl.Config)}
    assert tf.pop("device") == "cuda"
    assert tf == jf


def test_run_svi_bench_prints_a_bench_line(capsys):
    out = thl.run_svi(thl.Config(**CFG, svi_steps=5, bench=True,
                                 device="cpu"))
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "elbo_steps_per_s" and rec["value"] > 0
    assert rec["model"] == "hier_logistic" and rec["device"] == "cpu"
    assert out["losses"].shape == (5,)


def test_run_smoke_prints_cross_check(capsys):
    """``run`` at the smoke config on the CPU: the SVI fit, the NUTS
    cross-check on the centered model and their gap, as the JAX ``main``
    prints them."""
    thl.main(["--smoke", "true", "--device", "cpu"])
    text = capsys.readouterr().out
    assert '"smoke": true' in text
    svi_mu = float(text.split("SVI  mu = ")[1].split()[0])
    nuts_mu = float(text.split("NUTS mu = ")[1].split()[0])
    gap = float(text.split("cross-check gap = ")[1].split()[0])
    assert np.isfinite([svi_mu, nuts_mu, gap]).all()
    np.testing.assert_allclose(gap, abs(svi_mu - nuts_mu), atol=2e-3)
    # 8 groups x 40 rows: both fits see the same data, the gap stays small
    assert gap < 0.5
    rhat = float(text.split("rhat ")[1].split(",")[0])
    assert rhat < 1.1
