"""The port's generic SVI engine (``SVI`` + the DLGM ``NeuralGuide`` of
``models/dlgm.py`` through ``build_logjoint``, STL ELBO, ``Adam``) and the
fused trainer's plain math are one estimator: from the same converted init
and the same injected index/noise streams, 5 steps of the engine match the
port's ``reference_train`` and the JAX ``reference_train`` (losses rtol
1e-4; params rtol 1e-4, atol 1e-5).  Also: the port's ``Adam`` against
``optax.adam`` on the same gradients, and the ELBO estimator on a
conjugate model."""

import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.ops import fused_vae as jfv
from bayesic_tpu_torch.core import build_logjoint, plate, sample
from bayesic_tpu_torch.infer.svi import (SVI, Adam, NeuralGuide,
                                         draw_subsample, make_elbo)
from bayesic_tpu_torch.models import dlgm as tdlgm
from bayesic_tpu_torch.ops import fused_vae as tfv

torch.set_num_threads(2)

CFG = tdlgm.Config(num_data=200, data_dim=12, latent_dim=4, hidden=16,
                   batch_size=32, lr=1e-2)
STEPS = 5


def _leaves(seed):
    rng = np.random.default_rng(seed)
    shapes = tfv.leaf_shapes(tfv.FusedVAEDims(
        CFG.num_data, CFG.data_dim, CFG.hidden, CFG.latent_dim,
        CFG.batch_size))
    out = {}
    for k in tfv.LEAVES:
        s = shapes[k]
        out[k] = ((rng.normal(size=s) / np.sqrt(s[0])) if k.startswith("w")
                  else np.zeros(s)).astype(np.float32)
    return out


def _svi_params(lv):
    """Fused leaves (in, out) -> the generic engine's params (nn.Linear)."""
    t = {k: torch.as_tensor(a) for k, a in lv.items()}
    guide = {}
    for i, (w, b) in enumerate((("w1e", "b1e"), ("wmu", "bmu"),
                                ("wsig", "bsig"))):
        guide[f"Dense_{i}.weight"] = t[w].T.contiguous()
        guide[f"Dense_{i}.bias"] = t[b][0]
    return {"guide": guide,
            "model": {"decoder": tdlgm.fused_to_torch(t),
                      "sigma_x": t["usig"][0, 0]}}


@pytest.fixture(scope="module")
def runs():
    lv = _leaves(0)
    x = tdlgm.make_data(CFG)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, CFG.num_data, (STEPS, CFG.batch_size))
    eps = rng.normal(size=(STEPS, CFG.batch_size, CFG.latent_dim)) \
        .astype(np.float32)
    tx = torch.as_tensor(x)
    # the DLGM model and guide as shipped; the guide reads its noise from
    # ``eps`` and the model its mini-batch from ``subsample``
    model, guide, _, _ = tdlgm.make_model_and_guide(CFG, tx)
    params = _svi_params(lv)
    svi = SVI(model, guide, Adam(CFG.lr), model_args=(tx,))
    state = svi.init(torch.Generator().manual_seed(0))._replace(
        params=params, opt_state=svi.optimizer.init(params))
    losses = []
    for i in range(STEPS):
        state, loss = svi.step(
            state, subsample={"data__idx": torch.as_tensor(idx[i])},
            eps=torch.as_tensor(eps[i]))
        losses.append(float(loss))
    zeros = {k: np.zeros_like(a) for k, a in lv.items()}
    tref = tfv.reference_train(
        tx, {k: torch.as_tensor(a) for k, a in lv.items()},
        {k: torch.as_tensor(a) for k, a in zeros.items()},
        {k: torch.as_tensor(a) for k, a in zeros.items()},
        idx_stream=torch.as_tensor(idx), eps_stream=torch.as_tensor(eps),
        lr=CFG.lr)
    jref = jfv.reference_train(
        jnp.asarray(x), {k: jnp.asarray(a) for k, a in lv.items()},
        {k: jnp.asarray(a) for k, a in zeros.items()},
        {k: jnp.asarray(a) for k, a in zeros.items()},
        idx_stream=jnp.asarray(idx), eps_stream=jnp.asarray(eps), lr=CFG.lr)
    return dict(svi=svi, state=state, losses=np.asarray(losses),
                tref=tref, jref=jref)


def _generic_as_leaves(state):
    g, m = state.params["guide"], state.params["model"]
    out = {}
    for i, (w, b) in enumerate((("w1e", "b1e"), ("wmu", "bmu"),
                                ("wsig", "bsig"))):
        out[w] = g[f"Dense_{i}.weight"].T
        out[b] = g[f"Dense_{i}.bias"][None]
    d = m["decoder"]
    out["w1d"], out["b1d"] = d["Dense_0.weight"].T, d["Dense_0.bias"][None]
    out["w2d"], out["b2d"] = d["Dense_1.weight"].T, d["Dense_1.bias"][None]
    out["usig"] = m["sigma_x"].reshape(1, 1)
    return {k: v.detach().numpy() for k, v in out.items()}


@pytest.mark.parametrize("ref", ["port_reference_train",
                                 "jax_reference_train"])
def test_generic_engine_matches_fused_math(runs, ref):
    want = runs["tref"] if ref.startswith("port") else runs["jref"]
    np.testing.assert_allclose(runs["losses"], np.asarray(want[3]),
                               rtol=1e-4)
    got = _generic_as_leaves(runs["state"])
    for k in tfv.LEAVES:
        np.testing.assert_allclose(got[k], np.asarray(want[0][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_model_params_and_guide_params(runs):
    svi, state = runs["svi"], runs["state"]
    mp = svi.model_params(state.params)
    assert set(mp) == {"decoder", "sigma_x"}
    np.testing.assert_allclose(
        float(mp["sigma_x"]),
        math.exp(float(state.params["model"]["sigma_x"])), rtol=1e-6)
    assert svi.guide_params(state.params) is state.params["guide"]
    assert state.step == STEPS and state.opt_state.count == STEPS


def test_adam_matches_optax():
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(3, 4)), "b": {"c": rng.normal(size=5)}}
    params = {"a": params["a"].astype(np.float32),
              "b": {"c": params["b"]["c"].astype(np.float32)}}
    grads = [{"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": {"c": rng.normal(size=5).astype(np.float32)}}
             for _ in range(4)]
    lr = 3e-3
    opt = optax.adam(lr)
    jp = {"a": jnp.asarray(params["a"]), "b": {"c": jnp.asarray(
        params["b"]["c"])}}
    st = opt.init(jp)
    tp = {"a": torch.as_tensor(params["a"]),
          "b": {"c": torch.as_tensor(params["b"]["c"])}}
    adam = Adam(lr)
    ts = adam.init(tp)
    for g in grads:
        jg = {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"])}}
        u, st = opt.update(jg, st, jp)
        jp = optax.apply_updates(jp, u)
        tg = {"a": torch.as_tensor(g["a"]),
              "b": {"c": torch.as_tensor(g["b"]["c"])}}
        tp, ts = adam.update(tg, ts, tp)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp["b"]["c"].numpy(),
                               np.asarray(jp["b"]["c"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ts.nu["a"].numpy(),
                               np.asarray(st[0].nu["a"]), rtol=1e-5)


def _conjugate(y):
    mu = sample("mu", tdist.Normal(0.0, 1.0))
    sample("y", tdist.Normal(mu, 1.0), obs=y)


def _exact_guide():
    """q = the exact posterior N(y/2, 1/2) of ``_conjugate``."""
    def sample_fn(params, g, sample_shape, stop_gradient_q, ctx):
        loc, ls = params["loc"], params["log_scale"]
        eps = torch.randn(tuple(sample_shape), generator=g)
        z = loc + torch.exp(ls) * eps
        lq, sq = (loc.detach(), ls.detach()) if stop_gradient_q \
            else (loc, ls)
        zz = (z - lq) * torch.exp(-sq)
        return {"mu": z}, -0.5 * zz * zz - sq - 0.5 * math.log(2 * math.pi)
    return NeuralGuide(lambda g: {"loc": torch.tensor(0.5),
                                  "log_scale": torch.tensor(
                                      0.5 * math.log(0.5))}, sample_fn)


@pytest.mark.parametrize("num_particles", [1, 4])
def test_elbo_is_log_evidence_at_exact_posterior(num_particles):
    """With q the exact posterior, log p - log q is the log evidence for
    every draw, and the STL gradient with respect to q's parameters is
    zero."""
    y = torch.tensor(1.0)
    _, ld, _, _ = build_logjoint(_conjugate, y)
    guide = _exact_guide()
    elbo = make_elbo(ld, guide, num_particles=num_particles)
    params = {k: v.requires_grad_(True)
              for k, v in guide.init(None).items()}
    val = elbo(params, torch.Generator().manual_seed(3))
    want = -0.5 * math.log(2 * math.pi * 2.0) - 0.25
    np.testing.assert_allclose(float(val.detach()), want, rtol=1e-5)
    grads = torch.autograd.grad(val, list(params.values()))
    for g in grads:
        assert abs(float(g)) < 1e-5


def test_draw_subsample_and_svi_run_on_generator():
    def model(x):
        mu = sample("mu", tdist.Normal(0.0, 1.0))
        with plate("data", 50, subsample_size=8) as idx:
            sample("obs", tdist.Normal(mu, 1.0).expand((8,)).to_event(1),
                   obs=x[idx])
        with plate("other", 20, subsample_size=20, replacement=False):
            pass

    x = torch.linspace(0.0, 2.0, 50)
    info, _, _, _ = build_logjoint(model, x)
    assert info.subsample_sites == {"data__idx": (50, 8, True)}
    sub = draw_subsample(info, torch.Generator().manual_seed(0))
    assert tuple(sub["data__idx"].shape) == (8,)

    def guide_sample(params, g, shape, stop_q, ctx):
        eps = torch.randn(tuple(shape), generator=g)
        z = params["loc"] + torch.exp(params["ls"]) * eps
        lq, sq = params["loc"].detach(), params["ls"].detach()
        zz = (z - lq) * torch.exp(-sq)
        return {"mu": z}, -0.5 * zz * zz - sq - 0.5 * math.log(2 * math.pi)

    guide = NeuralGuide(lambda g: {"loc": torch.tensor(0.0),
                                   "ls": torch.tensor(0.0)}, guide_sample)
    svi = SVI(model, guide, Adam(0.05), model_args=(x,))
    res = svi.run(torch.Generator().manual_seed(1), 300)
    assert res.losses.shape == (300,)
    # posterior mean of mu: sum(x) / (1 + n) with n = 50
    np.testing.assert_allclose(float(res.params["loc"]),
                               float(x.sum()) / 51, atol=0.1)
