"""Parity of the port's ``core`` (primitives, handlers, ``build_logjoint``)
with ``bayesic_tpu.core`` on the DLGM model: log-density value (rtol 1e-5)
and its gradient with respect to z, the decoder parameters and the
unconstrained sigma_x (rtol 1e-4, atol 1e-5), at fixed parameters and a
fixed ``data__idx``, all from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.core import build_logjoint as j_build_logjoint
from bayesic_tpu.models import dlgm as jdlgm
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.core import (build_logjoint, handlers,
                                    inspect_model, param, plate, sample)
from bayesic_tpu_torch.core.primitives import HANDLER_STACK
from bayesic_tpu_torch.models import dlgm as tdlgm

torch.set_num_threads(2)

CFG = dict(num_data=200, data_dim=12, latent_dim=4, hidden=16,
           batch_size=32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jcfg, tcfg = jdlgm.Config(**CFG), tdlgm.Config(**CFG)
    x = tdlgm.make_data(tcfg)
    jmodel, _, _, _ = jdlgm.make_model_and_guide(jcfg, jnp.asarray(x))
    jinfo, jld, _, _ = j_build_logjoint(jmodel, jnp.asarray(x))
    dec = jax.tree.map(np.asarray, jinfo.param_init["decoder"])
    # perturb the biases off zero so their gradients are exercised
    dec = jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        dec)
    z = rng.normal(size=(CFG["batch_size"], CFG["latent_dim"])) \
        .astype(np.float32)
    idx = rng.integers(0, CFG["num_data"], CFG["batch_size"])
    usig = np.float32(np.log(0.7))
    tx = torch.as_tensor(x)
    tmodel, _, _, _ = tdlgm.make_model_and_guide(tcfg, tx)
    tinfo, tld, tconstrain, tpost = build_logjoint(tmodel, tx)
    return dict(x=x, jinfo=jinfo, jld=jld, tinfo=tinfo, tld=tld,
                tconstrain=tconstrain, tpost=tpost, dec=dec, z=z, idx=idx,
                usig=usig)


def _jax_value_and_grad(s):
    def f(z, dec, u):
        return s["jld"]({"z": z}, subsample={"data__idx": jnp.asarray(
            s["idx"])}, params={"decoder": dec, "sigma_x": u})
    dec = jax.tree.map(jnp.asarray, s["dec"])
    val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(s["z"]), dec, jnp.asarray(s["usig"]))
    return float(val), jax.tree.map(np.asarray, grads)


def _torch_value_and_grad(s):
    z = torch.as_tensor(s["z"]).requires_grad_(True)
    dec = {k: v.requires_grad_(True)
           for k, v in interop.flax_to_state_dict(s["dec"]).items()}
    u = torch.as_tensor(s["usig"]).requires_grad_(True)
    val = s["tld"]({"z": z}, subsample={"data__idx": torch.as_tensor(
        s["idx"])}, params={"decoder": dec, "sigma_x": u})
    leaves = [z, *dec.values(), u]
    grads = torch.autograd.grad(val, leaves)
    gdec = dict(zip(dec, grads[1:-1]))
    return float(val.detach()), (grads[0].numpy(),
                                 interop.state_dict_to_flax(gdec),
                                 grads[-1].numpy())


def test_model_info_matches_jax(setup):
    ji, ti = setup["jinfo"], setup["tinfo"]
    assert ti.latent_names == ji.latent_names == ("z",)
    assert ti.observed_names == ji.observed_names
    assert ti.param_names == ji.param_names
    assert ti.subsample_sites == ji.subsample_sites
    assert ti.site_shapes == {k: tuple(v) for k, v in ji.site_shapes.items()}
    assert ti.unconstrained_dim == ji.unconstrained_dim
    np.testing.assert_allclose(float(ti.param_init["sigma_x"]),
                               float(ji.param_init["sigma_x"]), rtol=1e-6)


def test_logdensity_value_matches_jax(setup):
    jv, _ = _jax_value_and_grad(setup)
    tv, _ = _torch_value_and_grad(setup)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)


def test_logdensity_grads_match_jax(setup):
    _, (gz, gdec, gu) = _jax_value_and_grad(setup)
    _, (tz, tdec, tu) = _torch_value_and_grad(setup)
    np.testing.assert_allclose(tz, gz, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tu, gu, rtol=1e-4, atol=1e-5)
    for layer, leaves in gdec["params"].items():
        for k, want in leaves.items():
            np.testing.assert_allclose(
                tdec["params"][layer][k], want, rtol=1e-4, atol=1e-5,
                err_msg=f"{layer}.{k}")


def test_constrain_postprocess_and_default_subsample(setup):
    z = torch.as_tensor(setup["z"])
    assert setup["tconstrain"]({"z": z})["z"] is z
    out = setup["tpost"]({"z": z})
    torch.testing.assert_close(out["z"], z)
    # without a forced subsample a replay draws one fixed mini-batch
    v1 = setup["tld"]({"z": z})
    v2 = setup["tld"]({"z": z})
    assert float(v1) == float(v2)


def _toy(y=None):
    mu = sample("mu", tdist.Normal(0.0, 1.0))
    s = param("s", torch.tensor(2.0), constraint=tdist.constraints.positive)
    with plate("data", 10, subsample_size=4) as idx:
        sample("obs", tdist.Normal(mu, s).expand((4,)).to_event(1),
               obs=None if y is None else y[idx])
    return mu


def test_handlers_seed_trace_substitute_condition():
    g = torch.Generator().manual_seed(0)
    tr = handlers.trace(handlers.seed(_toy, rng_key=g)).get_trace()
    assert list(tr) == ["mu", "s", "data__idx", "obs"]
    assert tr["obs"]["scale"] == 10 / 4 and tr["mu"]["scale"] == 1.0
    assert tuple(tr["data__idx"]["value"].shape) == (4,)
    assert int(tr["data__idx"]["value"].max()) < 10
    assert not tr["obs"]["is_observed"]
    tr2 = handlers.trace(handlers.substitute(
        handlers.seed(_toy, rng_key=g), data={"mu": torch.tensor(3.0)})
    ).get_trace()
    assert float(tr2["mu"]["value"]) == 3.0
    obs = torch.ones(4)
    tr3 = handlers.trace(handlers.condition(
        handlers.seed(_toy, rng_key=g), data={"obs": obs})).get_trace()
    assert tr3["obs"]["is_observed"] and tr3["obs"]["value"] is obs
    assert not HANDLER_STACK


def test_handlers_scale_block_mask_and_errors():
    g = torch.Generator().manual_seed(1)
    tr = handlers.trace(handlers.scale(handlers.seed(_toy, rng_key=g),
                                       factor=0.5)).get_trace()
    assert tr["mu"]["scale"] == 0.5 and tr["obs"]["scale"] == 0.5 * 2.5
    tr = handlers.trace(handlers.block(handlers.seed(_toy, rng_key=g),
                                       hide=["mu"])).get_trace()
    assert "mu" not in tr and "obs" in tr
    m = torch.tensor([True, False, True, True])
    tr = handlers.trace(handlers.mask(handlers.seed(_toy, rng_key=g),
                                      mask=m)).get_trace()
    assert tr["obs"]["mask"] is m
    with pytest.raises(RuntimeError, match="no value and no generator"):
        handlers.trace(_toy).get_trace()
    with pytest.raises(RuntimeError, match="outside any handler"):
        sample("x", tdist.Normal())
    with pytest.raises(TypeError):
        handlers.trace(lambda: sample("x", 1.0)).get_trace()
    with pytest.raises(ValueError, match="duplicate"):
        handlers.trace(handlers.seed(
            lambda: (sample("a", tdist.Normal()), sample("a", tdist.Normal())),
            rng_key=g)).get_trace()
    assert not HANDLER_STACK


def test_toy_logjoint_mask_jacobian_and_scale():
    """Hand-computed log-joint of the toy model: Jacobian of the positive
    param is not added (params are not latents), the plate scales by N/B,
    and a mask zeroes excluded terms."""
    y = torch.linspace(-1.0, 1.0, 10)
    info = inspect_model(_toy, y)
    assert info.param_names == ("s",) and info.latent_names == ("mu",)
    _, ld, _, _ = build_logjoint(_toy, y)
    idx = torch.tensor([0, 3, 5, 9])
    mu, us = torch.tensor(0.3), torch.tensor(0.2)
    got = ld({"mu": mu}, subsample={"data__idx": idx},
             params={"s": us})
    n = torch.distributions.Normal
    want = n(0.0, 1.0).log_prob(mu) + 2.5 * n(mu, torch.exp(us)) \
        .log_prob(y[idx]).sum()
    torch.testing.assert_close(got, want)

    def masked():
        mu = sample("mu", tdist.Normal(0.0, 1.0))
        s = param("s", torch.tensor(2.0),
                  constraint=tdist.constraints.positive)
        with plate("data", 10, subsample_size=4) as idx:
            with handlers.mask(mask=torch.tensor([True, False, True,
                                                  False])):
                sample("obs", tdist.Normal(mu, s).expand((4,)), obs=y[idx])
    _, ldm, _, _ = build_logjoint(masked)
    got = ldm({"mu": mu}, subsample={"data__idx": idx}, params={"s": us})
    lp = n(mu, torch.exp(us)).log_prob(y[idx])
    want = n(0.0, 1.0).log_prob(mu) + 2.5 * (lp[0] + lp[2])
    torch.testing.assert_close(got, want)
