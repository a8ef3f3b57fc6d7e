"""The port's DLGM entry points at the smoke config on the CPU, and the
``interop`` conversions against the JAX package's flax modules."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from bayesic_tpu.models import dlgm as jdlgm
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.models import common
from bayesic_tpu_torch.models import dlgm as tdlgm
from bayesic_tpu_torch.ops import fused_vae as tfv
from bayesic_tpu_torch.utils.config import dump_config, parse_config

torch.set_num_threads(2)

# the smoke config of dlgm.run (models/dlgm.py, both packages)
SMOKE = tdlgm.Config(num_data=512, data_dim=8, latent_dim=3, hidden=16,
                     batch_size=64, steps=300, device="cpu")


def _learns(losses):
    losses = np.asarray(losses)
    assert np.isfinite(losses).all()
    assert losses[-20:].mean() < losses[:20].mean()


def test_make_data_matches_jax():
    cfg = tdlgm.Config(num_data=300, data_dim=5, latent_dim=2, hidden=7)
    want = np.asarray(jdlgm.make_data(jdlgm.Config(
        num_data=300, data_dim=5, latent_dim=2, hidden=7)))
    got = tdlgm.make_data(cfg)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_run_svi_smoke_learns():
    out = tdlgm.run_svi(SMOKE)
    assert out["losses"].shape == (SMOKE.steps,)
    _learns(out["losses"])
    assert 0.0 < out["sigma_x"] < 5.0
    assert out["final_elbo"] == -float(out["losses"][-1])


def test_run_svi_fused_smoke_learns():
    before = tfv.LAUNCHES
    out = tdlgm.run_svi_fused(SMOKE)
    assert out["losses"].shape == (SMOKE.steps,)
    _learns(out["losses"])
    assert 0.0 < out["sigma_x"] < 5.0
    z = torch.randn(5, SMOKE.latent_dim)
    p = out["params"]
    want = torch.tanh(z @ p["w1d"] + p["b1d"]) @ p["w2d"] + p["b2d"]
    dec = tdlgm.Decoder(SMOKE.latent_dim, SMOKE.hidden, SMOKE.data_dim)
    got = functional_call(dec, out["decoder_params"], (z,))
    torch.testing.assert_close(got, want)
    assert tfv.LAUNCHES == before       # CPU tensors never launch


def test_main_smoke_prints_results(capsys):
    tdlgm.main(["--smoke", "true", "--steps", "50", "--device", "cpu"])
    text = capsys.readouterr().out
    assert '"smoke": true' in text
    for key in ("final ELBO", "sigma_x", "recon RMSE", "NUTS z-posterior"):
        assert key in text
    rmse = float(text.split("recon RMSE = ")[1].split()[0])
    assert np.isfinite(rmse)
    min_ess = float(text.split("min ESS = ")[1].split(",")[0])
    assert np.isfinite(min_ess) and min_ess > 0


def test_fused_init_matches_jax_recipe():
    """Same distributions as the JAX fused_init: truncated-normal kernels
    over sqrt(fan_in), zero biases, sigma_x = 0.5."""
    cfg = dataclasses.replace(SMOKE, data_dim=256, hidden=256)
    p, m, v = tdlgm.fused_init(cfg, torch.Generator().manual_seed(0))
    jp, _, _ = jdlgm.fused_init(jdlgm.Config(
        num_data=cfg.num_data, data_dim=256, latent_dim=cfg.latent_dim,
        hidden=256, batch_size=cfg.batch_size), jax.random.PRNGKey(0))
    for k in tfv.LEAVES:
        assert tuple(p[k].shape) == tuple(jp[k].shape)
        assert float(m[k].abs().sum()) == 0 and float(v[k].abs().sum()) == 0
    np.testing.assert_allclose(float(p["w1e"].std()),
                               float(jnp.std(jp["w1e"])), rtol=0.05)
    assert float(p["w1e"].abs().max()) <= 2.0 / 16 + 1e-6
    assert float(p["b1e"].abs().sum()) == 0
    np.testing.assert_allclose(float(torch.exp(p["usig"])), 0.5, rtol=1e-6)


def test_module_init_is_lecun_normal():
    g = torch.Generator().manual_seed(0)
    enc = tdlgm.Encoder(400, 300, 200, g)
    w = enc.Dense_0.weight.detach()
    assert tuple(w.shape) == (300, 400)
    np.testing.assert_allclose(float(w.std()), 1 / np.sqrt(400), rtol=0.02)
    assert float(enc.Dense_1.bias.detach().abs().sum()) == 0


def _jax_modules(cfg):
    dec = jdlgm.Decoder(cfg.data_dim, cfg.hidden)
    enc = jdlgm.Encoder(cfg.latent_dim, cfg.hidden)
    dp = dec.init(jax.random.PRNGKey(1), jnp.zeros((1, cfg.latent_dim)))
    ep = enc.init(jax.random.PRNGKey(2), jnp.zeros((1, cfg.data_dim)))
    return dec, enc, jax.tree.map(np.asarray, dp), jax.tree.map(np.asarray,
                                                                 ep)


def test_interop_modules_match_flax():
    dec, enc, dp, ep = _jax_modules(SMOKE)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(6, SMOKE.latent_dim)).astype(np.float32)
    x = rng.normal(size=(6, SMOKE.data_dim)).astype(np.float32)
    tdec = tdlgm.Decoder(SMOKE.latent_dim, SMOKE.hidden, SMOKE.data_dim)
    tenc = tdlgm.Encoder(SMOKE.data_dim, SMOKE.hidden, SMOKE.latent_dim)
    got = functional_call(tdec, interop.flax_to_state_dict(dp),
                          (torch.as_tensor(z),))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(dec.apply(dp, jnp.asarray(z))),
                               rtol=1e-5, atol=1e-6)
    mu, ls = functional_call(tenc, interop.flax_to_state_dict(ep),
                             (torch.as_tensor(x),))
    jmu, jls = enc.apply(ep, jnp.asarray(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ls.numpy(), np.asarray(jls), rtol=1e-5,
                               atol=1e-6)


def test_interop_round_trip_and_svi_tree():
    _, _, dp, ep = _jax_modules(SMOKE)
    back = interop.state_dict_to_flax(interop.flax_to_state_dict(dp))
    for layer, leaves in dp["params"].items():
        for k, a in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][k], a)
    tree = {"guide": ep, "model": {"decoder": dp, "sigma_x": np.float32(
        -0.3)}}
    out = interop.svi_params(tree)
    assert tuple(out["guide"]["Dense_0.weight"].shape) == (
        SMOKE.hidden, SMOKE.data_dim)
    assert float(out["model"]["sigma_x"]) == pytest.approx(-0.3)
    st = interop.adam_state(3, tree, tree)
    assert st.count == 3 and set(st.mu) == {"guide", "model"}
    leaves = {k: np.ones((2, 3), np.float32) for k in tfv.LEAVES}
    fl = interop.fused_leaves(leaves)
    assert set(fl) == set(tfv.LEAVES) and fl["w1e"].dtype == torch.float32


def test_config_and_bench_helpers(capsys):
    cfg = parse_config(tdlgm.Config, ["--steps", "7", "--bench", "yes",
                                      "--lr", "0.5"])
    assert cfg.steps == 7 and cfg.bench is True and cfg.lr == 0.5
    assert '"steps": 7' in dump_config(cfg)
    calls = []
    res, dt = common.timed_steps(lambda a: calls.append(a) or a, 3,
                                 warmup_runs=2, timed_runs=3)
    assert res == 3 and len(calls) == 5 and dt >= 0
    rec = common.bench_line("m", 2, "u", model="dlgm")
    assert rec["value"] == 2.0 and rec["model"] == "dlgm"
    assert '"metric": "m"' in capsys.readouterr().out
