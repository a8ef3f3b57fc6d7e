"""The DLGM's bf16 compute mode in the port (``Config.compute_dtype``,
``Decoder``/``Encoder(dtype=)``) against the JAX package's flax modules
(``Dense(dtype=jnp.bfloat16)``) on carried parameters, and the generic
``run_svi`` in that mode at the smoke size.

Flax's ``Dense`` rounds the product to bf16 and adds the bias in bf16;
PyTorch's bf16 ``linear`` may round once after the bias, so an output can
sit one bf16 ulp (2^-8 relative) away: outputs at rtol 2^-6 / atol 2^-7
of the output's scale, and the float32 mode's outputs differ from the
bf16 ones by more than that somewhere."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from bayesic_tpu.models import dlgm as jdlgm
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.models import dlgm as tdlgm

torch.set_num_threads(2)

SMOKE = tdlgm.Config(num_data=512, data_dim=8, latent_dim=3, hidden=16,
                     batch_size=64, steps=300, device="cpu")
RTOL, ATOL = 2.0 ** -6, 2.0 ** -7


def _flax(cfg, dtype):
    dec = jdlgm.Decoder(cfg.data_dim, cfg.hidden, dtype=dtype)
    enc = jdlgm.Encoder(cfg.latent_dim, cfg.hidden, dtype=dtype)
    dp = dec.init(jax.random.PRNGKey(1), jnp.zeros((1, cfg.latent_dim)))
    ep = enc.init(jax.random.PRNGKey(2), jnp.zeros((1, cfg.data_dim)))
    return dec, enc, jax.tree.map(np.asarray, dp), jax.tree.map(np.asarray,
                                                                 ep)


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_bf16_modules_match_flax():
    dec, enc, dp, ep = _flax(SMOKE, jnp.bfloat16)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(64, SMOKE.latent_dim)).astype(np.float32)
    x = rng.normal(size=(64, SMOKE.data_dim)).astype(np.float32)
    tdec = tdlgm.Decoder(SMOKE.latent_dim, SMOKE.hidden, SMOKE.data_dim,
                         dtype=torch.bfloat16)
    tenc = tdlgm.Encoder(SMOKE.data_dim, SMOKE.hidden, SMOKE.latent_dim,
                         dtype=torch.bfloat16)
    dsd, esd = interop.flax_to_state_dict(dp), interop.flax_to_state_dict(ep)
    got = functional_call(tdec, dsd, (torch.as_tensor(z),))
    want = dec.apply(dp, jnp.asarray(z))
    _close(got, want)
    mu, ls = functional_call(tenc, esd, (torch.as_tensor(x),))
    jmu, jls = enc.apply(ep, jnp.asarray(x))
    _close(mu, jmu)
    _close(ls, jls)
    # the parameters stay float32; the float32 mode is another function
    assert all(p.dtype == torch.float32 for p in tdec.parameters())
    f32 = functional_call(tdlgm.Decoder(SMOKE.latent_dim, SMOKE.hidden,
                                        SMOKE.data_dim), dsd,
                          (torch.as_tensor(z),))
    assert float((f32 - got).abs().max()) > 1e-3
    # gradients reach the float32 parameters through the casts
    w = dsd["Dense_0.weight"].clone().requires_grad_(True)
    out = functional_call(tdec, {**dsd, "Dense_0.weight": w},
                          (torch.as_tensor(z),))
    (g,) = torch.autograd.grad(out.sum(), w)
    assert g.dtype == torch.float32 and float(g.abs().max()) > 0


def test_run_svi_bf16_learns_and_rejects_other_modes():
    cfg = dataclasses.replace(SMOKE, compute_dtype="bfloat16")
    out = tdlgm.run_svi(cfg)
    losses = np.asarray(out["losses"])
    assert np.isfinite(losses).all() and np.isfinite(out["sigma_x"])
    assert losses[-20:].mean() < losses[:20].mean()
    assert out["decoder"].dtype == torch.bfloat16
    f32 = tdlgm.run_svi(dataclasses.replace(SMOKE, steps=20))
    assert f32["decoder"].dtype == torch.float32
    assert abs(losses[:20].mean() / f32["losses"].mean() - 1.0) < 0.05
    with pytest.raises(ValueError, match="compute_dtype"):
        tdlgm.run_svi(dataclasses.replace(SMOKE, compute_dtype="float16"))
