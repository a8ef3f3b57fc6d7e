"""Parity of the port's linear-regression path with the JAX package's:
``LowerCholeskyTransform``, ``FullRankGuide``, the fused trainer's step
math against autograd of the port's DSL model, and the entry points
against the analytic posterior.

Inputs are made with numpy (the JAX guide's noise with
``jax.random.normal``, injected into the port's guide through
``ctx["eps"]``) and go to both packages.  Tolerances: transforms and
guides rtol 1e-5 (float32 on both sides); the hand-derived step against
autograd elbo rtol 2e-5, gradients rtol 2e-4 / atol 2e-3 (the JAX test's
own); the entry points' posterior means within 0.02 of the analytic mean
(the JAX selftest's limit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.core.logjoint import build_logjoint as j_build
from bayesic_tpu.dist.transforms import LowerCholeskyTransform as JLC
from bayesic_tpu.infer.svi import FullRankGuide as JFullRank
from bayesic_tpu.models import linreg as jlr
from bayesic_tpu_torch.dist import constraints
from bayesic_tpu_torch.dist.transforms import LowerCholeskyTransform, biject_to
from bayesic_tpu_torch.infer.svi import (SVI, Adam, FullRankGuide,
                                         MeanFieldGuide)
from bayesic_tpu_torch.models import linreg as tlr
from bayesic_tpu_torch.ops import fused_linreg as tfl

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_lower_cholesky_transform_matches_jax():
    u = RNG.normal(size=(3, 10)).astype(np.float32)
    t, j = LowerCholeskyTransform(), JLC()
    mat = t.forward(torch.as_tensor(u))
    _close(mat, j.forward(jnp.asarray(u)))
    assert t.forward_shape((3, 10)) == (3, 4, 4)
    assert t.inverse_shape((3, 4, 4)) == (3, 10)
    _close(t.inverse(mat), u)
    _close(t.log_det_jacobian(torch.as_tensor(u)),
           j.log_det_jacobian(jnp.asarray(u)))
    assert bool(constraints.lower_cholesky(mat).all())
    assert isinstance(biject_to(constraints.lower_cholesky),
                      LowerCholeskyTransform)
    with pytest.raises(ValueError, match="triangular"):
        t.forward(torch.zeros(7))


@pytest.mark.parametrize("stl", [False, True])
def test_full_rank_guide_matches_jax(stl):
    """Draws and log q of both guides on the same params and noise; the
    port's gradients of log q against ``jax.grad`` of the JAX guide's."""
    cfg = tlr.Config(n=64, dim=3, device="cpu")
    x, y, _, _ = tlr.make_data(cfg)
    info_j = j_build(jlr.model, jnp.asarray(x), jnp.asarray(y),
                     cfg.noise)[0]
    svi = SVI(tlr.model, FullRankGuide, Adam(0.1),
              model_args=(torch.as_tensor(x), torch.as_tensor(y), cfg.noise))
    jg, tg = JFullRank(info_j), svi.guide
    assert tg.dim == jg.dim == 4
    init = tg.init(torch.Generator())
    _close(init["scale_tril_vec"],
           jg.init(jax.random.PRNGKey(0))["scale_tril_vec"])
    params = {"loc": RNG.normal(size=4).astype(np.float32),
              "scale_tril_vec": RNG.normal(-1.0, 0.3, 10).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, (5, 4), jnp.float32))

    def jlogq(p):
        return jg.sample_and_log_prob(p, key, (5,), stop_gradient_q=stl)

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    ju, jlq = jlogq(jparams)
    jgrad = jax.grad(lambda p: jnp.sum(jlogq(p)[1]))(jparams)
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    tu, tlq = tg.sample_and_log_prob(tparams, None, (5,), stop_gradient_q=stl,
                                     ctx={"eps": torch.as_tensor(eps)})
    for site in ("w", "b"):
        _close(tu[site].detach(), ju[site])
    _close(tlq.detach(), jlq)
    tgrad = torch.autograd.grad(tlq.sum(), list(tparams.values()))
    for got, k in zip(tgrad, tparams):
        _close(got, jgrad[k], rtol=1e-4, atol=1e-5)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    _close(tg.entropy(tp), jg.entropy(jparams))
    _close(tg.covariance(tp), jg.covariance(jparams))
    for got, want in zip(tg.stats(tp), jg.stats(jparams)):
        for site in ("w", "b"):
            _close(got[site], want[site])


def test_step_math_matches_dsl_autograd():
    """The fused trainer's hand-derived step against autograd of the port's
    generic pipeline: the DSL model under the ``MeanFieldGuide`` STL ELBO
    with the same noise (the JAX ``test_fused_linreg`` check)."""
    cfg = tlr.Config(n=512, dim=16, device="cpu")
    x, y, _, _ = (torch.as_tensor(a) for a in tlr.make_data(cfg))
    svi = SVI(tlr.model, MeanFieldGuide, Adam(0.01),
              model_args=(x, y, cfg.noise))
    assert svi.guide.dim == cfg.dim + 1
    loc = torch.as_tensor(RNG.normal(0, 0.5, 17).astype(np.float32))
    ls = torch.as_tensor(RNG.normal(-2, 0.3, 17).astype(np.float32))
    eps = torch.as_tensor(RNG.normal(0, 1, 17).astype(np.float32))
    params = {"loc": loc.clone().requires_grad_(True),
              "log_scale": ls.clone().requires_grad_(True)}
    elbo = svi.elbo(params, None, eps=eps[None])
    g_loc, g_ls = torch.autograd.grad(elbo, [params["loc"],
                                             params["log_scale"]])
    want = tfl._step_math(loc, ls, tfl.gram(x, y), cfg.n, eps, cfg.noise)
    _close(float(want[0]), float(elbo.detach()), rtol=2e-5)
    _close(want[1], g_loc, rtol=2e-4, atol=2e-3)
    _close(want[2], g_ls, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("guide", ["meanfield", "fullrank"])
def test_run_smoke_against_analytic(guide):
    out = tlr.run(tlr.Config(smoke=True, guide=guide, device="cpu"))
    assert out["max_abs_err"] < 0.02
    assert out["losses"][-20:].mean() < out["losses"][:20].mean()
    assert np.isfinite(out["final_elbo"])


def test_run_svi_fused_against_analytic():
    """The JAX ``test_reference_train_matches_analytic_posterior`` on the
    port's fused entry point (the plain trainer on the CPU)."""
    cfg = tlr.Config(n=2048, dim=16, steps=2500, device="cpu")
    out = tlr.run_svi_fused(cfg)
    assert out["losses"][-1] < out["losses"][0]
    np.testing.assert_allclose(out["posterior_mean"], out["analytic_mean"],
                               atol=0.02)
    np.testing.assert_allclose(out["posterior_sd"],
                               np.sqrt(np.diag(out["analytic_cov"])),
                               rtol=0.3, atol=0.01)


def test_make_data_matches_jax():
    cfg = tlr.Config(n=100, dim=5)
    for a, b in zip(tlr.make_data(cfg), jlr.make_data(jlr.Config(n=100,
                                                                  dim=5))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x, y, _, _ = tlr.make_data(cfg)
    for a, b in zip(tlr.analytic_posterior(torch.as_tensor(x), y, 0.5),
                    jlr.analytic_posterior(x, y, 0.5)):
        _close(a, b, rtol=1e-10)
