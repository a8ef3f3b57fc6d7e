"""Example 6 — Gaussian-process regression.

Counterpart of ``bayesic_tpu/models/gp.py``.  The latent function rides a
whitened parameterization (f = L z, z ~ N(0, I), L = chol(K)), which is
what ``infer.mcmc.EllipticalSlice`` requires and what NUTS mixes best on;
with Gaussian noise the posterior is analytic (``analytic_posterior``),
the oracle for both samplers, and ``log_marginal`` is the exact marginal
likelihood through ``dist.MultivariateNormal``.

The kernel matrix and its Cholesky are made once (in float64, see
``chol_K``); every ESS or NUTS step is then one (n, n) x (n,) product per
chain.

Run: ``python -m bayesic_tpu_torch.models.gp --smoke true`` (on the card;
add ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dist
from ..core import sample
from ..dist._special import cholesky
from ..infer.mcmc import MCMC
from ..infer.mcmc.ess import EllipticalSlice
from ..utils.config import dump_config, parse_config

__all__ = ["Config", "rbf", "make_data", "chol_K", "make_model",
           "analytic_posterior", "log_marginal", "run", "main"]


@dataclasses.dataclass(frozen=True)
class Config:
    n: int = 256
    noise: float = 0.2
    lengthscale: float = 0.4
    amplitude: float = 1.0
    seed: int = 0
    num_samples: int = 800
    num_burnin: int = 200
    num_chains: int = 8
    smoke: bool = False
    device: str = "cuda"


def matvec(a, v):
    """``a @ v`` in the wider of the two float dtypes (JAX's promotion)."""
    dt = torch.promote_types(a.dtype, v.dtype)
    return a.to(dt) @ v.to(dt)


def rbf(x1, x2, lengthscale, amplitude):
    d2 = (x1[:, None] - x2[None, :]) ** 2
    return amplitude**2 * torch.exp(-0.5 * d2 / lengthscale**2)


def make_data(cfg: Config):
    """``(x, y, f)`` float32 tensors on ``cfg.device`` from the JAX
    package's numpy recipe, so both make identical data."""
    rng = np.random.default_rng(cfg.seed)
    x = np.sort(rng.uniform(-2, 2, cfg.n)).astype(np.float32)
    f = np.sin(3 * x) * np.exp(-0.3 * np.abs(x))
    y = (f + rng.normal(0, cfg.noise, cfg.n)).astype(np.float32)
    dev = torch.device(cfg.device)
    return (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            torch.as_tensor(f, device=dev))


def chol_K(x, cfg: Config, jitter=1e-6):
    """Cholesky factor of K + jitter I, in the dtype of ``x``.  The kernel
    and its factor are computed in float64: in float32 the factor fails
    (NaN) from n ~ 128 on [-2, 2] at the default lengthscale, the JAX
    package's too at its default n 256 (the matrix's smallest eigenvalue
    is the jitter)."""
    return chol_float64(rbf(x.double(), x.double(), cfg.lengthscale,
                            cfg.amplitude), jitter).to(x.dtype)


def chol_float64(k, jitter):
    """Cholesky factor of the float64 ``k`` + jitter I (NaN where not
    positive definite)."""
    return cholesky(k + jitter * torch.eye(k.shape[0], dtype=k.dtype,
                                           device=k.device))


def make_model(x, y, cfg: Config):
    """Whitened GP: z ~ N(0, I); f = L z; y ~ N(f, noise)."""
    chol = chol_K(x, cfg)

    def model():
        z = sample("z", dist.Normal(0.0, 1.0).expand((x.shape[0],))
                   .to_event(1))
        f = matvec(chol, z)
        sample("obs", dist.Normal(f, cfg.noise).to_event(1), obs=y)

    return model, chol


def analytic_posterior(x, y, cfg: Config):
    """Exact GP posterior mean/cov over f at the training inputs (numpy,
    the kernel in the inputs' dtype, the algebra in float64)."""
    k = rbf(x, x, cfg.lengthscale, cfg.amplitude).cpu().numpy()
    a = k + cfg.noise**2 * np.eye(x.shape[0])
    kinv_y = np.linalg.solve(a, y.cpu().numpy())
    mean = k @ kinv_y
    cov = k - k @ np.linalg.solve(a, k)
    return mean, cov


def log_marginal(x, y, lengthscale, amplitude, noise):
    """Exact log marginal likelihood via dist.MultivariateNormal."""
    k = rbf(x, x, lengthscale, amplitude)
    cov = k + noise**2 * torch.eye(x.shape[0], dtype=x.dtype,
                                   device=x.device)
    return dist.MultivariateNormal(
        torch.zeros(x.shape[0], dtype=x.dtype, device=x.device),
        scale_tril=cholesky(cov)).log_prob(y)


def run(cfg: Config, seed=None, sampler="ess"):
    """``EllipticalSlice`` (``sampler="ess"``, the default) or NUTS over the
    whitened latents on ``cfg.device`` from the integer ``seed``
    (``cfg.seed`` by default); the draws of f against the analytic
    posterior."""
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, n=64, num_samples=200,
                                  num_burnin=100, num_chains=2)
    seed = cfg.seed if seed is None else seed
    x, y, f_true = make_data(cfg)
    model, chol = make_model(x, y, cfg)

    if sampler == "ess":
        res = EllipticalSlice(
            model, num_samples=cfg.num_samples, num_burnin=cfg.num_burnin,
            num_chains=cfg.num_chains, device=cfg.device).run(seed)
    else:
        res = MCMC(model=model, num_warmup=cfg.num_burnin,
                   num_samples=cfg.num_samples, num_chains=cfg.num_chains,
                   device=cfg.device).run(seed)

    z = res.samples["z"].reshape(-1, cfg.n)
    f_draws = (z @ chol.T).cpu().numpy()
    mean_ref, cov_ref = analytic_posterior(x, y, cfg)
    return {
        "x": x.cpu().numpy(), "y": y.cpu().numpy(),
        "f_mean": f_draws.mean(0), "f_std": f_draws.std(0),
        "analytic_mean": mean_ref,
        "analytic_std": np.sqrt(np.diag(cov_ref)),
        "max_mean_err": float(np.abs(f_draws.mean(0) - mean_ref).max()),
        "rmse_truth": float(np.sqrt(np.mean(
            (f_draws.mean(0) - f_true.cpu().numpy()) ** 2))),
        "result": res,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print({k: out[k] for k in ("max_mean_err", "rmse_truth")})
    return out


if __name__ == "__main__":
    main()
