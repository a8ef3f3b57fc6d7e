"""Example 8 — sparse variational GP regression (SVGP).

Counterpart of ``bayesic_tpu/models/svgp.py``.  M << n inducing points
carry the posterior and the likelihood streams over mini-batches
(Titsias 2009 / Hensman et al. 2013), written in the DSL:

  * whitened inducing latents ``v ~ N(0, I_M)`` (u = L_Z v, gp.py's
    whitening);
  * a per-batch projection ``f = A v`` with ``A = K_xZ L_Z^{-T}``, one
    (B, M) triangular solve and a matvec;
  * the Titsias variance correction as a ``factor`` site inside the
    subsampled plate, so the plate's N/B scale makes the whole bound an
    unbiased estimate of the full-data SVGP ELBO.

With Gaussian noise the optimal q(v) is a closed-form Gaussian
(precision I + AᵀA/σ², mean Λ^{-1} Aᵀ y/σ², ``optimal_q``), the oracle a
``FullRankGuide`` trained by SVI must recover.

Run: ``python -m bayesic_tpu_torch.models.svgp --smoke true`` (on the
card; add ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dist
from ..core import factor, plate, sample
from ..infer.svi import SVI, Adam, FullRankGuide, cosine_decay_schedule
from ..utils.config import dump_config, parse_config
from .gp import chol_float64, matvec, rbf

__all__ = ["Config", "make_data", "inducing_grid", "make_model",
           "optimal_q", "predict", "run_svi", "main"]


@dataclasses.dataclass(frozen=True)
class Config:
    n: int = 4096
    num_inducing: int = 32
    batch: int = 512
    noise: float = 0.2
    lengthscale: float = 0.4
    amplitude: float = 1.0
    seed: int = 0
    steps: int = 12000
    lr: float = 0.01
    smoke: bool = False
    device: str = "cuda"


def make_data(cfg: Config):
    """``(x, y, f)`` float32 tensors on ``cfg.device`` (the JAX package's
    numpy recipe)."""
    rng = np.random.default_rng(cfg.seed)
    x = np.sort(rng.uniform(-2, 2, cfg.n)).astype(np.float32)
    f = np.sin(3 * x) * np.exp(-0.3 * np.abs(x))
    y = (f + rng.normal(0, cfg.noise, cfg.n)).astype(np.float32)
    dev = torch.device(cfg.device)
    return (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            torch.as_tensor(f, device=dev))


def inducing_grid(cfg: Config, dtype=torch.float32):
    return torch.linspace(-2.0, 2.0, cfg.num_inducing, dtype=dtype,
                          device=torch.device(cfg.device))


def make_model(x, y, cfg: Config, jitter=1e-6):
    """DSL SVGP: the returned model uses a subsampled plate when
    ``cfg.batch < cfg.n`` and the full data otherwise.  Returns
    ``(model, project, L_Z)``; the inducing grid and L_Z are in the
    dtype of ``x``."""
    z = inducing_grid(cfg, x.dtype).to(x.device)
    # K_ZZ and its factor in float64 (gp.chol_K): at M 32 the float32
    # factor is so ill-conditioned that torch's and XLA's part by ~5e-3
    lz = chol_float64(rbf(z.double(), z.double(), cfg.lengthscale,
                          cfg.amplitude), jitter).to(z.dtype)
    m = z.shape[0]
    sub = cfg.batch if cfg.batch < cfg.n else None

    def project(xb):
        """A = K_xZ L_Z^{-T}: rows are the whitened predictive weights."""
        kxz = rbf(xb, z, cfg.lengthscale, cfg.amplitude)
        return torch.linalg.solve_triangular(lz, kxz.T, upper=False).T

    def model():
        v = sample("v", dist.Normal(0.0, 1.0).expand((m,)).to_event(1))
        with plate("data", cfg.n, subsample_size=sub) as idx:
            xb = x[idx] if sub is not None else x
            yb = y[idx] if sub is not None else y
            a = project(xb)
            f = matvec(a, v)
            # Titsias correction: the marginalized GP remainder
            # diag(K_xx - A A^T) enters the Gaussian likelihood bound as
            # -0.5 r / sigma^2 per point (plate scaling keeps it unbiased
            # under subsampling)
            r = torch.clamp(cfg.amplitude**2 - torch.sum(a * a, -1),
                            min=0.0)
            factor("titsias", -0.5 * r / cfg.noise**2)
            sample("obs", dist.Normal(f, cfg.noise), obs=yb)

    return model, project, lz


def optimal_q(x, y, cfg: Config, project):
    """Closed-form optimal whitened q(v) = N(mu, Sigma) for Gaussian
    noise: precision = I + A^T A / sigma^2, mean = Sigma A^T y / sigma^2
    (numpy)."""
    a = project(x).cpu().numpy()
    lam = np.eye(a.shape[1]) + a.T @ a / cfg.noise**2
    sigma = np.linalg.inv(lam)
    mu = sigma @ (a.T @ y.cpu().numpy()) / cfg.noise**2
    return mu, sigma


def predict(v_mean, v_cov, project, x_new, cfg: Config):
    """Predictive mean/variance of f at new inputs given q(v) (numpy
    ``v_mean``, ``v_cov``; ``x_new`` a tensor on the model's device)."""
    a = project(x_new).cpu().numpy()
    mean = a @ v_mean
    var = np.maximum(
        cfg.amplitude**2 - np.sum(a * a, -1), 0.0
    ) + np.einsum("ij,jk,ik->i", a, v_cov, a)
    return mean, var


def run_svi(cfg: Config, generator=None):
    """Full-rank SVI with Adam on a cosine decay on ``cfg.device``;
    ``generator`` (on that device) draws the guide's noise and the
    mini-batches."""
    dev = torch.device(cfg.device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(cfg.seed)
    x, y, f_true = make_data(cfg)
    model, project, _ = make_model(x, y, cfg)
    svi = SVI(model, FullRankGuide,
              Adam(cosine_decay_schedule(cfg.lr, cfg.steps)), device=dev)
    res = svi.run(gen, cfg.steps)
    mean_u, _ = svi.guide.stats(res.params)
    v_mean = mean_u["v"].detach().cpu().numpy()
    v_cov = svi.guide.covariance(res.params).detach().cpu().numpy()
    f_mean, f_var = predict(v_mean, v_cov, project, x, cfg)
    return {
        "losses": res.losses.cpu().numpy(),
        "v_mean": v_mean, "v_cov": v_cov,
        "f_mean": f_mean, "f_var": f_var,
        "rmse_truth": float(np.sqrt(np.mean(
            (f_mean - f_true.cpu().numpy()) ** 2))),
        "project": project, "x": x, "y": y, "svi": svi, "result": res,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, n=512, steps=400, batch=128)
    print(dump_config(cfg))
    out = run_svi(cfg)
    print({"rmse_truth": out["rmse_truth"],
           "final_loss": float(out["losses"][-1])})
    return out


if __name__ == "__main__":
    main()
