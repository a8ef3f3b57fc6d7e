"""Example 1 — Bayesian linear regression, full-batch SVI.

Counterpart of ``bayesic_tpu/models/linreg.py``.  Known noise, so the
posterior over (w, b) is an analytic Gaussian (``analytic_posterior``), the
correctness oracle.  Two entry points fit it with the STL ELBO and Adam at
a cosine-decayed rate:

* ``run``: the generic engine — DSL model -> ``build_logjoint`` -> ``SVI``
  with a ``MeanFieldGuide`` or a ``FullRankGuide`` (``Config.guide``), one
  Python step at a time.
* ``run_svi_fused``: ``ops/fused_linreg.fused_train`` on the exact Gram
  sufficient statistics (mean-field), which on a GPU runs every step in
  one launch of the hand-written kernel.

Run: ``python -m bayesic_tpu_torch.models.linreg --smoke true`` (on the
card; add ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dist
from ..core import sample
from ..infer.svi import (SVI, Adam, FullRankGuide, MeanFieldGuide,
                         cosine_decay_schedule)
from ..ops import fused_linreg as fl
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps

__all__ = ["Config", "make_data", "model", "analytic_posterior", "run",
           "run_svi_fused", "main"]


@dataclasses.dataclass(frozen=True)
class Config:
    n: int = 4096
    dim: int = 16
    noise: float = 0.5
    seed: int = 0
    steps: int = 2000
    lr: float = 0.05
    guide: str = "meanfield"       # meanfield | fullrank
    smoke: bool = False
    bench: bool = False
    device: str = "cuda"


def make_data(cfg: Config):
    """``(x (N, D) float32, y (N,) float32, w_true, b_true)`` as numpy:
    the JAX package's recipe, so both make identical data."""
    rng = np.random.default_rng(cfg.seed)
    x = rng.normal(0, 1, (cfg.n, cfg.dim)).astype(np.float32)
    w_true = rng.normal(0, 1, cfg.dim).astype(np.float32)
    b_true = np.float32(rng.normal(0, 1))
    y = (x @ w_true + b_true
         + rng.normal(0, cfg.noise, cfg.n)).astype(np.float32)
    return x, y, w_true, b_true


def model(x, y, noise):
    w = sample("w", dist.Normal(0.0, 1.0).expand((x.shape[1],)).to_event(1))
    b = sample("b", dist.Normal(0.0, 1.0))
    sample("obs", dist.Normal(x @ w + b, noise).to_event(1), obs=y)


def analytic_posterior(x, y, noise, prior_var=1.0):
    """Exact Gaussian posterior ``(mean, cov)`` over (w, b) with known
    noise, in float64 numpy (``x``, ``y`` numpy arrays or tensors)."""
    xn = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    yn = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
    phi = np.concatenate([xn, np.ones((xn.shape[0], 1), xn.dtype)], 1)
    prec = phi.T @ phi / noise**2 + np.eye(phi.shape[1]) / prior_var
    cov = np.linalg.inv(prec)
    mean = cov @ (phi.T @ yn) / noise**2
    return mean, cov


def _tensors(cfg: Config):
    x, y, w_true, b_true = make_data(cfg)
    device = torch.device(cfg.device)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device), w_true, b_true)


def _flat(mean_u):
    return np.concatenate([mean_u["w"].detach().cpu().numpy().ravel(),
                           [float(mean_u["b"])]])


def run(cfg: Config, generator=None):
    """Generic-engine SVI on ``cfg.device``.  ``generator`` (on that
    device) draws the guide's noise."""
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, n=256, dim=4, steps=300)
    device = torch.device(cfg.device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(cfg.seed)
    x, y, _, _ = _tensors(cfg)
    guide_cls = {"meanfield": MeanFieldGuide, "fullrank": FullRankGuide}[
        cfg.guide]
    svi = SVI(model, guide_cls,
              Adam(cosine_decay_schedule(cfg.lr, cfg.steps)),
              model_args=(x, y, cfg.noise), device=device)
    if cfg.bench:
        state = svi.init(gen)
        res, dt = timed_steps(lambda s: svi.run(gen, cfg.steps, state=s),
                              state)
        bench_line("elbo_steps_per_s", cfg.steps / dt, "steps/s",
                   model="linreg", n=cfg.n, dim=cfg.dim, device=str(device))
    else:
        res = svi.run(gen, cfg.steps)
    mean_u, std_u = svi.guide.stats(res.params)
    mean_ref, cov_ref = analytic_posterior(x, y, cfg.noise)
    got = _flat(mean_u)
    return {
        "posterior_mean": got,
        "posterior_sd": _flat(std_u),
        "analytic_mean": mean_ref,
        "analytic_cov": cov_ref,
        "max_abs_err": float(np.abs(got - mean_ref).max()),
        "final_elbo": -float(res.losses[-1]),
        "losses": res.losses.cpu().numpy(),
        "svi": svi,
        "result": res,
    }


def run_svi_fused(cfg: Config, generator=None):
    """Same model and estimator (mean-field) through the exact Gram
    sufficient statistics, one ``fused_train`` call for all ``cfg.steps``
    steps on ``cfg.device``.  ``generator`` is a CPU generator for the
    kernel's Philox seed."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    x, y, _, _ = _tensors(cfg)
    g = fl.gram(x, y)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item())
    loc, ls, opt = fl.init_params(cfg.dim, device=x.device)
    loc, ls, opt, losses = fl.fused_train(
        g, cfg.n, cfg.noise, loc, ls, opt, steps=cfg.steps, lr0=cfg.lr,
        seed=seed)
    mean_ref, cov_ref = analytic_posterior(x, y, cfg.noise)
    got = loc.cpu().numpy()
    return {
        "posterior_mean": got,
        "posterior_sd": torch.exp(ls).cpu().numpy(),
        "analytic_mean": mean_ref,
        "analytic_cov": cov_ref,
        "max_abs_err": float(np.abs(got - mean_ref).max()),
        "losses": losses.cpu().numpy(),
        "gram": g, "loc": loc, "ls": ls, "opt_state": opt,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"max |posterior mean - analytic| = {out['max_abs_err']:.4f}")
    print(f"final ELBO = {out['final_elbo']:.2f}")


if __name__ == "__main__":
    main()
