"""Example 7 — Bayesian structural time series.

Counterpart of ``bayesic_tpu/models/sts.py``.  A local-linear trend plus
dummy seasonality is assembled as a ``dist.LinearGaussianStateSpace``; the
Gaussian state path is marginalised exactly inside ``log_prob`` (the
Kalman prediction-error decomposition), and NUTS runs over the four
variance hyperparameters alone.  Afterwards ``smooth()`` decomposes the
series into trend and seasonal components and ``forecast()`` propagates
the filtered terminal state h steps ahead with exact Gaussian intervals.

``log_prob`` runs the temporally parallel Kalman filter (``dist/lgss.py``,
an associative scan: log2(T) rounds of batched (D, D) algebra), so a
potential evaluation on a T=256 series is 8 rounds of a few launches
each in place of 256 dependent steps.

Run: ``python -m bayesic_tpu_torch.models.sts --smoke true`` (on the card;
add ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dist
from ..core import sample
from ..infer.mcmc import MCMC
from ..utils.config import dump_config, parse_config

__all__ = ["Config", "make_lgss", "make_data", "make_model", "decompose",
           "forecast", "run", "main"]


@dataclasses.dataclass(frozen=True)
class Config:
    t_len: int = 256
    season: int = 7
    sigma_level: float = 0.15
    sigma_slope: float = 0.02
    sigma_seas: float = 0.08
    sigma_obs: float = 0.3
    seed: int = 0
    num_samples: int = 400
    num_warmup: int = 400
    num_chains: int = 4
    horizon: int = 28
    smoke: bool = False
    device: str = "cuda"


def _system_matrices(season):
    """F, H (numpy) for local-linear trend + (season-1)-dim dummy seasonal
    block.

    State z = [level, slope, s_0, s_1, ..., s_{S-2}] where s_0 is the
    current seasonal effect and the block rotates each step with
    s_new = -(s_0 + ... + s_{S-2}) + noise.
    """
    s = season - 1
    d = 2 + s
    f = np.zeros((d, d))
    f[0, 0] = f[0, 1] = f[1, 1] = 1.0          # level += slope; slope AR(1)=1
    f[2, 2:] = -1.0                            # new seasonal = -sum(previous)
    for i in range(1, s):
        f[2 + i, 2 + i - 1] = 1.0              # shift the seasonal history
    h = np.zeros((1, d))
    h[0, 0] = 1.0                              # observe level
    h[0, 2] = 1.0                              # + current seasonal
    return f, h


def make_lgss(cfg: Config, sigma_level, sigma_slope, sigma_seas,
              sigma_obs):
    """The state-space model at these scales (floats or tensors).  Its
    tensors live on the scales' device (``cfg.device`` when all are
    floats), in their dtype (float32 for floats).  Q is built without
    writes in place, so the generic ``MCMC`` differentiates it under
    ``vmap``."""
    tensors = [v for v in (sigma_level, sigma_slope, sigma_seas, sigma_obs)
               if isinstance(v, torch.Tensor)]
    dev = tensors[0].device if tensors else torch.device(cfg.device)
    dt = tensors[0].dtype if tensors else torch.float32

    def sq(v):
        if isinstance(v, torch.Tensor):
            return (v ** 2).to(dt)
        return torch.tensor(v ** 2, dtype=dt, device=dev)

    f_np, h_np = _system_matrices(cfg.season)
    d = f_np.shape[0]
    eye = torch.eye(d, dtype=dt, device=dev)
    diag = torch.cat([torch.stack([sq(sigma_level), sq(sigma_slope),
                                   sq(sigma_seas)]),
                      torch.zeros(d - 3, dtype=dt, device=dev)])
    # tiny diffuse-ish floor keeps Q and the smoother Cholesky full rank
    q = torch.diag_embed(diag) + 1e-8 * eye
    p0 = torch.diag(torch.tensor([1.0, 0.1] + [0.5] * (d - 2), dtype=dt,
                                 device=dev))
    return dist.LinearGaussianStateSpace(
        torch.zeros(d, dtype=dt, device=dev), p0,
        torch.as_tensor(f_np, dtype=dt, device=dev), q,
        torch.as_tensor(h_np, dtype=dt, device=dev),
        sq(sigma_obs).reshape(1, 1), cfg.t_len)


def make_data(cfg: Config, generator=None):
    """One (T, 1) series drawn from the model at the true scales, on
    ``cfg.device``; ``generator`` (on that device) draws it, else one
    seeded with ``cfg.seed``."""
    lg = make_lgss(cfg, cfg.sigma_level, cfg.sigma_slope, cfg.sigma_seas,
                   cfg.sigma_obs)
    gen = generator if generator is not None else \
        torch.Generator(device=cfg.device).manual_seed(cfg.seed)
    return lg.sample(gen)


def make_model(x, cfg: Config):
    def model():
        sl = sample("sigma_level", dist.HalfNormal(0.5))
        ss = sample("sigma_slope", dist.HalfNormal(0.1))
        se = sample("sigma_seas", dist.HalfNormal(0.5))
        so = sample("sigma_obs", dist.HalfNormal(1.0))
        sample("x", make_lgss(cfg, sl, ss, se, so), obs=x)

    return model


def decompose(x, cfg: Config, sigma_level, sigma_slope, sigma_seas,
              sigma_obs):
    """Smoothed trend/seasonal components and their marginal stds."""
    lg = make_lgss(cfg, sigma_level, sigma_slope, sigma_seas, sigma_obs)
    sm, sp = lg.smooth(x)
    return {
        "trend": sm[:, 0], "trend_std": torch.sqrt(sp[:, 0, 0]),
        "seasonal": sm[:, 2], "seasonal_std": torch.sqrt(sp[:, 2, 2]),
        "slope": sm[:, 1],
    }


def forecast(x, cfg: Config, sigma_level, sigma_slope, sigma_seas,
             sigma_obs, horizon=None):
    """Exact h-step-ahead Gaussian predictive from the filtered terminal
    state: mean (h,) and std (h,) of future observations."""
    horizon = cfg.horizon if horizon is None else horizon
    lg = make_lgss(cfg, sigma_level, sigma_slope, sigma_seas, sigma_obs)
    ms, ps = lg.filter(x)
    f, q = lg.transition_matrix, lg.transition_cov
    h, r = lg.observation_matrix, lg.observation_cov
    m, p = ms[-1], ps[-1]
    mx, vx = [], []
    for _ in range(horizon):
        m = f @ m
        p = f @ p @ f.T + q
        mx.append(h @ m)
        vx.append(h @ p @ h.T + r)
    return torch.stack(mx)[:, 0], torch.sqrt(torch.stack(vx)[:, 0, 0])


def run(cfg: Config, seed=None):
    """NUTS over the four scales on ``cfg.device`` (``seed`` an integer,
    ``cfg.seed + 1`` by default), then the decomposition and the forecast
    at the posterior means."""
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, t_len=96, num_samples=150,
                                  num_warmup=150, num_chains=2,
                                  horizon=14)
    seed = cfg.seed + 1 if seed is None else seed
    x = make_data(cfg)
    res = MCMC(model=make_model(x, cfg), num_warmup=cfg.num_warmup,
               num_samples=cfg.num_samples, num_chains=cfg.num_chains,
               device=cfg.device).run(seed)
    post = {k: float(v.mean()) for k, v in res.samples.items()}
    comp = decompose(x, cfg, post["sigma_level"], post["sigma_slope"],
                     post["sigma_seas"], post["sigma_obs"])
    mx, sx = forecast(x, cfg, post["sigma_level"], post["sigma_slope"],
                      post["sigma_seas"], post["sigma_obs"])
    return {
        "x": x[:, 0].cpu().numpy(),
        "posterior_means": post,
        "true": {"sigma_level": cfg.sigma_level,
                 "sigma_slope": cfg.sigma_slope,
                 "sigma_seas": cfg.sigma_seas,
                 "sigma_obs": cfg.sigma_obs},
        "samples": res.samples,
        "extra": res.extra,
        "trend": comp["trend"].cpu().numpy(),
        "seasonal": comp["seasonal"].cpu().numpy(),
        "forecast_mean": mx.cpu().numpy(),
        "forecast_std": sx.cpu().numpy(),
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print({"posterior_means": out["posterior_means"], "true": out["true"]})
    return out


if __name__ == "__main__":
    main()
