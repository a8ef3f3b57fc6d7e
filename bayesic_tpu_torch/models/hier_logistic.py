"""Example 2 — hierarchical logistic regression (partial pooling over J
groups): mini-batch mean-field SVI, and a full-batch NUTS cross-check.

Counterpart of ``bayesic_tpu/models/hier_logistic.py``.  Two entry points
fit the non-centered model with the same estimator (STL ELBO, mean-field
guide, Adam at a cosine-decayed rate):

* ``run_svi``: the generic engine — DSL model -> ``build_logjoint`` ->
  ``SVI`` + ``MeanFieldGuide``, one Python step at a time.
* ``run_svi_fused``: ``ops/fused_hier.fused_train``, which on a GPU runs
  every step in one launch of the hand-written kernel.

Two entry points sample the centered model's posterior with NUTS (the data
dominate at 200 rows per group, where the centered form mixes far better):

* ``MCMC`` on ``make_model(..., centered=True)`` (``run``'s cross-check):
  the batched NUTS core over autograd of the DSL log-joint.
* ``fused_nuts_mcmc``: the same ``MCMC`` sampler with its
  ``batched_transition`` hook running ``ops/fused_nuts_hier``, which on a
  GPU runs each whole transition of every chain in one kernel launch.

Run: ``python -m bayesic_tpu_torch.models.hier_logistic --smoke true``
(on the card; add ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dist
from ..core import plate, sample
from ..infer.mcmc import MCMC
from ..infer.svi import SVI, Adam, MeanFieldGuide, cosine_decay_schedule
from ..ops import fused_hier as fh
from ..utils import diagnostics as diag
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps


@dataclasses.dataclass(frozen=True)
class Config:
    num_groups: int = 50
    obs_per_group: int = 200
    num_features: int = 5
    seed: int = 0
    svi_steps: int = 3000
    batch_size: int = 1024
    lr: float = 0.03
    num_warmup: int = 500
    num_samples: int = 500
    num_chains: int = 4
    smoke: bool = False
    bench: bool = False
    run_nuts: bool = True
    device: str = "cuda"


def make_data(cfg: Config):
    """``(x (N, F) float32, y (N,) int32, group (N,) int32, truth)`` as
    numpy arrays: the JAX package's recipe, so both make identical data."""
    rng = np.random.default_rng(cfg.seed)
    j, npg, d = cfg.num_groups, cfg.obs_per_group, cfg.num_features
    mu_true, tau_true = 0.5, 1.0
    theta_true = rng.normal(mu_true, tau_true, j).astype(np.float32)
    beta_true = rng.normal(0, 0.5, d).astype(np.float32)
    group = np.repeat(np.arange(j), npg).astype(np.int32)
    x = rng.normal(0, 1, (j * npg, d)).astype(np.float32)
    logits = theta_true[group] + x @ beta_true
    y = (rng.uniform(size=j * npg) < 1 / (1 + np.exp(-logits))).astype(
        np.int32)
    return x, y, group, dict(theta=theta_true, beta=beta_true, mu=mu_true,
                             tau=tau_true)


def _tensors(cfg: Config):
    x, y, group, truth = make_data(cfg)
    device = torch.device(cfg.device)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device),
            torch.as_tensor(group, device=device), truth)


def make_model(num_groups, num_features, batch_size=None, centered=False):
    """``centered`` picks the parameterization of the group intercepts:
    non-centered for mean-field SVI (decorrelated latents), centered for
    full-batch NUTS, where 200 rows per group dominate the prior and the
    non-centered form makes a tau-theta ridge (the JAX module's
    docstring has the measurements)."""

    def model(x, y, group):
        n = x.shape[0]
        mu = sample("mu", dist.Normal(0.0, 5.0))
        tau = sample("tau", dist.HalfNormal(2.0))
        if centered:
            theta = sample("theta", dist.Normal(mu, tau)
                           .expand((num_groups,)).to_event(1))
        else:
            theta_raw = sample("theta_raw", dist.Normal(0.0, 1.0)
                               .expand((num_groups,)).to_event(1))
            theta = mu + tau * theta_raw
        beta = sample("beta", dist.Normal(0.0, 1.0)
                      .expand((num_features,)).to_event(1))
        with plate("data", n, subsample_size=batch_size) as idx:
            logits = theta[group[idx]] + x[idx] @ beta
            sample("obs", dist.Bernoulli(logits=logits).to_event(1),
                   obs=y[idx])

    return model


def _flat_stats(loc, ls, num_groups):
    """Flat (mu, log tau, theta_raw[J], beta[F]) vectors -> per-site
    unconstrained mean and std (the ``MeanFieldGuide.stats`` layout)."""
    j = int(num_groups)

    def split(v):
        return {"mu": v[0], "tau": v[1], "theta_raw": v[2:2 + j],
                "beta": v[2 + j:]}

    return split(loc), split(torch.exp(ls))


def run_svi(cfg: Config, generator=None):
    """Generic-engine mean-field SVI on ``cfg.device``.  ``generator`` (on
    that device) drives the mini-batches and the noise."""
    device = torch.device(cfg.device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(cfg.seed)
    x, y, group, truth = _tensors(cfg)
    model = make_model(cfg.num_groups, cfg.num_features, cfg.batch_size)
    svi = SVI(model, MeanFieldGuide,
              Adam(cosine_decay_schedule(cfg.lr, cfg.svi_steps)),
              model_args=(x, y, group), device=device)
    if cfg.bench:
        state = svi.init(gen)
        _, dt = timed_steps(lambda s: svi.run(gen, cfg.svi_steps, state=s),
                            state)
        bench_line("elbo_steps_per_s", cfg.svi_steps / dt, "steps/s",
                   model="hier_logistic", n=int(x.shape[0]),
                   batch=cfg.batch_size, device=str(device))
    res = svi.run(gen, cfg.svi_steps)
    mean_u, std_u = svi.guide.stats(res.params)
    return {"svi": svi, "result": res, "mean_u": mean_u, "std_u": std_u,
            "losses": res.losses.cpu().numpy(), "truth": truth,
            "data": (x, y, group)}


def run_svi_fused(cfg: Config, generator=None):
    """Same model, same estimator, one ``fused_train`` call for all
    ``cfg.svi_steps`` steps on ``cfg.device``.  ``generator`` is a CPU
    generator for the one-time shuffle and the kernel's Philox seed."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    x, y, group, truth = _tensors(cfg)
    perm = torch.randperm(x.shape[0], generator=gen).to(x.device)
    x, y, group = x[perm], y[perm], group[perm]
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item())
    loc, ls, opt = fh.init_params(cfg.num_groups, cfg.num_features,
                                  device=x.device)
    loc, ls, opt, losses = fh.fused_train(
        x, y, group, loc, ls, opt, steps=cfg.svi_steps, lr0=cfg.lr,
        seed=seed, batch=cfg.batch_size)
    mean_u, std_u = _flat_stats(loc, ls, cfg.num_groups)
    return {"data": (x, y, group), "loc": loc, "ls": ls, "opt_state": opt,
            "mean_u": mean_u, "std_u": std_u,
            "losses": losses.cpu().numpy(), "truth": truth}


def fused_nuts_mcmc(num_groups, num_features, x, y, group, *, num_warmup,
                    num_samples, num_chains=128, target_accept=0.85,
                    max_doublings=6):
    """The full-batch centered NUTS workload through
    ``ops/fused_nuts_hier``: the same model density and ``MCMC`` driver
    (pooled adaptation, Welford windows, diagnostics), each transition of
    every chain one kernel launch on a GPU.  Returns the ``MCMC`` object
    (call ``.run(seed)``).  The JAX function's ``block_chains``,
    ``mm_dtype`` and ``interpret`` are not ported: one thread block runs
    one chain, every product is fp32, and a CPU tensor runs the plain
    version."""
    from ..ops.fused_nuts_hier import make_batched_transition_hier

    model = make_model(num_groups, num_features, None, centered=True)
    bt = make_batched_transition_hier(x, y, group, num_groups,
                                      max_doublings=max_doublings)
    return MCMC(model=model, num_warmup=num_warmup, num_samples=num_samples,
                num_chains=num_chains, shared_adapt=True,
                model_args=(x, y, group), target_accept=target_accept,
                batched_transition=bt)


def run(cfg: Config, generator=None):
    if cfg.smoke:
        cfg = dataclasses.replace(
            cfg, num_groups=8, obs_per_group=40, svi_steps=400,
            batch_size=64, num_warmup=200, num_samples=200, num_chains=2)
    res = run_svi(cfg, generator)
    out = {
        "svi_mu": float(res["mean_u"]["mu"]),
        "svi_mu_std": float(res["std_u"]["mu"]),
        "svi_beta": res["mean_u"]["beta"].cpu().numpy(),
        "truth": res["truth"],
        "final_elbo": -float(res["losses"][-1]),
        "svi": res["svi"],
    }
    if cfg.run_nuts:
        # full batch, centered: the data-dominated regime
        mcmc = MCMC(model=make_model(cfg.num_groups, cfg.num_features, None,
                                     centered=True),
                    num_warmup=cfg.num_warmup, num_samples=cfg.num_samples,
                    num_chains=cfg.num_chains, target_accept=0.85,
                    model_args=res["data"])
        mres = mcmc.run(cfg.seed + 1)
        summ = diag.summary({k: mres.samples[k] for k in ("mu", "tau")})
        out["nuts_mu"] = float(summ["mu"]["mean"])
        out["nuts_mu_mcse"] = float(summ["mu"]["mcse"])
        out["nuts_tau"] = float(summ["tau"]["mean"])
        out["nuts_rhat_mu"] = float(summ["mu"]["rhat"])
        out["nuts_ess_mu"] = float(summ["mu"]["ess"])
        out["divergences"] = int(mres.extra["diverging"].sum())
        out["mcmc_result"] = mres
        # the SVI-vs-NUTS cross-check of the JAX module
        out["cross_check_gap"] = abs(out["svi_mu"] - out["nuts_mu"])
    return out


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"SVI  mu = {out['svi_mu']:.3f} ± {out['svi_mu_std']:.3f}")
    if cfg.run_nuts:
        print(f"NUTS mu = {out['nuts_mu']:.3f} "
              f"(mcse {out['nuts_mu_mcse']:.4f}, "
              f"rhat {out['nuts_rhat_mu']:.3f}, "
              f"ess {out['nuts_ess_mu']:.0f}, "
              f"divergences {out['divergences']})")
        print(f"cross-check gap = {out['cross_check_gap']:.3f}")


if __name__ == "__main__":
    main()
