"""Example 4 — a Gaussian mixture model fitted by tempered SMC.

Counterpart of ``bayesic_tpu/models/gmm.py``.  The assignment is
marginalised (``MixtureSameFamily``), so the target is continuous and
multimodal by the label symmetry, which is kept; correctness is judged on
a label-invariant functional, the posterior-predictive density against
the true generating mixture.

Four ways through ``infer.smc.SMC`` (``run``'s ``mode``):

* ``"generic"``: the DSL log-joint under ``torch.func.vmap`` for every
  potential evaluation;
* ``"kernels"``: the likelihood's value from ``gmm_loglik`` and its value
  and gradient from ``gmm_loglik_grad``, one launch per evaluation on a
  GPU, pulled back to unconstrained space by autograd through the
  stick-breaking and exp transforms;
* ``"split"``: ``gmm_loglik`` alone, differentiated by autograd through
  its backward kernel;
* ``"fused"``: ``ops/fused_smc_gmm``, one launch per stage for the whole
  mutation.

An empty ``Config.mode`` picks ``"kernels"`` on a CUDA device and
``"generic"`` elsewhere, as the JAX package picks its Pallas kernels on a
TPU.  ``run(particle_sharding=)`` splits the particles over a mesh axis in
every mode (``infer.smc``); each rank then runs the hooks' kernels on its
own rows, and every rank returns the same figures.

Run: ``python -m bayesic_tpu_torch.models.gmm --smoke true`` (on the card;
add ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dist
from ..core import sample
from ..infer.smc import SMC, gather_particles
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps

__all__ = ["Config", "MODES", "make_data", "make_model", "make_batched_loglik",
           "make_batched_loglik_grad", "make_batched_mutation", "make_smc",
           "predictive_loglik", "run", "main"]

MODES = ("generic", "kernels", "split", "fused")


@dataclasses.dataclass(frozen=True)
class Config:
    num_components: int = 3
    data_dim: int = 2
    num_data: int = 1000
    num_particles: int = 4096
    mutation_steps: int = 5
    leapfrog_steps: int = 5
    seed: int = 0
    smoke: bool = False
    bench: bool = False
    mode: str = ""              # "" picks by device; else one of MODES
    device: str = "cuda"


def make_data(cfg: Config):
    """``(x (N, D) float32, truth)`` as numpy: the JAX package's recipe,
    so both make identical data."""
    rng = np.random.default_rng(cfg.seed)
    k, d = cfg.num_components, cfg.data_dim
    centers = rng.normal(0, 4.0, (k, d)).astype(np.float32)
    scales = np.full((k,), 0.7, np.float32)
    weights = rng.dirichlet(np.full(k, 5.0)).astype(np.float32)
    comps = rng.choice(k, cfg.num_data, p=weights)
    x = (centers[comps]
         + rng.normal(0, 1, (cfg.num_data, d)) * scales[comps, None]) \
        .astype(np.float32)
    return x, dict(centers=centers, scales=scales, weights=weights)


def make_model(cfg: Config, x):
    k, d = cfg.num_components, cfg.data_dim

    def model():
        w = sample("weights", dist.Dirichlet(torch.ones(k, device=x.device)))
        mus = sample("mus", dist.Normal(0.0, 5.0).expand((k, d)).to_event(2))
        sigma = sample("sigma",
                       dist.HalfNormal(2.0).expand((k,)).to_event(1))
        comps = dist.Independent(dist.Normal(mus, sigma[:, None]), 1)
        mix = dist.MixtureSameFamily(dist.Categorical(probs=w), comps)
        sample("obs", mix.expand((x.shape[0],)).to_event(1), obs=x)

    return model


def make_batched_loglik(info, unravel, x):
    """The likelihood of flat particles through ``gmm_loglik`` (forward
    kernel; autograd runs its backward kernel)."""
    from ..ops.gmm_logprob import gmm_loglik

    t_w, t_s = info.transforms["weights"], info.transforms["sigma"]

    def loglik(qs):
        u = unravel(qs)
        return gmm_loglik(x, torch.log(t_w.forward(u["weights"])), u["mus"],
                          t_s.forward(u["sigma"]))

    return loglik


def make_batched_loglik_grad(info, unravel, ravel, x):
    """Value and gradient of the likelihood at flat UNCONSTRAINED
    particles: the value+grad kernel gives (ll, d/dlog w, d/dmus, d/dsig)
    in one launch and autograd pulls the gradient back through the
    transforms (the JAX package uses ``jax.vjp``)."""
    from ..ops.gmm_logprob import gmm_loglik_grad

    t_w, t_s = info.transforms["weights"], info.transforms["sigma"]

    def loglik_vg(qs):
        u = unravel(qs)
        uw = u["weights"].detach().requires_grad_()
        us = u["sigma"].detach().requires_grad_()
        with torch.enable_grad():
            logw, sig = torch.log(t_w.forward(uw)), t_s.forward(us)
        ll, dlogw, dmus, dsig = gmm_loglik_grad(x, logw.detach(),
                                                u["mus"], sig.detach())
        duw, dus = torch.autograd.grad((logw, sig), (uw, us), (dlogw, dsig))
        return ll, ravel({"weights": duw, "mus": dmus, "sigma": dus})

    return loglik_vg


def make_batched_mutation(cfg: Config, x, target_accept=0.65,
                          particle_sharding=None):
    """The whole-stage fused mutation (``ops/fused_smc_gmm``) as SMC's
    ``batched_mutation``."""
    from ..ops.fused_smc_gmm import make_batched_mutation as _mk

    return _mk(x, cfg.num_components, cfg.data_dim, kmut=cfg.mutation_steps,
               lsteps=cfg.leapfrog_steps, target_accept=target_accept,
               particle_sharding=particle_sharding)


def make_smc(cfg: Config, x, mode, particle_sharding=None, **smc_kwargs):
    """The SMC sampler of one mode (``MODES``) on x's device, its particles
    split over ``particle_sharding``'s axis when given."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    kw = dict(num_particles=cfg.num_particles,
              mutation_steps=cfg.mutation_steps,
              hmc_leapfrog_steps=cfg.leapfrog_steps, device=x.device,
              particle_sharding=particle_sharding)
    kw.update(smc_kwargs)
    model = make_model(cfg, x)
    smc = SMC(model, **kw)
    if mode == "generic":
        return smc
    hooks = {"batched_loglik": make_batched_loglik(smc.info, smc._unravel, x)}
    if mode == "kernels":
        hooks["batched_loglik_grad"] = make_batched_loglik_grad(
            smc.info, smc._unravel, smc._ravel, x)
    elif mode == "fused":
        hooks = {"batched_mutation": make_batched_mutation(
            cfg, x, kw.get("target_accept", 0.65), particle_sharding)}
    return SMC(model, **kw, **hooks)


def _true_loglik(x, truth):
    from scipy.stats import multivariate_normal
    xn = np.asarray(x)
    dens = np.zeros(xn.shape[0])
    for wk, ck, sk in zip(truth["weights"], truth["centers"],
                          truth["scales"]):
        dens += wk * multivariate_normal(
            ck, sk**2 * np.eye(xn.shape[1])
        ).pdf(xn)
    return float(np.log(dens).mean())


def predictive_loglik(res, x, cfg, num_particles_eval=256):
    """Label-invariant check: the posterior-averaged predictive density
    of the ``num_particles_eval`` heaviest particles, mean over x."""
    w = torch.exp(res.log_weights)
    idx = torch.argsort(-w)[:num_particles_eval]
    ws = w[idx] / w[idx].sum()
    mus = res.particles["mus"][idx][:, None]                # (P, 1, K, D)
    sig = res.particles["sigma"][idx][:, None, :, None]     # (P, 1, K, 1)
    pw = res.particles["weights"][idx][:, None]             # (P, 1, K)
    comps = dist.Independent(dist.Normal(mus, sig), 1)
    mix = dist.MixtureSameFamily(dist.Categorical(probs=pw), comps)
    lps = mix.log_prob(x)                                   # (P, N)
    avg = torch.logsumexp(lps + torch.log(ws)[:, None], 0)
    return float(avg.mean())


def run(cfg: Config, seed=None, particle_sharding=None):
    """One SMC fit on ``cfg.device`` in ``cfg.mode``; ``seed`` (an int or
    a ``torch.Generator``) defaults to ``cfg.seed``.  Under
    ``particle_sharding`` the result holds this rank's particles, and the
    predictive check gathers the whole final population once."""
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, num_data=200, num_particles=512,
                                  mutation_steps=2, leapfrog_steps=3)
    device = torch.device(cfg.device)
    mode = cfg.mode or ("kernels" if device.type == "cuda" else "generic")
    xn, truth = make_data(cfg)
    x = torch.as_tensor(xn, device=device)
    smc = make_smc(cfg, x, mode, particle_sharding)
    seed = cfg.seed if seed is None else seed
    if cfg.bench:
        res, dt = timed_steps(lambda: smc.run(seed))
        bench_line("smc_particles_per_s",
                   cfg.num_particles * res.num_stages / dt,
                   "particle-stages/s", model="gmm", mode=mode,
                   particles=cfg.num_particles, stages=res.num_stages,
                   device=str(device))
    else:
        res = smc.run(seed)
    pred = predictive_loglik(res if particle_sharding is None else
                             gather_particles(res, particle_sharding), x, cfg)
    ref = _true_loglik(xn, truth)
    return {
        "pred_loglik": pred,
        "true_loglik": ref,
        "gap": ref - pred,
        "log_evidence": float(res.log_evidence),
        "num_stages": res.num_stages,
        "accept_rate": float(res.accept_rate),
        "mode": mode,
        "result": res,
        "smc": smc,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"posterior predictive loglik = {out['pred_loglik']:.3f} "
          f"(true-model {out['true_loglik']:.3f}, gap {out['gap']:.3f})")
    print(f"mode {out['mode']}: logZ = {out['log_evidence']:.1f}, stages = "
          f"{out['num_stages']}, accept = {out['accept_rate']:.2f}")


if __name__ == "__main__":
    main()
