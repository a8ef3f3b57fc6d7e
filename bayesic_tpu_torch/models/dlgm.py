"""Example 5 — deep latent Gaussian model (DLGM) with a VAE-style amortized
guide, and NUTS over the local latents under the trained decoder.

Counterpart of ``bayesic_tpu/models/dlgm.py``.  Two entry points train the
same model with the same estimator:

* ``run_svi``: the generic engine — DSL model -> ``build_logjoint`` ->
  ``SVI`` + ``NeuralGuide`` -> STL ELBO -> Adam, one Python step at a time.
* ``run_svi_fused``: ``ops/fused_vae.fused_train``, which on a GPU runs all
  steps in the hand-written kernel.

Two entry points sample the local posterior of z for a batch of rows:

* ``local_posterior_mcmc``: DSL model -> ``build_logjoint`` -> ``MCMC`` ->
  the batched NUTS core, one Python leaf at a time.
* ``local_posterior_mcmc_fused``: the same ``MCMC`` sampler with its
  ``batched_transition`` hook running ``ops/fused_nuts``, which on a GPU
  runs each whole transition of every chain in one kernel launch.

``run_svi(data_sharding=)`` splits the rows over a mesh axis;
``run_svi(model_sharding=)`` splits the decoder's two kernels by output
units over the ``"model"`` axis (``sharded_decoder``), JAX's ``P(None,
"model")`` on the flax kernels.

``Config.compute_dtype = "bfloat16"`` runs the decoder's and encoder's
dense layers in bf16 (flax ``Dense(dtype=)`` semantics; the parameters stay
float32) in ``run_svi``.  As in the JAX package, ``run_svi_fused`` does not
read it: the fused trainer takes ``compute_dtype`` as its own argument.

Run: ``python -m bayesic_tpu_torch.models.dlgm --smoke true --device cuda``
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.nn import functional as F

from .. import dist
from ..core import param, plate, sample
from ..dist import constraints
from ..infer.mcmc import MCMC
from ..infer.svi import SVI, Adam, NeuralGuide
from ..ops import fused_vae as fv
from ..ops.fused_nuts import make_batched_transition
from ..parallel.mesh import (axis_index, axis_size, enter, gather,
                             local_slice, psum)
from ..parallel.tp import shard_params
from ..utils import diagnostics as diag
from ..utils.config import dump_config, parse_config
from ..utils.metrics import named_scope
from .common import bench_line, timed_steps

_LOG_2PI = math.log(2.0 * math.pi)
# stddev of a standard normal truncated to [-2, 2]: flax's lecun_normal
# divides by it so the truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class Config:
    num_data: int = 10_000
    data_dim: int = 32
    latent_dim: int = 8
    hidden: int = 64
    batch_size: int = 256
    steps: int = 3000
    lr: float = 1e-3
    seed: int = 0
    # NUTS variant
    num_chains: int = 64
    nuts_batch: int = 4
    num_warmup: int = 300
    num_samples: int = 300
    smoke: bool = False
    bench: bool = False
    device: str = "cuda"
    compute_dtype: str = "float32"   # "bfloat16": the MLPs' products in bf16


def _lecun_init(layer: nn.Linear, generator):
    """flax ``Dense`` init: lecun-normal kernel (truncated normal with
    variance 1/fan_in), zero bias."""
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        layer.weight.mul_(1.0 / (math.sqrt(layer.in_features) * _TRUNC_STD))
        layer.bias.zero_()


def _dense(layer, x, dtype):
    """flax ``Dense(dtype=)``: input, kernel and bias cast to ``dtype``,
    the product and the bias add in it; the parameters stay float32."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class Decoder(nn.Module):
    """z -> tanh(Dense_0) -> Dense_1 (submodule names follow flax).
    ``dtype``: the layers' compute dtype (``torch.bfloat16`` keeps the
    hidden activations in bf16); the output is float32."""

    def __init__(self, latent_dim, hidden, data_dim, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(latent_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, data_dim)
        if generator is not None:
            _lecun_init(self.Dense_0, generator)
            _lecun_init(self.Dense_1, generator)

    def forward(self, z):
        h = torch.tanh(_dense(self.Dense_0, z, self.dtype))
        return _dense(self.Dense_1, h, self.dtype).to(torch.float32)


def decoder_kernels(path, leaf):
    """``shard_params`` / ``gather_params``'s ``select`` for the DLGM's
    ``"model"`` split: the decoder's two 2-D kernels, in the SVI params and
    in their Adam moments."""
    return "decoder" in path and leaf.dim() == 2


def sharded_decoder(params, z, sharding, dtype=torch.float32):
    """The ``Decoder``'s forward with ``Dense_0.weight`` and
    ``Dense_1.weight`` split by rows (output units) over the axis of
    ``sharding`` (``(mesh, axis)``; each rank's slice in ``params``, the
    biases whole).  ``z`` is replicated; the result, the whole mu, is the
    same on every rank:

        h_r  = tanh(enter(z) W0_r^T + b0[r])     this rank's hidden units
        h    = enter(gather(h_r))                every hidden unit
        mu   = gather(h W1_r^T + b1[r])          every output column

    A replicated bias is used by its slice through ``enter``, so its
    gradient, like ``z``'s and ``h``'s, is the sum of the ranks' parts and
    the same on every rank.  ``dtype`` as ``Decoder``'s: the gathers move
    float32 (bf16 to float32 and back is exact)."""
    mesh, axis = sharding
    index = axis_index(mesh, axis)
    w0, w1 = params["Dense_0.weight"], params["Dense_1.weight"]

    def bias(name, n):
        return enter(params[name], mesh, axis).narrow(0, index * n, n)

    h = torch.tanh(F.linear(enter(z, mesh, axis).to(dtype), w0.to(dtype),
                            bias("Dense_0.bias", w0.shape[0]).to(dtype)))
    h = enter(gather(h.to(torch.float32), mesh, axis, dim=-1), mesh, axis)
    mu = F.linear(h.to(dtype), w1.to(dtype),
                  bias("Dense_1.bias", w1.shape[0]).to(dtype))
    return gather(mu.to(torch.float32), mesh, axis, dim=-1)


class Encoder(nn.Module):
    """x -> tanh(Dense_0) -> (mu = Dense_1, clip(Dense_2, -6, 3)).
    ``dtype`` as the ``Decoder``'s; mu and the log-scale are cast to
    float32 before the clip."""

    def __init__(self, data_dim, hidden, latent_dim, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(data_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, latent_dim)
        self.Dense_2 = nn.Linear(hidden, latent_dim)
        if generator is not None:
            for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
                _lecun_init(layer, generator)

    def forward(self, x):
        h = torch.tanh(_dense(self.Dense_0, x, self.dtype))
        mu = _dense(self.Dense_1, h, self.dtype).to(torch.float32)
        log_sigma = _dense(self.Dense_2, h, self.dtype).to(torch.float32)
        return mu, torch.clamp(log_sigma, -6.0, 3.0)


def _params_of(module, device):
    return {k: p.detach().to(device) for k, p in module.named_parameters()}


def make_data(cfg: Config):
    """Synthetic data from a random ground-truth DLGM (numpy float32; the
    same recipe as the JAX package, so both make identical data)."""
    rng = np.random.default_rng(cfg.seed)
    w1 = rng.normal(0, 1, (cfg.latent_dim, cfg.hidden)) / np.sqrt(
        cfg.latent_dim)
    w2 = rng.normal(0, 1, (cfg.hidden, cfg.data_dim)) / np.sqrt(cfg.hidden)
    z = rng.normal(0, 1, (cfg.num_data, cfg.latent_dim))
    x = np.tanh(z @ w1) @ w2 + rng.normal(0, 0.3, (cfg.num_data,
                                                   cfg.data_dim))
    return x.astype(np.float32)


def make_model_and_guide(cfg: Config, x, rows=None, model_sharding=None):
    """Model and amortized guide on ``x``'s device.  The decoder init is
    drawn from a CPU generator seeded with ``cfg.seed``, so it does not
    depend on the device.

    ``model_sharding = (mesh, axis)``: the decoder param holds this rank's
    slice of its two kernels (``decoder_kernels``) and the model runs
    ``sharded_decoder``; every other value is replicated, and the model,
    the guide and the loss are the unsharded ones on every rank.

    ``rows = (lo, hi)``: ``x`` holds only the global rows lo..hi-1 of
    ``cfg.num_data`` (one rank's shard).  The plate still draws the global
    mini-batch (every rank the same indices and the same guide noise), and
    the model and guide evaluate the batch positions whose rows fall in the
    shard, at the global scale N / B: summed over the ranks, the ELBO and
    its gradient are the unsharded ones, row for row."""
    device = x.device
    if rows is not None and model_sharding is not None:
        raise ValueError("make_model_and_guide: rows= and model_sharding= "
                         "cannot be combined")
    n = int(x.shape[0]) if rows is None else int(cfg.num_data)
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {cfg.compute_dtype!r}")
    cdtype = getattr(torch, cfg.compute_dtype)
    dec = Decoder(cfg.latent_dim, cfg.hidden, cfg.data_dim,
                  torch.Generator().manual_seed(cfg.seed),
                  dtype=cdtype).to(device)
    enc = Encoder(cfg.data_dim, cfg.hidden, cfg.latent_dim,
                  dtype=cdtype).to(device)
    dec_init = _params_of(dec, device)
    if model_sharding is None:
        def decode(dec_params, z):
            return functional_call(dec, dec_params, (z,))
    else:
        dec_init = shard_params({"decoder": dec_init}, *model_sharding,
                                decoder_kernels)["decoder"]

        def decode(dec_params, z):
            return sharded_decoder(dec_params, z, model_sharding, cdtype)
    b = cfg.batch_size
    scale = n / b

    def local(idx):
        """(positions in the batch, rows of x) of the batch's rows that
        ``x`` holds."""
        if rows is None:
            return None, idx
        pos = torch.nonzero((idx >= rows[0]) & (idx < rows[1])).reshape(-1)
        return pos, idx[pos] - rows[0]

    def model(xa):
        dec_params = param("decoder", init_value=dec_init)
        sigma_x = param("sigma_x",
                        init_value=torch.tensor(0.5, device=device),
                        constraint=constraints.positive)
        with plate("data", n, subsample_size=b) as idx:
            pos, r = local(idx)
            xb = xa[r]
            z = sample(
                "z", dist.Normal(0.0, 1.0).expand((xb.shape[0],
                                                   cfg.latent_dim))
                .to_event(2)
            )
            mu = decode(dec_params, z)
            sample("obs", dist.Normal(mu, sigma_x).to_event(2), obs=xb)

    def guide_init(generator):
        # draw the init on the CPU from a seed taken off ``generator``, so
        # a CUDA generator gives the same kind of init as a CPU one
        s = int(torch.randint(0, 2**62, (1,), generator=generator,
                              device=generator.device).item())
        e = Encoder(cfg.data_dim, cfg.hidden, cfg.latent_dim,
                    torch.Generator().manual_seed(s))
        return _params_of(e, device)

    def guide_sample(params, generator, sample_shape, stop_gradient_q, ctx):
        sub = (ctx or {}).get("subsample") or {}
        idx = sub.get("data__idx")
        if idx is None:
            idx = torch.arange(b, device=device)
        margs = (ctx or {}).get("model_args")
        xa = margs[0] if margs else x
        pos, r = local(idx)
        mu, log_sig = functional_call(enc, params, (xa[r],))   # (rows, dz)
        # the whole batch's noise, so every shard draws the same
        shape = tuple(sample_shape) + (idx.shape[0], cfg.latent_dim)
        eps = (ctx or {}).get("eps")
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=generator.device)
        else:
            eps = eps.expand(shape)
        if pos is not None:
            eps = eps[..., pos, :]
        z = mu + torch.exp(log_sig) * eps
        if stop_gradient_q:
            mu_q, log_sig_q = mu.detach(), log_sig.detach()
        else:
            mu_q, log_sig_q = mu, log_sig
        zz = (z - mu_q) * torch.exp(-log_sig_q)
        logq = torch.sum(-0.5 * zz * zz - log_sig_q - 0.5 * _LOG_2PI,
                         dim=(-2, -1))
        # match the model-side N/B plate scaling (unbiased mini-batch ELBO)
        return {"z": z}, scale * logq

    return model, NeuralGuide(guide_init, guide_sample), dec, enc


def run_svi(cfg: Config, generator=None, data_sharding=None,
            model_sharding=None):
    """Generic-engine SVI on ``cfg.device``.  ``generator`` (on that device)
    drives the mini-batches, the noise and the encoder init.

    ``data_sharding`` (a ``parallel.mesh.Sharding``, or ``(mesh, axis)``)
    shards the rows over the mesh axis: each rank holds its
    ``local_slice`` of them, draws the same global mini-batches and noise
    from a generator seeded alike, evaluates the batch rows it holds, and
    the gradients are all-reduced before Adam; the losses are the global
    ones.  Without it, one process trains on every row.

    ``model_sharding`` (a ``Sharding`` or ``(mesh, axis)``) splits the
    decoder's two kernels by output units over the axis
    (``make_model_and_guide``): each rank trains its slices, and the
    losses and every other parameter are the unsharded run's on every
    rank.  The result's decoder kernels (in ``decoder_params`` and
    ``result``) stay this rank's slices; ``parallel.tp.gather_params``
    with ``decoder_kernels`` gathers them."""
    device = torch.device(cfg.device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(cfg.seed)
    x = make_data(cfg)
    rows, grad_transform = None, None
    if data_sharding is not None:
        mesh, axis = data_sharding
        start, per = local_slice(cfg.num_data, axis_size(mesh, axis),
                                 axis_index(mesh, axis))
        rows, x = (start, start + per), x[start:start + per]

        def grad_transform(grads):
            return psum(grads, mesh, axis)
    x = torch.as_tensor(x, device=device)
    model, guide, dec, enc = make_model_and_guide(cfg, x, rows,
                                                  model_sharding)
    svi = SVI(model, guide, Adam(cfg.lr), model_args=(x,), device=device,
              grad_transform=grad_transform)

    if cfg.bench:
        state = svi.init(gen)
        _, dt = timed_steps(
            lambda s: svi.run(gen, cfg.steps, state=s, model_args=(x,)),
            state,
        )
        bench_line("elbo_steps_per_s", cfg.steps / dt, "steps/s",
                   model="dlgm", n=cfg.num_data, batch=cfg.batch_size,
                   device=str(device))
    res = svi.run(gen, cfg.steps, model_args=(x,))
    if data_sharding is not None:
        res = res._replace(losses=psum(res.losses, *data_sharding))
    mp = svi.model_params(res.params)
    losses = res.losses.cpu().numpy()
    return {
        "svi": svi,
        "result": res,
        "x": x,
        "decoder": dec,
        "encoder": enc,
        "decoder_params": mp["decoder"],
        "sigma_x": float(mp["sigma_x"]),
        "final_elbo": -float(losses[-1]),
        "losses": losses,
        "guide_params": svi.guide_params(res.params),
    }


def fused_init(cfg: Config, generator, device="cpu"):
    """Fused-trainer leaves (ops/fused_vae.LEAVES layout), drawn as the JAX
    package's ``fused_init`` draws them (truncated-normal kernels scaled by
    1/sqrt(fan_in), zero biases, sigma_x = 0.5) from a CPU ``generator``,
    then moved to ``device``."""
    shapes = fv.leaf_shapes(
        fv.FusedVAEDims(cfg.num_data, cfg.data_dim, cfg.hidden,
                        cfg.latent_dim, cfg.batch_size))
    params, m, v = {}, {}, {}
    for name in fv.LEAVES:
        s = shapes[name]
        if name == "usig":
            p = torch.full(s, math.log(0.5))
        elif name.startswith("w"):
            p = torch.empty(s)
            nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            p = p / math.sqrt(s[0])
        else:
            p = torch.zeros(s)
        params[name] = p.to(device)
        m[name] = torch.zeros(s, device=device)
        v[name] = torch.zeros(s, device=device)
    return params, m, v


def fused_to_torch(params):
    """Fused decoder leaves -> the ``Decoder``'s parameter dict (for
    ``functional_call``), so reconstruction works on fused-trained
    parameters.  Fused kernels are (in, out); ``nn.Linear`` is (out, in)."""
    return {
        "Dense_0.weight": params["w1d"].T.contiguous(),
        "Dense_0.bias": params["b1d"][0],
        "Dense_1.weight": params["w2d"].T.contiguous(),
        "Dense_1.bias": params["b2d"][0],
    }


def run_svi_fused(cfg: Config, generator=None):
    """Same model, same estimator, one ``fused_train`` call for all
    ``cfg.steps`` steps on ``cfg.device``.  ``generator`` is a CPU generator
    for the init and the kernel's Philox seed."""
    device = torch.device(cfg.device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    x = torch.as_tensor(make_data(cfg), device=device)
    params, m, v = fused_init(cfg, gen, device)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen).item())
    params, m, v, losses = fv.fused_train(
        x, params, m, v, steps=cfg.steps, lr=cfg.lr, seed=seed,
        batch=cfg.batch_size)
    losses = losses.cpu().numpy()
    return {
        "x": x,
        "params": params,
        "decoder_params": fused_to_torch(params),
        "sigma_x": float(torch.exp(params["usig"][0, 0])),
        "final_elbo": -float(losses[-1]),
        "losses": losses,
        "opt_state": (m, v),
    }


def local_posterior_model(cfg: Config, dec, dec_params, sigma_x, x_batch):
    """The model of z for the rows of ``x_batch`` under a fixed decoder:
    z ~ N(0, I) (nb, latent), x ~ N(dec(z), sigma_x)."""
    nb = int(x_batch.shape[0])

    def model():
        z = sample(
            "z", dist.Normal(0.0, 1.0).expand((nb, cfg.latent_dim))
            .to_event(2)
        )
        mu = functional_call(dec, dec_params, (z,))
        sample("obs", dist.Normal(mu, sigma_x).to_event(2), obs=x_batch)

    return model


def local_posterior_mcmc(cfg: Config, dec, dec_params, sigma_x, x_batch,
                         seed, chain_sharding=None, shared_adapt=None):
    """NUTS over the local latents z of ``x_batch``'s rows for a fixed
    decoder: the many-chain workload of the DLGM, on ``x_batch``'s device.
    Returns ``(mcmc, result)``.  ``chain_sharding`` (a
    ``parallel.mesh.Sharding`` or ``(mesh, axis)``) splits the chains over
    the mesh axis; the result then holds this rank's chains."""
    if shared_adapt is None:
        # pooled adaptation is the right default once chains are many
        shared_adapt = cfg.num_chains >= 64
    mcmc = MCMC(local_posterior_model(cfg, dec, dec_params, sigma_x, x_batch),
                num_warmup=cfg.num_warmup, num_samples=cfg.num_samples,
                num_chains=cfg.num_chains, init_step_size=0.2,
                shared_adapt=shared_adapt, chain_sharding=chain_sharding,
                device=x_batch.device)
    return mcmc, mcmc.run(seed)


def local_posterior_mcmc_fused(cfg: Config, dec, dec_params, sigma_x,
                               x_batch, *, max_doublings=6, run_seed=None,
                               chain_sharding=None):
    """The same workload through ``ops/fused_nuts``: the same model density
    and ``MCMC`` sampler (pooled adaptation, Welford windows, diagnostics),
    with each transition of every chain in one kernel launch on a GPU.
    Returns the ``MCMC`` object, or ``(mcmc, mcmc.run(run_seed))``.
    ``chain_sharding`` splits the chains over a mesh axis: each rank
    launches the kernel on its own chains, which draw their streams by
    their global indices (the kernel's chain base).

    The JAX function's ``block_chains``, ``mm_dtype`` and ``interpret``
    are not ported: the kernel runs one thread block per chain, so there
    is no chain block to size; every product is fp32, so there is no
    precision split to choose; and a CPU tensor runs the plain version, so
    no interpret mode is needed."""
    with named_scope("bayesic.models.dlgm.local_posterior_mcmc_fused"):
        chain0 = 0
        if chain_sharding is not None:
            mesh, axis = chain_sharding
            chain0 = local_slice(cfg.num_chains, axis_size(mesh, axis),
                                 axis_index(mesh, axis))[0]
        bt = make_batched_transition(dec_params, float(sigma_x), x_batch,
                                     max_doublings=max_doublings,
                                     chain0=chain0)
        mcmc = MCMC(local_posterior_model(cfg, dec, dec_params, sigma_x,
                                          x_batch),
                    num_warmup=cfg.num_warmup, num_samples=cfg.num_samples,
                    num_chains=cfg.num_chains, init_step_size=0.2,
                    shared_adapt=True, batched_transition=bt,
                    chain_sharding=chain_sharding, device=x_batch.device)
    if run_seed is not None:
        return mcmc, mcmc.run(run_seed)
    return mcmc


def run(cfg: Config, generator=None):
    if cfg.smoke:
        cfg = dataclasses.replace(
            cfg, num_data=512, data_dim=8, latent_dim=3, hidden=16,
            batch_size=64, steps=300, num_chains=8, num_warmup=100,
            num_samples=100, nuts_batch=2,
        )
    out = run_svi(cfg, generator)
    # reconstruction check
    x = out["x"][:256]
    with torch.no_grad():
        mu_z, _ = functional_call(out["encoder"], out["guide_params"], (x,))
        recon = functional_call(out["decoder"], out["decoder_params"],
                                (mu_z,))
    out["recon_rmse"] = float(torch.sqrt(torch.mean((recon - x) ** 2)))

    # NUTS variant on a small batch
    _, mres = local_posterior_mcmc(
        cfg, out["decoder"], out["decoder_params"], out["sigma_x"],
        out["x"][:cfg.nuts_batch], cfg.seed + 1,
    )
    z = mres.samples["z"]
    out["nuts_min_ess"] = float(torch.min(
        diag.ess(z.reshape(z.shape[0], z.shape[1], -1))))
    out["nuts_divergences"] = int(mres.extra["diverging"].sum())
    return out


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"final ELBO = {out['final_elbo']:.1f}")
    print(f"sigma_x = {out['sigma_x']:.3f} (true 0.3)")
    print(f"recon RMSE = {out['recon_rmse']:.3f}")
    print(f"NUTS z-posterior: min ESS = {out['nuts_min_ess']:.0f}, "
          f"divergences = {out['nuts_divergences']}")


if __name__ == "__main__":
    main()
