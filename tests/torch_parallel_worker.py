"""One rank of the gloo worlds that ``test_torch_parallel.py`` spawns, and
the inputs both sides build from seeds.

Run as ``python torch_parallel_worker.py MODE RANK WORLD INIT OUTDIR``:
MODE ``world`` runs every multi-rank case of the port's ``parallel``
layer in one world (``INIT`` a ``file://`` rendezvous) and writes this
rank's outputs to ``OUTDIR/rank{RANK}.npz``; the other modes read
``RANK``/``WORLD_SIZE``/``MASTER_*`` from the environment, as ``torchrun``
sets them: ``launcher`` runs the launcher, desync and checkpoint cases,
``crash`` checkpoints a run and then loses rank 1 (exit code 17), and
``resume`` restarts from that checkpoint in ``OUTDIR``.  It imports torch
and the port only.  The test module imports the recipes.
"""

from __future__ import annotations

import os
import sys
import traceback
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TIMEOUT = 60            # seconds: every collective of a spawned world
WORLD = 4               # ranks of the main world
LAUNCHER_WORLD = 2

# dp_svi_run: the linear model of the JAX test_sharding.py
LIN_N, LIN_STEPS, LIN_LR = 256, 200, 0.05
# dlgm.run_svi(data_sharding=)
DLGM = dict(num_data=2048, data_dim=32, latent_dim=8, hidden=64,
            batch_size=128, steps=50, device="cpu")
# the hier trainer: 4,096 shuffled rows (the JAX test_dp_fused.py shape)
HIER_ROWS, HIER_REP_STEPS = 4096, 50
HIER_SEGMENTS, HIER_SPS = 300, 10
# the VAE trainer under segment averaging (JAX test_vae_segment_...)
VAE = dict(num_data=2048, data_dim=32, latent_dim=8, hidden=64,
           batch_size=128)
VAE_SEGMENTS, VAE_SPS = 4, 60
# chain-sharded MCMC: the JAX test_sharding.py model, 8 chains
MCMC_CHAINS, MCMC_SHORT, MCMC_LONG = 8, 5, 150
# chain-sharded fused NUTS on the CPU path: a tiny decoder
FNUTS = dict(num_data=64, data_dim=6, latent_dim=2, hidden=8,
             num_chains=8, num_warmup=5, num_samples=5, device="cpu")
FNUTS_ROWS = 3
# the launcher world: dp_svi_run on 64 rows, a checkpoint at LAUNCH_SAVE
LAUNCH_N, LAUNCH_STEPS, LAUNCH_SAVE = 64, 200, 100
CRASH_CODE = 17         # the exit code of the rank that the crash loses
# systematic_resample_shard_map: the JAX test's 64 particles (log-weights
# and payloads from RES_SEED), and 2^20 by the ring; RES_U0 is the JAX
# test's jax.random.uniform(PRNGKey(1)) as a float32
RES_N, RES_BIG, RES_SEED, RES_U0 = 64, 1 << 20, 5, 0.4386324882507324
# SMC(particle_sharding=): the JAX test_sharding.py model at 512 particles
# and test_multihost.py's at 128 with ess_target and the resampling
# threshold 0.9
SMC_CASES = {"sharding": dict(num_particles=512),
             "multihost": dict(num_particles=128, ess_target=0.9,
                               resample_threshold=0.9)}
# gmm.run(particle_sharding=) at the smoke size
GMM_MODES = ("generic", "fused", "split")
# the dense MF objective: the JAX test_mf_dense_sharded.py config, 64 items
# a rank at 4 ranks
MF = dict(num_users=512, num_items=256, num_factors=8, num_ratings=40_000,
          steps=300, lr=0.05, device="cpu")
# make_data from a file: a count that 4 ranks do not divide
MF_FILE = dict(num_users=50, num_items=30, num_factors=4, num_ratings=10_001,
               device="cpu")


def linear_data(n=LIN_N, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n).astype(np.float32)
    y = (0.8 * x + 0.3 + rng.normal(0, 0.4, n)).astype(np.float32)
    return x, y


def linear_svi(x, y, device="cpu"):
    import torch

    from bayesic_tpu_torch import dist
    from bayesic_tpu_torch.core import sample
    from bayesic_tpu_torch.infer.svi import SVI, Adam, MeanFieldGuide

    def model(xa, ya):
        w = sample("w", dist.Normal(0.0, 2.0))
        b = sample("b", dist.Normal(0.0, 2.0))
        sample("obs", dist.Normal(w * xa + b, 0.4).to_event(1), obs=ya)

    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    return SVI(model, MeanFieldGuide, Adam(LIN_LR), model_args=(xt, yt),
               device=device), (xt, yt)


def hier_rows():
    """The hier bench data, shuffled once and cut to HIER_ROWS rows."""
    from bayesic_tpu_torch.models import hier_logistic as hl

    cfg = hl.Config()
    x, y, group, _ = hl.make_data(cfg)
    perm = np.random.default_rng(8).permutation(x.shape[0])[:HIER_ROWS]
    return cfg, x[perm], y[perm], group[perm]


def hier_local_train(n_total, batch, steps, lr0, lr_total):
    from bayesic_tpu_torch.ops import fused_hier as fh

    def local_train(data, state, seed, t0):
        loc, ls, opt = state
        loc, ls, opt, losses = fh.fused_train(
            *data, loc, ls, opt, steps=steps, lr0=lr0, lr_total=lr_total,
            seed=seed, batch=batch, t0=t0, n_total=n_total)
        return (loc, ls, opt), losses

    return local_train


def mcmc_data():
    return np.random.default_rng(1).normal(0.5, 1.0, 30).astype(np.float32)


def mcmc_model(yv):
    import torch

    from bayesic_tpu_torch import dist
    from bayesic_tpu_torch.core import sample

    yt = torch.as_tensor(yv)

    def model():
        mu = sample("mu", dist.Normal(0.0, 5.0))
        sample("obs", dist.Normal(mu, 1.0).expand((30,)).to_event(1), obs=yt)

    return model


def run_mcmc(n, shared_adapt, chain_sharding=None):
    from bayesic_tpu_torch.infer.mcmc import MCMC

    return MCMC(model=mcmc_model(mcmc_data()), num_warmup=n, num_samples=n,
                num_chains=MCMC_CHAINS, init_step_size=0.5,
                shared_adapt=shared_adapt, chain_sharding=chain_sharding,
                device="cpu").run(0)


def fnuts_inputs():
    """A random decoder and rows for the fused NUTS path's CPU version."""
    import torch

    from bayesic_tpu_torch.models import dlgm

    cfg = dlgm.Config(**FNUTS)
    dec = dlgm.Decoder(cfg.latent_dim, cfg.hidden, cfg.data_dim,
                       torch.Generator().manual_seed(3))
    dparams = {k: p.detach() for k, p in dec.named_parameters()}
    xb = torch.as_tensor(dlgm.make_data(cfg)[:FNUTS_ROWS])
    return cfg, dec, dparams, 0.3, xb


def resample_inputs(n=RES_N):
    """Log-weights (n,) and a payload {"x": (n, 3), "y": (n,)}."""
    rng = np.random.default_rng(RES_SEED)
    return (rng.normal(0, 1, n).astype(np.float32),
            {"x": rng.normal(0, 1, (n, 3)).astype(np.float32),
             "y": rng.normal(0, 1, n).astype(np.float32)})


def smc_model(case):
    """The SMC test models: mu ~ N(0, 3), 16 observations ~ N(mu, 1)."""
    import torch

    from bayesic_tpu_torch import dist
    from bayesic_tpu_torch.core import sample

    if case == "sharding":
        yv = np.random.default_rng(2).normal(1.0, 1.0, 16)
    else:
        yv = np.linspace(-0.5, 1.5, 16)
    yt = torch.as_tensor(yv.astype(np.float32))

    def model():
        mu = sample("mu", dist.Normal(0.0, 3.0))
        sample("obs", dist.Normal(mu, 1.0).expand((16,)).to_event(1), obs=yt)

    return model


def run_smc(case, particle_sharding=None):
    from bayesic_tpu_torch.infer.smc import SMC

    return SMC(smc_model(case), mutation_steps=2, hmc_leapfrog_steps=3,
               particle_sharding=particle_sharding, device="cpu",
               **SMC_CASES[case]).run(1)


def mf_params(cfg):
    """Dense guide params {site: (loc, log_scale)} as numpy, from a seed."""
    rng = np.random.default_rng(6)
    shapes = {"u": (cfg.num_users, cfg.num_factors),
              "v": (cfg.num_items, cfg.num_factors),
              "bu": (cfg.num_users,), "bi": (cfg.num_items,), "m": ()}
    loc0 = {"m": 3.0}
    return {k: ((loc0.get(k, 0.0) + rng.normal(0, 0.3, s))
                .astype(np.float32),
                rng.normal(-1.5, 0.3, s).astype(np.float32))
            for k, s in shapes.items()}


def toy_local_train(data_local, state, seed, t0):
    import torch

    return state + 1e-3, torch.zeros(4)


GUARD_CASES = {
    # name: (steps_per_segment, hierarchical_scales, allow_biased_segments)
    "raises": (20, True, False),
    "accepted": (20, True, True),
    "warns": (20, None, False),
    "short": (10, True, False),
    "declared_flat": (200, False, False),
}


# ---------------------------------------------------------------------------
# the main world's cases
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def _tree_np(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _tree_np(f"{prefix}/{k}", v, out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _tree_np(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = _np(tree)


def world_cases(rank, world, outdir):
    import torch

    from bayesic_tpu_torch.infer.mcmc import gather_chains
    from bayesic_tpu_torch.models import dlgm, linreg
    from bayesic_tpu_torch.ops import fused_hier as fh
    from bayesic_tpu_torch.ops import fused_vae as fv
    from bayesic_tpu_torch.parallel import dp_fused, dp_svi_run, make_mesh
    from bayesic_tpu_torch.parallel.mesh import (all_gather, local_slice,
                                                 pmax, ppermute, psum,
                                                 put_replicated, put_sharded,
                                                 shard_leading)

    out = {}
    data_mesh = make_mesh({"data": world})
    chain_mesh = make_mesh({"chain": -1})

    def shard(a):
        start, per = local_slice(a.shape[0], world, rank)
        return a[start:start + per]

    # the mesh's helpers
    a = torch.arange(world * 3.0).reshape(world, 3)
    out["mesh/put_sharded"] = _np(put_sharded({"a": a}, data_mesh,
                                              "data")["a"])
    out["mesh/put_replicated"] = _np(put_replicated(
        (torch.full((2,), float(rank)),), data_mesh)[0])
    out["mesh/pmax"] = _np(pmax(torch.tensor([float(rank)]), data_mesh,
                                "data"))
    out["mesh/all_gather"] = _np(all_gather(torch.tensor([rank]),
                                            data_mesh, "data"))
    tree = psum({"x": torch.ones(2), "y": (torch.full((1,), 2.0),)},
                data_mesh, "data")
    out["mesh/psum"] = _np(torch.cat([tree["x"], tree["y"][0]]))
    moved = ppermute({"a": torch.full((3,), float(rank)),
                      "b": torch.tensor([rank, rank])}, data_mesh, "data")
    out["mesh/ppermute/a"], out["mesh/ppermute/b"] = _np(moved["a"]), \
        _np(moved["b"])
    out["mesh/ppermute/back"] = _np(ppermute(moved["a"], data_mesh, "data",
                                             shift=1))

    # dp_gram on the JAX test's linreg shape
    x, y, _, _ = linreg.make_data(linreg.Config(n=4096, dim=16))
    out["dp_gram"] = _np(dp_fused.dp_gram(
        torch.as_tensor(shard(x)), torch.as_tensor(shard(y)), data_mesh))

    # dp_svi_run on the linear model
    x, y = linear_data()
    svi, _ = linear_svi(x, y)
    res = dp_svi_run(svi, data_mesh, torch.Generator().manual_seed(0),
                     (torch.as_tensor(shard(x)), torch.as_tensor(shard(y))),
                     LIN_STEPS)
    out["dp_svi/losses"] = _np(res.losses)
    _tree_np("dp_svi/params", res.params, out)

    # the DLGM's generic SVI with its rows sharded
    r = dlgm.run_svi(dlgm.Config(**DLGM),
                     generator=torch.Generator().manual_seed(0),
                     data_sharding=shard_leading(data_mesh, "data"))
    out["dlgm/losses"] = r["losses"]
    out["dlgm/sigma_x"] = np.float32(r["sigma_x"])
    _tree_np("dlgm/decoder", r["decoder_params"], out)

    # the hier trainer: replicated data, then real shards
    cfg, hx, hy, hg = hier_rows()
    rows = tuple(map(torch.as_tensor, (hx, hy, hg)))
    state0 = fh.init_params(cfg.num_groups, cfg.num_features)
    local = hier_local_train(HIER_ROWS, cfg.batch_size, HIER_REP_STEPS,
                             cfg.lr, HIER_REP_STEPS)
    st, losses = dp_fused.replicated_train(local, state0, rows, data_mesh,
                                           seed=5)
    out["hier_rep/losses"] = _np(losses)
    _tree_np("hier_rep/state", st, out)
    total = HIER_SEGMENTS * HIER_SPS
    local = hier_local_train(HIER_ROWS, cfg.batch_size, HIER_SPS, cfg.lr,
                             total)
    st, losses = dp_fused.segment_averaged_train(
        local, state0, tuple(shard(a) for a in rows), data_mesh,
        segments=HIER_SEGMENTS, steps_per_segment=HIER_SPS, seed=3,
        hierarchical_scales=True)
    out["hier_seg/losses"] = _np(losses)
    _tree_np("hier_seg/state", st, out)

    # the bias guard
    for name, (sps, hier, allow) in GUARD_CASES.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                st, _ = dp_fused.segment_averaged_train(
                    toy_local_train, torch.zeros(1, 128),
                    torch.zeros(16, 8), data_mesh, segments=1,
                    steps_per_segment=sps, hierarchical_scales=hier,
                    allow_biased_segments=allow)
                outcome = "ran" if bool(torch.isfinite(st).all()) \
                    else "non-finite"
            except ValueError as e:
                outcome = f"raised: {e}"
        out[f"guard/{name}/outcome"] = np.array(outcome)
        out[f"guard/{name}/warnings"] = np.array(
            [str(w.message) for w in caught
             if issubclass(w.category, UserWarning)] or [""])

    # the VAE trainer under segment averaging
    vcfg = dlgm.Config(**VAE)
    vx = torch.as_tensor(dlgm.make_data(vcfg))
    p, m, v = dlgm.fused_init(vcfg, torch.Generator().manual_seed(0))

    def vae_train(data, state, seed, t0):
        p_, m_, v_, losses_ = fv.fused_train(
            data, *state, steps=VAE_SPS, lr=vcfg.lr, seed=seed,
            batch=vcfg.batch_size, t0=t0, n_total=vcfg.num_data)
        return (p_, m_, v_), losses_

    _, losses = dp_fused.segment_averaged_train(
        vae_train, (p, m, v), shard(vx), data_mesh, segments=VAE_SEGMENTS,
        steps_per_segment=VAE_SPS, seed=1, hierarchical_scales=False)
    out["vae/losses"] = _np(losses)

    # chain-sharded MCMC, gathered for the comparison
    sharding = shard_leading(chain_mesh, "chain")
    for shared in (False, True):
        for n in (MCMC_SHORT, MCMC_LONG):
            res = run_mcmc(n, shared, sharding)
            out[f"local_chains/{shared}/{n}"] = _np(res.chains)
            full = gather_chains(res, sharding)
            out[f"mcmc/{shared}/{n}/q"] = _np(full.unconstrained)
            out[f"mcmc/{shared}/{n}/chains"] = _np(full.chains)
            out[f"mcmc/{shared}/{n}/diverging"] = _np(
                full.extra["diverging"])
            out[f"mcmc/{shared}/{n}/step_size"] = _np(
                full.extra["step_size"])

    # the fused NUTS path (its CPU version) with the chains sharded
    fcfg, dec, dparams, sig, xb = fnuts_inputs()
    _, res = dlgm.local_posterior_mcmc_fused(
        fcfg, dec, dparams, sig, xb, max_doublings=4, run_seed=5,
        chain_sharding=sharding)
    out["fnuts/q"] = _np(gather_chains(res, sharding).unconstrained)
    particle_cases(rank, world, out, outdir)
    return out


def particle_cases(rank, world, out, outdir):
    """The particle-sharded resampler, SMC and GMM, the item-sharded dense
    MF objective and the file-backed MF data."""
    import torch

    from bayesic_tpu_torch.infer.smc import gather_particles
    from bayesic_tpu_torch.models import gmm
    from bayesic_tpu_torch.models import matrix_fact as mf
    from bayesic_tpu_torch.parallel import make_mesh
    from bayesic_tpu_torch.parallel.mesh import local_slice, shard_leading
    from bayesic_tpu_torch.parallel.resample import \
        systematic_resample_shard_map

    pmesh = make_mesh({"particle": world})
    sharding = shard_leading(pmesh, "particle")

    def shard(a):
        start, per = local_slice(a.shape[0], world, rank)
        return a[start:start + per]

    lw, parts = resample_inputs()
    for routing in ("ring", "all_gather"):
        fn = systematic_resample_shard_map(pmesh, "particle", routing)
        got, anc = fn(RES_U0, torch.as_tensor(shard(lw)),
                      {k: torch.as_tensor(shard(v)) for k, v in parts.items()})
        out[f"resample/{routing}/anc"] = _np(anc)
        for k, v in got.items():
            out[f"resample/{routing}/{k}"] = _np(v)
    big = 3.0 * np.random.default_rng(RES_SEED).normal(0, 1, RES_BIG) \
        .astype(np.float32)
    fn = systematic_resample_shard_map(pmesh, "particle", "ring")
    got, anc = fn(RES_U0, torch.as_tensor(shard(big)),
                  torch.as_tensor(shard(np.arange(RES_BIG))))
    out["resample/big/anc"] = _np(anc)
    out["resample/big/routed"] = _np(got)

    for case in SMC_CASES:
        res = gather_particles(run_smc(case, sharding), sharding)
        out[f"smc/{case}/q"] = _np(res.unconstrained)
        out[f"smc/{case}/log_w"] = _np(res.log_weights)
        out[f"smc/{case}/log_z"] = _np(res.log_evidence)
        out[f"smc/{case}/stages"] = np.array(res.num_stages)
        out[f"smc/{case}/ancestors"] = _np(res.ancestors)

    for mode in GMM_MODES:
        r = gmm.run(gmm.Config(smoke=True, mode=mode, device="cpu"),
                    particle_sharding=sharding)
        full = gather_particles(r["result"], sharding)
        for k in ("gap", "log_evidence", "num_stages", "accept_rate"):
            out[f"gmm/{mode}/{k}"] = np.array(r[k])
        out[f"gmm/{mode}/q"] = _np(full.unconstrained)
        out[f"gmm/{mode}/ancestors"] = _np(full.ancestors)

    # the item-sharded dense MF objective: one value and gradient at
    # seeded params, then a run
    imesh = make_mesh({"items": world})
    cfg = mf.Config(**MF)
    users, items, ratings, _ = mf.make_data(cfg)
    start, per = local_slice(cfg.num_items, world, rank)
    cnt, rsum, sqsum, n = mf.dense_stats(users, items, ratings,
                                         cfg.num_users, cfg.num_items)
    cols = slice(start, start + per)
    params = {k: tuple(torch.as_tensor(a[cols] if k in ("v", "bi") else a)
                       for a in pair)
              for k, pair in mf_params(cfg).items()}
    loss_fn = mf.dense_neg_elbo_sharded(imesh, sqsum, n, cfg.noise)
    loss, grads = mf.dense_value_and_grad_sharded(
        loss_fn, params, cnt[:, cols].contiguous(),
        rsum[:, cols].contiguous(), imesh)
    out["mf/loss"] = _np(loss)
    _tree_np("mf/grads", grads, out)
    r = mf.run_dense_sharded(cfg, imesh, data=(users, items, ratings, None))
    out["mf/losses"] = r["losses"]
    out["mf/rmse"] = np.array(r["rmse"])

    # this rank's shard of a ratings file that the ranks write at once
    fcfg = mf.Config(**MF_FILE, data_file=os.path.join(outdir,
                                                       "ratings.btpr"))
    for k, a in zip(("users", "items", "ratings"), mf.make_data(fcfg)[:3]):
        out[f"file/{k}"] = a


# ---------------------------------------------------------------------------
# the launcher world: torchrun's variables, desync, checkpoint and resume
# ---------------------------------------------------------------------------

def launcher_cases(rank, world, outdir):
    import torch

    from bayesic_tpu_torch.parallel import dp_svi_run, make_mesh
    from bayesic_tpu_torch.parallel.launcher import (DesyncError,
                                                     check_replicated_sync,
                                                     host_shard, is_primary,
                                                     replicated_fingerprint)
    from bayesic_tpu_torch.utils import checkpoint as ckpt

    mesh = make_mesh({"data": world})
    x, y = linear_data(LAUNCH_N, seed=0)
    svi, _ = linear_svi(x, y)
    local = (torch.as_tensor(host_shard(x)), torch.as_tensor(host_shard(y)))

    def gen():
        return torch.Generator().manual_seed(0)

    out = {"primary": np.array(is_primary())}
    res = dp_svi_run(svi, mesh, gen(), local, LAUNCH_STEPS)
    out["sync"] = np.array(check_replicated_sync(res.params))
    out["fingerprint"] = np.array(replicated_fingerprint(res.params),
                                  dtype=np.int64)
    out["losses"] = _np(res.losses)

    perturbed = {k: v.clone() for k, v in res.params.items()}
    if rank == 1:
        perturbed["loc"][0] += 1e-6
    try:
        check_replicated_sync(perturbed)
        out["desync"] = np.array("no error")
    except DesyncError as e:
        out["desync"] = np.array(f"DesyncError: {e}")

    path = os.path.join(outdir, "svi.npz")
    half = dp_svi_run(svi, mesh, gen(), local, LAUNCH_SAVE)
    ckpt.save_multihost(path, half.state)
    state = ckpt.restore(path, svi.init(torch.Generator().manual_seed(99)))
    resumed = dp_svi_run(svi, mesh, None, local, LAUNCH_STEPS - LAUNCH_SAVE,
                         state=state)
    out["resumed_fingerprint"] = np.array(
        replicated_fingerprint(resumed.params), dtype=np.int64)
    out["resumed_losses"] = np.concatenate([_np(half.losses),
                                            _np(resumed.losses)])
    out["resumed_step"] = np.array(resumed.state.step)
    return out


def crash_case(rank, outdir):
    """The launcher world's run up to its checkpoint, then rank 1 exits at
    once after the checkpoint's barrier; rank 0 goes on and fails at the
    next collective."""
    import torch

    from bayesic_tpu_torch.parallel import dp_svi_run, make_mesh
    from bayesic_tpu_torch.parallel.launcher import host_shard
    from bayesic_tpu_torch.utils import checkpoint as ckpt

    mesh = make_mesh()
    x, y = linear_data(LAUNCH_N, seed=0)
    svi, _ = linear_svi(x, y)
    local = (torch.as_tensor(host_shard(x)), torch.as_tensor(host_shard(y)))
    half = dp_svi_run(svi, mesh, torch.Generator().manual_seed(0), local,
                      LAUNCH_SAVE)
    ckpt.save_multihost(os.path.join(outdir, "svi.npz"), half.state)
    if rank == 1:
        os._exit(CRASH_CODE)
    dp_svi_run(svi, mesh, None, local, LAUNCH_STEPS - LAUNCH_SAVE,
               state=half.state)
    return {}


def resume_case(outdir):
    """A restart with the same world size from the crashed run's
    checkpoint, to the end of the launcher world's run."""
    import torch

    from bayesic_tpu_torch.parallel import dp_svi_run, make_mesh
    from bayesic_tpu_torch.parallel.launcher import (check_replicated_sync,
                                                     host_shard,
                                                     replicated_fingerprint)
    from bayesic_tpu_torch.utils import checkpoint as ckpt

    mesh = make_mesh()
    x, y = linear_data(LAUNCH_N, seed=0)
    svi, _ = linear_svi(x, y)
    local = (torch.as_tensor(host_shard(x)), torch.as_tensor(host_shard(y)))
    state = ckpt.restore(os.path.join(outdir, "svi.npz"),
                         svi.init(torch.Generator().manual_seed(99)))
    res = dp_svi_run(svi, mesh, None, local, LAUNCH_STEPS - LAUNCH_SAVE,
                     state=state)
    return {"sync": np.array(check_replicated_sync(res.params)),
            "fingerprint": np.array(replicated_fingerprint(res.params),
                                    dtype=np.int64),
            "losses": _np(res.losses), "step": np.array(res.state.step)}


def main(argv):
    mode, rank, world, init, outdir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    from bayesic_tpu_torch.parallel.launcher import initialize

    try:
        if mode == "world":
            initialize(init_method=init, world_size=world, rank=rank,
                       device="cpu", timeout=TIMEOUT)
            out = world_cases(rank, world, outdir)
        else:           # torchrun's variables are in the environment
            initialize(device="cpu", timeout=TIMEOUT)
            if mode == "launcher":
                out = launcher_cases(rank, world, outdir)
            elif mode == "crash":
                out = crash_case(rank, outdir)
            else:
                out = resume_case(outdir)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)     # leave at once: the other ranks' collectives fail
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
