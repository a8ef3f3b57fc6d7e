"""A stream of NUTS jobs on the DLGM's local posterior through
``models/dlgm.local_posterior_mcmc_fused``: job i takes a batch of
``rows`` rows, so its z has rows * Z dimensions, and runs the traffic's
chains through warm-up and sampling from a seed drawn for it.  The data
come from the traffic's own ``data_seed`` and the batches from a pool of
``pool``, which the run's seed puts in its order, and the window closes
only at the end of a whole pass over the pool: every window holds each
posterior equally often, however fast the program runs, so the seed
changes the draws and the order, not the work.  The decoder is the data's
ground truth (zero biases, the configuration's observation scale).  The
warm-up job runs the same shapes with fewer transitions.

The benchmark wraps each job's batched transition (the entry's own, which
``MCMC`` calls) to keep its warm-up leapfrog counts, and in the job that
the check follows (drawn from the seed) the step size, mass and accept
statistics each warm-up transition got or gave, and each warm-up state's
draws, copied into a buffer made at set-up.

Off the clock, after each job: the minimum over coordinates of the bulk
multi-chain ESS of its sampling draws and the maximum split-R-hat (the
benchmark's own copy of the estimators); then the draws are freed.

The check, on the followed job, with the plain references: the initial
points rebuilt from the job's seed; transitions drawn from the seed in
the warm-up and in sampling, each run by the reference from the
program's state before it on the same draws (the keyed Philox streams) at
the step size and mass the program gave it, and compared in end point
and accept statistic; the step size of every warm-up transition and of
sampling, by dual averaging on the program's accept statistics; the mass
at the end of each slow window, from the program's draws in it."""

from __future__ import annotations

import dataclasses
import math
import random

import torch
from torch.profiler import record_function

from portbench.harness import checks, diagnostics, inputs
from portbench.reference import dlgm_nuts, nuts_adapt
from portbench.reference.philox import init_uniforms, nuts_streams

WARMUP, SAMPLE = 1, 2   # the stream phases
RHAT_MAX = 1.01
BLOCK = 512             # transitions the reference runs at once


class _Recorder:
    """Wraps a job's batched transition.  Keeps every warm-up
    transition's leapfrogs; with a buffer ``q_buf`` (W + 1, chains, dim)
    also the step size, mass and accept statistics of each warm-up
    transition and, in the buffer, the states before and after it."""

    def __init__(self, step, q_buf=None):
        self.step, self.q_buf = step, q_buf
        self.leapfrogs, self.eps, self.inv_mass, self.accept = [], [], [], []
        self.copies = 0

    def __call__(self, key, states, step_size, inv_mass):
        new, info = self.step(key, states, step_size, inv_mass)
        if int(key.phase) == WARMUP:
            self.leapfrogs.append(info.num_steps)
            if self.q_buf is not None:
                t = int(key.t)
                if t == 0:
                    self.q_buf[0].copy_(states.q)
                self.q_buf[t + 1].copy_(new.q)
                self.copies += 1 + (t == 0)
                self.eps.append(step_size)
                self.inv_mass.append(inv_mass)
                self.accept.append(info.accept_prob)
        return new, info


def _rows(state, i):
    """Job i's rows: the i-th batch of the pool in the seed's order; the
    warm-up job (i = -1) takes the batch after the pool."""
    rows, pool = state["traffic"]["rows"], state["order"]
    lo = rows * (pool[i % len(pool)] if i >= 0 else len(pool))
    return state["x"][lo:lo + rows].contiguous()


def _job_seed(state, i):
    return inputs.derive(state["seed"], "nuts_job", i)


def _run(state, i):
    from bayesic_tpu_torch.models import dlgm

    cfg = state["cfg"] if i >= 0 else state["warm_cfg"]
    with record_function("portbench.models.dlgm.local_posterior_mcmc_fused"):
        mcmc = dlgm.local_posterior_mcmc_fused(
            cfg, state["dec"], state["dec_params"], state["sigma"],
            _rows(state, i), max_doublings=state["traffic"]["max_doublings"])
        rec = _Recorder(mcmc.batched_transition,
                        state["q_buf"] if i in (-1, state["pick"]) else None)
        mcmc.batched_transition = rec
        res = mcmc.run(_job_seed(state, i))
    return res, rec


def setup(ctx):
    from bayesic_tpu_torch.models import dlgm

    c, tr = ctx.config, ctx.traffic
    x, (w1, w2) = inputs.dlgm_data(c, tr["data_seed"], ctx.device)
    order = list(range(tr["pool"]))
    random.Random(inputs.derive(ctx.seed, "nuts_order")).shuffle(order)
    pick = getattr(ctx, "pick", None)
    if pick is None:
        pick = inputs.derive(ctx.seed, "nuts_check") % tr["pool"]
    cfg = dlgm.Config(num_data=c["num_data"], data_dim=c["data_dim"],
                      latent_dim=c["latent_dim"], hidden=c["hidden"],
                      num_chains=tr["chains"], num_warmup=tr["warmup"],
                      num_samples=tr["samples"], device=str(ctx.device))
    warm_cfg = dataclasses.replace(cfg, num_warmup=tr["warm_warmup"],
                                   num_samples=tr["warm_samples"])
    dec = dlgm.Decoder(c["latent_dim"], c["hidden"], c["data_dim"]) \
        .to(ctx.device)
    dec_params = {"Dense_0.weight": w1.T.contiguous(),
                  "Dense_0.bias": torch.zeros(c["hidden"], device=ctx.device),
                  "Dense_1.weight": w2.T.contiguous(),
                  "Dense_1.bias": torch.zeros(c["data_dim"],
                                              device=ctx.device)}
    q_buf = torch.empty((tr["warmup"] + 1, tr["chains"],
                         tr["rows"] * c["latent_dim"]), device=ctx.device)
    state = dict(seed=ctx.seed, config=c, traffic=tr, x=x, w=(w1, w2),
                 cfg=cfg, warm_cfg=warm_cfg, dec=dec, dec_params=dec_params,
                 sigma=float(c["obs_scale"]), order=order, pick=pick,
                 q_buf=q_buf)
    _run(state, -1)
    return state


def job(state, i):
    tr = state["traffic"]
    res, rec = _run(state, i)
    return {"index": i, "result": res, "recorder": rec,
            "transitions": tr["warmup"] + tr["samples"],
            "sampling": tr["samples"], "bench_ops": rec.copies}


def closes(state, records):
    """The window closes only after a whole pass over the pool."""
    return len(records) % state["traffic"]["pool"] == 0


def after_job(state, rec):
    res, recorder = rec.pop("result"), rec.pop("recorder")
    qs = res.unconstrained                       # (chains, samples, dim)
    # by blocks of coordinates, so that the FFT's workspace stays small
    ess = min(float(torch.min(diagnostics.ess(qs[..., j:j + 256])))
              for j in range(0, qs.shape[-1], 256))
    rhat = float(torch.max(diagnostics.split_rhat(qs)))
    rec["min_ess"], rec["max_rhat"] = ess, rhat
    rec["failed"] = not (rhat < RHAT_MAX and math.isfinite(ess))
    rec["ess"] = 0.0 if rec["failed"] else ess
    rec["leapfrogs"] = int(res.extra["num_steps"].sum()) + int(
        torch.stack(recorder.leapfrogs).sum())
    if rec["index"] == state["pick"]:
        state["kept"] = _keep(state, rec["index"], res, recorder)


def _keep(state, i, res, recorder):
    """What the check reads of the followed job: its warm-up record, and
    the sampling transitions it follows (drawn from the seed); None where
    the job ran other numbers of transitions than the traffic's."""
    tr = state["traffic"]
    qs = res.unconstrained
    if len(recorder.eps) != tr["warmup"] or qs.shape[1] != tr["samples"]:
        return None
    rng = random.Random(inputs.derive(state["seed"], "nuts_pairs", i))
    pairs = [(rng.randrange(tr["chains"]), rng.randrange(tr["samples"]))
             for _ in range(tr["check_sampling"])]
    ch = torch.tensor([c for c, _ in pairs], device=qs.device)
    t = torch.tensor([t for _, t in pairs], device=qs.device)
    before = torch.where((t == 0)[:, None], state["q_buf"][-1][ch],
                         qs[ch, torch.clamp(t - 1, min=0)])
    return dict(
        index=i, eps=torch.stack(recorder.eps).reshape(-1),
        inv_mass=torch.stack([m.reshape(-1) for m in recorder.inv_mass]),
        accept=torch.stack(recorder.accept),
        step=res.extra["step_size"].reshape(()).clone(),
        final_mass=res.extra["inv_mass"].reshape(-1).clone(),
        s_chains=ch, s_t=t, s_before=before.clone(),
        s_after=qs[ch, t].clone(), s_accept=res.extra["accept_prob"][ch, t])


def facts(state):
    c, tr = state["config"], state["traffic"]
    return {"rows": tr["rows"], "latent": c["latent_dim"],
            "hidden": c["hidden"], "data_dim": c["data_dim"],
            "chains": tr["chains"]}


def release(state):
    for k in ("dec", "cfg", "warm_cfg"):
        state.pop(k, None)


def _warm_pairs(state):
    """The followed warm-up transitions: ``check_warmup`` chains at each
    warm-up step, drawn from the seed."""
    tr = state["traffic"]
    rng = random.Random(inputs.derive(state["seed"], "nuts_warm_pairs"))
    return [(rng.randrange(tr["chains"]), t) for t in range(tr["warmup"])
            for _ in range(tr["check_warmup"])]


def _follow(state, k, tf32):
    """The followed transitions of the kept job: ``(before, the
    program's end points and accept statistics, the reference's)``, the
    reference in TF32 with ``tf32``."""
    tr = state["traffic"]
    w1, w2 = state["w"]
    dev = w1.device
    pg = dlgm_nuts.make_potential(
        w1, torch.zeros(w1.shape[1], device=dev), w2,
        torch.zeros(w2.shape[1], device=dev), _rows(state, k["index"]),
        state["sigma"])
    seed = _job_seed(state, k["index"])
    wp = _warm_pairs(state)
    wc = torch.tensor([c for c, _ in wp], device=dev)
    wt = torch.tensor([t for _, t in wp], device=dev)
    qb = state["q_buf"]
    sets = [  # phase, chains, steps, before, after, accept, eps, mass
        (WARMUP, wc, wt, qb[wt, wc], qb[wt + 1, wc], k["accept"][wt, wc],
         k["eps"][wt], k["inv_mass"][wt]),
        (SAMPLE, k["s_chains"], k["s_t"], k["s_before"], k["s_after"],
         k["s_accept"], k["step"].expand(len(k["s_t"])),
         k["final_mass"].expand(len(k["s_t"]), -1))]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    out = []
    try:
        for phase, ch, t, before, after, acc, eps, mass in sets:
            for lo in range(0, len(t), BLOCK):
                s = slice(lo, lo + BLOCK)
                streams = nuts_streams(seed, phase, t[s], ch[s],
                                       before.shape[1], tr["max_doublings"],
                                       dev)
                q, a, _ = dlgm_nuts.transition(
                    pg, before[s], *streams, eps[s][:, None], mass[s],
                    tr["max_doublings"])
                out.append((after[s], acc[s], q, a))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return [torch.cat(x) for x in zip(*out)]


def readings(state, records, seed, control=False):
    """The compared numbers' readings, before their limits, and the
    quantiles of the followed transitions' deviations.  ``control=True``
    puts the reference in the precision below the configuration's in the
    program's place: its transitions in TF32, its arithmetic of the
    initial points, the dual averaging and the variances in bfloat16."""
    if state.get("kept") is None:
        return {"init_gap": math.inf, "trans_share": 1.0,
                "step_gap": math.inf, "mass_gap": math.inf}
    tr, k = state["traffic"], state["kept"]
    low = torch.bfloat16
    # the start
    dim = state["q_buf"].shape[2]
    chains = torch.arange(tr["chains"], device=state["q_buf"].device)
    u = init_uniforms(_job_seed(state, k["index"]), chains, dim,
                      chains.device)
    q0 = nuts_adapt.initial_points(u)
    q0_prog = nuts_adapt.initial_points(u, low) if control \
        else state["q_buf"][0]
    init_gap = float(torch.max(torch.abs(q0_prog.double() - q0)))
    # the transitions
    p_after, p_acc, r_after, r_acc = _follow(state, k, False)
    if control:
        _, _, p_after, p_acc = _follow(state, k, True)
    dq = torch.amax(torch.abs(r_after - p_after), 1) \
        / (1.0 + torch.amax(torch.abs(r_after), 1))
    da = torch.abs(r_acc - p_acc)
    tol = tr["tolerances"]
    off = (dq > tol["end_point"]) | (da > tol["accept"]) \
        | ~torch.isfinite(dq) | ~torch.isfinite(da)
    # the step sizes
    means = torch.mean(k["accept"].double(), 1)
    eps_ref, step_ref = nuts_adapt.dual_averaging(
        means, tr["warmup"], tr["init_step_size"])
    if control:
        eps_p, step_p = nuts_adapt.dual_averaging(
            means, tr["warmup"], tr["init_step_size"], low)
    else:
        eps_p, step_p = k["eps"].cpu(), k["step"].cpu()
    step_gap = max(
        float(torch.max(torch.abs(torch.log(eps_p.double())
                                  - torch.log(eps_ref)))),
        abs(math.log(float(step_p)) - math.log(float(step_ref))))
    # the mass at each slow window's end
    mass_gap = 0.0
    for a, b in nuts_adapt.windows(tr["warmup"]):
        draws = state["q_buf"][a + 1:b + 1].reshape(-1, dim)
        ref = nuts_adapt.window_variance(draws)
        prog = nuts_adapt.window_variance(draws, low) if control else (
            k["inv_mass"][b] if b < tr["warmup"] else k["final_mass"])
        mass_gap = max(mass_gap, float(torch.max(
            torch.abs(prog.double() - ref) / ref)))
    qs = torch.tensor([0.5, 0.9, 0.99, 1.0], device=dq.device)
    return {"init_gap": init_gap,
            "trans_share": float(torch.mean(off.float())),
            "step_gap": step_gap, "mass_gap": mass_gap,
            "end_point_quantiles": torch.quantile(dq, qs).tolist(),
            "accept_quantiles": torch.quantile(da, qs).tolist()}


def check(state, records, seed):
    lim = state["traffic"]["limits"]
    r = readings(state, records, seed)
    return [checks.number(k, r[k], lim[k]) for k in lim]
