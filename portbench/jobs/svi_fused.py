"""A stream of fused DLGM trainer calls (``ops.fused_vae.fused_train``),
each of ``steps`` steps at the traffic's batch, each continuing the state
of the call before, as ``models/dlgm.run_svi_fused`` makes one call.

Set-up builds the trainer's state from the seed and drives it through its
first three steps by the window's own call (one step, then two), keeping
what the reference needs to follow them; one call of the window's length
warms the kernels; the window then continues from there.  A call whose
losses are not all finite has failed, and its steps do not count.

The check follows, with the plain reference on the same rows and noise
(the kernel's Philox streams rebuilt from the seed): the first three steps
from the seed's initial state, and the first steps of one window call,
drawn from the seed, from the state (parameters, Adam's moments and step
count) that the call started from.  Any failed call fails the check."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from portbench.harness import checks, inputs
from portbench.reference import dlgm_svi

FIRST = 3   # steps (or kept losses of a window call) the reference follows


def _train(state, steps):
    from bayesic_tpu_torch.ops import fused_vae

    tr = state["traffic"]
    with record_function("portbench.ops.fused_vae.fused_train"):
        p, m, v, losses = fused_vae.fused_train(
            state["x"], *state["carry"], steps=steps, lr=tr["lr"],
            seed=state["kseed"], batch=tr["batch"], t0=state["t"])
    state["carry"] = (p, m, v)
    state["t"] += steps
    return losses


def _thin(steps):
    """The trainer's loss thinning: entry k holds the loss of step
    k * thin + thin - 1 of the call."""
    return -(-steps // min(steps, 2048))


def setup(ctx):
    x, _ = inputs.dlgm_data(ctx.config, ctx.seed, ctx.device)
    p0, m0, v0 = inputs.dlgm_fused_init(ctx.config, ctx.seed, ctx.device)
    pick = getattr(ctx, "pick", None)
    if pick is None:
        pick = inputs.derive(ctx.seed, "svi_pick") % ctx.traffic["trace_jobs"]
    state = dict(traffic=ctx.traffic, x=x, carry=(p0, m0, v0), t=0,
                 kseed=inputs.derive(ctx.seed, "svi_kernel") >> 1, p0=p0,
                 pick=pick)
    first = [_train(state, 1)]
    state["p1"], state["m1"] = state["carry"][0], state["carry"][1]
    first.append(_train(state, FIRST - 1))
    state["p3"] = state["carry"][0]
    state["first_losses"] = torch.cat(first)
    # warms the window's call and its off-clock check
    after_job(state, {"index": -1,
                      "losses": _train(state, ctx.traffic["steps"])})
    return state


def job(state, i):
    if i == state["pick"]:
        state["start"] = (tuple({k: a.clone() for k, a in tree.items()}
                                for tree in state["carry"]), state["t"])
    losses = _train(state, state["traffic"]["steps"])
    return {"index": i, "steps": state["traffic"]["steps"], "losses": losses}


def after_job(state, rec):
    losses = rec.pop("losses")
    rec["failed"] = not bool(torch.isfinite(losses).all())
    if rec["index"] == state["pick"]:
        state["start_losses"] = losses[:FIRST].clone()


def facts(state):
    c = state["x"].shape
    return {"data": c[0], "data_dim": c[1],
            "hidden": state["p0"]["w1e"].shape[1],
            "latent": state["p0"]["wmu"].shape[1],
            "batch": state["traffic"]["batch"]}


def release(state):
    state.pop("carry", None)


def _loss_gap(prog, ref):
    return float(torch.max(torch.abs(prog - ref) / torch.abs(ref)))


def readings(state, records, seed, control=False):
    """The compared numbers' readings, before their limits: the worst
    step's relative loss gap over the first three steps, the first
    gradient's worst leaf gap and the three steps' parameter change's;
    the worst relative gap of the picked window call's first kept losses
    (``window_loss_gap``).  ``control=True`` puts the reference in TF32 in
    the program's place."""
    tr = state["traffic"]

    def follow(tf32, start=None, steps=FIRST):
        kw = {}
        if start is not None:
            (p, m, v), t0 = start
            kw = dict(m=m, v=v, t0=t0)
        else:
            p = state["p0"]
        return dlgm_svi.train(state["x"], p, seed=state["kseed"],
                              steps=steps, lr=tr["lr"], batch=tr["batch"],
                              tf32=tf32, **kw)

    losses, path, grads = follow(False)
    if control:
        p_losses, p_path, p_grads = follow(True)
        p3 = p_path[-1]
    else:
        p_losses, p3 = state["first_losses"], state["p3"]
        # Adam's first moment after one step from zero is (1 - b1) g
        p_grads = {k: m / (1.0 - dlgm_svi.B1)
                   for k, m in state["m1"].items()}
    keep = checks.moving_leaves(grads)
    change = checks.leaf_norm_gap(
        {k: p3[k] - state["p0"][k] for k in keep},
        {k: path[-1][k] - state["p0"][k] for k in keep})
    out = {"loss_gap": _loss_gap(p_losses, losses),
           "grad_gap": checks.leaf_norm_gap(p_grads, grads),
           "change_gap": change}
    thin = _thin(tr["steps"])
    if "start" in state:
        kept = slice(thin - 1, None, thin)
        w_losses = follow(False, state["start"], FIRST * thin)[0][kept]
        w_prog = (follow(True, state["start"], FIRST * thin)[0][kept]
                  if control else state["start_losses"])
        out["window_loss_gap"] = _loss_gap(w_prog, w_losses)
    else:
        out["window_loss_gap"] = float("inf")   # the picked call never ran
    return out


def check(state, records, seed):
    lim = state["traffic"]["limits"]
    r = readings(state, records, seed)
    failed = sum(bool(rec["failed"]) for rec in records)
    return [checks.number(k, r[k], lim[k]) for k in lim] + [
        checks.number("failed_calls", failed, 0)]
