#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: the DLGM's
SVI and local-posterior NUTS, the hierarchical logistic regression's SVI
and full-batch NUTS, the Gaussian mixture's tempered SMC, the linear
regression's SVI and the matrix factorization's mini-batch and dense
SVI.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
hand-written kernels from ``bayesic_tpu_torch/csrc/``.

Phases 1-7, the SVI path: check the fused VAE kernel against its plain
PyTorch version at the SVI bench shape (N=65,536, D=128, Z=32, H=256,
B=1024; one step's gradients also at the DLGM default ``Config()``'s
widths and at ragged ones with a batch that is not a multiple of 16), its
Philox twin and that two calls agree bit for bit, drive both entry points
(``run_svi`` and ``run_svi_fused``), time the kernel against the plain
work's FP32 bound and its own TF32 tensor-core bound, time the plain
version, and trace where the device time goes (the three kernels of a
step and their shares).

Phases 8-11, the local-posterior NUTS path at its bench shape (1024
chains, 64 rows, latent 8, hidden 64, data 32): check the fused NUTS
kernel's potential and one whole transition against the plain versions,
drive ``local_posterior_mcmc_fused`` and ``local_posterior_mcmc`` after
training the decoder with ``run_svi``, gate their posteriors (split-R-hat,
agreement of the means and variances within Monte-Carlo error), time one
transition of the kernel and of the plain version, trace both sampling
loops, the whole fused call and the stream draws, and time the kernel at
a narrower and a wider decoder.

Phases 12-16, the hierarchical-logistic path at its bench shape
(``hier_logistic.Config()``: N=10,000 rows, J=50 groups, F=5 features,
B=1024, 3,000 SVI steps; NUTS on the centered model with 128 chains, 500
warmup + 300 samples, pooled adaptation): check the fused hier trainer and
the hier NUTS kernel against their plain versions (the trainer also at a
batch of 4,096, too large to stage, through its instance that reads the
rows from L2; the potential against autograd of the DSL model; the NUTS
kernel also at 20,000 rows, too many for its shared memory, through its
instance that reads them from L2), drive ``run_svi`` and ``run_svi_fused``
(with the trainer's step time, its probe's cycles by phase, its row loop's
SASS and one SM's floor a step), then ``fused_nuts_mcmc`` and ``MCMC`` on
the centered model, gate their posteriors, time both kernels against their
plain versions, print the NUTS kernel's launch geometry, depths, row loop
and critical path, and trace both sampling loops.

Phases 17-20, the GMM tempered-SMC path at its bench shape
(``gmm.Config(num_particles=8192, num_data=2000)``: K=3, D=2, 5 mutation
steps of 5 leapfrogs): check the three likelihood kernels (forward,
backward, value+grad) against their plain versions at the bench shape, an
odd one and the further shapes the value+grad kernel runs, and count the
shapes where the forward's ll and the backward's gradients equal the
value+grad kernel's (times the cotangent) bit for bit, and the fused
mutation kernel against ``mutation_core`` on the
same draws at three temperatures (and its generic instance at K 4, D 3),
with a second launch bit for bit; run ``SMC`` in its four modes (generic,
kernels, fused on five paired seeds, split on one) and gate the posterior
predictive and the paired log-evidence; time every kernel against its
plain version (the mutation also on one 128-particle adaptation block,
with its cluster launch's geometry), print each likelihood launch's
geometry and the SASS instructions a particle-point of every likelihood
instance's and the mutation's point loop, and trace one stage of each
mode.

Phases 21-22, the linear-regression path at its bench shape
(``linreg.Config(n=16384, dim=64)``): check the fused linreg trainer's
step against autograd of the DSL model and against a float64 plain step,
a 200-step injected trajectory and the Philox twin against the plain
version; drive ``run`` (mean-field and full-rank, 2,000 steps) and
``run_svi_fused`` (200,000 steps) and gate them on the analytic
posterior; time the kernel, the plain version and the generic engine.

Phases 23-25, the matrix-factorization path at its bench shape
(``matrix_fact.Config()``: 3,000 users x 1,500 items, K 16, 1M ratings):
check the dense MF cell pass against its plain version at the bench shape
and a ragged one (there also at the widest K, 30) in float32 and bfloat16,
and that two calls agree bit for bit; drive ``run`` (mini-batch),
``run_dense`` (eager) and ``mf_dense.fused_train`` in both modes and gate
their RMSE and final losses; time the kernel (its device time, queued
behind a spin kernel, and a call's time with the host's cost), its plain
version and the eager autograd path, and trace ``fused_train``.

Each phase prints one line and raises on failure.  The line before the
last is a JSON object with one entry per kernel: its launches on the main
path (``fused_vae_train`` counts calls of its C entry, each of which
enqueues three kernels per step; the others count kernel launches), its
largest error against the plain version, its time and the plain
version's (per SVI step, NUTS transition, SMC stage or likelihood call),
and the bound: the least time the card could take for the same work, the
larger of the bytes over the memory rate and the operations over the FP32
peak, or for the two kernels whose products run on the tensor cores
(``fused_vae_train``, ``fused_nuts_transition``) their three TF32 passes
over the TF32 peak, and for the hier NUTS kernel and the four GMM
kernels the larger of their FP32 and SFU figures (the exp, log and rcp
count their functions need at the SFU rate; phases 5 and 11 print both
of theirs; phases 16 and 20 print the FP32 and SFU figures; phase 25 the
MF cell pass's bf16-mode bound at the bf16 tensor-core rate and its scratch
bytes).  The last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or outside a checkout, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = dict(num_data=65_536, data_dim=128, latent_dim=32, hidden=256,
             batch_size=1024)
# phase 2's shapes off the bench: the DLGM default Config()'s widths, and
# ragged widths with a batch that is not a multiple of 16
SVI_OFF_BENCH = (dict(num_data=10_000, data_dim=32, latent_dim=8, hidden=64,
                      batch_size=256),
                 dict(num_data=3000, data_dim=37, latent_dim=5, hidden=100,
                      batch_size=40))
LR = 1e-3
# steps per traced window (phase 7): the kernel path, and the host-bound
# generic engine and plain version
TRACE_FUSED_STEPS, TRACE_HOST_STEPS = 200, 20
# the local-posterior NUTS bench (JAX benchmarks/harness.py:644-684): the
# decoder is trained by run_svi on NUTS_SVI, then 1024 chains sample the z
# of 64 rows, 200 warmup and 200 sampling transitions, pooled adaptation
NUTS_SVI = dict(num_data=2048, data_dim=32, latent_dim=8, hidden=64,
                batch_size=256, steps=200)
NUTS_CHAINS, NUTS_ROWS, NUTS_WARMUP, NUTS_SAMPLES = 1024, 64, 200, 200
NUTS_K, GENERIC_DEPTH = 6, 10       # max_doublings (fused), max_depth
# phase 9 step sizes at a random start: the trees reach depth 3-6 at the
# first; at the second about a quarter of the chains diverge
EPS_SMALL, EPS_DIVERGE = 0.05, 0.27
TRACE_NUTS_FUSED, TRACE_NUTS_GENERIC = 20, 3     # transitions per trace
# the hier-logistic bench (JAX benchmarks/harness.py:362-396): the
# Config() defaults for the data and the SVI; NUTS on the centered model
HIER_CHAINS, HIER_WARMUP, HIER_SAMPLES = 128, 500, 300
HIER_K, HIER_DEPTH = 6, 10          # max_doublings (fused), max_depth
# phase 14 step sizes near the posterior's bulk: trees of depth 2-5 at the
# first, most chains diverge at the second; the third runs K = 10
HIER_EPS_SMALL, HIER_EPS_DIVERGE, HIER_EPS_K10 = 0.02, 0.08, 0.005
HIER_TRAJ, HIER_PLAIN_STEPS = 50, 100
# phase 14's second shape: twice the bench's rows (J 50, F 5), too many for
# shared memory, through the NUTS kernel's instance that reads them from L2
HIER_L2_ROWS = 20_000
# phase 12's second batch: the bench data at a batch whose ring slots do not
# fit in shared memory, through the trainer's instance that reads its rows
# from L2
HIER_L2_BATCH = 4096
# the GMM tempered-SMC bench (JAX benchmarks/harness.py:522-594):
# gmm.Config(num_particles=8192, num_data=2000), K 3, D 2, 5 mutation steps
# of 5 leapfrogs; generic, kernels and fused run on GMM_SEEDS (paired: one
# seed gives every mode the same draws), split on the first
GMM = dict(num_particles=8192, num_data=2000)
GMM_SEEDS = (100, 101, 102, 103, 104)
# phase 18's temperatures and step sizes from a near-truth start: about
# the posterior's width, so that 58-64% of one-transition proposals are
# accepted (the posterior narrows as beta grows, so the step shrinks)
GMM_BETA_EPS = ((0.05, 0.1), (0.5, 0.04), (1.0, 0.03))
GMM_ODD = dict(p=1001, n=1999)      # phase 17's odd shape
# phase 17's further value+grad shapes: P by N at the bench's K 3, D 2
# (lone and ragged blocks, lanes with no points) and the generic instance
# at its largest K 8, D 4; phase 20's launches a timed kernel
GMM_VG_PN = [(p, n) for p in (1, 7, 1001, 8192) for n in (20, 1999, 2000)]
GMM_VG_GENERIC = ((8, 4, 1001, 1999), (8, 4, 7, 20))
GMM_TIMED = 50
GMM_GENERIC = (4, 3)    # phase 18's (K, D) of the generic kernel instance
# phase 18 at K = 5: limits on the adaptation's outcome against the plain
# core (per-block and pooled step rel err, mean accept abs err, share of
# particles whose q' parts by more than 1e-3, ll' rel err of the others),
# 2-5x the largest seen over the three temperatures on an H100 (0.051,
# 3.0e-4, 3.5e-5, 8.2%, 3.6e-5)
GMM_K5_TOL = {"step": 0.1, "next step": 1e-3, "accept": 2e-4,
              "parted": 0.25, "ll kept": 1e-4}
# the linreg bench (JAX benchmarks/harness.py:300-335): Config(n=16384,
# dim=64); phase 21's trajectories and limits (one step: elbo rel err,
# gradient err within grad x (|g| + 0.1 max|g|); trajectories: loss rel
# err and param err / max), phase 22's entry points: the generic engine
# with 2,000 steps per guide (the full-rank one at lr 0.01: at the
# default 0.05 its 2,145-parameter guide diverges on both packages at this
# width), the fused trainer with 200,000
LINREG = dict(n=16384, dim=64)
LINREG_TOL = {"elbo": 2e-5, "grad": 1e-4, "trajectory": 1e-4}
LINREG_TRAJ, LINREG_PLAIN_STEPS = 200, 100
LINREG_STEPS, LINREG_FULLRANK_LR = 2000, 0.01
LINREG_FUSED_STEPS, LINREG_TRACE_STEPS, LINREG_GENERIC_TIMED = \
    200_000, 2_000, 200
# phase 21's edges of the trainer's layout (one consumer warp at D 1 and 2,
# a ragged last warp at D 63, the widest D) and phase 22's probe steps
LINREG_EDGE_DIMS, LINREG_PROBE_STEPS = (1, 2, 63, 126), 20_000
LINREG_EDGE_TIMED = 50_000          # steps timed at each edge D
# the dense MF bench (JAX benchmarks/harness.py:430-510): Config(), 3,000
# users x 1,500 items, K 16, 1M ratings; phase 23's ragged shape (also
# run at the widest K the kernel takes, MAX_FACTORS = 30) and limits (loss
# rel err, gradient err / max|g|; bf16: a G entry at a rounding boundary
# may round the other way after float32 sums in another order); phase
# 24's fused_train rate (the JAX selftest's).  MF holds overrides of
# matrix_fact.Config(): none, the bench is its defaults
MF, MF_ODD = {}, (997, 1501)
MF_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 1e-3)}
MF_FUSED_LR, MF_TRACE_STEPS = 5e-3, 20
# published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores, dense bf16 and TF32 on them, and HBM3; the SFU does 16
# exp/log/rcp per SM per clock, at the 1.98 GHz boost clock on 132 SMs
PEAK_FP32, PEAK_BF16, PEAK_TF32 = 67e12, 989e12, 494.7e12
PEAK_BYTES = 3.35e12
SM_CLOCK = 1.98e9
PEAK_SFU = 16 * 132 * SM_CLOCK


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _card():
    res = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps=1):
    """Milliseconds per call of ``fn`` by CUDA events (caller warms up)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _device_ms(torch, fn, reps):
    """Milliseconds of device time per call of ``fn`` (caller warms up):
    the calls queue behind a spin kernel that outlasts their host cost
    (~2 ms a call at the card's clock), so they run back to back on the
    card and the events see no host gap."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e6 * reps))
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t)
    end.record()
    torch.cuda.synchronize()
    if host_ms > 2.0 * reps:
        raise AssertionError(f"_device_ms: the host took {host_ms:.1f} ms "
                             f"to queue {reps} calls, past the spin")
    return start.elapsed_time(end) / reps


def _host_ms(torch, fn, reps):
    """Milliseconds of host time per call of ``fn`` (caller warms up): the
    wrapper's own cost, the calls queued without a wait."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return host_ms


def _trace(torch, fn, steps, unit="step"):
    """Profile one call of ``fn`` (already warm) that runs ``steps`` steps
    (or transitions, ``unit``): device busy ms per step (union of kernel
    intervals), idle share of the window from the first kernel's start to
    the last one's end, kernels per step, and the three busiest kernel
    names with their share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return "not measured (the profiler recorded no device kernel)"
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in kern):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = (max(e.time_range.end for e in kern)
              - min(e.time_range.start for e in kern))
    by_name = {}
    for e in kern:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split()[-1]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return (f"busy {_num(busy / 1e3 / steps)} ms/{unit}, idle "
            f"{100 * (1 - busy / window):.1f}%, "
            f"{_num(len(kern) / steps, 1)} kernels/{unit} ("
            + ", ".join(f"{k} {100 * t / total:.1f}%" for k, t in top) + ")")


def _num(x, places=4):
    """``x`` with ``places`` decimals, or 4 significant digits below 0.01
    (a whole-run trainer's ms and kernels a step)."""
    return f"{x:.{places}f}" if abs(x) >= 0.01 else f"{x:.4g}"


def _bound(ops, nbytes, peak=PEAK_FP32):
    """(ms, what bounds it): the least time the card could take for
    ``ops`` operations at ``peak`` per second (FP32 unless given) that move
    ``nbytes`` bytes."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def _sfu_ms(count):
    """ms of ``count`` exp/log/rcp at the SFU rate."""
    return 1e3 * count / PEAK_SFU


def _record(name, source, replaces, launches, err, ms, plain_ms, bound):
    """One entry of the kernels line.  No single PyTorch call computes a
    whole-run trainer, a NUTS transition, an SMC mutation, the GMM
    likelihood or the dense MF cell pass, so ``library_ms`` is null."""
    return {"name": name, "route": "cuda",
            "source": f"bayesic_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def _ptxas_summary(log):
    """'kernel N regs, S B spill' for each entry function in nvcc's log."""
    stats, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in ("hier_train_kernel", "row_kernel",
                                     "wgrad_kernel", "adam_kernel",
                                     "dlgm_nuts_kernel", "dlgm_pack_kernel",
                                     "nuts_draws_kernel",
                                     "nuts_kernel", "potential_kernel",
                                     "gmm_lik_kernel",
                                     "smc_gmm_mutate_kernel",
                                     "linreg_train_kernel", "mf_cell_kernel",
                                     "mf_pack_kernel", "mf_reduce_kernel",
                                     "pack_kernel")
                         if k in mangled), mangled)
            if name == "row_kernel":
                # template argument: its buffers in shared memory or not
                name += "<smem>" if "ILb1E" in mangled else "<global>"
            if name in ("mf_cell_kernel", "mf_pack_kernel"):
                # template arguments: bf16 [, A padded to a multiple of 8]
                name += "<" + ",".join(
                    ["bf16" if "ILb1E" in mangled else "f32"]
                    + re.findall(r"ELi(\d+)E", mangled)) + ">"
            if "DlgmPotential" in mangled:
                name += "<Dlgm>"
            hier = re.search(r"HierPotentialILi\d+ELi(\d+)ELb([01])E",
                             mangled)
            if hier:
                # template arguments: F, the rows resident or read from L2
                name += (f"<Hier,F{hier.group(1)},"
                         f"{('l2', 'smem')[int(hier.group(2))]}>")
            if name == "dlgm_nuts_kernel":
                # template arguments: the whole tree or the potential
                # alone, element groups a lane, mode
                e, mode = re.findall(r"Li(\d+)E", mangled)[:2]
                name += ("<tree," if "ILb1E" in mangled else "<potential,") \
                    + f"{e},{('fast', 'guarded', 'staged')[int(mode)]}>"
            if "gmm" in name:
                # template arguments: K, D, exact [, mode]
                name += "<" + ",".join(re.findall(
                    r"L[ib](\d+)E", mangled.split("kernelI")[1])) + ">"
            if name == "hier_train_kernel" and "kernelI" in mangled:
                # template arguments: F, the rows staged or read from L2,
                # probe
                f_, res, probe = re.findall(
                    r"L[ib](\d+)E", mangled.split("kernelI")[1])[:3]
                name += (f"<F{f_},{('l2', 'smem')[int(res)]},"
                         f"{('main', 'probe')[int(probe)]}>")
            if name == "linreg_train_kernel":
                # template arguments: float4 chunks a lane, probe
                nc, probe = re.findall(r"L[ib](\d+)E", mangled)[:2]
                name += f"<{nc},{'probe' if probe == '1' else 'main'}>"
            stats[name] = {}
        elif name and "spill stores" in line:
            stats[name]["spill"] = (line.split("bytes spill stores")[0]
                                    .split(",")[-1].strip())
        elif name and "Used" in line and "registers" in line:
            stats[name]["regs"] = (line.split("Used")[1]
                                   .split("registers")[0].strip())
    # the linreg trainer's instances (one per chunk count) in two entries,
    # the hier NUTS kernels' off-bench F in one each, the hier trainer's
    # off-bench F in one
    for prefix, kind in (("linreg_train_kernel<", "main"),
                         ("linreg_train_kernel<", "probe"),
                         ("nuts_kernel<Hier,", ""),
                         ("potential_kernel<Hier,", ""),
                         ("hier_train_kernel<", "")):
        inst = {k: v for k, v in stats.items() if k.startswith(prefix)
                and kind in k and ",F5," not in k and "<F5," not in k}
        if inst:
            for k in inst:
                del stats[k]
            regs = [int(v.get("regs", 0)) for v in inst.values()]
            stats[f"{prefix[:-1]} {kind or 'F != 5'} x{len(inst)}"] = {
                "regs": f"{min(regs)}-{max(regs)}",
                "spill": str(max(int(v.get("spill", 0))
                                 for v in inst.values()))}
    return "; ".join(
        f"{k} {v.get('regs', '?')} regs, {v.get('spill', '?')} B spill"
        for k, v in stats.items()) or "library already built"


def _sass_loop_stats(so, kernel, per=None):
    """The innermost loops that hold exps (MUFU.EX2) in each instance of
    ``kernel`` in the library ``so``, read from ``cuobjdump -sass``: per
    loop, (the instance's template arguments, its instructions, the items
    an iteration covers, its FP32 (FFMA, FADD, FMUL, FMNMX) and MUFU
    instructions).  An iteration covers its EX2 count over ``per``, the
    exps of one item; by default the instance's first template argument,
    the GMM kernels' component count, whose items are (particle, point)
    pairs."""
    from bayesic_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name, labels = {}, None, {}
    for line in sass.splitlines():
        fn = re.match(r"\s*Function : (\S+)", line)
        if fn:
            name = fn.group(1) if re.search(rf"\d{kernel}I", fn.group(1)) \
                else None
            if name:
                funcs[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if lab:
            labels[name][lab.group(1)] = None
        elif ins:
            off = int(ins.group(1), 16)
            for lb, at in labels[name].items():
                if at is None:
                    labels[name][lb] = off
            funcs[name].append((off, ins.group(2)))
    out = []
    for fname, body in funcs.items():
        loops = []
        for off, txt in body:
            br = re.search(r"\bBRA(?:\.\S+)?\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)",
                           txt)
            if br:
                tgt = br.group(1)
                tgt = int(tgt, 16) if tgt.startswith("0x") \
                    else labels[fname].get(tgt)
                if tgt is not None and tgt < off:
                    loops.append((tgt, off))
        ops = {lp: [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
                    for o, t in body if lp[0] <= o <= lp[1]] for lp in loops}
        ex2 = {lp: sum(op.startswith("MUFU.EX2") for op in v)
               for lp, v in ops.items()}
        inner = [lp for lp in loops if ex2[lp] and not any(
            o != lp and ex2[o] and lp[0] <= o[0] and o[1] <= lp[1]
            for o in loops)]
        tmpl = re.findall(r"L[ib](\d+)E", fname.split("kernelI")[1])
        for lp in inner:
            v = ops[lp]
            pairs = ex2[lp] / (per or int(tmpl[0]))
            fp32 = sum(op.split(".")[0] in ("FFMA", "FADD", "FMUL", "FMNMX")
                       for op in v)
            mufu = sum(op.startswith("MUFU") for op in v)
            out.append((",".join(tmpl), len(v), pairs, fp32, mufu))
    return out


def _sass_loops(so, kernel, per=None, unit="pairs"):
    """``_sass_loop_stats`` as text: per loop the SASS instructions per
    item (``unit``), all, FP32, MUFU and the rest."""
    out = [f"{kernel}<{tmpl}> loop of {n} instructions, {items:g} {unit}: "
           f"{n / items:.1f} a {unit[:-1]} (FP32 {fp32 / items:.1f}, MUFU "
           f"{mufu / items:.2f}, other {(n - fp32 - mufu) / items:.1f})"
           for tmpl, n, items, fp32, mufu in _sass_loop_stats(so, kernel,
                                                               per)]
    return "; ".join(out) or f"no {kernel} loop with MUFU.EX2 found"


def _posterior(diag, torch, res, wall):
    """min ESS, max split-R-hat, divergences, mean leapfrogs per transition,
    final step size and min-ESS/s of one MCMC result (on the device)."""
    qs = res.unconstrained
    if not bool(torch.isfinite(qs).all()):
        raise AssertionError("non-finite samples")
    min_ess = float(diag.ess(qs).min())
    return dict(min_ess=min_ess, max_rhat=float(diag.split_rhat(qs).max()),
                divergences=int(res.extra["diverging"].sum()),
                leapfrogs=float(res.extra["num_steps"].float().mean()),
                step_size=float(res.extra["step_size"].mean()), wall_s=wall,
                ess_per_s=min_ess / wall)


def _svi_phases(torch, np, card, dev):
    """Phases 2-7, the DLGM SVI path at its bench shape; returns the fused
    VAE kernel's entry of the kernels line."""
    from bayesic_tpu_torch.models import dlgm
    from bayesic_tpu_torch.ops import _kernel_common as kc
    from bayesic_tpu_torch.ops import fused_vae as fv

    cfg = dlgm.Config(**BENCH, lr=LR, seed=0, device="cuda")
    x = torch.as_tensor(dlgm.make_data(cfg), device=dev)
    p0, m0, v0 = dlgm.fused_init(cfg, torch.Generator().manual_seed(0), dev)
    n, b, z = cfg.num_data, cfg.batch_size, cfg.latent_dim
    rng = np.random.default_rng(1)

    def streams(steps):
        idx = torch.as_tensor(rng.integers(0, n, (steps, b)), device=dev)
        eps = torch.as_tensor(
            rng.standard_normal((steps, b, z)).astype(np.float32),
            device=dev)
        return idx, eps

    # -- 2. gradients of one injected step, at the bench shape and at two
    #       off it: the DLGM default Config()'s widths, and ragged widths
    #       with a batch that is not a multiple of 16
    def one_step(cfg_, x_, p_, m_, v_, gen_rng):
        n_, b_ = cfg_.num_data, cfg_.batch_size
        idx_ = torch.as_tensor(gen_rng.integers(0, n_, (1, b_)), device=dev)
        eps_ = torch.as_tensor(gen_rng.standard_normal(
            (1, b_, cfg_.latent_dim)).astype(np.float32), device=dev)
        _, m1, _, l1 = fv.fused_train_injected(x_, p_, m_, v_,
                                               idx_stream=idx_,
                                               eps_stream=eps_, lr=LR)
        torch.cuda.synchronize()
        elbo, grads = fv._step_math(tuple(p_[k] for k in fv.LEAVES),
                                    x_[idx_[0]], eps_[0], n_ / b_)
        worst, max_err = 0.0, 0.0
        for k, g in zip(fv.LEAVES, grads):
            gk = -m1[k] / 0.1          # one Adam step from zero: m = -0.1 g
            err = (gk - g).abs()
            tol = 1e-4 * g.abs() + 1e-5 * float(g.abs().max())
            if bool((err > tol).any()):
                raise AssertionError(
                    f"phase 2: {cfg_.data_dim}/{cfg_.hidden}/"
                    f"{cfg_.latent_dim} B {b_}: grad {k} differs, max abs "
                    f"err {float(err.max())}")
            max_err = max(max_err, float(err.max()))
            worst = max(worst, float((err / tol).max()))
        loss_err = abs(float(l1[0]) + float(elbo)) / abs(float(elbo))
        if loss_err > 1e-4:
            raise AssertionError(f"phase 2: {cfg_.data_dim}/{cfg_.hidden}/"
                                 f"{cfg_.latent_dim} B {b_}: loss rel err "
                                 f"{loss_err}")
        return max_err, (f"D {cfg_.data_dim} H {cfg_.hidden} Z "
                         f"{cfg_.latent_dim} B {b_}: max abs err "
                         f"{max_err:.3e}, worst err/tol {worst:.3f}, loss "
                         f"rel err {loss_err:.2e}")

    max_abs_err, line = one_step(cfg, x, p0, m0, v0, rng)
    lines = [line]
    rng_o = np.random.default_rng(3)
    for shape in SVI_OFF_BENCH:
        cfg_o = dlgm.Config(**shape, lr=LR, seed=0, device="cuda")
        x_o = torch.as_tensor(dlgm.make_data(cfg_o), device=dev)
        lines.append(one_step(cfg_o, x_o, *dlgm.fused_init(
            cfg_o, torch.Generator().manual_seed(1), dev), rng_o)[1])
    print("phase 2 gradients ok, 11 leaves: " + "; ".join(lines),
          flush=True)

    # -- 3. 50-step injected trajectory ----------------------------------
    idx, eps = streams(50)
    pk, _, _, lk = fv.fused_train_injected(x, p0, m0, v0, idx_stream=idx,
                                           eps_stream=eps, lr=LR)
    pr, _, _, lr_ = fv.reference_train(x, p0, m0, v0, idx_stream=idx,
                                       eps_stream=eps, lr=LR)
    rel = float(((lk - lr_).abs() / lr_.abs()).max())
    if rel > 1e-3:
        raise AssertionError(f"phase 3: loss rel err {rel}")
    prel = max(float(((pk[k] - pr[k]).abs()).max()
                     / max(float(pr[k].abs().max()), 1e-30))
               for k in fv.LEAVES)
    print(f"phase 3 trajectory ok: 50 steps, loss max rel err {rel:.2e}, "
          f"param max err / leaf max {prel:.2e}", flush=True)

    # -- 4. Philox path ----------------------------------------------------
    seed = 12345
    _, _, _, lk = fv.fused_train(x, p0, m0, v0, steps=50, lr=LR, seed=seed,
                                 batch=b)
    idx, eps = kc.philox_streams(seed, 0, 50, b, n, z, device=dev)
    _, _, _, lr_ = fv.reference_train(x, p0, m0, v0, idx_stream=idx,
                                      eps_stream=eps, lr=LR)
    bits_rel = float(((lk - lr_).abs() / lr_.abs()).max())
    if bits_rel > 1e-3:
        raise AssertionError(f"phase 4: in-kernel Philox streams differ "
                             f"from the plain twin, loss rel err {bits_rel}")
    again = [fv.fused_train(x, p0, m0, v0, steps=50, lr=LR, seed=seed,
                            batch=b) for _ in range(2)]
    same = torch.equal(again[0][3], again[1][3]) and all(
        torch.equal(a[k], c[k]) for a, c in zip(again[0][:3], again[1][:3])
        for k in fv.LEAVES)
    if not same:
        raise AssertionError("phase 4: two calls with the same inputs "
                             "differ")
    steps = 3000
    _, _, _, lk = fv.fused_train(x, p0, m0, v0, steps=steps, lr=LR,
                                 seed=seed, batch=b)
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, n, (steps, b), generator=gen, device=dev)
    eps = torch.randn((steps, b, z), generator=gen, device=dev)
    _, _, _, lp = fv.reference_train(x, p0, m0, v0, idx_stream=idx,
                                     eps_stream=eps, lr=LR)
    thin = fv._thin(steps)
    keep = torch.clamp(torch.arange(len(lk), device=dev) * thin + thin - 1,
                       max=steps - 1)
    lk, lp = lk.cpu().numpy(), lp[keep].cpu().numpy()
    k_last, p_last = float(lk[-200:].mean()), float(lp[-200:].mean())
    k_first, p_first = float(lk[:100].mean()), float(lp[:100].mean())
    gap = abs(k_last - p_last) / abs(p_last)
    if not (np.isfinite(lk).all() and np.isfinite(lp).all()):
        raise AssertionError("phase 4: non-finite losses")
    if gap > 0.02 or not (k_last < k_first and p_last < p_first):
        raise AssertionError(
            f"phase 4: kernel last-200 {k_last} vs plain {p_last} "
            f"(first-100 {k_first} / {p_first})")
    print(f"phase 4 philox ok: 50-step twin rel err {bits_rel:.2e}, two "
          f"calls bit-identical; "
          f"{steps} steps last-200 mean kernel {k_last:.1f} plain "
          f"{p_last:.1f} (gap {100 * gap:.3f}%), first-100 {k_first:.1f} / "
          f"{p_first:.1f}", flush=True)

    # -- 5. main path through the user's entry points ---------------------
    cfg_g = dlgm.Config(**BENCH, lr=LR, seed=0, steps=300, device="cuda")
    cfg_f = dlgm.Config(**BENCH, lr=LR, seed=0, steps=3000, device="cuda")
    fv.LAUNCHES = 0
    out_g = dlgm.run_svi(cfg_g)
    out_f = dlgm.run_svi_fused(cfg_f)
    torch.cuda.synchronize()
    launches = fv.LAUNCHES
    if launches < 1:
        raise AssertionError("phase 5: run_svi_fused never launched the "
                             "kernel")
    for name, out in (("run_svi", out_g), ("run_svi_fused", out_f)):
        ls = out["losses"]
        if not (np.isfinite(ls).all() and np.isfinite(out["sigma_x"])
                and out["sigma_x"] > 0):
            raise AssertionError(f"phase 5: {name} gave non-finite output")
        if not ls[-20:].mean() < ls[:20].mean():
            raise AssertionError(f"phase 5: {name} loss did not fall")
    # timing, after the runs above warmed everything up
    gen = torch.Generator(device=dev).manual_seed(1)
    svi, res = out_g["svi"], out_g["result"]
    g_steps = 200
    g_ms, _ = _cuda_ms(torch, lambda: svi.run(gen, g_steps, state=res.state,
                                              model_args=(out_g["x"],)))
    f_steps = 3000
    pf, (mf, vf) = out_f["params"], out_f["opt_state"]
    f_ms, _ = _cuda_ms(torch, lambda: fv.fused_train(
        out_f["x"], pf, mf, vf, steps=f_steps, lr=LR, seed=7, batch=b,
        t0=cfg_f.steps))
    g_rate, f_rate = 1e3 * g_steps / g_ms, 1e3 * f_steps / f_ms
    kernel_step_ms = f_ms / f_steps
    # bounds.  SVI step: encoder, reparameterisation and decoder forward
    # and a backward of about twice that (benchmarks/roofline.py
    # dlgm_svi), the plain work at the FP32 rate; the kernel runs its
    # products as three TF32 passes on the tensor cores, the bound of the
    # units it uses, which the kernels line carries.  Bytes: the data set
    # read once per call and the parameters, both Adam moments and the
    # losses read and written once, over the call's steps.
    d_, h_, z_ = cfg.data_dim, cfg.hidden, cfg.latent_dim
    svi_ops = 3 * 2 * b * (d_ * h_ + 2 * h_ * z_ + z_ * h_ + h_ * d_)
    n_par = sum(int(np.prod(s)) for s in fv.leaf_shapes(fv.FusedVAEDims(
        n, d_, h_, z_, b)).values())
    svi_bytes = 4 * (n * d_ + 6 * n_par + f_steps) / f_steps
    fp32_bound = _bound(svi_ops, svi_bytes)
    tc_bound = _bound(3 * svi_ops, svi_bytes, PEAK_TF32)
    print(f"phase 5 main path ok [{card}]: run_svi final ELBO "
          f"{out_g['final_elbo']:.1f} sigma_x {out_g['sigma_x']:.4f} "
          f"{g_rate:.1f} steps/s; run_svi_fused final ELBO "
          f"{out_f['final_elbo']:.1f} sigma_x {out_f['sigma_x']:.4f} "
          f"{f_rate:.1f} steps/s ({kernel_step_ms:.4f} ms/step); kernel C "
          f"calls (LAUNCHES) {launches}, {3 * cfg_f.steps} kernels "
          f"enqueued; bounds: the plain work at FP32 {fp32_bound[0]:.4f} "
          f"ms ({fp32_bound[1]}), TF32 tensor cores x3 {tc_bound[0]:.4f} "
          f"ms ({tc_bound[1]}); kernel at "
          f"{100 * tc_bound[0] / kernel_step_ms:.1f}% of the latter",
          flush=True)

    # -- 6. plain version's time at the same shape ------------------------
    idx, eps = streams(200)
    fv.reference_train(x, p0, m0, v0, idx_stream=idx[:20],
                       eps_stream=eps[:20], lr=LR)
    plain_ms, _ = _cuda_ms(torch, lambda: fv.reference_train(
        x, p0, m0, v0, idx_stream=idx, eps_stream=eps, lr=LR))
    plain_step_ms = plain_ms / 200
    # the kernel's injected-stream mode (the parity entry) on the same 200
    # steps, warmed up by the first call
    fv.fused_train_injected(x, p0, m0, v0, idx_stream=idx, eps_stream=eps,
                            lr=LR)
    inj_ms, _ = _cuda_ms(torch, lambda: fv.fused_train_injected(
        x, p0, m0, v0, idx_stream=idx, eps_stream=eps, lr=LR))
    print(f"phase 6 plain timing ok [{card}]: reference_train "
          f"{plain_step_ms:.4f} ms/step, kernel {kernel_step_ms:.4f} "
          f"ms/step (injected streams {inj_ms / 200:.4f} ms/step)",
          flush=True)

    # -- 7. where the device time goes, under torch.profiler --------------
    traces = {
        "fused_train": _trace(torch, lambda: fv.fused_train(
            out_f["x"], pf, mf, vf, steps=TRACE_FUSED_STEPS, lr=LR, seed=8,
            batch=b, t0=cfg_f.steps + f_steps), TRACE_FUSED_STEPS),
        "run_svi engine": _trace(torch, lambda: svi.run(
            gen, TRACE_HOST_STEPS, state=res.state,
            model_args=(out_g["x"],)), TRACE_HOST_STEPS),
        "reference_train": _trace(torch, lambda: fv.reference_train(
            x, p0, m0, v0, idx_stream=idx[:TRACE_HOST_STEPS],
            eps_stream=eps[:TRACE_HOST_STEPS], lr=LR), TRACE_HOST_STEPS),
    }
    print(f"phase 7 trace ok [{card}]: "
          + "; ".join(f"{k} {v}" for k, v in traces.items()), flush=True)

    return _record("fused_vae_train", "fused_vae.cu",
                   "bayesic_tpu/ops/fused_vae.py:199", launches, max_abs_err,
                   kernel_step_ms, plain_step_ms, tc_bound)


def _nuts_phases(torch, np, card, dev):
    """Phases 8-11, the DLGM local-posterior NUTS path; returns the kernels
    line's entry of its kernel."""
    from bayesic_tpu_torch.infer.mcmc import (MCMC, IntegratorState,
                                              StreamKey, nuts_streams)
    from bayesic_tpu_torch.models import dlgm
    from bayesic_tpu_torch.ops import fused_nuts as fn
    from bayesic_tpu_torch.utils import diagnostics as diag

    # -- 8. the NUTS kernel's potential at the NUTS bench shape -----------
    ncfg = dlgm.Config(**NUTS_SVI, num_chains=NUTS_CHAINS,
                       num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES,
                       seed=0, device="cuda")
    dim = NUTS_ROWS * ncfg.latent_dim
    dec = dlgm.Decoder(ncfg.latent_dim, ncfg.hidden, ncfg.data_dim,
                       torch.Generator().manual_seed(0)).to(dev)
    dparams = {k: p.detach() for k, p in dec.named_parameters()}
    w = fn.decoder_weights(dparams)
    xb = torch.as_tensor(dlgm.make_data(ncfg)[:NUTS_ROWS], device=dev)
    sig = 0.3
    rng = np.random.default_rng(2)
    q0 = torch.as_tensor(
        (0.7 * rng.standard_normal((NUTS_CHAINS, dim))).astype(np.float32),
        device=dev)
    pe_k, g_k = fn.fused_nuts_potential(q0, *w, xb, sigma=sig)
    refs = {"plain": fn.dense_potential(*w, xb, sig)(q0),
            "autograd": MCMC(
                dlgm.local_posterior_model(ncfg, dec, dparams, sig, xb),
                num_warmup=0, num_samples=1, num_chains=NUTS_CHAINS,
                device=dev)._potential_and_grad(q0)}
    errs = []
    for name, (pe_r, g_r) in refs.items():
        pe_rel = float(((pe_k[:, 0] - pe_r).abs() / pe_r.abs()).max())
        g_rel = float((g_k - g_r).abs().max() / g_r.abs().max())
        if pe_rel > 1e-5 or g_rel > 1e-4:
            raise AssertionError(f"phase 8: potential vs {name}: pe rel err "
                                 f"{pe_rel}, grad err / max|g| {g_rel}")
        errs.append(f"vs {name} pe max rel err {pe_rel:.2e}, grad max err "
                    f"/ max|g| {g_rel:.2e}")
    print(f"phase 8 potential ok: {NUTS_CHAINS} chains x D {dim}: "
          + "; ".join(errs), flush=True)

    # -- 9. one whole transition with injected streams -------------------
    # at the fused path's K, and once at the generic path's max_depth
    ones = torch.ones(dim, device=dev)
    nuts_err, lines = 0.0, []
    for kk, eps in ((NUTS_K, EPS_SMALL), (NUTS_K, EPS_DIVERGE),
                    (GENERIC_DEPTH, EPS_SMALL)):
        streams = nuts_streams(StreamKey(9, 2, 0), NUTS_CHAINS, dim, kk, dev)
        args = (q0, pe_k, g_k, *streams, eps, ones, *w, xb)
        got = fn.fused_nuts_transition(*args, sigma=sig, max_doublings=kk)
        want = fn.reference_transition(*args, sigma=sig, max_doublings=kk)
        torch.cuda.synchronize()
        same = ((got[4] == want[4]) & (got[5] == want[5])
                & (got[6] == want[6]))[:, 0]
        n_diff = NUTS_CHAINS - int(same.sum())
        if n_diff > 0.01 * NUTS_CHAINS:
            raise AssertionError(f"phase 9: K {kk} eps {eps}: {n_diff} "
                                 f"chains differ in depth/steps/divergence")
        rel = {}
        for i, name in ((0, "q"), (1, "pe"), (7, "h0")):
            a, b = got[i][same], want[i][same]
            err = (a - b).abs()
            if bool((err > 1e-4 * b.abs() + (1e-4 if i == 0 else 0)).any()):
                raise AssertionError(f"phase 9: K {kk} eps {eps}: {name} "
                                     f"max abs err {float(err.max())}")
            rel[name] = float((err / b.abs().clamp(min=1e-3)).max())
            if i == 0:
                nuts_err = max(nuts_err, float(err.max()))
        pe_chk = fn.fused_nuts_potential(got[0], *w, xb, sigma=sig)[0]
        inv = float(((got[1] - pe_chk).abs() / pe_chk.abs()).max())
        if inv > 1e-5:
            raise AssertionError(f"phase 9: pe' != pe(q'), rel err {inv}")
        n_div = int(got[4].sum())
        if eps == EPS_DIVERGE and n_div == 0:
            raise AssertionError(f"phase 9: no chain diverged at eps {eps}")
        depth = torch.bincount(got[5][:, 0].long(), minlength=kk + 1)
        lines.append(
            f"K {kk} eps {eps}: {n_diff} chains differ, {n_div} diverged, "
            f"depths {depth.tolist()}, max rel err q {rel['q']:.2e} pe "
            f"{rel['pe']:.2e} h0 {rel['h0']:.2e}, pe'=pe(q') rel err "
            f"{inv:.2e}")
    # the keyed entry, which the main path runs: its in-kernel draws
    # against nuts_streams on the card, and its transition against the
    # injected kernel fed those streams, bit for bit, twice
    key = StreamKey(9, 2, 1)
    for kk in (NUTS_K, GENERIC_DEPTH):
        drawn = fn.fused_nuts_draws(key, NUTS_CHAINS, dim, kk, dev)
        want = nuts_streams(key, NUTS_CHAINS, dim, kk, dev)
        for name, d_out, s_out in zip(want._fields, drawn, want):
            if not torch.equal(d_out, s_out):
                raise AssertionError(
                    f"phase 9: in-kernel {name} draws at K {kk} differ from "
                    f"nuts_streams, max abs "
                    f"{float((d_out - s_out).abs().max())}")
    kw = dict(sigma=sig, max_doublings=NUTS_K)
    injected = fn.fused_nuts_transition(
        q0, pe_k, g_k, *nuts_streams(key, NUTS_CHAINS, dim, NUTS_K, dev),
        EPS_SMALL, ones, *w, xb, **kw)
    for call in range(2):
        keyed = fn.fused_nuts_transition_keyed(q0, pe_k, g_k, key, EPS_SMALL,
                                               ones, *w, xb, **kw)
        for i, (k_out, i_out) in enumerate(zip(keyed, injected)):
            if not torch.equal(k_out, i_out):
                raise AssertionError(
                    f"phase 9: keyed call {call + 1}, output {i} differs "
                    f"from the injected kernel's on nuts_streams, max abs "
                    f"{float((k_out - i_out).abs().max())}")
    lines.append(f"in-kernel draws = nuts_streams bit for bit (K {NUTS_K}, "
                 f"{GENERIC_DEPTH}); keyed = injected bit for bit, twice")
    print(f"phase 9 transition ok ({NUTS_CHAINS} chains): "
          + "; ".join(lines), flush=True)

    # -- 10. NUTS main path through the user's entry points --------------
    out = dlgm.run_svi(dlgm.Config(**NUTS_SVI, seed=0, device="cuda"))
    lp = (out["decoder"], out["decoder_params"], out["sigma_x"],
          out["x"][:NUTS_ROWS])
    fn.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    mcmc_f, res_f = dlgm.local_posterior_mcmc_fused(
        ncfg, *lp, max_doublings=NUTS_K, run_seed=2)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t
    nuts_launches = fn.LAUNCHES
    if nuts_launches < NUTS_WARMUP + NUTS_SAMPLES:
        raise AssertionError(f"phase 10: the fused path launched the kernel "
                             f"{nuts_launches} times")
    torch.cuda.synchronize()
    t = time.perf_counter()
    # another seed: with the same one both paths would draw the same
    # streams and, to float rounding, run the same chains
    mcmc_g, res_g = dlgm.local_posterior_mcmc(ncfg, *lp, 3)
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t
    paths = {"local_posterior_mcmc_fused": _posterior(diag, torch, res_f,
                                                      wall_f),
             "local_posterior_mcmc": _posterior(diag, torch, res_g, wall_g)}
    for name, st in paths.items():
        if not st["max_rhat"] < 1.01:
            raise AssertionError(f"phase 10: {name} max split-R-hat "
                                 f"{st['max_rhat']}")
    # the two paths' per-coordinate mean and variance of z agree within
    # 5 x their combined Monte-Carlo error (the variance's from the MCSE
    # of the squared deviations); 1e-6 covers float rounding only
    qf, qg = res_f.unconstrained, res_g.unconstrained
    mf, mg = qf.mean((0, 1)), qg.mean((0, 1))
    sqf, sqg = (qf - mf) ** 2, (qg - mg) ** 2
    ratios = {}
    for name, gap, bound in (
            ("mean", mf - mg, diag.mcse(qf) + diag.mcse(qg)),
            ("var", sqf.mean((0, 1)) - sqg.mean((0, 1)),
             diag.mcse(sqf) + diag.mcse(sqg))):
        ratio = gap.abs() / (5 * bound + 1e-6)
        if bool((ratio > 1).any()):
            raise AssertionError(f"phase 10: posterior {name}s differ, max "
                                 f"|gap| / bound {float(ratio.max())}")
        ratios[name] = float(ratio.max())
    print(f"phase 10 NUTS main path ok [{card}]: decoder sigma_x "
          f"{out['sigma_x']:.4f}; {NUTS_CHAINS} chains x {NUTS_ROWS} rows, "
          f"{NUTS_WARMUP} warmup + {NUTS_SAMPLES} samples; "
          + "; ".join(
              f"{k}: min ESS {v['min_ess']:.1f}, max R-hat "
              f"{v['max_rhat']:.4f}, divergences {v['divergences']}, "
              f"wall {v['wall_s']:.2f} s, min-ESS/s {v['ess_per_s']:.1f}, "
              f"{v['leapfrogs']:.2f} leapfrogs/transition, step size "
              f"{v['step_size']:.4f}" for k, v in paths.items())
          + f"; max |gap| / 5 MCSE: mean {ratios['mean']:.3f}, variance "
          f"{ratios['var']:.3f}; kernel launches {nuts_launches}", flush=True)

    # -- 11. NUTS times: one transition, then traces of both paths -------
    def start(mcmc, res):
        q = res.unconstrained[:, -1].contiguous()
        pe, g = mcmc._potential_and_grad(q)
        return IntegratorState(q, torch.zeros_like(q), pe, g)

    # device time per call of the keyed entry (the main path's) and of the
    # injected one; the plain version on the injected streams
    st = start(mcmc_f, res_f)
    step, inv_mass = res_f.extra["step_size"], res_f.extra["inv_mass"]
    wf = fn.decoder_weights(lp[1])
    key = StreamKey(11, 2, 0)
    args = (st.q, st.pe[:, None], st.grad,
            *nuts_streams(key, NUTS_CHAINS, dim, NUTS_K, dev), step,
            inv_mass, *wf, lp[3])
    kargs = (st.q, st.pe[:, None], st.grad, key, step, inv_mass, *wf, lp[3])
    kw = dict(sigma=lp[2], max_doublings=NUTS_K)
    nuts_out = fn.fused_nuts_transition_keyed(*kargs, **kw)
    fn.fused_nuts_transition(*args, **kw)
    fn.reference_transition(*args, **kw)
    nuts_ms = _device_ms(
        torch, lambda: fn.fused_nuts_transition_keyed(*kargs, **kw), 20)
    inj_ms = _device_ms(
        torch, lambda: fn.fused_nuts_transition(*args, **kw), 20)
    nuts_plain_ms, _ = _cuda_ms(torch, lambda: fn.reference_transition(
        *args, **kw), 3)

    def sample_loop(mcmc, res, n):
        s0 = start(mcmc, res)

        def run():
            s = s0
            for i in range(n):
                s, _ = mcmc._sample_step(99, s, res.extra["step_size"],
                                         res.extra["inv_mass"], i)
        return run

    traces = {
        "fused NUTS sampling": _trace(
            torch, sample_loop(mcmc_f, res_f, TRACE_NUTS_FUSED),
            TRACE_NUTS_FUSED, "transition"),
        "generic NUTS sampling": _trace(
            torch, sample_loop(mcmc_g, res_g, TRACE_NUTS_GENERIC),
            TRACE_NUTS_GENERIC, "transition"),
        # the user's whole call, warmup adaptation included
        "whole local_posterior_mcmc_fused run": _trace(
            torch, lambda: dlgm.local_posterior_mcmc_fused(
                ncfg, *lp, max_doublings=NUTS_K, run_seed=4),
            NUTS_WARMUP + NUTS_SAMPLES, "transition"),
        # what the host drew per transition before the draws moved into
        # the kernel
        "nuts_streams alone": _trace(torch, lambda: [
            nuts_streams(StreamKey(12, 2, i), NUTS_CHAINS, dim, NUTS_K, dev)
            for i in range(TRACE_NUTS_FUSED)], TRACE_NUTS_FUSED, "call"),
    }
    print(f"phase 11 NUTS times ok [{card}]: one transition at the bench "
          f"state ({float(nuts_out[6].mean()):.2f} leapfrogs per chain): "
          f"kernel, keyed {nuts_ms:.4f} ms, injected {inj_ms:.4f} ms; "
          f"plain reference_transition {nuts_plain_ms:.4f} ms; kernel "
          f"time x launches over phase 10's fused wall "
          f"{100 * nuts_ms * nuts_launches / (1e3 * wall_f):.1f}%; "
          + "; ".join(f"{k} {v}" for k, v in traces.items()), flush=True)

    # the kernel's other instances beside the bench's widths, each from a
    # random start at EPS_SMALL (deeper, uneven trees: not the bench
    # state): the dlgm smoke config's widths at 64 rows (`guarded`) and a
    # decoder twice as wide (`staged`)
    widths = []
    for lat_, hid_, dat_ in ((8, 64, 32), (3, 16, 8), (8, 128, 64)):
        dec_ = dlgm.Decoder(lat_, hid_, dat_,
                            torch.Generator().manual_seed(0)).to(dev)
        w_ = fn.decoder_weights({k: p.detach()
                                 for k, p in dec_.named_parameters()})
        x_ = torch.as_tensor(rng.normal(size=(NUTS_ROWS, dat_))
                             .astype(np.float32), device=dev)
        q_ = torch.as_tensor((0.7 * rng.standard_normal(
            (NUTS_CHAINS, NUTS_ROWS * lat_))).astype(np.float32), device=dev)
        pe_, g_ = fn.fused_nuts_potential(q_, *w_, x_, sigma=sig)
        a_ = (q_, pe_, g_, key, torch.full((1,), EPS_SMALL, device=dev),
              torch.ones(NUTS_ROWS * lat_, device=dev), *w_, x_)
        kw_ = dict(sigma=sig, max_doublings=NUTS_K)
        o_ = fn.fused_nuts_transition_keyed(*a_, **kw_)
        ms_ = _device_ms(torch, lambda: fn.fused_nuts_transition_keyed(
            *a_, **kw_), 10)
        widths.append(f"latent {lat_}, hidden {hid_}, data {dat_}: "
                      f"{ms_:.4f} ms ({float(o_[6].mean()):.2f} leapfrogs)")
    print(f"phase 11 kernel at other widths, random start, eps {EPS_SMALL} "
          f"[{card}]: " + "; ".join(widths), flush=True)

    # bounds.  Per chain-leaf the plain version does three decoder
    # forwards' FLOP (benchmarks/roofline.py), at the FP32 rate; the kernel
    # runs the four products (z W1, a W2, r W2^T, da W1^T: two forwards'
    # FLOP) as three TF32 passes on the tensor cores, the bound of the units
    # it uses, which the kernels line carries.  Over the leaves this
    # transition took; bytes: every input read once, every output written
    # once (the keyed entry reads no streams).
    lat, hid, dat = ncfg.latent_dim, ncfg.hidden, ncfg.data_dim
    leaves = float(nuts_out[6].sum())
    fwd = 2 * NUTS_ROWS * (lat * hid + hid * dat)
    nuts_bytes = 4 * (NUTS_CHAINS * (4 * dim + 7) + dim
                      + sum(t.numel() for t in wf) + NUTS_ROWS * dat)
    fp32_bound = _bound(leaves * 3 * fwd, nuts_bytes)
    tc_bound = _bound(leaves * 3 * 2 * fwd, nuts_bytes, PEAK_TF32)
    print(f"phase 11 bounds: FP32 {fp32_bound[0]:.4f} ms ({fp32_bound[1]}), "
          f"TF32 tensor cores x3 {tc_bound[0]:.4f} ms ({tc_bound[1]}); "
          f"kernel at {100 * tc_bound[0] / nuts_ms:.1f}% of the latter",
          flush=True)
    return _record("fused_nuts_transition", "fused_nuts.cu",
                   "bayesic_tpu/ops/fused_nuts.py:573", nuts_launches,
                   nuts_err, nuts_ms, nuts_plain_ms, tc_bound)


def _hier_phases(torch, np, card, dev):
    """Phases 12-16, the hierarchical-logistic path; returns the kernels
    line's entries of its two kernels."""
    from bayesic_tpu_torch.infer.mcmc import (MCMC, IntegratorState,
                                              StreamKey, nuts_streams)
    from bayesic_tpu_torch.models import hier_logistic as hl
    from bayesic_tpu_torch.ops import _build
    from bayesic_tpu_torch.ops import _kernel_common as kc
    from bayesic_tpu_torch.ops import fused_hier as fh
    from bayesic_tpu_torch.ops import fused_nuts_hier as fnh
    from bayesic_tpu_torch.utils import diagnostics as diag

    cfg = hl.Config(device="cuda")
    xn, yn, gn, truth = hl.make_data(cfg)
    x, y, group = (torch.as_tensor(a, device=dev) for a in (xn, yn, gn))
    n, j, f, b = x.shape[0], cfg.num_groups, cfg.num_features, \
        cfg.batch_size
    p = 2 + j + f
    steps = cfg.svi_steps
    rng = np.random.default_rng(12)

    def rnd(*shape, loc=0.0, scale=1.0):
        return torch.as_tensor(
            (loc + scale * rng.standard_normal(shape)).astype(np.float32),
            device=dev)

    # -- 12. the fused hier trainer against its plain version ------------
    perm = torch.as_tensor(rng.permutation(n), device=dev)
    xs, ys, gs = x[perm], y[perm], group[perm]
    loc0, ls0 = rnd(p, scale=0.5), rnd(p, loc=-2.0, scale=0.3)
    zeros = tuple(torch.zeros(p, device=dev) for _ in range(4))
    kw = dict(lr0=cfg.lr, lr_total=steps, batch=b)
    seed = 12345
    gates = {}
    for batch in (b, HIER_L2_BATCH):
        geo = fh.geometry(f, j, batch)
        if geo["instance"] != ("staged" if batch == b else "l2"):
            raise AssertionError(f"phase 12: B {batch} takes the "
                                 f"{geo['instance']} instance")
        gates[batch] = (geo, _hier_trainer_gates(
            torch, fh, kc, (xs, ys, gs), (loc0, ls0, zeros), rng, rnd,
            dict(kw, batch=batch), seed))
    svi_err = max(g[1][0] for g in gates.values())
    loc_i, ls_i, _ = fh.init_params(j, f, device=dev)
    lk = fh.fused_train(xs, ys, gs, loc_i, ls_i, steps=steps, lr0=cfg.lr,
                        seed=seed, batch=b)[3].cpu().numpy()
    if not (np.isfinite(lk).all() and lk[-100:].mean() < lk[:50].mean()):
        raise AssertionError(f"phase 12: {steps}-step Philox run: loss did "
                             f"not fall or is not finite")
    print("phase 12 fused hier trainer ok: " + "; ".join(
        f"B {batch} ({geo['instance']}, {geo['smem_bytes']} B of shared "
        f"memory): one step grads max abs err {e_:.3e} (worst err/tol "
        f"{w_:.3f}), loss rel err {l1:.2e}; {HIER_TRAJ}-step trajectory "
        f"loss max rel err {tr:.2e}, param max err / max {pr:.2e}; Philox "
        f"twin loss rel err {bt:.2e}"
        for batch, (geo, (e_, w_, l1, tr, pr, bt)) in gates.items())
        + f"; {steps} Philox steps: loss {lk[:50].mean():.1f} -> "
        f"{lk[-100:].mean():.1f}", flush=True)

    # -- 13. the hier SVI path through the user's entry points ------------
    t = time.perf_counter()
    out_g = hl.run_svi(cfg)
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t
    fh.LAUNCHES = 0
    t = time.perf_counter()
    out_f = hl.run_svi_fused(cfg)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t
    svi_launches = fh.LAUNCHES
    if svi_launches < 1:
        raise AssertionError("phase 13: run_svi_fused never launched the "
                             "kernel")
    fits = {}
    for name, out, tail in (("run_svi", out_g, 200), ("run_svi_fused",
                                                      out_f, 100)):
        ls_, m = out["losses"], out["mean_u"]
        mu, beta = float(m["mu"]), m["beta"].cpu().numpy()
        if not np.isfinite(ls_).all() or not ls_[-tail:].mean() \
                < ls_[:tail // 4].mean():
            raise AssertionError(f"phase 13: {name} loss did not fall")
        if abs(mu - truth["mu"]) > 0.5 or \
                np.abs(beta - truth["beta"]).max() > 0.15:
            raise AssertionError(f"phase 13: {name} mu {mu}, beta {beta}; "
                                 f"truth {truth['mu']}, {truth['beta']}")
        fits[name] = (mu, beta, float(ls_[-tail:].mean()))
    (mu_g, beta_g, last_g), (mu_f, beta_f, last_f) = fits.values()
    gap = abs(last_g - last_f) / abs(last_g)
    if abs(mu_g - mu_f) > 0.15 or np.abs(beta_g - beta_f).max() > 0.1 \
            or gap > 0.02:
        raise AssertionError(f"phase 13: the two fits differ: mu {mu_g} / "
                             f"{mu_f}, last-200-step loss {last_g} / "
                             f"{last_f}")
    gen = torch.Generator(device=dev).manual_seed(1)
    svi, res = out_g["svi"], out_g["result"]
    g_ms, _ = _cuda_ms(torch, lambda: svi.run(gen, 300, state=res.state))
    f_ms, _ = _cuda_ms(torch, lambda: fh.fused_train(
        *out_f["data"], out_f["loc"], out_f["ls"], out_f["opt_state"],
        steps=steps, lr0=cfg.lr, lr_total=2 * steps, seed=7, batch=b,
        t0=steps))
    hier_step_ms = f_ms / steps
    # the call's own cost (packing the rows, the wrapper's checks): a
    # one-step call; the kernel's step is the difference over the rest
    one_ms, _ = _cuda_ms(torch, lambda: fh.fused_train(
        *out_f["data"], out_f["loc"], out_f["ls"], out_f["opt_state"],
        steps=1, lr0=cfg.lr, lr_total=2 * steps, seed=7, batch=b,
        t0=steps), 3)
    kernel_step_ms = (f_ms - one_ms) / (steps - 1)
    probe = fh.probe_cycles(*out_f["data"], out_f["loc"], out_f["ls"],
                            out_f["opt_state"], steps=steps, lr0=cfg.lr,
                            lr_total=2 * steps, seed=7, batch=b, t0=steps)
    # the row loop of the bench instance (F 5, rows staged, no probe): its
    # SASS instructions and MUFU ops a row, and one SM's floor a step for
    # B rows: the instructions at 4 x 32 lanes a clock, the MUFU at 16
    loop = [st for st in _sass_loop_stats(_build.load()._name,
                                          "hier_train_kernel", per=1)
            if st[0] == f"{f},1,0" and st[2] == 1 and st[4] >= 2]
    if not loop:
        raise AssertionError("phase 13: no row loop in hier_train_kernel")
    _, n_ins, _, _, n_mufu = loop[0]
    step_floor = {"issue": b * n_ins / 128, "MUFU": b * n_mufu / 16}
    print(f"phase 13 hier trainer [{card}]: {1e3 * hier_step_ms:.4f} us a "
          f"step ({steps} steps from t0 {steps}, CUDA events over the "
          f"call), {1e3 * kernel_step_ms:.4f} us without the call's own "
          f"{one_ms:.4f} ms (a one-step call); probe, "
          f"cycles a sampled step on theta_0's owner ("
          f"{probe['sampled']} steps): " + ", ".join(
              f"{k} {v:.1f}" for k, v in probe["phases"].items())
          + f"; {probe['loop']:.1f} a step over the loop; row loop "
          f"{n_ins} SASS instructions a row, MUFU {n_mufu}; one SM's "
          f"floor a step: issue {step_floor['issue']:.0f} cycles "
          f"({1e6 * step_floor['issue'] / SM_CLOCK:.4f} us), MUFU "
          f"{step_floor['MUFU']:.0f} cycles "
          f"({1e6 * step_floor['MUFU'] / SM_CLOCK:.4f} us)", flush=True)
    print(f"phase 13 hier SVI main path ok [{card}]: run_svi mu "
          f"{mu_g:.3f} beta err {np.abs(beta_g - truth['beta']).max():.3f} "
          f"final-200 loss {last_g:.1f}, wall {wall_g:.2f} s, "
          f"{3e5 / g_ms:.1f} steps/s; run_svi_fused mu {mu_f:.3f} beta err "
          f"{np.abs(beta_f - truth['beta']).max():.3f} final-200 loss "
          f"{last_f:.1f} (gap {100 * gap:.3f}%), wall {wall_f:.2f} s, "
          f"{1e3 / hier_step_ms:.1f} steps/s; truth mu {truth['mu']}; "
          f"kernel launches {svi_launches}", flush=True)

    # -- 14. the hier NUTS kernel against its plain version ---------------
    data = fnh.hier_data(x, y, group, j)
    model = hl.make_model(j, f, None, centered=True)
    q0 = _hier_start(torch, truth, j, p, rnd, dev)
    hier_nuts_err, lines = _hier_nuts_check(torch, fnh, data, model, q0,
                                            (x, y, group))
    # the same gates at a shape whose rows do not fit in shared memory
    cfg_l2 = hl.Config(obs_per_group=HIER_L2_ROWS // j)
    xl, yl, gl, truth_l2 = hl.make_data(cfg_l2)
    xl, yl, gl = (torch.as_tensor(a, device=dev) for a in (xl, yl, gl))
    data_l2 = fnh.hier_data(xl, yl, gl, j)
    err_l2, lines_l2 = _hier_nuts_check(
        torch, fnh, data_l2, model, _hier_start(torch, truth_l2, j, p, rnd,
                                                dev), (xl, yl, gl))
    geo = {name: fnh.hier_geometry(d_, HIER_K)
           for name, d_ in (("bench", data), ("l2", data_l2))}
    if geo["bench"]["instance"] != "resident" or \
            geo["l2"]["instance"] != "l2":
        raise AssertionError(f"phase 14: instances {geo}")
    hier_nuts_err = max(hier_nuts_err, err_l2)
    print(f"phase 14 hier NUTS kernel ok ({HIER_CHAINS} chains x D {p}): "
          f"N {n}, rows resident in shared memory: " + "; ".join(lines)
          + f"; N {xl.shape[0]}, rows read from L2: " + "; ".join(lines_l2),
          flush=True)

    # -- 15. the hier NUTS path through the user's entry points -----------
    fnh.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    mcmc_f = hl.fused_nuts_mcmc(j, f, x, y, group, num_warmup=HIER_WARMUP,
                                num_samples=HIER_SAMPLES,
                                num_chains=HIER_CHAINS, target_accept=0.85,
                                max_doublings=HIER_K)
    res_f = mcmc_f.run(2)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t
    nuts_launches = fnh.LAUNCHES
    if nuts_launches < HIER_WARMUP + HIER_SAMPLES:
        raise AssertionError(f"phase 15: the fused path launched the kernel "
                             f"{nuts_launches} times")
    torch.cuda.synchronize()
    t = time.perf_counter()
    mcmc_g = MCMC(model, num_warmup=HIER_WARMUP, num_samples=HIER_SAMPLES,
                  num_chains=HIER_CHAINS, shared_adapt=True,
                  model_args=(x, y, group), target_accept=0.85,
                  max_depth=HIER_DEPTH)
    res_g = mcmc_g.run(3)
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t
    paths = {"fused_nuts_mcmc": _posterior(diag, torch, res_f, wall_f),
             "MCMC (generic)": _posterior(diag, torch, res_g, wall_g)}
    for name, st in paths.items():
        if not st["max_rhat"] < 1.01:
            raise AssertionError(f"phase 15: {name} max split-R-hat "
                                 f"{st['max_rhat']}")
    qf, qg = res_f.unconstrained, res_g.unconstrained
    mf, mg = qf.mean((0, 1)), qg.mean((0, 1))
    sqf, sqg = (qf - mf) ** 2, (qg - mg) ** 2
    ratios = {}
    for name, gap_, bound in (
            ("mean", mf - mg, diag.mcse(qf) + diag.mcse(qg)),
            ("var", sqf.mean((0, 1)) - sqg.mean((0, 1)),
             diag.mcse(sqf) + diag.mcse(sqg))):
        ratio = gap_.abs() / (5 * bound + 1e-6)
        if bool((ratio > 1).any()):
            raise AssertionError(f"phase 15: posterior {name}s differ, max "
                                 f"|gap| / bound {float(ratio.max())}")
        ratios[name] = float(ratio.max())
    nuts_mu = {k: float(r.samples["mu"].mean())
               for k, r in (("fused", res_f), ("generic", res_g))}
    print(f"phase 15 hier NUTS main path ok [{card}]: {HIER_CHAINS} chains, "
          f"{HIER_WARMUP} warmup + {HIER_SAMPLES} samples; "
          + "; ".join(
              f"{k}: min ESS {v['min_ess']:.1f}, max R-hat "
              f"{v['max_rhat']:.4f}, divergences {v['divergences']}, "
              f"wall {v['wall_s']:.2f} s, min-ESS/s {v['ess_per_s']:.1f}, "
              f"{v['leapfrogs']:.2f} leapfrogs/transition, step size "
              f"{v['step_size']:.4f}" for k, v in paths.items())
          + f"; max |gap| / 5 MCSE: mean {ratios['mean']:.3f}, variance "
          f"{ratios['var']:.3f}; SVI-vs-NUTS gap on mu: run_svi_fused vs "
          f"fused NUTS {abs(mu_f - nuts_mu['fused']):.4f}, run_svi vs "
          f"generic NUTS {abs(mu_g - nuts_mu['generic']):.4f}; kernel "
          f"launches {nuts_launches}", flush=True)

    # -- 16. times: kernels against plain versions, traces ----------------
    # device time per call of the keyed entry (the main path's) and of the
    # injected one; the plain version on the injected streams
    q = res_f.unconstrained[:, -1].contiguous()
    pe, g = fnh.fused_hier_nuts_potential(q, data)
    key = StreamKey(16, 2, 0)
    args = (q, pe, g, *nuts_streams(key, HIER_CHAINS, p, HIER_K, dev),
            res_f.extra["step_size"], res_f.extra["inv_mass"], data)
    kargs = (q, pe, g, key, *args[7:])
    tr_out = fnh.fused_hier_nuts_transition_keyed(*kargs,
                                                  max_doublings=HIER_K)
    fnh.fused_hier_nuts_transition(*args, max_doublings=HIER_K)
    fnh.reference_transition(*args, max_doublings=HIER_K)
    tr_ms = _device_ms(torch, lambda: fnh.fused_hier_nuts_transition_keyed(
        *kargs, max_doublings=HIER_K), 20)
    tr_inj_ms = _device_ms(torch, lambda: fnh.fused_hier_nuts_transition(
        *args, max_doublings=HIER_K), 20)
    tr_plain_ms, _ = _cuda_ms(torch, lambda: fnh.reference_transition(
        *args, max_doublings=HIER_K), 3)
    off = torch.as_tensor(rng.integers(0, n, HIER_PLAIN_STEPS), device=dev)
    eps = rnd(HIER_PLAIN_STEPS, p)
    fh.reference_train(xs, ys, gs, loc0, ls0, zeros, off_stream=off[:10],
                       eps_stream=eps[:10], **kw)
    plain_ms, _ = _cuda_ms(torch, lambda: fh.reference_train(
        xs, ys, gs, loc0, ls0, zeros, off_stream=off, eps_stream=eps, **kw))
    plain_step_ms = plain_ms / HIER_PLAIN_STEPS

    def sample_loop(mcmc, res, k):
        q_ = res.unconstrained[:, -1].contiguous()
        pe_, g_ = mcmc._potential_and_grad(q_)
        s0 = IntegratorState(q_, torch.zeros_like(q_), pe_, g_)

        def run():
            s_ = s0
            for i in range(k):
                s_, _ = mcmc._sample_step(99, s_, res.extra["step_size"],
                                          res.extra["inv_mass"], i)
        return run

    traces = {
        "fused NUTS sampling": _trace(
            torch, sample_loop(mcmc_f, res_f, TRACE_NUTS_FUSED),
            TRACE_NUTS_FUSED, "transition"),
        "generic NUTS sampling": _trace(
            torch, sample_loop(mcmc_g, res_g, TRACE_NUTS_GENERIC),
            TRACE_NUTS_GENERIC, "transition"),
    }
    leaves = float(tr_out[6].sum())
    deepest = int(tr_out[6].max())
    depths = torch.bincount(tr_out[5][:, 0].long(),
                            minlength=HIER_K + 1).tolist()
    geo = fnh.hier_geometry(data, HIER_K)
    # one SM's floor a leaf of one chain: the N rows' SASS instructions at
    # 4 warp-instructions a clock, or their MUFU ops at 16 lanes a clock,
    # of the bench instance
    loop = [st for st in _sass_loop_stats(_build.load()._name,
                                          "nuts_kernel", per=1)
            if st[0] == f"{geo['threads']},{geo['threads']},{f},1"]
    if not loop:
        raise AssertionError("phase 16: no row loop in nuts_kernel<Hier>")
    _, n_ins, items, _, n_mufu = loop[0]
    leaf_floor = {"issue": 1e3 * n * n_ins / items / (128 * SM_CLOCK),
                  "MUFU": 1e3 * n * n_mufu / items / (16 * SM_CLOCK)}
    floor_by = max(leaf_floor, key=leaf_floor.get)
    print(f"phase 16 hier times ok [{card}]: one transition at the adapted "
          f"state ({leaves / HIER_CHAINS:.2f} leapfrogs per chain, depths "
          f"{depths}, the deepest chain {deepest} leaves): kernel, "
          f"keyed {tr_ms:.4f} ms, injected {tr_inj_ms:.4f} ms; plain "
          f"reference_transition {tr_plain_ms:.4f} ms; launch "
          f"{HIER_CHAINS} blocks of {geo['threads']} threads, "
          f"{geo['smem_bytes']} B of shared memory, {geo['chunks']} chunks "
          f"of at most {geo['depth']} rows, rows {geo['instance']}; row "
          f"loop {n_ins / items:.1f} SASS instructions a row, MUFU "
          f"{n_mufu / items:.2f}; one SM's floor a leaf: issue "
          f"{1e3 * leaf_floor['issue']:.3f} us, MUFU "
          f"{1e3 * leaf_floor['MUFU']:.3f} us; critical path {deepest} "
          f"leaves x {floor_by} floor = "
          f"{deepest * leaf_floor[floor_by]:.4f} ms; fused trainer "
          f"{hier_step_ms:.5f} ms/step, plain reference_train "
          f"{plain_step_ms:.4f} ms/step; "
          + "; ".join(f"{k} {v}" for k, v in traces.items()), flush=True)

    # bounds.  Per row of the likelihood: the logit (F FMAs and the
    # intercept), softplus and sigmoid (exp, log1p, one division, ~6 more),
    # d/dlogit and the sums (~6), the beta gradient (F FMAs): 4F + 14
    # operations.  SVI step: B rows and ~40 operations per parameter
    # (noise, z, gradient, two Adam updates); bytes: the data set read
    # once per call, the parameters and both moment pairs read and written
    # once, the losses written, over the call's steps.  NUTS transition:
    # N rows per chain-leaf over the leaves this transition took, and the
    # larger of that at the FP32 peak and the SFU ops the function needs at
    # the SFU rate: a row's exp and its sigmoid's reciprocal, and one log
    # per kChunk rows (log1p as the log of their 1 + e's product,
    # gmm_lik.cuh); bytes: every input read once (the rows as hier_data
    # lays them out), every output written once (the keyed entry reads no
    # streams).
    row_ops = 4 * f + 14
    svi_bound = _bound(b * row_ops + 40 * p,
                       4 * (n * (f + 2) + 12 * p + steps) / steps)
    rows_bytes = sum(t.numel() * t.element_size() for t in
                     (data.xc, data.ybits, data.chunks, data.chunk_off))
    nuts_bound = _bound(leaves * (n * row_ops + 10 * p),
                        rows_bytes + 4 * (p + HIER_CHAINS * (4 * p + 7)))
    k_chunk = int(re.search(r"kChunk = (\d+);", (
        _build.CSRC / "gmm_lik.cuh").read_text()).group(1))
    sfu_ms = _sfu_ms((2 + 1 / k_chunk) * leaves * n)
    print(f"phase 16 hier NUTS bounds: FP32 {nuts_bound[0]:.4f} ms "
          f"({nuts_bound[1]}), SFU {sfu_ms:.4f} ms; critical path "
          f"{deepest * leaf_floor[floor_by]:.4f} ms", flush=True)
    nuts_bound = max(nuts_bound, (sfu_ms, "operations"))
    return [
        _record("fused_hier_train", "fused_hier.cu",
                "bayesic_tpu/ops/fused_hier.py:185", svi_launches, svi_err,
                hier_step_ms, plain_step_ms, svi_bound),
        _record("fused_hier_nuts_transition", "fused_nuts_hier.cu",
                "bayesic_tpu/ops/fused_nuts_hier.py:175", nuts_launches,
                hier_nuts_err, tr_ms, tr_plain_ms, nuts_bound),
    ]


def _hier_trainer_gates(torch, fh, kc, data, state, rng, rnd, kw, seed):
    """Phase 12's gates at one batch: one injected step's gradients (read
    off Adam's first moment) within 1e-4 rel + 1e-5 of the largest, its
    loss, a HIER_TRAJ-step injected trajectory and its Philox twin within
    rel 1e-5 of the plain version.  Returns (grad max abs err, worst
    err/tol, one-step loss rel err, trajectory loss rel err, param max err
    / max, Philox twin loss rel err)."""
    xs, ys, gs = data
    loc0, ls0, zeros = state
    n, p, b = xs.shape[0], loc0.numel(), kw["batch"]
    j = p - 2 - xs.shape[1]

    def streams(k):
        return (torch.as_tensor(rng.integers(0, n, k), device=xs.device),
                rnd(k, p))

    off, eps = streams(1)
    _, _, (m1, m2, _, _), l1 = fh.fused_train_injected(
        xs, ys, gs, loc0, ls0, zeros, off_stream=off, eps_stream=eps, **kw)
    torch.cuda.synchronize()
    elbo, g_loc, g_ls = fh._step_math(
        loc0, ls0, *fh._block(xs, ys.float(), gs, int(off[0]), b), eps[0],
        n / b, j)
    err_max, worst = 0.0, 0.0
    # one Adam step from zero moments: m = -0.1 g
    for name, got, want in (("loc", -m1 / 0.1, g_loc), ("ls", -m2 / 0.1,
                                                        g_ls)):
        err = (got - want).abs()
        tol = 1e-4 * want.abs() + 1e-5 * float(want.abs().max())
        if bool((err > tol).any()):
            raise AssertionError(f"phase 12: B {b}: grad {name} differs, "
                                 f"max abs err {float(err.max())}")
        err_max = max(err_max, float(err.max()))
        worst = max(worst, float((err / tol).max()))
    loss_err = abs(float(l1[0]) + float(elbo)) / abs(float(elbo))
    off, eps = streams(HIER_TRAJ)
    got = fh.fused_train_injected(xs, ys, gs, loc0, ls0, zeros,
                                  off_stream=off, eps_stream=eps, **kw)
    want = fh.reference_train(xs, ys, gs, loc0, ls0, zeros, off_stream=off,
                              eps_stream=eps, **kw)
    traj_rel = float(((got[3] - want[3]).abs() / want[3].abs()).max())
    par_rel = max(float((g_ - w_).abs().max() / w_.abs().max())
                  for g_, w_ in ((got[0], want[0]), (got[1], want[1])))
    got = fh.fused_train(xs, ys, gs, loc0, ls0, zeros, steps=HIER_TRAJ,
                         lr0=kw["lr0"], lr_total=kw["lr_total"], seed=seed,
                         batch=b)
    off, eps = kc.hier_streams(seed, 0, HIER_TRAJ, n, p, device=xs.device)
    want = fh.reference_train(xs, ys, gs, loc0, ls0, zeros, off_stream=off,
                              eps_stream=eps, **kw)
    bits_rel = float(((got[3] - want[3]).abs() / want[3].abs()).max())
    if max(loss_err, traj_rel, bits_rel) > 1e-5:
        raise AssertionError(
            f"phase 12: B {b}: loss rel errs one step {loss_err}, "
            f"{HIER_TRAJ}-step trajectory {traj_rel}, Philox twin "
            f"{bits_rel} (limit 1e-5)")
    return err_max, worst, loss_err, traj_rel, par_rel, bits_rel


def _hier_start(torch, truth, j, p, rnd, dev):
    """Phase 14's chains: the truth plus N(0, 0.1) noise."""
    start = torch.zeros((HIER_CHAINS, p), device=dev)
    start[:, 0] = truth["mu"]
    start[:, 2:2 + j] = torch.as_tensor(truth["theta"], device=dev)
    start[:, 2 + j:] = torch.as_tensor(truth["beta"], device=dev)
    return start + rnd(HIER_CHAINS, p, scale=0.1)


def _hier_nuts_check(torch, fnh, data, model, q0, model_args):
    """Phase 14 at one shape: the kernel's potential against the plain
    version and autograd of the DSL model, one injected transition at three
    (K, eps) against the plain version (every chain's depth, steps and
    divergence equal; q, pe and h0 within 1e-4; pe' = pe(q')), and the
    keyed entry against the injected one bit for bit.  Returns (the largest
    |q'| error, the lines)."""
    from bayesic_tpu_torch.infer.mcmc import MCMC, StreamKey, nuts_streams

    dev, p = q0.device, q0.shape[1]
    pe_k, g_k = fnh.fused_hier_nuts_potential(q0, data)
    refs = {"plain": fnh.hier_potential(data)(q0),
            "autograd": MCMC(model, num_chains=HIER_CHAINS,
                             model_args=model_args)._potential_and_grad(q0)}
    lines = []
    for name, (pe_r, g_r) in refs.items():
        pe_rel = float(((pe_k[:, 0] - pe_r).abs() / pe_r.abs()).max())
        g_rel = float((g_k - g_r).abs().max() / g_r.abs().max())
        if pe_rel > 1e-5 or g_rel > 1e-5:
            raise AssertionError(f"phase 14: potential vs {name}: pe rel "
                                 f"err {pe_rel}, grad err / max|g| {g_rel}")
        lines.append(f"vs {name} pe max rel err {pe_rel:.2e}, grad max err "
                     f"/ max|g| {g_rel:.2e}")
    ones = torch.ones(p, device=dev)
    q_err = 0.0
    for kk, eps in ((HIER_K, HIER_EPS_SMALL), (HIER_K, HIER_EPS_DIVERGE),
                    (HIER_DEPTH, HIER_EPS_K10)):
        s = nuts_streams(StreamKey(14, 2, 0), HIER_CHAINS, p, kk, dev)
        args = (q0, pe_k, g_k, *s, eps, ones, data)
        got = fnh.fused_hier_nuts_transition(*args, max_doublings=kk)
        want = fnh.reference_transition(*args, max_doublings=kk)
        torch.cuda.synchronize()
        same = ((got[4] == want[4]) & (got[5] == want[5])
                & (got[6] == want[6]))[:, 0]
        n_diff = HIER_CHAINS - int(same.sum())
        if n_diff:
            raise AssertionError(f"phase 14: K {kk} eps {eps}: {n_diff} "
                                 f"chains differ in depth/steps/divergence")
        rel = {}
        for i, name in ((0, "q"), (1, "pe"), (7, "h0")):
            err = (got[i] - want[i]).abs()
            if bool((err > 1e-4 * want[i].abs()
                     + (1e-4 if i == 0 else 0)).any()):
                raise AssertionError(f"phase 14: K {kk} eps {eps}: {name} "
                                     f"max abs err {float(err.max())}")
            rel[name] = float((err / want[i].abs().clamp(min=1e-3)).max())
            if i == 0:
                q_err = max(q_err, float(err.max()))
        pe_chk = fnh.fused_hier_nuts_potential(got[0], data)[0]
        inv = float(((got[1] - pe_chk).abs() / pe_chk.abs()).max())
        if inv > 1e-5:
            raise AssertionError(f"phase 14: pe' != pe(q'), rel err {inv}")
        n_div = int(got[4].sum())
        if eps == HIER_EPS_DIVERGE and n_div == 0:
            raise AssertionError(f"phase 14: no chain diverged at eps {eps}")
        depth = torch.bincount(got[5][:, 0].long(), minlength=kk + 1)
        lines.append(
            f"K {kk} eps {eps}: 0 chains differ, {n_div} diverged, depths "
            f"{depth.tolist()}, max rel err q {rel['q']:.2e} pe "
            f"{rel['pe']:.2e} h0 {rel['h0']:.2e}, pe'=pe(q') rel err "
            f"{inv:.2e}")
    # the keyed entry (the main path's) against the injected kernel fed
    # nuts_streams on the card, bit for bit
    key = StreamKey(14, 2, 1)
    s = nuts_streams(key, HIER_CHAINS, p, HIER_K, dev)
    injected = fnh.fused_hier_nuts_transition(
        q0, pe_k, g_k, *s, HIER_EPS_SMALL, ones, data, max_doublings=HIER_K)
    keyed = fnh.fused_hier_nuts_transition_keyed(
        q0, pe_k, g_k, key, HIER_EPS_SMALL, ones, data, max_doublings=HIER_K)
    for i, (k_out, i_out) in enumerate(zip(keyed, injected)):
        if not torch.equal(k_out, i_out):
            raise AssertionError(f"phase 14: keyed output {i} differs from "
                                 f"the injected kernel's on nuts_streams")
    lines.append("keyed = injected bit for bit")
    return q_err, lines


def _gmm_phases(torch, np, card, dev):
    """Phases 17-20, the GMM tempered-SMC path; returns the kernels line's
    entries of its four kernels."""
    from bayesic_tpu_torch.dist import StickBreaking
    from bayesic_tpu_torch.infer.smc import stage_draws
    from bayesic_tpu_torch.models import gmm
    from bayesic_tpu_torch.ops import _build
    from bayesic_tpu_torch.ops import fused_smc_gmm as fsg
    from bayesic_tpu_torch.ops import gmm_logprob as glp

    cfg = gmm.Config(**GMM, device="cuda")
    xn, truth = gmm.make_data(cfg)
    x = torch.as_tensor(xn, device=dev)
    k, d = cfg.num_components, cfg.data_dim
    kmut, lsteps = cfg.mutation_steps, cfg.leapfrog_steps
    p_b, n_b = cfg.num_particles, cfg.num_data
    dim = (k - 1) + k * d + k
    rng = np.random.default_rng(17)

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def lik_inputs(p, n, k=k, d=d, rng=rng):
        xx, tr = (xn, truth) if (n, k, d) == (n_b, cfg.num_components,
                                             cfg.data_dim) \
            else gmm.make_data(gmm.Config(num_components=k, data_dim=d,
                                          num_data=n, seed=1))
        lw = np.log(rng.dirichlet(np.full(k, 2.0), p))
        mus = tr["centers"][None] + rng.normal(0.0, 1.0, (p, k, d))
        sig = np.exp(rng.normal(np.log(0.7), 0.3, (p, k)))
        return t32(xx), t32(lw), t32(mus), t32(sig), t32(rng.normal(size=p))

    def lik_errs(got, want):
        """ll rel err and gradient err / max|g| by name; the worst abs err
        into lik_err."""
        errs = {}
        for name, (got_ll, ll_ref) in got.items():
            err = (got_ll - ll_ref).abs()
            errs[f"{name} ll"] = float((err / ll_ref.abs()).max())
            lik_err[name] = max(lik_err[name], float(err.max()))
        for name, (gots, refs) in want.items():
            for gname, got_, ref in zip(("dlogw", "dmus", "dsig"), gots,
                                        refs):
                err = (got_ - ref).abs()
                errs[f"{name} {gname}"] = float(err.max()
                                                / ref.abs().max())
                lik_err[name] = max(lik_err[name], float(err.max()))
        return errs

    def lik_check(errs, tag):
        bad = {kk: v for kk, v in errs.items()
               if v > (1e-5 if kk.endswith(" ll") else 1e-4)}
        if bad:
            raise AssertionError(f"phase 17: {tag}: {bad} (limits: ll 1e-5 "
                                 f"relative, gradients 1e-4 of max|g|)")

    # -- 17. the likelihood kernels against their plain versions ----------
    # every kernel at every shape: the bench's and the odd one in full, the
    # others' worst; the forward's ll against the value+grad kernel's and
    # the backward's gradients against ct times its, bit for bit
    lik_err, lines = {"fwd": 0.0, "bwd": 0.0, "vg": 0.0}, []
    rng_vg = np.random.default_rng(170)
    worst, same = {}, {"fwd": [], "bwd": []}
    shapes = [(k, d, p_b, n_b), (k, d, GMM_ODD["p"], GMM_ODD["n"])]
    shapes += [(k, d, p, n) for p, n in GMM_VG_PN
               if (k, d, p, n) not in shapes] + list(GMM_VG_GENERIC)
    for i, (kk_, dd, p, n) in enumerate(shapes):
        xx, lw, mus, sig, ct = lik_inputs(p, n, kk_, dd,
                                          rng if i < 2 else rng_vg)
        ll = glp.gmm_loglik(xx, lw, mus, sig)
        params = [t.clone().requires_grad_() for t in (lw, mus, sig)]
        g_bwd = torch.autograd.grad(glp.gmm_loglik(xx, *params), params, ct)
        vg = glp.gmm_loglik_grad(xx, lw, mus, sig)
        torch.cuda.synchronize()
        want = glp.gmm_loglik_grad_reference(xx, lw, mus, sig)
        want_ct = glp.gmm_loglik_grad_reference(xx, lw, mus, sig, ct)
        ll_ref = glp.gmm_loglik_reference(xx, lw, mus, sig)
        errs = lik_errs({"fwd": (ll, ll_ref), "vg": (vg[0], want[0])},
                        {"bwd": (g_bwd, want_ct[1:]), "vg": (vg[1:],
                                                             want[1:])})
        tag = f"K {kk_} D {dd} P {p} N {n}"
        lik_check(errs, tag)
        same["fwd"].append(bool(torch.equal(ll, vg[0])))
        same["bwd"].append(all(
            torch.equal(g, c * v) for g, v, c in zip(
                g_bwd, vg[1:], (ct[:, None], ct[:, None, None],
                                ct[:, None]))))
        if i < 2:
            lines.append(f"{tag}: " + ", ".join(
                f"{kk} {v:.2e}" for kk, v in errs.items()))
        for kk, v in errs.items():
            worst[kk] = max(worst.get(kk, 0.0), v)
    n_pn = len(shapes) - 2 - len(GMM_VG_GENERIC)
    lines.append(f"all {len(shapes)} shapes ({n_pn} more P x N at K {k}, "
                 f"D {d}, {len(GMM_VG_GENERIC)} at K 8, D 4), worst: "
                 + ", ".join(f"{kk} {v:.2e}" for kk, v in worst.items()))
    lines.append(
        f"fwd ll = vg ll bit for bit at {sum(same['fwd'])} of "
        f"{len(shapes)} shapes, bwd = ct x vg gradients at "
        f"{sum(same['bwd'])} of {len(shapes)}" + "".join(
            f" ({kk} differs at " + ", ".join(
                "K {} D {} P {} N {}".format(*shapes[j])
                for j, ok in enumerate(v) if not ok) + ")"
            for kk, v in same.items() if not all(v)))
    print("phase 17 GMM likelihood kernels ok (worst ll rel err; worst "
          "gradient err / max|g|): " + "; ".join(lines), flush=True)

    # -- 18. the mutation kernel against mutation_core --------------------
    def near_truth(tr, p):
        base = torch.cat([
            StickBreaking().inverse(torch.as_tensor(tr["weights"])),
            torch.as_tensor(tr["centers"]).reshape(-1),
            torch.log(torch.as_tensor(tr["scales"]))]).to(dev)
        return base + t32(rng.normal(0.0, 0.03, (p, base.numel())))

    def one_transition(got, want, q0, log_u, pg_, beta, tag):
        """Phase 18's limits on one transition; returns (line, q' err)."""
        # a = exp(H0 - H1): float32 sums of |pe| ~ 1e3-1e4 round each
        # energy by ~2.4e-7 |pe| (phase 17), so log a may differ by
        # 2e-6 |pe| between two correct versions
        a_err = (got[2] - want[2]).abs()
        a_tol = want[2] * (2e-6 * pg_(q0, beta)[0].abs() + 1e-5) + 1e-6
        if bool((a_err > a_tol).any()):
            raise AssertionError(f"phase 18: {tag}: accept max err / "
                                 f"tolerance {float((a_err / a_tol).max())}")
        differ = (got[0] != q0).any(1) != (want[0] != q0).any(1)
        margin = (log_u[:, 0] - torch.log(want[2])).abs()[differ]
        if bool((margin >= 1e-2).any()):
            raise AssertionError(f"phase 18: {tag}: a decision differs "
                                 f"{float(margin.max())} from its threshold")
        agree = ~differ
        m_max = float(margin.max()) if margin.numel() else 0.0
        q_err = (got[0] - want[0]).abs()[agree]
        ll_rel = ((got[1] - want[1]).abs() / want[1].abs())[agree]
        if bool((q_err > 1e-4 + 1e-4 * want[0].abs()[agree]).any()) \
                or float(ll_rel.max()) > 1e-5:
            raise AssertionError(f"phase 18: {tag}: q' max err "
                                 f"{float(q_err.max())}, ll' rel err "
                                 f"{float(ll_rel.max())}")
        return (f"accept max abs err {float(a_err.max()):.2e} (err/tol "
                f"{float((a_err / a_tol).max()):.3f}), {int(differ.sum())} "
                f"decisions differ (max |log u - log a| {m_max:.1e}), q' max "
                f"err {float(q_err.max()):.2e}, ll' rel err "
                f"{float(ll_rel.max()):.2e}"), float(q_err.max())

    def ll_matches_q(got, pg_, beta, tag):
        ll_chk = pg_(got[0], beta)[2]
        inv = float(((got[1] - ll_chk).abs() / ll_chk.abs()).max())
        if inv > 1e-5:
            raise AssertionError(f"phase 18: {tag}: ll' != ll(q'), rel err "
                                 f"{inv}")
        return inv

    pg = fsg.make_gmm_potential_flat(x, k, d)
    q0 = near_truth(truth, p_b)
    m_inv = torch.ones(dim, device=dev)
    mut_err, lines = 0.0, []
    for beta, eps in GMM_BETA_EPS:
        for kk in (1, kmut):
            mom = t32(rng.normal(size=(kk, p_b, dim)))
            log_u = t32(np.log(rng.uniform(size=(p_b, kk))))
            got = fsg.fused_gmm_mutate(q0, mom, log_u, beta, eps, m_inv, x,
                                       k=k, d=d, kmut=kk, lsteps=lsteps)
            want = fsg.mutation_core(q0, mom, log_u, beta, eps, m_inv, pg,
                                     kk, lsteps, 0.65)
            torch.cuda.synchronize()
            tag = f"beta {beta} eps {eps} K {kk}"
            if kk == 1:
                extra, q_err = one_transition(got, want, q0, log_u, pg, beta,
                                              tag)
                mut_err = max(mut_err, q_err)
            else:
                # With K > 1 a block's adaptation feeds its mean accept back
                # into its step size, which amplifies the float32 rounding
                # of energies of |pe| ~ 1e3-1e4 (K = 1 shows the accept
                # differences it leaves); a differing decision moves its
                # block's step too.  So the adaptation's outcome is
                # compared: per-block steps, the pooled next-stage step,
                # the mean accept and the share of particles whose q' part
                e_rel = (got[3] - want[3]).abs() / want[3]
                g_k, g_p = (torch.exp(torch.log(e).mean())
                            for e in (got[3], want[3]))
                kept = (got[0] - want[0]).abs().amax(1) <= 1e-3
                ll_rel = ((got[1] - want[1]).abs() / want[1].abs())[kept]
                stats = {"step": float(e_rel.max()),
                         "next step": float((g_k - g_p).abs() / g_p),
                         "accept": float((got[2].mean()
                                          - want[2].mean()).abs()),
                         "parted": 1.0 - float(kept.float().mean()),
                         "ll kept": float(ll_rel.max())}
                bad = {kk: v for kk, v in stats.items()
                       if v > GMM_K5_TOL[kk]}
                if bad:
                    raise AssertionError(f"phase 18: {tag}: {bad} (limits "
                                         f"{GMM_K5_TOL})")
                extra = (f"per-block step max rel err {stats['step']:.2e} "
                         f"(median {float(e_rel.median()):.2e}), next step "
                         f"rel err {stats['next step']:.2e}, mean accept "
                         f"err {stats['accept']:.2e}, parted "
                         f"{100 * stats['parted']:.2f}%, ll' rel err of "
                         f"the rest {stats['ll kept']:.2e}")
                # the fixed-order cluster sum: a second launch, same bits
                again = fsg.fused_gmm_mutate(q0, mom, log_u, beta, eps,
                                             m_inv, x, k=k, d=d, kmut=kk,
                                             lsteps=lsteps)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"phase 18: {tag}: a second launch "
                                         f"differs")
                extra += ", a second launch bit for bit"
            inv = ll_matches_q(got, pg, beta, tag)
            lines.append(f"{tag}: mean accept {float(got[2].mean()):.3f}, "
                         f"{extra}, ll'=ll(q') rel err {inv:.2e}")
    # the generic instance (K <= 8, D <= 4), one transition at K 4, D 3
    cfg_g = gmm.Config(num_components=GMM_GENERIC[0],
                       data_dim=GMM_GENERIC[1], num_data=n_b)
    xg_n, truth_g = gmm.make_data(cfg_g)
    xg = torch.as_tensor(xg_n, device=dev)
    kg, dg = cfg_g.num_components, cfg_g.data_dim
    dim_g = (kg - 1) + kg * dg + kg
    pg_g = fsg.make_gmm_potential_flat(xg, kg, dg)
    qg = near_truth(truth_g, p_b)
    for beta, eps in GMM_BETA_EPS:
        mom = t32(rng.normal(size=(1, p_b, dim_g)))
        log_u = t32(np.log(rng.uniform(size=(p_b, 1))))
        ones = torch.ones(dim_g, device=dev)
        got = fsg.fused_gmm_mutate(qg, mom, log_u, beta, eps, ones, xg, k=kg,
                                   d=dg, kmut=1, lsteps=lsteps)
        want = fsg.mutation_core(qg, mom, log_u, beta, eps, ones, pg_g, 1,
                                 lsteps, 0.65)
        torch.cuda.synchronize()
        tag = f"generic K {kg} D {dg} beta {beta} eps {eps} K 1"
        extra, q_err = one_transition(got, want, qg, log_u, pg_g, beta, tag)
        mut_err = max(mut_err, q_err)
        inv = ll_matches_q(got, pg_g, beta, tag)
        lines.append(f"{tag}: mean accept {float(got[2].mean()):.3f}, "
                     f"{extra}, ll'=ll(q') rel err {inv:.2e}")
    print(f"phase 18 mutation kernel ok ({p_b} particles, "
          f"{p_b // fsg.PB} blocks): " + "; ".join(lines), flush=True)

    # -- 19. SMC end to end through the four modes ------------------------
    true_ll = gmm._true_loglik(xn, truth)
    runs, launches, smcs, last = {}, {}, {}, {}
    for mode in ("generic", "kernels", "fused", "split"):
        smc = gmm.make_smc(cfg, x, mode)
        smcs[mode] = smc
        smc.max_stages = 2                  # warm-up, untimed
        smc.run(0)
        smc.max_stages = 100
        glp.LAUNCHES.update(fwd=0, bwd=0, vg=0)
        fsg.LAUNCHES = 0
        runs[mode] = []
        for seed in (GMM_SEEDS if mode != "split" else GMM_SEEDS[:1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = smc.run(seed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            gap = true_ll - gmm.predictive_loglik(res, x, cfg)
            acc = float(res.accept_rate)
            if not (abs(gap) < 0.3 and 0.0 < acc <= 1.0
                    and bool(torch.isfinite(res.log_evidence))):
                raise AssertionError(f"phase 19: {mode} seed {seed}: gap "
                                     f"{gap}, accept {acc}, log Z "
                                     f"{float(res.log_evidence)}")
            runs[mode].append(dict(wall=wall, stages=res.num_stages,
                                   logz=float(res.log_evidence), gap=gap,
                                   accept=acc))
            last[mode] = res
        launches[mode] = dict(glp.LAUNCHES, mutate=fsg.LAUNCHES)
    want_kernel = {"kernels": ("fwd", "vg"), "fused": ("mutate",),
                   "split": ("fwd", "bwd")}
    for mode, names in want_kernel.items():
        for name in names:
            if launches[mode][name] < 1:
                raise AssertionError(f"phase 19: {mode} never launched the "
                                     f"{name} kernel")
    lz = {m: [r["logz"] for r in rs] for m, rs in runs.items()}
    lz_gen = float(np.mean(lz["generic"]))
    for mode in ("kernels", "fused"):
        if abs(float(np.mean(lz[mode])) - lz_gen) > 3.0:
            raise AssertionError(f"phase 19: {mode} seed-mean log Z "
                                 f"{np.mean(lz[mode])} vs generic {lz_gen}")
    if not min(lz["generic"]) - 3 <= lz["split"][0] <= max(lz["generic"]) + 3:
        raise AssertionError(f"phase 19: split log Z {lz['split'][0]} "
                             f"outside generic's {lz['generic']} +- 3")
    rates, lines = {}, []
    for mode, rs in runs.items():
        walls = [r["wall"] for r in rs]
        med = float(np.median(walls))
        i_med = int(np.argmin([abs(w - med) for w in walls]))
        stages = rs[i_med]["stages"]
        rates[mode] = p_b * stages / med
        lines.append(
            f"{mode}: log Z {', '.join(f'{v:.2f}' for v in lz[mode])} "
            f"(mean {np.mean(lz[mode]):.2f}), stages "
            f"{[r['stages'] for r in rs]}, max |gap| "
            f"{max(abs(r['gap']) for r in rs):.3f}, accept "
            f"{', '.join(f'{r['accept']:.3f}' for r in rs)}, wall "
            f"{', '.join(f'{w:.2f}' for w in walls)} s, median "
            f"{med:.3f} s at {stages} stages: {rates[mode]:.1f} "
            f"particle-stages/s; launches {launches[mode]}")
    print(f"phase 19 GMM SMC main path ok [{card}]: P {p_b}, N {n_b}, "
          f"{kmut} x {lsteps}, seeds {list(GMM_SEEDS)}; " + "; ".join(lines),
          flush=True)

    # -- 20. times and traces ---------------------------------------------
    xx, lw, mus, sig, ct = lik_inputs(p_b, n_b)
    timed = {
        "fwd": (lambda: glp._fwd(xx, lw, mus, sig),
                lambda: glp.gmm_loglik_reference(xx, lw, mus, sig)),
        "bwd": (lambda: glp._bwd(xx, lw, mus, sig, ct),
                lambda: glp.gmm_loglik_grad_reference(xx, lw, mus, sig, ct)),
        "vg": (lambda: glp.gmm_loglik_grad(xx, lw, mus, sig),
               lambda: glp.gmm_loglik_grad_reference(xx, lw, mus, sig)),
    }
    # per call: the kernel's device time (queued behind a spin), the
    # plain version's time, the wrapper's host time
    ms, host_ms = {}, {}
    for name, (kern, plain) in timed.items():
        kern()
        plain()
        ms[name] = (_device_ms(torch, kern, GMM_TIMED),
                    _cuda_ms(torch, plain, 3)[0])
        host_ms[name] = _host_ms(torch, kern, GMM_TIMED)
    # each likelihood launch at the bench: the library's against
    # launch_geometry, its resident blocks an SM and its waves
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lik_geo = []
    for name in glp.LAUNCHES:
        geo_ = glp.device_geometry(name, p_b, n_b, k, d)
        resident = geo_.pop("resident_blocks")
        if geo_ != glp.launch_geometry(name, p_b, n_b, k, d):
            raise AssertionError(
                f"phase 20: the library's {name} launch {geo_} is not "
                f"launch_geometry's "
                f"{glp.launch_geometry(name, p_b, n_b, k, d)}")
        slots = resident * sms
        nb = geo_["blocks"]
        last_wave = nb - (-(-nb // slots) - 1) * slots
        lik_geo.append(
            f"{name} {nb} blocks of {geo_['threads']} threads "
            f"({geo_['particles_per_warp']} particle(s) a warp, "
            f"{geo_['particles_per_block']} a block), {geo_['smem_bytes']} B "
            f"of x in {geo_['tiles']} tile(s), {resident} resident an SM: "
            f"{nb / slots:.2f} waves, the last {last_wave} blocks")
    mom = t32(rng.normal(size=(kmut, p_b, dim)))
    log_u = t32(np.log(rng.uniform(size=(p_b, kmut))))
    margs = (q0, mom, log_u, 1.0, 0.03, m_inv, x)
    mkw = dict(k=k, d=d, kmut=kmut, lsteps=lsteps)
    fsg.fused_gmm_mutate(*margs, **mkw)
    ms["mutate"] = (
        _cuda_ms(torch, lambda: fsg.fused_gmm_mutate(*margs, **mkw), 5)[0],
        _cuda_ms(torch, lambda: fsg.mutation_core(
            q0, mom, log_u, 1.0, 0.03, m_inv, pg, kmut, lsteps, 0.65))[0])
    # one adaptation block alone: one cluster's latency, without the fill
    b_args = (q0[:fsg.PB].contiguous(), mom[:, :fsg.PB].contiguous(),
              log_u[:fsg.PB].contiguous(), 1.0, 0.03, m_inv, x)
    fsg.fused_gmm_mutate(*b_args, **mkw)
    ms_block = _cuda_ms(torch, lambda: fsg.fused_gmm_mutate(*b_args, **mkw),
                        5)[0]
    geo = fsg.device_geometry(n_b, k, d)
    want_geo = fsg.launch_geometry(p_b, k, d)
    if any(geo[kk] != want_geo[kk] for kk in ("cluster", "threads",
                                              "particles_per_warp")):
        raise AssertionError(f"phase 20: the library's geometry {geo} is not "
                             f"launch_geometry's {want_geo}")
    # one stage of each mode from the end of a run, tempered back to 0.9
    res = last["kernels"]
    gen = torch.Generator(device=dev).manual_seed(20)
    draws = stage_draws(gen, p_b, dim, kmut)
    traces = {}
    for mode, smc in smcs.items():
        q = res.unconstrained
        ll = smc._loglik(q) if mode == "fused" else None
        args = (q, torch.zeros(p_b, device=dev),
                torch.tensor(0.9, device=dev), ll,
                torch.tensor(0.004, device=dev), draws)
        smc.stage(*args)
        traces[mode] = _trace(torch, lambda: smc.stage(*args), 1, "stage")

    # bounds.  Per (particle, point): K (3D + 5) operations for the
    # component densities and the max-shifted exps, 3 for the log and the
    # sums (value), K (3 + 2D) + 1 for the responsibilities and the
    # gradient sums.  The SFU ops the function needs, at the SFU rate: K
    # exps, one log per kChunk points (the log of their sums' product,
    # gmm_lik.cuh) for the value, one reciprocal for the gradient.  Bytes:
    # every input read once, every output written once.  The mutation: K L
    # + 1 value+grad evaluations of its padded population per stage.  The
    # bound is the larger of the FP32 (or bytes) and the SFU figures.
    k_chunk = int(re.search(r"kChunk = (\d+);", (
        _build.CSRC / "gmm_lik.cuh").read_text()).group(1))
    pts = p_b * n_b
    per_val, per_grad = k * (3 * d + 5) + 3, k * (3 + 2 * d) + 1
    sfu_pair = {"fwd": k + 1 / k_chunk, "bwd": k + 1,
                "vg": k + 1 + 1 / k_chunk, "mutate": k + 1 + 1 / k_chunk}
    par = p_b * (2 * k + k * d)
    cost = {
        "fwd": (pts * per_val, 4 * (n_b * d + par + p_b),
                pts * sfu_pair["fwd"]),
        "bwd": (pts * (k * (3 * d + 5) + per_grad),
                4 * (n_b * d + 2 * par + p_b), pts * sfu_pair["bwd"]),
        "vg": (pts * (per_val + per_grad), 4 * (n_b * d + 2 * par + p_b),
               pts * sfu_pair["vg"]),
    }
    evals = kmut * lsteps + 1
    p_pad = -(-p_b // fsg.PB) * fsg.PB
    cost["mutate"] = (
        evals * p_pad * n_b * (per_val + per_grad),
        4 * (n_b * d + (2 + kmut) * p_b * dim + p_b * kmut + dim + 2 * p_b
             + p_pad // fsg.PB),
        evals * p_pad * n_b * sfu_pair["mutate"])
    fp32 = {kk: _bound(o, b) for kk, (o, b, _) in cost.items()}
    bounds = {kk: max(fp32[kk], (_sfu_ms(cost[kk][2]), "operations"))
              for kk in cost}
    so = _build.load()._name
    print(f"phase 20 GMM times ok [{card}]: " + "; ".join(
        f"{kk} kernel {ms[kk][0]:.4f} ms, plain {ms[kk][1]:.4f} ms, FP32 "
        f"bound {fp32[kk][0]:.4f} ms ({fp32[kk][1]}), SFU "
        f"{_sfu_ms(cost[kk][2]):.4f} ms ({sfu_pair[kk]:g} a pair)"
        for kk in ms)
        + f" (mutate per stage, the others per call, the likelihood "
        f"kernels' device time queued behind a spin; the wrappers' host time "
        f"a call: " + ", ".join(f"{kk} {v:.4f} ms" for kk, v in
                                host_ms.items())
        + f"); launches at P {p_b}: " + "; ".join(lik_geo)
        + f"; SASS: {_sass_loops(so, 'gmm_lik_kernel')}; "
        f"{_sass_loops(so, 'smc_gmm_mutate_kernel')}; mutate at P "
        f"{fsg.PB} (one adaptation block) {ms_block:.4f} ms; clusters of "
        f"{geo['cluster']} blocks x {geo['threads']} threads, "
        f"{want_geo['ctas']} blocks at P {p_b}, "
        f"{geo['particles_per_warp']} particles a warp, "
        f"cudaOccupancyMaxActiveClusters "
        f"{geo['max_active_clusters']}; one stage: "
        + "; ".join(f"{kk} {v}" for kk, v in traces.items()), flush=True)

    n_launch = {kk: sum(lc[kk] for lc in launches.values())
                for kk in ("fwd", "bwd", "vg", "mutate")}
    return [
        _record("fused_gmm_mutate", "fused_smc_gmm.cu",
                "bayesic_tpu/ops/fused_smc_gmm.py:319", n_launch["mutate"],
                mut_err, ms["mutate"][0], ms["mutate"][1], bounds["mutate"]),
        _record("gmm_loglik_fwd", "gmm_logprob.cu",
                "bayesic_tpu/ops/gmm_logprob.py:141", n_launch["fwd"],
                lik_err["fwd"], ms["fwd"][0], ms["fwd"][1], bounds["fwd"]),
        _record("gmm_loglik_bwd", "gmm_logprob.cu",
                "bayesic_tpu/ops/gmm_logprob.py:158", n_launch["bwd"],
                lik_err["bwd"], ms["bwd"][0], ms["bwd"][1], bounds["bwd"]),
        _record("gmm_loglik_grad", "gmm_logprob.cu",
                "bayesic_tpu/ops/gmm_logprob.py:375", n_launch["vg"],
                lik_err["vg"], ms["vg"][0], ms["vg"][1], bounds["vg"]),
    ]


def _linreg_phases(torch, np, card, dev):
    """Phases 21-22, the linear-regression path; returns the kernels line's
    entry of its trainer."""
    from bayesic_tpu_torch.infer.svi import SVI, Adam, MeanFieldGuide
    from bayesic_tpu_torch.models import linreg as lr
    from bayesic_tpu_torch.ops import _kernel_common as kc
    from bayesic_tpu_torch.ops import fused_linreg as fl

    cfg = lr.Config(**LINREG, device=str(dev))
    xn, yn, _, _ = lr.make_data(cfg)
    x, y = torch.as_tensor(xn, device=dev), torch.as_tensor(yn, device=dev)
    n, d, noise = cfg.n, cfg.dim, cfg.noise
    p = d + 1
    g = fl.gram(x, y)
    rng = np.random.default_rng(21)

    def rnd(*shape, loc=0.0, scale=1.0):
        return torch.as_tensor(
            (loc + scale * rng.standard_normal(shape)).astype(np.float32),
            device=dev)

    # -- 21. the fused linreg trainer against its plain version ----------
    loc0, ls0, eps1 = rnd(p, scale=0.5), rnd(p, loc=-2.0, scale=0.3), rnd(p)
    zeros = tuple(torch.zeros(p, device=dev) for _ in range(4))
    svi = SVI(lr.model, MeanFieldGuide, Adam(0.01),
              model_args=(x, y, noise))
    params = {"loc": loc0.clone().requires_grad_(True),
              "log_scale": ls0.clone().requires_grad_(True)}
    elbo_dsl = svi.elbo(params, None, eps=eps1[None])
    g_dsl = torch.autograd.grad(elbo_dsl, [params["loc"],
                                           params["log_scale"]])
    plain = fl._step_math(loc0, ls0, g, n, eps1, noise)
    plain64 = fl._step_math(loc0.double(), ls0.double(), g.double(), n,
                            eps1.double(), noise)
    _, _, (m1, m2, _, _), l1 = fl.fused_train_injected(
        g, n, noise, loc0, ls0, zeros, eps_stream=eps1[None], lr0=cfg.lr,
        lr_total=10)
    torch.cuda.synchronize()
    kern = (-l1[0], -m1 / 0.1, -m2 / 0.1)   # one Adam step from zero moments
    errs, lin_err = {}, 0.0
    for name, got, want in (("step vs DSL autograd", plain,
                             (elbo_dsl.detach(),) + g_dsl),
                            ("kernel vs float64 step", kern, plain64)):
        e_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        worst = 0.0
        for gg, ww in zip(got[1:], want[1:]):
            ww = ww.to(gg.dtype)
            err = (gg.detach() - ww).abs()
            worst = max(worst, float((err / (LINREG_TOL["grad"] * ww.abs()
                                             + LINREG_TOL["grad"] * 0.1
                                             * float(ww.abs().max()))).max()))
            if name.startswith("kernel"):
                lin_err = max(lin_err, float(err.max()))
        if e_rel > LINREG_TOL["elbo"] or worst > 1.0:
            raise AssertionError(f"phase 21: {name}: elbo rel err {e_rel}, "
                                 f"gradient err/tol {worst} (limits "
                                 f"{LINREG_TOL})")
        errs[name] = (e_rel, worst)
    eps = rnd(LINREG_TRAJ, p)
    kw = dict(eps_stream=eps, lr0=cfg.lr, lr_total=LINREG_TRAJ)
    got = fl.fused_train_injected(g, n, noise, loc0, ls0, zeros, **kw)
    want = fl.reference_train(g, n, noise, loc0, ls0, zeros, **kw)
    traj_rel = float(((got[3] - want[3]).abs() / want[3].abs()).max())
    par_rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in ((got[0], want[0]), (got[1], want[1])))
    seed = 2121
    got = fl.fused_train(g, n, noise, loc0, ls0, zeros, steps=LINREG_TRAJ,
                         lr0=cfg.lr, seed=seed)
    eps = kc.hier_streams(seed, 0, LINREG_TRAJ, 1, p, device=dev)[1]
    want = fl.reference_train(g, n, noise, loc0, ls0, zeros, eps_stream=eps,
                              lr0=cfg.lr, lr_total=LINREG_TRAJ)
    bits_rel = float(((got[3] - want[3]).abs() / want[3].abs()).max())
    if max(traj_rel, par_rel, bits_rel) > LINREG_TOL["trajectory"]:
        raise AssertionError(
            f"phase 21: {LINREG_TRAJ}-step trajectory loss rel err "
            f"{traj_rel}, param err / max {par_rel}; Philox twin {bits_rel} "
            f"(limit {LINREG_TOL['trajectory']})")
    again = fl.fused_train(g, n, noise, loc0, ls0, zeros, steps=LINREG_TRAJ,
                           lr0=cfg.lr, seed=seed)
    if not all(torch.equal(a, b) for a, b in zip(
            (got[0], got[1], *got[2], got[3]),
            (again[0], again[1], *again[2], again[3]))):
        raise AssertionError("phase 21: two launches differ")
    edges = {dd: _linreg_edge(torch, kc, fl, lr, dataclasses.replace(
        cfg, dim=dd), rnd, seed + dd) for dd in LINREG_EDGE_DIMS}
    for dd, (errs_d, _) in edges.items():
        if max(errs_d) > LINREG_TOL["trajectory"]:
            raise AssertionError(
                f"phase 21: D {dd}: {LINREG_TRAJ}-step trajectory loss rel "
                f"err, param err / max and Philox twin loss rel err "
                f"{errs_d} (limit {LINREG_TOL['trajectory']})")
    print(f"phase 21 fused linreg trainer ok (N {n}, D {d}): one step: "
          + "; ".join(f"{k} elbo rel err {v[0]:.2e}, gradient err/tol "
                      f"{v[1]:.3f}" for k, v in errs.items())
          + f"; {LINREG_TRAJ}-step trajectory loss max rel err "
          f"{traj_rel:.2e}, param max err / max {par_rel:.2e}; Philox twin "
          f"loss rel err {bits_rel:.2e}; two launches bit for bit; at D "
          + ", ".join(f"{dd}: {e[0]:.2e} / {e[1]:.2e} / {e[2]:.2e} "
                      f"({us:.6f} us a step)"
                      for dd, (e, us) in edges.items())
          + f" (limits {LINREG_TOL})", flush=True)

    # -- 22. the linreg path through the user's entry points --------------
    fits, walls = {}, {}
    for name, c in (
            ("run meanfield", dataclasses.replace(cfg, steps=LINREG_STEPS)),
            ("run fullrank", dataclasses.replace(
                cfg, steps=LINREG_STEPS, guide="fullrank",
                lr=LINREG_FULLRANK_LR))):
        t = time.perf_counter()
        fits[name] = lr.run(c)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
    fl.LAUNCHES = 0
    t = time.perf_counter()
    fits["run_svi_fused"] = lr.run_svi_fused(dataclasses.replace(
        cfg, steps=LINREG_FUSED_STEPS))
    torch.cuda.synchronize()
    walls["run_svi_fused"] = time.perf_counter() - t
    lin_launches = fl.LAUNCHES
    if lin_launches < 1:
        raise AssertionError("phase 22: run_svi_fused never launched the "
                             "kernel")
    lines = []
    for name, out in fits.items():
        sd_ref = np.sqrt(np.diag(out["analytic_cov"]))
        sd_rel = float(np.abs(out["posterior_sd"] / sd_ref - 1.0).max())
        losses = out["losses"]
        if not (np.isfinite(losses).all() and out["max_abs_err"] < 0.02):
            raise AssertionError(f"phase 22: {name}: max |mean - analytic| "
                                 f"{out['max_abs_err']} (limit 0.02)")
        if name == "run_svi_fused" and sd_rel >= 0.3:
            raise AssertionError(f"phase 22: {name}: sd rel err {sd_rel} "
                                 f"(limit 0.3)")
        lines.append(f"{name}: max |mean - analytic| "
                     f"{out['max_abs_err']:.2e}, sd max rel err "
                     f"{sd_rel:.3f}, wall {walls[name]:.2f} s")
    out_f = fits["run_svi_fused"]
    state = (out_f["loc"], out_f["ls"], out_f["opt_state"])
    f_ms, _ = _cuda_ms(torch, lambda: fl.fused_train(
        g, n, noise, *state, steps=LINREG_FUSED_STEPS, lr0=cfg.lr,
        lr_total=2 * LINREG_FUSED_STEPS, seed=7, t0=LINREG_FUSED_STEPS))
    lin_step_ms = f_ms / LINREG_FUSED_STEPS
    eps = rnd(LINREG_PLAIN_STEPS, p)
    fl.reference_train(g, n, noise, loc0, ls0, zeros, eps_stream=eps[:10],
                       lr0=cfg.lr, lr_total=LINREG_PLAIN_STEPS)
    plain_ms, _ = _cuda_ms(torch, lambda: fl.reference_train(
        g, n, noise, loc0, ls0, zeros, eps_stream=eps, lr0=cfg.lr,
        lr_total=LINREG_PLAIN_STEPS))
    lin_plain_ms = plain_ms / LINREG_PLAIN_STEPS
    svi_g, res_g = fits["run meanfield"]["svi"], fits["run meanfield"][
        "result"]
    gen = torch.Generator(device=dev).manual_seed(1)
    g_ms, _ = _cuda_ms(torch, lambda: svi_g.run(gen, LINREG_GENERIC_TIMED,
                                                state=res_g.state))
    # the trace in a process of its own: in one that has run the earlier
    # phases, CUPTI hands the profiler a kernel's record only seconds
    # after the kernel, so this call's window comes out empty (PERF.md §7)
    child = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke._linreg_trace()"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if child.returncode:
        raise AssertionError(f"phase 22: the trace's process failed:\n"
                             f"{child.stdout[-2000:]}{child.stderr[-2000:]}")
    trace = child.stdout.strip().splitlines()[-1]
    probe = fl.probe_cycles(g, n, noise, *state, steps=LINREG_PROBE_STEPS,
                            lr0=cfg.lr, seed=9)
    clock = _sm_clock_during(torch, lambda: fl.fused_train(
        g, n, noise, *state, steps=10 * LINREG_FUSED_STEPS, lr0=cfg.lr,
        seed=10))
    print(f"phase 22 linreg main path ok [{card}]: " + "; ".join(lines)
          + f" (gates: mean 0.02, fused sd 0.3); fused trainer "
          f"{1e3 * lin_step_ms:.4f} us/step, plain reference_train "
          f"{lin_plain_ms:.4f} ms/step, generic run (mean-field) "
          f"{1e3 * LINREG_GENERIC_TIMED / g_ms:.1f} steps/s; fused_train "
          f"(traced in a new process) {trace}; kernel launches "
          f"{lin_launches}", flush=True)
    print(f"phase 22 linreg trainer probe [{card}], SM clock {clock} under "
          f"the kernel: cycles a step on consumer thread 0, mean of "
          f"{probe['sampled']} sampled steps of {LINREG_PROBE_STEPS}: "
          + ", ".join(f"{k} {v:.1f}" for k, v in probe["phases"].items())
          + f"; the probe instance's whole loop {probe['loop']:.1f} "
          f"cycles a step", flush=True)

    # bound per step: the (D+2)^2 FMAs of G u and ~60 operations per
    # parameter (Philox, Box-Muller, z, gradient, two Adam updates); bytes:
    # G read once, the parameters and both moment pairs read and written
    # once, the losses written, over the call's steps
    steps = LINREG_FUSED_STEPS
    bound = _bound(2 * (d + 2) ** 2 + 60 * p,
                   4 * ((d + 2) ** 2 + 12 * p + 2048) / steps)
    return [_record("fused_linreg_train", "fused_linreg.cu",
                    "bayesic_tpu/ops/fused_linreg.py:102", lin_launches,
                    lin_err, lin_step_ms, lin_plain_ms, bound)]


def _linreg_edge(torch, kc, fl, lr, cfg, rnd, seed):
    """Phase 21 at D = ``cfg.dim``: the trainer against the plain version
    on a 200-step injected stream and on its Philox streams, from a random
    state; ((loss rel err, param err / max, Philox loss rel err), the
    kernel's us a step)."""
    dev = torch.device(cfg.device)
    xn, yn, _, _ = lr.make_data(cfg)
    g = fl.gram(torch.as_tensor(xn, device=dev),
                torch.as_tensor(yn, device=dev))
    p = cfg.dim + 1
    loc, ls = rnd(p, scale=0.5), rnd(p, loc=-2.0, scale=0.3)
    zeros = tuple(torch.zeros(p, device=dev) for _ in range(4))
    kw = dict(eps_stream=rnd(LINREG_TRAJ, p), lr0=cfg.lr,
              lr_total=LINREG_TRAJ)
    got = fl.fused_train_injected(g, cfg.n, cfg.noise, loc, ls, zeros, **kw)
    want = fl.reference_train(g, cfg.n, cfg.noise, loc, ls, zeros, **kw)
    traj = float(((got[3] - want[3]).abs() / want[3].abs()).max())
    par = max(float((a - b).abs().max() / b.abs().max())
              for a, b in ((got[0], want[0]), (got[1], want[1])))
    got = fl.fused_train(g, cfg.n, cfg.noise, loc, ls, zeros,
                         steps=LINREG_TRAJ, lr0=cfg.lr, seed=seed)
    want = fl.reference_train(
        g, cfg.n, cfg.noise, loc, ls, zeros,
        eps_stream=kc.hier_streams(seed, 0, LINREG_TRAJ, 1, p, device=dev)[1],
        lr0=cfg.lr, lr_total=LINREG_TRAJ)
    bits = float(((got[3] - want[3]).abs() / want[3].abs()).max())
    fl.fused_train(g, cfg.n, cfg.noise, loc, ls, zeros, steps=1000,
                   lr0=cfg.lr)
    ms, _ = _cuda_ms(torch, lambda: fl.fused_train(
        g, cfg.n, cfg.noise, loc, ls, zeros, steps=LINREG_EDGE_TIMED,
        lr0=cfg.lr))
    return (traj, par, bits), 1e3 * ms / LINREG_EDGE_TIMED


def _linreg_trace():
    """Phase 22's trace of ``fused_train`` (``LINREG_TRACE_STEPS`` steps at
    the bench shape), for a process of its own: prints ``_trace``'s line."""
    import torch

    from bayesic_tpu_torch.models import linreg as lr
    from bayesic_tpu_torch.ops import fused_linreg as fl

    dev = torch.device("cuda", 0)
    cfg = lr.Config(**LINREG, device=str(dev))
    xn, yn, _, _ = lr.make_data(cfg)
    g = fl.gram(torch.as_tensor(xn, device=dev),
                torch.as_tensor(yn, device=dev))
    state = fl.init_params(cfg.dim, device=dev)

    def run():
        return fl.fused_train(g, cfg.n, cfg.noise, *state,
                              steps=LINREG_TRACE_STEPS, lr0=cfg.lr, seed=8)
    run()
    print(_trace(torch, run, LINREG_TRACE_STEPS), flush=True)


def _sm_clock_during(torch, fn):
    """The SM clock nvidia-smi reads while ``fn``'s kernels (queued, and
    running for most of a second) occupy the card."""
    torch.cuda.synchronize()
    fn()
    time.sleep(0.2)
    res = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    torch.cuda.synchronize()
    return res.stdout.strip()


def _mf_phases(torch, np, card, dev):
    """Phases 23-25, the matrix-factorization path; returns the kernels
    line's entry of its cell pass."""
    from bayesic_tpu_torch.infer.svi.svi import tree_leaves, tree_map
    from bayesic_tpu_torch.models import matrix_fact as mf
    from bayesic_tpu_torch.ops import _build
    from bayesic_tpu_torch.ops import mf_dense as md

    cfg = mf.Config(**MF, device=str(dev))
    data = mf.make_data(cfg)
    cnt, rsum, sqsum, n_r = mf.dense_stats(*data[:3], cfg.num_users,
                                           cfg.num_items, dev)
    gen = torch.Generator().manual_seed(23)

    def off_symmetric(c):
        p = mf.dense_init(c, gen, init_scale=0.3)
        return tree_map(lambda t: t + 0.2 * torch.randn(
            t.shape, generator=gen).to(dev), p)

    # -- 23. the cell pass against its plain version ----------------------
    mf_err, lines = 0.0, []
    for nu, ni, k in ((cfg.num_users, cfg.num_items, cfg.num_factors),
                      (*MF_ODD, cfg.num_factors), (*MF_ODD, md.MAX_FACTORS)):
        c = dataclasses.replace(cfg, num_users=nu, num_items=ni,
                                num_factors=k,
                                num_ratings=cfg.num_ratings * nu * ni
                                // (cfg.num_users * cfg.num_items))
        cn, rs = (cnt, rsum) if nu == cfg.num_users else \
            mf.dense_stats(*mf.make_data(c)[:3], nu, ni, dev)[:2]
        cp, rp = md.pack_stats(cn, rs)
        fu, fv = md.pack_aug(off_symmetric(c))
        a = k + 2
        for mm in ("float32", "bfloat16"):
            got = md.cell_grads(cp, rp, fu, fv, mm_dtype=mm)
            again = md.cell_grads(cp, rp, fu, fv, mm_dtype=mm)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"phase 23: {nu} x {ni}, K {k}, {mm}: "
                                     f"two calls differ")
            want = md.cell_grads_reference(cp, rp, fu, fv, mm)
            errs = {"loss": abs(float(got[0]) - float(want[0]))
                    / abs(float(want[0]))}
            for side, gg, ww in (("u", got[1], want[1]),
                                 ("v", got[2], want[2])):
                for name, sl in (("a", slice(0, a)), ("w", slice(a, None))):
                    err = (gg[:, sl] - ww[:, sl]).abs()
                    errs[f"d{name.upper()}{side}"] = float(
                        err.max() / ww[:, sl].abs().max())
                    if mm == "float32":
                        mf_err = max(mf_err, float(err.max()))
            lim = MF_TOL[mm]
            bad = {k: v for k, v in errs.items()
                   if v > (lim[0] if k == "loss" else lim[1])}
            if bad:
                raise AssertionError(f"phase 23: {nu} x {ni}, K {k}, {mm}: "
                                     f"{bad} "
                                     f"(limits: loss rel {lim[0]}, "
                                     f"gradients {lim[1]} of max|g|)")
            lines.append(f"{nu} x {ni} K {k} {mm}: " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items()))
    print(f"phase 23 dense MF cell pass ok (two calls bit-identical; loss "
          f"rel err, gradient err / max|g|; limits {MF_TOL}): "
          + "; ".join(lines), flush=True)

    # -- 24. the MF path through the user's entry points -------------------
    runs, walls = {}, {}
    t = time.perf_counter()
    runs["run (mini-batch)"] = mf.run(cfg)
    torch.cuda.synchronize()
    walls["run (mini-batch)"] = time.perf_counter() - t
    t = time.perf_counter()
    dense = mf.run_dense(cfg, data=data)
    torch.cuda.synchronize()
    walls["run_dense"] = time.perf_counter() - t
    runs["run_dense"] = dense
    idx = [torch.as_tensor(v, device=dev) for v in data[:3]]
    md.LAUNCHES = 0
    for mm in ("float32", "bfloat16"):
        t = time.perf_counter()
        p, _, losses = md.fused_train(
            mf.dense_init(cfg), cnt, rsum, sqsum, n_r, cfg.noise,
            steps=cfg.steps, lr=MF_FUSED_LR, mm_dtype=mm)
        torch.cuda.synchronize()
        walls[f"fused_train {mm}"] = time.perf_counter() - t
        runs[f"fused_train {mm}"] = {
            "rmse": mf._rmse({k: v[0] for k, v in p.items()}, *idx),
            "final_elbo": -float(losses[-1]), "params": p}
    mf_launches = md.LAUNCHES
    if mf_launches < 2 * cfg.steps:
        raise AssertionError(f"phase 24: fused_train launched the kernel "
                             f"{mf_launches} times")
    lines = []
    for name, out in runs.items():
        gap = (dense["final_elbo"] - out["final_elbo"]) \
            / abs(dense["final_elbo"])
        if not (out["rmse"] < 1.2 * cfg.noise and np.isfinite(
                out["final_elbo"])):
            raise AssertionError(f"phase 24: {name}: rmse {out['rmse']} "
                                 f"(limit {1.2 * cfg.noise})")
        if name.startswith("fused") and gap >= 0.01:
            raise AssertionError(f"phase 24: {name}: final loss {gap:.4f} "
                                 f"above run_dense's (limit 0.01)")
        lines.append(f"{name}: rmse {out['rmse']:.4f}, final ELBO "
                     f"{out['final_elbo']:.1f}"
                     + (f" (loss gap {100 * gap:.4f}%)"
                        if name.startswith("fused") else "")
                     + f", wall {walls[name]:.2f} s")
    print(f"phase 24 MF main path ok [{card}]: {cfg.num_users} x "
          f"{cfg.num_items}, K {cfg.num_factors}, {n_r} ratings, "
          f"{cfg.steps} steps; " + "; ".join(lines)
          + f" (gates: rmse {1.2 * cfg.noise:.2f}, loss gap 1%); kernel "
          f"launches {mf_launches}", flush=True)

    # -- 25. times and traces ---------------------------------------------
    params = runs["fused_train float32"]["params"]
    cp, rp = md.pack_stats(cnt, rsum)
    fu, fv = md.pack_aug(params)
    # per call: the kernels' device time, the wrapper's time with its host
    # cost (the larger of the two), the plain version's time
    ms = {}
    for mm in ("float32", "bfloat16"):
        md.cell_grads(cp, rp, fu, fv, mm_dtype=mm)
        md.cell_grads_reference(cp, rp, fu, fv, mm)
        ms[mm] = (_device_ms(torch, lambda: md.cell_grads(
            cp, rp, fu, fv, mm_dtype=mm), 20), _cuda_ms(
            torch, lambda: md.cell_grads(cp, rp, fu, fv, mm_dtype=mm),
            20)[0], _cuda_ms(
            torch, lambda: md.cell_grads_reference(cp, rp, fu, fv, mm),
            5)[0])

    def eager():
        pp = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = mf.dense_neg_elbo(pp, cnt, rsum, sqsum, n_r, cfg.noise)
        return torch.autograd.grad(loss, tree_leaves(pp))

    def fused_vg():
        return md.dense_value_and_grad(params, cp, rp, sqsum, n_r,
                                       cfg.noise)

    eager()
    eager_ms = _cuda_ms(torch, eager, 10)[0]
    vg_ms = _cuda_ms(torch, fused_vg, 10)[0]
    traces = {
        "fused_train float32": _trace(torch, lambda: md.fused_train(
            params, cnt, rsum, sqsum, n_r, cfg.noise, steps=MF_TRACE_STEPS,
            lr=MF_FUSED_LR), MF_TRACE_STEPS),
        "eager value+grad": _trace(torch, lambda: [
            eager() for _ in range(MF_TRACE_STEPS)], MF_TRACE_STEPS),
    }
    # bound: cnt (2 B) and rsum (4 B) per cell read once, both factor
    # matrices read and both gradients written once; 9A FMAs per cell, at
    # the FP32 rate (float32) or the bf16 tensor-core rate (bfloat16)
    nu, ni, a = cfg.num_users, cfg.num_items, cfg.num_factors + 2
    ops, nbytes = 2 * nu * ni * 9 * a, \
        6 * nu * ni + 4 * (2 * (nu + ni) * 3 * a + 1)
    bound = _bound(ops, nbytes)
    bounds = {"float32": bound, "bfloat16": _bound(ops, nbytes, PEAK_BF16)}
    scratch_mb = 4 * _build.load().mf_dense_scratch_floats(nu, ni, a) / 1e6
    print(f"phase 25 MF times ok [{card}]: cell pass kernel "
          + ", ".join(f"{mm} {v[0]:.4f} ms on the card ({v[1]:.4f} ms a "
                      f"call with the host's cost; plain {v[2]:.4f} ms, "
                      f"bound {bounds[mm][0]:.4f} ms, {bounds[mm][1]})"
                      for mm, v in ms.items())
          + f", scratch {scratch_mb:.2f} MB per call; one value+grad: "
          f"through the kernel {vg_ms:.4f} ms, eager autograd of "
          f"dense_neg_elbo {eager_ms:.4f} ms; "
          + "; ".join(f"{k} {v}" for k, v in traces.items()), flush=True)
    return [_record("mf_dense_cell_grads", "mf_dense.cu",
                    "bayesic_tpu/ops/mf_dense.py:99", mf_launches, mf_err,
                    ms["float32"][0], ms["float32"][2], bound)]


def main():
    import numpy as np
    import torch

    t_start = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is False)")
    if not os.path.isdir(os.path.join(ROOT, "bayesic_tpu_torch", "csrc")):
        _fail("run me from a checkout of the repository")
    sys.path.insert(0, ROOT)
    from bayesic_tpu_torch.ops import _build

    card = _card()
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    # -- 1. build ----------------------------------------------------------
    t = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t
    print(f"phase 1 build ok in {build_s:.1f} s: "
          f"{_ptxas_summary(_build.build_log())}", flush=True)

    records = [_svi_phases(torch, np, card, dev),
               _nuts_phases(torch, np, card, dev)]
    records += _hier_phases(torch, np, card, dev)
    records += _gmm_phases(torch, np, card, dev)
    records += _linreg_phases(torch, np, card, dev)
    records += _mf_phases(torch, np, card, dev)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
