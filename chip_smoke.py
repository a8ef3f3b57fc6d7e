#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: the DLGM's
SVI and local-posterior NUTS, the hierarchical logistic regression's SVI
and full-batch NUTS, the Gaussian mixture's tempered SMC, the linear
regression's SVI, the matrix factorization's mini-batch and dense SVI,
the sharded (multi-rank) forms of the DLGM, hier, linreg, GMM and dense MF
paths, the model DSL's breadth (every distribution family, the generic
MCMC and SVI on further models), the DLGM's bf16 mode, the SVI breadth
and the model-checking tools, discrete enumeration with the rest of the
samplers, and the state-space families, the GP, STS and SVGP models and
pathfinder.

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

Phase 28, the breadth of ``dist`` and ``core`` (no kernel): every
distribution family's log_prob, mean, variance, entropy, cdf and icdf on
2^20 seeded points on the card against the same call on the CPU, and
each family built from Python floats evaluated on the card; 10^6 draws
of each family on the card, in the support, with the moments (or, for
heavy tails, the quartiles) against the analytic values; and the JAX
package's own tests' models through the generic ``MCMC`` and ``SVI`` on
the card: 8-schools non-centered by ``LocScaleReparam`` (with
``render_model``'s text), the Wishart-precision conjugate, the LKJ prior
alone, and a negative-binomial regression at 100,000 rows by SVI.

Phase 29, the DLGM's bf16 compute mode, the rest of ``infer/svi`` and the
model-checking tools: (a) the fused trainer's bf16 instance at the SVI
bench against its plain bf16 version (one injected step's gradients, a
20-step trajectory), then 3,000 steps of ``fused_train(compute_dtype=
"bfloat16")`` beside the float32 instance, gated on falling losses,
sigma_x and the final-loss gap, timed by CUDA events and by device time;
(b) the generic ``run_svi`` with ``Config.compute_dtype="bfloat16"`` at
the bench, and its bf16 ``Decoder`` on the card against the CPU; (c) the
IWAE and DReG bounds against the analytic evidence, the low-rank and flow
guides against mean-field on a correlated posterior, and ``TraceGuide``
against mean-field, through the generic ``SVI`` on the card; (d)
``Predictive``, ``log_likelihood`` (the card against the CPU), PSIS-LOO
against exact LOO, ``compare`` and SBC (an exact sampler calibrated, a
shifted one caught), on exact conjugate posterior draws on the card.

Phase 30, discrete enumeration and the rest of the inference algorithms
(no new kernel), in six processes started beside phase 28(c)'s and done
before phase 29 times anything: (a) the enumerated mixture density and
gradient at 65,536 points against the CPU in float64 and against
``MixtureSameFamily``, and ``infer_discrete`` against Bayes' rule; (b)
``DiscreteGibbs`` against marginal NUTS; (c) ``EllipticalSlice`` against
NUTS; (d) ``ParallelTempering`` on a bimodal target and an analytic
evidence; (e) ``SGMCMC``'s three methods, and sgld on a 100,000-row
regression against (f) ``map_estimate`` / ``Laplace`` (the gradient at
the mode, ``cov`` against the float64 inverse Hessian, exact on a
linear-Gaussian model); (g) ``SVGD``; (h) ``MCMC.warmup_and_sample`` on
the two fused NUTS paths equal to ``run`` bit for bit, the kernels'
launches counted; (i) the chain-sharded samplers at world size 1 on NCCL
equal to their unsharded runs.

Phase 31, the last modules (no kernel), in four processes beside phase
30's: (a) ``LinearGaussianStateSpace``'s filter, smoother, log_prob and
gradient at the STS system on the card against the CPU in float64, both
methods, and the ms and launches of a log_prob, parallel against
sequential, at T 256 and 10,000; (b) ``HiddenMarkovModel`` under NUTS;
(c) the structural time series by NUTS and its forecast against a dense
oracle; (d) the GP by ``EllipticalSlice`` against the exact posterior;
(e) the SVGP by full-rank SVI and its subsampled bound against the full
one; (f) ``pathfinder`` against an exact Gaussian posterior and as the
warm start of NUTS.

Phases 26-27, the sharded paths (``bayesic_tpu_torch.parallel``,
``MCMC(chain_sharding=)``): at world size 1 on NCCL in this process,
``dp_gram`` and the linreg trainer on it, ``dp_svi_run`` on the linreg
model, ``dlgm.run_svi(data_sharding=)``, ``segment_averaged_train`` on the
hier trainer, the chain-sharded ``local_posterior_mcmc_fused``,
``systematic_resample_shard_map`` in both routings, ``gmm.run(
particle_sharding=)`` in the fused and kernels modes at the GMM bench,
``run_dense_sharded`` and ``make_data`` and ``fused_train`` on the bench's
1M ratings read from a file, and on the ``"model"`` axis
``dlgm.run_svi(model_sharding=)`` in float32 and bf16,
``sharded_logdensity`` on the linreg model and ``ShardedMeanFieldGuide``
on the MF model, each against its unsharded call bit for bit,
with the kernels' launches counted; then two ranks in processes of their
own (``_rank_main``) that share the card under gloo (NCCL refuses two
ranks on one card), at the bench shapes: the hier trainer
segment-averaged (300 segments of 10 steps), ``dp_gram`` and the linreg
trainer, the DLGM's generic SVI with its rows sharded (50 steps), its
fused NUTS with the 1024 chains split over the ranks, the GMM's fused and
kernels modes with 4,096 particles a rank, ``run_dense_sharded`` with 750
items a rank and each rank's shard of the ratings file, the DLGM decoder
split over the ``"model"`` axis at the bench (50 steps), the linreg
log-density on each rank's half of the observations and the MF guide's
flat vector split (TP_MF), gated against the
single-process paths run first; their rates and the collectives' bytes
print beside the single-process ones, which is no scaling efficiency,
since the ranks share one card.  Phase 9 also holds the keyed
NUTS kernel's chain base: launched on the upper half of the chains from
``chain0`` = 512, it gives the upper half of the full-width launch's
draws and outputs bit for bit.

Each phase prints one line and raises on failure.  The line before the
last is a JSON object with one entry per kernel: its launches on the main
path (``fused_vae_train`` and ``fused_vae_train_bf16`` count calls of
the C entry's float32 and bf16 instances, each of which enqueues three
kernels per step; the others count kernel launches), its
largest error against the plain version, its time and the plain
version's (per SVI step, NUTS transition, SMC stage or likelihood call),
and the bound: the least time the card could take for the same work, the
larger of the bytes over the memory rate and the operations over the FP32
peak, or for the two kernels whose products run on the tensor cores
(``fused_vae_train``, ``fused_nuts_transition``) their three TF32 passes
over the TF32 peak (``fused_vae_train_bf16``: its products at the dense
bf16 tensor rate), and for the hier NUTS kernel and the four GMM
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
import functools
import json
import math
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
# phases 26-27, the sharded paths: segments of DP_SPS hier steps (the JAX
# package's safe length), DP_SEGMENTS of them at two ranks (the hier bench's
# 3,000 steps); the DLGM generic SVI at the bench for DP_DLGM_STEPS steps;
# the DLGM fused NUTS bench over the ranks.  Phase 26 at world size 1 runs
# shorter: W1_SVI_STEPS generic steps, W1_SEGMENTS segments, W1_NUTS + W1_NUTS
# transitions.  Every spawned world's collectives time out after
# RANK_TIMEOUT s; the ranks' processes are killed after RANK_DEADLINE s.
RANKS, RANK_TIMEOUT, RANK_DEADLINE = 2, 60, 600
DP_SEGMENTS, DP_SPS, DP_DLGM_STEPS, DP_LINREG_SEED = 300, 10, 50, 4
W1_SVI_STEPS, W1_SEGMENTS, W1_NUTS = 50, 20, 20
# phases 26-27 also run the particle-sharded GMM SMC at the GMM bench on
# GMM_SEEDS[0] in the fused and kernels modes (4,096 particles a rank at
# two ranks), the item-sharded dense MF at matrix_fact.Config() (750 items
# a rank at two ranks) for W1_MF_STEPS steps at world size 1 and
# DP_MF_STEPS at two ranks (the bench's 2,000 cut for time; the schedule
# follows the step count on both sides), and the bench's 1M ratings read
# from a file; the resampler at the GMM bench's 8,192 particles
W1_MF_STEPS, DP_MF_STEPS = 200, 1000
DP_GMM_MODES = ("fused", "kernels")
# phases 26-27 also run the "model" axis: the DLGM decoder split by columns
# (at world size 1 on NUTS_SVI for W1_SVI_STEPS steps in float32 and bf16,
# at two ranks at the bench for DP_DLGM_STEPS); the observation-sharded
# linreg log-density at LINREG (TP_EVALS value-and-gradient evaluations
# timed at two ranks); the MF mean-field guide split at the CPU test's
# sizes, TP_MF, whose flat vector (496 entries) splits over the ranks,
# TP_MF_STEPS steps at lr TP_MF_LR (at matrix_fact.Config() the vector has
# 76,501 entries: odd, so JAX's rule leaves it replicated)
TP_MF = dict(num_users=64, num_items=35, num_factors=4, num_ratings=4096,
             batch_size=512)
TP_MF_STEPS, TP_MF_LR, TP_EVALS = 50, 0.05, 200
# phase 28, the breadth of dist and core: (a) 2^20 seeded points a family,
# the card against the CPU at BREADTH_LIMITS (rtol, atol), at
# BREADTH_SPECIAL for values through gammainc, the incomplete beta,
# i0e/i1e, ndtri or the multivariate log-gamma; (b) BREADTH_DRAWS draws a
# family, moments by batch means over BREADTH_BATCHES batches; (c) the JAX
# package's own tests' models: 8-schools (tests/test_logjoint.py:262), the
# Wishart-precision conjugate (tests/test_multivariate_extra.py:131) and
# the LKJ prior under NUTS as (chains, warmup, samples), and a
# negative-binomial regression at a size users fit by SVI
BREADTH_POINTS = 1 << 20
BREADTH_LIMITS, BREADTH_SPECIAL = (1e-5, 1e-6), (1e-4, 1e-5)
BREADTH_DRAWS, BREADTH_BATCHES = 1_000_000, 100
# the families the earlier slices ported: their new members are gated,
# their float32 log_prob (the five models' paths) is measured
OLDER_FAMILIES = ("Normal", "HalfNormal", "Bernoulli", "Categorical",
                  "Dirichlet")
# (cut from 400 + 400, 500 + 500 and 300 + 300 since phase 29 was added:
# the runs are host-bound, and on a slow host the whole script reached
# 1,197.5 s of its 1,200 s limit with the 8-schools run at 300 + 300;
# 8-schools at 150 + 150 read max split-R-hat 1.0053 / 1.0065 / 1.0096
# over three seeds against the 1.01 gate, at 250 + 250 1.0032-1.0038)
BREADTH_NUTS = {"schools": (64, 250, 250), "wishart": (64, 200, 200),
                "lkj": (64, 150, 150)}
SCHOOLS_Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
SCHOOLS_SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)
NEGBIN = dict(rows=100_000, dim=16, steps=2000, lr=0.01, conc=5.0)
# 28(c)'s runs, each in a process of its own, and their deadline (s); phase
# 29(c)-(d), host-bound too, runs beside them in one more ("checks")
BREADTH_RUNS = ("schools", "wishart", "lkj", "negbin")
BREADTH_DEADLINE = 600
# phase 29: (a) the DLGM trainer's bf16 instance at BENCH against its
# plain version: one injected step's gradients within BF16_GRAD_SHARE of
# each leaf's max (the CPU tests' limit) and the loss at BF16_LOSS_RTOL; a
# BF16_TRAJ-step trajectory's losses at BF16_TRAJ_RTOL and its parameters
# within BF16_PARAM_SHARE of the most Adam moves one (BF16_TRAJ x LR);
# BF16_STEPS steps of fused_train beside the float32 instance, the final
# losses (mean of the last 200) within BF16_FINAL_GAP; BF16_TIMED = (steps
# a call, calls) for _device_ms, behind a spin of BF16_SPIN_MS a call (the
# wrapper's host cost is ~1.5 ms a call, its launches ~25 us each; past
# ~1,000 queued launches the host blocks until the spin ends, so the
# timed calls queue fewer).  (b) the generic run_svi in bf16 for
# BF16_GENERIC_STEPS steps at BENCH.  (c) SVI breadth on the card: IWAE and
# DReG (K 8) on the conjugate normal mean, LowRank, Flow and mean-field on
# the JAX flow test's correlated posterior (Adam 0.05 on a cosine decay:
# the JAX test's 3,000 steps at 5e-3 cut for time), TraceGuide against
# mean-field, steps in BREADTH_SVI.  (d) the model-checking tools on
# CHECK_DRAWS exact conjugate posterior draws, SBC over CHECK_SIMS
# simulations
BF16_GRAD_SHARE, BF16_LOSS_RTOL = 1e-3, 1e-5
BF16_TRAJ, BF16_TRAJ_RTOL, BF16_PARAM_SHARE = 20, 5e-4, 0.5
BF16_STEPS, BF16_FINAL_GAP, BF16_TIMED = 3000, 0.01, (30, 6)
BF16_GENERIC_STEPS, BF16_SPIN_MS = 200, 10.0
BREADTH_SVI = dict(iwae=700, corr=2000, trace=1000)
CHECK_DRAWS, CHECK_SIMS = 2000, 200
# phase 30, discrete enumeration and the further samplers, in the
# _breadth_child processes P30_RUNS started beside phase 28(c)'s at nice
# P30_NICE, so that 28(c)'s runs keep their cores (sizes in P30_SIZES, one
# dict a group's runs):
# (a) enum: tests/test_logjoint.py:339's mixture (a per-point enumerated
#     Categorical over two locations) at n 65,536 points: the marginal
#     density and gradient on the card against the CPU in float64 and
#     against MixtureSameFamily on the card, rel err <= P30_ENUM_RTOL, at
#     mu -2 and 3 (away from the mode, where the gradient is a sum of
#     terms of one sign); infer_discrete at mu 0.5, 4,096 draws in chunks
#     of 512, the 16 least certain points' frequencies within 4 SE of
#     Bayes' rule (tests/test_infer_discrete.py:20)
# (b) gibbs: tests/test_gibbs.py:42's mixture at n 10,000, 16 chains,
#     150 + 150 (cut from 200 + 200, the gates held on three seeds):
#     DiscreteGibbs against marginal NUTS on the same model,
#     each draw's means sorted (a chain may take either labeling), within
#     5 MCSE of each other, split-R-hat < 1.01
# (c) ess: the whitened logistic regression of tests/test_ess_sampler.py:48
#     at 10,000 rows x D 16, 32 chains, 200 + 500: EllipticalSlice's means
#     and sds within 5 MCSE of the port's NUTS at 150 + 150 (cut from
#     200 + 200; the sd's MCSE as sd / sqrt(2 ESS))
# (d) pt: tests/test_tempering.py:69's bimodal target (8 rungs, 16 chains;
#     mass at q > 0 in 0.3-0.7, more than 0.6 of the chains hopping) and
#     :115's Beta-Bernoulli evidence (11 + 1 rungs, 16 leapfrogs as in
#     the JAX test; SS within 0.1, TI 0.3 of the analytic log Z); the
#     draws cut from the JAX tests' 400 + 600 (bimodal, 8 leapfrogs) and
#     400 + 1,500 (evidence) to 300 + 400 each, the gates held on three
#     seeds
# (e) sg: tests/test_sgmcmc.py:38's three methods at its tolerances, cut
#     from its 2,000 + 1,500 steps to 1,000 + 750 (the gates held on three
#     seeds); sgld on a logistic regression of 100,000 rows x D 16 with a
#     subsampled plate of 1,000, each mean within P30_SGLD_SDS of (f)'s
#     Laplace sds from (f)'s mode (step 3e-6: at 1e-6 the chains had not
#     mixed in 1,000 + 1,000, one seed 1.67 sds off, R-hat 2.07)
# (f) map: map_estimate / Laplace on the same regression (full batch),
#     800 Adam steps on a cosine decay (cut from 1,500; on the card the
#     gradient ratio read 3.9e-8 at 1,500, 6.0e-8 at 800): the gradient
#     norm at the mode <= 1e-3 of the start, cov within rel 1e-3 of the
#     float64 inverse Hessian by autograd on the CPU; Laplace exact on
#     tests/test_laplace.py:49's model
# (g) svgd: tests/test_svgd.py:35's correlated Gaussian at 256 particles
#     and :55's subsampled plate, at the JAX tests' tolerances
# (h) kernels: MCMC.warmup_and_sample on hier_logistic.fused_nuts_mcmc
#     (row 4, phase 15's shapes) and dlgm.local_posterior_mcmc_fused (row
#     3, phase 10's shapes, a random decoder) at 100 + 100, equal to run
#     on the seed bit for bit, the kernels' launches counted
# (i) sharded: EllipticalSlice, ParallelTempering and SGMCMC with
#     chain_sharding at world size 1 on NCCL, equal to their unsharded
#     runs bit for bit
P30_RUNS = ("p30_enum", "p30_gibbs", "p30_ess", "p30_pt", "p30_sg_map",
            "p30_kernels")
P30_SIZES = dict(
    enum=dict(n=65_536, draws=4096, points=16, chunk=512),
    svgd=dict(particles=256, corr_steps=2000, sub_steps=1200),
    gibbs=dict(n=10_000, chains=16, warmup=150, samples=150),
    ess=dict(n=10_000, d=16, chains=32, burnin=200, samples=500, nuts=150),
    pt=dict(bimodal=dict(replicas=8, chains=16, warmup=300, samples=400,
                         leapfrog=8),
            evidence=dict(rungs=11, chains=8, warmup=300, samples=400,
                          leapfrog=16)),
    map=dict(rows=100_000, dim=16, steps=800, lr=0.05, grad_ratio=1e-3,
             cov_rtol=1e-3),
    sg=dict(conj=dict(chains=8, burnin=1000, samples=750),
            logit=dict(rows=100_000, dim=16, batch=1000, chains=8,
                       burnin=1500, samples=1500, step=3e-6)),
    kernels=dict(warmup=100, samples=100),
    sharded=dict(n=2000, d=4, batch=100, chains=8, steps=20))
P30_ENUM_RTOL, P30_SGLD_SDS, P30_NICE = 1e-5, 1.0, 10
# phase 31, the state-space families, the GP, STS and SVGP models and
# pathfinder, in three more _breadth_child processes at P30_NICE, started
# before phase 26 and read with phase 28(c)'s and phase 30's (sizes in
# P31_SIZES; widths are the JAX Config() defaults):
# (a) lgss: log_prob, filter, smooth and the gradient at STS's system (D
#     8, T 256) on the card against the CPU's float64, both methods: in
#     float64 within P31_LGSS_RTOL[0] of each output's largest entry, in
#     float32 (the NUTS path's) within P31_LGSS_RTOL[1] (the CPU's own
#     float32 reads up to 7.0e-5, the parallel gradient w.r.t. Q); ms and
#     launches a float32 log_prob at T 256 and 10,000, and the STS
#     potential and gradient at 4 chains
# (b) hmm: tests/test_hmm.py:106's NUTS (40 series x 12, 4 chains), the
#     sorted locs within 0.25; cut from 300 + 300 to 150 + 150 (0.047 from
#     the truth on an H100 at 300 + 300; 0.033 / 0.037 / 0.036 on three
#     CPU seeds at 150 + 150)
# (c) sts: Config() (T 256, season 7), 4 chains, tests/test_sts.py:116-117's
#     bands; the forecast against test_sts.py:60's dense oracle.  Cut from
#     400 + 400 to 25 + 25: an H100 (700 W) ran 0.41 transitions/s with
#     this group alone (135.7 ms a potential and gradient, the deepest of
#     the 4 chains 12.9 leapfrog steps a transition), so 400 + 400 takes
#     ~33 minutes, and at 40 + 40 the whole script read 1,131.6 s on a
#     slow host; at 25 + 25 the bands held on three CPU seeds (sigma_obs
#     0.273 / 0.322 / 0.309, sigma_level 0.113 / 0.190 / 0.165)
# (d) gp: Config() (n 256) by EllipticalSlice, 8 chains, 200 + 800, at
#     tests/test_gp.py:16-18's gates
# (e) svgp: full-rank SVI at tests/test_svgp.py:19's sizes (n 256, M 16,
#     full batch, 15,000 steps), rmse_truth < 0.1 (its distance to the
#     optimal q printed: the JAX test's 0.05 on the mean holds on 3 of 4
#     JAX keys; the port fed JAX's noise gives JAX's q); at Config() (n
#     4,096, M 32, B 512) the subsampled bound within 4 SE of the full one
#     and 1,000 SVI steps timed (the JAX package's run_svi does not
#     converge at Config(): on the CPU its loss reaches -2.5e23,
#     rmse_truth 0.47)
# (f) pathfinder: tests/test_pathfinder.py:34 (4 paths, maxiter 40, 4,000
#     draws) and :82's warm start (2 paths, 64 draws, NUTS 8 chains), at
#     those tests' gates; the warm start's NUTS cut from 150 + 400 to 100 +
#     200 (cov at 0.018 of its limit on an H100 at 150 + 400; 0.28 / 0.22
#     / 0.10 on three CPU seeds at 100 + 200)
P31_RUNS = ("p31_sts", "p31_lgss_hmm_pf", "p31_gp_svgp")
P31_SIZES = dict(
    lgss=dict(t=256, timed_t=(256, 10_000)),
    hmm=dict(series=40, t=12, chains=4, warmup=150, samples=150),
    sts=dict(chains=4, warmup=25, samples=25, seed=0),
    gp=dict(chains=8, burnin=200, samples=800),
    svgp=dict(steps=15_000, unbiased_draws=400, config_steps=1000),
    pathfinder=dict(gaussian=dict(paths=4, maxiter=40, samples=4000),
                    warm=dict(paths=2, maxiter=40, samples=64, chains=8,
                              warmup=100, keep=200)))
P31_LGSS_RTOL = (1e-8, 1e-3)
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


def _device_ms(torch, fn, reps, spin_ms=2.0):
    """Milliseconds of device time per call of ``fn`` (caller warms up):
    the calls queue behind a spin kernel that outlasts their host cost
    (``spin_ms`` a call at the card's clock), so they run back to back on
    the card and the events see no host gap."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * spin_ms * reps))
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t)
    end.record()
    torch.cuda.synchronize()
    if host_ms > spin_ms * reps:
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


def _trace(torch, fn, steps, unit="step", host=True):
    """Profile one call of ``fn`` (already warm) that runs ``steps`` steps
    (or transitions, ``unit``): device busy ms per step (union of kernel
    intervals), idle share of the window from the first kernel's start to
    the last one's end, kernels per step, and the three busiest kernel
    names with their share.  ``host=False`` records the device's activity
    alone and reads the kernels from the exported trace's text: a call of
    ~10^5 launches costs minutes through the profiler's Python events."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if host:
        kern = [(e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.device_type == DeviceType.CUDA]
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        # the device's events: kernels, copies and sets, as prof.events()
        # gives them with the host's
        kern = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if str(e.get("cat", "")).lower() in (
                    "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not kern:
        return "not measured (the profiler recorded no device kernel)"
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(kern):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(k[1] for k in kern) - min(k[0] for k in kern)
    by_name = {}
    for s, e, name in kern:
        name = name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split()[-1]
        by_name[name] = by_name.get(name, 0.0) + (e - s)
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


def _nuts_gap(diag, qa, qb):
    """max |gap| / (5 x combined MCSE + 1e-6) of the per-coordinate means
    and variances of two runs' samples (phase 10's gate)."""
    ma, mb = qa.mean((0, 1)), qb.mean((0, 1))
    sqa, sqb = (qa - ma) ** 2, (qb - mb) ** 2
    return {name: float((gap.abs() / (5 * bound + 1e-6)).max())
            for name, gap, bound in (
                ("mean", ma - mb, diag.mcse(qa) + diag.mcse(qb)),
                ("var", sqa.mean((0, 1)) - sqb.mean((0, 1)),
                 diag.mcse(sqa) + diag.mcse(sqb)))}


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
    # bounds.  SVI step, in multiply-adds a row: the forward's four
    # products (2DH + 3HZ), the four weight gradients (the same) and the
    # three input gradients the step needs (HD + 3HZ: none of the data),
    # 5DH + 9HZ in all, the plain work at the FP32 rate; the kernel runs its
    # products as three TF32 passes on the tensor cores, the bound of the
    # units it uses, which the kernels line carries.  Bytes: the data set
    # read once per call and the parameters, both Adam moments and the
    # losses read and written once, over the call's steps.
    d_, h_, z_ = cfg.data_dim, cfg.hidden, cfg.latent_dim
    svi_ops = 2 * b * (5 * d_ * h_ + 9 * h_ * z_)
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
    # the chain base: the keyed kernel over the upper half of the chains
    # from chain0 = half draws those chains' streams, so its outputs are
    # the upper half of the full-width launch's, bit for bit
    half = NUTS_CHAINS // 2
    drawn = fn.fused_nuts_draws(key, half, dim, NUTS_K, dev, chain0=half)
    want = nuts_streams(key, torch.arange(half, NUTS_CHAINS, device=dev),
                        dim, NUTS_K, dev)
    upper = fn.fused_nuts_transition_keyed(
        q0[half:], pe_k[half:], g_k[half:], key, EPS_SMALL, ones, *w, xb,
        chain0=half, **kw)
    for i, (got_, full_) in enumerate(zip((*drawn, *upper),
                                          (*want, *(o[half:] for o
                                                    in keyed)))):
        if not torch.equal(got_, full_):
            raise AssertionError(
                f"phase 9: chain0 {half}: output {i} differs from the "
                f"full-width launch's upper half, max abs "
                f"{float((got_ - full_).abs().max())}")
    lines.append(f"in-kernel draws = nuts_streams bit for bit (K {NUTS_K}, "
                 f"{GENERIC_DEPTH}); keyed = injected bit for bit, twice; "
                 f"chain0 {half} over {half} chains = the upper half, draws "
                 f"and outputs, bit for bit")
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
    ratios = _nuts_gap(diag, res_f.unconstrained, res_g.unconstrained)
    for name, ratio in ratios.items():
        if ratio > 1:
            raise AssertionError(f"phase 10: posterior {name}s differ, max "
                                 f"|gap| / bound {ratio}")
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
    # the timed calls take beta and the step on the card, as the SMC stage
    # passes them: a Python number is copied to the card with a host sync
    # each call, which would wait out the spin
    beta_t, step_t = (torch.tensor(v, device=dev) for v in (1.0, 0.03))
    t_args = (q0, mom, log_u, beta_t, step_t, m_inv, x)
    ms["mutate"] = (
        _device_ms(torch, lambda: fsg.fused_gmm_mutate(*t_args, **mkw),
                   GMM_TIMED),
        _cuda_ms(torch, lambda: fsg.mutation_core(
            q0, mom, log_u, 1.0, 0.03, m_inv, pg, kmut, lsteps, 0.65))[0])
    # one adaptation block alone: one cluster's latency, without the fill
    b_args = (q0[:fsg.PB].contiguous(), mom[:, :fsg.PB].contiguous(),
              log_u[:fsg.PB].contiguous(), beta_t, step_t, m_inv, x)
    fsg.fused_gmm_mutate(*b_args, **mkw)
    ms_block = _device_ms(torch, lambda: fsg.fused_gmm_mutate(*b_args, **mkw),
                          GMM_TIMED)
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
        + f" (mutate per stage, the others per call, the four kernels' "
        f"device time queued behind a spin; the wrappers' host time "
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


# ---------------------------------------------------------------------------
# phases 26-27: the sharded paths (parallel/, MCMC chain sharding)
# ---------------------------------------------------------------------------

def _timed(torch, dev, fn_):
    """(fn_(), its wall seconds), the device synchronised around it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    res = fn_()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t


def _hier_dp_rows(np, hl, cfg, ranks):
    """The hier bench's rows shuffled once and cut to a multiple of 8 x the
    ranks (JAX harness.py:765-769), as numpy (x, y, group), and the
    truth."""
    x, y, group, truth = hl.make_data(cfg)
    n = x.shape[0] // (8 * ranks) * (8 * ranks)
    perm = np.random.default_rng(8).permutation(x.shape[0])[:n]
    return (x[perm], y[perm], group[perm]), truth


def _hier_segment_train(fh, n_total, batch, lr0, lr_total):
    def local_train(rows, state, seed, t0):
        loc, ls, opt = state
        loc, ls, opt, losses = fh.fused_train(
            *rows, loc, ls, opt, steps=DP_SPS, lr0=lr0, lr_total=lr_total,
            seed=seed, batch=batch, t0=t0, n_total=n_total)
        return (loc, ls, opt), losses

    return local_train


def _flat_np(tree, prefix=""):
    """A tree's tensor leaves as numpy arrays under "/"-joined keys."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_np(v, f"{prefix}/{k}").items()}
    return {prefix: tree.detach().cpu().numpy()}


def _tp_mf_svi(torch, dev, guide):
    """The MF model's generic SVI at TP_MF on ``dev`` with ``guide`` (a
    guide class or a factory of the model's info)."""
    from bayesic_tpu_torch.infer.svi import SVI, Adam
    from bayesic_tpu_torch.models import matrix_fact as mf

    cfg = mf.Config(**TP_MF, device=str(dev))
    args = tuple(torch.as_tensor(a, device=dev)
                 for a in mf.make_data(cfg)[:3])
    return SVI(mf.make_model(cfg), guide, Adam(TP_MF_LR), model_args=args)


def _tp_linreg(torch, np, dev, rows=None):
    """The linreg model's log-density at LINREG (``rows``: this rank's
    ``(start, per)`` of the observations), its model args and a point
    (w, b) from a seed."""
    from bayesic_tpu_torch.core import build_logjoint
    from bayesic_tpu_torch.models import linreg as lr

    cfg = lr.Config(**LINREG, device=str(dev))
    x, y, _, _ = lr.make_data(cfg)
    if rows is not None:
        x, y = x[rows[0]:rows[0] + rows[1]], y[rows[0]:rows[0] + rows[1]]
    args = (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            cfg.noise)
    info, logdensity, _, _ = build_logjoint(
        lr.model, *args, rng_key=torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(23)
    u = {"w": torch.as_tensor(rng.normal(0, 1, cfg.dim).astype(np.float32),
                              device=dev),
         "b": torch.tensor(0.3, device=dev)}
    return info, logdensity, args, u


def _value_grad(torch, fn, u, args):
    """``fn(u, model_args=args)`` and its gradient in ``u``'s order."""
    u = {k: v.detach().requires_grad_() for k, v in u.items()}
    value = fn(u, model_args=args)
    return value.detach(), torch.autograd.grad(value, list(u.values()))


class _CollectiveBytes:
    """Counts the collectives and the bytes each rank hands to them while
    it is entered, by wrapping ``torch.distributed``'s ``all_reduce`` and
    ``all_gather`` (the only two the ``"model"`` axis calls): an
    all-reduce's buffer, an all-gather's input."""

    def __init__(self, dist):
        self.dist, self.n, self.bytes = dist, 0, 0

    def __enter__(self):
        self.saved = self.dist.all_reduce, self.dist.all_gather
        reduce_, gather_ = self.saved

        def all_reduce(t, *a, **k):
            self.n, self.bytes = self.n + 1, self.bytes + t.nbytes
            return reduce_(t, *a, **k)

        def all_gather(out, t, *a, **k):
            self.n, self.bytes = self.n + 1, self.bytes + t.nbytes
            return gather_(out, t, *a, **k)

        self.dist.all_reduce, self.dist.all_gather = all_reduce, all_gather
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce, self.dist.all_gather = self.saved


def _dp_world1_phase(torch, np, card, dev):
    """Phase 26: every sharded path at world size 1 on NCCL, each against
    its unsharded call on the same seed, bit for bit."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from bayesic_tpu_torch.infer.svi import SVI, Adam, MeanFieldGuide
    from bayesic_tpu_torch.infer.svi.svi import tree_leaves
    from bayesic_tpu_torch.io import write_ratings
    from bayesic_tpu_torch.models import dlgm
    from bayesic_tpu_torch.models import hier_logistic as hl
    from bayesic_tpu_torch.models import linreg as lr
    from bayesic_tpu_torch.models import matrix_fact as mf
    from bayesic_tpu_torch.ops import fused_hier as fh
    from bayesic_tpu_torch.ops import fused_linreg as fl
    from bayesic_tpu_torch.ops import fused_nuts as fn
    from bayesic_tpu_torch.ops import mf_dense as md
    from bayesic_tpu_torch.parallel import dp_svi_run, make_mesh
    from bayesic_tpu_torch.parallel.dp_fused import (dp_gram,
                                                     segment_averaged_train)
    from bayesic_tpu_torch.parallel.mesh import shard_leading
    from bayesic_tpu_torch.parallel.tp import (ShardedMeanFieldGuide,
                                               sharded_logdensity)

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    t_phase = time.perf_counter()
    checks, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        try:
            data = make_mesh({"data": 1})
            chain = shard_leading(make_mesh({"chain": 1}), "chain")
            # dp_gram, then the linreg trainer on it
            cfg = lr.Config(**LINREG, device=str(dev))
            xn, yn, _, _ = lr.make_data(cfg)
            x, y = (torch.as_tensor(a, device=dev) for a in (xn, yn))
            g = dp_gram(x, y, data)
            checks["dp_gram"] = torch.equal(g, fl.gram(x, y))
            fl.LAUNCHES = 0
            fit = fl.fused_train(g, cfg.n, cfg.noise,
                                 *fl.init_params(cfg.dim, device=dev),
                                 steps=LINREG_STEPS, lr0=cfg.lr, seed=3)
            launches["linreg"] = fl.LAUNCHES
            checks["linreg fused_train on dp_gram"] = same(
                fit[:2], fl.fused_train(
                    fl.gram(x, y), cfg.n, cfg.noise,
                    *fl.init_params(cfg.dim, device=dev),
                    steps=LINREG_STEPS, lr0=cfg.lr, seed=3)[:2])
            # dp_svi_run on the linreg model against SVI.run
            svi = SVI(lr.model, MeanFieldGuide, Adam(cfg.lr),
                      model_args=(x, y, cfg.noise))
            gen = torch.Generator(device=dev)
            a = svi.run(gen.manual_seed(0), W1_SVI_STEPS)
            b = dp_svi_run(svi, data, gen.manual_seed(0),
                           (x, y, cfg.noise), W1_SVI_STEPS)
            checks["dp_svi_run"] = torch.equal(a.losses, b.losses) and same(
                a.params.values(), b.params.values())
            # the DLGM's generic SVI with its rows sharded
            scfg = dlgm.Config(**dict(NUTS_SVI, steps=W1_SVI_STEPS), seed=0,
                               device=dev.type)
            a = dlgm.run_svi(scfg, torch.Generator(dev).manual_seed(0))
            b = dlgm.run_svi(scfg, torch.Generator(dev).manual_seed(0),
                             data_sharding=shard_leading(data, "data"))
            checks["dlgm.run_svi(data_sharding=)"] = np.array_equal(
                a["losses"], b["losses"]) and same(
                a["decoder_params"].values(), b["decoder_params"].values())
            # the "model" axis: the DLGM decoder split by columns in float32
            # and bf16, the observation-sharded linreg log-density, the MF
            # guide split
            model = (make_mesh({"model": 1}), "model")
            for dt in ("float32", "bfloat16"):
                ccfg = dataclasses.replace(scfg, compute_dtype=dt)
                if dt != "float32":
                    a = dlgm.run_svi(ccfg,
                                     torch.Generator(dev).manual_seed(0))
                b = dlgm.run_svi(ccfg, torch.Generator(dev).manual_seed(0),
                                 model_sharding=model)
                checks[f"dlgm.run_svi(model_sharding=) {dt}"] = \
                    np.array_equal(a["losses"], b["losses"]) and same(
                        tree_leaves(a["result"].params),
                        tree_leaves(b["result"].params))
            info, ld, args, u = _tp_linreg(torch, np, dev)
            va, ga = _value_grad(torch, ld, u, args)
            vb, gb = _value_grad(
                torch, sharded_logdensity(info, ld, model[0]), u, args)
            checks["sharded_logdensity linreg"] = torch.equal(va, vb) and \
                same(ga, gb)
            # the MF model's index_select backward adds by atomics on the
            # card, so two runs of it differ in the last bits unless the
            # deterministic kernels are on
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                a = _tp_mf_svi(torch, dev, MeanFieldGuide).run(
                    torch.Generator(dev).manual_seed(0), W1_SVI_STEPS)
                b = _tp_mf_svi(torch, dev, functools.partial(
                    ShardedMeanFieldGuide, mesh=model[0])).run(
                    torch.Generator(dev).manual_seed(0), W1_SVI_STEPS)
            finally:
                torch.use_deterministic_algorithms(False)
            checks["ShardedMeanFieldGuide"] = torch.equal(
                a.losses, b.losses) and same(a.params.values(),
                                             b.params.values())
            # segment averaging on the hier trainer against its segments
            hcfg = hl.Config()
            rows, _ = _hier_dp_rows(np, hl, hcfg, 1)
            rows = tuple(torch.as_tensor(r, device=dev) for r in rows)
            total = W1_SEGMENTS * DP_SPS
            local = _hier_segment_train(fh, rows[0].shape[0],
                                        hcfg.batch_size, hcfg.lr, total)
            start = fh.init_params(hcfg.num_groups, hcfg.num_features,
                                   device=dev)
            fh.LAUNCHES = 0
            st, ls_ = segment_averaged_train(
                local, start, rows, data, segments=W1_SEGMENTS,
                steps_per_segment=DP_SPS, seed=3, hierarchical_scales=True)
            launches["hier"] = fh.LAUNCHES
            st1, ls1 = start, []
            for s in range(W1_SEGMENTS):
                st1, l_ = local(rows, st1, (3 + s + 1) * 1 + 0, s * DP_SPS)
                ls1.append(l_)
            checks["segment_averaged_train"] = torch.equal(
                ls_, torch.cat(ls1)) and same(
                (st[0], st[1], *st[2]), (st1[0], st1[1], *st1[2]))
            # chain-sharded fused NUTS against the unsharded sampler
            ncfg = dlgm.Config(**NUTS_SVI, num_chains=NUTS_CHAINS,
                               num_warmup=W1_NUTS, num_samples=W1_NUTS,
                               seed=0, device=dev.type)
            dec = dlgm.Decoder(ncfg.latent_dim, ncfg.hidden, ncfg.data_dim,
                               torch.Generator().manual_seed(0)).to(dev)
            dparams = {k: p.detach() for k, p in dec.named_parameters()}
            xb = torch.as_tensor(dlgm.make_data(ncfg)[:NUTS_ROWS],
                                 device=dev)
            _, a = dlgm.local_posterior_mcmc_fused(
                ncfg, dec, dparams, 0.3, xb, max_doublings=NUTS_K,
                run_seed=2)
            fn.LAUNCHES = 0
            _, b = dlgm.local_posterior_mcmc_fused(
                ncfg, dec, dparams, 0.3, xb, max_doublings=NUTS_K,
                run_seed=2, chain_sharding=chain)
            launches["dlgm nuts"] = fn.LAUNCHES
            checks["local_posterior_mcmc_fused(chain_sharding=)"] = \
                torch.equal(a.unconstrained, b.unconstrained) and same(
                    (a.extra["step_size"], a.extra["inv_mass"]),
                    (b.extra["step_size"], b.extra["inv_mass"]))
            _particle_world1(torch, np, dev, checks, launches, same)
            # the item-sharded dense MF against run_dense
            mcfg = mf.Config(**MF, steps=W1_MF_STEPS, device=str(dev))
            data = mf.make_data(mcfg)
            a = mf.run_dense(mcfg, data=data)
            b = mf.run_dense_sharded(mcfg, make_mesh({"items": 1}),
                                     data=data)
            checks["run_dense_sharded"] = np.array_equal(
                a["losses"], b["losses"]) and same(
                tree_leaves(a["params"]), tree_leaves(b["params"]))
            # the bench's 1M ratings through a file, and fused_train on them
            path = os.path.join(tmp, "ratings.btpr")
            write_ratings(path, *data[:3])
            got = mf.make_data(dataclasses.replace(mcfg, data_file=path))
            checks["make_data(data_file=)"] = all(
                np.array_equal(u, v) for u, v in zip(got[:3], data[:3]))

            def fused(d):
                st = mf.dense_stats(*d[:3], mcfg.num_users, mcfg.num_items,
                                    dev)
                return md.fused_train(mf.dense_init(mcfg), *st, mcfg.noise,
                                      steps=W1_MF_STEPS, lr=MF_FUSED_LR)[2]

            md.LAUNCHES = 0
            checks["fused_train on the file's ratings"] = torch.equal(
                fused(got), fused(data))
            launches["mf file"] = md.LAUNCHES
        finally:
            dist.destroy_process_group()
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"phase 26: not bit for bit at world size 1: "
                             f"{bad}")
    if min(launches.values()) < 1:
        raise AssertionError(f"phase 26: a sharded path launched no "
                             f"kernel: {launches}")
    print(f"phase 26 sharded paths at world size 1 (NCCL) ok [{card}]: "
          + ", ".join(checks) + " each equal to the unsharded call bit for "
          "bit (linreg " + f"{LINREG_STEPS} steps, generic SVI "
          f"{W1_SVI_STEPS} steps (the MF guide at {TP_MF['num_users']} x "
          f"{TP_MF['num_items']}), {W1_SEGMENTS} x {DP_SPS} hier steps, "
          f"{NUTS_CHAINS} chains x {W1_NUTS} + {W1_NUTS}, the GMM bench "
          f"on seed {GMM_SEEDS[0]}, MF {W1_MF_STEPS} steps); kernel launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


def _particle_world1(torch, np, dev, checks, launches, same):
    """Phase 26's particle-sharded paths at world size 1: the resampler in
    both routings against ``systematic_resample``, and ``gmm.run`` in the
    fused and kernels modes against the unsharded run."""
    from bayesic_tpu_torch.models import gmm
    from bayesic_tpu_torch.ops import fused_smc_gmm as fsg
    from bayesic_tpu_torch.ops import gmm_logprob as glp
    from bayesic_tpu_torch.parallel import make_mesh
    from bayesic_tpu_torch.parallel.mesh import shard_leading
    from bayesic_tpu_torch.parallel.resample import (
        systematic_resample, systematic_resample_shard_map)

    pmesh = make_mesh({"particle": 1})
    n = GMM["num_particles"]
    g = torch.Generator(device=dev).manual_seed(26)
    lw = 3.0 * torch.randn(n, generator=g, device=dev)
    payload = {"q": torch.randn(n, 7, generator=g, device=dev),
               "ll": torch.randn(n, generator=g, device=dev)}
    ref, anc = systematic_resample(0.37, lw, payload)
    for routing in ("ring", "all_gather"):
        got, a = systematic_resample_shard_map(pmesh, "particle", routing)(
            0.37, lw, payload)
        checks[f"systematic_resample_shard_map {routing}"] = \
            torch.equal(a, anc) and same(got.values(), ref.values())
    sharding = shard_leading(pmesh, "particle")
    for mode in DP_GMM_MODES:
        cfg = gmm.Config(**GMM, mode=mode, device=str(dev))
        a = gmm.run(cfg, seed=GMM_SEEDS[0])
        glp.LAUNCHES.update(fwd=0, bwd=0, vg=0)
        fsg.LAUNCHES = 0
        b = gmm.run(cfg, seed=GMM_SEEDS[0], particle_sharding=sharding)
        if mode == "fused":
            launches["gmm fused"] = fsg.LAUNCHES
        else:
            launches["gmm kernels vg"] = glp.LAUNCHES["vg"]
            launches["gmm kernels fwd"] = glp.LAUNCHES["fwd"]
        ra, rb = a["result"], b["result"]
        checks[f"gmm.run(particle_sharding=) {mode}"] = (
            a["num_stages"] == b["num_stages"]
            and all(a[k] == b[k] for k in ("log_evidence", "gap",
                                           "accept_rate"))
            and same((ra.unconstrained, ra.log_weights, ra.ancestors),
                     (rb.unconstrained, rb.log_weights, rb.ancestors)))


def _rank_main(rank, tmp, device="cuda"):
    """One rank of phase 27 (run in a process of its own): joins a gloo
    world of ``RANKS`` ranks that share cuda:0, runs the sharded paths,
    and writes its outputs to ``tmp/rank{rank}.npz``."""
    import traceback

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from bayesic_tpu_torch.parallel import launcher

    try:
        launcher.initialize(init_method=f"file://{tmp}/rendezvous",
                            world_size=RANKS, rank=rank, local_rank=0,
                            device=device, backend="gloo",
                            timeout=RANK_TIMEOUT)
        dev = torch.device(device, 0) if device == "cuda" \
            else torch.device(device)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"),
                 **_rank_work(torch, np, rank, tmp, dev))
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)     # at once: the other rank's collectives time out
    import torch.distributed as dist

    dist.destroy_process_group()


def _rank_work(torch, np, rank, tmp, dev):
    from bayesic_tpu_torch.models import dlgm
    from bayesic_tpu_torch.models import hier_logistic as hl
    from bayesic_tpu_torch.models import linreg as lr
    from bayesic_tpu_torch.ops import fused_hier as fh
    from bayesic_tpu_torch.ops import fused_linreg as fl
    from bayesic_tpu_torch.ops import fused_nuts as fn
    from bayesic_tpu_torch.parallel import make_mesh
    from bayesic_tpu_torch.parallel.dp_fused import (dp_gram,
                                                     segment_averaged_train)
    from bayesic_tpu_torch.parallel.mesh import local_slice, shard_leading

    data = make_mesh({"data": RANKS})
    chain = shard_leading(make_mesh({"chain": RANKS}), "chain")
    out = {}

    def shard(a):
        start, per = local_slice(a.shape[0], RANKS, rank)
        return a[start:start + per]

    def timed(fn_):
        return _timed(torch, dev, fn_)

    # each path runs once short and untimed first: its first call pays the
    # set-up (model build, first kernels, first collectives) that the
    # single-process runs, warmed by the earlier phases, do not pay
    # the hier trainer, segment averaged
    cfg = hl.Config()
    rows, _ = _hier_dp_rows(np, hl, cfg, RANKS)
    local = tuple(torch.as_tensor(shard(r), device=dev) for r in rows)
    total = DP_SEGMENTS * DP_SPS
    train = _hier_segment_train(fh, rows[0].shape[0], cfg.batch_size,
                                cfg.lr, total)
    start = fh.init_params(cfg.num_groups, cfg.num_features, device=dev)

    def hier_fit(segments):
        return segment_averaged_train(
            train, start, local, data, segments=segments,
            steps_per_segment=DP_SPS, seed=3, hierarchical_scales=True)

    hier_fit(2)
    fh.LAUNCHES = 0
    (st, losses), out["hier_s"] = timed(lambda: hier_fit(DP_SEGMENTS))
    out["hier_launches"] = fh.LAUNCHES
    out["hier_loc"], out["hier_ls"] = st[0].cpu().numpy(), \
        st[1].cpu().numpy()
    out["hier_losses"] = losses.cpu().numpy()

    # linreg: the Gram of every rank's rows, then the replicated trainer
    lcfg = lr.Config(**LINREG, device=str(dev))
    xn, yn, _, _ = lr.make_data(lcfg)
    xl, yl = (torch.as_tensor(shard(a), device=dev) for a in (xn, yn))

    def linreg_fit(steps):
        g = dp_gram(xl, yl, data)
        return fl.fused_train(g, lcfg.n, lcfg.noise,
                              *fl.init_params(lcfg.dim, device=dev),
                              steps=steps, lr0=lcfg.lr, seed=DP_LINREG_SEED)

    linreg_fit(100)
    fl.LAUNCHES = 0
    (loc, ls, _, _), out["linreg_s"] = timed(
        lambda: linreg_fit(LINREG_FUSED_STEPS))
    out["linreg_launches"] = fl.LAUNCHES
    out["linreg_loc"], out["linreg_ls"] = loc.cpu().numpy(), \
        ls.cpu().numpy()

    # the DLGM's generic SVI at the bench, its rows sharded
    bcfg = dlgm.Config(**BENCH, steps=DP_DLGM_STEPS, lr=LR, seed=0,
                       device=dev.type)

    def dlgm_fit(cfg_):
        return dlgm.run_svi(cfg_, torch.Generator(dev).manual_seed(0),
                            data_sharding=shard_leading(data, "data"))

    dlgm_fit(dataclasses.replace(bcfg, steps=2))
    r, out["dlgm_s"] = timed(lambda: dlgm_fit(bcfg))
    out["dlgm_losses"] = r["losses"]

    # the DLGM's fused NUTS, the chains sharded, under phase 27's decoder
    saved = torch.load(os.path.join(tmp, "nuts.pt"), weights_only=True)
    ncfg = dlgm.Config(**NUTS_SVI, num_chains=NUTS_CHAINS,
                       num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES,
                       seed=0, device=dev.type)
    dec = dlgm.Decoder(ncfg.latent_dim, ncfg.hidden, ncfg.data_dim).to(dev)
    dparams = {k: v.to(dev) for k, v in saved["decoder"].items()}

    def nuts_fit(cfg_, sharding=chain):
        return dlgm.local_posterior_mcmc_fused(
            cfg_, dec, dparams, float(saved["sigma"]), saved["x"].to(dev),
            max_doublings=NUTS_K, run_seed=2, chain_sharding=sharding)

    nuts_fit(dataclasses.replace(ncfg, num_warmup=2, num_samples=2))
    fn.LAUNCHES = 0
    (_, res), out["nuts_s"] = timed(lambda: nuts_fit(ncfg))
    out["nuts_launches"] = fn.LAUNCHES
    out["nuts_q"] = res.unconstrained.cpu().numpy()
    out["nuts_chains"] = res.chains.cpu().numpy()
    out["nuts_step_size"] = res.extra["step_size"].cpu().numpy()
    out["nuts_inv_mass"] = res.extra["inv_mass"].cpu().numpy()

    # the control: a rank's share of the hier and NUTS work unsharded (no
    # collective), both ranks at once, which is what sharing the card
    # costs them
    import torch.distributed as dist

    def alone_hier():
        st_ = start
        for s_ in range(DP_SEGMENTS):
            st_, _ = train(local, st_, s_ + 1, s_ * DP_SPS)
        return st_

    dist.barrier()
    _, out["hier_alone_s"] = timed(alone_hier)
    dist.barrier()
    _, out["nuts_alone_s"] = timed(lambda: nuts_fit(dataclasses.replace(
        ncfg, num_chains=NUTS_CHAINS // RANKS), None))
    out.update(_rank_particle_work(torch, np, rank, tmp, dev, timed))
    out.update(_rank_tp_work(torch, np, dev, timed))
    return out


def _rank_tp_work(torch, np, dev, timed):
    """Phase 27's ``"model"``-axis runs on one rank: the DLGM decoder split
    at the bench, the observation-sharded linreg log-density and the MF
    guide split, each warmed first, timed, with the collectives and bytes
    this rank hands them counted."""
    import torch.distributed as dist

    from bayesic_tpu_torch.models import dlgm
    from bayesic_tpu_torch.parallel import make_mesh
    from bayesic_tpu_torch.parallel.mesh import axis_index, local_slice
    from bayesic_tpu_torch.parallel.tp import (ShardedMeanFieldGuide,
                                               gather_params,
                                               sharded_logdensity)

    mesh = make_mesh({"model": RANKS})
    model = (mesh, "model")
    out = {}

    def counted(fn_):
        """(fn_(), its wall seconds, its collectives, their bytes)."""
        with _CollectiveBytes(dist) as c:
            res, sec = timed(fn_)
        return res, sec, c.n, c.bytes

    # the DLGM decoder split at the bench: a step's collectives are the
    # difference between the run and its 2-step warm-up
    bcfg = dlgm.Config(**BENCH, steps=DP_DLGM_STEPS, lr=LR, seed=0,
                       device=dev.type)

    def dlgm_fit(cfg_):
        return dlgm.run_svi(cfg_, torch.Generator(dev).manual_seed(0),
                            model_sharding=model)

    _, _, n2, b2 = counted(lambda: dlgm_fit(dataclasses.replace(bcfg,
                                                                steps=2)))
    r, out["tp_dlgm_s"], n, b = counted(lambda: dlgm_fit(bcfg))
    out["tp_dlgm_coll"] = np.array([(n - n2) / (DP_DLGM_STEPS - 2),
                                    (b - b2) / (DP_DLGM_STEPS - 2)])
    out["tp_dlgm_losses"] = r["losses"]
    local = r["result"].params["model"]["decoder"]
    out["tp_dlgm_shapes"] = np.array([tuple(local[f"Dense_{i}.weight"]
                                            .shape) for i in range(2)])
    for k, v in _flat_np(gather_params(r["result"].params, *model,
                                       dlgm.decoder_kernels)).items():
        out[f"tp_dlgm_p{k}"] = v

    # the observation-sharded linreg log-density and its gradient
    rows = local_slice(LINREG["n"], RANKS, axis_index(mesh, "model"))
    info, ld, args, u = _tp_linreg(torch, np, dev, rows)
    f = sharded_logdensity(info, ld, mesh)
    _value_grad(torch, f, u, args)
    (value, grad), sec, n, b = counted(lambda: [
        _value_grad(torch, f, u, args) for _ in range(TP_EVALS)][-1])
    out["tp_lin_s"], out["tp_lin_coll"] = sec, np.array([n / TP_EVALS,
                                                         b / TP_EVALS])
    out["tp_lin_value"] = value.cpu().numpy()
    out["tp_lin_grad"] = torch.cat([g.reshape(-1) for g in grad]).cpu() \
        .numpy()

    # the MF guide split
    svi = _tp_mf_svi(torch, dev, functools.partial(ShardedMeanFieldGuide,
                                                   mesh=mesh))
    svi.run(torch.Generator(dev).manual_seed(0), 2)
    res, out["tp_mf_s"], n, b = counted(lambda: svi.run(
        torch.Generator(dev).manual_seed(0), TP_MF_STEPS))
    out["tp_mf_coll"] = np.array([n / TP_MF_STEPS, b / TP_MF_STEPS])
    out["tp_mf_losses"] = res.losses.cpu().numpy()
    out["tp_mf_local"] = np.array(res.params["loc"].numel())
    gathered = gather_params(res.params, *model,
                             lambda path, leaf: leaf.dim() == 1)
    for k, v in _flat_np(gathered).items():
        out[f"tp_mf_p{k}"] = v
    return out


def _rank_particle_work(torch, np, rank, tmp, dev, timed):
    """Phase 27's particle-sharded GMM runs, item-sharded dense MF and file
    shard on one rank."""
    from bayesic_tpu_torch.infer.smc import gather_particles
    from bayesic_tpu_torch.io import RatingsDataset
    from bayesic_tpu_torch.models import gmm
    from bayesic_tpu_torch.models import matrix_fact as mf
    from bayesic_tpu_torch.ops import fused_smc_gmm as fsg
    from bayesic_tpu_torch.ops import gmm_logprob as glp
    from bayesic_tpu_torch.parallel import make_mesh
    from bayesic_tpu_torch.parallel.mesh import shard_leading

    particle = shard_leading(make_mesh({"particle": RANKS}), "particle")
    out = {}
    for mode in DP_GMM_MODES:
        cfg = gmm.Config(**GMM, mode=mode, device=dev.type)
        # warmed on a run of one adaptation block a rank
        gmm.run(dataclasses.replace(cfg, num_particles=RANKS * 128),
                seed=GMM_SEEDS[0], particle_sharding=particle)
        glp.LAUNCHES.update(fwd=0, bwd=0, vg=0)
        fsg.LAUNCHES = 0
        r, out[f"gmm_{mode}_s"] = timed(lambda: gmm.run(
            cfg, seed=GMM_SEEDS[0], particle_sharding=particle))
        out[f"gmm_{mode}_launches"] = fsg.LAUNCHES if mode == "fused" \
            else glp.LAUNCHES["vg"]
        out[f"gmm_{mode}_fwd_launches"] = glp.LAUNCHES["fwd"]
        res = r["result"]
        out[f"gmm_{mode}_stages"] = np.array(r["num_stages"])
        out[f"gmm_{mode}_ancestors"] = res.ancestors.cpu().numpy()
        for k in ("log_evidence", "gap", "accept_rate"):
            out[f"gmm_{mode}_{k}"] = np.array(r[k])
        out[f"gmm_{mode}_q"] = gather_particles(
            res, particle).unconstrained.cpu().numpy()
    items = make_mesh({"items": RANKS})
    cfg = mf.Config(**MF, steps=DP_MF_STEPS, device=str(dev))
    data = mf.make_data(cfg)
    mf.run_dense_sharded(dataclasses.replace(cfg, steps=2), items,
                         data=data)
    r, out["mf_s"] = timed(lambda: mf.run_dense_sharded(cfg, items,
                                                        data=data))
    out["mf_losses"], out["mf_rmse"] = r["losses"], np.array(r["rmse"])
    # this rank's shard of the file the parent wrote, by the JAX
    # package's arithmetic, against the plain reader's rows
    path = os.path.join(tmp, "ratings.btpr")
    got = mf.make_data(dataclasses.replace(cfg, data_file=path))
    with RatingsDataset(path, use_native=False) as ds:
        per = len(ds) // RANKS
        want = ds.read_shard(rank * per, per)
    out["file_rows"] = np.array(len(got[0]))
    out["file_equal"] = np.array(all(np.array_equal(a, b)
                                     for a, b in zip(got[:3], want)))
    return out


def _dp_ranks_phase(torch, np, card, dev):
    """Phase 27: two ranks on the one card (gloo), at the bench shapes,
    against the single-process paths run first in this process."""
    import tempfile

    from bayesic_tpu_torch.models import dlgm
    from bayesic_tpu_torch.models import hier_logistic as hl
    from bayesic_tpu_torch.models import linreg as lr
    from bayesic_tpu_torch.ops import fused_hier as fh
    from bayesic_tpu_torch.ops import fused_linreg as fl
    from bayesic_tpu_torch.utils import diagnostics as diag

    def timed(fn_):
        return _timed(torch, dev, fn_)

    t_phase = time.perf_counter()
    # the single-process paths
    cfg = hl.Config()
    rows, truth = _hier_dp_rows(np, hl, cfg, RANKS)
    trows = tuple(torch.as_tensor(r, device=dev) for r in rows)
    total = DP_SEGMENTS * DP_SPS
    (h_loc, h_ls, _, _), hier_s = timed(lambda: fh.fused_train(
        *trows, *fh.init_params(cfg.num_groups, cfg.num_features,
                                device=dev)[:2],
        steps=total, lr0=cfg.lr, lr_total=total, seed=11,
        batch=cfg.batch_size))
    lcfg = lr.Config(**LINREG, device=str(dev))
    xn, yn, _, _ = lr.make_data(lcfg)
    x, y = (torch.as_tensor(a, device=dev) for a in (xn, yn))
    (l_loc, _, _, _), linreg_s = timed(lambda: fl.fused_train(
        fl.gram(x, y), lcfg.n, lcfg.noise,
        *fl.init_params(lcfg.dim, device=dev), steps=LINREG_FUSED_STEPS,
        lr0=lcfg.lr, seed=DP_LINREG_SEED))
    analytic, _ = lr.analytic_posterior(xn, yn, lcfg.noise)
    bcfg = dlgm.Config(**BENCH, steps=DP_DLGM_STEPS, lr=LR, seed=0,
                       device=dev.type)
    # warmed as the ranks warm their paths (_rank_work)
    dlgm.run_svi(dataclasses.replace(bcfg, steps=2))
    ref_dlgm, dlgm_s = timed(lambda: dlgm.run_svi(
        bcfg, torch.Generator(dev).manual_seed(0)))
    trained = dlgm.run_svi(dlgm.Config(**NUTS_SVI, seed=0, device=dev.type))
    ncfg = dlgm.Config(**NUTS_SVI, num_chains=NUTS_CHAINS,
                       num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES,
                       seed=0, device=dev.type)
    xb = trained["x"][:NUTS_ROWS]

    def nuts_fit(cfg_):
        return dlgm.local_posterior_mcmc_fused(
            cfg_, trained["decoder"], trained["decoder_params"],
            trained["sigma_x"], xb, max_doublings=NUTS_K, run_seed=2)

    nuts_fit(dataclasses.replace(ncfg, num_warmup=2, num_samples=2))
    (_, ref_nuts), nuts_s = timed(lambda: nuts_fit(ncfg))

    trefs = _tp_refs(torch, np, dev, timed)
    with tempfile.TemporaryDirectory() as tmp:
        prefs = _particle_refs(torch, np, dev, tmp)
        torch.save({"decoder": {k: v.cpu() for k, v
                                in trained["decoder_params"].items()},
                    "sigma": torch.tensor(trained["sigma_x"],
                                          dtype=torch.float64),
                    "x": xb.cpu()}, os.path.join(tmp, "nuts.pt"))
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke._rank_main({r}, {tmp!r}, "
             f"{dev.type!r})"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(RANKS)]
        errs = []
        try:
            for p in procs:
                left = RANK_DEADLINE - (time.perf_counter() - t)
                errs.append(p.communicate(timeout=max(left, 1.0))[1])
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 27: the ranks passed the "
                                 f"{RANK_DEADLINE} s deadline") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t
        bad = [(r, p.returncode, e[-3000:]) for r, (p, e)
               in enumerate(zip(procs, errs)) if p.returncode]
        if bad:
            raise AssertionError(f"phase 27: ranks failed: {bad}")
        outs = []
        for r in range(RANKS):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
                outs.append(dict(f))

    # replicated results: the same bits on every rank
    for k in ("hier_loc", "hier_ls", "hier_losses", "linreg_loc",
              "dlgm_losses", "nuts_step_size", "nuts_inv_mass"):
        if not all(np.array_equal(o[k], outs[0][k]) for o in outs):
            raise AssertionError(f"phase 27: {k} differs across ranks")
    launches = {k: [int(o[f"{k}_launches"]) for o in outs]
                for k in ("hier", "linreg", "nuts")}
    plines, prates = _particle_gates(np, outs, prefs)
    tlines, trates = _tp_gates(np, outs, ref_dlgm, dlgm_s, trefs)
    want = {"hier": DP_SEGMENTS, "linreg": 1,
            "nuts": NUTS_WARMUP + NUTS_SAMPLES}
    if any(c != [want[k]] * RANKS for k, c in launches.items()):
        raise AssertionError(f"phase 27: kernel launches a rank {launches}, "
                             f"want {want}")
    out = outs[0]
    lines = []

    # hier: JAX's limits against the single-process trainer, phase 13's
    # against the truth
    j = cfg.num_groups
    m_dp, m_1 = out["hier_loc"], h_loc.cpu().numpy()
    gaps = {"mu": abs(m_dp[0] - m_1[0]),
            "tau": abs(np.exp(m_dp[1]) - np.exp(m_1[1])),
            "beta": np.abs(m_dp[2 + j:] - m_1[2 + j:]).max(),
            "theta": np.abs(m_dp[2:2 + j] - m_1[2:2 + j]).max()}
    lim = {"mu": 0.15, "tau": 0.3, "beta": 0.15, "theta": 0.35}
    truth_gap = {"mu": abs(m_dp[0] - truth["mu"]),
                 "beta": np.abs(m_dp[2 + j:] - truth["beta"]).max()}
    hl_losses = out["hier_losses"]
    if any(gaps[k] > lim[k] for k in lim) or truth_gap["mu"] > 0.5 \
            or truth_gap["beta"] > 0.15 or not hl_losses[-1] < hl_losses[0]:
        raise AssertionError(f"phase 27: hier gaps {gaps} (limits {lim}), "
                             f"to the truth {truth_gap} (0.5, 0.15)")
    lines.append(
        f"hier segment_averaged_train {rows[0].shape[0]} rows, "
        f"{DP_SEGMENTS} x {DP_SPS} steps: gaps to one process's "
        + ", ".join(f"{k} {v:.4f}" for k, v in gaps.items())
        + f" (limits {lim}), to the truth mu {truth_gap['mu']:.4f} beta "
        f"{truth_gap['beta']:.4f} (0.5, 0.15)")

    # linreg: phase 22's gate
    lin_err = float(np.abs(out["linreg_loc"] - analytic).max())
    one_err = float(np.abs(l_loc.cpu().numpy() - analytic).max())
    if not lin_err < 0.02:
        raise AssertionError(f"phase 27: linreg mean off the analytic by "
                             f"{lin_err} (limit 0.02)")
    lines.append(f"linreg dp_gram + fused_train: max |mean - analytic| "
                 f"{lin_err:.5f} (one process {one_err:.5f}; limit 0.02)")

    # the DLGM's generic SVI: the losses at rtol 2e-4
    rel = np.abs(out["dlgm_losses"] - ref_dlgm["losses"]) \
        / np.abs(ref_dlgm["losses"])
    if not rel.max() < 2e-4:
        raise AssertionError(f"phase 27: DLGM losses rel err {rel.max()}")
    lines.append(f"DLGM run_svi(data_sharding=) at the bench, "
                 f"{DP_DLGM_STEPS} steps: losses max rel err "
                 f"{rel.max():.2e} (limit 2e-4)")

    # the DLGM's fused NUTS: bit for bit, else phase 10's gates
    q = torch.as_tensor(np.concatenate([o["nuts_q"] for o in outs]))
    chains = np.concatenate([o["nuts_chains"] for o in outs])
    ref_q = ref_nuts.unconstrained.cpu()
    if not np.array_equal(chains, np.arange(NUTS_CHAINS)):
        raise AssertionError(f"phase 27: the ranks ran chains {chains}")
    bits = torch.equal(q, ref_q) and np.array_equal(
        out["nuts_step_size"], ref_nuts.extra["step_size"].cpu().numpy()) \
        and np.array_equal(out["nuts_inv_mass"],
                           ref_nuts.extra["inv_mass"].cpu().numpy())
    if bits:
        lines.append(f"DLGM fused NUTS {NUTS_CHAINS} chains over {RANKS} "
                     f"ranks, {NUTS_WARMUP} + {NUTS_SAMPLES}: equal to one "
                     f"process bit for bit (samples, step size, mass)")
    else:
        rhat = float(diag.split_rhat(q).max())
        ratio = _nuts_gap(diag, q, ref_q)
        if not rhat < 1.01 or max(ratio.values()) > 1:
            raise AssertionError(f"phase 27: NUTS not bit for bit, R-hat "
                                 f"{rhat}, gap / bound {ratio}")
        lines.append(f"DLGM fused NUTS: NOT bit for bit, max split-R-hat "
                     f"{rhat:.4f}, max |gap| / 5 MCSE {ratio}")

    # rates: two ranks share the one card, so no scaling efficiency
    slow = {k: max(float(o[f"{k}_s"]) for o in outs)
            for k in ("hier", "linreg", "dlgm", "nuts")}
    work = {"hier": (total, "steps"), "linreg": (LINREG_FUSED_STEPS, "steps"),
            "dlgm": (DP_DLGM_STEPS, "steps"),
            "nuts": (NUTS_WARMUP + NUTS_SAMPLES, "transitions")}
    single = {"hier": hier_s, "linreg": linreg_s, "dlgm": dlgm_s,
              "nuts": nuts_s}
    rates = "; ".join(
        f"{k} {n / slow[k]:.1f} {u}/s over {RANKS} ranks against "
        f"{n / single[k]:.1f} in one process" for k, (n, u) in work.items())
    print(f"phase 27 two ranks on one card (gloo) ok [{card}]: "
          + "; ".join(lines + plines + tlines) + "; kernel launches a rank "
          f"{launches}", flush=True)
    alone = {k: max(float(o[f"{k}_alone_s"]) for o in outs)
             for k in ("hier", "nuts")}
    rates += "; control, a rank's share unsharded with no collective, " \
        "both ranks at once: " + "; ".join(
            f"{k} {work[k][0] / alone[k]:.1f} {work[k][1]}/s"
            for k in alone)
    rates += "; " + prates + "; " + trates
    print(f"phase 27 rates [{card}]: {rates} (each sharded call's wall on "
          f"its slower rank, the DLGM's including its data; {RANKS} ranks "
          f"share one card, so the ratio is not a scaling efficiency); "
          f"the ranks' processes {ranks_s:.1f} s in all, the phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def _tp_refs(torch, np, dev, timed):
    """Phase 27's one-process sides of the ``"model"``-axis runs (the DLGM
    decoder's is the phase's ``run_svi`` at the bench): the linreg
    log-density and gradient, TP_EVALS evaluations timed, and the MF run
    with the replicated guide, each warmed first."""
    from bayesic_tpu_torch.infer.svi import MeanFieldGuide

    _, ld, args, u = _tp_linreg(torch, np, dev)
    _value_grad(torch, ld, u, args)
    (value, grad), lin_s = timed(lambda: [
        _value_grad(torch, ld, u, args) for _ in range(TP_EVALS)][-1])
    svi = _tp_mf_svi(torch, dev, MeanFieldGuide)
    svi.run(torch.Generator(dev).manual_seed(0), 2)
    res, mf_s = timed(lambda: svi.run(torch.Generator(dev).manual_seed(0),
                                      TP_MF_STEPS))
    return {"lin_value": value.cpu().numpy(),
            "lin_grad": torch.cat([g.reshape(-1) for g in grad]).cpu()
            .numpy(), "lin_s": lin_s, "mf_losses": res.losses.cpu().numpy(),
            "mf_params": _flat_np(res.params), "mf_s": mf_s}


def _tp_gates(np, outs, ref_dlgm, dlgm_s, refs):
    """Phase 27's ``"model"``-axis gates against the one-process runs, and
    its rates: each run's wall on its slower rank, and the collectives and
    bytes a rank hands them a step (an evaluation for the linreg)."""
    from bayesic_tpu_torch.models import matrix_fact as mf

    def rel(got, want):
        return float(np.max(np.abs(got - want) / np.abs(want)))

    def close(o, prefix, want, tol):
        """max |got - want| over the tree's leaves, and whether each leaf
        is within rtol and atol ``tol``."""
        err = max(float(np.abs(o[prefix + k] - a).max())
                  for k, a in want.items())
        return err, all(np.allclose(o[prefix + k], a, rtol=tol, atol=tol)
                        for k, a in want.items())

    same = all(np.array_equal(o[k], outs[0][k]) for o in outs
               for k in outs[0] if k.startswith((
                   "tp_dlgm_p", "tp_dlgm_losses", "tp_lin_value",
                   "tp_lin_grad", "tp_mf_p", "tp_mf_losses")))
    if not same:
        raise AssertionError("phase 27: a model-axis result differs across "
                             "ranks")
    o = outs[0]

    # the DLGM decoder split: the JAX test's limits
    shapes = [[BENCH["hidden"] // RANKS, BENCH["latent_dim"]],
              [BENCH["data_dim"] // RANKS, BENCH["hidden"]]]
    loss_err = rel(o["tp_dlgm_losses"], ref_dlgm["losses"])
    p_err, p_ok = close(o, "tp_dlgm_p", _flat_np(ref_dlgm["result"].params),
                        5e-3)
    if not (np.allclose(o["tp_dlgm_losses"], ref_dlgm["losses"], rtol=2e-4,
                        atol=2e-4) and p_ok
            and np.array_equal(o["tp_dlgm_shapes"], shapes)):
        raise AssertionError(f"phase 27: DLGM model_sharding losses rel err "
                             f"{loss_err}, params {p_err}, kernel shapes "
                             f"{o['tp_dlgm_shapes'].tolist()} (want "
                             f"{shapes})")
    lines = [f"DLGM run_svi(model_sharding=) at the bench, {DP_DLGM_STEPS} "
             f"steps, decoder kernels {shapes} a rank: losses max rel err "
             f"{loss_err:.2e}, params max abs err {p_err:.2e} (rtol/atol "
             f"2e-4, 5e-3)"]

    # the observation-sharded linreg log-density: rtol 1e-5, the gradient
    # against its largest entry
    g = refs["lin_grad"]
    val_err = rel(o["tp_lin_value"], refs["lin_value"])
    grad_err = float(np.abs(o["tp_lin_grad"] - g).max() / np.abs(g).max())
    if not (val_err < 1e-5 and grad_err < 1e-5):
        raise AssertionError(f"phase 27: sharded_logdensity linreg value "
                             f"rel err {val_err}, gradient {grad_err}")
    lines.append(f"sharded_logdensity linreg N {LINREG['n']}, D "
                 f"{LINREG['dim']}: value rel err {val_err:.2e}, gradient "
                 f"{grad_err:.2e} of its max (limit 1e-5)")

    # the MF guide split: 2e-4
    def entries(c):
        return (c["num_users"] + c["num_items"]) * (c["num_factors"] + 1) + 1

    n = entries(TP_MF)
    at_config = entries(dataclasses.asdict(mf.Config()))
    mf_loss = rel(o["tp_mf_losses"], refs["mf_losses"])
    mf_err, mf_ok = close(o, "tp_mf_p", refs["mf_params"], 2e-4)
    if not (int(o["tp_mf_local"]) == n // RANKS and mf_ok
            and np.allclose(o["tp_mf_losses"], refs["mf_losses"], rtol=2e-4,
                            atol=2e-4)):
        raise AssertionError(f"phase 27: ShardedMeanFieldGuide "
                             f"{int(o['tp_mf_local'])} entries a rank, "
                             f"losses rel err {mf_loss}, params {mf_err} "
                             f"(rtol/atol 2e-4)")
    lines.append(f"ShardedMeanFieldGuide MF {TP_MF['num_users']} x "
                 f"{TP_MF['num_items']}, {TP_MF_STEPS} steps: {n} entries, "
                 f"{int(o['tp_mf_local'])} a rank, losses max rel err "
                 f"{mf_loss:.2e}, params max abs err {mf_err:.2e} (rtol/atol "
                 f"2e-4); at matrix_fact.Config() the vector has {at_config} "
                 f"entries, " + ("odd, so JAX's rule would leave it "
                                 "replicated" if at_config % 2 else "even"))

    work = {"DLGM model_sharding": ("dlgm", DP_DLGM_STEPS, "step", dlgm_s),
            "linreg sharded_logdensity": ("lin", TP_EVALS, "evaluation",
                                          refs["lin_s"]),
            "MF ShardedMeanFieldGuide": ("mf", TP_MF_STEPS, "step",
                                         refs["mf_s"])}
    rates = []
    for name, (k, count, unit, one) in work.items():
        slow = max(float(o_[f"tp_{k}_s"]) for o_ in outs)
        n_coll, n_bytes = o[f"tp_{k}_coll"]
        rates.append(f"{name} {count / slow:.1f} {unit}s/s over {RANKS} "
                     f"ranks against {count / one:.1f} in one process, "
                     f"{n_coll:.1f} collectives and {n_bytes:,.0f} B a rank "
                     f"per {unit}")
    return lines, "; ".join(rates)


def _particle_refs(torch, np, dev, tmp):
    """Phase 27's one-process sides of the particle-sharded GMM runs and the
    item-sharded dense MF, timed (the earlier phases warmed both paths), and
    the ratings file the ranks read (the bench's 1M ratings)."""
    from bayesic_tpu_torch.io import write_ratings
    from bayesic_tpu_torch.models import gmm
    from bayesic_tpu_torch.models import matrix_fact as mf

    refs = {}
    for mode in DP_GMM_MODES:
        cfg = gmm.Config(**GMM, mode=mode, device=dev.type)
        refs[f"gmm_{mode}"], refs[f"gmm_{mode}_s"] = _timed(
            torch, dev, lambda: gmm.run(cfg, seed=GMM_SEEDS[0]))
    cfg = mf.Config(**MF, steps=DP_MF_STEPS, device=str(dev))
    data = mf.make_data(cfg)
    refs["mf"], refs["mf_s"] = _timed(
        torch, dev, lambda: mf.run_dense(cfg, data=data))
    write_ratings(os.path.join(tmp, "ratings.btpr"), *data[:3])
    refs["mf_cfg"] = cfg
    return refs


def _particle_gates(np, outs, refs):
    """Phase 27's gates on the particle-sharded GMM runs (the stage count
    and ancestors equal to one process, log Z to 1e-6 relative, the
    predictive gap < 0.3 nats a point, the fused kernel launched once a
    stage a rank), the item-sharded dense MF (the final ELBO to rtol 1e-4,
    the RMSE within 5e-3 of run_dense's: the JAX test's limits) and the
    file shards; returns the lines and the
    rates, with the bytes each rank receives a stage or step."""
    out, lines, rates = outs[0], [], []
    n = GMM["num_particles"]
    per = n // RANKS
    for mode in DP_GMM_MODES:
        ref = refs[f"gmm_{mode}"]
        res = ref["result"]
        for k in ("stages", "ancestors", "log_evidence", "gap", "q"):
            if not all(np.array_equal(o[f"gmm_{mode}_{k}"],
                                      out[f"gmm_{mode}_{k}"]) for o in outs):
                raise AssertionError(f"phase 27: GMM {mode} {k} differs "
                                     f"across ranks")
        stages = int(out[f"gmm_{mode}_stages"])
        anc_ok = stages == res.num_stages and np.array_equal(
            out[f"gmm_{mode}_ancestors"], res.ancestors.cpu().numpy())
        dz = abs(float(out[f"gmm_{mode}_log_evidence"]) - ref["log_evidence"])
        gap = float(out[f"gmm_{mode}_gap"])
        bits = np.array_equal(out[f"gmm_{mode}_q"],
                              res.unconstrained.cpu().numpy()) and dz == 0.0
        launched = [int(o[f"gmm_{mode}_launches"]) for o in outs]
        fwd = [int(o[f"gmm_{mode}_fwd_launches"]) for o in outs]
        want = [stages] * RANKS if mode == "fused" else None
        if not anc_ok or dz > 1e-6 * abs(ref["log_evidence"]) \
                or not gap < 0.3 or min(launched) < 1 \
                or (want is not None and launched != want):
            raise AssertionError(
                f"phase 27: GMM {mode} over {RANKS} ranks: stages {stages} "
                f"(one process {res.num_stages}), ancestors equal {anc_ok}, "
                f"|d log Z| {dz}, gap {gap}, launches a rank {launched}")
        lines.append(
            f"GMM {mode} {n} particles over {RANKS} ranks ({per} a rank), "
            f"seed {GMM_SEEDS[0]}: {stages} stages and every stage's "
            f"ancestors equal to one process, log Z "
            f"{float(out[f'gmm_{mode}_log_evidence']):.4f} (|diff| {dz:.2e}), "
            f"gap {gap:.4f} (< 0.3), "
            + ("particles and log Z bit for bit" if bits else
               "particles NOT bit for bit")
            + f", launches a rank {launched}"
            + ("" if mode == "fused" else f" (value+grad), {fwd} (forward)"))
        slow = max(float(o[f"gmm_{mode}_s"]) for o in outs)
        # each rank receives a stage: the other ranks' ll, the ring's
        # P - 1 hops of (n_local, dim) rows, and the fused mode's accepts
        # and block steps or the generic mutation's K accept vectors
        dim, kmut = ref["smc"].dim, ref["smc"].mutation_steps
        floats = per * (1 + dim) + (per + per // 128 if mode == "fused"
                                    else kmut * per)
        rates.append(
            f"GMM {mode} {n * stages / slow:.1f} particle-stages/s over "
            f"{RANKS} ranks against {n * res.num_stages / refs[f'gmm_{mode}_s']:.1f} "
            f"in one process, {(RANKS - 1) * floats * 4} B received a rank "
            f"a stage")
    ref = refs["mf"]
    rel = abs(out["mf_losses"][-1] - ref["losses"][-1]) \
        / abs(ref["losses"][-1])
    rmse = float(out["mf_rmse"])
    cfg = refs["mf_cfg"]
    if not all(np.array_equal(o["mf_losses"], out["mf_losses"])
               for o in outs) or not rel < 1e-4 \
            or not abs(rmse - ref["rmse"]) < 5e-3:
        raise AssertionError(f"phase 27: run_dense_sharded final ELBO rel "
                             f"err {rel} (limit 1e-4), RMSE {rmse}")
    every = float(np.max(np.abs(out["mf_losses"] - ref["losses"])
                         / np.abs(ref["losses"])))
    lines.append(f"run_dense_sharded at Config() over {RANKS} ranks "
                 f"({cfg.num_items // RANKS} items a rank), {DP_MF_STEPS} "
                 f"steps: final ELBO rel err {rel:.2e} (limit 1e-4), every "
                 f"step's {every:.2e}, RMSE {rmse:.4f} (run_dense "
                 f"{ref['rmse']:.4f}, limit 5e-3 apart)")
    slow = max(float(o["mf_s"]) for o in outs)
    floats = 1 + 2 * (cfg.num_users * cfg.num_factors + cfg.num_users + 1)
    rates.append(f"dense MF {DP_MF_STEPS / slow:.1f} steps/s over {RANKS} "
                 f"ranks against {DP_MF_STEPS / refs['mf_s']:.1f} in one "
                 f"process, one all-reduce of {floats * 4} B a step")
    rows = [int(o["file_rows"]) for o in outs]
    if not all(bool(o["file_equal"]) for o in outs) \
            or rows != [cfg.num_ratings // RANKS] * RANKS:
        raise AssertionError(f"phase 27: file shards {rows} rows, equal "
                             f"{[bool(o['file_equal']) for o in outs]}")
    lines.append(f"each rank's make_data(data_file=) shard of the 1M-rating "
                 f"file equal to read_shard of its rows ({rows[0]} a rank)")
    return lines, "; ".join(rates)


# ---------------------------------------------------------------------------
# phase 28: the breadth of dist and core (no kernel: the families run as
# PyTorch ops on the card, the models through the generic MCMC and SVI)
# ---------------------------------------------------------------------------

def _b_params(np, rng, n, spec):
    """A family's parameters: a dict of float32 arrays (a batch of n) from
    ``spec``, each a (low, high) uniform range or a function of (rng, n)."""
    out = {}
    for k, v in spec.items():
        out[k] = (np.asarray(v(rng, n), np.float32) if callable(v)
                  else rng.uniform(v[0], v[1], n).astype(np.float32))
    return out


def _b_tril(np, d):
    def make(rng, n):
        t = np.tril(rng.normal(size=(n, d, d)) * 0.4, -1)
        return t + np.eye(d) * rng.uniform(0.5, 1.5, size=(n, 1, d))
    return make


def _b_spd(np, rng, n, d):
    a = rng.normal(size=(n, d, d))
    return (a @ np.swapaxes(a, -1, -2) / d + np.eye(d)).astype(np.float32)


def _b_corr(np, rng, n, d):
    t = np.tril(rng.normal(size=(n, d, d)), -1) \
        + np.eye(d) * rng.uniform(0.3, 1.5, size=(n, 1, d))
    return (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)


def _breadth_families(np):
    """Phase 28(a)'s families: (name, parameter spec, build(dist, P) from
    tensors P, points(rng, p, n) in the support, the members whose values
    go through gammainc, the incomplete beta, i0e/i1e, ndtri or the
    multivariate log-gamma, and the family built from Python floats with
    its points, for the pass that checks floats broadcast on the card)."""
    nrm = (lambda r, p, n: 2.0 * r.normal(size=n))
    ints = (lambda lo, hi: lambda r, n: r.integers(lo, hi, n))

    def counts(total, k):
        def make(r, p, n):
            tot = np.broadcast_to(total(p), (n,)).astype(np.int64)
            pr = r.dirichlet(np.ones(k), n)
            return r.multinomial(tot, pr).astype(np.float32)
        return make

    tril3, tril2 = _b_tril(np, 3), _b_tril(np, 2)
    return [
        ("Normal", dict(loc=(-2, 2), scale=(0.3, 2)),
         lambda d, P: d.Normal(P["loc"], P["scale"]), nrm, {"icdf"},
         (lambda d: d.Normal(0.5, 1.5), nrm)),
        ("LogNormal", dict(loc=(-1, 1), scale=(0.2, 1)),
         lambda d, P: d.LogNormal(P["loc"], P["scale"]),
         lambda r, p, n: r.lognormal(size=n), {"icdf"},
         (lambda d: d.LogNormal(0.3, 0.5), lambda r, p, n: r.lognormal(
             size=n))),
        ("HalfNormal", dict(scale=(0.3, 2)),
         lambda d, P: d.HalfNormal(P["scale"]),
         lambda r, p, n: np.abs(r.normal(size=n)), set(),
         (lambda d: d.HalfNormal(1.5), lambda r, p, n: np.abs(
             r.normal(size=n)))),
        ("Cauchy", dict(loc=(-2, 2), scale=(0.3, 2)),
         lambda d, P: d.Cauchy(P["loc"], P["scale"]),
         lambda r, p, n: 3.0 * r.normal(size=n), set(),
         (lambda d: d.Cauchy(1.0, 2.0), nrm)),
        ("HalfCauchy", dict(scale=(0.3, 2)),
         lambda d, P: d.HalfCauchy(P["scale"]),
         lambda r, p, n: np.abs(3.0 * r.normal(size=n)), set(),
         (lambda d: d.HalfCauchy(5.0), lambda r, p, n: np.abs(
             r.normal(size=n)))),
        ("StudentT", dict(df=(0.5, 8), loc=(-2, 2), scale=(0.3, 2)),
         lambda d, P: d.StudentT(P["df"], P["loc"], P["scale"]),
         lambda r, p, n: 3.0 * r.normal(size=n), {"cdf"},
         (lambda d: d.StudentT(3.0, 0.5, 1.5), nrm)),
        ("Laplace", dict(loc=(-2, 2), scale=(0.3, 2)),
         lambda d, P: d.Laplace(P["loc"], P["scale"]), nrm, set(),
         (lambda d: d.Laplace(1.0, 2.0), nrm)),
        ("Exponential", dict(rate=(0.3, 3)),
         lambda d, P: d.Exponential(P["rate"]),
         lambda r, p, n: r.exponential(size=n), set(),
         (lambda d: d.Exponential(1.5), lambda r, p, n: r.exponential(
             size=n))),
        ("Gamma", dict(c=(0.2, 5), r=(0.3, 3)),
         lambda d, P: d.Gamma(P["c"], P["r"]),
         lambda r, p, n: r.gamma(2.0, size=n), {"cdf"},
         (lambda d: d.Gamma(2.0, 0.1), lambda r, p, n: r.gamma(
             2.0, size=n) * 10.0)),
        ("InverseGamma", dict(c=(0.5, 5), s=(0.3, 3)),
         lambda d, P: d.InverseGamma(P["c"], P["s"]),
         lambda r, p, n: 1.0 / r.gamma(2.0, size=n), set(),
         (lambda d: d.InverseGamma(3.0, 2.0), lambda r, p, n: 1.0 / r.gamma(
             2.0, size=n))),
        ("Beta", dict(a=(0.3, 5), b=(0.3, 5)),
         lambda d, P: d.Beta(P["a"], P["b"]),
         lambda r, p, n: r.uniform(0.01, 0.99, n), {"cdf"},
         (lambda d: d.Beta(2.0, 3.0), lambda r, p, n: r.uniform(
             0.01, 0.99, n))),
        ("Uniform", dict(lo=(-2, 0), hi=(0.5, 3)),
         lambda d, P: d.Uniform(P["lo"], P["hi"]),
         lambda r, p, n: r.uniform(-2.5, 3.5, n), set(),
         (lambda d: d.Uniform(-1.0, 3.0), lambda r, p, n: r.uniform(
             -2.0, 4.0, n))),
        ("TruncatedNormal",
         dict(loc=(-1, 1), scale=(0.5, 2), low=(-2, -0.5), high=(0, 2)),
         lambda d, P: d.TruncatedNormal(P["loc"], P["scale"], P["low"],
                                        P["high"]),
         lambda r, p, n: r.uniform(-2.5, 2.5, n), set(),
         (lambda d: d.TruncatedNormal(0.5, 1.5, -1.0, 2.0),
          lambda r, p, n: r.uniform(-1.5, 2.5, n))),
        ("Weibull", dict(s=(0.5, 2), k=(0.5, 3)),
         lambda d, P: d.Weibull(P["s"], P["k"]),
         lambda r, p, n: r.exponential(size=n) + 0.01, set(),
         (lambda d: d.Weibull(1.5, 2.0), lambda r, p, n: r.exponential(
             size=n) + 0.01)),
        ("Gumbel", dict(loc=(-2, 2), scale=(0.3, 2)),
         lambda d, P: d.Gumbel(P["loc"], P["scale"]), nrm, set(),
         (lambda d: d.Gumbel(0.5, 1.2), nrm)),
        ("Pareto", dict(s=(0.5, 2), a=(1.5, 4)),
         lambda d, P: d.Pareto(P["s"], P["a"]),
         lambda r, p, n: p["s"] * (1.0 + r.exponential(size=n)), set(),
         (lambda d: d.Pareto(1.0, 2.0), lambda r, p, n: 1.0
          + r.exponential(size=n))),
        ("Chi2", dict(df=(0.5, 8)),
         lambda d, P: d.Chi2(P["df"]),
         lambda r, p, n: r.gamma(2.0, size=n), {"cdf"},
         (lambda d: d.Chi2(4.0), lambda r, p, n: r.gamma(2.0, size=n))),
        ("Bernoulli", dict(p=(0.05, 0.95)),
         lambda d, P: d.Bernoulli(probs=P["p"]),
         lambda r, p, n: r.integers(0, 2, n), set(),
         (lambda d: d.Bernoulli(probs=0.3), lambda r, p, n: r.integers(
             0, 2, n))),
        ("Binomial", dict(n=ints(1, 20), p=(0.05, 0.95)),
         lambda d, P: d.Binomial(P["n"], probs=P["p"]),
         lambda r, p, n: np.floor(r.uniform(0, 1, n) * (p["n"] + 1)), set(),
         (lambda d: d.Binomial(12.0, probs=0.3), lambda r, p, n: r.integers(
             0, 13, n))),
        ("Categorical",
         dict(probs=lambda r, n: r.dirichlet(np.ones(4), n)),
         lambda d, P: d.Categorical(probs=P["probs"]),
         lambda r, p, n: r.integers(0, 4, n), set(), None),
        ("OrderedLogistic",
         dict(eta=(-2, 2),
              cut=lambda r, n: np.sort(1.5 * r.normal(size=(n, 3)), -1)),
         lambda d, P: d.OrderedLogistic(P["eta"], P["cut"]),
         lambda r, p, n: r.integers(0, 4, n), set(), None),
        ("Poisson", dict(rate=(0.5, 8)),
         lambda d, P: d.Poisson(P["rate"]),
         lambda r, p, n: r.poisson(3.0, n), set(),
         (lambda d: d.Poisson(3.5), lambda r, p, n: r.poisson(3.0, n))),
        ("Geometric", dict(p=(0.1, 0.9)),
         lambda d, P: d.Geometric(probs=P["p"]),
         lambda r, p, n: r.geometric(0.4, n) - 1, set(),
         (lambda d: d.Geometric(probs=0.3), lambda r, p, n: r.geometric(
             0.4, n) - 1)),
        ("NegativeBinomial", dict(r=(0.5, 6), p=(0.1, 0.8)),
         lambda d, P: d.NegativeBinomial(P["r"], probs=P["p"]),
         lambda r, p, n: r.poisson(3.0, n), set(),
         (lambda d: d.NegativeBinomial(5.0, probs=0.4),
          lambda r, p, n: r.poisson(3.0, n))),
        ("Multinomial",
         dict(probs=lambda r, n: r.dirichlet(2 * np.ones(3), n)),
         lambda d, P: d.Multinomial(10, probs=P["probs"]),
         counts(lambda p: 10, 3), set(), None),
        ("MultivariateNormal",
         dict(loc=lambda r, n: r.normal(size=(n, 3)), L=tril3),
         lambda d, P: d.MultivariateNormal(P["loc"], scale_tril=P["L"]),
         lambda r, p, n: 2.0 * r.normal(size=(n, 3)), set(), None),
        ("Dirichlet", dict(alpha=lambda r, n: r.uniform(0.5, 4, (n, 3))),
         lambda d, P: d.Dirichlet(P["alpha"]),
         lambda r, p, n: r.dirichlet(np.ones(3), n), set(), None),
        ("LKJCholesky", dict(eta=(0.5, 4)),
         lambda d, P: d.LKJCholesky(3, P["eta"]),
         lambda r, p, n: _b_corr(np, r, n, 3), set(),
         (lambda d: d.LKJCholesky(3, 2.0),
          lambda r, p, n: _b_corr(np, r, n, 3))),
        ("MultivariateStudentT",
         dict(df=(3, 9), loc=lambda r, n: r.normal(size=(n, 3)), L=tril3),
         lambda d, P: d.MultivariateStudentT(P["df"], P["loc"], P["L"]),
         lambda r, p, n: 2.0 * r.normal(size=(n, 3)), set(), None),
        ("MatrixNormal",
         dict(loc=lambda r, n: r.normal(size=(n, 2, 3)), R=tril2, C=tril3),
         lambda d, P: d.MatrixNormal(P["loc"], P["R"], P["C"]),
         lambda r, p, n: r.normal(size=(n, 2, 3)), set(), None),
        ("Wishart", dict(df=(3, 8), L=tril3),
         lambda d, P: d.Wishart(P["df"], P["L"]),
         lambda r, p, n: _b_spd(np, r, n, 3), {"log_prob"}, None),
        ("InverseWishart", dict(df=(7.5, 10), L=tril3),
         lambda d, P: d.InverseWishart(P["df"], P["L"]),
         lambda r, p, n: _b_spd(np, r, n, 3), {"log_prob"}, None),
        ("BetaBinomial", dict(a=(0.5, 4), b=(0.5, 4), n=ints(1, 15)),
         lambda d, P: d.BetaBinomial(P["a"], P["b"], P["n"]),
         lambda r, p, n: np.floor(r.uniform(0, 1, n) * (p["n"] + 1)), set(),
         (lambda d: d.BetaBinomial(2.0, 3.0, 10.0),
          lambda r, p, n: r.integers(0, 11, n))),
        ("DirichletMultinomial",
         dict(alpha=lambda r, n: r.uniform(0.5, 4, (n, 3)), n=ints(1, 12)),
         lambda d, P: d.DirichletMultinomial(P["alpha"], P["n"]),
         counts(lambda p: p["n"], 3), set(), None),
        ("GaussianRandomWalk", dict(s=(0.3, 2)),
         lambda d, P: d.GaussianRandomWalk(P["s"], num_steps=5),
         lambda r, p, n: np.cumsum(r.normal(size=(n, 5)), -1), set(),
         (lambda d: d.GaussianRandomWalk(1.5, num_steps=5),
          lambda r, p, n: np.cumsum(r.normal(size=(n, 5)), -1))),
        ("VonMises", dict(loc=(-2, 2), k=(0.01, 10)),
         lambda d, P: d.VonMises(P["loc"], P["k"]),
         lambda r, p, n: r.uniform(-np.pi, np.pi, n),
         {"log_prob", "variance"},
         (lambda d: d.VonMises(1.0, 2.0), lambda r, p, n: r.uniform(
             -np.pi, np.pi, n))),
        ("ZeroInflatedDistribution", dict(g=(-2, 2), rate=(0.5, 6)),
         lambda d, P: d.ZeroInflatedDistribution(
             d.Poisson(P["rate"]), gate_logits=P["g"]),
         lambda r, p, n: r.poisson(1.0, n), set(),
         (lambda d: d.ZeroInflatedDistribution(d.Poisson(4.0),
                                               gate_logits=-0.5),
          lambda r, p, n: r.poisson(1.0, n))),
        ("ZeroInflatedPoisson", dict(g=(0.05, 0.8), rate=(0.5, 6)),
         lambda d, P: d.ZeroInflatedPoisson(P["g"], P["rate"]),
         lambda r, p, n: r.poisson(1.0, n), set(),
         (lambda d: d.ZeroInflatedPoisson(0.3, 4.0),
          lambda r, p, n: r.poisson(1.0, n))),
        ("ZeroInflatedNegativeBinomial",
         dict(g=(0.05, 0.8), r=(0.5, 6), p=(0.1, 0.8)),
         lambda d, P: d.ZeroInflatedNegativeBinomial(P["g"], P["r"],
                                                     probs=P["p"]),
         lambda r, p, n: r.poisson(1.5, n), set(),
         (lambda d: d.ZeroInflatedNegativeBinomial(0.2, 5.0, probs=0.4),
          lambda r, p, n: r.poisson(1.5, n))),
        ("Censored",
         dict(loc=(-1, 1), scale=(0.5, 2), lo=(-2, -0.5), hi=(0.5, 2)),
         lambda d, P: d.Censored(d.Normal(P["loc"], P["scale"]),
                                 lower=P["lo"], upper=P["hi"]),
         lambda r, p, n: np.clip(2.0 * r.normal(size=n), p["lo"], p["hi"]),
         set(),
         (lambda d: d.Censored(d.Normal(0.5, 1.5), lower=-1.0, upper=2.0),
          lambda r, p, n: np.clip(2.0 * r.normal(size=n), -1.0, 2.0))),
        ("Truncated",
         dict(loc=(-1, 1), scale=(0.5, 2), lo=(-2, -0.5), hi=(0.5, 2)),
         lambda d, P: d.Truncated(d.Normal(P["loc"], P["scale"]),
                                  lower=P["lo"], upper=P["hi"]),
         lambda r, p, n: r.uniform(-2.5, 2.5, n), set(),
         (lambda d: d.Truncated(d.Gamma(2.0, 1.0), lower=0.5, upper=3.0),
          lambda r, p, n: r.uniform(0.0, 3.5, n))),
        ("Delta", dict(v=(-2, 2)),
         lambda d, P: d.Delta(P["v"]),
         lambda r, p, n: np.where(r.uniform(size=n) < 0.5, p["v"],
                                  p["v"] + 1.0), set(),
         (lambda d: d.Delta(1.5), lambda r, p, n: np.where(
             r.uniform(size=n) < 0.5, 1.5, 2.5))),
        ("TransformedDistribution", dict(loc=(-1, 1), scale=(0.2, 1)),
         lambda d, P: d.TransformedDistribution(
             d.Normal(P["loc"], P["scale"]), d.transforms.Exp()),
         lambda r, p, n: r.lognormal(size=n), set(),
         (lambda d: d.TransformedDistribution(d.Normal(0.3, 0.5),
                                              d.transforms.Exp()),
          lambda r, p, n: r.lognormal(size=n))),
    ]


def _b_member(d, member, arg):
    """``d``'s member where the class defines it, else None."""
    try:
        attr = getattr(d, member)
        if member == "entropy":
            return attr()
        return attr(arg) if member in ("cdf", "icdf") else attr
    except (NotImplementedError, AttributeError):
        return None


def _b_excess(torch, got, want, limits):
    """max |got - want| / (atol + rtol |want|) over finite entries, and
    whether the non-finite entries (NaN, +-inf) sit at the same places."""
    rtol, atol = limits
    got, want = got.double(), want.to(got.device).double()
    fin = torch.isfinite(want)
    same = bool(torch.equal(fin, torch.isfinite(got))) and bool(
        torch.equal(got[~fin].nan_to_num(nan=7.0), want[~fin].nan_to_num(
            nan=7.0)))
    excess = ((got - want).abs() / (atol + rtol * want.abs()))[fin]
    return (float(excess.max()) if excess.numel() else 0.0), same


def _breadth_parity(torch, np, dev):
    """28(a): every family's log_prob and members on 2^20 seeded points, the
    card against the CPU; then each built from Python floats."""
    import bayesic_tpu_torch.dist as dist

    n = BREADTH_POINTS
    worst, checked, older = {}, 0, {}
    for name, pspec, build, points, special, floats in \
            _breadth_families(np):
        rng = np.random.default_rng(sum(map(ord, name)))
        p = _b_params(np, rng, n, pspec)
        x = np.asarray(points(rng, p, n), np.float32)
        q = rng.uniform(0.02, 0.98, x.shape).astype(np.float32)
        outs = {}
        for where in ("cpu", dev):
            P = {k: torch.as_tensor(v, device=where) for k, v in p.items()}
            d = build(dist, P)
            xt = torch.as_tensor(x, device=where)
            if name in ("Categorical", "OrderedLogistic"):
                xt = xt.long()
            res = {"log_prob": d.log_prob(xt)}
            for m in ("mean", "variance", "entropy", "cdf", "icdf"):
                arg = torch.as_tensor(q if m == "icdf" else x, device=where)
                res[m] = _b_member(d, m, arg)
            outs[str(where)] = res
        for m, g in outs[str(dev)].items():
            c = outs["cpu"][m]
            if (g is None) != (c is None):
                raise AssertionError(f"phase 28(a): {name}.{m} defined on "
                                     f"one device only")
            if g is None:
                continue
            if g.device.type != dev.type:
                raise AssertionError(f"phase 28(a): {name}.{m} computed on "
                                     f"{g.device}, not the card")
            lim = BREADTH_SPECIAL if m in special else BREADTH_LIMITS
            ex, same = _b_excess(torch, g, c, lim)
            if m == "log_prob" and name in OLDER_FAMILIES:
                # a density the earlier slices ported, summed in float32:
                # measured, and gated by its own path's phases
                older[name] = (ex, same)
                continue
            if ex > 1.0 or not same:
                raise AssertionError(
                    f"phase 28(a): {name}.{m} on the card against the CPU: "
                    f"{ex:.3g} x the limit rtol {lim[0]:g} / atol "
                    f"{lim[1]:g} (non-finite entries alike: {same})")
            worst[f"{name}.{m}"] = ex
            checked += 1
        if floats is None:
            continue
        make, fpoints = floats
        xf = np.asarray(fpoints(rng, p, n), np.float32)
        if name in OLDER_FAMILIES:
            continue
        got = make(dist).log_prob(torch.as_tensor(xf, device=dev))
        want = make(dist).log_prob(torch.as_tensor(xf))
        if got.device.type != dev.type:
            raise AssertionError(f"phase 28(a): {name} from floats computed "
                                 f"on {got.device}")
        ex, same = _b_excess(torch, got, want, BREADTH_LIMITS)
        if ex > 1.0 or not same:
            raise AssertionError(f"phase 28(a): {name} from floats, card vs "
                                 f"CPU: {ex:.3g} x the limit")
        worst[f"{name}(floats).log_prob"] = ex
        checked += 1
    return worst, checked, older


def _b_quantiles(torch, d, probs, lo, hi):
    """Quantiles of a scalar family on the card by 60 bisection steps on
    its cdf."""
    q = torch.as_tensor(probs, dtype=torch.float32, device=d.loc.device)
    lo, hi = torch.full_like(q, lo), torch.full_like(q, hi)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        below = d.cdf(mid) < q
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _breadth_samplers(np, torch, dev):
    """28(b) families: (name, family on the card, check), the check one of
    ("mv", mean, variance or None), ("q", quartiles), ("lkj",), ("vm",),
    ("delta", value); the analytic values are float64 numpy arrays (the
    class's own mean and variance where it has them)."""
    import bayesic_tpu_torch.dist as dist

    def c(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    def own(d, var=True):
        d64 = d.to_float64()
        return ("mv", d64.mean.cpu().numpy(),
                d64.variance.cpu().numpy() if var else None)

    def phi(z):
        return np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)

    def Phi(z):
        return 0.5 * np.vectorize(math.erfc)(-np.asarray(z) / np.sqrt(2))

    def trunc_norm(mu, sd, lo, hi):
        a, b = (lo - mu) / sd, (hi - mu) / sd
        z = Phi(b) - Phi(a)
        r = (phi(a) - phi(b)) / z
        return ("mv", mu + sd * r,
                sd * sd * (1 + (a * phi(a) - b * phi(b)) / z - r * r))

    def censored(mu, sd, lo, hi):
        a, b = (lo - mu) / sd, (hi - mu) / sd
        fa, fb, pa, pb = Phi(a), Phi(b), phi(a), phi(b)
        m1 = lo * fa + hi * (1 - fb) + mu * (fb - fa) + sd * (pa - pb)
        m2 = (lo * lo * fa + hi * hi * (1 - fb) + (mu * mu + sd * sd)
              * (fb - fa) + 2 * mu * sd * (pa - pb)
              + sd * sd * (a * pa - b * pb))
        return ("mv", m1, m2 - m1 * m1)

    def gamma_trunc(a, lo, hi):
        xs = np.linspace(lo, hi, 400_001)
        w = xs ** (a - 1) * np.exp(-xs)
        w /= w.sum()
        m = (w * xs).sum()
        return ("mv", m, (w * (xs - m) ** 2).sum())

    quart = np.array([0.25, 0.5, 0.75])
    L3 = np.array([[1.0, 0, 0], [0.3, 0.8, 0], [-0.2, 0.4, 0.6]])
    L2 = np.array([[1.0, 0], [0.5, 0.7]])
    st = dist.StudentT(c(3.0), c(5.0), c(1.0))
    ol = dist.OrderedLogistic(c(0.4), c([-1.0, 0.5, 2.0]))
    olp = ol.probs.double().cpu().numpy()
    k = np.arange(4)
    mn_p = np.array([0.2, 0.3, 0.5])
    dm_a = np.array([1.0, 2.0, 3.0])
    dm_p = dm_a / dm_a.sum()
    ig_a, ig_b = 6.0, 2.0
    wb = [math.gamma(1 + i / 2.0) for i in (1, 2)]
    return [
        ("LogNormal", dist.LogNormal(c(0.3), c(0.5)), None),
        ("Cauchy", dist.Cauchy(c(5.0), c(1.0)),
         ("q", 5.0 + np.tan(np.pi * (quart - 0.5)))),
        ("HalfCauchy", dist.HalfCauchy(c(2.0)),
         ("q", 2.0 * np.tan(np.pi * quart / 2))),
        ("StudentT(df 3)", st, ("q", _b_quantiles(
            torch, st, quart, -50.0, 60.0).double().cpu().numpy())),
        ("StudentT(df 8)", dist.StudentT(c(8.0), c(1.0), c(2.0)), None),
        ("Laplace", dist.Laplace(c(1.0), c(2.0)), None),
        ("Exponential", dist.Exponential(c(1.5)), None),
        ("Gamma", dist.Gamma(c(2.5), c(1.5)), None),
        ("InverseGamma", dist.InverseGamma(c(ig_a), c(ig_b)),
         ("mv", ig_b / (ig_a - 1),
          ig_b ** 2 / ((ig_a - 1) ** 2 * (ig_a - 2)))),
        ("Beta", dist.Beta(c(2.0), c(3.0)), None),
        ("Uniform", dist.Uniform(c(-1.0), c(3.0)), None),
        ("TruncatedNormal", dist.TruncatedNormal(c(0.5), c(1.5), c(-1.0),
                                                 c(2.0)),
         trunc_norm(0.5, 1.5, -1.0, 2.0)),
        ("Weibull", dist.Weibull(c(1.5), c(2.0)),
         ("mv", 1.5 * wb[0], 1.5 ** 2 * (wb[1] - wb[0] ** 2))),
        ("Gumbel", dist.Gumbel(c(0.5), c(1.2)), None),
        ("Pareto", dist.Pareto(c(1.0), c(2.0)),
         ("q", (1.0 - quart) ** (-1.0 / 2.0))),
        ("Chi2", dist.Chi2(c(4.0)), None),
        ("Binomial", dist.Binomial(c(12.0), probs=c(0.3)), None),
        ("OrderedLogistic", ol,
         ("mv", (olp * k).sum(), (olp * k * k).sum() - (olp * k).sum() ** 2)),
        ("Poisson", dist.Poisson(c(3.5)), None),
        ("Geometric", dist.Geometric(probs=c(0.3)), None),
        ("NegativeBinomial", dist.NegativeBinomial(c(5.0), probs=c(0.4)),
         None),
        ("Multinomial", dist.Multinomial(10, probs=c(mn_p)),
         ("mv", 10 * mn_p, 10 * mn_p * (1 - mn_p))),
        ("MultivariateNormal", dist.MultivariateNormal(
            c([1.0, -1.0, 0.5]), scale_tril=c(L3)), None),
        ("LKJCholesky", dist.LKJCholesky(4, c(2.0)), ("lkj", 2.0, 4)),
        ("MultivariateStudentT", dist.MultivariateStudentT(
            c(8.0), c([1.0, -1.0, 0.5]), c(L3)), None),
        ("MatrixNormal", dist.MatrixNormal(
            c(np.arange(6.0).reshape(2, 3)), c(L2), c(L3)), None),
        ("Wishart", dist.Wishart(c(8.0), c(L3)), None),
        ("InverseWishart", dist.InverseWishart(c(16.0), c(L3)), None),
        ("BetaBinomial", dist.BetaBinomial(c(2.0), c(3.0), c(10.0)), None),
        ("DirichletMultinomial", dist.DirichletMultinomial(c(dm_a), c(10.0)),
         ("mv", 10 * dm_p,
          10 * dm_p * (1 - dm_p) * (10 + dm_a.sum()) / (1 + dm_a.sum()))),
        ("GaussianRandomWalk", dist.GaussianRandomWalk(c(1.5), num_steps=5),
         None),
        ("VonMises", dist.VonMises(c(1.0), c(2.0)), ("vm",)),
        ("ZeroInflatedPoisson", dist.ZeroInflatedPoisson(c(0.3), c(4.0)),
         None),
        ("ZeroInflatedNegativeBinomial", dist.ZeroInflatedNegativeBinomial(
            c(0.2), c(5.0), probs=c(0.4)), None),
        ("ZeroInflatedDistribution", dist.ZeroInflatedDistribution(
            dist.Binomial(c(8.0), probs=c(0.6)), gate_logits=c(-0.5)), None),
        ("Censored", dist.Censored(dist.Normal(c(0.5), c(1.5)),
                                   lower=c(-1.0), upper=c(2.0)),
         censored(0.5, 1.5, -1.0, 2.0)),
        ("Truncated(Normal)", dist.Truncated(dist.Normal(c(0.5), c(1.5)),
                                             lower=c(-1.0), upper=c(2.0)),
         trunc_norm(0.5, 1.5, -1.0, 2.0)),
        ("Truncated(Gamma)", dist.Truncated(dist.Gamma(c(2.0), c(1.0)),
                                            lower=c(0.5), upper=c(3.0)),
         gamma_trunc(2.0, 0.5, 3.0)),
        ("Delta", dist.Delta(c(1.5)), ("delta", 1.5)),
        ("TransformedDistribution", dist.TransformedDistribution(
            dist.Normal(c(0.3), c(0.5)), dist.transforms.Exp()),
         own(dist.LogNormal(c(0.3), c(0.5)))),
    ]


def _b_batch_z(torch, xb, want):
    """|mean of the batch statistics - want| over its standard error from
    the batch means (the statistics xb: (batches, ...))."""
    mean = xb.mean(0)
    se = xb.std(0) / math.sqrt(xb.shape[0])
    gap = (mean - torch.as_tensor(want, dtype=torch.float64,
                                  device=xb.device)).abs()
    z = torch.where(se > 0, gap / se, torch.where(gap > 1e-9, math.inf,
                                                   0.0))
    return float(z.max())


def _breadth_draws(torch, np, dev):
    """28(b): 10^6 draws a family on the card, all in the support; the mean
    and variance within 5 standard errors (batch means over 100 batches),
    or the quartiles within 1% for the heavy tails."""
    gen = torch.Generator(device=dev).manual_seed(28)
    worst = {}
    for name, d, check in _breadth_samplers(np, torch, dev):
        x = d.sample(gen, (BREADTH_DRAWS,))
        if x.device.type != dev.type:
            raise AssertionError(f"phase 28(b): {name} drew on {x.device}")
        if not bool(d.support(x).all()):
            raise AssertionError(f"phase 28(b): {name} drew outside its "
                                 f"support")
        if check is None:
            d64 = d.to_float64()
            check = ("mv", d64.mean.cpu().numpy(),
                     d64.variance.cpu().numpy())
        xd = x.double()
        xb = xd.reshape((BREADTH_BATCHES, -1) + tuple(xd.shape[1:]))
        kind = check[0]
        if kind == "q":
            got = torch.quantile(xd.reshape(BREADTH_DRAWS, -1)[:, 0],
                                 torch.tensor([0.25, 0.5, 0.75],
                                              dtype=torch.float64,
                                              device=dev)).cpu().numpy()
            rel = float(np.max(np.abs(got - check[1]) / np.abs(check[1])))
            if rel > 0.01:
                raise AssertionError(f"phase 28(b): {name} quartiles {got} "
                                     f"against {check[1]}")
            worst[name] = f"quartiles rel {rel:.2e}"
            continue
        if kind == "delta":
            if not bool((x == check[1]).all()):
                raise AssertionError(f"phase 28(b): {name} drew off its "
                                     f"value")
            worst[name] = "exact"
            continue
        if kind == "lkj":
            eta, dd = check[1], check[2]
            r = (xb @ xb.transpose(-1, -2))
            row, col = torch.tril_indices(dd, dd, -1, device=dev)
            r = r[..., row, col]
            zs = (_b_batch_z(torch, r.mean(1), 0.0),
                  _b_batch_z(torch, (r * r).mean(1),
                             1.0 / (2 * eta + dd - 1)))
        elif kind == "vm":
            d64 = d.to_float64()
            ang = xb - float(d64.loc)
            zs = (_b_batch_z(torch, torch.sin(ang).mean(1), 0.0),
                  _b_batch_z(torch, torch.cos(ang).mean(1),
                             1.0 - float(d64.variance)))
        else:
            mean, var = check[1], check[2]
            zs = (_b_batch_z(torch, xb.mean(1), mean),)
            if var is not None:
                mt = torch.as_tensor(mean, dtype=torch.float64, device=dev)
                zs += (_b_batch_z(torch, ((xb - mt) ** 2).mean(1), var),)
        z = max(zs)
        if z > 5.0:
            raise AssertionError(f"phase 28(b): {name} moments {z:.2f} "
                                 f"standard errors off (mean, variance: "
                                 f"{zs})")
        worst[name] = f"{z:.2f} SE"
    return worst


def _b_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _breadth_schools(torch, dev, core, dist, diag, sizes):
    """28(c) 8-schools, centered, non-centered by LocScaleReparam (JAX
    tests/test_logjoint.py:262), through the generic MCMC on the card."""
    from bayesic_tpu_torch.infer.mcmc import MCMC

    y = torch.tensor(SCHOOLS_Y, device=dev)
    sigma = torch.tensor(SCHOOLS_SIGMA, device=dev)

    def eight_schools():
        mu = core.sample("mu", dist.Normal(0.0, 5.0))
        tau = core.sample("tau", dist.HalfCauchy(5.0))
        theta = core.sample("theta",
                            dist.Normal(mu, tau).expand((8,)).to_event(1))
        core.sample("obs", dist.Normal(theta, sigma).to_event(1), obs=y)

    model = core.reparam(eight_schools,
                         config={"theta": core.LocScaleReparam()})
    # (chains, warmup, samples[, seed]): the seed is 28 unless given, as
    # in a seed sweep run by hand (PERF.md)
    chains, warm, keep, seed = (*sizes, 28)[:4]
    t = time.perf_counter()
    res = MCMC(model=model, num_warmup=warm, num_samples=keep,
               num_chains=chains, target_accept=0.9, init_step_size=0.2,
               device=dev).run(seed)
    _b_sync(torch, dev)
    wall = time.perf_counter() - t
    s = diag.summary(res.samples)
    mu = float(s["mu"]["mean"])
    rhat = max(float(v["rhat"].max()) for v in s.values())
    div = float(res.extra["diverging"].float().mean())
    if abs(mu - 4.4) > 0.8 or rhat >= 1.01 or div >= 0.03:
        raise AssertionError(f"phase 28(c): 8-schools seed {seed} mu "
                             f"{mu:.3f} (4.4 +- 0.8), max split-R-hat "
                             f"{rhat:.4f} (< 1.01), "
                             f"divergences {div:.4f} (< 0.03)")
    text = core.render_model(model, rng_key=torch.Generator(
        device=dev).manual_seed(0))
    return (f"8-schools ({chains} chains, {warm}+{keep}, seed {seed}, "
            f"target 0.9) mu {mu:.3f} +- {float(s['mu']['std']):.3f}, tau "
            f"{float(s['tau']['mean']):.3f}, max split-R-hat {rhat:.4f}, "
            f"divergences {div:.4f}, {wall:.1f} s"), text


def _breadth_wishart(torch, np, dev, core, dist, diag, sizes):
    """28(c) the Wishart-precision conjugate (JAX
    tests/test_multivariate_extra.py:131): the posterior mean against the
    analytic (df0 + n)(S0^-1 + X^T X)^-1 within 5 MCSE."""
    from bayesic_tpu_torch.infer.mcmc import MCMC

    rng = np.random.default_rng(0)
    dim, n, df0 = 2, 40, 3.0
    s0 = np.eye(dim) * 0.5
    lam_true = np.array([[2.0, 0.6], [0.6, 1.5]])
    xs = rng.multivariate_normal(np.zeros(dim), np.linalg.inv(lam_true),
                                 size=n)
    x = torch.as_tensor(xs.astype(np.float32), device=dev)
    s0_tril = torch.as_tensor(np.linalg.cholesky(s0).astype(np.float32),
                              device=dev)
    zero = torch.zeros(dim, device=dev)

    def model():
        lam = core.sample("lam", dist.Wishart(df0, s0_tril))
        cov = torch.linalg.inv_ex(lam)[0]
        chol = torch.linalg.cholesky_ex(cov)[0]
        core.sample("obs", dist.MultivariateNormal(zero, scale_tril=chol)
                    .expand((n,)).to_event(1), obs=x)

    want = (df0 + n) * np.linalg.inv(np.linalg.inv(s0) + xs.T @ xs)
    chains, warm, keep = sizes
    t = time.perf_counter()
    res = MCMC(model=model, num_warmup=warm, num_samples=keep,
               num_chains=chains, device=dev).run(29)
    _b_sync(torch, dev)
    wall = time.perf_counter() - t
    s = diag.summary(res.samples)["lam"]
    got = s["mean"].double().cpu().numpy()
    mcse = s["mcse"].double().cpu().numpy()
    z = float(np.max(np.abs(got - want) / mcse))
    rhat = float(s["rhat"].max())
    if z > 5.0:
        raise AssertionError(f"phase 28(c): Wishart posterior mean {got} "
                             f"against {want}: {z:.2f} MCSE")
    return (f"Wishart precision ({chains} chains, {warm}+{keep}) mean "
            f"{np.round(got, 4).tolist()} against the analytic "
            f"{np.round(want, 4).tolist()}, {z:.2f} MCSE at most, max "
            f"split-R-hat {rhat:.4f}, {wall:.1f} s")


def _breadth_lkj(torch, dev, core, dist, diag, sizes):
    """28(c) LKJCholesky(d 4, eta 2) alone under NUTS: each off-diagonal
    correlation is Beta(eta - 1 + d/2, eta - 1 + d/2) on (-1, 1), mean 0
    and E[r^2] = 1/(2 eta + d - 1), each within 5 MCSE."""
    from bayesic_tpu_torch.infer.mcmc import MCMC

    d, eta = 4, 2.0

    def model():
        core.sample("L", dist.LKJCholesky(d, eta))

    chains, warm, keep = sizes
    t = time.perf_counter()
    res = MCMC(model=model, num_warmup=warm, num_samples=keep,
               num_chains=chains, device=dev).run(30)
    _b_sync(torch, dev)
    wall = time.perf_counter() - t
    L = res.samples["L"]
    r = L @ L.transpose(-1, -2)
    row, col = torch.tril_indices(d, d, -1, device=dev)
    r = r[..., row, col]
    s = diag.summary({"r": r, "r2": r * r})
    want2 = 1.0 / (2 * eta + d - 1)
    z_r = float((s["r"]["mean"].abs() / s["r"]["mcse"]).max())
    z_r2 = float(((s["r2"]["mean"] - want2).abs() / s["r2"]["mcse"]).max())
    if z_r > 5.0 or z_r2 > 5.0:
        raise AssertionError(f"phase 28(c): LKJ correlations mean "
                             f"{s['r']['mean'].tolist()} ({z_r:.2f} MCSE), "
                             f"E[r^2] {s['r2']['mean'].tolist()} against "
                             f"{want2:.4f} ({z_r2:.2f} MCSE)")
    return (f"LKJCholesky(d {d}, eta {eta}) prior ({chains} chains, "
            f"{warm}+{keep}) E[r] {z_r:.2f} MCSE from 0, E[r^2] "
            f"{float(s['r2']['mean'].mean()):.4f} against {want2:.4f} "
            f"({z_r2:.2f} MCSE at most), {wall:.1f} s")


def _breadth_negbin(torch, np, dev, core, dist, diag, cfg):
    """28(c) a negative-binomial regression at N 100,000 x D 16 by SVI with
    the mean-field guide, 2,000 full-batch Adam steps at lr 0.01."""
    from bayesic_tpu_torch.infer.svi import SVI, Adam, MeanFieldGuide

    rng = np.random.default_rng(31)
    n, dim, conc = cfg["rows"], cfg["dim"], cfg["conc"]
    xs = rng.normal(size=(n, dim)).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, dim)
    mu = np.exp(xs.astype(np.float64) @ beta)
    ys = rng.negative_binomial(conc, conc / (conc + mu)).astype(np.float32)
    x = torch.as_tensor(xs, device=dev)
    y = torch.as_tensor(ys, device=dev)

    def model(x, y):
        b = core.sample("beta", dist.StudentT(3.0, 0.0, 1.0)
                        .expand((x.shape[1],)).to_event(1))
        r = core.sample("conc", dist.Gamma(2.0, 0.1))
        # mean exp(x b): NegativeBinomial's mean is r exp(logits)
        logits = x @ b - torch.log(r)
        core.sample("obs", dist.NegativeBinomial(r, logits=logits)
                    .to_event(1), obs=y)

    svi = SVI(model, MeanFieldGuide, Adam(cfg["lr"]), model_args=(x, y),
              device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    state = svi.init(gen)
    svi.step(state)                                   # warm the path
    _b_sync(torch, dev)
    t = time.perf_counter()
    res = svi.run(gen, cfg["steps"], state=state)
    losses = res.losses.cpu().numpy()
    wall = time.perf_counter() - t
    loc, _ = svi.guide.stats(res.params)
    b_hat = loc["beta"].double().cpu().numpy()
    r_hat = float(torch.exp(loc["conc"]))
    gap = float(np.max(np.abs(b_hat - beta)))
    head, tail = float(losses[:100].mean()), float(losses[-100:].mean())
    if not (tail < head) or gap > 0.05 or abs(r_hat / conc - 1.0) > 0.1:
        raise AssertionError(
            f"phase 28(c): negative-binomial SVI loss {head:.1f} -> "
            f"{tail:.1f}, max |beta - truth| {gap:.4f} (0.05), conc "
            f"{r_hat:.3f} against {conc} (10%)")
    return (f"negative-binomial SVI (N {n}, D {dim}, {cfg['steps']} Adam "
            f"steps, lr {cfg['lr']}) loss {head:.1f} -> {tail:.1f}, max "
            f"|beta - truth| {gap:.4f}, conc {r_hat:.3f} (truth {conc}), "
            f"{cfg['steps'] / wall:.1f} steps/s")


def _breadth_child(which, device, sizes):
    """One 28(c) run, or phase 29(c)-(d) ("checks"), in a process of its
    own (``python -c "import chip_smoke; chip_smoke._breadth_child(...)"``):
    the generic MCMC and SVI are host-bound, so the runs share the card
    from five processes.  Prints one JSON line, the run's summary (and the
    render, or 29(d)'s line); a failed gate raises, and the process exits
    non-zero."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import bayesic_tpu_torch.core as core
    import bayesic_tpu_torch.dist as dist
    from bayesic_tpu_torch.utils import diagnostics as diag

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    if which.startswith(("p30_", "p31_")):
        line, text = (_phase30_child if which.startswith("p30_")
                      else _phase31_child)(which, device, sizes)
        print(json.dumps({"line": line, "text": text}), flush=True)
        return
    run = {"schools": lambda: _breadth_schools(torch, dev, core, dist, diag,
                                               sizes),
           "wishart": lambda: (_breadth_wishart(torch, np, dev, core, dist,
                                                diag, sizes), ""),
           "lkj": lambda: (_breadth_lkj(torch, dev, core, dist, diag,
                                        sizes), ""),
           "negbin": lambda: (_breadth_negbin(torch, np, dev, core, dist,
                                              diag, sizes), ""),
           "checks": lambda: (_svi_breadth(torch, np, dev),
                              _model_checking(torch, np, dev))}[which]
    line, text = run()
    print(json.dumps({"line": line, "text": text}), flush=True)


def _spawn_child(which, dev, sizes):
    """``_breadth_child(which, ...)`` in a process of its own."""
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke._breadth_child({which!r}, "
         f"{dev.type!r}, {sizes!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _child_result(proc, deadline, what):
    """The JSON line of a ``_breadth_child`` process, waited for until
    ``deadline`` (``time.perf_counter()``); raises if it failed."""
    try:
        out, err = proc.communicate(
            timeout=max(deadline - time.perf_counter(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{what}: the run passed its deadline") \
            from None
    if proc.returncode:
        raise AssertionError(f"{what}: the run failed: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _breadth_phase(torch, np, card, dev, p31):
    """Phase 28: the families, transforms and core pieces that the five
    models do not use, on the card (dist and core breadth).  28(c)'s four
    runs start first, each in a process of its own, and run while this
    process checks (a) and (b); phase 29's "checks" process and phase 31's
    groups (``p31``, started by the caller before phase 26) run beside
    them."""
    sizes = dict(BREADTH_NUTS, negbin=NEGBIN)
    t0 = time.perf_counter()
    procs = {w: _spawn_child(w, dev, sizes[w]) for w in BREADTH_RUNS}
    # phase 30's groups run beside them, and phase 31's, already running
    procs.update({w: _spawn_child(w, dev, P30_SIZES) for w in P30_RUNS})
    procs.update(p31)
    # leave the children (and phase 29's) a core each while (a) computes
    # on the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - len(procs) - 1))
    try:
        worst, checked, older = _breadth_parity(torch, np, dev)
        ta = time.perf_counter() - t0
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
        print(f"phase 28(a) {checked} values of "
              f"{len(_breadth_families(np))} families on {BREADTH_POINTS} "
              f"points, card = CPU within rtol {BREADTH_LIMITS[0]:g} / atol "
              f"{BREADTH_LIMITS[1]:g} (rtol {BREADTH_SPECIAL[0]:g} / atol "
              f"{BREADTH_SPECIAL[1]:g} through the special functions), "
              f"every result on the card; the largest shares of the limit: "
              + ", ".join(f"{k} {v:.3f}" for k, v in top)
              + "; the earlier slices' float32 log_prob, not gated here: "
              + ", ".join(f"{k} {v[0]:.3f} of the limit" for k, v in
                          older.items())
              + f" [{card}, {ta:.1f} s, beside 28(c)'s processes]",
              flush=True)
        t = time.perf_counter()
        draws = _breadth_draws(torch, np, dev)
        print(f"phase 28(b) {len(draws)} samplers, {BREADTH_DRAWS} draws "
              f"each on the card, all in the support: "
              + "; ".join(f"{k} {v}" for k, v in draws.items())
              + f" [{card}, {time.perf_counter() - t:.1f} s]", flush=True)
        results, walls = {}, {}
        for w, p in procs.items():
            results[w] = _child_result(
                p, t0 + BREADTH_DEADLINE,
                f"phase 28(c) {w}" if w in BREADTH_RUNS
                else f"phase {w[1:3]} {w}")
            walls[w] = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print("phase 28(c) render_model of the 8-schools model:\n"
          + results["schools"]["text"], flush=True)
    print(f"phase 28 dist and core breadth ok [{card}]: "
          + "; ".join(results[w]["line"] for w in BREADTH_RUNS)
          + f" (the phase {time.perf_counter() - t0:.1f} s, 28(c)'s four "
          f"runs in processes of their own, at once, beside phase 30's "
          f"{len(P30_RUNS)} and phase 31's {len(P31_RUNS)} groups)",
          flush=True)
    # phase 30's wall: from its start to its last group's result; phase
    # 31's groups started earlier and return their own walls
    return ({w: results[w] for w in P30_RUNS + P31_RUNS},
            max(walls[w] for w in P30_RUNS))


def _bf16_trainer(torch, np, card, dev):
    """29(a): the fused DLGM trainer's bf16 instance at the SVI bench;
    returns its entry of the kernels line."""
    from bayesic_tpu_torch.models import dlgm
    from bayesic_tpu_torch.ops import fused_vae as fv

    cfg = dlgm.Config(**BENCH, lr=LR, seed=0, device=dev.type)
    x = torch.as_tensor(dlgm.make_data(cfg), device=dev)
    p0, m0, v0 = dlgm.fused_init(cfg, torch.Generator().manual_seed(0), dev)
    n, b, z = cfg.num_data, cfg.batch_size, cfg.latent_dim
    dims = fv._check(x, p0, m0, v0, b)
    rng = np.random.default_rng(29)

    def injected(steps):
        idx = torch.as_tensor(rng.integers(0, n, (steps, b)), device=dev)
        eps = torch.as_tensor(rng.standard_normal((steps, b, z)).astype(
            np.float32), device=dev)
        out = fv._launch(x, p0, m0, v0, dims, steps=steps, lr=LR, seed=0,
                         t0=0, thin=1, idx=idx.to(torch.int32).contiguous(),
                         eps=eps.contiguous(), scale=n / b, bf16=True)
        return idx, eps, out

    idx, eps, (_, m1, _, l1) = injected(1)
    elbo, grads = fv._step_math(tuple(p0[k] for k in fv.LEAVES), x[idx[0]],
                                eps[0], n / b, "bfloat16")
    _, g32 = fv._step_math(tuple(p0[k] for k in fv.LEAVES), x[idx[0]],
                           eps[0], n / b)
    worst, max_err, mode_gap = 0.0, 0.0, 0.0
    for k, g, g_f in zip(fv.LEAVES, grads, g32):
        err = float((-m1[k] / 0.1 - g).abs().max())
        share = err / float(g.abs().max())
        if share > BF16_GRAD_SHARE:
            raise AssertionError(f"phase 29(a): grad {k} differs from the "
                                 f"plain bf16 step by {share:.3e} of its max")
        worst, max_err = max(worst, share), max(max_err, err)
        mode_gap = max(mode_gap, float((g_f - g).abs().max()
                                       / g.abs().max()))
    loss_err = abs(float(l1[0]) + float(elbo)) / abs(float(elbo))
    if loss_err > BF16_LOSS_RTOL:
        raise AssertionError(f"phase 29(a): one step's loss rel err "
                             f"{loss_err}")
    idx, eps, (pk, _, _, lk) = injected(BF16_TRAJ)
    pr, _, _, lp = fv.reference_train(x, p0, m0, v0, idx_stream=idx,
                                      eps_stream=eps, lr=LR,
                                      compute_dtype="bfloat16")
    traj_rel = float(((lk - lp).abs() / lp.abs()).max())
    param_share = max(float((pk[k] - pr[k]).abs().max())
                      for k in fv.LEAVES) / (BF16_TRAJ * LR)
    if traj_rel > BF16_TRAJ_RTOL or param_share > BF16_PARAM_SHARE:
        raise AssertionError(f"phase 29(a): {BF16_TRAJ}-step trajectory "
                             f"loss rel err {traj_rel}, params "
                             f"{param_share} of {BF16_TRAJ} lr")
    print(f"phase 29(a) bf16 trainer ok at the bench: one step's gradients "
          f"max abs err {max_err:.3e}, worst {worst:.3e} of a leaf's max "
          f"(limit {BF16_GRAD_SHARE:g}; the float32 mode's gap "
          f"{mode_gap:.3e}), loss rel err {loss_err:.2e}; {BF16_TRAJ} steps "
          f"loss rel err {traj_rel:.2e}, params within {param_share:.3f} "
          f"of {BF16_TRAJ} lr", flush=True)

    # the main path: fused_train(compute_dtype="bfloat16"), beside float32
    seed, runs = 2929, {}
    fv.LAUNCHES_BF16 = 0
    ms, out = _cuda_ms(torch, lambda: fv.fused_train(
        x, p0, m0, v0, steps=BF16_STEPS, lr=LR, seed=seed, batch=b,
        compute_dtype="bfloat16"))
    launches = fv.LAUNCHES_BF16
    if launches < 1:
        raise AssertionError("phase 29(a): fused_train never launched the "
                             "bf16 instance")
    runs["bfloat16"] = (ms, out)
    runs["float32"] = _cuda_ms(torch, lambda: fv.fused_train(
        x, p0, m0, v0, steps=BF16_STEPS, lr=LR, seed=seed, batch=b))
    last = {}
    for cd, (_, o) in runs.items():
        ls = o[3].cpu().numpy()
        sig = float(torch.exp(o[0]["usig"][0, 0]))
        if not (np.isfinite(ls).all() and ls[-200:].mean() < ls[:100].mean()
                and abs(sig - 0.3) < 0.2 and sig < 0.5):
            raise AssertionError(f"phase 29(a): {cd} run: losses "
                                 f"{ls[:100].mean()} -> {ls[-200:].mean()}, "
                                 f"sigma_x {sig}")
        last[cd] = (float(ls[-200:].mean()), sig)
    gap = abs(last["bfloat16"][0] / last["float32"][0] - 1.0)
    if gap > BF16_FINAL_GAP:
        raise AssertionError(f"phase 29(a): bf16 final loss "
                             f"{last['bfloat16'][0]} against float32's "
                             f"{last['float32'][0]}")
    steps_c, calls = BF16_TIMED
    dev_ms = {}
    for cd, (_, o) in runs.items():
        p1, m_1, v_1 = o[:3]

        def call(cd=cd, p1=p1, m_1=m_1, v_1=v_1):
            fv.fused_train(x, p1, m_1, v_1, steps=steps_c, lr=LR, seed=7,
                           batch=b, t0=BF16_STEPS, compute_dtype=cd)

        call()
        dev_ms[cd] = _device_ms(torch, call, calls, BF16_SPIN_MS) / steps_c
    idx, eps = idx[:1].expand(20, b), eps[:1].expand(20, b, z)
    fv.reference_train(x, p0, m0, v0, idx_stream=idx[:2], eps_stream=eps[:2],
                       lr=LR, compute_dtype="bfloat16")
    plain_ms, _ = _cuda_ms(torch, lambda: fv.reference_train(
        x, p0, m0, v0, idx_stream=idx, eps_stream=eps, lr=LR,
        compute_dtype="bfloat16"))
    plain_ms /= 20
    d_, h_ = cfg.data_dim, cfg.hidden
    # the products phase 5 counts (5DH + 9HZ multiply-adds a row), one
    # bf16 tensor-core pass each
    svi_ops = 2 * b * (5 * d_ * h_ + 9 * h_ * z)
    n_par = sum(int(np.prod(s_)) for s_ in fv.leaf_shapes(dims).values())
    svi_bytes = 4 * (n * d_ + 6 * n_par + BF16_STEPS) / BF16_STEPS
    bound = _bound(svi_ops, svi_bytes, PEAK_BF16)
    print(f"phase 29(a) bf16 main path ok [{card}]: fused_train "
          f"{BF16_STEPS} steps bf16 {runs['bfloat16'][0] / BF16_STEPS:.4f} "
          f"ms/step, float32 {runs['float32'][0] / BF16_STEPS:.4f} (CUDA "
          f"events, the call's host cost included); device time "
          f"({steps_c} steps a call, {calls} calls) bf16 "
          f"{dev_ms['bfloat16']:.4f}, float32 {dev_ms['float32']:.4f} "
          f"ms/step; last-200 loss bf16 {last['bfloat16'][0]:.1f} sigma_x "
          f"{last['bfloat16'][1]:.4f}, float32 {last['float32'][0]:.1f} "
          f"sigma_x {last['float32'][1]:.4f} (gap {100 * gap:.4f}%); plain "
          f"bf16 {plain_ms:.4f} ms/step; LAUNCHES_BF16 {launches}; bound "
          f"at the bf16 tensor rate {bound[0]:.4g} ms ({bound[1]}), kernel "
          f"at {100 * bound[0] / dev_ms['bfloat16']:.1f}% of it", flush=True)
    return _record("fused_vae_train_bf16", "fused_vae.cu",
                   "bayesic_tpu/ops/fused_vae.py:199", launches, max_err,
                   dev_ms["bfloat16"], plain_ms, bound)


def _bf16_generic(torch, np, card, dev):
    """29(b): the generic DLGM run_svi with compute_dtype="bfloat16" at the
    bench, and its Decoder on the card against the CPU."""
    from torch.func import functional_call

    from bayesic_tpu_torch.models import dlgm

    cfg = dlgm.Config(**BENCH, lr=LR, seed=0, steps=BF16_GENERIC_STEPS,
                      device=dev.type, compute_dtype="bfloat16")
    out = dlgm.run_svi(cfg)
    ls = out["losses"]
    if not (np.isfinite(ls).all() and np.isfinite(out["sigma_x"])
            and ls[-20:].mean() < ls[:20].mean()):
        raise AssertionError(f"phase 29(b): run_svi bf16 losses "
                             f"{ls[:20].mean()} -> {ls[-20:].mean()}")
    svi, res = out["svi"], out["result"]
    gen = torch.Generator(device=dev).manual_seed(5)
    svi.run(gen, 5, state=res.state, model_args=(out["x"],))
    g_ms, _ = _cuda_ms(torch, lambda: svi.run(
        gen, 100, state=res.state, model_args=(out["x"],)))
    dec = out["decoder"]
    params = {k: v.detach() for k, v in out["decoder_params"].items()}
    zz = torch.randn((cfg.batch_size, cfg.latent_dim),
                     generator=torch.Generator().manual_seed(6))
    on_card = functional_call(dec, params, (zz.to(dev),)).cpu()
    cpu_dec = dlgm.Decoder(cfg.latent_dim, cfg.hidden, cfg.data_dim,
                           dtype=torch.bfloat16)
    on_cpu = functional_call(cpu_dec, {k: v.cpu() for k, v in
                                       params.items()}, (zz,))
    err = (on_card - on_cpu).abs()
    tol = 2.0 ** -6 * on_cpu.abs() + 2.0 ** -7 * float(on_cpu.abs().max())
    if on_card.dtype != torch.float32 or bool((err > tol).any()):
        raise AssertionError(f"phase 29(b): Decoder(bf16) card vs CPU max "
                             f"err {float(err.max())}")
    print(f"phase 29(b) generic DLGM SVI in bf16 ok [{card}]: "
          f"{BF16_GENERIC_STEPS} steps, loss {ls[:20].mean():.1f} -> "
          f"{ls[-20:].mean():.1f}, sigma_x {out['sigma_x']:.4f}, "
          f"{1e5 / g_ms:.1f} steps/s; Decoder(bf16) card vs CPU max abs err "
          f"{float(err.max()):.3e} (limit 2^-6 |y| + 2^-7 max|y|)",
          flush=True)


def _svi_breadth(torch, np, dev):
    """29(c): the IWAE and DReG bounds, the low-rank, flow and DSL-authored
    guides through the generic SVI on the card; returns the phase's line
    (without the card's name)."""
    import scipy.stats as st

    import bayesic_tpu_torch.core as core
    import bayesic_tpu_torch.dist as dist
    from bayesic_tpu_torch.dist import constraints
    from bayesic_tpu_torch.infer.svi import (SVI, Adam, FlowGuide,
                                             LowRankGuide, MeanFieldGuide,
                                             TraceGuide,
                                             cosine_decay_schedule)

    lines = []
    # IWAE / DReG on the conjugate normal mean (JAX tests/test_svi.py:198)
    rng = np.random.default_rng(3)
    n = 30
    y = rng.normal(0.5, 1.0, n).astype(np.float32)
    log_z = st.multivariate_normal.logpdf(
        y, np.zeros(n), np.eye(n) + 25.0 * np.ones((n, n)))
    yt = torch.as_tensor(y, device=dev)

    def conj():
        mu = core.sample("mu", dist.Normal(0.0, 5.0))
        core.sample("obs", dist.Normal(mu, 1.0).expand((n,)).to_event(1),
                    obs=yt)

    for dreg in (False, True):
        svi = SVI(conj, MeanFieldGuide, Adam(0.05), num_particles=8,
                  iwae=True, dreg=dreg, device=dev)
        t = time.perf_counter()
        res = svi.run(torch.Generator(device=dev).manual_seed(0),
                      BREADTH_SVI["iwae"])
        bound = -float(res.losses[-200:].mean())
        wall = time.perf_counter() - t
        if not abs(bound - log_z) < 0.2:
            raise AssertionError(f"phase 29(c): {'DReG' if dreg else 'IWAE'}"
                                 f" bound {bound} against log Z {log_z}")
        lines.append(f"{'DReG' if dreg else 'IWAE'} K 8 bound {bound:.4f} "
                     f"vs log Z {log_z:.4f} "
                     f"({BREADTH_SVI['iwae'] / wall:.1f} steps/s)")

    # LowRank and Flow against mean-field on a correlated posterior (JAX
    # tests/test_flows.py:72)
    rng = np.random.default_rng(0)
    n, d = 64, 2
    base = rng.normal(size=(n, 1))
    xs = np.concatenate([base + 0.05 * rng.normal(size=(n, 1)),
                         base + 0.05 * rng.normal(size=(n, 1))], 1)
    ys = xs @ np.array([1.0, -0.5]) + 0.1 * rng.normal(size=n)
    cov = np.linalg.inv(np.eye(d) / 4.0 + xs.T @ xs / 0.01)
    mean = cov @ xs.T @ ys / 0.01
    ref_corr = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    xt = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    yt2 = torch.as_tensor(ys, dtype=torch.float32, device=dev)

    def corr_model():
        w = core.sample("w", dist.Normal(0.0, 2.0).expand((d,)).to_event(1))
        core.sample("obs", dist.Normal(xt @ w, 0.1).to_event(1), obs=yt2)

    steps = BREADTH_SVI["corr"]
    tails, corrs = {}, {}
    for name, guide in (("mean-field", MeanFieldGuide),
                        ("low-rank", lambda info: LowRankGuide(info, rank=1)),
                        ("flow", lambda info: FlowGuide(info, num_flows=2,
                                                        hidden=(32,)))):
        svi = SVI(corr_model, guide, Adam(cosine_decay_schedule(0.05, steps)),
                  device=dev)
        t = time.perf_counter()
        res = svi.run(torch.Generator(device=dev).manual_seed(1), steps)
        tails[name] = float(res.losses[-200:].mean())
        wall = time.perf_counter() - t
        u = svi.sample_posterior(res.params,
                                 torch.Generator(device=dev).manual_seed(2),
                                 8192)["w"].double().cpu().numpy()
        cc = np.cov(u.T)
        corrs[name] = (cc[0, 1] / np.sqrt(cc[0, 0] * cc[1, 1]),
                       float(np.abs(u.mean(0) - mean).max()), steps / wall)
    # the flow's mean within the JAX test's 0.15; the low-rank guide's,
    # slower along the posterior's long axis, within 0.25
    for name, mean_tol in (("low-rank", 0.25), ("flow", 0.15)):
        if not (tails[name] < tails["mean-field"] - 0.5
                and abs(corrs[name][0] - ref_corr) < 0.1
                and corrs[name][1] < mean_tol):
            raise AssertionError(f"phase 29(c): {name} loss {tails[name]} "
                                 f"against mean-field's "
                                 f"{tails['mean-field']}, corr "
                                 f"{corrs[name][0]} against {ref_corr}, "
                                 f"mean off by {corrs[name][1]}")
    lines.append(f"correlated posterior (corr {ref_corr:.4f}): " + ", ".join(
        f"{k} loss {tails[k]:.3f} corr {corrs[k][0]:.4f} "
        f"({corrs[k][2]:.1f} steps/s)" for k in tails))

    # TraceGuide against mean-field (JAX tests/test_predictive_guides.py:44)
    y = np.random.default_rng(0).normal(2.0, 1.0, 40).astype(np.float32)
    yt3 = torch.as_tensor(y, device=dev)

    def mean_model():
        mu = core.sample("mu", dist.Normal(0.0, 10.0))
        core.sample("obs", dist.Normal(mu, 1.0).expand((40,)).to_event(1),
                    obs=yt3)

    def guide():
        loc = core.param("mu_loc", torch.zeros((), device=dev))
        scale = core.param("mu_scale", torch.tensor(0.1, device=dev),
                           constraint=constraints.positive)
        core.sample("mu", dist.Normal(loc, scale))

    post_var = 1.0 / (1.0 / 100.0 + 40)
    post_mean = post_var * float(y.sum())
    steps = BREADTH_SVI["trace"]
    svi_t = SVI(mean_model, lambda info: TraceGuide(guide, info, device=dev),
                Adam(0.05), device=dev)
    res_t = svi_t.run(torch.Generator(device=dev).manual_seed(3), steps)
    svi_m = SVI(mean_model, MeanFieldGuide, Adam(0.05), device=dev)
    res_m = svi_m.run(torch.Generator(device=dev).manual_seed(3), steps)
    loc_t = float(res_t.params["mu_loc"])
    sd_t = float(torch.exp(res_t.params["mu_scale"]))
    loc_m, sd_m = svi_m.posterior_stats(res_m.params)
    loc_m, sd_m = float(loc_m["mu"]), float(sd_m["mu"])
    if not (abs(loc_t - loc_m) < 0.05 and abs(sd_t / sd_m - 1.0) < 0.2
            and abs(loc_t - post_mean) < 0.05):
        raise AssertionError(f"phase 29(c): TraceGuide mu {loc_t} sd {sd_t}"
                             f", mean-field {loc_m} / {sd_m}, analytic "
                             f"{post_mean} / {post_var ** 0.5}")
    lines.append(f"TraceGuide mu {loc_t:.4f} sd {sd_t:.4f}, mean-field "
                 f"{loc_m:.4f} / {sd_m:.4f}, analytic {post_mean:.4f} / "
                 f"{post_var ** 0.5:.4f}")
    return "; ".join(lines)


def _model_checking(torch, np, dev):
    """29(d): Predictive, log_likelihood, PSIS-LOO, compare and SBC on the
    card, on draws from the conjugate normal mean's exact posterior (JAX
    tests/test_compare.py:80, tests/test_sbc.py); returns the phase's
    line (without the card's name)."""
    import scipy.stats as st

    import bayesic_tpu_torch.core as core
    import bayesic_tpu_torch.dist as dist
    from bayesic_tpu_torch.infer import Predictive, log_likelihood
    from bayesic_tpu_torch.utils.compare import compare, psis_loo
    from bayesic_tpu_torch.utils.sbc import sbc

    rng = np.random.default_rng(1)
    n, tau0, sigma = 30, 2.0, 1.0
    y = rng.normal(0.7, sigma, size=n)

    def post(ys):
        prec = 1.0 / tau0 ** 2 + len(ys) / sigma ** 2
        return (ys.sum() / sigma ** 2) / prec, np.sqrt(1.0 / prec)

    mu_n, s_n = post(y)
    exact = sum(st.norm.logpdf(y[i], post(np.delete(y, i))[0],
                               np.sqrt(post(np.delete(y, i))[1] ** 2
                                       + sigma ** 2)) for i in range(n))

    def model(y, shift=0.0):
        mu = core.sample("mu", dist.Normal(0.0, tau0))
        with core.plate("data", y.shape[0]):
            core.sample("obs", dist.Normal(mu + shift, sigma).expand(
                (y.shape[0],)), obs=y)

    gen = torch.Generator(device=dev).manual_seed(11)
    draws = mu_n + s_n * torch.randn(CHECK_DRAWS, generator=gen, device=dev,
                                     dtype=torch.float64)
    yt = torch.as_tensor(y, device=dev)
    t = time.perf_counter()
    pred = Predictive(model, {"mu": draws}, model_args=(yt,))(gen)["obs"]
    if pred.device != yt.device or tuple(pred.shape) != (CHECK_DRAWS, n):
        raise AssertionError(f"phase 29(d): Predictive gave "
                             f"{tuple(pred.shape)} on {pred.device}")
    pm, pv = pred.mean(0).cpu().numpy(), pred.var(0).cpu().numpy()
    want_v = s_n ** 2 + sigma ** 2
    z_m = float(np.abs(pm - mu_n).max() / np.sqrt(want_v / CHECK_DRAWS))
    z_v = float(np.abs(pv / want_v - 1.0).max() / np.sqrt(2.0 / CHECK_DRAWS))
    if z_m > 5.0 or z_v > 5.0:
        raise AssertionError(f"phase 29(d): predictive mean {z_m:.2f} SE, "
                             f"variance {z_v:.2f} SE off")
    t_pred = time.perf_counter() - t
    t = time.perf_counter()
    ll = log_likelihood(model, {"mu": draws}, model_args=(yt,))["obs"]
    ll_bad = log_likelihood(model, {"mu": draws}, model_args=(yt, 3.0))["obs"]
    t_ll = time.perf_counter() - t
    ll_cpu = log_likelihood(model, {"mu": draws.cpu()},
                            model_args=(yt.cpu(),))["obs"]
    ll_err = float(((ll.cpu() - ll_cpu).abs() / ll_cpu.abs()).max())
    if ll.device != yt.device or ll_err > 1e-10:
        raise AssertionError(f"phase 29(d): log_likelihood on "
                             f"{ll.device}, card vs CPU rel err {ll_err}")
    loo = psis_loo(ll)
    rows = compare({"true": loo, "shifted": psis_loo(ll_bad)})
    if not (abs(loo.elpd - exact) < 0.5 and np.all(loo.pareto_k < 0.7)
            and rows[0]["name"] == "true"
            and rows[1]["d_elpd"] > 5 * rows[1]["d_se"]):
        raise AssertionError(f"phase 29(d): PSIS-LOO elpd {loo.elpd} vs "
                             f"exact {exact}, max k {loo.pareto_k.max()}, "
                             f"compare {rows}")

    def prior_fn(g):
        mu = 2.0 * torch.randn((), generator=g, device=dev)
        return {"mu": mu}, mu + torch.randn(16, generator=g, device=dev)

    def run_fn(g, ys, shift=0.0):
        pv_ = 1.0 / (0.25 + 16.0)
        return {"mu": pv_ * ys.sum() + shift + pv_ ** 0.5 * torch.randn(
            99, generator=g, device=dev)}

    t = time.perf_counter()
    ok = sbc(prior_fn, run_fn, num_sims=CHECK_SIMS, num_bins=10,
             generator=torch.Generator(device=dev).manual_seed(12))
    biased = sbc(prior_fn, lambda g, ys: run_fn(g, ys, 0.3),
                 num_sims=CHECK_SIMS, num_bins=10,
                 generator=torch.Generator(device=dev).manual_seed(13))
    t_sbc = time.perf_counter() - t
    if not (ok.min_pvalue() > 0.01 and biased.min_pvalue() < 1e-3):
        raise AssertionError(f"phase 29(d): SBC p exact {ok.min_pvalue()}, "
                             f"biased {biased.min_pvalue()}")
    return (f"Predictive "
          f"{CHECK_DRAWS} draws, mean {z_m:.2f} SE and variance {z_v:.2f} SE "
          f"from the analytic ({t_pred:.1f} s); log_likelihood card = CPU "
          f"within {ll_err:.1e} ({t_ll:.1f} s for two models); PSIS-LOO "
          f"elpd {loo.elpd:.4f} vs exact LOO {exact:.4f}, max k-hat "
          f"{float(loo.pareto_k.max()):.3f}; compare: true first, shifted "
          f"d_elpd {rows[1]['d_elpd']:.1f} +- {rows[1]['d_se']:.1f}; SBC "
          f"{CHECK_SIMS} sims min p exact {ok.min_pvalue():.3f}, shifted "
          f"{biased.min_pvalue():.2e} ({t_sbc:.1f} s)")


def _phase29(torch, np, card, dev, checks=None):
    """Phase 29: the SVI breadth and the model-checking tools, read from
    ``checks`` (the "checks" ``_breadth_child`` process, started beside
    phase 28's runs) or run here if None, then the DLGM's bf16 mode (the
    trainer's bf16 instance, the generic path) in this process; returns the
    bf16 instance's entry of the kernels line."""
    t0 = time.perf_counter()
    # the "checks" process has exited before (a) and (b) time anything, so
    # no other CUDA context shares the card then
    if checks is None:
        lines, where = (_svi_breadth(torch, np, dev),
                        _model_checking(torch, np, dev)), "in this process"
    else:
        res = _child_result(checks, time.perf_counter() + BREADTH_DEADLINE,
                            "phase 29(c)-(d)")
        lines = res["line"], res["text"]
        where = "in a process of its own, beside phase 28(c)'s runs"
    print(f"phase 29(c) SVI breadth ok [{card}, {where}]: {lines[0]}",
          flush=True)
    print(f"phase 29(d) model checking ok [{card}, {where}]: {lines[1]}",
          flush=True)
    record = _bf16_trainer(torch, np, card, dev)
    _bf16_generic(torch, np, card, dev)
    print(f"phase 29 ok [{card}] in {time.perf_counter() - t0:.1f} s "
          f"(29(c)-(d) {where})", flush=True)
    return record


# ---------------------------------------------------------------------------
# phase 30: discrete enumeration and the further samplers (no kernel but
# (h)'s: the generic engines on the card, each run in a _breadth_child
# process of its own beside phase 28(c)'s)
# ---------------------------------------------------------------------------

def _p30_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _p30_mixture(torch, np, dev, core, dist, n, dtype=None):
    """tests/test_logjoint.py:339's mixture at n points: a per-point
    enumerated Categorical assignment over two locations, and the same
    marginal by MixtureSameFamily."""
    dtype = dtype or torch.float32
    y = torch.as_tensor(np.random.default_rng(1).normal(0.5, 1.3, n)
                        .astype(np.float32), device=dev).to(dtype)
    pi = torch.tensor([0.3, 0.7], device=dev, dtype=dtype)
    locs = torch.tensor([-1.0, 2.0], device=dev, dtype=dtype)

    def model():
        mu = core.sample("mu", dist.Normal(torch.tensor(0.0, dtype=dtype,
                                                        device=dev), 3.0))
        z = core.sample("z", dist.Categorical(probs=pi), sample_shape=(n,),
                        infer={"enumerate": True})
        core.sample("obs", dist.Normal(mu + locs[z], 1.0), obs=y)

    def model_mix():
        mu = core.sample("mu", dist.Normal(torch.tensor(0.0, dtype=dtype,
                                                        device=dev), 3.0))
        core.sample("obs", dist.MixtureSameFamily(
            dist.Categorical(probs=pi), dist.Normal(mu + locs, 1.0)), obs=y)
    return model, model_mix, y, pi, locs


def _p30_enum(torch, np, dev, core, dist, sizes):
    """30(a): the enumerated density and gradient on the card against the
    CPU in float64 and against the MixtureSameFamily marginal on the card;
    infer_discrete's assignment frequencies against Bayes' rule."""
    from bayesic_tpu_torch.infer import infer_discrete

    n, draws, points, chunk = (sizes["n"], sizes["draws"], sizes["points"],
                               sizes["chunk"])
    t0 = time.perf_counter()
    model, model_mix, y, pi, locs = _p30_mixture(torch, np, dev, core, dist,
                                                 n)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, ld, _, _ = core.build_logjoint(model, rng_key=gen)
    _, ld_mix, _, _ = core.build_logjoint(model_mix, rng_key=gen)
    m64, _, _, _, _ = _p30_mixture(torch, np, torch.device("cpu"), core,
                                   dist, n, torch.float64)
    _, ld64, _, _ = core.build_logjoint(m64)
    worst = {"cpu64": 0.0, "mix": 0.0}
    # away from the mode, where the gradient is a sum of terms of one sign
    for mu0 in (-2.0, 3.0):
        g, v = torch.func.grad_and_value(lambda m: ld({"mu": m}))(
            torch.tensor(mu0, device=dev))
        g64, v64 = torch.func.grad_and_value(lambda m: ld64({"mu": m}))(
            torch.tensor(mu0, dtype=torch.float64))
        gm, vm = torch.func.grad_and_value(lambda m: ld_mix({"mu": m}))(
            torch.tensor(mu0, device=dev))
        for k, (a, b) in (("cpu64", ((v, g), (v64, g64))),
                          ("mix", ((v, g), (vm, gm)))):
            for u, w in zip(a, b):
                worst[k] = max(worst[k], abs(float(u) - float(w))
                               / abs(float(w)))
    if max(worst.values()) > P30_ENUM_RTOL:
        raise AssertionError(f"phase 30(a): enumerated density rel err "
                             f"{worst} > {P30_ENUM_RTOL}")
    # infer_discrete at mu = 0.5: the chosen points are those whose
    # assignment is least certain
    mu0 = 0.5
    yn = y.double().cpu().numpy()
    lp0 = np.log(0.3) - 0.5 * (yn - mu0 + 1.0) ** 2
    lp1 = np.log(0.7) - 0.5 * (yn - mu0 - 2.0) ** 2
    p1 = 1.0 / (1.0 + np.exp(lp0 - lp1))
    chosen = np.argsort(np.abs(p1 - 0.5))[:points]
    t = time.perf_counter()
    counts = torch.zeros(points, device=dev)
    for i in range(draws // chunk):
        out = infer_discrete(model, {"mu": torch.full((chunk,), mu0,
                                                      device=dev)}, 100 + i)
        if out["z"].shape != (chunk, n) or out["z"].device != y.device:
            raise AssertionError(f"phase 30(a): infer_discrete gave "
                                 f"{tuple(out['z'].shape)} on "
                                 f"{out['z'].device}")
        counts += out["z"][:, torch.as_tensor(chosen, device=dev)].float() \
            .sum(0)
    _p30_sync(torch, dev)
    t_inf = time.perf_counter() - t
    freq = counts.cpu().numpy() / draws
    pc = p1[chosen]
    z = np.abs(freq - pc) / np.sqrt(pc * (1 - pc) / draws)
    if z.max() > 4.0:
        raise AssertionError(f"phase 30(a): infer_discrete frequencies "
                             f"{z.max():.2f} SE from Bayes' rule (> 4)")
    return (f"30(a) enumeration at N {n}: value and gradient rel err "
            f"{worst['cpu64']:.2e} against the CPU in float64, "
            f"{worst['mix']:.2e} against MixtureSameFamily (<= "
            f"{P30_ENUM_RTOL:g}); infer_discrete {draws} draws x {n} "
            f"points in {t_inf:.1f} s ({draws * n / t_inf / 1e6:.1f} M "
            f"assignments/s), {points} chosen points' frequencies within "
            f"{z.max():.2f} SE of Bayes' rule (<= 4) "
            f"[{time.perf_counter() - t0:.1f} s]")


def _p30_gibbs(torch, np, dev, core, dist, diag, sizes):
    """30(b): DiscreteGibbs against marginal NUTS on tests/test_gibbs.py:42's
    mixture at n points."""
    from bayesic_tpu_torch.infer.mcmc import MCMC, DiscreteGibbs

    n, chains, warm, keep = (sizes["n"], sizes["chains"], sizes["warmup"],
                             sizes["samples"])
    rng = np.random.default_rng(0)
    y = torch.as_tensor(np.concatenate([
        rng.normal(-2.0, 0.5, n // 2), rng.normal(2.0, 0.5, n - n // 2)])
        .astype(np.float32), device=dev)
    prior_loc = torch.tensor([-1.0, 1.0], device=dev)
    half = torch.tensor([0.5, 0.5], device=dev)

    def model():
        mu = core.sample("mu", dist.Normal(prior_loc, 2.0).to_event(1))
        with core.plate("data", n):
            z = core.sample("z", dist.Categorical(half), sample_shape=(n,),
                            infer={"enumerate": True})
            core.sample("obs", dist.Normal(mu[z], 0.5), obs=y)

    t = time.perf_counter()
    g = DiscreteGibbs(model, num_warmup=warm, num_samples=keep,
                      num_chains=chains, device=dev).run(30)
    _p30_sync(torch, dev)
    wall_g = time.perf_counter() - t
    t = time.perf_counter()
    m = MCMC(model=model, num_warmup=warm, num_samples=keep,
             num_chains=chains, device=dev).run(31)
    _p30_sync(torch, dev)
    wall_m = time.perf_counter() - t
    # label-invariant: each draw's two means sorted (a chain may settle on
    # either labeling)
    sg = diag.summary({"mu": torch.sort(g.samples["mu"], -1)[0].cpu()})["mu"]
    sm = diag.summary({"mu": torch.sort(m.samples["mu"], -1)[0].cpu()})["mu"]
    gap = ((sg["mean"] - sm["mean"]).abs()
           / torch.sqrt(sg["mcse"] ** 2 + sm["mcse"] ** 2))
    rhat = max(float(sg["rhat"].max()), float(sm["rhat"].max()))
    z = g.samples["z"]
    acc = float(g.extra["accept_prob"].float().mean())
    if float(gap.max()) > 5.0 or rhat >= 1.01:
        raise AssertionError(f"phase 30(b): Gibbs vs marginal NUTS sorted "
                             f"means {gap.tolist()} MCSE (<= 5), max "
                             f"split-R-hat {rhat:.4f} (< 1.01)")
    return (f"30(b) DiscreteGibbs at N {n}, {chains} chains, {warm}+{keep}: "
            f"sorted means {[round(float(v), 4) for v in sg['mean']]} "
            f"against marginal NUTS's "
            f"{[round(float(v), 4) for v in sm['mean']]}, "
            f"{float(gap.max()):.2f} MCSE apart (<= 5), max split-R-hat "
            f"{rhat:.4f} (< 1.01), z {tuple(z.shape)} {z.dtype}, mean accept "
            f"{acc:.3f}; {chains * (warm + keep) / wall_g:.1f} chain-"
            f"transitions/s Gibbs ({wall_g:.1f} s), "
            f"{chains * (warm + keep) / wall_m:.1f} marginal NUTS "
            f"({wall_m:.1f} s)")


def _p30_logistic_data(torch, np, dev, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_true = np.linspace(1.0, -1.0, d).astype(np.float32)
    p = 1 / (1 + np.exp(-x @ w_true))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            w_true)


def _p30_logistic(core, dist, x, y):
    """The whitened logistic regression of tests/test_ess_sampler.py:48."""
    def model():
        w = core.sample("w", dist.Normal(0.0, 1.0).expand((x.shape[1],))
                        .to_event(1))
        core.sample("obs", dist.Bernoulli(logits=x @ w).to_event(1), obs=y)
    return model


def _p30_ess(torch, np, dev, core, dist, diag, sizes):
    """30(c): EllipticalSlice against the port's NUTS on the whitened
    logistic regression."""
    from bayesic_tpu_torch.infer.mcmc import MCMC, EllipticalSlice

    x, y, _ = _p30_logistic_data(torch, np, dev, sizes["n"], sizes["d"], 1)
    model = _p30_logistic(core, dist, x, y)
    chains, burn, keep = sizes["chains"], sizes["burnin"], sizes["samples"]
    t = time.perf_counter()
    es = EllipticalSlice(model, num_samples=keep, num_burnin=burn,
                         num_chains=chains, device=dev).run(32)
    _p30_sync(torch, dev)
    wall_e = time.perf_counter() - t
    t = time.perf_counter()
    nu = MCMC(model=model, num_warmup=sizes["nuts"], num_samples=sizes["nuts"],
              num_chains=chains, device=dev).run(33)
    _p30_sync(torch, dev)
    wall_n = time.perf_counter() - t
    se = diag.summary({"w": es.samples["w"].cpu()})["w"]
    sn = diag.summary({"w": nu.samples["w"].cpu()})["w"]
    mean_gap = ((se["mean"] - sn["mean"]).abs()
                / torch.sqrt(se["mcse"] ** 2 + sn["mcse"] ** 2))
    # the sd's Monte-Carlo error, sd / sqrt(2 ESS)
    sd_gap = ((se["std"] - sn["std"]).abs() / torch.sqrt(
        se["std"] ** 2 / (2 * se["ess"]) + sn["std"] ** 2 / (2 * sn["ess"])))
    iters = es.extra["shrink_iters"].float()
    # the loop runs until the slowest chain accepts: one host read of the
    # done mask an iteration
    syncs = torch.clamp(iters.max(0).values + 1, max=30).mean()
    if float(mean_gap.max()) > 5.0 or float(sd_gap.max()) > 5.0:
        raise AssertionError(f"phase 30(c): ESS vs NUTS means "
                             f"{float(mean_gap.max()):.2f}, sds "
                             f"{float(sd_gap.max()):.2f} MCSE (<= 5)")
    return (f"30(c) EllipticalSlice at N {sizes['n']}, D {sizes['d']}, "
            f"{chains} chains, {burn}+{keep}: means and sds within "
            f"{float(mean_gap.max()):.2f} / {float(sd_gap.max()):.2f} MCSE of "
            f"NUTS ({sizes['nuts']}+{sizes['nuts']}) (<= 5), min ESS "
            f"{float(se['ess'].min()):.0f} (NUTS {float(sn['ess'].min()):.0f}),"
            f" shrink iterations {float(iters.mean()):.2f} a transition (max "
            f"{int(iters.max())}), {float(syncs):.2f} loop iterations and host "
            f"syncs a transition (of 30); "
            f"{chains * (burn + keep) / wall_e:.1f} "
            f"chain-transitions/s ({wall_e:.1f} s, "
            f"{(burn + keep) / wall_e:.1f} transitions/s, each with "
            f"shrink-loop host syncs), NUTS "
            f"{2 * chains * sizes['nuts'] / wall_n:.1f} ({wall_n:.1f} s)")


def _p30_pt(torch, np, dev, core, dist, sizes):
    """30(d): ParallelTempering on tests/test_tempering.py:69's bimodal
    target and :115's Beta-Bernoulli evidence."""
    from bayesic_tpu_torch.infer.mcmc import (ParallelTempering,
                                              geometric_ladder)

    def bimodal():
        q = core.sample("q", dist.Normal(0.0, 10.0))
        lp = torch.logaddexp(dist.Normal(-4.0, 0.5).log_prob(q),
                             dist.Normal(4.0, 0.5).log_prob(q))
        core.factor("modes", lp)

    b = sizes["bimodal"]
    t = time.perf_counter()
    res = ParallelTempering(bimodal, num_replicas=b["replicas"],
                            beta_min=0.01, num_warmup=b["warmup"],
                            num_samples=b["samples"], num_chains=b["chains"],
                            num_leapfrog=b["leapfrog"], init_step_size=0.3,
                            device=dev).run(34)
    _p30_sync(torch, dev)
    wall_b = time.perf_counter() - t
    q = res.samples["q"].cpu().numpy()
    frac = float((q > 0).mean())
    per_chain = (q > 0).mean(axis=1)
    hop = float((np.minimum(per_chain, 1 - per_chain) > 0.05).mean())
    if not 0.30 < frac < 0.70 or hop <= 0.6:
        raise AssertionError(f"phase 30(d): bimodal mass {frac:.3f} (0.3 - "
                             f"0.7), chains hopping {hop:.3f} (> 0.6)")
    e = sizes["evidence"]
    heads, trials = 37, 50
    yb = torch.cat([torch.ones(heads, device=dev),
                    torch.zeros(trials - heads, device=dev)])

    def coin():
        p = core.sample("p", dist.Beta(1.0, 1.0))
        core.sample("obs", dist.Bernoulli(p).expand((trials,)).to_event(1),
                    obs=yb)

    betas = torch.cat([geometric_ladder(e["rungs"], 0.01, dev),
                       torch.zeros(1, device=dev)])
    t = time.perf_counter()
    ev = ParallelTempering(coin, betas=betas, num_warmup=e["warmup"],
                           num_samples=e["samples"], num_chains=e["chains"],
                           num_leapfrog=e["leapfrog"], device=dev).run(35)
    _p30_sync(torch, dev)
    wall_e = time.perf_counter() - t
    # Bernoulli sequence: Z = B(heads + 1, trials - heads + 1)
    ref = (math.lgamma(heads + 1) + math.lgamma(trials - heads + 1)
           - math.lgamma(trials + 2))
    ss, ti = (float(ev.extra["log_evidence_ss"]),
              float(ev.extra["log_evidence_ti"]))
    if abs(ss - ref) >= 0.1 or abs(ti - ref) >= 0.3:
        raise AssertionError(f"phase 30(d): evidence SS {ss:.4f} / TI "
                             f"{ti:.4f} against {ref:.4f} (0.1 / 0.3)")
    sw = [round(float(v), 3) for v in res.extra["swap_accept"]]
    steps_b = b["warmup"] + b["samples"]
    steps_e = e["warmup"] + e["samples"]
    return (f"30(d) ParallelTempering: bimodal ({b['replicas']} rungs, "
            f"{b['chains']} chains, {b['warmup']}+{b['samples']}) mass "
            f"{frac:.3f} at q > 0 (0.3 - 0.7), {hop:.3f} of chains hop "
            f"(> 0.6), swap rates {sw}; Beta-Bernoulli ({e['rungs'] + 1} "
            f"rungs, {e['chains']} chains, {e['warmup']}+{e['samples']}) log Z "
            f"SS {ss:.4f}, TI {ti:.4f} against {ref:.4f} (0.1 / 0.3); "
            f"{steps_b / wall_b:.1f} / {steps_e / wall_e:.1f} steps/s "
            f"({wall_b:.1f} / {wall_e:.1f} s; a step = every rung of every "
            f"chain, L + 1 gradient evaluations)")


def _p30_regression(torch, np, dev, core, dist, rows, dim, batch=None):
    """A logistic regression at ``rows`` x ``dim`` (prior N(0, 1)); with
    ``batch``, its likelihood on a subsampled plate of that size."""
    x, y, _ = _p30_logistic_data(torch, np, dev, rows, dim, 5)

    def model():
        w = core.sample("w", dist.Normal(0.0, 1.0).expand((dim,))
                        .to_event(1))
        with core.plate("data", rows, subsample_size=batch) as idx:
            core.sample("obs", dist.Bernoulli(logits=x[idx] @ w), obs=y[idx])
    return model, x, y


def _p30_map(torch, np, dev, core, dist, sizes):
    """30(f): map_estimate and Laplace on the 100,000 x 16 regression (the
    cov against the float64 inverse Hessian by autograd on the CPU), and
    Laplace exact on tests/test_laplace.py:49's linear-Gaussian model.
    Returns the line and the mode and sds (e)'s gate reads."""
    from bayesic_tpu_torch.infer import Laplace, map_estimate
    from bayesic_tpu_torch.infer.svi import Adam, cosine_decay_schedule

    rows, dim, steps = sizes["rows"], sizes["dim"], sizes["steps"]
    model, x, y = _p30_regression(torch, np, dev, core, dist, rows, dim)
    init = {"w": torch.zeros(dim, device=dev)}
    opt = lambda: Adam(cosine_decay_schedule(sizes["lr"], steps))  # noqa
    t = time.perf_counter()
    lap = Laplace(model, device=dev).fit(optimizer=opt(), num_steps=steps,
                                         init=init)
    _p30_sync(torch, dev)
    wall = time.perf_counter() - t
    _, ld, _, _ = core.build_logjoint(model, rng_key=torch.Generator(
        device=dev).manual_seed(0))

    def gnorm(w):
        return float(torch.linalg.vector_norm(torch.func.grad(
            lambda ww: ld({"w": ww}))(w)))
    ratio = gnorm(lap.mean) / gnorm(init["w"])
    # the float64 Hessian at the card's mode, by autograd on the CPU
    x64, y64 = x.double().cpu(), y.double().cpu()

    def pot64(w):
        logits = x64 @ w
        return -(torch.sum(y64 * logits - torch.nn.functional.softplus(
            logits)) - 0.5 * torch.sum(w * w))
    h64 = torch.func.hessian(pot64)(lap.mean.double().cpu())
    cov64 = torch.linalg.inv(h64)
    cov_err = float((lap.cov.double().cpu() - cov64).abs().max()
                    / cov64.abs().max())
    if ratio > sizes["grad_ratio"] or cov_err > sizes["cov_rtol"]:
        raise AssertionError(f"phase 30(f): gradient norm at the mode "
                             f"{ratio:.2e} of the start (<= "
                             f"{sizes['grad_ratio']:g}), cov rel err "
                             f"{cov_err:.2e} (<= {sizes['cov_rtol']:g})")
    # Laplace exact on the linear-Gaussian model (float64 closed form)
    sigma, prior_sd = 0.5, 2.0
    rng = np.random.default_rng(1)
    xl = rng.normal(0.0, 1.0, 40).astype(np.float32) + 0.5
    yl = (1.2 * xl - 0.4 + rng.normal(0, sigma, 40)).astype(np.float32)
    xt, yt = (torch.as_tensor(a, device=dev) for a in (xl, yl))

    def lin():
        w = core.sample("w", dist.Normal(0.0, prior_sd))
        b = core.sample("b", dist.Normal(0.0, prior_sd))
        core.sample("obs", dist.Normal(w * xt + b, sigma).to_event(1),
                    obs=yt)
    xm = np.stack([np.ones_like(xl), xl], 1).astype(np.float64)
    cov_l = np.linalg.inv(xm.T @ xm / sigma ** 2 + np.eye(2) / prior_sd ** 2)
    mean_l = cov_l @ (xm.T @ yl.astype(np.float64)) / sigma ** 2
    from scipy import stats as st
    log_z = st.multivariate_normal.logpdf(
        yl.astype(np.float64), np.zeros(40),
        sigma ** 2 * np.eye(40) + prior_sd ** 2 * (xm @ xm.T))
    lap_l = Laplace(lin, device=dev).fit(num_steps=3000)
    m_err = float(np.abs(lap_l.mean.cpu().numpy() - mean_l).max())
    c_err = float(np.abs(lap_l.cov.cpu().numpy() - cov_l).max()
                  / np.abs(cov_l).max())
    z_err = abs(lap_l.log_evidence - log_z)
    if m_err > 5e-3 or c_err > 0.02 or z_err > 0.02:
        raise AssertionError(f"phase 30(f): linear-Gaussian Laplace mean "
                             f"{m_err:.2e} (<= 5e-3), cov {c_err:.2e} (<= "
                             f"0.02), log Z {z_err:.2e} (<= 0.02)")
    mode = lap.mean
    sds = torch.sqrt(torch.diagonal(lap.cov))
    line = (f"30(f) MAP/Laplace at {rows} x {dim}: {steps} Adam steps "
            f"(cosine from {sizes['lr']:g}) in {wall:.1f} s "
            f"({steps / wall:.1f} steps/s, the Hessian included), gradient "
            f"norm at the mode {ratio:.2e} of the start (<= "
            f"{sizes['grad_ratio']:g}), cov rel err {cov_err:.2e} against "
            f"the float64 inverse Hessian (<= {sizes['cov_rtol']:g}); "
            f"linear-Gaussian exact: mean {m_err:.1e}, cov {c_err:.1e}, log Z "
            f"{z_err:.1e} (5e-3 / 0.02 / 0.02)")
    return line, mode, sds


def _p30_sg(torch, np, dev, core, dist, sizes, mode, sds):
    """30(e): the three SG-MCMC updates on tests/test_sgmcmc.py:38's
    conjugate model at its sizes and tolerances, and sgld on the 100,000 x
    16 regression with a subsampled plate, against (f)'s mode and sds."""
    from bayesic_tpu_torch.infer import SGMCMC

    c = sizes["conj"]
    rng = np.random.default_rng(0)
    xc = torch.as_tensor(rng.normal(0.7, 1.0, 256).astype(np.float32),
                         device=dev)
    post_var = 1.0 / (1.0 / 4.0 + 256.0)
    post_mean = post_var * float(xc.sum())

    def conj(x):
        mu = core.sample("mu", dist.Normal(0.0, 2.0))
        with core.plate("data", x.shape[0], subsample_size=64) as idx:
            core.sample("obs", dist.Normal(mu, 1.0), obs=x[idx])

    parts, t_conj = [], time.perf_counter()
    for method, step in (("sgld", 2e-4), ("psgld", 1e-2), ("sghmc", 5e-5)):
        r = SGMCMC(conj, method=method, step_size=step,
                   num_chains=c["chains"], num_burnin=c["burnin"],
                   num_samples=c["samples"], model_args=(xc,),
                   device=dev).run(36)
        d = r.samples["mu"].reshape(-1).cpu().numpy()
        sd = np.sqrt(post_var)
        if not (np.isfinite(d).all() and abs(d.mean() - post_mean) < 6 * sd
                and 0.3 * sd < d.std() < 6 * sd):
            raise AssertionError(f"phase 30(e): {method} mean "
                                 f"{d.mean():.4f} (want {post_mean:.4f} "
                                 f"+- {6 * sd:.4f}), sd {d.std():.4f}")
        parts.append(f"{method} {(d.mean() - post_mean) / sd:+.2f} sd, sd "
                     f"x{d.std() / sd:.2f}")
    _p30_sync(torch, dev)
    t_conj = time.perf_counter() - t_conj
    g = sizes["logit"]
    model, _, _ = _p30_regression(torch, np, dev, core, dist, g["rows"],
                                  g["dim"], g["batch"])
    t = time.perf_counter()
    r = SGMCMC(model, method="sgld", step_size=g["step"],
               num_chains=g["chains"], num_burnin=g["burnin"],
               num_samples=g["samples"], device=dev).run(37)
    _p30_sync(torch, dev)
    wall = time.perf_counter() - t
    w = r.samples["w"].reshape(-1, g["dim"])
    gap = ((w.mean(0) - mode).abs() / sds).max()
    if not float(gap) <= P30_SGLD_SDS:
        raise AssertionError(f"phase 30(e): sgld means {float(gap):.3f} "
                             f"Laplace sds from the mode (<= "
                             f"{P30_SGLD_SDS})")
    steps = g["burnin"] + g["samples"]
    return (f"30(e) SG-MCMC: conjugate ({c['chains']} chains, "
            f"{c['burnin']}+{c['samples']}) " + "; ".join(parts)
            + f" (6 sd; 0.3 - 6 sd) in {t_conj:.1f} s; sgld at "
            f"{g['rows']} x {g['dim']}, batch {g['batch']}, {g['chains']} "
            f"chains, {g['burnin']}+{g['samples']}: means within "
            f"{float(gap):.3f} Laplace sds of the mode (<= {P30_SGLD_SDS}), "
            f"sd x{float((w.std(0) / sds).mean()):.2f} of Laplace's; "
            f"{steps / wall:.1f} steps/s ({wall:.1f} s)")


def _p30_svgd(torch, np, dev, core, dist, sizes):
    """30(g): SVGD on tests/test_svgd.py:35's correlated Gaussian and :55's
    subsampled plate, at the JAX tests' tolerances."""
    from bayesic_tpu_torch.infer import SVGD
    from bayesic_tpu_torch.infer.svi import Adam

    cov = np.array([[1.0, 0.95], [0.95, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32,
                           device=dev)

    def corr():
        w = core.sample("w", dist.Normal(0.0, 10.0).expand((2,)).to_event(1))
        core.factor("target", -0.5 * w @ prec @ w
                    - dist.Normal(0.0, 10.0).log_prob(w).sum())

    t = time.perf_counter()
    r = SVGD(corr, num_particles=sizes["particles"],
             num_steps=sizes["corr_steps"], optimizer=Adam(5e-2),
             device=dev).run(38)
    _p30_sync(torch, dev)
    wall = time.perf_counter() - t
    w = r.samples["w"].cpu().numpy()
    cc = float(np.corrcoef(w.T)[0, 1])
    sd = float(w.std(0).mean())
    y = torch.as_tensor(np.random.default_rng(2).normal(-0.5, 1.0, 256)
                        .astype(np.float32), device=dev)

    def sub():
        mu = core.sample("mu", dist.Normal(0.0, 2.0))
        with core.plate("data", 256, subsample_size=64) as idx:
            core.sample("obs", dist.Normal(mu, 1.0), obs=y[idx])
    rs = SVGD(sub, num_particles=64, num_steps=sizes["sub_steps"],
              optimizer=Adam(3e-2), device=dev).run(39)
    gap = abs(float(rs.samples["mu"].mean()) - float(y.mean()))
    if abs(cc - 0.95) >= 0.1 or abs(sd - 1.0) >= 0.35 or gap >= 0.1 \
            or not bool(torch.isfinite(rs.extra["phi_norm"]).all()):
        raise AssertionError(f"phase 30(g): SVGD corr {cc:.3f} (0.95 +- "
                             f"0.1), sd {sd:.3f} (1 +- 0.35), subsampled "
                             f"mean gap {gap:.3f} (< 0.1)")
    return (f"30(g) SVGD: correlated Gaussian at {sizes['particles']} "
            f"particles, {sizes['corr_steps']} steps: corr {cc:.3f} (0.95 +- "
            f"0.1), sd {sd:.3f} (1 +- 0.35), {sizes['corr_steps'] / wall:.1f}"
            f" steps/s; subsampled plate (64 particles, {sizes['sub_steps']} "
            f"steps) mean {gap:.4f} from ybar (< 0.1)")


def _p30_kernels(torch, np, dev, sizes):
    """30(h): MCMC.warmup_and_sample on the two fused NUTS paths (rows 3
    and 4) against run on the same seed, bit for bit, with each kernel's
    launches."""
    from bayesic_tpu_torch.models import dlgm
    from bayesic_tpu_torch.models import hier_logistic as hl
    from bayesic_tpu_torch.ops import _build
    from bayesic_tpu_torch.ops import fused_nuts as fn
    from bayesic_tpu_torch.ops import fused_nuts_hier as fnh

    if dev.type == "cuda":
        _build.load()
    warm, keep = sizes["warmup"], sizes["samples"]
    out = {}
    # row 4: the hier posterior at phase 15's shapes
    cfg = hl.Config(device=str(dev))
    xn, yn, gn, _ = hl.make_data(cfg)
    x, y, group = (torch.as_tensor(a, device=dev) for a in (xn, yn, gn))

    def hier():
        return hl.fused_nuts_mcmc(cfg.num_groups, cfg.num_features, x, y,
                                  group, num_warmup=warm, num_samples=keep,
                                  num_chains=HIER_CHAINS, target_accept=0.85,
                                  max_doublings=HIER_K)
    # row 3: the DLGM local posterior at phase 10's shapes, random decoder
    ncfg = dlgm.Config(**NUTS_SVI, num_chains=NUTS_CHAINS, num_warmup=warm,
                       num_samples=keep, seed=0, device=str(dev))
    dec = dlgm.Decoder(ncfg.latent_dim, ncfg.hidden, ncfg.data_dim,
                       torch.Generator().manual_seed(0)).to(dev)
    dparams = {k: p.detach() for k, p in dec.named_parameters()}
    xb = torch.as_tensor(dlgm.make_data(ncfg)[:NUTS_ROWS], device=dev)

    def local():
        return dlgm.local_posterior_mcmc_fused(ncfg, dec, dparams, 0.3, xb,
                                               max_doublings=NUTS_K)
    for name, make, mod in (("fused_nuts_hier", hier, fnh),
                            ("fused_nuts", local, fn)):
        mod.LAUNCHES = 0
        t = time.perf_counter()
        raw = make().warmup_and_sample(40)()
        _p30_sync(torch, dev)
        wall = time.perf_counter() - t
        launches = mod.LAUNCHES
        res = make().run(40)
        same = torch.equal(raw[0].transpose(0, 1), res.unconstrained) and all(
            torch.equal(a.transpose(0, 1), res.extra[k]) for a, k in zip(
                raw[1:5], ("diverging", "accept_prob", "tree_depth",
                           "num_steps"))) \
            and torch.equal(raw[5], res.extra["step_size"]) \
            and torch.equal(raw[6], res.extra["inv_mass"])
        if not same or launches < warm + keep:
            raise AssertionError(f"phase 30(h): {name} warmup_and_sample "
                                 f"equal to run: {same}, launches "
                                 f"{launches} (>= {warm + keep})")
        out[name] = (launches, wall)
    return "30(h) MCMC.warmup_and_sample = run bit for bit at " + \
        f"{warm}+{keep}: " + "; ".join(
            f"{k} {v[0]} launches, {(warm + keep) / v[1]:.1f} transitions/s"
            for k, v in out.items()), out


def _p30_sharded(torch, np, dev, core, dist, sizes):
    """30(i): EllipticalSlice, ParallelTempering and SGMCMC with
    chain_sharding at world size 1 (NCCL on a card), each against its
    unsharded run bit for bit."""
    import datetime
    import tempfile

    import torch.distributed as tdist

    from bayesic_tpu_torch.infer import SGMCMC
    from bayesic_tpu_torch.infer.mcmc import (EllipticalSlice,
                                              ParallelTempering)
    from bayesic_tpu_torch.parallel import make_mesh
    from bayesic_tpu_torch.parallel.mesh import shard_leading

    x, y, _ = _p30_logistic_data(torch, np, dev, sizes["n"], sizes["d"], 7)
    model = _p30_logistic(core, dist, x, y)
    reg, _, _ = _p30_regression(torch, np, dev, core, dist, sizes["n"],
                                sizes["d"], sizes["batch"])
    c, s = sizes["chains"], sizes["steps"]
    runs = {
        "EllipticalSlice": lambda sh: EllipticalSlice(
            model, num_samples=s, num_burnin=s, num_chains=c,
            chain_sharding=sh, device=dev).run(41),
        "ParallelTempering": lambda sh: ParallelTempering(
            model, num_replicas=4, num_warmup=s, num_samples=s,
            num_chains=c, num_leapfrog=4, chain_sharding=sh,
            device=dev).run(42),
        "SGMCMC": lambda sh: SGMCMC(
            reg, method="sghmc", step_size=1e-6, num_burnin=s,
            num_samples=s, num_chains=c, chain_sharding=sh,
            device=dev).run(43)}
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        try:
            chain = shard_leading(make_mesh({"chain": 1}), "chain")
            for name, run in runs.items():
                a, b = run(None), run(chain)
                same = torch.equal(a.unconstrained, b.unconstrained) and \
                    torch.equal(b.chains, torch.arange(c, device=dev))
                if name == "ParallelTempering":
                    same = same and all(torch.equal(a.extra[k], b.extra[k])
                                        for k in ("swap_accept",
                                                  "log_evidence_ss"))
                if not same:
                    raise AssertionError(f"phase 30(i): sharded {name} "
                                         f"differs from its unsharded run")
                out.append(name)
        finally:
            tdist.destroy_process_group()
    return (f"30(i) chain_sharding at world size 1 "
            f"({'NCCL' if dev.type == 'cuda' else 'gloo'}), {c} chains, "
            f"{s}+{s}: " + ", ".join(out) + " = unsharded bit for bit")


def _phase30_child(which, device, sizes):
    """One phase-30 run group (``_breadth_child``'s ``p30_*`` names):
    returns (line, text)."""
    import numpy as np
    import torch

    import bayesic_tpu_torch.core as core
    import bayesic_tpu_torch.dist as dist
    from bayesic_tpu_torch.utils import diagnostics as diag

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    # yield the host's cores to phase 28(c)'s runs beside this one: their
    # 8-schools run sets the phase's wall
    os.nice(P30_NICE)
    t = time.perf_counter()
    if which == "p30_enum":
        lines = [_p30_enum(torch, np, dev, core, dist, sizes["enum"]),
                 _p30_svgd(torch, np, dev, core, dist, sizes["svgd"])]
    elif which == "p30_gibbs":
        lines = [_p30_gibbs(torch, np, dev, core, dist, diag,
                            sizes["gibbs"])]
    elif which == "p30_ess":
        lines = [_p30_ess(torch, np, dev, core, dist, diag, sizes["ess"])]
    elif which == "p30_pt":
        lines = [_p30_pt(torch, np, dev, core, dist, sizes["pt"])]
    elif which == "p30_sg_map":
        line_f, mode, sds = _p30_map(torch, np, dev, core, dist,
                                     sizes["map"])
        lines = [_p30_sg(torch, np, dev, core, dist, sizes["sg"], mode, sds),
                 line_f]
    else:
        line_h, counts = _p30_kernels(torch, np, dev, sizes["kernels"])
        lines = [line_h, _p30_sharded(torch, np, dev, core, dist,
                                      sizes["sharded"])]
        return (f"{which} {time.perf_counter() - t:.1f} s",
                {"lines": lines, "launches": {k: v[0] for k, v in
                                              counts.items()}})
    return (f"{which} {time.perf_counter() - t:.1f} s", {"lines": lines})


def _phase30_report(card, results, wall):
    """Print phase 30's lines from its children's results."""
    for which in P30_RUNS:
        for line in results[which]["text"]["lines"]:
            print(f"phase {line} [{card}]", flush=True)
    launches = results["p30_kernels"]["text"]["launches"]
    print(f"phase 30 ok [{card}]: the kernels' launches under "
          f"warmup_and_sample: " + ", ".join(
              f"{k} {v}" for k, v in launches.items())
          + "; each group's wall: "
          + ", ".join(results[w]["line"] for w in P30_RUNS)
          + f" (the groups in processes of their own beside phase 28(c)'s; "
          f"{wall:.1f} s from their start to the last result)", flush=True)


# ---------------------------------------------------------------------------
# phase 31: the state-space families, the GP, STS and SVGP models and
# pathfinder (no kernel: torch.linalg and the generic engines on the card,
# each group in a _breadth_child process of its own beside phase 28(c)'s)
# ---------------------------------------------------------------------------

def _p31_lgss_outputs(torch, dist, sts, cfg, x, scales, device, dtype,
                      method):
    """log_prob, filter, smooth and d log_prob / d (m0, F, Q, R) of the STS
    system at ``scales`` on ``device`` in ``dtype``."""
    sc = [torch.tensor(s, dtype=dtype, device=device) for s in scales]
    lg0 = sts.make_lgss(dataclasses.replace(cfg, device=str(device)), *sc)
    leaves = [a.detach().clone().requires_grad_(True) for a in (
        lg0.initial_mean, lg0.transition_matrix, lg0.transition_cov,
        lg0.observation_cov)]
    lg = dist.LinearGaussianStateSpace(
        leaves[0], lg0.initial_cov, leaves[1], leaves[2],
        lg0.observation_matrix, leaves[3], cfg.t_len, method=method)
    xx = x.to(device=device, dtype=dtype)
    lp = lg.log_prob(xx)
    grads = torch.autograd.grad(lp, leaves)
    with torch.no_grad():
        fm, fp = lg.filter(xx)
        sm, sp = lg.smooth(xx)
    out = dict(log_prob=lp.detach(), filter_mean=fm, filter_cov=fp,
               smooth_mean=sm, smooth_cov=sp)
    out.update(zip(("grad_m0", "grad_F", "grad_Q", "grad_R"), grads))
    return {k: v.detach().cpu().double() for k, v in out.items()}


def _p31_lgss(torch, np, dev, dist, sizes):
    """31(a): the LGSS filter, smoother, log_prob and its gradient at STS's
    system (D 8) on the card against the CPU in float64, both methods; the
    float32 the NUTS path runs, held looser; then ms and launches a
    log_prob, parallel against sequential."""
    from bayesic_tpu_torch.models import sts

    cfg = sts.Config(t_len=sizes["t"], device="cpu")
    x = sts.make_data(cfg)                            # CPU, seed 0
    scales = (cfg.sigma_level, cfg.sigma_slope, cfg.sigma_seas,
              cfg.sigma_obs)
    worst = {}
    for method in ("parallel", "sequential"):
        ref = _p31_lgss_outputs(torch, dist, sts, cfg, x, scales,
                                torch.device("cpu"), torch.float64, method)
        for dtype, limit in ((torch.float64, P31_LGSS_RTOL[0]),
                             (torch.float32, P31_LGSS_RTOL[1])):
            got = _p31_lgss_outputs(torch, dist, sts, cfg, x, scales, dev,
                                    dtype, method)
            rel = {k: float((got[k] - ref[k]).abs().max()
                            / ref[k].abs().max()) for k in ref}
            key = f"{method} {str(dtype)[6:]}"
            worst[key] = max(rel.items(), key=lambda kv: kv[1])
            if not worst[key][1] <= limit:
                raise AssertionError(f"phase 31(a): {key} {rel} > {limit}")
    # ms and launches a log_prob (float32, no gradient), and a potential
    # and gradient of the STS model as NUTS evaluates it at 4 chains
    timing = []
    for t_len in sizes["timed_t"]:
        tcfg = sts.Config(t_len=t_len, device=str(dev))
        xt = sts.make_data(tcfg)
        for method in ("parallel", "sequential"):
            lg = sts.make_lgss(tcfg, *scales)
            lg.method = method

            def fn(lg=lg, xt=xt):
                with torch.no_grad():
                    return lg.log_prob(xt)

            if t_len > 1000 and method == "sequential":
                # ~370,000 launches: one call, timed under the device-only
                # profiler (its kernels are warm from T 256's calls)
                box = {}

                def timed(fn=fn):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    box["ms"] = 1e3 * (time.perf_counter() - t0)

                trace = _trace(torch, timed, 1, unit="log_prob", host=False)
                timing.append(f"T {t_len} {method} {_num(box['ms'])} ms "
                              f"(under the profiler), {trace}")
                continue
            fn()
            ms, _ = _cuda_ms(torch, fn, 5)
            timing.append(f"T {t_len} {method} {_num(ms)} ms, "
                          + _trace(torch, fn, 1, unit="log_prob"))
    from bayesic_tpu_torch.infer.mcmc.mcmc import flat_model

    ncfg = sts.Config(t_len=sizes["t"], device=str(dev))
    fm = flat_model(sts.make_model(sts.make_data(ncfg), ncfg), device=dev)
    vg = torch.func.vmap(torch.func.grad_and_value(
        lambda q: -fm.logdensity(fm.unravel(q))))
    q = torch.full((4, fm.dim), -2.0, device=dev)
    vg(q)
    ms_vg, _ = _cuda_ms(torch, lambda: vg(q), 3)
    trace_vg = _trace(torch, lambda: vg(q), 1, unit="evaluation")
    return (f"31(a) LinearGaussianStateSpace at STS's system (D 8, T "
            f"{sizes['t']}): card = CPU float64, the largest relative error "
            f"of log_prob, filter, smooth and the gradient w.r.t. m0, F, Q, "
            f"R: " + ", ".join(f"{k} {v[1]:.3g} ({v[0]})"
                              for k, v in worst.items())
            + f" (float64 <= {P31_LGSS_RTOL[0]:g}, float32 <= "
            f"{P31_LGSS_RTOL[1]:g}); a float32 log_prob: "
            + "; ".join(timing)
            + f"; the STS potential and gradient at 4 chains (vmap, T "
            f"{sizes['t']}, parallel): {_num(ms_vg)} ms, {trace_vg}")


def _p31_hmm(torch, np, dev, dist, core, sizes):
    """31(b): tests/test_hmm.py:106's NUTS: the emission locs of 40
    independent two-state chains of length 12."""
    from bayesic_tpu_torch.infer.mcmc import MCMC

    init = torch.log(torch.tensor([0.5, 0.5], device=dev))
    trans = torch.log(torch.tensor([[0.9, 0.1], [0.1, 0.9]], device=dev))
    true = torch.tensor([-1.5, 1.5], device=dev)
    n, t_len = sizes["series"], sizes["t"]
    gen = dist.HiddenMarkovModel(init, trans, dist.Normal(true, 0.5), t_len)
    data = gen.sample(torch.Generator(device=dev).manual_seed(9), (n,))

    def model():
        locs = core.sample("locs", dist.Normal(0.0, 3.0).expand((2,))
                           .to_event(1))
        hmm = dist.HiddenMarkovModel(init, trans, dist.Normal(locs, 0.5),
                                     t_len)
        core.sample("obs", hmm.expand((n,)).to_event(1), obs=data)

    c, w, s = sizes["chains"], sizes["warmup"], sizes["samples"]
    t = time.perf_counter()
    r = MCMC(model=model, num_warmup=w, num_samples=s, num_chains=c,
             device=dev).run(10)
    _p30_sync(torch, dev)
    wall = time.perf_counter() - t
    # symmetric dynamics: label switching, so sort each draw
    locs = torch.sort(r.samples["locs"].reshape(-1, 2), -1).values.mean(0)
    gap = float((locs.cpu() - torch.tensor([-1.5, 1.5])).abs().max())
    if not gap < 0.25:
        raise AssertionError(f"phase 31(b): sorted locs {locs.tolist()} "
                             f"(within 0.25 of -1.5, 1.5)")
    leaves = float(r.extra["num_steps"].float().mean())
    return (f"31(b) HiddenMarkovModel under NUTS ({n} series x T {t_len}, "
            f"{c} chains, {w}+{s}): sorted locs "
            f"{[round(v, 3) for v in locs.tolist()]}, {gap:.3f} from the "
            f"truth (< 0.25); {(w + s) / wall:.1f} transitions/s ({wall:.1f} "
            f"s; {leaves:.2f} leapfrog steps a chain-transition, the forward "
            f"pass a loop of {t_len} steps a potential evaluation)")


def _p31_sts_oracle(np, lg, cfg):
    """tests/test_sts.py:60's dense joint-Gaussian forecast of the
    observations after T given x_0..T-1: (mean, std) as functions of x."""
    t_all = cfg.t_len + cfg.horizon
    f, q, h, r, p0 = (a.detach().cpu().double().numpy() for a in (
        lg.transition_matrix, lg.transition_cov, lg.observation_matrix,
        lg.observation_cov, lg.initial_cov))
    d = f.shape[0]
    covs = [p0]
    for _ in range(1, t_all):
        covs.append(f @ covs[-1] @ f.T + q)
    pz = np.zeros((t_all, d, t_all, d))
    for t in range(t_all):
        for s in range(t_all):
            if t <= s:
                pz[t, :, s, :] = covs[t] @ np.linalg.matrix_power(f, s - t).T
            else:
                pz[t, :, s, :] = np.linalg.matrix_power(f, t - s) @ covs[s]
    hb = np.kron(np.eye(t_all), h)
    cx = hb @ pz.reshape(t_all * d, t_all * d) @ hb.T + np.kron(
        np.eye(t_all), r)
    n = cfg.t_len
    c_oo, c_fo, c_ff = cx[:n, :n], cx[n:, :n], cx[n:, n:]
    cov_f = c_ff - c_fo @ np.linalg.solve(c_oo, c_fo.T)
    return (lambda xv: c_fo @ np.linalg.solve(c_oo, xv)), np.sqrt(
        np.diag(cov_f))


def _p31_sts(torch, np, dev, sizes):
    """31(c): the structural time series at Config() (T 256, season 7, D
    8) by NUTS over its four scales; tests/test_sts.py:116-117's bounds;
    the forecast against the dense oracle (test_sts.py:60)."""
    from bayesic_tpu_torch.models import sts

    cfg = sts.Config(num_warmup=sizes["warmup"],
                     num_samples=sizes["samples"],
                     num_chains=sizes["chains"], seed=sizes["seed"],
                     device=str(dev))
    t = time.perf_counter()
    out = sts.run(cfg)
    _p30_sync(torch, dev)
    wall = time.perf_counter() - t
    post, true = out["posterior_means"], out["true"]
    for name in ("sigma_obs", "sigma_level"):
        if not (true[name] / 4.0 - 0.05 < post[name]
                < 3.2 * true[name] + 0.1):
            raise AssertionError(f"phase 31(c): {name} posterior mean "
                                 f"{post[name]:.4f}, truth {true[name]}")
    ex = out["extra"]
    leaves = float(ex["num_steps"].float().mean())
    deepest = float(ex["num_steps"].float().max(0).values.mean())
    # the forecast on the card (float64) against the dense oracle
    fcfg = sts.Config(t_len=24, season=4, horizon=6, seed=5,
                      device=str(dev))
    scales = [torch.tensor(v, dtype=torch.float64, device=dev) for v in (
        fcfg.sigma_level, fcfg.sigma_slope, fcfg.sigma_seas,
        fcfg.sigma_obs)]
    lg = sts.make_lgss(fcfg, *scales)
    x = lg.sample(torch.Generator(device=dev).manual_seed(1))
    mx, sx = sts.forecast(x, fcfg, *scales)
    mean_fn, std_ref = _p31_sts_oracle(np, lg, fcfg)
    mean_ref = mean_fn(x.cpu().numpy().ravel())
    err = max(float(np.max(np.abs(mx.cpu().numpy() - mean_ref)
                           / (1e-3 * np.abs(mean_ref) + 1e-4))),
              float(np.max(np.abs(sx.cpu().numpy() - std_ref)
                           / (1e-3 * np.abs(std_ref) + 1e-4))))
    if not err <= 1.0:
        raise AssertionError(f"phase 31(c): forecast off the dense oracle "
                             f"by {err:.3f} of rtol 1e-3 / atol 1e-4")
    w, s, c = cfg.num_warmup, cfg.num_samples, cfg.num_chains
    return (f"31(c) structural time series (T {cfg.t_len}, season "
            f"{cfg.season}, D 8, {c} chains, {w}+{s}): posterior means "
            + ", ".join(f"{k} {v:.4f} (truth {true[k]})"
                        for k, v in post.items())
            + f" (sigma_obs, sigma_level within test_sts.py's bands); the "
            f"forecast (T 24, season 4, 6 steps, float64) at {err:.3g} of "
            f"the dense oracle's rtol 1e-3 / atol 1e-4; "
            f"{(w + s) / wall:.2f} NUTS transitions/s ({wall:.1f} s; "
            f"{leaves:.2f} leapfrog steps a chain-transition, the deepest "
            f"chain's {deepest:.2f} a transition, each a parallel-filter "
            f"potential and gradient at T {cfg.t_len})")


def _p31_gp(torch, np, dev, sizes):
    """31(d): the GP at Config() (n 256) by EllipticalSlice;
    tests/test_gp.py:16-18's gates."""
    from bayesic_tpu_torch.models import gp

    cfg = gp.Config(num_samples=sizes["samples"],
                    num_burnin=sizes["burnin"], num_chains=sizes["chains"],
                    device=str(dev))
    t = time.perf_counter()
    out = gp.run(cfg)
    _p30_sync(torch, dev)
    wall = time.perf_counter() - t
    tol = max(0.1, 4 * out["analytic_std"].max() / np.sqrt(200))
    if not out["max_mean_err"] < tol:
        raise AssertionError(f"phase 31(d): max |f mean - exact| "
                             f"{out['max_mean_err']:.4f} (< {tol:.4f})")
    sd_excess = np.abs(out["f_std"] - out["analytic_std"]) / (
        0.25 * out["analytic_std"] + 0.03)
    if not float(sd_excess.max()) <= 1.0:
        raise AssertionError(f"phase 31(d): f sd off the exact one by "
                             f"{float(sd_excess.max()):.3f} of rtol 0.25 / "
                             f"atol 0.03")
    iters = out["result"].extra["shrink_iters"].float()
    steps = cfg.num_burnin + cfg.num_samples
    return (f"31(d) GP regression (n {cfg.n}, {cfg.num_chains} chains, "
            f"{cfg.num_burnin}+{cfg.num_samples}) by EllipticalSlice: max "
            f"|f mean - exact| {out['max_mean_err']:.4f} (< {tol:.4f}), f sd "
            f"at {float(sd_excess.max()):.3f} of rtol 0.25 / atol 0.03, RMSE "
            f"to the truth {out['rmse_truth']:.4f}; {steps / wall:.1f} ESS "
            f"transitions/s ({wall:.1f} s, {float(iters.mean()):.2f} shrink "
            f"iterations a chain-transition)")


def _p31_svgp(torch, np, dev, sizes):
    """31(e): the SVGP by full-rank SVI at tests/test_svgp.py:19's sizes
    (n 256, M 16, full batch, 15,000 steps) against the closed-form
    optimal q and the truth (tests/test_svgp.py:29's gates); at Config()
    (n 4,096, M 32, B 512) the subsampled bound unbiased within 4 SE
    (tests/test_svgp.py:33-54) and the SVI rate.  The JAX package's own
    run_svi at Config() does not converge (on the CPU its loss reaches
    -2.5e23 and rmse_truth 0.47: float32 z = L^-1 (L eps) is exploited by
    the STL gradient), nor does the port's, so the fit is gated at the
    test's sizes."""
    from bayesic_tpu_torch.core.logjoint import build_logjoint
    from bayesic_tpu_torch.models import svgp

    cfg = svgp.Config(n=256, num_inducing=16, batch=256,
                      steps=sizes["steps"], device=str(dev))
    t = time.perf_counter()
    out = svgp.run_svi(cfg)
    _p30_sync(torch, dev)
    wall = time.perf_counter() - t
    mu, sigma = svgp.optimal_q(out["x"], out["y"], cfg, out["project"])
    mean_err = float(np.abs(out["v_mean"] - mu).max())
    cov_err = float(np.abs(out["v_cov"] - sigma).max())
    if not out["rmse_truth"] < 0.1:
        raise AssertionError(f"phase 31(e): rmse_truth "
                             f"{out['rmse_truth']:.4f} (< 0.1)")
    big = svgp.Config(device=str(dev))
    x, y, _ = svgp.make_data(big)
    gen = torch.Generator(device=dev).manual_seed(0)
    model_sub, _, _ = svgp.make_model(x, y, big)
    model_full, _, _ = svgp.make_model(x, y, dataclasses.replace(
        big, batch=big.n))
    _, ld_sub, _, _ = build_logjoint(model_sub, rng_key=gen)
    _, ld_full, _, _ = build_logjoint(model_full, rng_key=gen)
    v = {"v": 0.3 * torch.randn(big.num_inducing, generator=gen,
                                device=dev)}
    full = float(ld_full(v))
    draws = torch.Generator(device=dev).manual_seed(2)
    ests = np.array([float(ld_sub(v, rng_key=draws))
                     for _ in range(sizes["unbiased_draws"])])
    est, se = ests.mean(), ests.std() / np.sqrt(len(ests))
    if not abs(est - full) < 4 * se:
        raise AssertionError(f"phase 31(e): subsampled bound {est:.3f} vs "
                             f"full {full:.3f} (4 SE = {4 * se:.3f})")
    big = dataclasses.replace(big, steps=sizes["config_steps"])
    t = time.perf_counter()
    run = svgp.run_svi(big)
    _p30_sync(torch, dev)
    wall_big = time.perf_counter() - t
    return (f"31(e) SVGP by full-rank SVI at test_svgp.py's sizes (n "
            f"{cfg.n}, M {cfg.num_inducing}, full batch, {cfg.steps} "
            f"steps): rmse_truth {out['rmse_truth']:.4f} (< 0.1); q within "
            f"{mean_err:.4f} / {cov_err:.4f} of the optimal mean / cov (not "
            f"gated: test_svgp.py's 0.05 / 0.03 hold on 3 of 4 JAX keys, the "
            f"mean's slowest mode hangs on the noise path), "
            f"{cfg.steps / wall:.1f} steps/s "
            f"({wall:.1f} s); at Config() (n {big.n}, M {big.num_inducing}, "
            f"B {big.batch}) the subsampled bound {est:.3f} against the full "
            f"{full:.3f} over {len(ests)} mini-batches, "
            f"{abs(est - full) / se:.2f} SE (< 4), and {big.steps} SVI steps "
            f"at {big.steps / wall_big:.1f} steps/s ({wall_big:.1f} s; final "
            f"loss {float(run['losses'][-1]):.4g}, not gated: the reference "
            f"does not converge there either)")


def _p31_pathfinder(torch, np, dev, dist, core, sizes):
    """31(f): pathfinder on tests/test_pathfinder.py:34's Gaussian at its
    gates, and :82's MCMC warm start."""
    from bayesic_tpu_torch.infer import pathfinder as run_pathfinder
    from bayesic_tpu_torch.infer.mcmc import MCMC

    # the module (infer/__init__ exports the function under its name)
    pf = sys.modules["bayesic_tpu_torch.infer.pathfinder"]
    rng = np.random.default_rng(1)
    n = 60
    xn = rng.normal(0.0, 1.0, n).astype(np.float32) + 1.0
    sigma = 0.5
    yn = (1.5 * xn - 0.7 + rng.normal(0, sigma, n)).astype(np.float32)
    xt, yt = torch.tensor(xn, device=dev), torch.tensor(yn, device=dev)

    def model():
        w = core.sample("w", dist.Normal(0.0, 2.0))
        b = core.sample("b", dist.Normal(0.0, 2.0))
        core.sample("obs", dist.Normal(w * xt + b, sigma).to_event(1),
                    obs=yt)

    xd = np.stack([xn, np.ones_like(xn)], 1).astype(np.float64)
    prec = xd.T @ xd / sigma**2 + np.eye(2) / 4.0
    cov = np.linalg.inv(prec)
    mean = cov @ (xd.T @ yn) / sigma**2
    big = xd @ (4.0 * np.eye(2)) @ xd.T + sigma**2 * np.eye(n)
    log_z = float(-0.5 * (np.linalg.slogdet(big)[1] + yn @ np.linalg.solve(
        big, yn) + n * np.log(2 * np.pi)))

    # count the line search's gradient evaluations a path
    counts = []
    zoom = pf.zoom_linesearch

    def counted(*a, **k):
        step, c = zoom(*a, **k)
        counts.append(c)
        return step, c

    pf.zoom_linesearch = counted
    try:
        a = sizes["gaussian"]
        t = time.perf_counter()
        res = run_pathfinder(model, torch.Generator(device=dev).manual_seed(0),
                     num_paths=a["paths"], maxiter=a["maxiter"],
                     num_samples=a["samples"], device=dev)
        _p30_sync(torch, dev)
        wall = time.perf_counter() - t
    finally:
        pf.zoom_linesearch = zoom
    grad_evals = (a["maxiter"] + 1) + torch.stack(counts).sum(0).float()
    got = torch.stack([res.samples["w"], res.samples["b"]], 1).cpu().numpy()
    mean_err = float(np.abs(got.mean(0) - mean).max())
    cov_excess = float(np.max(np.abs(np.cov(got.T) - cov)
                              / (0.25 * np.abs(cov) + 2e-4)))
    elbo_err = float(np.abs(res.elbo.cpu().numpy() - log_z).max())
    if not (mean_err <= 0.03 and cov_excess <= 1.0
            and res.pareto_k < 0.7 and elbo_err <= 0.1):
        raise AssertionError(
            f"phase 31(f): mean {mean_err:.4f} (<= 0.03), cov "
            f"{cov_excess:.3f} of the limit, pareto_k {res.pareto_k:.3f} "
            f"(< 0.7), ELBO {elbo_err:.4f} from log Z (<= 0.1)")
    w = sizes["warm"]
    warm = run_pathfinder(model, torch.Generator(device=dev).manual_seed(2),
                  num_paths=w["paths"], maxiter=w["maxiter"],
                  num_samples=w["samples"], device=dev)
    r = MCMC(model=model, num_warmup=w["warmup"], num_samples=w["keep"],
             num_chains=w["chains"], device=dev,
             init_params=warm.unconstrained[:w["chains"]]).run(3)
    got = torch.stack([r.samples["w"].reshape(-1), r.samples["b"].reshape(
        -1)], 1).cpu().numpy()
    w_mean = float(np.abs(got.mean(0) - mean).max())
    w_cov = float(np.max(np.abs(np.cov(got.T) - cov)
                         / (0.35 * np.abs(cov) + 3e-4)))
    if not (w_mean <= 0.04 and w_cov <= 1.0):
        raise AssertionError(f"phase 31(f): warm-started NUTS mean "
                             f"{w_mean:.4f} (<= 0.04), cov {w_cov:.3f} of "
                             f"the limit")
    return (f"31(f) pathfinder ({a['paths']} paths, maxiter {a['maxiter']}, "
            f"{a['samples']} draws) on the conjugate regression: mean "
            f"{mean_err:.4f} from exact (<= 0.03), cov at {cov_excess:.3f} of "
            f"rtol 0.25 / atol 2e-4, pareto_k {res.pareto_k:.3f} (< 0.7), "
            f"best ELBO {elbo_err:.4f} from log Z (<= 0.1); "
            f"{float(grad_evals.mean()):.1f} gradient evaluations a path "
            f"({a['maxiter'] + 1} iterates + the zoom line search's "
            f"{float(grad_evals.mean()) - a['maxiter'] - 1:.1f}), "
            f"{wall:.2f} s; NUTS from {w['chains']} of {w['samples']} "
            f"pathfinder draws ({w['warmup']}+{w['keep']}): mean {w_mean:.4f} "
            f"(<= 0.04), cov at {w_cov:.3f} of rtol 0.35 / atol 3e-4")


def _phase31_child(which, device, sizes):
    """One phase-31 run group (``_breadth_child``'s ``p31_*`` names):
    returns (line, {"lines": [...]})."""
    import numpy as np
    import torch

    import bayesic_tpu_torch.core as core
    import bayesic_tpu_torch.dist as dist

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    os.nice(P30_NICE)
    t = time.perf_counter()
    if which == "p31_lgss_hmm_pf":
        lines = [_p31_lgss(torch, np, dev, dist, sizes["lgss"]),
                 _p31_hmm(torch, np, dev, dist, core, sizes["hmm"]),
                 _p31_pathfinder(torch, np, dev, dist, core,
                                 sizes["pathfinder"])]
    elif which == "p31_sts":
        lines = [_p31_sts(torch, np, dev, sizes["sts"])]
    else:
        lines = [_p31_gp(torch, np, dev, sizes["gp"]),
                 _p31_svgp(torch, np, dev, sizes["svgp"])]
    return (f"{which} {time.perf_counter() - t:.1f} s", {"lines": lines})


def _phase31_report(card, results, t31):
    """Print phase 31's lines from its children's results (``t31``: when
    the groups started)."""
    for which in P31_RUNS:
        for line in results[which]["text"]["lines"]:
            print(f"phase {line} [{card}]", flush=True)
    print(f"phase 31 ok [{card}]: no kernel of the 11 launches on these "
          f"paths; each group's wall: "
          + ", ".join(results[w]["line"] for w in P31_RUNS)
          + f" (the groups in processes of their own, started before phase "
          f"26, beside phases 26-28; their results read "
          f"{time.perf_counter() - t31:.1f} s after their start)",
          flush=True)


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
    # phase 31's groups start here and run beside phases 26-28: beside
    # phase 28(c)'s and phase 30's processes alone they put the script
    # past its limit (1,209.2 s on an H100, phase 28 369.0 s)
    t31 = time.perf_counter()
    p31 = {w: _spawn_child(w, dev, P31_SIZES) for w in P31_RUNS}
    checks = None
    try:
        _dp_world1_phase(torch, np, card, dev)
        _dp_ranks_phase(torch, np, card, dev)
        # phase 29(c)-(d) runs beside phase 28(c)'s host-bound runs
        checks = _spawn_child("checks", dev, None)
        groups, wall30 = _breadth_phase(torch, np, card, dev, p31)
        records.append(_phase29(torch, np, card, dev, checks))
    finally:
        for proc in list(p31.values()) + [checks]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    # phases 30 and 31 ran in their own processes, all of them done before
    # phase 29 timed anything
    _phase30_report(card, groups, wall30)
    _phase31_report(card, groups, t31)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
