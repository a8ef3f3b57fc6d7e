#!/usr/bin/env python3
"""Time the fused linreg SVI trainer with single design steps undone.

Each variant is ``bayesic_tpu_torch/csrc/fused_linreg.cu`` with a few
textual edits (one lane or four lanes a row of G instead of two; one
consumer warp holding whole rows of G in registers; the accurate exp,
sqrt and division on the step's chain instead of ``ex2``/``sqrt``/``rcp``
``.approx``; four producer warps instead of eight), built alone into its
own library with the port's nvcc flags and launched at the linreg bench
shape (N 16,384, D 64, as ``chip_smoke.py`` phase 22): 200,000 steps from
one warm state, in the middle of the cosine schedule.  The variants are
timed in two rounds, in order and then in reverse, on the same inputs;
each prints its microseconds a step, its registers and spills, and how far
its parameters end from the shipped kernel's.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:
``python3 tools/linreg_ablation.py``.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

STEPS = 200_000

# one lane a row: the float4 chunks of a row (17 at D 64) on one lane,
# so only D + 2 <= 68 fits
KL1 = {"constexpr int KL = 2;": "constexpr int KL = 1;",
       "constexpr int NCMAX = (MAXD2 + 4 * KL - 1) / (4 * KL);":
       "constexpr int NCMAX = 17;"}

# One consumer warp, lane l holding rows l, l + 32 and l + 64 of G whole:
# the shipped consume() with its lane state widened to RPL rows (no probe
# stamps), the barrier a __syncwarp.
_ONE_WARP_CONSUME = r'''template <int NC, bool PROBE>
__device__ void consume(const Args& A, Smem& S, int tid) {
  constexpr int CW = cw_max(NC), RPL = 3;
  const int D2 = A.d + 2, P = A.d + 1;
  const int lane = tid & 31, w = tid >> 5;
  int row[RPL];
  float4 g[RPL][NC];
  float loc[RPL], ls[RPL], m1[RPL], m2[RPL], v1[RPL], v2[RPL], cm[RPL];
  float eps[RPL], els[RPL], emls[RPL];
#pragma unroll
  for (int rr = 0; rr < RPL; ++rr) {
    const int r = (w * RPL + rr) * 32 + lane;
    row[rr] = r;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * n + k;
        e[k] = (r < D2 && c < D2) ? A.g[r * D2 + c] : 0.f;
      }
      g[rr][n] = make_float4(e[0], e[1], e[2], e[3]);
    }
    const bool own = r < P;
    loc[rr] = own ? A.loc[r] : (r == P ? -1.f : 0.f);
    ls[rr] = own ? A.ls[r] : 0.f;
    m1[rr] = own ? A.m1[r] : 0.f;
    m2[rr] = own ? A.m2[r] : 0.f;
    v1[rr] = own ? A.v1[r] : 0.f;
    v2[rr] = own ? A.v2[r] : 0.f;
    cm[rr] = pin(own ? 1.f : 0.f);
  }
  mbar_wait(&S.full[0], 0);
#pragma unroll
  for (int rr = 0; rr < RPL; ++rr) {
    eps[rr] = S.eps[0][row[rr]];
    els[rr] = exp_path(ls[rr]);
    emls[rr] = exp_path(-ls[rr]);
  }
  float2 sc = S.sched[0];
  const float nis = pin(-A.inv_s2);
  const int steps = pin(A.steps), lead = pin(tid == 0 ? 1 : 0);
  int par = 0, left = A.thin, pend = 0, slot = 0, inb = 0, batch = 0;
  for (int i = 0; i < steps; ++i) {
    float z[RPL];
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr) {
      z[rr] = fmaf(els[rr], eps[rr], loc[rr]);
      S.u[par][row[rr]] = z[rr];
    }
    float eps_n[RPL] = {};
    float2 sc_n = sc;
    if (i + 1 < steps) {
      if (++inb == BATCH) {
        mbar_arrive(&S.empty[batch % NBUF]);
        ++batch;
        inb = 0;
        mbar_wait(&S.full[batch % NBUF], (batch / NBUF) & 1);
      }
      if (++slot == R) slot = 0;
#pragma unroll
      for (int rr = 0; rr < RPL; ++rr) eps_n[rr] = S.eps[slot][row[rr]];
      sc_n = S.sched[slot];
    }
    consumer_sync<CW>();
    float4 uv[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      uv[n] = *reinterpret_cast<const float4*>(&S.u[par][4 * n]);
    float gu[RPL];
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        a0 = fmaf(g[rr][n].x, uv[n].x, a0);
        a1 = fmaf(g[rr][n].y, uv[n].y, a1);
        a2 = fmaf(g[rr][n].z, uv[n].z, a2);
        a3 = fmaf(g[rr][n].w, uv[n].w, a3);
      }
      gu[rr] = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
    }
    const bool write = --left == 0 || i + 1 == steps;
    if (write) {
      left = A.thin;
      float q = 0.f, pq = 0.f;
#pragma unroll
      for (int rr = 0; rr < RPL; ++rr) {
        q += z[rr] * gu[rr];
        if (row[rr] < P)
          pq += (-0.5f * z[rr] * z[rr]) - (-ls[rr] - 0.5f * eps[rr] * eps[rr]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        q += __shfl_xor_sync(0xffffffffu, q, o);
        pq += __shfl_xor_sync(0xffffffffu, pq, o);
      }
      if (lane == 0) S.red[par][w] = make_float2(q, pq);
    }
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr) {
      const float g_z = fmaf(nis, gu[rr], fmaf(eps[rr], emls[rr], -z[rr]));
      const float g_ls = g_z * __fmul_rn(eps[rr], els[rr]);
      const float c1 = __fmul_rn(sc.x, cm[rr]);
      adam(loc[rr], m1[rr], v1[rr], g_z, c1, sc.y);
      adam(ls[rr], m2[rr], v2[rr], g_ls, c1, sc.y);
      els[rr] = exp_path(ls[rr]);
      emls[rr] = exp_path(-ls[rr]);
      eps[rr] = eps_n[rr];
    }
    sc = sc_n;
    if (pend && lead) write_loss<CW>(A, S.red[par ^ 1], pend);
    pend = write ? i / A.thin + 1 : 0;
    par ^= 1;
  }
  consumer_sync<CW>();
  if (pend && lead) write_loss<CW>(A, S.red[par ^ 1], pend);
#pragma unroll
  for (int rr = 0; rr < RPL; ++rr) {
    const int r = row[rr];
    if (r < P) {
      A.loc[r] = loc[rr]; A.ls[r] = ls[rr];
      A.m1[r] = m1[rr]; A.m2[r] = m2[rr]; A.v1[r] = v1[rr]; A.v2[r] = v2[rr];
    }
  }
}

'''

ACCURATE = {
    'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(x, kLog2e)));':
        "r = expf(x);",
    'asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(x));':
        "s = sqrtf(x);",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(s, 1e-8f)));':
        "r = 1.f / (s + 1e-8f);",
}


def _variants():
    from bayesic_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_linreg.cu").read_text()
    a = src.index("template <int NC, bool PROBE>\n__device__ void consume")
    b = src.index("template <int NC, bool PROBE>\n__global__")
    return {
        "shipped": {},
        "one lane a row (D + 2 <= 68)": KL1,
        "4 lanes a row": {"constexpr int KL = 2;": "constexpr int KL = 4;"},
        "one consumer warp, whole rows in registers": {
            **KL1, src[a:b]: _ONE_WARP_CONSUME,
            "constexpr int RPW = 32 / KL;": "constexpr int RPW = 3 * 32 / KL;",
            "template <bool PROBE, int NC = 1>":
            "template <bool PROBE, int NC = 17>"},
        "accurate exp, sqrt and division": ACCURATE,
        "4 producer warps": {"constexpr int NPW = 8;":
                             "constexpr int NPW = 4;"},
    }


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from _variants import build

    from bayesic_tpu_torch.models import linreg as lr
    from bayesic_tpu_torch.ops import fused_linreg as fl
    from bayesic_tpu_torch.ops.fused_nuts import _stream
    from chip_smoke import LINREG

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = lr.Config(**LINREG, device="cuda")
    xn, yn, _, _ = lr.make_data(cfg)
    g = fl.gram(torch.as_tensor(xn, device=dev),
                torch.as_tensor(yn, device=dev))
    # a warm state: the shipped trainer's first 1,000 steps
    loc, ls, opt, _ = fl.fused_train(
        g, cfg.n, cfg.noise, *fl.init_params(cfg.dim, device=dev),
        steps=1000, lr0=cfg.lr, lr_total=2 * STEPS, seed=1)
    start = (loc, ls, *opt)
    thin = fl.loss_thin(STEPS)
    losses = torch.empty(-(-STEPS // thin), device=dev)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    with tempfile.TemporaryDirectory() as tmp:
        built = build("fused_linreg.cu", ["kernel_common.cuh"], _variants(),
                      tmp)
        runs = {}
        for name, (so, _) in built.items():
            lib = ctypes.CDLL(str(so))
            lib.fused_linreg_train.argtypes = (
                [vp] * 9 + [i32] * 2 + [ctypes.c_longlong, i32, f32, i32,
                                        f32, f32, ctypes.c_ulonglong, vp])
            lib.fused_linreg_train.restype = i32

            def run(lib=lib):
                state = [t.clone() for t in start]
                err = lib.fused_linreg_train(
                    g.data_ptr(), *(t.data_ptr() for t in state),
                    losses.data_ptr(), None, cfg.dim, STEPS, STEPS,
                    thin, cfg.lr, 2 * STEPS,
                    1.0 / cfg.noise ** 2,
                    cfg.n * (math.log(cfg.noise) + fl._C), 11, _stream(dev))
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return state
            run()
            torch.cuda.synchronize()
            runs[name] = run
        ref = runs["shipped"]()
        us = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0.record()
                runs[name]()
                t1.record()
                torch.cuda.synchronize()
                us[name].append(1e3 * t0.elapsed_time(t1) / STEPS)
        print(f"fused_linreg.cu variants [{card}], N {cfg.n}, D {cfg.dim}, "
              f"{STEPS} steps, us a step (two rounds):")
        for name, (_, regs) in built.items():
            got = runs[name]()
            torch.cuda.synchronize()
            gap = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(got[:2], ref[:2]))
            print(f"  {name}: {us[name][0]:.6f} / {us[name][1]:.6f} us "
                  f"(loc, ls max |diff| / max from the shipped {gap:.2e}); "
                  f"{regs}", flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
