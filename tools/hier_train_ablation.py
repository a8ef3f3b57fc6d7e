#!/usr/bin/env python3
"""Time the fused hier-logistic SVI trainer with single design steps undone.

Each variant is ``bayesic_tpu_torch/csrc/fused_hier.cu`` with a few textual
edits, built alone into its own library with the port's nvcc flags
(``tools/_variants.py``) and launched at the hier bench shape (N 10,000,
J 50, F 5, B 1,024, as ``chip_smoke.py`` phase 13): 3,000 steps from one
warm state in the middle of the cosine schedule.  The variants:

- the accurate exp, log, sqrt and division in place of ``ex2``, ``lg2``,
  ``rcp`` and ``sqrt`` ``.approx`` (the row loop and Adam);
- the rows read from L2 (the instance chosen past the shared memory);
- the per-group sums by ``__match_any_sync`` (each group's lowest lane
  adds its peers' d by shuffles), in place of the segmented scan over each
  tile's group order;
- 4 and 16 consumer warps in place of 8;
- no producer warps: consumer warp 0 makes each next step (draws,
  schedule, offset, copy) inside the step;
- the warps' sums by a butterfly of shuffles a value (warp_sum) in place
  of the staging rows in shared memory;
- and, as a what-if whose results are wrong on purpose, no row pass: the
  time of the step's chain without its rows.

With ``--parent DIR`` (an unpacked ``git archive`` of the commit before
the redesign, in a gitignored directory such as ``_archive/``) the
parent's ``fused_hier.cu`` is built alone and timed with them.  The runs
go in two rounds, in order and then in reverse, on the same inputs; each
prints its microseconds a step, its registers and spills, and how far its
parameters end from the shipped kernel's.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:
``python3 tools/hier_train_ablation.py [--parent DIR]``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

STEPS = 3000
HEADERS = ["gmm_lik.cuh", "warp_sum.cuh", "kernel_common.cuh"]

ACCURATE = {
    'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));':
        "r = exp2f(v);",
    'asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));':
        "r = log2f(v);",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));':
        "r = 1.f / v;",
    'asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(x));':
        "s = sqrtf(x);",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(s, 1e-8f)));':
        "r = 1.f / (s + 1e-8f);",
}

L2 = {"    return smem_bytes<F, true>(j, b) <= kMaxSmem\n"
      "               ? run(std::true_type{})":
      "    return false\n               ? run(std::true_type{})"}

# the parent's group sums: in each tile, the lowest lane of each group
# (__match_any_sync) adds its peers' d in lane order into the warp's
# partial, in place of the segmented scan over the tile's group order
MATCH_ANY = {
    """    float x = __shfl_sync(0xffffffffu, d, sw & 31);
    const int lo = lane - ((sw >> 5) & 31), span = 1 << (sw >> 21);
    for (int o = 1; o < span; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, x, o);
      if (o <= lo) x += up;
    }
    if (sw & 1024) part[(sw >> 11) & 1023] += x;""":
    """    const int gm = in ? yg >> 1 : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, gm);
    float x = 0.f;
    for (unsigned mm = peers; mm; mm &= mm - 1)
      x += __shfl_sync(peers, d, __ffs(mm) - 1);
    if (gm >= 0 && lane == __ffs(peers) - 1) part[gm] += x;""",
}

# consumer warp 0 makes step i + 1 (and step 0 before the loop) into the
# two ring slots; no producer warps are launched
NO_PRODUCERS = {
    "constexpr int NPW = 4;": "constexpr int NPW = 2;",
    "constexpr int NT = 32 * (CW + NPW);": "constexpr int NT = 32 * CW;",
    "  mbar_wait(&full[0], 0);\n  Slot<F, RES> cur(sm, L, 0);":
    "  if (w == 0) produce_step<F, RES>(A, sm, L, 0, lane, 0);\n"
    "  mbar_wait(&full[0], 0);\n  Slot<F, RES> cur(sm, L, 0);",
    "      mbar_wait(&full[(i + 1) % R], ((i + 1) / R) & 1);":
    "      if (w == 0)\n"
    "        produce_step<F, RES>(A, sm, L, (i + 1) % R, lane, i + 1);\n"
    "      mbar_wait(&full[(i + 1) % R], ((i + 1) / R) & 1);",
}


# the warps' sums by one warp_sum (xor butterfly) a value
SHUFFLE_SUMS = {
    """#pragma unroll
  for (int k = 0; k < N; ++k) stage[k * 33 + lane] = v[K0 + k];
  __syncwarp();
  float t = 0.f;
  if (lane < N) {
    const float* row = stage + lane * 33;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int l = 0; l < 32; l += 4) {
      a0 += row[l];
      a1 += row[l + 1];
      a2 += row[l + 2];
      a3 += row[l + 3];
    }
    t = (a0 + a1) + (a2 + a3);
    red[K0 + lane] = t;
  }
  return t;""":
    """  float t = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float s = warp_sum(v[K0 + k]);
    if (lane == k) t = s;
  }
  if (lane < N) red[K0 + lane] = t;
  return t;""",
}

NO_ROWS = {"const int s0 = off & 31, nt = ((s0 + B - 1) >> 5) + 1;":
           "const int s0 = off & 31, nt = 0;"}


def _variants():
    return {
        "shipped": {},
        "accurate exp, log, sqrt and division": ACCURATE,
        "rows read from L2": L2,
        "__match_any_sync group sums": MATCH_ANY,
        "4 consumer warps": {"constexpr int CW = 8;":
                             "constexpr int CW = 4;"},
        "16 consumer warps": {"constexpr int CW = 8;":
                              "constexpr int CW = 16;"},
        "no producer warps": NO_PRODUCERS,
        "warp sums by shuffles": SHUFFLE_SUMS,
        "what-if: no row pass (wrong results)": NO_ROWS,
    }


def _bind_new(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_hier_train.argtypes = (
        [vp] * 10 + [i32] * 5 + [ctypes.c_longlong, i32, f32, i32, f32,
                                 ctypes.c_ulonglong, vp])
    lib.fused_hier_train.restype = i32


def _bind_parent(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_hier_train.argtypes = (
        [vp] * 12 + [i32] * 5 + [ctypes.c_longlong, i32, f32, i32, f32,
                                 ctypes.c_ulonglong, vp])
    lib.fused_hier_train.restype = i32


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="unpacked git archive of the commit "
                    "before the redesign")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from _variants import build, build_parent

    from bayesic_tpu_torch.models import hier_logistic as hl
    from bayesic_tpu_torch.ops import fused_hier as fh
    from bayesic_tpu_torch.ops.fused_nuts import _stream

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = hl.Config(device="cuda")
    xn, yn, gn, _ = hl.make_data(cfg)
    x, y, group = (torch.as_tensor(a, device=dev) for a in (xn, yn, gn))
    n, j, f, b = x.shape[0], cfg.num_groups, cfg.num_features, \
        cfg.batch_size
    perm = torch.as_tensor(__import__("numpy").random.default_rng(0)
                           .permutation(n), device=dev)
    x, y, group = x[perm], y[perm], group[perm]
    # a warm state: the shipped trainer's first STEPS steps
    loc, ls, opt, _ = fh.fused_train(
        x, y, group, *fh.init_params(j, f, device=dev), steps=STEPS,
        lr0=cfg.lr, lr_total=2 * STEPS, seed=1, batch=b)
    start = (loc, ls, *opt)
    thin = fh._thin(STEPS)
    losses = torch.empty(-(-STEPS // thin), device=dev)
    tiles = fh.pack_rows(x, y, group.to(torch.int32), b)
    yf = y.to(torch.float32).contiguous()
    g32 = group.to(torch.int32).contiguous()
    xc = x.contiguous()

    with tempfile.TemporaryDirectory() as tmp:
        built = build("fused_hier.cu", HEADERS, _variants(), tmp)
        if args.parent:
            built["parent"] = build_parent("fused_hier.cu", args.parent, tmp)
        runs = {}
        for name, (so, _) in built.items():
            lib = ctypes.CDLL(str(so))
            parent = name == "parent"
            (_bind_parent if parent else _bind_new)(lib)

            def run(lib=lib, parent=parent):
                state = [t.clone() for t in start]
                data = ((xc.data_ptr(), yf.data_ptr(), g32.data_ptr())
                        if parent else (tiles.data_ptr(),))
                err = lib.fused_hier_train(
                    *data, *(t.data_ptr() for t in state), losses.data_ptr(),
                    None, None, n, f, j, b, STEPS, STEPS, thin, cfg.lr,
                    2 * STEPS, n / b, 11, _stream(dev))
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
        print(f"fused_hier.cu variants [{card}], N {n}, J {j}, F {f}, B {b}, "
              f"{STEPS} steps from t0 {STEPS}, us a step (two rounds):")
        for name, (_, regs) in built.items():
            got = runs[name]()
            torch.cuda.synchronize()
            gap = max(float((a - b_).abs().max() / b_.abs().max())
                      for a, b_ in zip(got[:2], ref[:2]))
            print(f"  {name}: {us[name][0]:.6f} / {us[name][1]:.6f} us "
                  f"(loc, ls max |diff| / max from the shipped {gap:.2e}); "
                  f"{regs}", flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
