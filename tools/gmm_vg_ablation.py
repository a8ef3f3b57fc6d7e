#!/usr/bin/env python3
"""Time the GMM value+grad likelihood kernel with single design steps
undone.

Each variant is ``bayesic_tpu_torch/csrc/gmm_logprob.cu`` (with
``gmm_lik.cuh``) under a few textual edits: the design before whole (the
forward and backward kernels' body run as value+grad: ``accumulate``'s
accurate per-point exp, log and reciprocal, 8 warps a block, a static 32
KB x tile, no register bound); the accurate exp, log and reciprocal with a
log per point in place of the log2-domain ``.approx`` forms; blocks of 8
warps (4 an SM, or 5 with a smaller x tile so that five fit, and the
register bound that comes with it), of 16 (2 an SM) or of 4 in place of
32 (one an SM); and a particle's points split between two warps whose
sums are added in a fixed order through shared memory, in place of one
warp a particle.  Each is built alone into its own library with the port's nvcc flags and
launched at the GMM bench shape (P 8,192, N 2,000, K 3, D 2, particles as
``chip_smoke.py`` phase 17 makes them).  The variants are timed in two
rounds, in order and then in reverse, by device time (the launches queued
behind a spin kernel); each prints its milliseconds a call, its registers
and spills, its resident blocks an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and waves, the SASS
instructions of its point loop a particle-point and its largest error
against the plain version (ll relative, gradients over max|g|).

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:
``python3 tools/gmm_vg_ablation.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

APPROX = {
    'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));': "r = exp2f(v);",
    'asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));': "r = log2f(v);",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));':
        "r = __frcp_rn(v);",
    "constexpr int kChunk = 16;": "constexpr int kChunk = 1;",
}
NT = "constexpr int VG_NT = 1024;"
MIN_BLOCKS = "constexpr int VG_MIN_BLOCKS = 1;"
TILE = "constexpr int VG_TILE_FLOATS = 12288;"


def geometry(warps, per_sm, tile=None):
    """Blocks of ``warps`` warps built for ``per_sm`` of them an SM [and
    x tiles of ``tile`` floats]."""
    edits = {NT: f"constexpr int VG_NT = {32 * warps};",
             MIN_BLOCKS: f"constexpr int VG_MIN_BLOCKS = {per_sm};"}
    if tile:
        edits[TILE] = f"constexpr int VG_TILE_FLOATS = {tile};"
    return edits


# the design before: the forward/backward body with LL and GRAD both on, 8
# warps a block, no register bound
PARENT = {
    "if constexpr (MODE == VG) {": "if constexpr (false) {",
    NT: "constexpr int VG_NT = 256;",
    "MODE == VG && EXACT ? VG_MIN_BLOCKS : 1": "1",
    "return MODE == VG ? 4 * (size_t)(n < tile ? n : tile) * d : 0;":
        "return 0;",
}
# two warps a particle: each takes half of every tile's points, the second
# hands its sums to the first through shared memory, which adds them in one
# order
SPLIT = {
    "const int pi = blockIdx.x * (NT / 32) + warp;":
        "const int pi = blockIdx.x * (NT / 64) + (warp >> 1);",
    "int blocks(int p, int nt) { return (p + nt / 32 - 1) / (nt / 32); }":
        "int blocks(int p, int nt) { return (p + nt / 64 - 1) / (nt / 64); }",
    "out[1] = out[0] / 32;": "out[1] = out[0] / 64;",
    """    if (live) points_log2<MK, MD, EXACT, 1>(m, xs, lane, cnt, k, d, s);
  }
  if (!live) return;                       // whole warps only
  s.butterfly(k, d);
  if (lane != 0) return;
""": """    const int h = (threadIdx.x >> 5) & 1, h0 = h ? cnt / 2 : 0;
    const int hn = h ? cnt - cnt / 2 : cnt / 2;
    if (live)
      points_log2<MK, MD, EXACT, 1>(m, xs + h0 * d, lane, hn, k, d, s);
  }
  constexpr int NS = 1 + 2 * MK + MK * MD;
  __shared__ float part[NT / 64][NS];
  float* mine = part[threadIdx.x >> 6];
  const bool second = (threadIdx.x >> 5) & 1;
  if (live) {
    s.butterfly(k, d);
    if (second && lane == 0) {
      mine[0] = s.ll[0];
      for (int kk = 0; kk < MK; ++kk) {
        mine[1 + kk] = s.r[0][kk];
        mine[1 + MK + kk] = s.rq[0][kk];
        for (int j = 0; j < MD; ++j)
          mine[1 + 2 * MK + kk * MD + j] = s.rdx[0][kk][j];
      }
    }
  }
  __syncthreads();
  if (!live || second || lane != 0) return;
  s.ll[0] += mine[0];
  for (int kk = 0; kk < MK; ++kk) {
    s.r[0][kk] += mine[1 + kk];
    s.rq[0][kk] += mine[1 + MK + kk];
    for (int j = 0; j < MD; ++j)
      s.rdx[0][kk][j] += mine[1 + 2 * MK + kk * MD + j];
  }
""",
}
VARIANTS = {
    "shipped": {},
    "before: accumulate, 8 warps, 32 KB static tile": PARENT,
    "accurate exp/log/rcp, a log per point": APPROX,
    "8 warps a block, 4 blocks an SM": geometry(8, 4),
    "16 warps a block, 2 blocks an SM": geometry(16, 2),
    "4 warps a block, 8 blocks an SM, 24 KB tiles": geometry(4, 8, 6144),
    "8 warps a block, 5 blocks an SM, 36 KB tiles": geometry(8, 5, 9216),
    "two warps a particle": SPLIT,
}
REPS = 50


def _build_all(tmp):
    """{name: (library path, the value+grad K 3, D 2 instance's registers
    and spills)} of every variant."""
    from _variants import build

    out = {}
    headers = ["gmm_lik.cuh", "warp_sum.cuh"]
    for name, (so, summary) in build("gmm_logprob.cu", headers, VARIANTS,
                                     tmp).items():
        stats = [part for part in summary.split("; ")
                 if part.startswith("gmm_lik_kernel<3,2,1,2>")]
        out[name] = (so, ", ".join(stats) if stats else
                     f"no ptxas summary ({summary[-300:]!r})")
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from chip_smoke import _sass_loops
    from bayesic_tpu_torch.models import gmm
    from bayesic_tpu_torch.ops import gmm_logprob as glp
    from bayesic_tpu_torch.ops.fused_nuts import _ptr, _stream

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    p, n, k, d = 8192, 2000, 3, 2
    rng = np.random.default_rng(17)
    xn, truth = gmm.make_data(gmm.Config(num_data=n))
    args = [torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (
        xn, np.log(rng.dirichlet(np.full(k, 2.0), p)),
        truth["centers"][None] + rng.normal(0.0, 1.0, (p, k, d)),
        np.exp(rng.normal(np.log(0.7), 0.3, (p, k))))]
    want = glp.gmm_loglik_grad_reference(*args)
    outs = [torch.empty_like(w) for w in want]
    vp, i32 = ctypes.c_void_p, ctypes.c_int

    with tempfile.TemporaryDirectory() as tmp:
        built = _build_all(Path(tmp))
        runs, info = {}, {}
        for name, (so, regs) in built.items():
            lib = ctypes.CDLL(str(so))
            lib.gmm_loglik_vg.argtypes = [vp] * 8 + [i32] * 4 + [vp]
            lib.gmm_loglik_vg.restype = i32
            lib.gmm_loglik_vg_geometry.argtypes = [i32] * 4 + [vp]
            lib.gmm_loglik_vg_geometry.restype = i32
            geo = (ctypes.c_int * 6)()
            if lib.gmm_loglik_vg_geometry(p, n, k, d, geo):
                raise RuntimeError(f"{name}: the geometry call failed")

            def run(lib=lib, name=name):
                err = lib.gmm_loglik_vg(*map(_ptr, args), *map(_ptr, outs),
                                        p, n, k, d, _stream(dev))
                if err:
                    raise RuntimeError(f"{name}: launch failed: CUDA error "
                                       f"{err}")
            run()
            torch.cuda.synchronize()
            errs = [float(((outs[0] - want[0]).abs() / want[0].abs()).max())]
            errs += [float((g - w).abs().max() / w.abs().max())
                     for g, w in zip(outs[1:], want[1:])]
            sass = [part for part in _sass_loops(so, "gmm_lik_kernel")
                    .split("; ") if part.startswith("gmm_lik_kernel<3,2,1,2>")]
            info[name] = (regs, geo[5], geo[2], sass, errs)
            runs[name] = run
        ms = {name: [] for name in runs}
        order = list(runs)
        for names in (order, order[::-1]):
            for name in names:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(int(4e6 * REPS))
                start.record()
                for _ in range(REPS):
                    runs[name]()
                end.record()
                torch.cuda.synchronize()
                ms[name].append(start.elapsed_time(end) / REPS)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print(f"gmm_logprob.cu value+grad variants [{card}], P {p}, N {n}, "
              f"K {k}, D {d}, device ms a call (two rounds):")
        for name in built:
            regs, resident, blocks, sass, errs = info[name]
            print(f"  {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} ms; "
                  f"{regs}; {blocks} blocks, {resident} resident an SM: "
                  f"{blocks / (resident * sms):.2f} waves; "
                  f"{'; '.join(sass) or 'no SASS loop found'}; ll rel err "
                  f"{errs[0]:.2e}, gradients "
                  + ", ".join(f"{e:.2e}" for e in errs[1:]), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
