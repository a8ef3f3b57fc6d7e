#!/usr/bin/env python3
"""Time the GMM likelihood kernels (forward, backward, value+grad) with
single design steps undone, and against the commit before.

Each variant is ``bayesic_tpu_torch/csrc/gmm_logprob.cu`` (with
``gmm_lik.cuh``) under a few textual edits: the accurate exp2, log2 and
reciprocal with a log per point in place of the log2-domain ``.approx``
forms; the forward's K 3, D 2 instance at other block sizes and
particles a warp (1,024 threads at one block an SM, 512 threads at four,
two particles a warp at 1,024 threads, one block an SM, or at 512, two)
in place of 1,024 threads at two blocks an SM and one particle a warp;
the backward's at 8 and 16 warps a block (4 and 2 blocks an SM) in place
of 32 at one.  Each is built into its own library with the port's nvcc
flags.  With ``--parent DIR`` (an
unpacked ``git archive`` of the commit before, in a directory
``.gitignore`` lists) that commit's ``gmm_logprob.cu`` and its headers are
built alone and timed too.

All run at the GMM bench shape (P 8,192, N 2,000, K 3, D 2, particles as
``chip_smoke.py`` phase 17 makes them, a random cotangent for the
backward).  The (variant, kernel) pairs are timed in four rounds, in
order, reversed, in order and reversed, so that the parent and this
tree's kernels run in turns, by device time (the launches queued behind a
spin kernel).  Each line prints a kernel's milliseconds a call in each
round, the K 3, D 2 instance's registers and spills, its blocks,
resident blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
and waves, the SASS instructions of its point loop a particle-point, and
its largest error against the plain version (ll relative, gradients over
max|g|).

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:
``python3 tools/gmm_lik_ablation.py [--parent DIR]``.
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

SOURCE = "gmm_logprob.cu"
HEADERS = ["gmm_lik.cuh", "warp_sum.cuh"]
APPROX = {
    'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));': "r = exp2f(v);",
    'asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));': "r = log2f(v);",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));':
        "r = __frcp_rn(v);",
    "constexpr int kChunk = 16;": "constexpr int kChunk = 1;",
}


def shape(mode, threads=None, per_sm=None, w=None):
    """The K 3, D 2 instance of ``mode`` ("FWD", "BWD") at ``threads`` a
    block built for ``per_sm`` blocks an SM [and ``w`` particles a
    warp]."""
    edits = {}
    for name, value in ((f"{mode}_NT", threads),
                        (f"{mode}_MIN_BLOCKS", per_sm), (f"{mode}_W", w)):
        if value is not None:
            old = next(line for line in (ROOT / "bayesic_tpu_torch" / "csrc"
                                         / SOURCE).read_text().splitlines()
                       if line.startswith(f"constexpr int {name} = "))
            edits[old] = f"constexpr int {name} = {value};"
    return edits


VARIANTS = {
    "shipped": {},
    "accurate exp2/log2/rcp, a log per point": APPROX,
    "forward 1,024 threads, 1 block an SM, 1 particle a warp":
        shape("FWD", 1024, 1, 1),
    "forward 512 threads, 4 blocks an SM, 1 particle a warp":
        shape("FWD", 512, 4, 1),
    "forward 1,024 threads, 1 block an SM, 2 particles a warp":
        shape("FWD", 1024, 1, 2),
    "forward 512 threads, 2 blocks an SM, 2 particles a warp":
        shape("FWD", 512, 2, 2),
    "backward 8 warps, 4 blocks an SM": shape("BWD", 256, 4),
    "backward 16 warps, 2 blocks an SM": shape("BWD", 512, 2),
}
PARENT = "parent (the commit before)"
KERNELS = {"fwd": 0, "bwd": 1, "vg": 2}     # csrc/gmm_logprob.cu's Mode
REPS, ROUNDS = 50, 4


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gmm_loglik_fwd.argtypes = [vp] * 5 + [i32] * 4 + [vp]
    lib.gmm_loglik_bwd.argtypes = [vp] * 8 + [i32] * 4 + [vp]
    lib.gmm_loglik_vg.argtypes = [vp] * 8 + [i32] * 4 + [vp]
    for fn in (lib.gmm_loglik_fwd, lib.gmm_loglik_bwd, lib.gmm_loglik_vg):
        fn.restype = i32
    if hasattr(lib, "gmm_loglik_geometry"):
        lib.gmm_loglik_geometry.argtypes = [i32] * 5 + [vp]
        lib.gmm_loglik_geometry.restype = i32
    return lib


def main():
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of the commit "
                    "before the redesign, timed in turns with this tree")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from _variants import build, build_parent
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
    ct = torch.as_tensor(rng.normal(size=p).astype(np.float32), device=dev)
    want = {"vg": glp.gmm_loglik_grad_reference(*args),
            "bwd": glp.gmm_loglik_grad_reference(*args, ct)[1:]}
    want["fwd"] = want["vg"][:1]
    outs = {kk: [torch.empty_like(w) for w in ws] for kk, ws in want.items()}

    with tempfile.TemporaryDirectory() as tmp:
        built = build(SOURCE, HEADERS, VARIANTS, Path(tmp))
        if opt.parent:
            built[PARENT] = build_parent(SOURCE, opt.parent, tmp)
        runs, info = {}, {}
        for name, (so, summary) in built.items():
            lib = _bind(ctypes.CDLL(str(so)))
            sass = _sass_loops(so, "gmm_lik_kernel").split("; ")
            for kernel, mode in KERNELS.items():
                inst = f"gmm_lik_kernel<3,2,1,{mode}>"
                extra = [ct] if kernel == "bwd" else []
                entry = getattr(lib, f"gmm_loglik_{kernel}")

                def run(entry=entry, extra=extra, out=outs[kernel],
                        tag=f"{name} {kernel}"):
                    err = entry(*map(_ptr, args + extra + out), p, n, k, d,
                                _stream(dev))
                    if err:
                        raise RuntimeError(f"{tag}: launch failed: CUDA "
                                           f"error {err}")
                run()
                torch.cuda.synchronize()
                got, ref = outs[kernel], want[kernel]
                errs = [float((g - w).abs().max() / w.abs().max())
                        for g, w in zip(got, ref)]
                if kernel != "bwd":
                    errs[0] = float(((got[0] - ref[0]).abs()
                                     / ref[0].abs()).max())
                geo = "geometry not read"
                if hasattr(lib, "gmm_loglik_geometry"):
                    g = (ctypes.c_int * 7)()
                    if lib.gmm_loglik_geometry(mode, p, n, k, d, g):
                        raise RuntimeError(f"{name}: the geometry call "
                                           f"failed")
                    sms = torch.cuda.get_device_properties(dev) \
                        .multi_processor_count
                    geo = (f"{g[3]} blocks of {g[0]} threads, {g[1]} "
                           f"particle(s) a warp, {g[6]} resident an SM: "
                           f"{g[3] / (g[6] * sms):.2f} waves")
                regs = [part for part in summary.split("; ")
                        if part.startswith(inst)]
                loops = [part for part in sass if part.startswith(inst)]
                info[name, kernel] = (
                    ", ".join(regs) or "no ptxas summary", geo,
                    "; ".join(loops) or "no SASS loop found", errs)
                runs[name, kernel] = run
        ms = {key: [] for key in runs}
        order = list(runs)
        for r in range(ROUNDS):
            for key in (order if r % 2 == 0 else order[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(int(4e6 * REPS))
                start.record()
                for _ in range(REPS):
                    runs[key]()
                end.record()
                torch.cuda.synchronize()
                ms[key].append(start.elapsed_time(end) / REPS)
        print(f"gmm_logprob.cu variants [{card}], P {p}, N {n}, K {k}, D "
              f"{d}, device ms a call ({ROUNDS} rounds in turns):")
        for (name, kernel), times in ms.items():
            regs, geo, loops, errs = info[name, kernel]
            label = ("ll rel err " if kernel != "bwd" else "") + ", ".join(
                f"{e:.2e}" for e in errs)
            print(f"  {name} / {kernel}: "
                  + " / ".join(f"{t:.4f}" for t in times)
                  + f" ms; {regs}; {geo}; {loops}; errors {label}",
                  flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
