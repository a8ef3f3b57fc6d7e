#!/usr/bin/env python3
"""Time the fused GMM SMC mutation kernel with single design steps undone.

Each variant is ``bayesic_tpu_torch/csrc/fused_smc_gmm.cu`` with one textual
edit or a few (one block per adaptation block, a cluster of four, the
accurate exp, log and reciprocal with a log per point, 16 warps a block
and two particles a group at K 3, D 2, the point loop unrolled 2 or 4
times), built alone
into its own library with the port's nvcc flags, and launched at the GMM
bench shape (P 8,192, N 2,000, K 3, D 2, 5 transitions of 5 leapfrogs,
particles near the truth as in ``chip_smoke.py`` phase 20) and on the
generic instance at K 4, D 3 with the same counts.  The variants are timed
in two rounds, in order and then in reverse, on the same inputs; each
prints its milliseconds a stage at both instances, the registers and
spills of both, and how far its output lies from the shipped kernel's.
With ``--parent DIR`` (an unpacked ``git archive`` of the commit before)
that commit's ``fused_smc_gmm.cu`` and its headers are built alone and
timed among them.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:
``python3 tools/smc_mutation_ablation.py [--parent DIR]``.
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

APPROX = {
    'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));': "r = exp2f(v);",
    'asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));': "r = log2f(v);",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));':
        "r = __frcp_rn(v);",
    "constexpr int kChunk = 16;": "constexpr int kChunk = 1;",
}
W2 = {"launch<3, 2, true, 1, NW_EXACT>": "launch<3, 2, true, 2, NW_EXACT>"}
NW16 = {"constexpr int NW_EXACT = 32;": "constexpr int NW_EXACT = 16;"}
UNROLL = {n: {"#pragma unroll 1\n": f"#pragma unroll {n}\n"} for n in (2, 4)}
VARIANTS = {
    "shipped": {},
    "one block per adaptation block": {"constexpr int CL = 2;":
                                       "constexpr int CL = 1;"},
    "cluster of 4": {"constexpr int CL = 2;": "constexpr int CL = 4;"},
    "accurate exp/log/rcp, a log per point": APPROX,
    "16 warps (K 3, D 2)": NW16,
    "16 warps (K 3, D 2), point loop unrolled twice": {**NW16, **UNROLL[2]},
    "16 warps, two particles a group (K 3, D 2), unrolled twice":
        {**NW16, **W2, **UNROLL[2]},
    "two particles a group (K 3, D 2)": W2,
    "point loop unrolled twice": UNROLL[2],
    "point loop unrolled 4 times": UNROLL[4],
}


def _build_all(tmp, parent=None):
    """{name: (library path, the mutation kernel's registers and spills)}
    of every variant [and of the ``parent`` checkout's kernel]."""
    from _variants import build, build_parent

    out = {}
    headers = ["gmm_lik.cuh", "warp_sum.cuh"]
    built = build("fused_smc_gmm.cu", headers, VARIANTS, tmp)
    if parent:
        built["parent (the commit before)"] = build_parent(
            "fused_smc_gmm.cu", parent, tmp)
    for name, (so, summary) in built.items():
        stats = [part for part in summary.split("; ")
                 if part.startswith("smc_gmm_mutate_kernel")]
        out[name] = (so, ", ".join(stats) if stats else
                     f"no ptxas summary ({summary[-300:]!r})")
    return out


def main():
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of the commit "
                    "before, timed beside the variants")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from bayesic_tpu_torch.dist import StickBreaking
    from bayesic_tpu_torch.models import gmm
    from bayesic_tpu_torch.ops import fused_smc_gmm as fsg
    from bayesic_tpu_torch.ops.fused_nuts import _ptr, _stream

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    p, n, kmut, lsteps = 8192, 2000, 5, 5
    rng = np.random.default_rng(20)

    def inputs(k, d):
        """Launch arguments near the truth of a (K, D) mixture's data."""
        xn, truth = gmm.make_data(gmm.Config(num_components=k, data_dim=d,
                                             num_data=n))
        dim = (k - 1) + k * d + k
        base = torch.cat([
            StickBreaking().inverse(torch.as_tensor(truth["weights"])),
            torch.as_tensor(truth["centers"]).reshape(-1),
            torch.log(torch.as_tensor(truth["scales"]))])
        q = (base + torch.as_tensor(rng.normal(0.0, 0.03, (p, dim)))) \
            .to(**f32)
        mom = torch.as_tensor(rng.normal(size=(kmut, p, dim)), **f32)
        log_u = torch.as_tensor(np.log(rng.uniform(size=(p, kmut))), **f32)
        return (q, mom, log_u, torch.ones(dim, **f32),
                torch.as_tensor(xn, **f32), torch.tensor([1.0], **f32),
                torch.tensor([0.03], **f32)), k, d

    with tempfile.TemporaryDirectory() as tmp:
        built = _build_all(Path(tmp), opt.parent)
        cases = {"K 3, D 2": inputs(3, 2), "K 4, D 3": inputs(4, 3)}
        vp, i32, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        runs = {}
        for name, (so, _) in built.items():
            lib = ctypes.CDLL(str(so))
            lib.smc_gmm_mutate.argtypes = [vp] * 11 + [i32] * 6 + [fl, fl, vp]
            lib.smc_gmm_mutate.restype = i32
            for inst, (args, k, d) in cases.items():
                outs = (torch.empty_like(args[0]), torch.empty(p, **f32),
                        torch.empty(p, **f32),
                        torch.empty(-(-p // 128), **f32))

                def run(lib=lib, args=args, outs=outs, k=k, d=d):
                    err = lib.smc_gmm_mutate(
                        *map(_ptr, args), *map(_ptr, outs), p, n, k, d, kmut,
                        lsteps, 0.65, fsg.potential_constant(k, d),
                        _stream(dev))
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                    return outs
                run()
                torch.cuda.synchronize()
                runs[name, inst] = run
        ref = {inst: [t.clone() for t in runs["shipped", inst]()]
               for inst in cases}
        ms = {key: [] for key in runs}
        order = list(runs)
        for keys in (order, order[::-1]):
            for key in keys:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(5):
                    runs[key]()
                end.record()
                torch.cuda.synchronize()
                ms[key].append(start.elapsed_time(end) / 5)
        print(f"fused_smc_gmm.cu variants [{card}], P {p}, N {n}, {kmut} x "
              f"{lsteps}, ms a stage (two rounds):")
        for name in built:
            line = []
            for inst in cases:
                got = runs[name, inst]()
                torch.cuda.synchronize()
                parted = int(((got[0] - ref[inst][0]).abs().amax(1)
                              > 1e-3).sum())
                line.append(f"{inst} {ms[name, inst][0]:.4f} / "
                            f"{ms[name, inst][1]:.4f} ms (mean accept "
                            f"{float(got[2].mean()):.4f}, {parted} particles "
                            f"part from the shipped q' by > 1e-3)")
            print(f"  {name}: " + "; ".join(line) + f"; {built[name][1]}",
                  flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
