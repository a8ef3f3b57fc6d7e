#!/usr/bin/env python3
"""Time the hier-logistic NUTS transition kernel with single design steps
undone, and split its time by phase.

Each variant is ``bayesic_tpu_torch/csrc/fused_nuts_hier.cu`` (with the
headers it includes) under a few textual edits: the rows read from device
memory (L2) at every leaf in place of copied once into shared memory;
blocks of 8 or 32 warps in place of 16 (a thread then takes four chunks
or one in place of two); a warp per group (warp w takes groups w, w + 16,
..., its lanes that group's chunks) in place of two chunks a thread; the
accurate exp2, log2 and reciprocal with a log per row in place of the
``.approx`` forms; all four of rows from L2, 8 warps, a warp per group
and the accurate forms at once; the tree alone (no rows, so another
trajectory); and the shipped kernel with clock64 stamps, whose time is
the stamps' cost and which also prints, from thread 0 of block 0, the
cycles from the start to the rows resident (the bulk copy, the draws and
the momentum), those of the doublings' ends (merge, full-span U-turn,
the next doubling's set-up), and per leaf: the drift and the block
barrier that publishes q; thread 0's own rows; the warp sums and the
potential's barrier; thread 0's part of the gradient's tail; the leaf's
bookkeeping and sums over the owner warps; the tree's decision and the
proposal's copy.  The shipped source is built alone first and its nvcc
seconds printed (with ``--parent``, the parent's too), with the SASS
instructions a row of its row loop at every F it compiles; the others
are built side by side, each into its own library with the port's nvcc
flags.  With ``--parent DIR`` (an unpacked checkout of the commit before
the redesign) that commit's kernel is built and timed too (its C entry
takes the sorted rows: x, y, offsets), and the largest J each commit's
kernel takes at F 5 and K 6, 10 and 12 is printed, for groups of 200 rows
and for groups of 3 rows beside one of 100,000.

All run at ``chip_smoke.py`` phase 16's state: the bench's data
(``hier_logistic.Config()``: N 10,000, J 50, F 5), 128 chains after
``fused_nuts_mcmc``'s 500 + 300 transitions, their step size and mass,
one keyed transition at K 6.  The variants are timed in two rounds, in
order and then in reverse, by device time (20 launches queued behind a
spin kernel); each prints its milliseconds a transition, its registers
and spills, the SASS instructions of its row loop a row, and whether its
depths and steps equal the shipped kernel's (and its largest |q'| gap).

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:
``python3 tools/hier_nuts_ablation.py [--parent DIR]``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

SOURCE = "fused_nuts_hier.cu"
HEADERS = ["nuts_tree.cuh", "nuts_draws.cuh", "kernel_common.cuh",
           "gmm_lik.cuh", "warp_sum.cuh"]
L2 = {"    return smem_bytes<F, true>(rows, k) <= kMaxSmem\n":
      "    return false\n"}
THREADS = "constexpr int kHierThreads = 512;"
WARPS8 = {THREADS: "constexpr int kHierThreads = 256;"}
PER_GROUP = {"    for (int c = tid; c < nch; c += NT) {\n":
             "    for (int g = warp; g < J; g += NW)\n"
             "    for (int c = __ldg(r.coff + g) + lane;\n"
             "         c < __ldg(r.coff + g + 1); c += 32) {\n"}
APPROX = {
    'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));': "r = exp2f(v);",
    'asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));': "r = log2f(v);",
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));':
        "r = __frcp_rn(v);",
    "constexpr int kChunk = 16;": "constexpr int kChunk = 1;",
}
VARIANTS = {
    "shipped": {},
    "rows read from L2 at every leaf": L2,
    "8 warps a block": WARPS8,
    "a warp per group": PER_GROUP,
    "accurate exp2/log2/rcp, a log per row": APPROX,
    "32 warps a block": {THREADS: "constexpr int kHierThreads = 1024;"},
    "the tree alone (no rows: another trajectory)": {
        "      const int rows = __ldg(r.chunks + nch + c);\n":
        "      const int rows = 0;\n"},
    "all four undone": {**L2, **WARPS8, **PER_GROUP, **APPROX},
}
STAMP = r"""
__device__ long long g_phase_cycles[8];
// Thread 0 of block 0: add the cycles since the last stamp to phase k (-1:
// start, -2: hand the sums to g_phase_cycles).
__device__ __forceinline__ void stamp(int k) {
  __shared__ long long s_last, s_sum[8];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long t = clock64();
    if (k == -1) {
      for (int i = 0; i < 8; ++i) s_sum[i] = 0;
    } else if (k == -2) {
      for (int i = 0; i < 8; ++i) g_phase_cycles[i] = s_sum[i];
    } else {
      s_sum[k] += t - s_last;
    }
    s_last = t;
  }
}
"""
# per phase: its name, and whether it is counted per leaf
PHASES = [("start to rows resident (copy, draws, momentum)", False),
          ("drift + q's barrier", True), ("rows (thread 0)", True),
          ("warp sums + the potential's barrier", True),
          ("gradient tail (thread 0)", True),
          ("bookkeeping + owner sums", True), ("decision + take", True),
          ("doubling ends", False)]
STAMPED = "clock64 stamps (their cost; cycles by phase)"
VARIANTS[STAMPED] = {
    "namespace {\n\nconstexpr int MAXK":
        "namespace {\n" + STAMP + "\nconstexpr int MAXK",
    "  pot.load();\n  const int n_draws":
        "  stamp(-1);\n  pot.load();\n  const int n_draws",
    "  owner_sum(m2, nw, red2);\n":
        "  owner_sum(m2, nw, red2);\n  stamp(0);\n",
    "      __syncthreads();\n      const float part = pot.eval(q, g);":
        "      __syncthreads();\n      stamp(1);\n"
        "      const float part = pot.eval(q, g);\n      stamp(4);",
    "      owner_sync(nw);\n      float pe_leaf":
        "      owner_sync(nw);\n      stamp(5);\n      float pe_leaf",
    "          t[D + d] = g[d];\n        }\n      }\n":
        "          t[D + d] = g[d];\n        }\n      }\n      stamp(6);\n",
    "    trajectory_close(T, s, full_turn);":
        "    trajectory_close(T, s, full_turn);\n    stamp(7);",
    "  if (tid == 0) trajectory_write(A, chain, T);":
        "  if (tid == 0) trajectory_write(A, chain, T);\n  stamp(-2);",
    "    const float lw = warp_sum(fmaf(kLn2, lik2, lin));":
        "    stamp(2);\n    const float lw = warp_sum(fmaf(kLn2, lik2, lin));",
    "    __syncthreads();\n    const int D = 2 + J + F;":
        "    __syncthreads();\n    stamp(3);\n    const int D = 2 + J + F;",
    '}  // extern "C"':
        "int phase_cycles(long long* out) {\n  return cudaMemcpyFromSymbol("
        "out, g_phase_cycles, sizeof(g_phase_cycles));\n}\n"
        '}  // extern "C"',
}
REPS = 20
CHAINS, K = 128, 6
DEEP = 25          # the deep state's step size is the adapted one's / DEEP


def _summary(summary, f):
    """The F instances' nuts_kernel registers and spills in a
    ``chip_smoke._ptxas_summary``."""
    parts = [part for part in summary.split("; ")
             if part.startswith((f"nuts_kernel<Hier,F{f},", "nuts_kernel "))]
    return ", ".join(parts) or "no ptxas summary"


def _timed(fn):
    """(fn(), its wall seconds)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _largest_j(fits):
    """The largest J in 1..4,096 for which ``fits(J)`` holds, by bisection
    (0 if none)."""
    lo, hi = 0, 4096
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def _limits(fnh, lib, parent_so, f=5):
    """The largest J each kernel takes at F ``f`` and K 6, 10, 12, for
    groups of 200 rows and for groups of 3 beside one of 100,000, as
    text."""
    out = (ctypes.c_int * 3)()
    shapes = {"200 rows a group": lambda j: np.full(j, 200),
              "3 rows a group, one of 100,000":
                  lambda j: np.array([3] * (j - 1) + [100_000])}
    parent = None
    if parent_so:
        parent = ctypes.CDLL(str(parent_so)).fused_hier_nuts_smem_bytes
        parent.argtypes, parent.restype = [ctypes.c_int] * 3, ctypes.c_size_t
    parts = []
    for kk in (6, 10, 12):
        for label, counts in shapes.items():
            def fits(j, counts=counts, kk=kk):
                chunks, _, depth = fnh._layout(counts(j))
                return lib.fused_hier_nuts_geometry(
                    j, f, kk, depth, chunks.shape[1], out) == 0
            parts.append(f"K {kk}, {label}: {_largest_j(fits)}")
        if parent:
            parts.append(f"K {kk}, parent: "
                         f"{_largest_j(lambda j, kk=kk: parent(j, f, kk))}")
    return "; ".join(parts)


def card():
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def adapted_state(torch, dev):
    """``chip_smoke.py`` phase 16's state: (data, q, pe, grad, step size (1,),
    inverse mass (D,)) of the bench's 128 chains after ``fused_nuts_mcmc``'s
    500 + 300 transitions at K 6."""
    from bayesic_tpu_torch.models import hier_logistic as hl
    from bayesic_tpu_torch.ops import fused_nuts_hier as fnh

    cfg = hl.Config(device="cuda")
    j, f = cfg.num_groups, cfg.num_features
    xn, yn, gn, _ = hl.make_data(cfg)
    x, y, group = (torch.as_tensor(a, device=dev) for a in (xn, yn, gn))
    res = hl.fused_nuts_mcmc(j, f, x, y, group, num_warmup=500,
                             num_samples=300, num_chains=CHAINS,
                             target_accept=0.85, max_doublings=K).run(2)
    data = fnh.hier_data(x, y, group, j)
    q = res.unconstrained[:, -1].contiguous()
    pe, g = fnh.fused_hier_nuts_potential(q, data)
    step = torch.as_tensor(res.extra["step_size"], dtype=torch.float32,
                           device=dev).reshape(1)
    return data, q, pe, g, step, res.extra["inv_mass"].reshape(-1) \
        .contiguous()


def keyed_entry(lib, n_rows, n_shape, n_key):
    """The keyed transition entry of a built library, for ``n_rows`` row
    arrays, ``n_shape`` int arguments and ``n_key`` key words (4 with the
    chain base, 3 before it)."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entry = lib.fused_hier_nuts_transition_keyed
    entry.argtypes = ([vp] * (13 + n_rows) + [i32] * n_shape + [f32]
                      + [ctypes.c_ulonglong] + [ctypes.c_uint] * (n_key - 1)
                      + [vp])
    entry.restype = i32
    return entry


def _phase_cycles(lib, state, leaves):
    """The stamped kernel's cycles by phase in its last launch, as text
    (``leaves``: chain 0's leaf count in it)."""
    cyc = (ctypes.c_longlong * len(PHASES))()
    if lib.phase_cycles(cyc):
        raise RuntimeError("reading the stamps failed")
    return (f"{state} step, SM cycles on thread 0 of block 0 ({leaves:.0f} "
            f"leaves in chain 0): " + ", ".join(
                f"{label} {cyc[i] / (leaves if per else 1):.0f}"
                + (" a leaf" if per else "")
                for i, (label, per) in enumerate(PHASES)))


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of the commit "
                    "before the redesign, timed beside the variants")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from _variants import build, build_parent
    from chip_smoke import _sass_loop_stats
    from bayesic_tpu_torch.infer.mcmc import StreamKey
    from bayesic_tpu_torch.ops import _build
    from bayesic_tpu_torch.ops import fused_nuts_hier as fnh
    from bayesic_tpu_torch.ops.fused_nuts import _key_words, _ptr, _stream

    dev = torch.device("cuda", 0)
    data, q, pe, g, step, inv_mass = adapted_state(torch, dev)
    j, f = fnh._dims(data)
    kk, chains = K, CHAINS
    depth, nch = fnh._depth_nch(data)
    key = _key_words(StreamKey(16, 2, 0))
    states = {"adapted": step, "deep": step / DEEP}

    with tempfile.TemporaryDirectory() as tmp:
        alone, rest = Path(tmp) / "alone", Path(tmp) / "rest"
        alone.mkdir()
        rest.mkdir()
        shipped, secs = _timed(lambda: build(
            SOURCE, HEADERS, {"shipped": {}}, alone))
        line = f"nvcc alone: {SOURCE} {secs:.1f} s"
        if opt.parent:
            parent, secs = _timed(lambda: build_parent(SOURCE, opt.parent,
                                                       tmp))
            line += f", the parent's {secs:.1f} s"
        loops = ", ".join(
            f"F{t.split(',')[2]} {('l2', 'resident')[int(t.split(',')[3])]} "
            f"{n / items:.1f}" for t, n, items, _, _
            in _sass_loop_stats(shipped["shipped"][0], "nuts_kernel", per=1))
        print(f"{line}; row loop SASS instructions a row by instance: "
              f"{loops}", flush=True)
        print("largest J at F 5: " + _limits(
            fnh, _build.load(), parent[0] if opt.parent else None),
            flush=True)
        others = {k: v for k, v in VARIANTS.items() if k != "shipped"}
        built = {name: (so, _summary(summary, f)) for name, (so, summary)
                 in {**shipped, **build(SOURCE, HEADERS, others,
                                        rest)}.items()}
        rows = {name: (data.xc, data.ybits, data.chunks, data.chunk_off)
                for name in built}
        shape = {name: (chains, j, f, kk, depth, nch) for name in built}
        key_of = {name: key for name in built}
        if opt.parent:
            built["parent (the commit before)"] = parent
            rows["parent (the commit before)"] = (data.x, data.y,
                                                  data.offsets)
            shape["parent (the commit before)"] = (chains, j, f, kk)
            # the parent's keyed entry takes no chain base
            key_of["parent (the commit before)"] = key[:3]
        # the launched instance's template arguments: threads, F, resident
        tmpl = {name: ",".join(
            [edits.get(THREADS, THREADS).split()[-1][:-1]] * 2
            + [str(f), "0" if L2.items() <= edits.items() else "1"])
            for name, edits in VARIANTS.items()}
        tmpl["parent (the commit before)"] = ""
        runs, outs_of, libs = {}, {}, {}
        for name, (so, _) in built.items():
            libs[name] = ctypes.CDLL(str(so))
            entry = keyed_entry(libs[name], len(rows[name]),
                                len(shape[name]), len(key_of[name]))
            for state, eps in states.items():
                scal = torch.empty((6, chains, 1), device=dev)
                # q', pe', grad', accept, diverging, depth, steps, h0
                outs = (torch.empty_like(q), scal[0], torch.empty_like(q),
                        *scal[1:])

                def run(entry=entry, name=name, outs=outs, eps=eps):
                    err = entry(*map(_ptr, (q, pe, g, eps, inv_mass)),
                                *map(_ptr, rows[name]), *map(_ptr, outs),
                                *shape[name], 1000.0, *key_of[name],
                                _stream(dev))
                    if err:
                        raise RuntimeError(f"{name}: launch failed: CUDA "
                                           f"error {err}")
                run()
                torch.cuda.synchronize()
                runs[name, state], outs_of[name, state] = run, outs
        ms = {key_: [] for key_ in runs}
        order = list(runs)
        for keys in (order, order[::-1]):
            for key_ in keys:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(int(4e6 * REPS))
                start.record()
                for _ in range(REPS):
                    runs[key_]()
                end.record()
                torch.cuda.synchronize()
                ms[key_].append(start.elapsed_time(end) / REPS)
        ref = {state: [t.clone() for t in outs_of["shipped", state]]
               for state in states}
        print(f"fused_nuts_hier.cu variants [{card()}], N {data.x.shape[0]}, "
              f"J {j}, "
              f"F {f}, {chains} chains at K {kk} after fused_nuts_mcmc's "
              f"500 + 300, one keyed transition at its step size "
              f"{float(step):.4f} (adapted) and at 1/{DEEP} of it (deep); "
              f"device ms a transition (two rounds):", flush=True)
        for name, (so, regs) in built.items():
            line, deepest, cycles = [], {}, []
            for state in states:
                runs[name, state]()
                torch.cuda.synchronize()
                got, want = outs_of[name, state], ref[state]
                if name == STAMPED:
                    cycles.append(_phase_cycles(libs[name], state,
                                                float(got[6][0, 0])))
                same = all(torch.equal(got[i], want[i]) for i in (4, 5, 6))
                deepest[state] = int(got[6].max())
                line.append(
                    f"{state} {ms[name, state][0]:.4f} / "
                    f"{ms[name, state][1]:.4f} ms ({float(got[6].mean()):.2f} "
                    f"leapfrogs a chain, the deepest {deepest[state]}; depths "
                    f"and steps {'equal' if same else 'DIFFER'}, max |q' gap| "
                    f"{float((got[0] - want[0]).abs().max()):.2e})")
            t = {state: min(ms[name, state]) for state in states}
            if deepest["deep"] > deepest["adapted"]:
                leaf = (t["deep"] - t["adapted"]) / (deepest["deep"]
                                                     - deepest["adapted"])
                rest = t["adapted"] - leaf * deepest["adapted"]
                line.append(f"{1e3 * leaf:.3f} us a leaf of the deepest "
                            f"chain, {1e3 * rest:.2f} us besides")
            loop = [st for st in _sass_loop_stats(so, "nuts_kernel", per=1)
                    if st[0] == tmpl[name]]
            line.append(f"{loop[0][1] / loop[0][2]:.1f} SASS instructions a "
                        f"row (MUFU {loop[0][4] / loop[0][2]:.2f})" if loop
                        else "row loop not read")
            print(f"  {name}: " + "; ".join(line) + f"; {regs}", flush=True)
            for text in cycles:
                print(f"    {text}", flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
