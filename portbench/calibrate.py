"""The readings that a cell's limits are set from, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 3] [--faults 3] [--out <file>]

For each seed, the cell's set-up and one job, which the check follows,
then the check's numbers without their limits: the program's readings on every
seed; the control's (the reference in the precision below the
configuration's, put in the program's place) on the first ``--control``
seeds; each planted fault's (``faults.py``) on the first ``--faults``
seeds.  One JSON line a reading, and a summary line: the largest program
reading and the smallest control and fault reading of each number.  Not
part of a benchmark run."""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed, device, control=False, fault=None):
    """One seed's readings of ``cell``'s compared numbers."""
    import contextlib

    import torch

    from portbench import faults
    from portbench.harness import core

    mod = cell.job_module()
    # the check follows the window's first job (or call), so that one job
    # after set-up gives a reading
    ctx = SimpleNamespace(device=device, seed=int(seed), config=cell.config,
                          traffic=cell.traffic, pick=0)
    planted = (faults.FOR_KIND[cell.kind](fault) if fault
               else contextlib.nullcontext())
    with planted:
        state = mod.setup(ctx)
        records = core._jobs(mod, state, device, count=1)
    mod.release(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return mod.readings(state, records, seed, control=control)


def summarize(lines):
    out = {}
    for line in lines:
        for k, v in line["readings"].items():
            if not isinstance(v, (int, float)):
                continue
            slot = out.setdefault(k, {})
            key = line["side"]
            if key == "program":
                slot["program_max"] = max(slot.get("program_max", v), v)
            else:
                name = f"{key}_min"
                slot[name] = min(slot.get(name, v), v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import faults
    from portbench.harness import spec

    cell = spec.load_cell(args.workload, Path.cwd())
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    plan = [("program", s, False, None) for s in seeds]
    plan += [("control", s, True, None) for s in seeds[:args.control]]
    plan += [(f"fault.{k}", s, False, k) for k in faults.KINDS
             for s in seeds[:args.faults]]
    lines = []
    out = open(args.out, "a") if args.out else None
    try:
        for side, seed, control, fault in plan:
            t0 = time.perf_counter()
            r = readings(cell, seed, device, control, fault)
            line = {"cell": cell.name, "side": side, "seed": seed,
                    "readings": r, "seconds": time.perf_counter() - t0}
            lines.append(line)
            for f in (sys.stdout, out):
                if f is not None:
                    print(json.dumps(line), file=f, flush=True)
        summary = {"cell": cell.name, "summary": summarize(lines)}
        for f in (sys.stdout, out):
            if f is not None:
                print(json.dumps(summary), file=f, flush=True)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
