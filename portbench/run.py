"""The port's benchmark: run one cell once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``,
``bayesic_tpu_torch`` and this folder.  The last line of standard output is
the result (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``);
the last lines of standard error give each compared number beside its
limit.  Exits non-zero, with no result, without the CUDA cards the cell
asks for, or when JAX or the JAX package is loaded in this process."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import core, spec

    cell = spec.load_cell(args.workload, Path.cwd())
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    try:
        result, found = core.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), torch.device("cuda"),
                                      T_START)
    except core.GuardError as e:
        print(f"import guard: {e}", file=sys.stderr)
        return 4
    core.emit(result, found)
    return 0


if __name__ == "__main__":
    sys.exit(main())
