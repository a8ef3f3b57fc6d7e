"""The cells of BENCHMARK.json, at their full sizes and at sizes that a
CPU test run holds."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL = {"dlgm": dict(num_data=256, data_dim=8, latent_dim=3, hidden=16)}
SMALL_TRAFFIC = dict(batch=64, steps=10, rows=4, chains=16, warmup=60,
                     samples=40, warm_warmup=20, warm_samples=10,
                     check_warmup=1, check_sampling=32, trace_jobs=1, pool=2)


def cell(name):
    """A cell of BENCHMARK.json at its full size."""
    from portbench.harness import spec

    return spec.load_cell(name, ROOT)


def small_cell(name):
    c = cell(name)
    c.config = dict(c.config, **SMALL[c.entry["config"]])
    c.traffic = dict(c.traffic, **SMALL_TRAFFIC)
    return c


def listed():
    return [w["name"] for w in
            json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
