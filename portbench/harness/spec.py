"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one its ``configs`` entry gives; the mix is
``traffic/<traffic>.json``; the mix's ``kind`` names the job module
``jobs/<kind>.py``; each metric is read by ``metrics/<name>.py``.  A later
change adds a cell by adding such files and entries, never by editing
these."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def load_module(path: Path):
    """A module from its file: metric files are named after metrics, whose
    names hold dots."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric, cell_name):
    names = metric.get("workloads")
    return names is None or cell_name in names


class Cell:
    """One cell with its configuration, traffic mix and metrics."""

    def __init__(self, bench: dict, name: str, root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.kind = self.traffic["kind"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name)]

    def job_module(self):
        return load_module(BENCH / "jobs" / f"{self.kind}.py")

    @staticmethod
    def reader(metric_name):
        return load_module(BENCH / "metrics" / f"{metric_name}.py").read


def load_cell(name: str, root: Path) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return Cell(bench, name, root)
