"""The harness finds every cell's files by name; BENCHMARK.json keeps the
contract's shape; the counts, the trace arithmetic and the import guard
give the hand-worked values."""

import json
import re
import subprocess
import sys
import types

import pytest
import torch

from portbench.counts import fused_nuts, fused_vae
from portbench.harness import core, guard, spec, trace

from .cells import ROOT, small_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # 24 cells at this length fit the check's time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_files_found_by_name(cell_name):
    cell = spec.load_cell(cell_name, ROOT)
    mod = cell.job_module()
    for fn in ("setup", "job", "facts", "release", "readings", "check"):
        assert callable(getattr(mod, fn))
    assert cell.traffic["limits"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    # a per-layer metric's cells report the end-to-end metric it moves
    for m in cell.per_layer:
        assert m["moves"] in names


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert len(e["why"]) <= 200
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_counts_by_hand():
    # 5DH + 9HZ multiply-adds a row at D 128, H 256, Z 32, B 1,024
    assert fused_vae.step_flops(128, 256, 32, 1024) == 486_539_264
    # and at the configuration's D 560, H 200, Z 20: 1.22 GFLOP a step
    assert fused_vae.step_flops(560, 200, 20, 1024) \
        == 2 * 1024 * (5 * 560 * 200 + 9 * 200 * 20) == 1_220_608_000
    # 2 nb (ZH + HD) multiply-adds a chain, forward and backward, 1,024
    # chains on 64 rows
    assert fused_nuts.leapfrog_flops(64, 32, 256, 128) == 10_485_760
    assert 1024 * fused_nuts.leapfrog_flops(64, 32, 256, 128) \
        == pytest.approx(10.74e9, rel=1e-3)
    # at Z 20, H 200, D 560: 30.41 GFLOP a leapfrog of 1,024 chains
    assert 1024 * fused_nuts.leapfrog_flops(64, 20, 200, 560) \
        == pytest.approx(30.41e9, rel=1e-3)


def test_idle_union_on_a_synthetic_trace():
    ms = 1_000_000
    dev = [(0, 2 * ms, "void ns::row_kernel<4>(Args)"),
           (1 * ms, 3 * ms, "wgrad_kernel"),
           (5 * ms, 6 * ms, "row_kernel"),
           (9 * ms, 10 * ms, "Memset (Device)")]
    host = [(2 * ms, 6 * ms, "portbench.job"), (3 * ms, 5 * ms, "aten::cat")]
    t = trace.Trace(dev, host, window_s=0.010)
    assert t.busy_s == pytest.approx(0.005)
    assert t.gaps() == [(3 * ms, 5 * ms), (6 * ms, 9 * ms)]
    assert t.seconds(["row_kernel"]) == pytest.approx(0.003)
    b = t.breakdown()
    assert b["device_ops"][0] == ["row_kernel", pytest.approx(0.003)]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "aten::cat": pytest.approx(0.002), "no host op": pytest.approx(0.003)}


def test_import_guard_names_whole_top_levels():
    found = guard.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                     "bayesic_tpu.ops", "bayesic_tpu_torch",
                                     "bayesic_tpu_torch.ops", "jaxtyping",
                                     "torch"])
    assert found == ["bayesic_tpu", "flax", "jax", "jaxlib"]
    assert guard.forbidden_modules(["bayesic_tpu_torch.models.dlgm"]) == []


def test_import_guard_stops_a_run(monkeypatch, fused_train_on_cpu):
    monkeypatch.setitem(sys.modules, "bayesic_tpu",
                        types.ModuleType("bayesic_tpu"))
    with pytest.raises(core.GuardError, match="bayesic_tpu"):
        core.run_cell(small_cell("dlgm.svi_fused"), 1, 0.1, False,
                      torch.device("cpu"), 0.0)


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing
    on standard output."""
    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without a card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "dlgm.svi_fused", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
