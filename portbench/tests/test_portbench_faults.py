"""Each cell's check comes out false with its timed path broken, and true
without: the harness's whole run on the CPU (its look for a card
skipped), at sizes a test run holds, with ``faults.py``'s faults planted
under the program's entry."""

import math

import pytest
import torch

from portbench import faults
from portbench.harness import core

from .cells import listed, small_cell

CPU = torch.device("cpu")
CELLS = listed()


def _run(cell, seed=2**31 + 17):
    return core.run_cell(cell, seed, 0.05, False, CPU, 0.0)[0]


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_fault_fails_the_check(cell_name, fault, fused_train_on_cpu):
    cell = small_cell(cell_name)
    with faults.FOR_KIND[cell.kind](fault):
        result = _run(cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell_name", ["dlgm.svi_fused", "dlgm.nuts_fused"])
def test_a_sound_run_is_correct(cell_name, fused_train_on_cpu):
    cell = small_cell(cell_name)
    if cell.kind == "nuts":
        # enough chains and draws that the adapted mass is near the draws'
        # variance at this size
        cell.traffic = dict(cell.traffic, chains=256, warmup=100, samples=100)
    result = _run(cell)
    assert result["correct"] is True, result["checks"]


def test_a_failed_window_call_fails_the_check(fused_train_on_cpu,
                                              monkeypatch):
    """Window calls whose losses are not finite: the check is false and
    the rate counts none of their steps."""
    from bayesic_tpu_torch.ops import fused_vae

    cell = small_cell("dlgm.svi_fused")
    train, first = fused_vae.fused_train, 3 + cell.traffic["steps"]

    def nan_after_setup(*args, t0=0, **kw):
        p, m, v, losses = train(*args, t0=t0, **kw)
        return p, m, v, losses * (math.nan if t0 >= first else 1.0)

    monkeypatch.setattr(fused_vae, "fused_train", nan_after_setup)
    result = _run(cell)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0
    assert result["checks"]["failed_calls"]["value"] == result["failed"]
    assert result["metrics"]["svi_steps_per_s"]["value"] == 0.0


def test_a_fault_in_a_few_chains_fails_the_check(monkeypatch):
    """A transition that alters the draws of its last eighth of chains
    only: the share of followed transitions off the reference fails."""
    from bayesic_tpu_torch.models import dlgm

    build = dlgm.make_batched_transition

    def few(*args, **kwargs):
        step = build(*args, **kwargs)

        def transition(key, states, step_size, inv_mass):
            new, info = step(key, states, step_size, inv_mass)
            q = new.q.clone()
            q[-(q.shape[0] // 8):] += 1e-2
            return new._replace(q=q), info
        return transition

    monkeypatch.setattr(dlgm, "make_batched_transition", few)
    result = _run(small_cell("dlgm.nuts_fused"))
    assert result["correct"] is False
    share = result["checks"]["trans_share"]
    assert share["value"] > share["limit"]


def test_a_shortened_warm_up_fails_the_check(monkeypatch):
    """Jobs that run fewer warm-up transitions than the traffic asks for:
    the check comes out false, and the run still ends with its line."""
    import dataclasses

    from bayesic_tpu_torch.models import dlgm

    entry = dlgm.local_posterior_mcmc_fused

    def short(cfg, *args, **kwargs):
        cfg = dataclasses.replace(cfg, num_warmup=cfg.num_warmup - 10)
        return entry(cfg, *args, **kwargs)

    monkeypatch.setattr(dlgm, "local_posterior_mcmc_fused", short)
    result = _run(small_cell("dlgm.nuts_fused"))
    assert result["correct"] is False
    assert result["checks"]["trans_share"]["value"] == 1.0

