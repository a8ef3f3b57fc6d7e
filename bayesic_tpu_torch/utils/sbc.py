"""Simulation-based calibration (Talts et al. 2018).

Counterpart of ``bayesic_tpu/utils/sbc.py``: draw (theta, y) ~ p(theta)
p(y | theta), run the sampler under test on y, and record the rank of
theta among its posterior draws.  A correct sampler gives uniform ranks
for every marginal; a U shape means an overdispersed posterior, a hump an
underdispersed one, a skew a shifted one.

Usage::

    def run_fn(generator, data):      # -> dict site -> (draws, *event)
        r = MCMC(model=model_fn(data), ...).run(seed)
        return {k: v.reshape((-1,) + v.shape[2:]) for k, v in ...}

    res = sbc(prior_predictive_fn, run_fn, num_sims=200,
              generator=torch.Generator().manual_seed(0))
    res.ranks      # site -> (num_sims, *event) integer ranks
    res.pvalues    # site -> chi-squared uniformity p-value per coordinate
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .compare import _host

__all__ = ["sbc", "SBCResult"]


class SBCResult(NamedTuple):
    ranks: dict       # site -> (num_sims, *event) ranks in [0, L]
    num_bins: int
    pvalues: dict     # site -> per-coordinate chi^2 uniformity p-value

    def min_pvalue(self):
        return min(float(np.min(v)) for v in self.pvalues.values())


def _chi2_sf(x, df):
    """Survival function of chi^2 (the regularized upper gamma)."""
    from scipy.stats import chi2
    return float(chi2.sf(x, df))


def sbc(prior_fn: Callable, run_fn: Callable, *, num_sims=100,
        num_bins=20, thin=1, generator=None) -> SBCResult:
    """``prior_fn(generator) -> (theta: dict, data)`` draws one joint prior
    sample; ``run_fn(generator, data) -> dict site -> (L, *event)`` runs
    the sampler under test and returns posterior draws for the same sites
    as theta (``thin`` keeps every thin-th: ranks need near-independent
    draws).  Both get the one ``generator`` (a CPU generator seeded with 0
    if None), in turn, simulation after simulation.

    Ranks are binned by floor(rank * num_bins / (L + 1)); when (L + 1) is
    not a multiple of num_bins the bins are unequal, and the chi-squared
    expectation uses each bin's width."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    all_ranks = {}
    L = None
    for _ in range(int(num_sims)):
        theta, data = prior_fn(generator)
        draws = run_fn(generator, data)
        for name, true_val in theta.items():
            d = _host(draws[name])[::thin]
            if L is None:
                L = d.shape[0]
            rank = (d < _host(true_val)[None]).sum(axis=0)
            all_ranks.setdefault(name, []).append(rank)
    ranks = {n: np.stack(v) for n, v in all_ranks.items()}

    binned = {n: np.floor(r * num_bins / (L + 1)).astype(int)
              for n, r in ranks.items()}
    # floor binning gives unequal bin widths when (L+1) % num_bins != 0;
    # the expectation must use each bin's width or a calibrated sampler
    # fails the test
    widths = np.bincount(
        np.floor(np.arange(L + 1) * num_bins / (L + 1)).astype(int),
        minlength=num_bins)
    expected = num_sims * widths / (L + 1)
    used = expected > 0
    pvalues = {}
    for n, b in binned.items():
        flat = b.reshape(num_sims, -1)
        pv = []
        for c in range(flat.shape[1]):
            counts = np.bincount(flat[:, c], minlength=num_bins)
            stat = float(((counts[used] - expected[used]) ** 2
                          / expected[used]).sum())
            pv.append(_chi2_sf(stat, int(used.sum()) - 1))
        pvalues[n] = np.asarray(pv).reshape(b.shape[1:] or (1,))
    return SBCResult(ranks, num_bins, pvalues)
