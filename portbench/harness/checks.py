"""Comparisons that decide ``correct``, shared by the job modules.  Each
compared number goes out as ``{"name", "value", "limit"}``; a run is
correct when every value is finite and at most its limit."""

from __future__ import annotations

import math

import torch


def number(name, value, limit):
    return {"name": name, "value": float(value), "limit": float(limit)}


def all_within(checks):
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks)


def leaf_norm_gap(prog, ref, keep=None):
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger.  ``keep``: the leaves compared (all by default)."""
    keys = list(ref) if keep is None else list(keep)
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = sorted(norms.values())[len(keys) // 2]
    worst = 0.0
    for k in keys:
        gap = abs(float(torch.linalg.vector_norm(prog[k].double()))
                  - norms[k]) / max(norms[k], med)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def moving_leaves(grads, share=1e-3):
    """The leaves whose reference gradient norm is at least ``share`` of
    the median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= share * med]
