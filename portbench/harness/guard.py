"""The import guard: the run measures the PyTorch port alone, so JAX and
the JAX package must not be loaded in the process that prints the result.

Names are compared whole by their top-level part (before the first dot):
the port's ``bayesic_tpu_torch`` starts with the JAX package's name and
passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bayesic_tpu"})


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)
