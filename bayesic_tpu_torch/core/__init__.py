"""Model DSL + joint log-prob compiler (discrete enumeration included):
the port of ``bayesic_tpu.core``."""

from . import handlers
from .logjoint import (ModelInfo, Potential, build_logjoint, init_to_prior,
                       init_to_uniform, inspect_model)
from .primitives import deterministic, factor, param, plate, sample
from .render import render_model
from .reparam import LocScaleReparam, Reparam, reparam

__all__ = [
    "handlers",
    "sample",
    "plate",
    "param",
    "deterministic",
    "factor",
    "reparam",
    "Reparam",
    "LocScaleReparam",
    "ModelInfo",
    "Potential",
    "build_logjoint",
    "inspect_model",
    "init_to_prior",
    "init_to_uniform",
    "render_model",
]
