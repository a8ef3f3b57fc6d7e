"""Model DSL + joint log-prob compiler (the DLGM path's subset)."""

from . import handlers
from .logjoint import ModelInfo, build_logjoint, inspect_model
from .primitives import param, plate, sample

__all__ = [
    "handlers",
    "sample",
    "plate",
    "param",
    "ModelInfo",
    "build_logjoint",
    "inspect_model",
]
