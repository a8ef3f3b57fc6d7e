"""SVI backend: the STL, IWAE and DReG ELBOs, mean-field, full-rank,
low-rank, flow, amortized and DSL-authored guides, the Adam loop."""

from .elbo import draw_subsample, make_elbo
from .flows import FlowGuide
from .guides import (FullRankGuide, Guide, LowRankGuide, MeanFieldGuide,
                     NeuralGuide, TraceGuide, unraveler)
from .svi import (SVI, Adam, AdamState, SVIResult, SVIState,
                  cosine_decay_schedule)

__all__ = [
    "SVI", "SVIResult", "SVIState", "Adam", "AdamState",
    "cosine_decay_schedule", "make_elbo", "draw_subsample",
    "Guide", "MeanFieldGuide", "FullRankGuide", "LowRankGuide", "FlowGuide",
    "NeuralGuide", "TraceGuide", "unraveler",
]
