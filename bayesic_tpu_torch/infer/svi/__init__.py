"""SVI backend: STL ELBO, amortized and mean-field guides, Adam driver."""

from .elbo import draw_subsample, make_elbo
from .guides import Guide, MeanFieldGuide, NeuralGuide, unraveler
from .svi import (SVI, Adam, AdamState, SVIResult, SVIState,
                  cosine_decay_schedule)

__all__ = [
    "SVI", "SVIResult", "SVIState", "Adam", "AdamState",
    "cosine_decay_schedule", "make_elbo", "draw_subsample", "Guide",
    "MeanFieldGuide", "NeuralGuide", "unraveler",
]
