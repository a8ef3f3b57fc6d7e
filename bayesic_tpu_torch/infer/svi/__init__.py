"""SVI backend: STL ELBO, amortized, mean-field and full-rank guides, Adam
driver."""

from .elbo import draw_subsample, make_elbo
from .guides import (FullRankGuide, Guide, MeanFieldGuide, NeuralGuide,
                     unraveler)
from .svi import (SVI, Adam, AdamState, SVIResult, SVIState,
                  cosine_decay_schedule)

__all__ = [
    "SVI", "SVIResult", "SVIState", "Adam", "AdamState",
    "cosine_decay_schedule", "make_elbo", "draw_subsample", "Guide",
    "MeanFieldGuide", "FullRankGuide", "NeuralGuide", "unraveler",
]
