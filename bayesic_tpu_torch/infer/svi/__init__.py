"""SVI backend: STL ELBO, amortized guide, Adam driver."""

from .elbo import draw_subsample, make_elbo
from .guides import Guide, NeuralGuide, unraveler
from .svi import SVI, Adam, AdamState, SVIResult, SVIState

__all__ = [
    "SVI", "SVIResult", "SVIState", "Adam", "AdamState", "make_elbo",
    "draw_subsample", "Guide", "NeuralGuide", "unraveler",
]
