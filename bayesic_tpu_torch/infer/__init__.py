"""Inference backends: SVI, MCMC (NUTS, HMC), SMC, and the predictive
tools (``Predictive``, ``log_likelihood``)."""

from .loglik import log_likelihood
from .predictive import Predictive

__all__ = ["Predictive", "log_likelihood"]
