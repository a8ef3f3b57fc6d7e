"""Inference backends: SVI, MCMC (NUTS, HMC, elliptical slice, parallel
tempering, NUTS within Gibbs), SMC, SG-MCMC, MAP/Laplace, SVGD,
Pathfinder, ``infer_discrete`` and the predictive tools (``Predictive``,
``log_likelihood``)."""

from .discrete import infer_discrete
from .laplace import Laplace, MAPResult, map_estimate
from .loglik import log_likelihood
from .pathfinder import PathfinderResult, pathfinder
from .predictive import Predictive
from .sgmcmc import SGMCMC, SGMCMCResult
from .svgd import SVGD, SVGDResult

__all__ = ["Laplace", "MAPResult", "PathfinderResult", "Predictive",
           "SGMCMC", "SGMCMCResult", "SVGD", "SVGDResult", "infer_discrete",
           "log_likelihood", "map_estimate", "pathfinder"]
