"""Particle resampling (the single-device half of
``bayesic_tpu.parallel``)."""

from .resample import (compensated_cumsum, effective_sample_size,
                       normalize_log_weights, systematic_ancestors,
                       systematic_resample)

__all__ = ["normalize_log_weights", "effective_sample_size",
           "compensated_cumsum", "systematic_ancestors",
           "systematic_resample"]
