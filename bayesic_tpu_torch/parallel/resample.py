"""Systematic resampling on one device.

Counterpart of the single-device half of ``bayesic_tpu/parallel/
resample.py`` (the ``shard_map`` choreography across devices is not
ported yet).  Every weight prefix sum goes through ``compensated_cumsum``:
a plain float32 cumsum within blocks of 1024 and Kahan-compensated block
offsets, so the absolute error is bounded by the block size and not the
population size (at 2^20 particles a plain float32 cumsum drifts past the
1/N spacing of the systematic positions).
"""

from __future__ import annotations

import torch

__all__ = ["normalize_log_weights", "effective_sample_size",
           "compensated_cumsum", "systematic_ancestors",
           "systematic_resample"]


def normalize_log_weights(log_weights):
    return log_weights - torch.logsumexp(log_weights, 0)


def effective_sample_size(log_weights):
    """ESS = (sum w)^2 / sum w^2 for unnormalized log weights."""
    lw = normalize_log_weights(log_weights)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0))


def _kahan_exclusive_cumsum(x):
    """Exclusive prefix sum of a short 1-D tensor with Kahan compensation
    (error O(eps), not O(n eps)); a sequential loop over float32 scalars
    kept on x's device."""
    out = torch.empty_like(x)
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    comp = torch.zeros_like(total)
    for i in range(x.shape[0]):
        out[i] = total
        y = x[i] - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return out


def compensated_cumsum(x, block=1024):
    """Inclusive cumulative sum of a 1-D tensor whose absolute error is
    bounded by the block size; for n <= block exactly ``torch.cumsum``."""
    n = x.shape[0]
    if n <= block:
        return torch.cumsum(x, 0)
    pad = (-n) % block
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(-1, block)
    within = torch.cumsum(xb, 1)
    offsets = _kahan_exclusive_cumsum(within[:, -1])
    return (within + offsets[:, None]).reshape(-1)[:n]


def systematic_ancestors(u0, log_weights, num_out=None):
    """Ancestor indices (num_out,) int64 of systematic resampling.

    Positions u_j = (j + u0) / num_out with ONE shared uniform ``u0``: a
    number or a one-element tensor, or a ``torch.Generator`` to draw it
    from.  ancestor_j is the i with C_{i-1} <= u_j < C_i, C the normalized
    weight cumsum with an exact 1.0 endpoint."""
    n = log_weights.shape[0]
    num_out = n if num_out is None else int(num_out)
    dev = log_weights.device
    if isinstance(u0, torch.Generator):
        u0 = torch.rand((), generator=u0, device=u0.device)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=dev).reshape(())
    cum = compensated_cumsum(torch.exp(normalize_log_weights(log_weights)))
    cum = cum / cum[-1]
    pos = (torch.arange(num_out, dtype=torch.float32, device=dev) + u0) \
        / num_out
    return torch.clamp(torch.searchsorted(cum, pos, right=True), 0, n - 1)


def systematic_resample(u0, log_weights, particles, num_out=None):
    """Resample a tensor or a dict of tensors along axis 0; returns
    ``(resampled, ancestors)``."""
    idx = systematic_ancestors(u0, log_weights, num_out)
    if isinstance(particles, dict):
        return {k: v[idx] for k, v in particles.items()}, idx
    return particles[idx], idx
