"""Posterior diagnostics: ESS, split-R-hat, MCSE, summaries.

Counterpart of ``bayesic_tpu/utils/diagnostics.py``.  Autocovariances come
from one batched real FFT (``torch.fft``); Geyer's initial monotone
sequence is a cumulative product and a cumulative minimum, with no
data-dependent control flow, so everything runs on the device that holds
the samples and only the caller's scalars cross to the host.
"""

from __future__ import annotations

import math
import sys

import torch

__all__ = ["autocovariance", "ess", "split_rhat", "mcse", "summary",
           "print_summary"]


def autocovariance(x, axis=-1):
    """Biased autocovariance along ``axis`` via FFT, normalized by n."""
    x = torch.movedim(torch.as_tensor(x), axis, -1)
    n = x.shape[-1]
    x = x - torch.mean(x, -1, keepdim=True)
    # zero-pad to >= 2n for linear (non-circular) correlation
    m = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(x, m, -1)
    acov = torch.fft.irfft(f * torch.conj(f), m, -1)[..., :n] / n
    return torch.movedim(acov, -1, axis)


def ess(x):
    """Effective sample size of ``x`` shaped (n_chains, n_samples, ...)
    with Stan's multi-chain rho_hat and Geyer's initial monotone positive
    truncation.  Returns ESS with shape ``x.shape[2:]``.  As in the JAX
    package (and Stan), ESS can exceed the draw count for antithetic
    chains: tau is floored at 1/log10(n), not at 1."""
    x = torch.as_tensor(x)
    if x.dim() == 1:
        x = x[None]
    m, n = x.shape[0], x.shape[1]
    acov = autocovariance(x, axis=1)              # (m, n, ...)
    mean_acov = torch.mean(acov, 0)               # (n, ...)
    chain_var = acov[:, 0] * n / (n - 1.0)        # (m, ...)
    w = torch.mean(chain_var, 0)
    mean_per_chain = torch.mean(x, 1)             # (m, ...)
    var_plus = mean_acov[0] * n / (n - 1.0)
    if m > 1:
        b_over_n = torch.var(mean_per_chain, 0, correction=1)
        var_plus = w * (n - 1.0) / n + b_over_n
    rho = 1.0 - (w - mean_acov) / var_plus        # (n, ...)
    rho[0] = 1.0

    # Geyer pairs P_t = rho_{2t} + rho_{2t+1}
    n_pairs = n // 2
    p = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]   # (n_pairs, ...)
    # initial positive sequence: keep while all pairs so far > 0
    positive = torch.cumprod((p > 0).to(p.dtype), 0)
    # monotone decreasing envelope
    p_mono = torch.cummin(torch.where(positive > 0, p, math.inf), 0).values
    p_used = torch.where(positive > 0, torch.minimum(p, p_mono), 0.0)
    tau = -1.0 + 2.0 * torch.sum(p_used, 0)
    tau = torch.clamp(tau, min=1.0 / math.log10(n + 1.0))
    return m * n / tau


def split_rhat(x):
    """Split-R-hat (potential scale reduction) of ``x`` shaped
    (n_chains, n_samples, ...).  Values near 1 indicate convergence."""
    x = torch.as_tensor(x)
    m, n = x.shape[0], x.shape[1]
    half = n // 2
    halves = torch.cat([x[:, :half], x[:, half:2 * half]], 0)
    nn = half
    mean_c = torch.mean(halves, 1)
    var_c = torch.var(halves, 1, correction=1)
    w = torch.mean(var_c, 0)
    b = nn * torch.var(mean_c, 0, correction=1)
    var_plus = (nn - 1.0) / nn * w + b / nn
    return torch.sqrt(var_plus / w)


def mcse(x):
    """Monte-Carlo standard error of the posterior mean."""
    x = torch.as_tensor(x)
    sd = torch.std(x, dim=(0, 1), correction=1)
    return sd / torch.sqrt(ess(x))


def summary(samples_dict):
    """Per-site posterior summary: mean, std, mcse, ess, split_rhat.
    Input tensors are shaped (n_chains, n_samples, *event)."""
    out = {}
    for name, x in samples_dict.items():
        x = torch.as_tensor(x)
        out[name] = {
            "mean": torch.mean(x, (0, 1)),
            "std": torch.std(x, dim=(0, 1), correction=1),
            "mcse": mcse(x),
            "ess": ess(x),
            "rhat": split_rhat(x),
        }
    return out


def print_summary(samples_dict, file=None):
    """Readable per-site posterior table (mean, std, mcse, ess, r-hat)."""
    out = file or sys.stdout
    stats = summary(samples_dict)
    header = f"{'site':<16}{'mean':>10}{'std':>10}{'mcse':>10}" \
             f"{'ess':>9}{'rhat':>7}"
    print(header, file=out)
    print("-" * len(header), file=out)
    for name, st in stats.items():
        cols = [torch.atleast_1d(st[k]).reshape(-1).cpu()
                for k in ("mean", "std", "mcse", "ess", "rhat")]
        mean, std, mcse_v, essv, rh = cols
        for i in range(mean.shape[0]):
            label = name if mean.shape[0] == 1 else f"{name}[{i}]"
            print(f"{label:<16}{float(mean[i]):>10.3f}"
                  f"{float(std[i]):>10.3f}{float(mcse_v[i]):>10.4f}"
                  f"{float(essv[i]):>9.0f}{float(rh[i]):>7.3f}", file=out)
    return stats
