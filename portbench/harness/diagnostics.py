"""Bulk multi-chain ESS and split-R-hat: a frozen copy of the port's
``utils/diagnostics`` (Stan's multi-chain rho-hat with Geyer's initial
monotone sequence, autocovariances by one batched FFT), so that the NUTS
metric's yardstick does not move when the program's copy is edited."""

from __future__ import annotations

import math

import torch


def _autocovariance(x):
    """Biased autocovariance along axis 1 of (chains, n, ...), by FFT."""
    x = torch.movedim(x, 1, -1)
    n = x.shape[-1]
    x = x - torch.mean(x, -1, keepdim=True)
    m = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(x, m, -1)
    acov = torch.fft.irfft(f * torch.conj(f), m, -1)[..., :n] / n
    return torch.movedim(acov, -1, 1)


def ess(x):
    """ESS of ``x`` (chains, draws, ...) per trailing coordinate."""
    m, n = x.shape[0], x.shape[1]
    acov = _autocovariance(x)
    mean_acov = torch.mean(acov, 0)
    chain_var = acov[:, 0] * n / (n - 1.0)
    w = torch.mean(chain_var, 0)
    var_plus = mean_acov[0] * n / (n - 1.0)
    if m > 1:
        var_plus = w * (n - 1.0) / n + torch.var(torch.mean(x, 1), 0,
                                                 correction=1)
    rho = 1.0 - (w - mean_acov) / var_plus
    rho[0] = 1.0
    pairs = n // 2
    p = rho[0:2 * pairs:2] + rho[1:2 * pairs:2]
    positive = torch.cumprod((p > 0).to(p.dtype), 0)
    p_mono = torch.cummin(torch.where(positive > 0, p, math.inf), 0).values
    p_used = torch.where(positive > 0, torch.minimum(p, p_mono), 0.0)
    tau = -1.0 + 2.0 * torch.sum(p_used, 0)
    tau = torch.clamp(tau, min=1.0 / math.log10(n + 1.0))
    return m * n / tau


def split_rhat(x):
    """Split-R-hat of ``x`` (chains, draws, ...) per trailing coordinate."""
    n = x.shape[1]
    half = n // 2
    halves = torch.cat([x[:, :half], x[:, half:2 * half]], 0)
    w = torch.mean(torch.var(halves, 1, correction=1), 0)
    b = half * torch.var(torch.mean(halves, 1), 0, correction=1)
    var_plus = (half - 1.0) / half * w + b / half
    return torch.sqrt(var_plus / w)
