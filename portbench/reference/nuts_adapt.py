"""Plain reference of NUTS's warm-up as Stan runs it, for one pooled
step size and one diagonal mass shared by all chains: the chains'
initial points, the window schedule, dual averaging (Hoffman and Gelman
2014, section 3.2) and the windowed variance.

* Initial points: uniform on (-2, 2) in the unconstrained space, from the
  chains' open uniforms u: 2 (2 u - 1).
* Windows: a fast buffer of 75 transitions, slow windows of 25 doubling
  each time, a fast buffer of 50 at the end; where those do not fit, 15%
  and 10% of the warm-up for the buffers and the rest for one slow
  window; a window that the next (twice as long) would not fit beside
  takes the rest of the slow span.  Fewer than 20 transitions: none.
* Dual averaging: a transition runs at exp(x); after it, with a the mean
  accept statistic over all chains, t += 1, H = (1 - 1/(t + t0)) H +
  (delta - a)/(t + t0), x = mu - sqrt(t) H / gamma, xbar = t^-kappa x +
  (1 - t^-kappa) xbar, with delta 0.8, gamma 0.05, t0 10, kappa 0.75 and
  mu = log(10 eps0).  The end of a slow window restarts it from exp(x).
  Sampling runs at exp(xbar).
* Mass: at the end of a slow window the inverse mass is the variance of
  that window's draws over all chains, shrunk as Stan does: n / (n + 5)
  var + 1e-3 * 5 / (n + 5), n the window's draws.

Float64 unless the caller asks for the control's precision."""

from __future__ import annotations

import math

import torch

TARGET, GAMMA, T0, KAPPA = 0.8, 0.05, 10.0, 0.75


def initial_points(u, dtype=torch.float64):
    u = u.to(dtype)
    return 2.0 * (2.0 * u - 1.0)


def windows(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """The slow windows' ``(start, end)`` transitions."""
    if num_warmup < 20:
        return []
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.1 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    out, start, size, last = [], init_buffer, base_window, \
        num_warmup - term_buffer
    while start < last:
        end = min(start + size, last)
        if end + 2 * size > last:
            end = last
        out.append((start, end))
        start, size = end, 2 * size
    return out


def dual_averaging(accept_means, num_warmup, eps0, dtype=torch.float64):
    """The step size of each warm-up transition (W,) and the sampling
    step size, from each transition's mean accept statistic (W,)."""
    ends = {end - 1 for _, end in windows(num_warmup)}
    a = accept_means.detach().to("cpu", dtype)

    def start(eps):
        z = torch.zeros((), dtype=dtype)
        return dict(x=torch.log(eps), xbar=z, h=z, t=z,
                    mu=math.log(10.0) + torch.log(eps))

    s = start(torch.tensor(eps0, dtype=dtype))
    steps = []
    for t in range(num_warmup):
        steps.append(torch.exp(s["x"]))
        s["t"] = s["t"] + 1.0
        eta = 1.0 / (s["t"] + T0)
        s["h"] = (1.0 - eta) * s["h"] + eta * (TARGET - a[t])
        s["x"] = s["mu"] - torch.sqrt(s["t"]) / GAMMA * s["h"]
        w = s["t"] ** -KAPPA
        s["xbar"] = w * s["x"] + (1.0 - w) * s["xbar"]
        if t in ends:
            s = start(torch.exp(s["x"]))
    return torch.stack(steps), torch.exp(s["xbar"])


def window_variance(draws, dtype=torch.float64):
    """The regularized inverse mass (D,) from a window's draws (n, D)."""
    x = draws.to(dtype)
    n = x.shape[0]
    var = torch.sum((x - torch.mean(x, 0)) ** 2, 0) / max(n - 1, 1)
    return n / (n + 5.0) * var + 1e-3 * (5.0 / (n + 5.0))
