"""The cells' inputs, made by the benchmark from ``--seed`` and handed to
the program and to the reference alike.

Frozen copies of the port's DLGM data recipe (``models/dlgm.make_data``)
and of its fused trainer's initial state (``models/dlgm.fused_init``), so
that a change to the program cannot move the inputs.  Data and weights are
drawn on the card from a ``torch.Generator`` seeded from the run's seed,
in a few large calls."""

from __future__ import annotations

import hashlib
import math

import torch

# the fused DLGM trainer's leaves, (in, out) layout
DLGM_LEAVES = ("w1e", "b1e", "wmu", "bmu", "wsig", "bsig",
               "w1d", "b1d", "w2d", "b2d", "usig")


def derive(seed, *labels):
    """A 62-bit seed derived from the run's seed and ``labels``: the same
    run seed gives the same stream for each label, and labels never share
    one."""
    h = hashlib.sha256(repr((int(seed),) + labels).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2


def dlgm_leaf_shapes(d, h, z):
    return {"w1e": (d, h), "b1e": (1, h), "wmu": (h, z), "bmu": (1, z),
            "wsig": (h, z), "bsig": (1, z), "w1d": (z, h), "b1d": (1, h),
            "w2d": (h, d), "b2d": (1, d), "usig": (1, 1)}


def dlgm_data(cfg, seed, device):
    """``(x (N, D), (w1 (Z, H), w2 (H, D)))`` float32: rows of a random
    ground-truth DLGM, x = tanh(z w1) w2 + N(0, 0.3^2) noise, z ~ N(0, I),
    w1 ~ N(0, 1/Z), w2 ~ N(0, 1/H); the truth's biases are zero."""
    n, d = cfg["num_data"], cfg["data_dim"]
    z_dim, h = cfg["latent_dim"], cfg["hidden"]
    g = torch.Generator(device=device).manual_seed(derive(seed, "dlgm_data"))
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    w1 = torch.randn((z_dim, h), **f32) / math.sqrt(z_dim)
    w2 = torch.randn((h, d), **f32) / math.sqrt(h)
    z = torch.randn((n, z_dim), **f32)
    noise = torch.randn((n, d), **f32)
    x = torch.tanh(z @ w1) @ w2 + cfg["obs_scale"] * noise
    return x.contiguous(), (w1, w2)


def dlgm_fused_init(cfg, seed, device):
    """The fused trainer's initial parameters and Adam moments, drawn as
    ``models/dlgm.fused_init`` draws them: weights from a normal truncated
    to [-2, 2] over sqrt(fan_in), zero biases, sigma_x = 0.5.  All weights
    come from one draw on the device."""
    shapes = dlgm_leaf_shapes(cfg["data_dim"], cfg["hidden"],
                              cfg["latent_dim"])
    weights = [k for k in DLGM_LEAVES if k.startswith("w")]
    total = sum(math.prod(shapes[k]) for k in weights)
    g = torch.Generator(device=device).manual_seed(derive(seed, "dlgm_init"))
    flat = torch.empty(total, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    params, o = {}, 0
    for k in DLGM_LEAVES:
        s = shapes[k]
        if k in weights:
            size = math.prod(s)
            params[k] = (flat[o:o + size].view(s) / math.sqrt(s[0]))
            o += size
        elif k == "usig":
            params[k] = torch.full(s, math.log(0.5), device=device)
        else:
            params[k] = torch.zeros(s, device=device)
    params = {k: v.contiguous() for k, v in params.items()}
    return (params, {k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()})
