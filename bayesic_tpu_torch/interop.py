"""JAX parameters, given as numpy arrays, <-> the port's parameters.

The JAX package keeps flax ``Dense`` kernels as (in, out); ``nn.Linear``
keeps its weight as (out, in), so every kernel is transposed here.  The
fused DLGM trainer's leaves keep (in, out) on both sides and map one to
one.  The fused hier and linreg trainers' state is (1, 128) lane vectors in
the JAX package (lanes 0 .. P-1 hold the flat parameters, the rest are
padding) and flat (P,) vectors here (P = D + 1 for the linreg, lanes w[0 ..
D-1], b).  The dense MF params are ``{site: (loc, log_scale)}`` on both
sides.  The GMM's SMC particles are (P, dim) rows in
unraveler order (K-1 stick-breaking weights, K*D means, K log-scales) on
both sides; the JAX fused mutation kernel pads them to (P, 128) lanes.
The low-rank, flow and DSL-authored guides' params keep their layouts
(flow kernels (in, out) on both sides); ``tree_to_torch`` takes a dtype,
so a parity test can run both packages in float64.
Pass pytrees through ``jax.tree.map(np.asarray,
tree)`` first; this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "state_dict_to_flax", "svi_params",
           "fused_leaves", "adam_state", "mean_field_params",
           "mean_field_to_jax", "lanes_to_flat", "flat_to_lanes",
           "smc_particles", "mf_dense_params", "mf_dense_to_jax",
           "tree_to_torch", "tree_to_jax"]


def _t(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def flax_to_state_dict(flax_params, device="cpu"):
    """``{"params": {"Dense_i": {"kernel" (in,out), "bias" (out,)}}}`` (or
    the inner dict) -> ``{"Dense_i.weight" (out,in), "Dense_i.bias"}``."""
    layers = flax_params.get("params", flax_params)
    out = {}
    for name, leaf in layers.items():
        out[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).T, device)
        out[f"{name}.bias"] = _t(leaf["bias"], device)
    return out


def state_dict_to_flax(state_dict):
    """Inverse of ``flax_to_state_dict``, as numpy arrays."""
    layers = {}
    for key, value in state_dict.items():
        name, kind = key.rsplit(".", 1)
        a = value.detach().cpu().numpy()
        if kind == "weight":
            layers.setdefault(name, {})["kernel"] = a.T
        else:
            layers.setdefault(name, {})["bias"] = a
    return {"params": layers}


def svi_params(tree, device="cpu"):
    """The JAX DLGM's SVI params ``{"guide": encoder, "model": {"decoder":
    decoder, "sigma_x": unconstrained}}`` -> the port's SVI params."""
    return {
        "guide": flax_to_state_dict(tree["guide"], device),
        "model": {
            "decoder": flax_to_state_dict(tree["model"]["decoder"], device),
            "sigma_x": _t(tree["model"]["sigma_x"], device),
        },
    }


def fused_leaves(leaves, device="cpu"):
    """Fused ``LEAVES`` dict (params, or Adam m or v) -> tensors."""
    return {k: _t(v, device) for k, v in leaves.items()}


def adam_state(count, mu, nu, device="cpu"):
    """optax ``ScaleByAdamState(count, mu, nu)`` of the SVI params -> the
    port's ``AdamState`` (mu and nu converted like ``svi_params``)."""
    from .infer.svi import AdamState

    return AdamState(int(count), svi_params(mu, device),
                     svi_params(nu, device))


def mean_field_params(params, device="cpu"):
    """JAX ``MeanFieldGuide`` params ``{"loc", "log_scale"}`` -> the
    port's (the same flat vectors, as tensors)."""
    return {k: _t(params[k], device) for k in ("loc", "log_scale")}


def mean_field_to_jax(params):
    """Inverse of ``mean_field_params``, as numpy arrays."""
    return {k: params[k].detach().cpu().numpy()
            for k in ("loc", "log_scale")}


def lanes_to_flat(lanes, dim, device="cpu"):
    """JAX fused hier or linreg trainer state, a sequence of (1, 128) lane
    vectors (loc, ls, m1, m2, v1, v2), -> the port's flat (dim,)
    tensors."""
    return tuple(_t(np.asarray(v)[0, :dim], device) for v in lanes)


def flat_to_lanes(flats):
    """The port's flat (P,) tensors -> (1, 128) numpy lane vectors with
    zero padding (the JAX trainer keeps its pad lanes at zero)."""
    out = []
    for v in flats:
        a = np.zeros((1, 128), np.float32)
        a[0, :v.numel()] = v.detach().cpu().numpy()
        out.append(a)
    return tuple(out)


def smc_particles(q, dim, device="cpu"):
    """JAX SMC particles, flat (P, dim) or the fused kernel's lane-padded
    (P, 128), -> the port's (P, dim) tensor (the same unraveler order)."""
    return _t(np.asarray(q)[:, :dim], device)


def mf_dense_params(params, device="cpu"):
    """JAX dense MF params (or Adam moments of them) ``{site: (loc,
    log_scale)}`` -> the port's, tensors of the same shapes."""
    return {site: tuple(_t(v, device) for v in pair)
            for site, pair in params.items()}


def mf_dense_to_jax(params):
    """Inverse of ``mf_dense_params``, as numpy arrays."""
    return {site: tuple(v.detach().cpu().numpy() for v in pair)
            for site, pair in params.items()}


def tree_to_torch(tree, device="cpu", dtype=torch.float32):
    """Nested dicts and lists of numpy arrays -> the same nesting of
    tensors: the JAX ``LowRankGuide`` (``loc``, ``w`` (dim, rank),
    ``log_diag``), ``FlowGuide`` (``loc``, ``log_scale``, ``flows``: kernels
    (in, out) on both sides; the MADE masks are no params, both packages
    build the same ones from the widths) and ``TraceGuide`` (unconstrained,
    one array a ``param`` site) params all keep their layouts."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device, dtype) for v in tree)
    return torch.as_tensor(np.array(tree), dtype=dtype, device=device)


def tree_to_jax(tree):
    """Nested dicts and lists of the port's tensors -> the same nesting of
    numpy arrays (the inverse of ``tree_to_torch``)."""
    if isinstance(tree, dict):
        return {k: tree_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_jax(v) for v in tree)
    return tree.detach().cpu().numpy()

