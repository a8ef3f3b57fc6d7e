"""JAX parameters, given as numpy arrays, -> the port's parameters.

The JAX package keeps flax ``Dense`` kernels as (in, out); ``nn.Linear``
keeps its weight as (out, in), so every kernel is transposed here.  The
fused trainer's leaves keep (in, out) on both sides and map one to one.
Pass pytrees through ``jax.tree.map(np.asarray, tree)`` first; this module
imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "state_dict_to_flax", "svi_params",
           "fused_leaves", "adam_state"]


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
