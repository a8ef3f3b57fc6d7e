"""Checkpoints of a run's state: one ``.npz`` keyed by tree paths.

Counterpart of ``bayesic_tpu/utils/checkpoint.py``, in the same file
layout: a leaf's key is its path through the tree, dict keys, sequence
positions and NamedTuple field names joined with "/", so a checkpoint the
JAX package wrote for a tree of dicts restores here.  Trees are dicts,
tuples, lists and NamedTuples of tensors, numbers and ``torch.Generator``
s (saved as their state bytes, so a resumed run draws what the
uninterrupted one would).  Restoring needs a target of the same structure
(init, then restore).  In a sharded run only rank 0 writes and every rank
waits for the file at a barrier (``save_multihost``).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save", "restore", "save_multihost"]


def _flatten(tree, path=()):
    """[(path, leaf)] in tree order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _flatten(v, path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k, v in zip(tree._fields, tree)
                for x in _flatten(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path, tree):
    """Write ``tree`` to ``path`` (.npz), atomically: a temporary file in
    the same directory, then a rename."""
    arrays = {key: _to_numpy(leaf) for key, leaf in _flatten(tree)}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _like(arr, leaf, key):
    """``arr`` as a leaf of ``leaf``'s kind, dtype and device."""
    if isinstance(leaf, torch.Generator):
        gen = torch.Generator(device=leaf.device)
        gen.set_state(torch.from_numpy(np.ascontiguousarray(arr)))
        return gen
    if arr.shape != np.shape(_to_numpy(leaf)):
        raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape} != "
                         f"target shape {np.shape(_to_numpy(leaf))}")
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(arr).to(leaf.device, leaf.dtype)
    return type(leaf)(arr.item()) if np.ndim(arr) == 0 else arr


def restore(path, target):
    """Load ``path`` into the structure of ``target``: each leaf takes the
    target leaf's dtype, device and kind (shapes must match)."""
    with np.load(path) as data:
        leaves = []
        for key, leaf in _flatten(target):
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}")
            leaves.append(_like(data[key], leaf, key))
    return _unflatten(target, leaves)


def save_multihost(path, tree):
    """Rank 0 writes; then every rank waits at a barrier, so none reads or
    moves on before the file is complete."""
    multi = dist.is_available() and dist.is_initialized()
    if not multi or dist.get_rank() == 0:
        save(path, tree)
    if multi and dist.get_world_size() > 1:
        dist.barrier()
    return path
