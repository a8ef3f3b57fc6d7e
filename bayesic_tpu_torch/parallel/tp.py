"""The ``"model"`` mesh axis: parameters and observations split over its
ranks, with every collective placed by hand.

The JAX package uses the axis only through ``NamedSharding`` annotations
(a flax kernel under ``P(None, "model")``, observations or a flat guide
vector under ``P("model")``) and lets XLA place the collectives.  Here each
rank holds its slice, and the three differentiable collectives of
``mesh`` (``enter``, ``gather``, ``reduce``) carry the replicated values
and the gradients between the slices:

* ``shard_params`` / ``gather_params`` move the selected leaves of a
  parameter tree (an ``SVIState`` with its Adam moments too) onto the axis
  and off it.  A torch ``nn.Linear.weight`` (out, in) split on dim 0 is
  the flax kernel (in, out) under ``P(None, "model")``.
* ``sharded_logdensity``: each rank holds its slice of the observations;
  the log-density is the prior plus the sum over the ranks of the local
  likelihoods.
* ``ShardedMeanFieldGuide``: a ``MeanFieldGuide`` whose ``loc`` and
  ``log_scale`` are this rank's slices of the flat vector.  Adam is
  elementwise, so ``SVI.run(..., state=sharded_state)`` runs unchanged on
  the slices.
* ``models/dlgm.run_svi(model_sharding=)`` splits the decoder's two
  kernels by output units (``dlgm.sharded_decoder``).

Every rank computes the same replicated loss, and each replicated leaf's
gradient comes out equal on every rank, so the replicas never drift.
"""

from __future__ import annotations

import torch

from ..infer.svi.guides import _LOG_2PI, MeanFieldGuide
from ..infer.svi.svi import tree_map
from .mesh import (all_gather, axis_index, axis_size, enter, gather,
                   local_slice, reduce)

__all__ = ["shard_params", "gather_params", "sharded_logdensity",
           "ShardedMeanFieldGuide"]


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` on every tensor leaf of nested dicts, lists,
    tuples and named tuples; ``path`` is the tuple of keys, indices and
    field names down to the leaf.  Other leaves (an int, a generator) are
    kept as they are."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def shard_params(tree, mesh, axis, select):
    """This rank's ``local_slice`` of the leading dimension of every tensor
    leaf for which ``select(path, leaf)`` is true (a copy, so the global
    array can be freed); the other leaves stay replicated.  Like JAX's
    ``device_put``, a leaf whose leading dimension the axis does not divide
    raises a ``ValueError``: nothing is padded."""
    size, index = axis_size(mesh, axis), axis_index(mesh, axis)

    def one(path, x):
        if not select(path, x):
            return x
        if x.dim() == 0 or x.shape[0] % size:
            raise ValueError(f"shard_params: leaf {'/'.join(map(str, path))}"
                             f" of shape {tuple(x.shape)} does not split "
                             f"over the {size} ranks of {axis!r}")
        start, per = local_slice(x.shape[0], size, index)
        return x[start:start + per].clone()

    return _map_with_path(one, tree)


def gather_params(tree, mesh, axis, select):
    """Inverse of ``shard_params``: every selected leaf (this rank's slice)
    all-gathered along its leading dimension."""
    return _map_with_path(
        lambda path, x: all_gather(x, mesh, axis) if select(path, x) else x,
        tree)


def sharded_logdensity(info, logdensity, mesh, axis="model"):
    """``build_logjoint``'s ``(info, logdensity)`` over observations split
    along ``axis``: returns ``f(uparams, model_args, params=None, **kw)``,
    where ``model_args`` hold this rank's slice of the observations, whose
    value is the log-density of all of them, the same on every rank:

        f = reduce(local likelihood + prior / P)      (P = axis size)

    one replay a rank, the prior counted once in the sum.  The latents and
    ``params`` (replicated) enter through ``enter``, so their gradient is
    the all-reduce of the ranks' parts, as ``jax.grad`` of the sharded JAX
    log-density gives it.  A model that subsamples a plate is refused: a
    rank holds only its slice of the rows the subsample indexes."""
    if info.has_subsample:
        raise ValueError("sharded_logdensity: the model subsamples a plate; "
                         "a rank holds only its slice of the rows the "
                         "subsample indexes")
    n = axis_size(mesh, axis)

    def fn(uparams, model_args=(), params=None, **kw):
        def ent(x):
            return enter(x, mesh, axis)

        if params is not None:
            params = tree_map(ent, params)
        lp, ll = logdensity.parts(tree_map(ent, uparams),
                                  model_args=model_args, params=params, **kw)
        return reduce(ll + lp / n, mesh, axis)

    return fn


class ShardedMeanFieldGuide(MeanFieldGuide):
    """``MeanFieldGuide`` over the flat unconstrained vector, its ``loc`` and
    ``log_scale`` split along ``axis``: each rank holds its ``local_slice``
    of the two (``shard_params`` of a ``MeanFieldGuide``'s params gives the
    same).  Every rank draws the whole noise from a generator seeded alike
    (or reads the whole of ``ctx["eps"]``) and keeps its slice, so the draws
    equal the replicated guide's; the flat draw is ``gather``-ed before
    ``unravel`` and log q is the ``reduce`` of the local sums.  The vector's
    size must split over the axis (no padding)."""

    def __init__(self, info, mesh, axis="model", init_scale=0.1):
        super().__init__(info, init_scale)
        self.mesh, self.axis = mesh, axis
        self.start, self.per = local_slice(
            self.dim, axis_size(mesh, axis), axis_index(mesh, axis))

    def _local(self, x):
        return x[..., self.start:self.start + self.per]

    def init(self, generator, loc=None):
        return {k: self._local(v).clone()
                for k, v in super().init(generator, loc).items()}

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        shape = tuple(sample_shape) + (self.dim,)
        eps = (ctx or {}).get("eps")
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=generator.device)
        else:
            eps = eps.expand(shape)
        loc, ls = params["loc"], params["log_scale"]
        flat = loc + torch.exp(ls) * self._local(eps)
        if stop_gradient_q:
            loc, ls = loc.detach(), ls.detach()
        z = (flat - loc) * torch.exp(-ls)
        logq = torch.sum(-0.5 * z * z - ls - 0.5 * _LOG_2PI, -1)
        return (self.unravel(gather(flat, self.mesh, self.axis, dim=-1)),
                reduce(logq, self.mesh, self.axis))

    def entropy(self, params):
        return reduce(torch.sum(params["log_scale"]), self.mesh, self.axis) \
            + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def stats(self, params):
        """Unconstrained-space posterior mean/std per site (gathered)."""
        loc, ls = (all_gather(params[k], self.mesh, self.axis)
                   for k in ("loc", "log_scale"))
        return self.unravel(loc), self.unravel(torch.exp(ls))
