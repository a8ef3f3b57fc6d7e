"""Data-parallel SVI with one hand-placed gradient all-reduce a step.

Counterpart of ``bayesic_tpu/parallel/dp.py``.  Every rank runs the same
steps on its shard of the rows, with the same guide noise (each rank's
``generator`` is seeded alike), and the replicated parameters and Adam
state stay identical because every rank applies the same summed gradient:

    elbo        = E_q[ log_lik(data) + log_prior - log q ]
    local elbo  = E_q[ log_lik(local shard) + (log_prior - log q) / S ]
    elbo        = sum over ranks of the local elbo      (S = axis size)

so ``grad(elbo)`` is the all-reduced sum of the local gradients, and each
rank's backward pass touches only its own rows.

Scope: the model's likelihood is a plain sum over the leading (sharded)
axis of the ``model_args`` arrays, and the model subsamples no plate (the
shard does not hold the global rows a subsample indexes).  Guides whose
sample depends on the rows (the DLGM's amortized guide) shard inside the
model instead: ``models/dlgm.run_svi(data_sharding=)``.  The port's
``SVI`` has no IWAE or DReG estimator, so there is none to refuse here.
"""

from __future__ import annotations

import torch

from ..infer.svi.svi import (SVIResult, SVIState, _tree_unflatten,
                             tree_leaves, tree_map)
from .mesh import axis_size, psum

__all__ = ["dp_svi_run"]


def dp_svi_run(svi, mesh, generator, local_args, num_steps, axis="data",
               state=None, stl=True):
    """Run ``num_steps`` data-parallel SVI steps of ``svi`` on this rank's
    ``local_args`` (the model_args tuple, each array this rank's rows).

    ``generator`` starts the run (``svi.init``) unless ``state`` continues
    one; every rank passes one seeded alike.  Returns an ``SVIResult``
    whose losses are the global negative ELBOs, as ``SVI.run(generator,
    num_steps, model_args=all rows)`` gives them up to the order of fp32
    sums."""
    if svi.info.has_subsample:
        raise ValueError("dp_svi_run: the model subsamples a plate; a rank "
                         "holds only its shard of the rows the subsample "
                         "indexes")
    n_shards = axis_size(mesh, axis)
    if state is None:
        state = svi.init(generator)
    parts = svi.logdensity.parts
    ctx = {"subsample": None, "model_args": local_args, "eps": None}

    def local_loss(params, gen):
        gp, mp = svi._split_params(params)
        u, logq = svi.guide.sample_and_log_prob(
            gp, gen, (svi.num_particles,), stop_gradient_q=stl, ctx=ctx)
        contrib = []
        for i in range(svi.num_particles):
            lp, ll = parts({k: v[i] for k, v in u.items()},
                           model_args=local_args, params=mp)
            contrib.append(ll + lp / n_shards)
        return -torch.mean(torch.stack(contrib) - logq / n_shards)

    losses = []
    for _ in range(int(num_steps)):
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state.params)
        loss = local_loss(params, state.key)
        grads = _tree_unflatten(params, torch.autograd.grad(
            loss, tree_leaves(params)))
        grads = psum(grads, mesh, axis)
        if svi.grad_transform is not None:
            grads = svi.grad_transform(grads)
        new_params, opt_state = svi.optimizer.update(grads, state.opt_state,
                                                     state.params)
        state = SVIState(new_params, opt_state, state.key, state.step + 1)
        losses.append(loss.detach())
    # the global losses: one collective for the whole run
    losses = psum(torch.stack(losses), mesh, axis)
    return SVIResult(state.params, losses, state)
