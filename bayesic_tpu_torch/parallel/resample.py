"""Systematic resampling, on one device and across the ranks of a mesh
axis.

Counterpart of ``bayesic_tpu/parallel/resample.py``.  ``systematic_
ancestors`` and ``systematic_resample`` work on a whole population.
``systematic_resample_shard_map`` is the explicit choreography over P
ranks that each hold n_local particles: the weights normalised by a
``pmax`` and a ``psum``, a distributed prefix sum (each rank's
compensated cumsum plus Kahan offsets over the all-gathered shard sums),
the positions of the rank's own output slots, and the global ancestors by
``searchsorted`` over the gathered global cumsum.  The payload moves in
one of two ways:

* ``"ring"`` (default): P - 1 ``ppermute`` hops pass one shard-sized
  chunk around the ring, and each rank copies out the rows whose ancestor
  lies in the chunk visiting it: O(n_local * dim) of payload a rank at
  any time (``_ring_route``);
* ``"all_gather"``: every rank gathers the whole payload, O(N * dim) a
  rank; the oracle.

Payload rows are exact copies.  Every weight prefix sum goes through
``compensated_cumsum``: a plain float32 cumsum within blocks of 1024 and
Kahan-compensated block offsets, so the absolute error is bounded by the
block size and not the population size (at 2^20 particles a plain
float32 cumsum drifts past the 1/N spacing of the systematic positions).
One shared uniform u0 places every rank's positions, and the weights are
normalised by the global log-sum-exp as ``normalize_log_weights`` does it,
so with one rank the sharded ancestors are ``systematic_ancestors``' bits.
"""

from __future__ import annotations

import torch

from ..infer.svi.svi import tree_map
from .mesh import all_gather, axis_index, axis_size, pmax, ppermute, psum

__all__ = ["normalize_log_weights", "effective_sample_size",
           "compensated_cumsum", "systematic_ancestors",
           "systematic_resample", "systematic_resample_shard_map"]


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


def _ring_route(particles_local, src_shard, src_row, mesh, axis):
    """Each rank's output row j is row ``src_row[j]`` of rank
    ``src_shard[j]``'s ``particles_local`` (a tensor or a dict of tensors
    with a leading axis of n_local rows).  The chunks pass P - 1 hops around
    the ring (``ppermute`` with JAX's shift); after t hops a rank holds
    the chunk of coordinate (me + t) mod P and copies out the rows whose
    ancestor lies there.  Every rank makes the same hops whatever its
    ancestors, so the collectives stay symmetric."""
    p, me = axis_size(mesh, axis), axis_index(mesh, axis)
    chunk = particles_local
    out = tree_map(torch.zeros_like, particles_local)
    for t in range(p):
        mask = src_shard == (me + t) % p

        def copy(o, c):
            m = mask.reshape(mask.shape + (1,) * (o.dim() - 1))
            return torch.where(m, c[src_row], o)

        out = tree_map(copy, out, chunk)
        if t < p - 1:
            chunk = ppermute(chunk, mesh, axis)
    return out


def systematic_resample_shard_map(mesh, axis, routing="ring"):
    """The resampler over the ranks of ``mesh``'s ``axis``: returns
    ``fn(u0, lw_local, particles_local) -> (particles_out_local,
    ancestors_local)``, where ``u0`` is the one shared uniform (a number or
    a one-element tensor, equal on every rank), ``lw_local`` the rank's
    (n_local,) log-weights, ``particles_local`` a tensor or a dict of
    tensors of n_local rows, and ``ancestors_local`` the global indices of
    the ancestors of the rank's output rows.  ``routing`` is ``"ring"``
    or ``"all_gather"`` (see the module docstring)."""
    if routing not in ("ring", "all_gather"):
        raise ValueError(f"unknown routing {routing!r}")

    def fn(u0, lw_local, particles_local):
        n_local = lw_local.shape[0]
        p, me = axis_size(mesh, axis), axis_index(mesh, axis)
        n_global = n_local * p
        dev = lw_local.device
        # normalise by the global log-sum-exp, as logsumexp computes it:
        # the max (pmax), then the log of the sum of exp (psum)
        gmax = pmax(torch.amax(lw_local, 0, keepdim=True), mesh, axis)
        total = psum(torch.sum(torch.exp(lw_local - gmax), 0, keepdim=True),
                     mesh, axis)
        w = torch.exp(lw_local - (torch.log(total) + gmax))
        # the distributed prefix sum: Kahan offsets over the shard sums
        sums = all_gather(torch.sum(w, 0, keepdim=True), mesh, axis)
        local_cum = _kahan_exclusive_cumsum(sums)[me] + compensated_cumsum(w)
        cum = all_gather(local_cum, mesh, axis)
        cum = cum / cum[-1]                 # an exact 1.0 endpoint
        u0 = torch.as_tensor(u0, dtype=torch.float32, device=dev).reshape(())
        pos = (torch.arange(n_local, dtype=torch.float32, device=dev)
               + me * n_local + u0) / n_global
        anc = torch.clamp(torch.searchsorted(cum, pos, right=True), 0,
                          n_global - 1)
        if routing == "ring":
            out = _ring_route(particles_local, anc // n_local,
                              anc % n_local, mesh, axis)
        else:
            out = tree_map(lambda x: all_gather(x, mesh, axis)[anc],
                           particles_local)
        return out, anc

    return fn
