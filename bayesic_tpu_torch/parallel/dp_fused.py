"""Data-parallel composition of the whole-run fused trainers.

Counterpart of ``bayesic_tpu/parallel/dp_fused.py``.  The fused trainers
(``ops/fused_{linreg,hier,vae}.py``) run a whole training segment in one
kernel launch, so a gradient all-reduce every step would mean leaving the
kernel every step.  Two compositions instead, each one collective a
segment:

1. **Distributed sufficient statistics** (linreg): the Gram matrix is
   additive over row shards, so ``dp_gram`` all-reduces the ranks' local
   Grams once (a (D+2)^2 matrix on the wire, not the rows) and every rank
   then trains the same replicated state on it.  Exact: the estimator does
   not change.

2. **Segment-averaged local SGD** (hier, DLGM: any mini-batch trainer):
   each rank runs a fused segment on its local rows with the likelihood
   scaled to the global size (``n_total``), then the parameters and the
   Adam moments are averaged over the ranks, and the next segment starts
   from the average.  Each rank's gradient is an unbiased estimate of the
   full ELBO's (uniform local batches at the global scale over randomly
   sharded rows), so this is parallel SGD with periodic model averaging.
   The segment length trades bias for communication, and it bites on
   hierarchical scale parameters: between averages each rank drifts toward
   the posterior of its shard, and averaging the location parameters of a
   correlated (funnel) posterior is not averaging the posterior.  The JAX
   package measured on hier-logistic (8 shards, 4k steps) that segments of
   at most 10 steps reproduce the single-device optimum (log tau within
   0.07) and segments of 20 or more bias log tau by about +0.8, while mu
   and beta stay right; ``segment_averaged_train`` enforces that limit.

Rows are shuffled once and then sharded in contiguous blocks
(``mesh.local_slice``), since the hier trainer takes contiguous blocks at
an offset.  The collectives are ``mesh.psum``/``pmean``: one flat buffer a
segment for the whole state.
"""

from __future__ import annotations

import warnings

import torch

from ..ops.fused_linreg import gram64, gram_round
from .mesh import axis_index, axis_size, pmean, psum

__all__ = ["MAX_HIER_SEGMENT_STEPS", "dp_gram", "segment_averaged_train",
           "replicated_train"]

# Measured-safe segment length for models with hierarchical scale sites
# (hier-logistic, 8 shards, 4k steps: segments <= 10 reproduce the
# single-device optimum with log tau within 0.07; segments >= 20 bias
# log tau by about +0.8).  Enforced by segment_averaged_train below.
MAX_HIER_SEGMENT_STEPS = 10


def dp_gram(x_local, y_local, mesh, axis="data"):
    """The Gram matrix of every rank's rows: each rank's float64 ``P^T P``
    of its ``x_local``, ``y_local`` (``fused_linreg.gram64``), summed over
    ``axis`` in float64, then made symmetric and rounded to float32 as
    ``fused_linreg.gram`` does.  Equal to the Gram of all rows up to the
    order of the float64 sums."""
    return gram_round(psum(gram64(x_local, y_local), mesh, axis))


def _check_segments(sps, hierarchical_scales, allow_biased_segments):
    if sps <= MAX_HIER_SEGMENT_STEPS or allow_biased_segments:
        return
    if hierarchical_scales:
        raise ValueError(
            f"steps_per_segment={sps} exceeds the measured-safe "
            f"{MAX_HIER_SEGMENT_STEPS} for models with hierarchical "
            "scale sites: segment-averaged DP biases the scale posterior "
            "upward (~+0.8 in log-tau at >=20-step segments on "
            "hier-logistic).  Shorten the segments, or pass "
            "allow_biased_segments=True to accept the bias.")
    if hierarchical_scales is None:
        warnings.warn(
            f"steps_per_segment={sps} > {MAX_HIER_SEGMENT_STEPS}: if this "
            "model has hierarchical scale sites the averaged posterior scale "
            "will be biased (see dp_fused docstring).  Declare "
            "hierarchical_scales=True/False to silence this.",
            UserWarning, stacklevel=3)


def segment_averaged_train(local_train, state, data_local, mesh, *,
                           segments, steps_per_segment, seed=0,
                           axis="data", hierarchical_scales=None,
                           allow_biased_segments=False):
    """Run ``segments`` x ``steps_per_segment`` fused steps under
    segment-averaged data parallelism, on every rank of ``axis``.

    ``local_train(data_local, state, seed, t0) -> (state, losses)`` runs
    one fused segment on this rank's rows; it scales its likelihood with
    the GLOBAL data size (the fused trainers' ``n_total``).  Segment ``s``
    on rank ``r`` of S gets the seed ``(seed + s + 1) * S + r`` (its own
    streams) and ``t0 = s * steps_per_segment``.  ``state`` is the whole
    tree to average (parameters and optimizer moments).  Returns
    ``(state, losses)``, the losses averaged over the ranks and
    concatenated over the segments.

    Bias guard: long segments on a model with hierarchical scale sites
    bias the scale upward (module docstring).  ``hierarchical_scales``:

    * ``True``: a segment longer than ``MAX_HIER_SEGMENT_STEPS`` raises,
      unless ``allow_biased_segments=True`` (the caller accepts the bias).
    * ``False``: no cap (plain MLP/VAE objectives take long segments).
    * ``None`` (default): a long segment warns, asking to declare.
    """
    n_dev, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    segments, sps = int(segments), int(steps_per_segment)
    _check_segments(sps, hierarchical_scales, allow_biased_segments)
    losses = []
    for s in range(segments):
        state, seg_losses = local_train(data_local, state,
                                        (int(seed) + s + 1) * n_dev + idx,
                                        s * sps)
        state, seg_losses = pmean((state, seg_losses), mesh, axis)
        losses.append(seg_losses)
    return state, torch.cat(losses)


def replicated_train(local_train, state, data, mesh, *, seed=0,
                     axis="data"):
    """The choreography's check: every rank runs ``local_train`` on the
    same ``data`` with the same seed and t0 0, then the state is averaged
    as ``segment_averaged_train`` averages it.  The losses equal one
    process's run bit for bit, the state up to the rounding of the
    average."""
    state, losses = local_train(data, state, int(seed), 0)
    return pmean(state, mesh, axis), losses
