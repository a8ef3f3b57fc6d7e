"""Whole-run fused trainer for the hierarchical-logistic SVI workload: one
launch runs every SVI step.

Counterpart of ``bayesic_tpu/ops/fused_hier.py``.  On a CUDA tensor,
``fused_train`` runs the hand-written kernel of ``csrc/fused_hier.cu``: one
persistent thread block holds the guide's parameters and Adam state in
registers and runs all ``steps`` steps, reading the mini-batch rows from
device memory (the whole data set stays in L2).  On a CPU tensor it runs
the plain version below (``reference_train``) over the same Philox streams
(``_kernel_common.hier_streams``).  Nothing falls back: on a CUDA tensor
the kernel runs or the call raises.

Semantics match ``SVI(make_model(...), MeanFieldGuide,
Adam(cosine_decay_schedule(lr0, T)))`` on ``models/hier_logistic.py``
(non-centered), except that each mini-batch is a circular block of ``B``
rows at a uniform offset of the once-shuffled data (every row has the same
marginal, so the gradient stays unbiased), as in the JAX package.

Layout: ``x (N, F)``, ``y (N,)`` (0/1 as float32), ``group (N,)`` int32;
the guide's ``loc``/``log_scale`` and the Adam moments are flat ``(P,)``
vectors, P = 2 + J + F, in the order (mu, log tau, theta_raw[J],
beta[F]).  The TPU's 128-lane packing, one-hot group columns and selector
matrices are not ported (``interop`` maps the JAX lane vectors).

Math (s = n_total/B, c = 0.5 ln 2 pi, q = N(loc, e^ls), z = loc + e^ls eps):

    logit_r = mu + tau theta_raw[g_r] + x_r . beta,   tau = e^{z_1}
    elbo = s sum_r(y l - softplus(l)) + [-mu^2/50 - ln 5 - c]
           + [-tau^2/8 - c + ln tau] + sum(-theta^2/2 - c)
           + sum(-beta^2/2 - c) - sum(-ls - eps^2/2 - c)

with the STL gradient (q's parameters stopped inside log q).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..infer.svi.svi import cosine_decay_schedule
from . import _build
from ._kernel_common import adam_leaf, hier_streams, thin_losses
from ._kernel_common import loss_thin as _thin

__all__ = ["fused_train", "fused_train_injected", "reference_train",
           "init_params", "MAX_FEATURES"]

_C = 0.5 * math.log(2.0 * math.pi)
# the HalfNormal(2) log density's constant: ln 2 - ln 2 - c
_TAU_CONST = 0.5 * math.log(2.0 / math.pi) - math.log(2.0)
MAX_FEATURES = 8        # MAXF of csrc/fused_hier.cu
_MAX_THREADS = 1024     # NT: one parameter per thread

# launches of the kernel, through either entry point: one launch runs
# every step of the call
LAUNCHES = 0


def init_params(num_groups, num_features, init_scale=0.1, device="cpu"):
    """The guide's init as ``MeanFieldGuide.init`` makes it (loc 0,
    log_scale log(init_scale)) and zero Adam moments ``(m1, m2, v1, v2)``
    (m1/v1 for loc, m2/v2 for log_scale)."""
    p = 2 + int(num_groups) + int(num_features)
    loc = torch.zeros(p, device=device)
    ls = torch.full((p,), math.log(init_scale), device=device)
    return loc, ls, tuple(torch.zeros(p, device=device) for _ in range(4))


# ---------------------------------------------------------------------------
# plain step math (the kernel's oracle; the JAX package's hand backward)
# ---------------------------------------------------------------------------

def _step_math(loc, ls, xb, yb, gb, eps, scale, num_groups):
    """One STL ELBO step on the rows ``xb (B, F)``, ``yb (B,)``, ``gb (B,)``.
    Returns ``(elbo, g_loc, g_ls)``, gradients of the elbo (ascent)."""
    j = int(num_groups)
    e_ls = torch.exp(ls)
    z = loc + e_ls * eps
    mu, ltau = z[0], z[1]
    tau = torch.exp(ltau)
    th, be = z[2:2 + j], z[2 + j:]
    logits = mu + tau * th[gb] + xb @ be
    ll = torch.sum(yb * logits - torch.clamp(logits, min=0.0)
                   - torch.log1p(torch.exp(-torch.abs(logits))))
    lp = (-mu * mu / 50.0 - math.log(5.0) - _C + _TAU_CONST
          - tau * tau / 8.0 + ltau
          + torch.sum(-0.5 * th * th - _C) + torch.sum(-0.5 * be * be - _C))
    logq = torch.sum(-ls - 0.5 * eps * eps - _C)
    elbo = scale * ll + lp - logq

    gl = scale * (yb - torch.sigmoid(logits))          # d elbo / d logit
    seg = torch.zeros(j, dtype=gl.dtype, device=gl.device) \
        .index_add_(0, gb.long(), gl)                  # per-group sums
    g_z = torch.cat([
        (torch.sum(gl) - mu / 25.0).reshape(1),
        (tau * torch.sum(th * seg) - tau * tau / 4.0 + 1.0).reshape(1),
        tau * seg - th,
        xb.T @ gl - be,
    ])
    g_z = g_z + eps * torch.exp(-ls)                   # STL: -d logq / dz
    return elbo, g_z, g_z * eps * e_ls


def _block(x, y, group, off, batch):
    idx = (off + torch.arange(batch, device=x.device)) % x.shape[0]
    return x[idx], y[idx], group[idx]


def reference_train(x, y, group, loc, ls, opt_state, *, off_stream,
                    eps_stream, lr0, lr_total, batch, t0=0, n_total=None):
    """The plain ``_step_math`` + Adam over injected block offsets
    ``(steps,)`` and noise ``(steps, P)``, J = P - 2 - F.  Returns
    ``(loc, ls, (m1, m2, v1, v2), losses (steps,))`` — the kernel's parity
    oracle."""
    n = x.shape[0]
    j = loc.numel() - 2 - x.shape[1]
    scale = float(n_total if n_total is not None else n) / batch
    y = y.to(torch.float32)
    lr_at = cosine_decay_schedule(lr0, lr_total)
    m1, m2, v1, v2 = opt_state
    losses = []
    for i in range(off_stream.shape[0]):
        xb, yb, gb = _block(x, y, group, int(off_stream[i]), batch)
        elbo, g_loc, g_ls = _step_math(loc, ls, xb, yb, gb, eps_stream[i],
                                       scale, j)
        t = t0 + i
        loc, m1, v1 = adam_leaf(loc, m1, v1, g_loc, t + 1, lr_at(t))
        ls, m2, v2 = adam_leaf(ls, m2, v2, g_ls, t + 1, lr_at(t))
        losses.append(-elbo)
    return loc, ls, (m1, m2, v1, v2), torch.stack(losses)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _check(x, y, group, loc, ls, opt_state, batch):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("x must be a float32 (N, F) tensor")
    n, f = x.shape
    p = loc.numel()
    j = p - 2 - f
    if j < 1:
        raise ValueError(f"loc holds {p} values; want 2 + J + F with F={f}")
    for name, t in (("y", y), ("group", group)):
        if tuple(t.shape) != (n,) or t.device != x.device:
            raise ValueError(f"{name} must be ({n},) on {x.device}")
    for name, t in (("loc", loc), ("ls", ls)) + tuple(
            zip(("m1", "m2", "v1", "v2"), opt_state)):
        if tuple(t.shape) != (p,) or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"{name}: want float32 ({p},) on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= batch <= n:
        raise ValueError(f"batch must be in 1..{n}")
    if f > MAX_FEATURES or p > _MAX_THREADS:
        raise ValueError(f"the kernel takes F <= {MAX_FEATURES} and "
                         f"2 + J + F <= {_MAX_THREADS}; got F={f}, J={j}")
    return n, f, j


def _launch(x, y, group, loc, ls, opt_state, *, steps, lr0, lr_total, batch,
            t0, n_total, thin, seed, off, eps):
    global LAUNCHES
    n, f, j = _check(x, y, group, loc, ls, opt_state, batch)
    lib = _build.load()
    if lib.fused_hier_smem_bytes(f, j) == 0:
        raise ValueError(f"J={j} too large for one block's shared memory")
    state = [t.clone() for t in (loc, ls, *opt_state)]
    x = x.contiguous()
    yf = y.to(torch.float32).contiguous()
    g32 = group.to(torch.int32).contiguous()
    if int(g32.min()) < 0 or int(g32.max()) >= j:
        raise ValueError(f"group ids must lie in 0..{j - 1}")
    losses = torch.empty(-(-steps // thin), dtype=torch.float32,
                         device=x.device)
    ptr = lambda t: ctypes.c_void_p(None if t is None  # noqa: E731
                                    else t.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_hier_train(
            ptr(x), ptr(yf), ptr(g32), *map(ptr, state), ptr(losses),
            ptr(off), ptr(eps), n, f, j, int(batch), int(steps), int(t0),
            int(thin), float(lr0), int(lr_total),
            float((n_total if n_total is not None else n) / batch),
            int(seed) & 0xFFFFFFFFFFFFFFFF, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_hier kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    LAUNCHES += 1
    return state[0], state[1], tuple(state[2:]), losses


def fused_train(x, y, group, loc, ls, opt_state=None, *, steps, lr0,
                lr_total=None, seed=0, batch=1024, t0=0, n_total=None):
    """Run ``steps`` fused hier-logistic ELBO steps.

    ``x``/``y``/``group`` already shuffled row-wise once (the block
    mini-batch contract); ``opt_state`` ``(m1, m2, v1, v2)``, zeros if
    None; ``t0`` the global step count already taken (the schedule, the
    bias correction and the Philox counter continue from it);
    ``n_total`` the global data size for the likelihood scale (defaults
    to N).  Returns ``(loc, ls, opt_state, losses)``, losses thinned to at
    most 2048 entries by the JAX kernel's rule.  CUDA tensors run the
    kernel with in-kernel Philox streams; CPU tensors run
    ``reference_train`` over the same streams."""
    steps = int(steps)
    lr_total = int(lr_total if lr_total is not None else steps)
    if opt_state is None:
        opt_state = tuple(torch.zeros_like(loc) for _ in range(4))
    thin = _thin(steps)
    if x.device.type == "cuda":
        return _launch(x, y, group, loc, ls, opt_state, steps=steps,
                       lr0=lr0, lr_total=lr_total, batch=batch, t0=t0,
                       n_total=n_total, thin=thin, seed=seed, off=None,
                       eps=None)
    if x.device.type != "cpu":
        raise ValueError(f"fused_train: unsupported device {x.device}")
    off, eps = hier_streams(seed, t0, steps, x.shape[0], loc.numel())
    loc, ls, opt, losses = reference_train(
        x, y, group, loc, ls, opt_state, off_stream=off, eps_stream=eps,
        lr0=lr0, lr_total=lr_total, batch=batch, t0=t0, n_total=n_total)
    return loc, ls, opt, thin_losses(losses, steps)


def fused_train_injected(x, y, group, loc, ls, opt_state, *, off_stream,
                         eps_stream, lr0, lr_total, batch, t0=0,
                         n_total=None):
    """The kernel with injected block offsets ``(steps,)`` and noise
    ``(steps, P)`` (the parity entry); one loss per step."""
    steps = int(off_stream.shape[0])
    if x.device.type == "cuda":
        p = loc.numel()
        if tuple(eps_stream.shape) != (steps, p) \
                or eps_stream.device != x.device \
                or off_stream.device != x.device:
            raise ValueError("eps_stream must be (steps, P) and off_stream "
                             "(steps,), both on x's device")
        off = off_stream.to(torch.int32).contiguous()
        if steps and (int(off.min()) < 0 or int(off.max()) >= x.shape[0]):
            raise ValueError("off_stream out of range")
        return _launch(x, y, group, loc, ls, opt_state, steps=steps,
                       lr0=lr0, lr_total=lr_total, batch=batch, t0=t0,
                       n_total=n_total, thin=1, seed=0, off=off,
                       eps=eps_stream.to(torch.float32).contiguous())
    if x.device.type != "cpu":
        raise ValueError(f"fused_train_injected: unsupported device "
                         f"{x.device}")
    return reference_train(x, y, group, loc, ls, opt_state,
                           off_stream=off_stream, eps_stream=eps_stream,
                           lr0=lr0, lr_total=lr_total, batch=batch, t0=t0,
                           n_total=n_total)
