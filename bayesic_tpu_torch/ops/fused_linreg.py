"""Whole-run fused trainer for the Bayesian linear regression: one launch
runs every SVI step on the exact Gram sufficient statistics.

Counterpart of ``bayesic_tpu/ops/fused_linreg.py``.  Model (known noise s):
``w ~ N(0, I_D)``, ``b ~ N(0, 1)``, ``y ~ N(X w + b, s)``.  With the
columns ``P = [x, 1, y]`` and ``G = P^T P`` ((D+2) x (D+2), ``gram``), the
residual of a draw ``z = (w, b)`` is ``P u`` with ``u = (z, -1)``, so

    sum r^2 = u^T G u

exactly: a step is one (D+2) x (D+2) matvec, whatever N is.

On a CUDA tensor, ``fused_train`` runs the hand-written kernel of
``csrc/fused_linreg.cu``: one persistent thread block runs all ``steps``
steps, its consumer warps holding G in registers and the state of
parameter p in the lanes of row p, its producer warps making each step's
noise and schedule ahead into a ring.  On a CPU tensor it runs the plain
version below (``reference_train``) over the same Philox streams
(``_kernel_common.hier_streams``: lane 1 + p is the noise of parameter p).
Nothing falls back: on a CUDA tensor the kernel runs or the call raises.
``probe_cycles`` runs the kernel's probe instance, which reads the clock at
the phase boundaries of a step.

Layout: the guide's ``loc``/``log_scale`` and the Adam moments are flat
``(D+1,)`` vectors in ``unraveler`` order (w[0..D-1], b), which is the JAX
kernel's lane order; its 128-lane padding and selector masks are not ported
(``interop`` maps the lane vectors).  Mean-field STL ELBO, Adam at the
cosine-decayed rate, as ``SVI(model, MeanFieldGuide,
Adam(cosine_decay_schedule(lr0, T)))`` on ``models/linreg.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..infer.svi.svi import cosine_decay_schedule
from . import _build
from ._kernel_common import adam_leaf, hier_streams, loss_thin, thin_losses

__all__ = ["gram", "init_params", "fused_train", "fused_train_injected",
           "reference_train", "probe_cycles", "MAX_DIM"]

_C = 0.5 * math.log(2.0 * math.pi)
MAX_DIM = 126           # the JAX cap D + 2 <= 128 (MAXD2 of the kernel)
PROBE_PHASES = ("ring wait", "z and u exchange", "matvec and butterfly",
                "loss, gradient and Adam")

# launches of the kernel, through either entry point: one launch runs
# every step of the call
LAUNCHES = 0


def gram(x, y):
    """``G = P^T P`` over the columns ``P = [x, 1, y]``: the Gaussian
    likelihood's sufficient statistic, (D+2, D+2) float32.  Accumulated in
    float64 (the N-row inner products lose digits in float32, and the
    residual quadratic form is a difference of large terms), made exactly
    symmetric, then rounded to float32."""
    p = torch.cat([x.to(torch.float64),
                   torch.ones_like(x[:, :1], dtype=torch.float64),
                   y.to(torch.float64)[:, None]], 1)
    g = p.T @ p
    return (0.5 * (g + g.T)).to(torch.float32)


def init_params(dim, init_scale=0.1, device="cpu"):
    """The guide's init as ``MeanFieldGuide.init`` makes it (loc 0,
    log_scale log(init_scale)) over the D + 1 parameters, and zero Adam
    moments ``(m1, m2, v1, v2)`` (m1/v1 for loc, m2/v2 for log_scale)."""
    p = int(dim) + 1
    loc = torch.zeros(p, device=device)
    ls = torch.full((p,), math.log(init_scale), device=device)
    return loc, ls, tuple(torch.zeros(p, device=device) for _ in range(4))


# ---------------------------------------------------------------------------
# plain step math (the kernel's oracle; the JAX package's hand backward)
# ---------------------------------------------------------------------------

def _step_math(loc, ls, g, n, eps, noise):
    """Full-batch STL ELBO and its gradients (ascent) from the Gram matrix
    ``g`` of N = ``n`` rows.  Returns ``(elbo, g_loc, g_ls)``; runs in the
    dtype of its inputs (the tests hold the kernel against float64)."""
    inv_s2 = 1.0 / (noise * noise)
    e_ls = torch.exp(ls)
    z = loc + e_ls * eps
    u = torch.cat([z, -torch.ones_like(z[:1])])      # residual coefficients
    gu = g @ u
    ll = -0.5 * inv_s2 * torch.sum(u * gu) - n * (math.log(noise) + _C)
    lp = torch.sum(-0.5 * z * z - _C)
    logq = torch.sum(-ls - 0.5 * eps * eps - _C)
    g_z = (-inv_s2) * gu[:-1] - z + eps * torch.exp(-ls)
    return ll + lp - logq, g_z, g_z * eps * e_ls


def reference_train(g, n, noise, loc, ls, opt_state, *, eps_stream, lr0,
                    lr_total, t0=0):
    """The plain ``_step_math`` + Adam over injected noise ``(steps, D+1)``.
    Returns ``(loc, ls, (m1, m2, v1, v2), losses (steps,))``, one loss per
    step — the kernel's parity oracle."""
    lr_at = cosine_decay_schedule(lr0, lr_total)
    m1, m2, v1, v2 = opt_state
    losses = []
    for i in range(eps_stream.shape[0]):
        elbo, g_loc, g_ls = _step_math(loc, ls, g, n, eps_stream[i], noise)
        t = t0 + i
        loc, m1, v1 = adam_leaf(loc, m1, v1, g_loc, t + 1, lr_at(t))
        ls, m2, v2 = adam_leaf(ls, m2, v2, g_ls, t + 1, lr_at(t))
        losses.append(-elbo)
    return loc, ls, (m1, m2, v1, v2), torch.stack(losses)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _check(g, loc, ls, opt_state):
    d2 = g.shape[0]
    if g.dim() != 2 or g.shape[1] != d2 or g.dtype != torch.float32:
        raise ValueError("g must be a float32 (D+2, D+2) Gram matrix")
    if not 3 <= d2 <= MAX_DIM + 2:
        raise ValueError(f"the kernel takes 1 <= D <= {MAX_DIM}; got "
                         f"D={d2 - 2}")
    for name, t in (("loc", loc), ("ls", ls)) + tuple(
            zip(("m1", "m2", "v1", "v2"), opt_state)):
        if tuple(t.shape) != (d2 - 1,) or t.dtype != torch.float32 \
                or t.device != g.device:
            raise ValueError(f"{name}: want float32 ({d2 - 1},) on "
                             f"{g.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    return d2 - 2


def _launch(g, n, noise, loc, ls, opt_state, *, steps, lr0, lr_total, t0,
            thin, seed, eps, probe=None):
    global LAUNCHES
    d = _check(g, loc, ls, opt_state)
    lib = _build.load()
    state = [t.clone() for t in (loc, ls, *opt_state)]
    losses = torch.empty(-(-steps // thin), dtype=torch.float32,
                         device=g.device)
    ptr = lambda t: ctypes.c_void_p(None if t is None  # noqa: E731
                                    else t.data_ptr())
    args = (ptr(g.contiguous()), *map(ptr, state), ptr(losses), ptr(eps), d,
            int(steps), int(t0), int(thin), float(lr0), int(lr_total),
            float(1.0 / (noise * noise)), float(n * (math.log(noise) + _C)),
            int(seed) & 0xFFFFFFFFFFFFFFFF)
    with torch.cuda.device(g.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(g.device).cuda_stream)
        if probe is None:
            err = lib.fused_linreg_train(*args, stream)
        else:
            err = lib.fused_linreg_probe(*args, ptr(probe), stream)
    if err != 0:
        raise RuntimeError(f"fused_linreg kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    if probe is None:
        LAUNCHES += 1
    return state[0], state[1], tuple(state[2:]), losses


def fused_train(g, n, noise, loc, ls, opt_state=None, *, steps, lr0,
                lr_total=None, seed=0, t0=0):
    """Run ``steps`` fused full-batch linreg ELBO steps on the Gram matrix
    ``g = gram(x, y)`` of ``n`` rows.

    ``opt_state`` ``(m1, m2, v1, v2)``, zeros if None; ``t0`` the global
    step count already taken (the schedule, the bias correction and the
    Philox counter continue from it).  Returns ``(loc, ls, opt_state,
    losses)``, losses thinned to at most 2048 entries by the JAX kernel's
    rule.  CUDA tensors run the kernel with in-kernel Philox streams; CPU
    tensors run ``reference_train`` over the same streams."""
    steps = int(steps)
    lr_total = int(lr_total if lr_total is not None else steps)
    if opt_state is None:
        opt_state = tuple(torch.zeros_like(loc) for _ in range(4))
    if g.device.type == "cuda":
        return _launch(g, n, noise, loc, ls, opt_state, steps=steps, lr0=lr0,
                       lr_total=lr_total, t0=t0, thin=loss_thin(steps),
                       seed=seed, eps=None)
    if g.device.type != "cpu":
        raise ValueError(f"fused_train: unsupported device {g.device}")
    eps = hier_streams(seed, t0, steps, 1, loc.numel())[1]
    loc, ls, opt, losses = reference_train(
        g, n, noise, loc, ls, opt_state, eps_stream=eps, lr0=lr0,
        lr_total=lr_total, t0=t0)
    return loc, ls, opt, thin_losses(losses, steps)


def fused_train_injected(g, n, noise, loc, ls, opt_state, *, eps_stream,
                         lr0, lr_total, t0=0):
    """The kernel with injected noise ``(steps, D+1)`` (the parity entry);
    one loss per step."""
    steps = int(eps_stream.shape[0])
    if g.device.type == "cuda":
        if tuple(eps_stream.shape) != (steps, loc.numel()) \
                or eps_stream.device != g.device:
            raise ValueError("eps_stream must be (steps, D+1) on g's device")
        return _launch(g, n, noise, loc, ls, opt_state, steps=steps, lr0=lr0,
                       lr_total=lr_total, t0=t0, thin=1, seed=0,
                       eps=eps_stream.to(torch.float32).contiguous())
    if g.device.type != "cpu":
        raise ValueError(f"fused_train_injected: unsupported device "
                         f"{g.device}")
    return reference_train(g, n, noise, loc, ls, opt_state,
                           eps_stream=eps_stream, lr0=lr0, lr_total=lr_total,
                           t0=t0)


def probe_cycles(g, n, noise, loc, ls, opt_state=None, *, steps, lr0,
                 lr_total=None, seed=0, t0=0):
    """Run ``fused_train``'s work through the kernel's probe instance (CUDA
    tensors only; not counted in ``LAUNCHES``) and return the clock cycles
    of one step on consumer thread 0: ``{"phases": {name: mean cycles}
    (PROBE_PHASES), "sampled": steps sampled (every 16th from step 32
    on), "loop": mean cycles a step over the whole loop}``.  The stamps
    wait for the value each phase ends on, so the sampled steps run
    slower than the others."""
    if g.device.type != "cuda":
        raise ValueError("probe_cycles reads the card's clock: it needs "
                         "CUDA tensors")
    steps = int(steps)
    if opt_state is None:
        opt_state = tuple(torch.zeros_like(loc) for _ in range(4))
    probe = torch.zeros(6, dtype=torch.int64, device=g.device)
    _launch(g, n, noise, loc, ls, opt_state, steps=steps, lr0=lr0,
            lr_total=int(lr_total if lr_total is not None else steps), t0=t0,
            thin=loss_thin(steps), seed=seed, eps=None, probe=probe)
    c = probe.cpu().tolist()
    k = max(c[4], 1)
    return {"phases": {name: c[i] / k for i, name in enumerate(PROBE_PHASES)},
            "sampled": c[4], "loop": c[5] / steps}
