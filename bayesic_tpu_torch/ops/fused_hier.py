"""Whole-run fused trainer for the hierarchical-logistic SVI workload: one
launch runs every SVI step.

Counterpart of ``bayesic_tpu/ops/fused_hier.py``.  On a CUDA tensor,
``fused_train`` runs the hand-written kernel of ``csrc/fused_hier.cu``: one
persistent thread block whose producer warps make each step's offset,
noise, schedule and rows-by-group lists ahead and stage its rows in shared
memory, while its consumer warps hold the guide's parameters and Adam state
in registers and run the steps' dependent chain.  The wrapper lays the rows
out once a call for the copy (``pack_rows``).  On a CPU tensor it runs the
plain version below (``reference_train``) over the same Philox streams
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
           "init_params", "pack_rows", "geometry", "probe_cycles",
           "MAX_FEATURES", "PROBE_PHASES"]

_C = 0.5 * math.log(2.0 * math.pi)
# the HalfNormal(2) log density's constant: ln 2 - ln 2 - c
_TAU_CONST = 0.5 * math.log(2.0 / math.pi) - math.log(2.0)
MAX_FEATURES = 8        # MAXF of csrc/fused_hier.cu
_MAX_PARAMS = 1024      # MAXP: 2 + J + F
TILE = 32               # rows a tile of pack_rows' layout
# the probe instance's phases of a step (fused_hier_probe)
PROBE_PHASES = ("z and barrier 1", "row pass", "warp sums", "slot wait",
                "barrier 2", "group and total sums", "Adam and exps")

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
    if f > MAX_FEATURES or p > _MAX_PARAMS:
        raise ValueError(f"the kernel takes F <= {MAX_FEATURES} and "
                         f"2 + J + F <= {_MAX_PARAMS}; got F={f}, J={j}")
    return n, f, j


def pack_rows(x, y, group, batch):
    """The rows as the kernel copies them: ``(ntile, F + 2, 32)`` float32,
    tile c holding the rows at positions 32 c .. 32 c + 31 of the data read
    circularly (position q is row q mod N), as F planes of x, one of
    ``y + 2 group`` and one of the tile's group order (int32 bits): its
    rows sorted by group (stable), word l describes position l of that
    order: the lane of its row (bits 0-4), the first position of its
    group's segment (bits 5-9), bit 10 set where l ends the segment, its
    group (bits 11-20) and the scan rounds the tile's longest segment
    needs, ceil log2 of its length (from bit 21).  A window of ``batch``
    rows at any offset is one run of whole tiles, with its first row at
    lane ``offset % 32`` of its first tile; ``ntile`` covers every
    window."""
    n, f = x.shape
    ntile = (n + batch - 2) // TILE + 1
    idx = torch.arange(ntile * TILE, device=x.device) % n
    g = group.to(torch.int32)[idx]
    yg = g * 2 + y.to(torch.int32)[idx]
    gs, lane = torch.sort(g.view(ntile, TILE), dim=1, stable=True)
    pos = torch.arange(TILE, device=x.device).expand(ntile, TILE)
    first = torch.ones_like(gs, dtype=torch.bool)
    first[:, 1:] = gs[:, 1:] != gs[:, :-1]
    last = torch.ones_like(first)
    last[:, :-1] = first[:, 1:]
    head = torch.cummax(torch.where(first, pos, 0), dim=1).values
    # the scan rounds of the tile's longest segment: ceil(log2 length)
    span = (pos - head + 1).max(dim=1, keepdim=True).values
    rounds = torch.ceil(torch.log2(span.to(torch.float32))).to(torch.int32)
    order = (lane.to(torch.int32) | (head.to(torch.int32) << 5)
             | (last.to(torch.int32) << 10) | (gs << 11) | (rounds << 21))
    cols = torch.cat([x[idx].to(torch.float32),
                      yg.view(torch.float32)[:, None],
                      order.reshape(-1).view(torch.float32)[:, None]], 1)
    return cols.view(ntile, TILE, f + 2).transpose(1, 2).contiguous()


def geometry(num_features, num_groups, batch):
    """The kernel's launch at (F, J, B) (``fused_hier_geometry``):
    ``{"threads", "smem_bytes", "instance": "staged" (the rows copied into
    shared memory) or "l2" (read from L2)}`` (CUDA only: it loads the
    library)."""
    out = (ctypes.c_longlong * 3)()
    err = _build.load().fused_hier_geometry(int(num_features),
                                            int(num_groups), int(batch), out)
    if err != 0:
        raise ValueError(f"no fused_hier instance takes F={num_features}, "
                         f"J={num_groups}, B={batch}")
    return {"threads": out[0], "smem_bytes": out[1],
            "instance": "staged" if out[2] else "l2"}


def _launch(x, y, group, loc, ls, opt_state, *, steps, lr0, lr_total, batch,
            t0, n_total, thin, seed, off, eps, probe=None):
    global LAUNCHES
    n, f, j = _check(x, y, group, loc, ls, opt_state, batch)
    lib = _build.load()
    geometry(f, j, batch)
    state = [t.clone() for t in (loc, ls, *opt_state)]
    g32 = group.to(torch.int32)
    bad_group, bad_y = torch.stack([((g32 < 0) | (g32 >= j)).any(),
                                    ((y != 0) & (y != 1)).any()]).tolist()
    if bad_group:
        raise ValueError(f"group ids must lie in 0..{j - 1}")
    if bad_y:
        raise ValueError("y must hold 0/1 labels")
    tiles = pack_rows(x, y, g32, batch)
    losses = torch.empty(-(-steps // thin), dtype=torch.float32,
                         device=x.device)
    ptr = lambda t: ctypes.c_void_p(None if t is None  # noqa: E731
                                    else t.data_ptr())
    args = (ptr(tiles), *map(ptr, state), ptr(losses), ptr(off), ptr(eps),
            n, f, j, int(batch), int(steps), int(t0), int(thin),
            float(lr0), int(lr_total),
            float((n_total if n_total is not None else n) / batch),
            int(seed) & 0xFFFFFFFFFFFFFFFF)
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream)
        err = (lib.fused_hier_train(*args, stream) if probe is None
               else lib.fused_hier_probe(*args, ptr(probe), stream))
    if err != 0:
        raise RuntimeError(f"fused_hier kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    if probe is None:
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


def probe_cycles(x, y, group, loc, ls, opt_state=None, *, steps, lr0,
                 lr_total=None, seed=0, batch=1024, t0=0, n_total=None):
    """Run ``fused_train``'s work through the kernel's probe instance (CUDA
    tensors and a shape whose rows are staged; not counted in
    ``LAUNCHES``) and return the clock cycles of one step on consumer
    thread 2, theta_0's owner: ``{"phases": {name: mean cycles}
    (PROBE_PHASES), "sampled": steps sampled (every 16th from step 8 on),
    "loop": mean cycles a step over the whole loop}``.  The stamps wait for
    the value each phase ends on, so the sampled steps run slower than the
    others."""
    if x.device.type != "cuda":
        raise ValueError("probe_cycles reads the card's clock: it needs "
                         "CUDA tensors")
    steps = int(steps)
    if opt_state is None:
        opt_state = tuple(torch.zeros_like(loc) for _ in range(4))
    probe = torch.zeros(len(PROBE_PHASES) + 2, dtype=torch.int64,
                        device=x.device)
    _launch(x, y, group, loc, ls, opt_state, steps=steps, lr0=lr0,
            lr_total=int(lr_total if lr_total is not None else steps),
            batch=batch, t0=t0, n_total=n_total, thin=_thin(steps),
            seed=seed, off=None, eps=None, probe=probe)
    c = probe.cpu().tolist()
    k = max(c[len(PROBE_PHASES)], 1)
    return {"phases": {name: c[i] / k for i, name in enumerate(PROBE_PHASES)},
            "sampled": c[len(PROBE_PHASES)],
            "loop": c[len(PROBE_PHASES) + 1] / steps}
