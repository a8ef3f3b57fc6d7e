"""Whole-run fused DLGM/VAE trainer: one C call runs every SVI step.

Counterpart of ``bayesic_tpu/ops/fused_vae.py``.  On a CUDA tensor,
``fused_train`` runs the hand-written Hopper kernel in
``csrc/fused_vae.cu``: the data, parameters and Adam state stay on the
device, and one call enqueues all ``steps`` steps on the current stream
with no host sync and no Python between steps.  On a CPU tensor it runs
the plain version below (``reference_train``), which carries the same
hand-derived backward.  Nothing falls back: on a CUDA tensor the kernel
runs or the call raises.

Semantics match ``SVI(model, NeuralGuide, Adam(lr))`` on
``models/dlgm.py``: stick-the-landing single-sample minibatch ELBO with N/B
plate scaling, sigma_x through the Exp bijector, optax-equal Adam.  The
mini-batch is an exact iid with-replacement gather of rows; the TPU
package's "onehot", "loop" and "block" gather modes were workarounds for
the TPU compiler and are not ported.

``compute_dtype="bfloat16"`` (the JAX kernel's ``mm_dtype=bfloat16``)
rounds every product's operands to bf16 and multiplies them with float32
accumulation; parameters, Adam state and all elementwise math stay
float32.  On a CUDA tensor it runs the kernel's bf16 instance, on a CPU
tensor the plain version in the same mode (the JAX package's interpret
path ignores the mode; this one does not).

Math (B=batch, D=data dim, H=hidden, Z=latent, s=N/B, sigma=exp(usig)):

    h1  = tanh(xb W1e + b1e)          mu = h1 Wmu + bmu
    ls  = clip(h1 Wsig + bsig, -6, 3)  z = mu + e^ls eps,  eps~N(0,1)
    hd  = tanh(z W1d + b1d)           mx = hd W2d + b2d
    elbo = s * [ sum(-.5 z^2 - c) + sum(-.5((xb-mx)/sig)^2 - ln sig - c)
                 - sum(-ls - .5 eps^2 - c) ]          (c = .5 ln 2pi)

Parameter leaves keep the JAX package's (in, out) layout.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils.metrics import named_scope
from . import _build
from ._kernel_common import adam_leaf, thin_losses
from ._kernel_common import loss_thin as _thin

_C = 0.5 * math.log(2.0 * math.pi)

# parameter leaf order, fixed (the kernel's flat buffer follows it)
LEAVES = ("w1e", "b1e", "wmu", "bmu", "wsig", "bsig",
          "w1d", "b1d", "w2d", "b2d", "usig")

# calls of the kernel's C entry, through either entry point: one per call,
# though each call packs the weights once (a memset and a launch) and
# enqueues three kernels (rows, split-K A^T G tiles, the partial sums and
# Adam) for every one of its steps; LAUNCHES counts the float32 instance,
# LAUNCHES_BF16 the bf16 one
LAUNCHES = 0
LAUNCHES_BF16 = 0

COMPUTE_DTYPES = ("float32", "bfloat16")

_ROWS = 8          # the batch a CUDA call takes is a multiple of this


class FusedVAEDims(NamedTuple):
    n: int
    d: int
    h: int
    z: int
    b: int


def leaf_shapes(dims: FusedVAEDims):
    d, h, z = dims.d, dims.h, dims.z
    return {
        "w1e": (d, h), "b1e": (1, h), "wmu": (h, z), "bmu": (1, z),
        "wsig": (h, z), "bsig": (1, z), "w1d": (z, h), "b1d": (1, h),
        "w2d": (h, d), "b2d": (1, d), "usig": (1, 1),
    }


# ---------------------------------------------------------------------------
# plain step math (the kernel's oracle; same hand-derived backward as JAX)
# ---------------------------------------------------------------------------

def _is_bf16(compute_dtype):
    """Whether ``compute_dtype`` names the bf16 mode; raises on a name
    that is neither mode."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    return compute_dtype == "bfloat16"


def _step_math(params, xb, eps, scale, compute_dtype="float32"):
    """One STL ELBO step on a gathered batch.  Returns (elbo, grads) where
    grads[k] = d elbo / d params[k] (ascent direction), all hand-derived.

    ``compute_dtype="bfloat16"`` rounds each product's operands to bf16
    (to nearest even) and multiplies them in float32 (a product of two bf16
    values is exact in float32); the elementwise math stays float32."""
    (w1e, b1e, wmu, bmu, wsig, bsig, w1d, b1d, w2d, b2d, usig) = params
    csum = lambda a: torch.sum(a, dim=0, keepdim=True)  # noqa: E731
    if _is_bf16(compute_dtype):
        def cv(a):
            return a.to(torch.bfloat16).to(torch.float32)
    else:
        def cv(a):
            return a

    def mm(a, b):
        return cv(a) @ cv(b)

    # forward
    h1 = torch.tanh(mm(xb, w1e) + b1e)                 # (B,H)
    mu = mm(h1, wmu) + bmu                             # (B,Z)
    pre = mm(h1, wsig) + bsig
    ls = torch.clamp(pre, -6.0, 3.0)                   # (B,Z)
    e_ls = torch.exp(ls)
    zl = mu + e_ls * eps                               # (B,Z)
    hd = torch.tanh(mm(zl, w1d) + b1d)                 # (B,H)
    mx = mm(hd, w2d) + b2d                             # (B,D)
    u = usig[0, 0]
    inv_s2 = torch.exp(-2.0 * u)
    r = mx - xb
    prior = torch.sum(-0.5 * zl * zl - _C)
    lik = torch.sum(-0.5 * r * r * inv_s2 - u - _C)
    logq = torch.sum(-ls - 0.5 * eps * eps - _C)
    elbo = scale * (prior + lik - logq)

    # backward (d elbo; STL: d(-logq)/dz = + eps e^{-ls})
    g_mx = -scale * r * inv_s2                         # (B,D)
    g_usig = (scale * torch.sum(r * r * inv_s2 - 1.0)).reshape(1, 1)
    g_w2d = mm(hd.T, g_mx)
    g_b2d = csum(g_mx)
    g_hd = mm(g_mx, w2d.T)
    g_a1d = g_hd * (1.0 - hd * hd)
    g_w1d = mm(zl.T, g_a1d)
    g_b1d = csum(g_a1d)
    g_z = (mm(g_a1d, w1d.T) - scale * zl
           + scale * eps * torch.exp(-ls))             # (B,Z)
    clip_mask = ((pre > -6.0) & (pre < 3.0)).to(torch.float32)
    # STL stops q-params inside logq, so ls gets gradient only through the
    # z = mu + e^ls eps path
    g_pre = g_z * eps * e_ls * clip_mask
    g_wmu = mm(h1.T, g_z)
    g_bmu = csum(g_z)
    g_wsig = mm(h1.T, g_pre)
    g_bsig = csum(g_pre)
    g_h1 = mm(g_z, wmu.T) + mm(g_pre, wsig.T)
    g_a1e = g_h1 * (1.0 - h1 * h1)
    g_w1e = mm(xb.T, g_a1e)
    g_b1e = csum(g_a1e)

    grads = (g_w1e, g_b1e, g_wmu, g_bmu, g_wsig, g_bsig,
             g_w1d, g_b1d, g_w2d, g_b2d, g_usig)
    return elbo, grads


def _adam(params, m, v, grads, t, lr):
    """optax.adam over all leaves (adam_leaf is the single-leaf update)."""
    out = [adam_leaf(p, mm_, vv_, g, t, lr)
           for p, mm_, vv_, g in zip(params, m, v, grads)]
    return (tuple(o[0] for o in out), tuple(o[1] for o in out),
            tuple(o[2] for o in out))


def _flatten(tree, device=None):
    return [torch.as_tensor(tree[k], dtype=torch.float32, device=device)
            for k in LEAVES]


def _scale(n, b, n_total):
    """The likelihood's plate scale: the global data size over the batch
    (``n_total``, for a shard of a larger data set) or the local one."""
    return (int(n_total) if n_total else n) / b


def reference_train(x, params, m, v, *, idx_stream, eps_stream, lr, t0=0,
                    n_total=None, compute_dtype="float32"):
    """Run the plain ``_step_math`` + ``_adam`` over injected (steps, B)
    index and (steps, B, Z) noise streams.  Returns (params, m, v, losses
    (steps,)) — the kernel's parity oracle.  ``n_total``: the global data
    size when x is one shard of it (None: x's own); ``compute_dtype``: the
    products' mode (see ``_step_math``)."""
    _is_bf16(compute_dtype)
    n = x.shape[0]
    b = idx_stream.shape[1]
    scale = _scale(n, b, n_total)
    p = tuple(_flatten(params, x.device))
    mm = tuple(_flatten(m, x.device))
    vv = tuple(_flatten(v, x.device))
    losses = []
    for i in range(idx_stream.shape[0]):
        xb = x[idx_stream[i]]
        elbo, grads = _step_math(p, xb, eps_stream[i], scale,
                                 compute_dtype)
        p, mm, vv = _adam(p, mm, vv, grads, float(t0 + i + 1), lr)
        losses.append(-elbo)
    return (dict(zip(LEAVES, p)), dict(zip(LEAVES, mm)),
            dict(zip(LEAVES, vv)), torch.stack(losses))


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _check(x, params, m, v, batch):
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("x must be a float32 (N, D) tensor")
    n, d = x.shape
    h = params["w1e"].shape[1]
    z = params["wmu"].shape[1]
    dims = FusedVAEDims(n, d, h, z, int(batch))
    shapes = leaf_shapes(dims)
    for tree in (params, m, v):
        for k in LEAVES:
            t = tree[k]
            if tuple(t.shape) != shapes[k] or t.dtype != torch.float32 \
                    or t.device != x.device:
                raise ValueError(
                    f"leaf {k!r}: want float32 {shapes[k]} on {x.device}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dims.b % _ROWS:
        raise ValueError(f"batch must be a multiple of {_ROWS} on CUDA")
    return dims


def _pack(tree):
    return torch.cat([tree[k].reshape(-1) for k in LEAVES]).contiguous()


def _unpack(flat, dims):
    shapes = leaf_shapes(dims)
    out, o = {}, 0
    for k in LEAVES:
        size = math.prod(shapes[k])
        out[k] = flat[o:o + size].view(shapes[k])
        o += size
    return out


def _launch(x, params, m, v, dims, *, steps, lr, seed, t0, thin, idx, eps,
            scale, bf16=False):
    """One call of the kernel's C entry (no launch count); ``bf16`` runs
    its bf16 instance.  ``idx``/``eps`` None: in-kernel Philox streams."""
    lib = _build.load()
    x = x.contiguous()
    p, mf, vf = _pack(params), _pack(m), _pack(v)
    losses = torch.empty(-(-steps // thin), dtype=torch.float32,
                         device=x.device)
    scratch = torch.empty(
        lib.fused_vae_scratch_floats(dims.d, dims.h, dims.z, dims.b),
        dtype=torch.float32, device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None  # noqa
                                    else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with named_scope("bayesic.ops.fused_vae.launch"):
            err = lib.fused_vae_train(
                ptr(x), ptr(p), ptr(mf), ptr(vf), ptr(losses), ptr(scratch),
                ptr(idx), ptr(eps), dims.n, dims.d, dims.h, dims.z, dims.b,
                int(steps), int(t0), int(thin), float(lr), float(scale),
                int(seed) & 0xFFFFFFFFFFFFFFFF, int(bool(bf16)),
                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"fused_vae kernel launch failed: CUDA error {err} "
            f"({_build.error_string(err)})")
    return _unpack(p, dims), _unpack(mf, dims), _unpack(vf, dims), losses


def fused_train(x, params, m, v, *, steps, lr, seed, batch=256, t0=0,
                n_total=None, compute_dtype="float32"):
    """Run ``steps`` fused DLGM ELBO steps.

    x (N,D) f32; params/m/v: dicts over LEAVES (see leaf_shapes), on x's
    device; t0: global Adam step count already taken (bias correction and
    the Philox counter continue from it, so successive calls never repeat
    a stream); n_total: the global data size when x is one data-parallel
    shard of it, so the likelihood is scaled by n_total / batch (None: N /
    batch).  Returns (params, m, v, losses), losses thinned to at most
    2048 entries by the JAX kernel's rule.  ``compute_dtype``: "float32"
    or "bfloat16" (each product on operands rounded to bf16; the kernel's
    bf16 instance on a CUDA tensor).

    CUDA tensors run the kernel with in-kernel Philox streams; CPU tensors
    run ``reference_train`` with streams from a ``torch.Generator`` seeded
    from (seed, t0) — a different, equally uniform stream, so the two agree
    in distribution, not bitwise.  Under a profiler the call is the span
    ``bayesic.ops.fused_vae.fused_train``, and on a card its C call the
    child span ``bayesic.ops.fused_vae.launch``.
    """
    global LAUNCHES, LAUNCHES_BF16
    with named_scope("bayesic.ops.fused_vae.fused_train"):
        steps = int(steps)
        thin = _thin(steps)
        bf16 = _is_bf16(compute_dtype)
        if x.device.type == "cuda":
            dims = _check(x, params, m, v, batch)
            out = _launch(x, params, m, v, dims, steps=steps, lr=lr, seed=seed,
                          t0=t0, thin=thin, idx=None, eps=None,
                          scale=_scale(dims.n, dims.b, n_total), bf16=bf16)
            if bf16:
                LAUNCHES_BF16 += 1
            else:
                LAUNCHES += 1
            return out
        if x.device.type != "cpu":
            raise ValueError(f"fused_train: unsupported device {x.device}")
        n = x.shape[0]
        z = params["wmu"].shape[1]
        gen = torch.Generator().manual_seed(
            (int(seed) * 1_000_003 + int(t0)) % (2**63))
        idx = torch.randint(0, n, (steps, int(batch)), generator=gen)
        eps = torch.randn((steps, int(batch), z), generator=gen)
        p, mm, vv, losses = reference_train(x, params, m, v, idx_stream=idx,
                                            eps_stream=eps, lr=lr, t0=t0,
                                            n_total=n_total,
                                            compute_dtype=compute_dtype)
        return p, mm, vv, thin_losses(losses, steps)


def fused_train_injected(x, params, m, v, *, idx_stream, eps_stream, lr):
    """The kernel with injected index/noise streams (the parity entry):
    reads idx (steps, B) and eps (steps, B, Z) instead of drawing them.
    Adam's step count starts at 0, as in the JAX package's entry."""
    global LAUNCHES
    steps, b = idx_stream.shape
    if x.device.type == "cuda":
        dims = _check(x, params, m, v, b)
        if tuple(eps_stream.shape) != (steps, b, dims.z) \
                or eps_stream.device != x.device \
                or idx_stream.device != x.device:
            raise ValueError("eps_stream must be (steps, B, Z) on x's device")
        idx = idx_stream.to(torch.int32).contiguous()
        if int(idx.min()) < 0 or int(idx.max()) >= dims.n:
            raise ValueError("idx_stream out of range")
        eps = eps_stream.to(torch.float32).contiguous()
        out = _launch(x, params, m, v, dims, steps=steps, lr=lr, seed=0,
                      t0=0, thin=1, idx=idx, eps=eps,
                      scale=_scale(dims.n, b, None))
        LAUNCHES += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"fused_train_injected: unsupported device "
                         f"{x.device}")
    return reference_train(x, params, m, v, idx_stream=idx_stream,
                           eps_stream=eps_stream, lr=lr)
