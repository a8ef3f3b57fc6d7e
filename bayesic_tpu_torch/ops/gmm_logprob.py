"""Batched Gaussian-mixture log-likelihood, its gradient, and the kernels
that compute them.

Counterpart of ``bayesic_tpu/ops/gmm_logprob.py``.  For P particles, each
a K-component isotropic mixture (log-weights (P, K), means (P, K, D),
scales (P, K)), over a shared data set x (N, D):

    ll[p] = sum_n logsumexp_k [log w_pk + log N(x_n; mu_pk, s_pk^2 I)].

* ``gmm_loglik`` is a ``torch.autograd.Function``: on a CUDA tensor its
  forward runs ``csrc/gmm_logprob.cu``'s forward kernel and its backward the
  backward kernel; the gradient for x is NaN (not implemented; the SMC path
  never asks for it, and NaN fails loudly where zeros would mislead).
* ``gmm_loglik_grad`` returns the value and the three gradients from one
  launch of the value+grad kernel.
* ``launch_geometry`` gives the launch of each kernel, named as
  ``LAUNCHES`` names it, and ``device_geometry`` the library's own, with
  the blocks an SM of the current card can hold at once.

On a CPU tensor each runs its plain version, ``gmm_loglik_reference`` and
``gmm_loglik_grad_reference``; on a CUDA tensor each launches its kernel or
raises.  The JAX package's ``BAYESIC_PALLAS`` switch is not ported.  The
plain versions compute the squared distance as the difference squared and
the responsibility sums directly, as the kernels do (``csrc/gmm_lik.cuh``
says why the TPU's expanded forms are not ported).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .fused_nuts import _ptr, _raise, _stream

__all__ = ["gmm_loglik_reference", "gmm_loglik_grad_reference",
           "gmm_loglik", "gmm_loglik_grad", "launch_geometry",
           "device_geometry", "LAUNCHES", "MAX_COMPONENTS",
           "MAX_DATA_DIM", "THREADS", "EXACT_SHAPES", "TILE_FLOATS"]

_LOG_2PI = math.log(2.0 * math.pi)
MAX_COMPONENTS, MAX_DATA_DIM = 8, 4      # GMM_MAXK, GMM_MAXD of gmm_lik.cuh
# csrc/gmm_logprob.cu: the generic instances' threads a block, one warp a
# particle (GL_NT); the most x floats a block holds in shared memory at
# once (TILE_FLOATS); each kernel's K 3, D 2 instance's threads a block and
# particles a warp (FWD_NT, FWD_W, BWD_NT, VG_NT)
THREADS, TILE_FLOATS = 256, 12288
EXACT_SHAPES = {"fwd": (1024, 1), "bwd": (1024, 1), "vg": (1024, 1)}

# launches of each kernel: "fwd", "bwd" (gmm_loglik's backward) and "vg"
# (gmm_loglik_grad), in the order of csrc/gmm_logprob.cu's Mode
LAUNCHES = {"fwd": 0, "bwd": 0, "vg": 0}


def _terms(x, log_w, mus, sigmas):
    """dx (..., K, N, D), squared distances q and per-component log
    densities l (..., K, N)."""
    d = x.shape[-1]
    dx = x - mus[..., :, None, :]
    q = torch.sum(dx * dx, -1)
    inv_s2 = 1.0 / (sigmas * sigmas)
    ll = (log_w[..., None] - 0.5 * q * inv_s2[..., None]
          - d * torch.log(sigmas)[..., None] - 0.5 * d * _LOG_2PI)
    return dx, q, ll


def gmm_loglik_reference(x, log_w, mus, sigmas):
    """x (N, D); log_w (..., K); mus (..., K, D); sigmas (..., K) ->
    (...)."""
    _, _, ll = _terms(x, log_w, mus, sigmas)
    return torch.sum(torch.logsumexp(ll, -2), -1)


def gmm_loglik_grad_reference(x, log_w, mus, sigmas, ct=None):
    """``(ll, d/dlog_w, d/dmus, d/dsigmas)`` by the responsibilities, the
    plain version of the value+grad kernel; with a cotangent ``ct`` (...)
    the gradients are scaled by it (the backward kernel's plain
    version)."""
    d = x.shape[-1]
    dx, q, ll = _terms(x, log_w, mus, sigmas)
    lse = torch.logsumexp(ll, -2)                        # (..., N)
    resp = torch.exp(ll - lse[..., None, :])             # (..., K, N)
    r = resp.sum(-1)
    rq = (resp * q).sum(-1)
    rdx = (resp[..., None] * dx).sum(-2)                 # (..., K, D)
    inv_s2 = 1.0 / (sigmas * sigmas)
    dlogw = r
    dmus = rdx * inv_s2[..., None]
    dsig = (rq * inv_s2 - d * r) / sigmas
    if ct is not None:
        dlogw, dmus, dsig = (ct[..., None] * dlogw,
                             ct[..., None, None] * dmus,
                             ct[..., None] * dsig)
    return lse.sum(-1), dlogw, dmus, dsig


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check(x, log_w, mus, sigmas):
    """Shapes (P, K, N, D) of a CUDA call, with the parameters made
    contiguous float32; raises on what the kernels do not take."""
    if x.dim() != 2 or log_w.dim() != 2:
        raise ValueError("x must be (N, D) and log_w (P, K)")
    n, d = x.shape
    p, k = log_w.shape
    if not (1 <= k <= MAX_COMPONENTS and 1 <= d <= MAX_DATA_DIM):
        raise ValueError(f"the kernels take K <= {MAX_COMPONENTS} and D <= "
                         f"{MAX_DATA_DIM}, got K={k}, D={d}")
    want = {"x": (n, d), "log_w": (p, k), "mus": (p, k, d),
            "sigmas": (p, k)}
    out = []
    for name, t in zip(want, (x, log_w, mus, sigmas)):
        if tuple(t.shape) != want[name] or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"{name}: want float32 {want[name]} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        out.append(t.contiguous())
    return (p, k, n, d), out


def _device_ok(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


def _fwd(x, log_w, mus, sigmas):
    if x.device.type == "cpu":
        return gmm_loglik_reference(x, log_w, mus, sigmas)
    _device_ok(x, "gmm_loglik")
    (p, k, n, d), args = _check(x, log_w, mus, sigmas)
    lib = _build.load()
    ll = torch.empty(p, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gmm_loglik_fwd(*map(_ptr, args), _ptr(ll), p, n, k, d,
                                 _stream(x.device))
    _raise(err, "gmm_loglik_fwd")
    LAUNCHES["fwd"] += 1
    return ll


def _bwd(x, log_w, mus, sigmas, ct):
    if x.device.type == "cpu":
        return gmm_loglik_grad_reference(x, log_w, mus, sigmas, ct)[1:]
    _device_ok(x, "gmm_loglik backward")
    (p, k, n, d), args = _check(x, log_w, mus, sigmas)
    ct = ct.to(torch.float32).contiguous()
    if tuple(ct.shape) != (p,) or ct.device != x.device:
        raise ValueError(f"the cotangent must be ({p},) on {x.device}")
    lib = _build.load()
    dlogw, dsig = (torch.empty((p, k), dtype=torch.float32, device=x.device)
                   for _ in range(2))
    dmus = torch.empty((p, k, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gmm_loglik_bwd(*map(_ptr, args), _ptr(ct), _ptr(dlogw),
                                 _ptr(dmus), _ptr(dsig), p, n, k, d,
                                 _stream(x.device))
    _raise(err, "gmm_loglik_bwd")
    LAUNCHES["bwd"] += 1
    return dlogw, dmus, dsig


class _GmmLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, log_w, mus, sigmas):
        ctx.save_for_backward(x, log_w, mus, sigmas)
        return _fwd(x, log_w, mus, sigmas)

    @staticmethod
    def backward(ctx, ct):
        x, log_w, mus, sigmas = ctx.saved_tensors
        with torch.no_grad():
            dlogw, dmus, dsig = _bwd(x.detach(), log_w.detach(),
                                     mus.detach(), sigmas.detach(), ct)
        return torch.full_like(x, float("nan")), dlogw, dmus, dsig


def gmm_loglik(x, log_w, mus, sigmas):
    """Batched GMM log-likelihood: x (N, D), log_w (P, K), mus (P, K, D),
    sigmas (P, K) -> (P,), differentiable in log_w, mus and sigmas (the
    backward kernel on a CUDA tensor)."""
    return _GmmLoglik.apply(x, log_w, mus, sigmas)


def launch_geometry(kernel, p, n, k, d):
    """The launch of ``kernel`` ("fwd", "bwd" or "vg", as ``LAUNCHES``
    names them) for ``p`` particles of a (K, D) mixture over ``n`` points:
    threads a block, particles a warp and a block (``EXACT_SHAPES`` at K 3,
    D 2; 8 warps of one particle at the generic instances), blocks,
    dynamic shared bytes (x, up to ``TILE_FLOATS`` floats) and the x tiles
    each block walks."""
    if kernel not in LAUNCHES:
        raise ValueError(f"no kernel {kernel!r}: one of {list(LAUNCHES)}")
    if not (p >= 1 and n >= 1 and 1 <= k <= MAX_COMPONENTS
            and 1 <= d <= MAX_DATA_DIM):
        raise ValueError(f"no launch for P={p}, N={n}, K={k}, D={d}")
    tile = TILE_FLOATS // d
    threads, per_warp = EXACT_SHAPES[kernel] if (k, d) == (3, 2) \
        else (THREADS, 1)
    per_block = threads // 32 * per_warp
    return dict(threads=threads, particles_per_warp=per_warp,
                particles_per_block=per_block, blocks=-(-p // per_block),
                smem_bytes=4 * min(n, tile) * d, tiles=-(-n // tile))


def device_geometry(kernel, p, n, k, d):
    """The library's launch of ``kernel`` at (P, N, K, D), as
    ``launch_geometry`` names it, and ``resident_blocks``: the blocks of it
    an SM of the current card can hold at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Needs a CUDA
    card."""
    import ctypes

    if kernel not in LAUNCHES:
        raise ValueError(f"no kernel {kernel!r}: one of {list(LAUNCHES)}")
    out = (ctypes.c_int * 7)()
    _raise(_build.load().gmm_loglik_geometry(list(LAUNCHES).index(kernel),
                                             p, n, k, d, out),
           "gmm_loglik_geometry")
    return dict(zip(("threads", "particles_per_warp", "particles_per_block",
                     "blocks", "smem_bytes", "tiles", "resident_blocks"),
                    out))


def gmm_loglik_grad(x, log_w, mus, sigmas):
    """Value and gradient in one launch: -> (ll (P,), dlogw (P, K), dmus
    (P, K, D), dsig (P, K)).  Not differentiable itself."""
    if x.device.type == "cpu":
        with torch.no_grad():
            return gmm_loglik_grad_reference(x, log_w, mus, sigmas)
    _device_ok(x, "gmm_loglik_grad")
    (p, k, n, d), args = _check(x, log_w, mus, sigmas)
    lib = _build.load()
    ll = torch.empty(p, dtype=torch.float32, device=x.device)
    dlogw, dsig = (torch.empty((p, k), dtype=torch.float32, device=x.device)
                   for _ in range(2))
    dmus = torch.empty((p, k, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gmm_loglik_vg(*map(_ptr, (t.detach() for t in args)),
                                _ptr(ll), _ptr(dlogw), _ptr(dmus),
                                _ptr(dsig), p, n, k, d, _stream(x.device))
    _raise(err, "gmm_loglik_vg")
    LAUNCHES["vg"] += 1
    return ll, dlogw, dmus, dsig
