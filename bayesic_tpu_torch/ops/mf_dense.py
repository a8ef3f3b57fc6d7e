"""The dense matrix-factorization ELBO's cell pass as one hand-written
kernel, with its plain version.

Counterpart of ``bayesic_tpu/ops/mf_dense.py``.  ``models/matrix_fact.
dense_neg_elbo`` is exact and deterministic; its eager PyTorch form makes
the (num_users, num_items) mean, variance and gradient fields in device
memory several times per step.  The information per step is the two
sufficient-statistic arrays (cnt, rsum) read once; everything else is
O(users K + items K).  The kernel of ``csrc/mf_dense.cu`` does the whole
cell-space computation (two forward and four backward products and the
elementwise terms) in one launch over (cnt, rsum) tiles, after a launch
that packs the factors and before a fixed-order reduction of the
partials.

Biases fold into augmented factor columns, so the objective is products
(A = K + 2 augmented width, K factors):

  Ua   = [u_loc | bu_loc | 1]            (NU, A)
  Va   = [v_loc | 1 | bi_loc + m_loc]    (NI, A)
  Wu   = [Eu2a | U2a],  Wv = [Ev2a | -V2a]      (*, 2A)
    Eu2a = [u_loc^2 + e^{2 u_ls} | e^{2 bu_ls} | 1]
    Ev2a = [v_loc^2 + e^{2 v_ls} | 1 | e^{2 bi_ls} + e^{2 m_ls}]
    U2a  = [u_loc^2 | 0 | 0],  V2a = [v_loc^2 | 0 | 0]
  mean = Ua Va^T,  var = Wu Wv^T
  cells = sum cnt (var + mean^2) - 2 rsum mean
  G = 2 (cnt mean - rsum);  dUa = G Va, dWu = cnt Wv, dVa = G^T Ua,
  dWv = cnt^T Wu

The port keeps each side's factors as one matrix, ``Fu = [Ua | Wu]`` and
``Fv = [Va | Wv]`` (3A columns), at the real width A (the TPU pads A to 32
lanes and the grid to 8 x 128 tiles; neither is ported).  ``mm_dtype
"bfloat16"`` rounds each product operand (the factors and G; cnt is exact)
to bf16 with fp32 sums, in the kernel and the plain version alike.

On a CUDA tensor ``cell_grads`` launches the kernel; on a CPU tensor it
runs ``cell_grads_reference``.  Nothing falls back: on a CUDA tensor the
kernel runs or the call raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..infer.svi.svi import Adam
from . import _build

__all__ = ["PRIORS", "kl_normal", "pack_stats", "pack_aug", "cell_grads",
           "cell_grads_reference", "dense_value_and_grad", "fused_train",
           "MAX_FACTORS"]

# the mean-field sites' priors (loc, scale), as in models/matrix_fact
PRIORS = {"u": (0.0, 1.0), "v": (0.0, 1.0), "bu": (0.0, 0.5),
          "bi": (0.0, 0.5), "m": (3.0, 1.0)}
MAX_FACTORS = 30        # A = K + 2 <= 32, MAXA of the kernel
_MAX_COUNT = 256        # bf16 holds every integer up to 256 exactly

# launches of the cell pass (each is the packing, cell and reduction kernels)
LAUNCHES = 0


def kl_normal(loc, ls, loc0, scale0):
    """KL(N(loc, e^ls) || N(loc0, scale0)) summed over all coordinates."""
    return torch.sum(math.log(scale0) - ls
                     + (torch.exp(2.0 * ls) + (loc - loc0) ** 2)
                     / (2.0 * scale0 ** 2) - 0.5)


def _kl_and_grads(params):
    """The analytic KL of every site and its gradient, ``{site: (d loc,
    d ls)}``."""
    kl, grads = 0.0, {}
    for site, (loc0, s0) in PRIORS.items():
        loc, ls = params[site]
        kl = kl + kl_normal(loc, ls, loc0, s0)
        grads[site] = ((loc - loc0) / s0 ** 2,
                       torch.exp(2.0 * ls) / s0 ** 2 - 1.0)
    return kl, grads


def pack_stats(cnt, rsum):
    """(cnt as bf16, rsum as contiguous float32).  bf16 is exact for the
    integer counts up to 256; a larger count raises."""
    if cnt.shape != rsum.shape or cnt.dim() != 2:
        raise ValueError("cnt and rsum must be (num_users, num_items)")
    top = float(cnt.max())
    if top > _MAX_COUNT:
        raise ValueError(f"a cell holds {top:g} ratings; bf16 counts are "
                         f"exact only up to {_MAX_COUNT}")
    return (cnt.to(torch.bfloat16).contiguous(),
            rsum.to(torch.float32).contiguous())


def pack_aug(params):
    """Mean-field params ``{site: (loc, ls)}`` -> ``(Fu (NU, 3A), Fv (NI,
    3A))``, ``Fu = [Ua | Eu2a | U2a]`` and ``Fv = [Va | Ev2a | -V2a]``."""
    (u_loc, u_ls), (v_loc, v_ls) = params["u"], params["v"]
    (bu_loc, bu_ls), (bi_loc, bi_ls) = params["bu"], params["bi"]
    m_loc, m_ls = params["m"]
    ones_u = torch.ones_like(bu_loc)[:, None]
    ones_i = torch.ones_like(bi_loc)[:, None]
    zeros_u = u_loc.new_zeros((u_loc.shape[0], 2))
    zeros_i = v_loc.new_zeros((v_loc.shape[0], 2))
    u2, v2 = u_loc * u_loc, v_loc * v_loc
    fu = torch.cat([u_loc, bu_loc[:, None], ones_u,
                    u2 + torch.exp(2.0 * u_ls), torch.exp(2.0 * bu_ls)[:, None],
                    ones_u, u2, zeros_u], 1)
    fv = torch.cat([v_loc, ones_i, (bi_loc + m_loc)[:, None],
                    v2 + torch.exp(2.0 * v_ls), ones_i,
                    (torch.exp(2.0 * bi_ls) + torch.exp(2.0 * m_ls))[:, None],
                    -v2, zeros_i], 1)
    return fu.contiguous(), fv.contiguous()


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def cell_grads_reference(cnt, rsum, fu, fv, mm_dtype="float32"):
    """The plain cell pass: ``(cells (), dFu (NU, 3A), dFv (NI, 3A))``."""
    a = fu.shape[1] // 3
    cnt = cnt.to(torch.float32)
    if mm_dtype == "bfloat16":
        fu, fv = _bf16(fu), _bf16(fv)
    mean = fu[:, :a] @ fv[:, :a].T
    var = fu[:, a:] @ fv[:, a:].T
    g = 2.0 * (cnt * mean - rsum)
    cells = torch.sum(cnt * (var + mean * mean) - 2.0 * rsum * mean)
    if mm_dtype == "bfloat16":
        g = _bf16(g)
    dfu = torch.cat([g @ fv[:, :a], cnt @ fv[:, a:]], 1)
    dfv = torch.cat([g.T @ fu[:, :a], cnt.T @ fu[:, a:]], 1)
    return cells, dfu, dfv


def _check(cnt, rsum, fu, fv):
    nu, ni = cnt.shape
    w = fu.shape[1]
    if cnt.dtype != torch.bfloat16 or rsum.dtype != torch.float32 \
            or tuple(rsum.shape) != (nu, ni):
        raise ValueError("cnt must be bf16 and rsum float32, both (NU, NI) "
                         "(pack_stats)")
    if fu.dim() != 2 or w % 3 or tuple(fv.shape) != (ni, w) \
            or tuple(fu.shape) != (nu, w):
        raise ValueError(f"fu must be (NU, 3A) and fv (NI, 3A); got "
                         f"{tuple(fu.shape)}, {tuple(fv.shape)}")
    if w // 3 > MAX_FACTORS + 2:
        raise ValueError(f"the kernel takes K <= {MAX_FACTORS}; got "
                         f"K={w // 3 - 2}")
    for t in (rsum, fu, fv):
        if t.device != cnt.device:
            raise ValueError("all inputs must lie on one device")
        if t.dtype == torch.float32 and not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    return nu, ni, w // 3


def cell_grads(cnt, rsum, fu, fv, *, mm_dtype="float32"):
    """One fused pass: ``(cells (), dFu (NU, 3A), dFv (NI, 3A))`` for
    ``cnt``, ``rsum`` from ``pack_stats`` and ``fu``, ``fv`` from
    ``pack_aug``.  CUDA tensors run the kernel; CPU tensors the plain
    version."""
    global LAUNCHES
    if mm_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"mm_dtype must be float32 or bfloat16, not "
                         f"{mm_dtype!r}")
    if cnt.device.type == "cpu":
        return cell_grads_reference(cnt, rsum, fu, fv, mm_dtype)
    if cnt.device.type != "cuda":
        raise ValueError(f"cell_grads: unsupported device {cnt.device}")
    nu, ni, a = _check(cnt, rsum, fu, fv)
    lib = _build.load()
    dev = cnt.device
    scratch = torch.empty(lib.mf_dense_scratch_floats(nu, ni, a),
                          dtype=torch.float32, device=dev)
    cells = torch.empty((), dtype=torch.float32, device=dev)
    dfu = torch.empty_like(fu)
    dfv = torch.empty_like(fv)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mf_dense_cell_grads(
            ptr(cnt.contiguous()), ptr(rsum), ptr(fu), ptr(fv), ptr(scratch),
            ptr(cells), ptr(dfu), ptr(dfv), nu, ni, a,
            int(mm_dtype == "bfloat16"), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"mf_dense kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES += 1
    return cells, dfu, dfv


def dense_value_and_grad(params, cnt, rsum, sqsum, n_ratings, noise, *,
                         mm_dtype="float32"):
    """``(loss, grads)`` of ``models/matrix_fact.dense_neg_elbo``, with the
    cell-space work in ``cell_grads`` and the chain rule and the analytic
    KL in torch; ``cnt``, ``rsum`` from ``pack_stats``; ``grads`` match
    ``params`` (``{site: (d loc, d ls)}``)."""
    (u_loc, u_ls), (v_loc, v_ls) = params["u"], params["v"]
    bu_ls, bi_ls, m_ls = params["bu"][1], params["bi"][1], params["m"][1]
    k = u_loc.shape[1]
    a = k + 2
    fu, fv = pack_aug(params)
    cells, dfu, dfv = cell_grads(cnt, rsum, fu, fv, mm_dtype=mm_dtype)
    s = 0.5 / noise ** 2        # neg_elbo = s (cells + sqsum) + const + KL
    dua, deu2a, du2a = dfu[:, :a], dfu[:, a:2 * a], dfu[:, 2 * a:]
    dva, dev2a, dv2a = dfv[:, :a], dfv[:, a:2 * a], -dfv[:, 2 * a:]
    kl, kl_grads = _kl_and_grads(params)
    g = {
        "u": (s * (dua[:, :k] + (deu2a[:, :k] + du2a[:, :k]) * 2 * u_loc),
              s * deu2a[:, :k] * 2 * torch.exp(2 * u_ls)),
        "v": (s * (dva[:, :k] + (dev2a[:, :k] + dv2a[:, :k]) * 2 * v_loc),
              s * dev2a[:, :k] * 2 * torch.exp(2 * v_ls)),
        "bu": (s * dua[:, k], s * deu2a[:, k] * 2 * torch.exp(2 * bu_ls)),
        "bi": (s * dva[:, k + 1],
               s * dev2a[:, k + 1] * 2 * torch.exp(2 * bi_ls)),
        "m": (s * torch.sum(dva[:, k + 1]),
              s * torch.sum(dev2a[:, k + 1]) * 2 * torch.exp(2 * m_ls)),
    }
    grads = {site: (g[site][0] + kl_grads[site][0],
                    g[site][1] + kl_grads[site][1]) for site in PRIORS}
    loss = (s * (cells + sqsum)
            + n_ratings * (math.log(noise) + 0.5 * math.log(2.0 * math.pi))
            + kl)
    return loss, grads


def fused_train(params, cnt, rsum, sqsum, n_ratings, noise, *, steps, lr,
                mm_dtype="float32", opt_state=None):
    """``steps`` dense-ELBO Adam steps at the constant rate ``lr``, each one
    ``dense_value_and_grad``; ``cnt``, ``rsum`` the raw (NU, NI) statistics
    (``pack_stats`` runs here).  Returns ``(params, opt_state, losses)``."""
    cnt_p, rsum_p = pack_stats(cnt, rsum)
    opt = Adam(lr)
    if opt_state is None:
        opt_state = opt.init(params)
    losses = []
    for _ in range(int(steps)):
        loss, grads = dense_value_and_grad(params, cnt_p, rsum_p, sqsum,
                                           n_ratings, noise,
                                           mm_dtype=mm_dtype)
        params, opt_state = opt.update(grads, opt_state, params)
        losses.append(loss)
    return params, opt_state, torch.stack(losses)
