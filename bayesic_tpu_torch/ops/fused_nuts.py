"""Fused NUTS transition for the DLGM local posterior: one launch runs a
whole NUTS transition for every chain.

Counterpart of ``bayesic_tpu/ops/fused_nuts.py``.  The workload is the
1024-chain local-posterior NUTS of the DLGM: per chain a D = nb*latent
posterior over the latents z of ``nb`` data rows under a fixed decoder,

    pe(q) = 0.5|q|^2 + |x - (tanh(z W1 + b1) W2 + b2)|^2 / (2 s^2) + const,

with z = q.view(C, nb, latent) and the constants of the JAX package's
``make_packed_potential``.  On a CUDA tensor the entries run the
hand-written kernel of ``csrc/fused_nuts.cu``; on a CPU tensor they run the
plain version, ``reference_transition``: the port's one NUTS core
(``infer/mcmc/nuts.nuts_core``) over the dense potential below.  Nothing
falls back: on a CUDA tensor the kernel runs or the call raises.

Two entries share the kernel.  ``fused_nuts_transition`` takes pre-drawn
randomness (momentum normals, +-1 doubling signs, strictly negative
log-uniforms), so it and its plain version compute the same transition
from the same streams: the parity entry.  ``fused_nuts_transition_keyed``
takes the transition's ``StreamKey`` and the kernel makes the draws itself,
as ``infer/mcmc/streams.nuts_streams`` makes them (the same Philox words
and float recipes; ``fused_nuts_draws`` writes them out for a check): what
``make_batched_transition`` runs, one launch per transition and no stream
ops on the host.  The JAX package's lane packing, hi/lo bf16 dot splits,
(C, 1) layout rules and in-kernel re-evaluation of pe are TPU workarounds
and are not ported.  The kernel computes the potential's products on the
tensor cores in TF32 with both operands split in three passes (about
fp32's accuracy); the plain version in fp32.  It takes any decoder widths
with ``element_groups(nb, latent) <= MAX_GROUPS``; each call allocates the
device workspace the kernel's plan asks for (its packed weights, its chain
counter, and the tree's vectors where they do not fit in shared memory).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..infer.mcmc.integrators import IntegratorState
from ..infer.mcmc.nuts import NUTSInfo, nuts_core
from ..infer.mcmc.streams import NUTSStreams, nuts_streams
from . import _build

__all__ = ["dense_potential", "reference_transition", "fused_nuts_potential",
           "fused_nuts_transition", "fused_nuts_transition_keyed",
           "fused_nuts_draws", "decoder_weights", "make_batched_transition",
           "element_groups", "MAX_DOUBLINGS", "MAX_GROUPS"]

_LOG_2PI = math.log(2.0 * math.pi)
MAX_DOUBLINGS = 12      # MAXK of csrc/nuts_tree.cuh
# csrc/fused_nuts.cu: a lane holds at most MAX_GROUPS element groups, each a
# block of 16 rows (a chain's up to 16 warps take ceil(nb / 256) each) and
# 8 latents, so ceil(nb / 256) * ceil(latent / 8) <= MAX_GROUPS
MAX_GROUPS = 16

# launches of the transition kernel (either entry); one launch is one NUTS
# transition of every chain
LAUNCHES = 0


def _constants(nb, latent, data, sigma):
    sigma = float(sigma)
    inv_s2 = 1.0 / (sigma * sigma)
    const = (0.5 * _LOG_2PI * (nb * latent + nb * data)
             + nb * data * math.log(sigma))
    return inv_s2, const


def dense_potential(w1, b1, w2, b2, x_batch, sigma):
    """``pg(q (C, D)) -> (pe (C,), grad (C, D))`` of the local posterior,
    with the hand-derived gradient (dmu = res/s^2, da = dmu W2^T (1 - a^2),
    grad = q + da W1^T).  Weights in the (in, out) layout."""
    nb, data = x_batch.shape
    latent = w1.shape[0]
    inv_s2, const = _constants(nb, latent, data, sigma)

    def pg(q):
        c = q.shape[0]
        z = q.reshape(c, nb, latent)
        a = torch.tanh(z @ w1 + b1)
        res = a @ w2 + b2 - x_batch
        pe = (0.5 * torch.sum(q * q, 1)
              + (0.5 * inv_s2) * torch.sum(res * res, (1, 2)) + const)
        da = ((res * inv_s2) @ w2.T) * (1.0 - a * a)
        return pe, q + (da @ w1.T).reshape(c, -1)

    return pg


def reference_transition(q, pe, grad, mom, sign_dir, log_u_acc, log_u_leaf,
                         eps, inv_mass, w1, b1, w2, b2, x_batch, *, sigma,
                         max_doublings, divergence_threshold=1000.0):
    """The plain version of the kernel: ``nuts_core`` over
    ``dense_potential``, with the kernel's argument and output layout
    (per-chain outputs as (N, 1))."""
    pg = dense_potential(w1, b1, w2, b2, x_batch, sigma)
    out = nuts_core(pg, q, pe.reshape(-1), grad,
                    NUTSStreams(mom, sign_dir, log_u_acc, log_u_leaf),
                    eps, inv_mass.reshape(-1), max_doublings,
                    divergence_threshold)
    q2, pe2, g2 = out[:3]
    return (q2, pe2[:, None], g2) + tuple(s[:, None] for s in out[3:])


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")


def _check_weights(q, w1, b1, w2, b2, x_batch):
    nb, data = x_batch.shape
    latent, hidden = w1.shape
    want = {"w1": (latent, hidden), "b1": (hidden,), "w2": (hidden, data),
            "b2": (data,), "x_batch": (nb, data)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "x_batch": x_batch}
    for k, t in got.items():
        if tuple(t.shape) != want[k] or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{k}: want contiguous float32 {want[k]} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if q.dim() != 2 or q.shape[1] != nb * latent:
        raise ValueError(f"q must be (N, nb*latent) = (N, {nb * latent})")
    return nb, latent, hidden, data


def _check_rows(n, **rows):
    for k, (t, width) in rows.items():
        if tuple(t.shape) != (n, width) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{k}: want contiguous float32 ({n}, {width}), "
                             f"got {t.dtype} {tuple(t.shape)}")


def _key_words(key, chain0=0):
    """A ``StreamKey`` as the C entries take it: the 64-bit seed, the phase
    and the step's low 32 bits (the counter's first word, as in
    streams.py), then the chain base: the logical index of the launch's
    first chain."""
    chain0 = int(chain0)
    if not 0 <= chain0 < 2**32:
        raise ValueError(f"chain0 {chain0} is not a 32-bit chain index")
    return (int(key.seed) & 0xFFFFFFFFFFFFFFFF, int(key.phase) & 0xFFFFFF,
            int(key.t) & 0xFFFFFFFF, chain0)


def _chains(chain0, n, device):
    """Logical indices chain0 .. chain0 + n - 1 (``nuts_streams``' chains)."""
    return torch.arange(int(chain0), int(chain0) + n, device=device)


def element_groups(nb, latent):
    """Element groups a lane of the kernel holds at this shape (see
    ``csrc/fused_nuts.cu``)."""
    blocks = -(-nb // 16)
    per_warp = -(-blocks // 16)
    return per_warp * -(-latent // 8)


def _workspace(n, nb, latent, hidden, data, kk, tree, device):
    """The library and the device workspace a call needs, after checking
    that the kernel takes the shape."""
    shape = (f"nb={nb}, latent={latent}, hidden={hidden}, data={data}, "
             f"K={kk}")
    if element_groups(nb, latent) > MAX_GROUPS:
        raise ValueError(f"shape the kernel does not take: {shape} (it "
                         f"takes ceil(nb / 256) * ceil(latent / 8) <= "
                         f"{MAX_GROUPS})")
    lib = _build.load()
    nbytes = lib.fused_nuts_workspace_bytes(n, nb, latent, hidden, data, kk,
                                            int(tree))
    if nbytes == 0:
        raise ValueError(f"shape the kernel does not take: {shape}")
    return lib, torch.empty(nbytes, dtype=torch.uint8, device=device)


def fused_nuts_potential(q, w1, b1, w2, b2, x_batch, *, sigma):
    """pe (N, 1) and grad (N, D) at q (N, D).  On a CUDA tensor this runs
    the kernel's own device function (the check entry that isolates the
    potential from the tree); on a CPU tensor ``dense_potential``."""
    if q.device.type == "cpu":
        pe, grad = dense_potential(w1, b1, w2, b2, x_batch, sigma)(q)
        return pe[:, None], grad
    if q.device.type != "cuda":
        raise ValueError(f"fused_nuts_potential: unsupported device "
                         f"{q.device}")
    nb, latent, hidden, data = _check_weights(q, w1, b1, w2, b2, x_batch)
    _check_rows(q.shape[0], q=(q, nb * latent))
    lib, ws = _workspace(q.shape[0], nb, latent, hidden, data, 1, False,
                         q.device)
    pe = torch.empty((q.shape[0], 1), dtype=torch.float32, device=q.device)
    grad = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.fused_nuts_potential(
            _ptr(q), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(x_batch),
            _ptr(pe), _ptr(grad), _ptr(ws), ws.numel(), q.shape[0], nb,
            latent, hidden, data, float(sigma), _stream(q.device))
    _raise(err, "fused_nuts_potential")
    return pe, grad


def _doublings(max_doublings):
    kk = int(max_doublings)
    if not 1 <= kk <= MAX_DOUBLINGS:
        raise ValueError(f"max_doublings must be in 1..{MAX_DOUBLINGS}")
    return kk


def _check_state(q, pe, grad, eps, inv_mass, **rows):
    """The checks every NUTS transition wrapper makes on the chain state
    (``rows``: the injected streams and their widths); returns eps as a
    one-element device tensor."""
    n, d = q.shape
    _check_rows(n, q=(q, d), grad=(grad, d), **rows)
    if pe.numel() != n or inv_mass.numel() != d \
            or tuple(inv_mass.shape) not in ((d,), (1, d)):
        raise ValueError(f"pe must hold {n} values and inv_mass be a "
                         f"diagonal (D,) or (1, D), D = {d}")
    eps = torch.as_tensor(eps, dtype=torch.float32, device=q.device) \
        .reshape(1)
    for k, t in (("pe", pe), ("inv_mass", inv_mass), ("eps", eps)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{k} must be float32 on {q.device}")
    return eps


def _call_transition(entry, q, ins, args, key=()):
    """Call a NUTS transition C entry: ``ins`` are its input tensors, then
    the outputs, ``args`` (workspace, shape, K, ...), ``key`` (a keyed
    entry's words) and the stream.  Returns the outputs as
    ``fused_nuts_transition`` does."""
    n = q.shape[0]
    q2, g2 = torch.empty_like(q), torch.empty_like(q)
    scal = torch.empty((6, n, 1), dtype=torch.float32, device=q.device)
    outs = (q2, scal[0], g2, *scal[1:])
    with torch.cuda.device(q.device):
        err = entry(*map(_ptr, ins), *map(_ptr, outs), *args, *key,
                    _stream(q.device))
    _raise(err, entry.__name__)
    return outs


def _transition(entry, q, pe, grad, eps, inv_mass, weights, kk, sigma,
                divergence_threshold, streams=(), key=()):
    """Check, then run one transition through ``entry``: the injected one
    with ``streams`` (mom, sign_dir, log_u_acc, log_u_leaf) or the keyed
    one with ``key``'s words."""
    global LAUNCHES
    nb, latent, hidden, data = _check_weights(q, *weights)
    widths = (q.shape[1], kk, kk, 1 << kk)
    eps = _check_state(q, pe, grad, eps, inv_mass, **dict(zip(
        ("mom", "sign_dir", "log_u_acc", "log_u_leaf"),
        zip(streams, widths))))
    lib, ws = _workspace(q.shape[0], nb, latent, hidden, data, kk, True,
                         q.device)
    outs = _call_transition(
        getattr(lib, entry), q,
        (q, pe.contiguous(), grad, *streams, eps, inv_mass.contiguous(),
         *weights),
        (_ptr(ws), ws.numel(), q.shape[0], nb, latent, hidden, data, kk,
         float(sigma), float(divergence_threshold)), key)
    LAUNCHES += 1
    return outs


def fused_nuts_transition(q, pe, grad, mom, sign_dir, log_u_acc, log_u_leaf,
                          eps, inv_mass, w1, b1, w2, b2, x_batch, *, sigma,
                          max_doublings=6, divergence_threshold=1000.0):
    """One NUTS transition of every chain, from pre-drawn streams.

    q/grad/mom (N, D) with D = nb*latent; pe (N, 1); sign_dir (N, K) of
    +-1; log_u_acc (N, K) and log_u_leaf (N, 2^K) strictly negative
    log-uniforms, K = ``max_doublings``; eps the step size (a float, or a
    one-element tensor on q's device, which avoids a host sync); inv_mass
    (D,) or (1, D); decoder weights (in, out): w1 (latent, hidden), b1
    (hidden,), w2 (hidden, data), b2 (data,); x_batch (nb, data).

    Returns ``(q', pe', grad', accept_stat, diverging, depth, num_steps,
    h0)``, the per-chain values as (N, 1) float32.
    """
    if q.device.type == "cpu":
        return reference_transition(
            q, pe, grad, mom, sign_dir, log_u_acc, log_u_leaf, eps, inv_mass,
            w1, b1, w2, b2, x_batch, sigma=sigma,
            max_doublings=max_doublings,
            divergence_threshold=divergence_threshold)
    if q.device.type != "cuda":
        raise ValueError(f"fused_nuts_transition: unsupported device "
                         f"{q.device}")
    return _transition("fused_nuts_transition", q, pe, grad, eps, inv_mass,
                       (w1, b1, w2, b2, x_batch), _doublings(max_doublings),
                       sigma, divergence_threshold,
                       streams=(mom, sign_dir, log_u_acc, log_u_leaf))


def fused_nuts_transition_keyed(q, pe, grad, key, eps, inv_mass, w1, b1, w2,
                                b2, x_batch, *, sigma, max_doublings=6,
                                divergence_threshold=1000.0, chain0=0):
    """One NUTS transition of every chain, its draws made from ``key`` (a
    ``streams.StreamKey``) for logical chains chain0 .. chain0 + N - 1, as
    ``nuts_streams(key, chain0 + arange(N), D, K)`` makes them: row i of q
    is logical chain chain0 + i, so a chain-sharded rank passes its first
    global chain.  On a CUDA tensor the kernel draws them itself; on a CPU
    tensor this is ``reference_transition`` on ``nuts_streams``.  Other
    arguments and the outputs as ``fused_nuts_transition``."""
    if q.device.type == "cpu":
        n, d = q.shape
        return reference_transition(
            q, pe, grad, *nuts_streams(key, _chains(chain0, n, q.device), d,
                                       int(max_doublings), q.device),
            eps, inv_mass, w1, b1, w2, b2, x_batch, sigma=sigma,
            max_doublings=max_doublings,
            divergence_threshold=divergence_threshold)
    if q.device.type != "cuda":
        raise ValueError(f"fused_nuts_transition_keyed: unsupported device "
                         f"{q.device}")
    return _transition("fused_nuts_transition_keyed", q, pe, grad, eps,
                       inv_mass, (w1, b1, w2, b2, x_batch),
                       _doublings(max_doublings), sigma,
                       divergence_threshold, key=_key_words(key, chain0))


def fused_nuts_draws(key, n, dim, max_doublings, device, chain0=0):
    """The keyed entries' draws for logical chains chain0 .. chain0 + n - 1
    as a ``NUTSStreams``: on a CUDA device written by the kernels' own draw
    function (the check entry against ``nuts_streams``), on the CPU
    ``nuts_streams`` itself."""
    device = torch.device(device)
    kk = int(max_doublings)
    if device.type == "cpu":
        return nuts_streams(key, _chains(chain0, n, device), dim, kk, device)
    if device.type != "cuda":
        raise ValueError(f"fused_nuts_draws: unsupported device {device}")
    kk = _doublings(kk)
    out = NUTSStreams(*(torch.empty((n, w), dtype=torch.float32,
                                    device=device)
                        for w in (dim, kk, kk, 1 << kk)))
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.fused_nuts_draws(*map(_ptr, out), n, dim, kk,
                                   *_key_words(key, chain0), _stream(device))
    _raise(err, "fused_nuts_draws")
    return out


# ---------------------------------------------------------------------------
# MCMC integration: a batched_transition for infer/mcmc/mcmc.py
# ---------------------------------------------------------------------------

def decoder_weights(dec_params):
    """The ``Decoder``'s parameter dict (``nn.Linear`` layout) -> (w1, b1,
    w2, b2) in the kernel's (in, out) layout, contiguous float32."""
    f = lambda t: t.detach().to(torch.float32).contiguous()  # noqa: E731
    return (f(dec_params["Dense_0.weight"].T), f(dec_params["Dense_0.bias"]),
            f(dec_params["Dense_1.weight"].T), f(dec_params["Dense_1.bias"]))


def make_batched_transition(dec_params, sigma_x, x_batch, *,
                            max_doublings=6, chain0=0):
    """A ``batched_transition(key, states, step_size, inv_mass)`` for
    ``MCMC`` over the DLGM local posterior (``models/dlgm.py``
    ``local_posterior_mcmc``'s model), running
    ``fused_nuts_transition_keyed``: the kernel draws each transition's
    per-chain streams from ``key`` by logical chain index, so the host
    draws nothing.  ``chain0`` is the logical index of the first chain
    it is given (a chain-sharded rank's first global chain).  Requires
    ``shared_adapt=True`` (one step size, one diagonal mass).  The
    decoder's widths come from ``dec_params``."""
    w1, b1, w2, b2 = decoder_weights(dec_params)
    x_batch = x_batch.to(torch.float32).contiguous()
    sigma = float(sigma_x)
    kk = int(max_doublings)

    def transition(key, states, step_size, inv_mass):
        n = states.q.shape[0]
        q2, pe2, g2, acc, div, depth, nsteps, h0 = \
            fused_nuts_transition_keyed(
                states.q, states.pe.reshape(n, 1), states.grad, key,
                step_size, inv_mass, w1, b1, w2, b2, x_batch, sigma=sigma,
                max_doublings=kk, chain0=chain0)
        new_states = IntegratorState(q2, torch.zeros_like(q2), pe2[:, 0], g2)
        info = NUTSInfo(
            accept_prob=acc[:, 0], diverging=div[:, 0] > 0.5,
            depth=depth[:, 0].to(torch.int32),
            num_steps=nsteps[:, 0].to(torch.int32), energy=h0[:, 0],
            is_accepted=torch.any(q2 != states.q, dim=-1))
        return new_states, info

    return transition
