"""Fused SMC mutation stage for the Gaussian mixture model: one launch runs
all K HMC transitions of a tempering stage for every particle.

Counterpart of ``bayesic_tpu/ops/fused_smc_gmm.py``.  The target is
p_beta(q) = prior(q) lik(q)^beta on the flat unconstrained particle q of
``models/gmm.make_model`` in unraveler order (K-1 stick-breaking
coordinates, K*D means, K log-scales), with the potential

    pe_beta(q) = -[log Dirichlet(1)(w) + ldj_SB(uw)] + |mu|^2/50
                 + K*D*(log 5 + 0.5 log 2pi) + sum_k [s_k^2/8 - us_k]
                 + K*0.5 log 2pi - beta * ll(q),

equal to ``core.logjoint``'s density parts, constants included.

* ``make_gmm_potential_flat`` is the plain potential: pe, grad and ll on
  (P, dim), with the stick-breaking and exp pullbacks written out.
* ``mutation_core`` is the plain K-transition core: leapfrog HMC, MH in log
  space (log u < log a), and dual averaging of the step size on the mean
  accept probability of each block of 128 particles.
* ``fused_gmm_mutate`` takes injected (pre-scaled) momenta and log-uniforms
  and runs ``csrc/fused_smc_gmm.cu`` on a CUDA tensor, ``mutation_core`` on
  a CPU tensor; on a CUDA tensor it launches the kernel or raises.
* ``make_batched_mutation`` returns the ``batched_mutation`` hook of
  ``infer.smc.SMC``: ``(q', ll', accept, next_step)``, ll' the final
  particles' log-likelihood, which the next stage's reweight reuses.

The 128-particle block is the adaptation's semantics, as on the TPU: a
population that is not a multiple of 128 is padded with particles at q = 0
with zero momentum that are never accepted and whose accept probabilities
count in their block's mean.  The TPU's 128-lane padding of q is not
ported: the particles carry their real dim coordinates.

The kernel runs one cluster of ``CLUSTER`` blocks per 128-particle block,
of ``THREADS_EXACT`` threads at K = 3, D = 2 and ``THREADS_GENERIC`` at
the other shapes; ``launch_geometry`` gives its shape at P particles and
``device_geometry`` the library's own, with the clusters the card can hold
at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from .fused_nuts import _ptr, _raise, _stream
from .gmm_logprob import MAX_COMPONENTS, MAX_DATA_DIM

__all__ = ["make_gmm_potential_flat", "mutation_core", "fused_gmm_mutate",
           "make_batched_mutation", "potential_constant", "launch_geometry",
           "device_geometry", "PB", "CLUSTER", "THREADS_EXACT",
           "THREADS_GENERIC", "CHUNK"]

_LOG_2PI = math.log(2.0 * math.pi)
PB = 128        # particles per adaptation block (PB of csrc/fused_smc_gmm.cu)
CLUSTER = 2     # blocks per cluster, one cluster per adaptation block (CL)
# threads per block: 32 warps at K = 3, D = 2, 16 at the generic instance
# (32 * NW_EXACT, 32 * NW_GENERIC)
THREADS_EXACT, THREADS_GENERIC = 1024, 512
CHUNK = 16      # points whose sums a lane multiplies before one log (kChunk)

# launches of the mutation kernel; one launch is one stage's mutation of
# every particle
LAUNCHES = 0


def _dim(k, d):
    return (k - 1) + k * d + k


def launch_geometry(p, k, d):
    """The kernel's launch for ``p`` particles of a (K, D) mixture: blocks
    per cluster, threads per block, blocks in all and particles per
    warp."""
    threads = THREADS_EXACT if (k, d) == (3, 2) else THREADS_GENERIC
    return dict(cluster=CLUSTER, threads=threads,
                ctas=CLUSTER * -(-p // PB),
                particles_per_warp=PB // (CLUSTER * threads // 32))


def device_geometry(n, k, d):
    """The library's launch geometry at (N, K, D), as ``launch_geometry``
    names it (without ``ctas``), and ``max_active_clusters``: the clusters
    that can be resident on the current card at once
    (``cudaOccupancyMaxActiveClusters``).  Needs a CUDA card."""
    import ctypes

    lib = _build.load()
    out = (ctypes.c_int * 4)()
    _raise(lib.smc_gmm_mutate_geometry(n, k, d, out),
           "smc_gmm_mutate_geometry")
    return dict(zip(("cluster", "threads", "particles_per_warp",
                     "max_active_clusters"), out))


def potential_constant(k, d):
    """The potential's constant: -log Dirichlet(1) density, the means'
    and the HalfNormal(2) scales' normalisers."""
    return (-math.lgamma(k) + k * d * (0.5 * _LOG_2PI + math.log(5.0))
            - k * (0.5 * math.log(2.0 / math.pi) - math.log(2.0)))


def make_gmm_potential_flat(x, k, d):
    """``pg(q (P, dim), beta) -> (pe (P,), grad (P, dim), ll (P,))`` over
    the data x (N, D), with the hand-derived gradient."""
    off_mu, off_us = k - 1, k - 1 + k * d
    const = potential_constant(k, d)

    def pg(q, beta):
        p = q.shape[0]
        uw = q[:, :off_mu]
        mus = q[:, off_mu:off_us].reshape(p, k, d)
        us = q[:, off_us:]
        t = uw - torch.log(torch.arange(k - 1, 0, -1, dtype=q.dtype,
                                        device=q.device))
        z = torch.sigmoid(t)
        log_z, log1mz = F.logsigmoid(t), F.logsigmoid(-t)
        cums = torch.cumsum(log1mz, 1)                   # (P, K-1)
        rem_excl = torch.cat([torch.zeros_like(cums[:, :1]),
                              cums[:, :-1]], 1)
        logw = torch.cat([log_z + rem_excl, cums[:, -1:]], 1)
        ldj = torch.sum(log_z + log1mz + rem_excl, 1)
        sig = torch.exp(us)
        inv_s2 = 1.0 / (sig * sig)
        dx = x - mus[:, :, None, :]                       # (P, K, N, D)
        qd = torch.sum(dx * dx, -1)
        lk = (logw - d * us - 0.5 * d * _LOG_2PI)[..., None] \
            - 0.5 * qd * inv_s2[..., None]                # (P, K, N)
        lse = torch.logsumexp(lk, 1)                     # (P, N)
        resp = torch.exp(lk - lse[:, None])
        ll = lse.sum(1)
        r = resp.sum(-1)
        rq = (resp * qd).sum(-1)
        rdx = (resp[..., None] * dx).sum(2)               # (P, K, D)
        pe = (const - ldj + torch.sum(mus * mus, (1, 2)) / 50.0
              + torch.sum(sig * sig, 1) / 8.0 - torch.sum(us, 1) - beta * ll)
        # d ll / d uw_j = r_j (1 - z_j) - z_j sum_{i>j} r_i;
        # d ldj / d uw_j = (1 - 2 z_j) - z_j (K - 2 - j)
        tail = torch.flip(torch.cumsum(torch.flip(r, [1]), 1), [1])[:, 1:]
        dll = r[:, :-1] * (1.0 - z) - z * tail
        dldj = (1.0 - 2.0 * z) - z * torch.arange(
            k - 2, -1, -1, dtype=q.dtype, device=q.device)
        g_uw = -dldj - beta * dll
        g_mu = mus / 25.0 - beta * rdx * inv_s2[..., None]
        g_us = sig * sig / 4.0 - 1.0 - beta * (rq * inv_s2 - d * r)
        return pe, torch.cat([g_uw, g_mu.reshape(p, -1), g_us], 1), ll

    return pg


def mutation_core(q, mom, log_u, beta, eps0, m_inv, pg, kmut, lsteps,
                  target_accept, block=PB):
    """K HMC transitions of every particle, with dual averaging of the step
    size per block of ``block`` particles (t0 = 2, gamma = 0.05, kappa =
    0.75, mu = log eps0: the SMC tracking configuration).

    q (P, dim) with P a multiple of ``block``; mom (kmut, P, dim) pre-scaled
    momenta; log_u (P, kmut) log-uniforms; beta, eps0 numbers or
    one-element tensors; m_inv (dim,).  Returns (q', ll' (P,), mean accept
    (P,), averaged step per block (P // block,))."""
    p = q.shape[0]
    nb = p // block
    if nb * block != p:
        raise ValueError(f"P = {p} is not a multiple of the block {block}")
    beta = torch.as_tensor(beta, dtype=q.dtype, device=q.device).reshape(())
    log_eps0 = torch.log(torch.as_tensor(eps0, dtype=q.dtype,
                                         device=q.device)).reshape(())
    m_inv = m_inv.reshape(-1)
    pe, g, ll = pg(q, beta)
    log_step = log_eps0.expand(nb)
    log_avg, grad_avg = log_step, torch.zeros_like(log_step)
    acc = torch.zeros_like(pe)
    for t in range(kmut):
        eps = torch.exp(log_step).repeat_interleave(block)[:, None]
        p0 = mom[t]
        h0 = pe + 0.5 * torch.sum(p0 * p0 * m_inv, 1)
        qq, pp, gg = q, p0, g
        for _ in range(lsteps):
            pp = pp - 0.5 * eps * gg
            qq = qq + eps * m_inv * pp
            pe1, gg, ll1 = pg(qq, beta)
            pp = pp - 0.5 * eps * gg
        delta = pe1 + 0.5 * torch.sum(pp * pp * m_inv, 1) - h0
        delta = torch.where(torch.isnan(delta), math.inf, delta)
        log_a = torch.clamp(-delta, max=0.0)
        a = torch.exp(log_a)
        take = log_u[:, t] < log_a
        q = torch.where(take[:, None], qq, q)
        g = torch.where(take[:, None], gg, g)
        pe = torch.where(take, pe1, pe)
        ll = torch.where(take, ll1, ll)
        acc = acc + a
        a_mean = a.reshape(nb, block).mean(1)
        t2 = float(t + 1)
        eta_h = 1.0 / (t2 + 2.0)
        grad_avg = (1.0 - eta_h) * grad_avg + eta_h * (target_accept - a_mean)
        log_step = log_eps0 - math.sqrt(t2) / 0.05 * grad_avg
        eta_x = math.exp(-0.75 * math.log(t2))
        log_avg = eta_x * log_step + (1.0 - eta_x) * log_avg
    return q, ll, acc / kmut, torch.exp(log_avg)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _pad_rows(t, rows, dim=0):
    if t.shape[dim] == rows:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, rows - t.shape[dim]]
    return F.pad(t, pad)


def fused_gmm_mutate(q, mom, log_u, beta, step_size, m_inv, x, *, k, d, kmut,
                     lsteps, target_accept=0.65):
    """One stage's mutation of every particle.

    q (P, dim) flat unconstrained particles; mom (kmut, P, dim) pre-scaled
    momenta; log_u (P, kmut) log-uniforms; beta and step_size numbers or
    one-element tensors (a tensor on q's device avoids a host sync); m_inv
    (dim,) the diagonal inverse mass; x (N, D) the data.  Any P: a last
    block that is not full is padded (see the module docstring).  Returns
    (q' (P, dim), ll' (P,), mean accept (P,), averaged step per block
    (ceil(P / 128),))."""
    global LAUNCHES
    p, dim = q.shape
    if dim != _dim(k, d):
        raise ValueError(f"q must be (P, (K-1) + K*D + K) = (P, {_dim(k, d)})")
    if q.device.type == "cpu":
        p_pad = -(-p // PB) * PB
        out = mutation_core(
            _pad_rows(q, p_pad), _pad_rows(mom, p_pad, 1),
            _pad_rows(log_u, p_pad), beta, step_size, m_inv,
            make_gmm_potential_flat(x, k, d), kmut, lsteps, target_accept)
        return out[0][:p], out[1][:p], out[2][:p], out[3]
    if q.device.type != "cuda":
        raise ValueError(f"fused_gmm_mutate: unsupported device {q.device}")
    if not (2 <= k <= MAX_COMPONENTS and 1 <= d <= MAX_DATA_DIM):
        raise ValueError(f"the kernel takes 2 <= K <= {MAX_COMPONENTS} and "
                         f"D <= {MAX_DATA_DIM}, got K={k}, D={d}")
    n = x.shape[0]
    want = {"q": (q, (p, dim)), "mom": (mom, (kmut, p, dim)),
            "log_u": (log_u, (p, kmut)), "m_inv": (m_inv.reshape(-1), (dim,)),
            "x": (x, (n, d))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32 {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if kmut < 1 or lsteps < 1:
        raise ValueError("kmut and lsteps must be at least 1")
    scal = [torch.as_tensor(v, dtype=torch.float32, device=q.device)
            .reshape(1).contiguous() for v in (beta, step_size)]
    lib = _build.load()
    if lib.smc_gmm_mutate_smem_bytes(n, k, d) == 0:
        raise ValueError(f"N = {n} points of D = {d} do not fit one block's "
                         f"shared memory")
    q2 = torch.empty_like(q)
    ll, acc = (torch.empty(p, dtype=torch.float32, device=q.device)
               for _ in range(2))
    eps_b = torch.empty(-(-p // PB), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.smc_gmm_mutate(
            _ptr(q), _ptr(mom), _ptr(log_u), _ptr(want["m_inv"][0]), _ptr(x),
            _ptr(scal[0]), _ptr(scal[1]), _ptr(q2), _ptr(ll), _ptr(acc),
            _ptr(eps_b), p, n, k, d, int(kmut), int(lsteps),
            float(target_accept), float(potential_constant(k, d)),
            _stream(q.device))
    _raise(err, "smc_gmm_mutate")
    LAUNCHES += 1
    return q2, ll, acc, eps_b


# ---------------------------------------------------------------------------
# SMC integration
# ---------------------------------------------------------------------------

def make_batched_mutation(x, k, d, *, kmut, lsteps, target_accept=0.65):
    """A ``batched_mutation(q, beta, step_size, m_inv, mom, log_u)`` for
    ``infer.smc.SMC``: ``mom`` (kmut, P, dim) standard normals and
    ``log_u`` (P, kmut) log-uniforms are the stage's draws; the momenta are
    scaled by 1/sqrt(m_inv) here.  Returns ``(q', ll', accept,
    next_step)``, next_step the geometric mean of the blocks' steps clipped
    to [1e-5, 2]."""
    x = x.to(torch.float32).contiguous()

    def mutate(q, beta, step_size, m_inv, mom, log_u):
        dim = q.shape[1]
        if m_inv is None:
            m_inv = torch.ones(dim, dtype=torch.float32, device=q.device)
        mom = (mom / torch.sqrt(m_inv)).contiguous()
        q2, ll, acc, eps_b = fused_gmm_mutate(
            q.contiguous(), mom, log_u.contiguous(), beta, step_size,
            m_inv.contiguous(), x, k=k, d=d, kmut=kmut, lsteps=lsteps,
            target_accept=target_accept)
        next_step = torch.clamp(torch.exp(torch.mean(torch.log(eps_b))),
                                1e-5, 2.0)
        return q2, ll, acc.mean(), next_step

    return mutate
