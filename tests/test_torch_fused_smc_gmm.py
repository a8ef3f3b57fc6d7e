"""Parity of the port's fused SMC mutation (``ops/fused_smc_gmm.py``) with
the JAX package.

Data come from the shared numpy recipe (the port's ``gmm.make_data``);
particles, momenta and log-uniforms are made with numpy and go to both
packages.  The JAX side runs its plain functions on its 128-lane layout
(``make_gmm_potential_flat``, ``mutation_core``) and its Pallas kernel in
interpret mode; its pad lanes hold zero q and zero momentum, so they stay
fixed and the lane-padded dynamics are the port's.  A population that is
not a multiple of 128 reaches the JAX kernel padded with particles at
q = 0, zero momentum and log u = 0, the port's own padding.

Tolerances: potential ll and pe rtol 1e-5 (the JAX's squared distance is
the expanded |x|^2 - 2 mu.x + |mu|^2), gradient within 1e-4 of max|g|;
mutation q' atol 2e-5, ll' atol 2e-3, accept and per-block step atol
2e-4, all rtol 1e-3 (the JAX package's own kernel-vs-core tolerances).

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``,
``test_kernel_repeats_bit_for_bit`` and ``test_device_geometry`` are
marked ``gpu`` and skip here.  What the CPU can check of it:
``test_mutation_arithmetic_precision`` emulates its per-point arithmetic
(log2-domain constants, ex2/lg2/rcp at the PTX ISA's error bounds, the
chunked product of sums under one log, the lanes' order and the
butterfly; the point loop through ``tests/gmm_log2_emulation.py``, which
the value+grad likelihood kernel's test shares) in numpy float32 against
float64, and the launch geometry and the chunk length are checked against
the sources.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmm_log2_emulation as emu
from bayesic_tpu.ops import fused_smc_gmm as jfsg
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.dist import StickBreaking
from bayesic_tpu_torch.models import gmm as tgmm
from bayesic_tpu_torch.ops import fused_smc_gmm as tfsg
from bayesic_tpu_torch.ops.gmm_logprob import MAX_COMPONENTS

torch.set_num_threads(2)

K, D = 3, 2
DIM = (K - 1) + K * D + K


def _x(num_data=200):
    x, _ = tgmm.make_data(tgmm.Config(num_data=num_data))
    return x


def _xt(x, bn=512):
    n = x.shape[0]
    n_pad = -(-n // bn) * bn
    return jnp.pad(jnp.asarray(x).T, ((0, 0), (0, n_pad - n))), n


def _lanes(a):
    out = np.zeros(a.shape[:-1] + (128,), np.float32)
    out[..., :a.shape[-1]] = a
    return jnp.asarray(out)


def _inputs(c, kmut, seed=1, dim=DIM):
    rng = np.random.default_rng(seed)
    q = rng.normal(0.0, 0.5, (c, dim)).astype(np.float32)
    mom = rng.normal(0.0, 1.0, (kmut, c, dim)).astype(np.float32)
    log_u = np.log(rng.uniform(1e-6, 1.0, (c, kmut))).astype(np.float32)
    return q, mom, log_u


@pytest.mark.parametrize("beta", [0.0, 0.3, 1.0])
def test_potential_matches_jax(beta):
    x = _x()
    q = np.random.default_rng(0).normal(0.0, 0.6, (16, DIM)) \
        .astype(np.float32)
    xt, n = _xt(x)
    pe_j, g_j, ll_j = jfsg.make_gmm_potential_flat(xt, n, K, D)(
        _lanes(q), jnp.full((1, 1), beta))
    pe, g, ll = tfsg.make_gmm_potential_flat(torch.as_tensor(x), K, D)(
        torch.as_tensor(q), beta)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j)[:, 0], rtol=1e-5)
    np.testing.assert_allclose(pe.numpy(), np.asarray(pe_j)[:, 0], rtol=1e-5)
    g_j = np.asarray(g_j)[:, :DIM]
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())


def test_potential_matches_autograd_of_the_model():
    """The hand-derived gradient equals autograd of the DSL density
    parts at beta = 0.7, and pe equals -(log prior + beta ll)."""
    x = torch.as_tensor(_x())
    smc = tgmm.make_smc(tgmm.Config(num_data=200), x, "generic",
                        num_particles=16)
    q = torch.as_tensor(np.random.default_rng(2).normal(0.0, 0.6, (16, DIM))
                        .astype(np.float32))
    pe, g, ll = tfsg.make_gmm_potential_flat(x, K, D)(q, 0.7)
    pe_r, g_r = smc._pe_and_grad(q, torch.tensor(0.7))
    torch.testing.assert_close(pe, pe_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(g, g_r, rtol=0,
                               atol=1e-4 * float(g_r.abs().max()))
    torch.testing.assert_close(ll, smc._parts_batched(q)[1], rtol=1e-5,
                               atol=0)


def test_mutation_core_matches_jax_core():
    """One block of 64 particles, 3 transitions of 4 leapfrogs."""
    x = _x()
    xt, n = _xt(x)
    kmut, c = 3, 64
    q, mom, log_u = _inputs(c, kmut)
    want = jfsg.mutation_core(
        _lanes(q), _lanes(mom), jnp.asarray(log_u), jnp.full((1, 1), 0.5),
        jnp.full((1, 1), 0.05), jnp.ones((1, 128)),
        jfsg.make_gmm_potential_flat(xt, n, K, D), kmut, 4, 0.65)
    got = tfsg.mutation_core(
        *map(torch.as_tensor, (q, mom, log_u)), 0.5, 0.05, torch.ones(DIM),
        tfsg.make_gmm_potential_flat(torch.as_tensor(x), K, D), kmut, 4,
        0.65, block=c)
    assert bool((got[0] != torch.as_tensor(q)).any())
    np.testing.assert_array_equal(np.asarray(want[0])[:, DIM:], 0.0)
    for g_, w_, tol in zip(got, (np.asarray(want[0])[:, :DIM],
                                 np.asarray(want[1])[:, 0],
                                 np.asarray(want[2])[:, 0],
                                 np.asarray(want[3]).reshape(1)),
                           (2e-5, 2e-3, 2e-4, 2e-4)):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-3, atol=tol)
    # the returned ll is the likelihood of the returned particles
    ll_chk = tfsg.make_gmm_potential_flat(torch.as_tensor(x), K, D)(
        got[0], 0.5)[2]
    torch.testing.assert_close(got[1], ll_chk, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("p", [256, 200])
def test_fused_gmm_mutate_matches_jax_kernel(p):
    """The port's kernel entry on a CPU tensor (the plain core) against
    the JAX Pallas kernel in interpret mode: 2 blocks, and a population
    that is not a multiple of 128."""
    x = _x()
    xt, n = _xt(x)
    kmut, lsteps = 3, 4
    q, mom, log_u = _inputs(p, kmut, seed=5)
    p_pad = -(-p // 128) * 128
    qj = np.zeros((p_pad, DIM), np.float32)
    qj[:p] = q
    momj = np.zeros((kmut, p_pad, DIM), np.float32)
    momj[:, :p] = mom
    luj = np.zeros((p_pad, kmut), np.float32)
    luj[:p] = log_u
    want = jfsg.fused_gmm_mutate(
        _lanes(qj), _lanes(momj), jnp.asarray(luj), jnp.full((1, 1), 0.7),
        jnp.full((1, 1), 0.05), jnp.ones((1, 128)), xt, n=n, k=K, d=D,
        kmut=kmut, lsteps=lsteps, target_accept=0.65, interpret=True)
    got = tfsg.fused_gmm_mutate(
        *map(torch.as_tensor, (q, mom, log_u)), 0.7, 0.05, torch.ones(DIM),
        torch.as_tensor(x), k=K, d=D, kmut=kmut, lsteps=lsteps)
    assert got[3].shape == (p_pad // 128,)
    eps_rows = np.asarray(want[3]).reshape(p_pad // 128, 128)
    for g_, w_, tol in zip(got, (interop.smc_particles(want[0], DIM)[:p],
                                 np.asarray(want[1])[:p, 0],
                                 np.asarray(want[2])[:p, 0],
                                 eps_rows[:, 0]),
                           (2e-5, 2e-3, 2e-4, 2e-4)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-3,
                                   atol=tol)


def test_batched_mutation_scales_momenta_and_pools_steps():
    """``make_batched_mutation`` scales the normals by 1/sqrt(m_inv) and
    returns the mean accept and the geometric mean of the blocks' steps."""
    x = torch.as_tensor(_x())
    q, mom, log_u = map(torch.as_tensor, _inputs(200, 2, seed=7))
    m_inv = torch.linspace(0.5, 2.0, DIM)
    mut = tfsg.make_batched_mutation(x, K, D, kmut=2, lsteps=3)
    q2, ll, acc, step = mut(q, torch.tensor(0.4), torch.tensor(0.05), m_inv,
                            mom, log_u)
    want = tfsg.fused_gmm_mutate(q, mom / torch.sqrt(m_inv), log_u, 0.4,
                                 0.05, m_inv, x, k=K, d=D, kmut=2, lsteps=3)
    torch.testing.assert_close(q2, want[0])
    torch.testing.assert_close(ll, want[1])
    torch.testing.assert_close(acc, want[2].mean())
    torch.testing.assert_close(step, torch.exp(torch.log(want[3]).mean()))
    assert 0.0 < float(acc) <= 1.0


def test_wrapper_checks():
    x = torch.as_tensor(_x(20))
    q, mom, log_u = map(torch.as_tensor, _inputs(4, 2))
    kw = dict(k=K, d=D, kmut=2, lsteps=2)
    with pytest.raises(ValueError, match="q must be"):
        tfsg.fused_gmm_mutate(q[:, :5], mom, log_u, 0.5, 0.1,
                              torch.ones(DIM), x, **kw)
    meta = [t.to("meta") for t in (q, mom, log_u)]
    with pytest.raises(ValueError, match="unsupported device"):
        tfsg.fused_gmm_mutate(*meta, 0.5, 0.1, torch.ones(DIM), x, **kw)


_F32 = np.float32
_CU = Path(tfsg.__file__).resolve().parents[1] / "csrc" / "fused_smc_gmm.cu"
# the point loop and its chunk length live in the header it shares with the
# value+grad likelihood kernel
_CUH = _CU.with_name("gmm_lik.cuh")


def _softplus(v):
    return np.maximum(v, _F32(0)) + np.log1p(np.exp(-np.abs(v)))


def _emulated_potential(q, x, beta, sign):
    """pe, grad and ll of the particles q (P, dim) as the kernel computes
    them at K = 3, D = 2 (particle_terms, points_log2, eval_group) in
    float32, every ex2, lg2 and rcp moved by ``sign`` times its bound."""
    k, d = K, D
    off_mu, off_us = k - 1, k - 1 + k * d
    q, x = q.astype(_F32), x.astype(_F32)
    p = q.shape[0]
    # particle_terms
    t = q[:, :k - 1] - np.log(np.arange(k - 1, 0, -1)).astype(_F32)
    z = _F32(1) / (_F32(1) + np.exp(-t))
    lz, l1mz = -_softplus(-t), -_softplus(t)
    cum = np.zeros(p, _F32)
    ldj = np.zeros(p, _F32)
    logw = np.zeros((p, k), _F32)
    for j in range(k - 1):
        logw[:, j] = lz[:, j] + cum
        ldj = ldj + (lz[:, j] + l1mz[:, j] + cum)
        cum = cum + l1mz[:, j]
    logw[:, k - 1] = cum
    us = q[:, off_us:]
    sg = np.exp(us)
    inv_s2 = _F32(1) / (sg * sg)
    mu = q[:, off_mu:off_us].reshape(p, k, d)
    c2 = emu.LOG2E * (logw - _F32(d) * us - _F32(d) * emu.HALF_LOG_2PI)
    h2 = _F32(0.5 * np.log2(np.e)) * inv_s2
    # points_log2 (tests/gmm_log2_emulation.py), then eval_group's butterfly
    ll2, r, rq, rdx = emu.points_log2(c2, h2, mu, x, sign, tfsg.CHUNK)
    ll = emu.LN2 * ll2
    # eval_group's epilogue
    beta = _F32(beta)
    pe = _F32(tfsg.potential_constant(k, d)) - ldj - beta * ll
    for kk in range(k):
        pe = pe + (sg[:, kk] * sg[:, kk] * _F32(0.125) - us[:, kk])
        for j in range(d):
            pe = pe + mu[:, kk, j] * mu[:, kk, j] * _F32(0.02)
    g = np.zeros((p, DIM), _F32)
    for j in range(k - 1):
        suf = np.zeros(p, _F32)
        for kk in range(j + 1, k):
            suf = suf + r[:, kk]
        dll = r[:, j] * (1 - z[:, j]) - z[:, j] * suf
        dldj = (1 - 2 * z[:, j]) - z[:, j] * _F32(k - 2 - j)
        g[:, j] = -dldj - beta * dll
    g[:, off_mu:off_us] = (mu * _F32(0.04) - beta * (
        rdx * inv_s2[..., None])).reshape(p, -1)
    g[:, off_us:] = sg * sg * _F32(0.25) - 1 - beta * (rq * inv_s2
                                                        - _F32(d) * r)
    return pe, g, ll


def test_mutation_arithmetic_precision():
    """The kernel's per-point arithmetic (log2-domain constants, one ex2
    per component, one rcp, the sums of CHUNK points multiplied under one
    lg2 and the maxes summed apart), emulated in float32 with every
    approximate function at its PTX ISA bound in either direction, at N
    2,000, K 3, D 2 for particles near the truth and far from it: ll and
    pe within rel 1e-5 and the gradient within 1e-4 of max|g| of float64
    (phase 18's and the potential tests' limits)."""
    cfg = tgmm.Config(num_data=2000)
    x, truth = tgmm.make_data(cfg)
    rng = np.random.default_rng(11)
    base = np.concatenate([
        StickBreaking().inverse(torch.as_tensor(truth["weights"])).numpy(),
        truth["centers"].reshape(-1), np.log(truth["scales"])])
    sets = {"near": base + rng.normal(0.0, 0.03, (8, DIM)),
            "prior": rng.normal(0.0, 0.5, (8, DIM)),
            "far": rng.normal(0.0, 3.0, (8, DIM))}
    pg64 = tfsg.make_gmm_potential_flat(
        torch.as_tensor(x, dtype=torch.float64), K, D)
    for name, q in sets.items():
        q = q.astype(np.float32)
        pe_r, g_r, ll_r = (a.numpy() for a in pg64(
            torch.as_tensor(q, dtype=torch.float64), 1.0))
        for sign in (1.0, -1.0):
            pe, g, ll = _emulated_potential(q, x, 1.0, sign)
            ll_err = np.abs(ll - ll_r) / np.abs(ll_r)
            pe_err = np.abs(pe - pe_r) / np.abs(pe_r)
            g_err = np.abs(g - g_r).max() / np.abs(g_r).max()
            assert ll_err.max() < 1e-5, (name, sign, ll_err.max())
            assert pe_err.max() < 1e-5, (name, sign, pe_err.max())
            assert g_err < 1e-4, (name, sign, g_err)


def test_chunk_product_cannot_overflow():
    """A point's sum of component exps lies in [1, K] (the largest is ex2(0)
    = 1), so a lane's product over CHUNK points lies in [1, K^CHUNK]: at
    K = 8, the most the kernel takes, with every ex2 at its bound and
    every product rounded up, it stays finite and below 2^64 in float32,
    and the kernels' chunk (``kChunk`` of gmm_lik.cuh) is this one."""
    assert MAX_COMPONENTS == 8
    se = _F32(MAX_COMPONENTS * (1 + emu.EX2_REL) * (1 + 2.0 ** -23))
    prod = _F32(1)
    for _ in range(tfsg.CHUNK):
        prod = _F32(np.float64(prod) * se * (1 + 2.0 ** -23))
    assert np.isfinite(prod) and 1.0 <= prod < 2.0 ** 64
    src = _CUH.read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == tfsg.CHUNK


@pytest.mark.parametrize("p, ctas", [(40, 2), (200, 4), (256, 4),
                                     (8192, 128)])
def test_launch_geometry(p, ctas):
    """A cluster of CLUSTER blocks per 128-particle block: P 40 is one
    cluster whose second block holds only padding, P 200 is ragged across
    blocks, P 8192 fills 128 blocks; 32 warps a block at K 3, D 2 and 16 at
    the generic instance; the constants are the kernel's."""
    src = _CU.read_text()
    consts = {name: int(re.search(rf"int {name} = (\d+);", src).group(1))
              for name in ("PB", "CL", "NW_EXACT", "NW_GENERIC")}
    assert (consts["PB"], consts["CL"]) == (tfsg.PB, tfsg.CLUSTER)
    for (k, d), nw in (((K, D), consts["NW_EXACT"]),
                       ((4, 3), consts["NW_GENERIC"])):
        g = tfsg.launch_geometry(p, k, d)
        assert g["ctas"] == ctas and g["ctas"] % g["cluster"] == 0
        assert g["threads"] == 32 * nw
        assert g["cluster"] * nw * g["particles_per_warp"] == tfsg.PB


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _generic_x(dev, num_data=200):
    """Data of the generic instance's case, K 4, D 3."""
    x, _ = tgmm.make_data(tgmm.Config(num_components=4, data_dim=3,
                                      num_data=num_data))
    return torch.as_tensor(x, device=dev)


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card: the mutation kernel against ``mutation_core`` on
    the same draws: at K 3, D 2 on a lone block whose second cluster block
    holds only padding (P 40), a population ragged across blocks (P 200)
    and 2 blocks (P 256); at K 4, D 3 (the generic instance) on P 200.
    With one transition, accept probabilities within rtol 1e-3 and atol
    2e-4, every differing accept decision within 1e-2 of its threshold,
    and q' / ll' where the decisions agree; with three, the per-block
    steps within 10% and the mean accept within 0.01."""
    dev = _gpu()
    data = {(K, D): torch.as_tensor(_x(), device=dev),
            (4, 3): _generic_x(dev)}
    cases = [(K, D, p) for p in (40, 200, 256)] + [(4, 3, 200)]
    for (k, d, p), kmut in ((c, km) for c in cases for km in (1, 3)):
        dim = (k - 1) + k * d + k
        x = data[(k, d)]
        q, mom, log_u = (torch.as_tensor(a, device=dev) for a in
                         _inputs(p, kmut, seed=p + kmut + 10 * k, dim=dim))
        args = (q, mom, log_u, 0.7, 0.05, torch.ones(dim, device=dev), x)
        kw = dict(k=k, d=d, kmut=kmut, lsteps=4)
        before = tfsg.LAUNCHES
        got = tfsg.fused_gmm_mutate(*args, **kw)
        torch.cuda.synchronize()
        assert tfsg.LAUNCHES == before + 1
        want = tfsg.fused_gmm_mutate(*(a.cpu() if torch.is_tensor(a) else a
                                       for a in args), **kw)
        want = [w.to(dev) for w in want]
        if kmut == 1:
            # a = exp(-(H1 - H0)) with |H| ~ 1e3: float32 rounding of the
            # energies moves a by ~1e-4 (the JAX package's own accept
            # tolerance, rtol 1e-3 and atol 2e-4)
            torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=2e-4)
            moved_k = (got[0] != q).any(1)
            moved_p = (want[0] != q).any(1)
            differ = moved_k != moved_p
            log_a = torch.log(want[2])
            assert bool(((log_u[:, 0] - log_a).abs()[differ] < 1e-2).all())
            same = ~differ
            torch.testing.assert_close(got[0][same], want[0][same],
                                       rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(got[1][same], want[1][same],
                                       rtol=1e-5, atol=1e-3)
        else:
            # the blocks' adaptation feeds each block's mean accept back
            # into its step size, amplifying float32 rounding of the
            # energies: the outcome is compared (chip_smoke phase 18's
            # limits)
            torch.testing.assert_close(got[3], want[3], rtol=0.1, atol=0)
            torch.testing.assert_close(got[2].mean(), want[2].mean(),
                                       rtol=0, atol=0.01)


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit():
    """Two launches on the same inputs give the same bits: the cluster's
    mean accept is summed in one fixed order, with no atomics."""
    dev = _gpu()
    for k, d, x in ((K, D, torch.as_tensor(_x(), device=dev)),
                    (4, 3, _generic_x(dev))):
        dim = (k - 1) + k * d + k
        q, mom, log_u = (torch.as_tensor(a, device=dev)
                         for a in _inputs(200, 3, seed=3, dim=dim))
        args = (q, mom, log_u, 0.7, 0.05, torch.ones(dim, device=dev), x)
        kw = dict(k=k, d=d, kmut=3, lsteps=4)
        one = tfsg.fused_gmm_mutate(*args, **kw)
        two = tfsg.fused_gmm_mutate(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(one, two):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_device_geometry():
    """The library launches the geometry ``launch_geometry`` gives, and
    the card can hold at least one of its clusters."""
    _gpu()
    for k, d in ((K, D), (4, 3)):
        want = tfsg.launch_geometry(128, k, d)
        got = tfsg.device_geometry(2000, k, d)
        assert got["max_active_clusters"] >= 1
        assert {kk: got[kk] for kk in ("cluster", "threads",
                                       "particles_per_warp")} \
            == {kk: want[kk] for kk in ("cluster", "threads",
                                        "particles_per_warp")}
