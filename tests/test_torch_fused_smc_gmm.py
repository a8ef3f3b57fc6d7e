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

The kernel itself runs only on a CUDA card: ``test_kernel_matches_plain``
is marked ``gpu`` and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.ops import fused_smc_gmm as jfsg
from bayesic_tpu_torch import interop
from bayesic_tpu_torch.models import gmm as tgmm
from bayesic_tpu_torch.ops import fused_smc_gmm as tfsg

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


def _inputs(c, kmut, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(0.0, 0.5, (c, DIM)).astype(np.float32)
    mom = rng.normal(0.0, 1.0, (kmut, c, DIM)).astype(np.float32)
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


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card: the mutation kernel against ``mutation_core`` on
    the same draws, on 2 blocks and on a population that is not a multiple
    of 128: with one transition, accept probabilities within rtol 1e-3
    and atol 2e-4, every differing accept decision within 1e-2 of its
    threshold, and q' / ll' where the decisions agree; with three, the
    per-block steps within 10% and the mean accept within 0.01."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    x = torch.as_tensor(_x(), device=dev)
    for p, kmut in ((256, 1), (200, 1), (256, 3), (200, 3)):
        q, mom, log_u = (torch.as_tensor(a, device=dev)
                         for a in _inputs(p, kmut, seed=p + kmut))
        args = (q, mom, log_u, 0.7, 0.05, torch.ones(DIM, device=dev), x)
        kw = dict(k=K, d=D, kmut=kmut, lsteps=4)
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
