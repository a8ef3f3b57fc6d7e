"""Parity of the port's fused NUTS transition (``ops/fused_nuts.py``) and
its one batched NUTS core (``infer/mcmc/nuts.nuts_core``) with the JAX
package.

Inputs, decoder weights and the transition's random streams come from numpy
with a seed and go to both packages.  The JAX side runs its plain
functions: the lane-packed potential at ``mm_dtype=float32`` and the shared
transition core ``_nuts_transition_core`` (what its Pallas kernel runs in
interpret mode).  The port runs the precision it ships, fp32 throughout.
Tolerances: potential pe rtol 1e-5, grad within 1e-4 * max|grad|; one
transition: equal depth, num_steps and diverging, q' / pe' / h0 rtol 1e-5
(q' with atol 1e-5 for coordinates near zero); the posterior of the two
DLGM entry points as in ``tests/test_fused_nuts.py``.

The kernel computes the potential's products on the tensor cores in TF32
with both operands split (three passes); ``test_operand_split_precision``
emulates that arithmetic on the CPU at the bench widths.  The kernel itself
runs only on a CUDA card: the tests marked ``gpu`` skip here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.ops import fused_nuts as jfn
from bayesic_tpu_torch.infer.mcmc import MCMC, NUTSStreams, nuts_core
from bayesic_tpu_torch.models import dlgm as tdlgm
from bayesic_tpu_torch.ops import fused_nuts as tfn

torch.set_num_threads(2)

NB, LATENT, HIDDEN, DATA = 16, 8, 16, 8
D = NB * LATENT
C, K = 8, 5
SIGMA = 0.4


def _weights(seed):
    """Decoder weights (in, out) and a data batch, numpy float32."""
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(LATENT, HIDDEN)) / np.sqrt(LATENT)
    b1 = 0.1 * rng.normal(size=HIDDEN)
    w2 = rng.normal(size=(HIDDEN, DATA)) / np.sqrt(HIDDEN)
    b2 = 0.1 * rng.normal(size=DATA)
    x = rng.normal(size=(NB, DATA))
    return [a.astype(np.float32) for a in (w1, b1, w2, b2, x)]


def _streams(seed, c=C, kk=K, scale=0.5):
    """A start point, momenta and the transition's streams, as
    ``ops/fused_nuts.make_batched_transition`` draws them: exact +-1 signs
    and strictly negative log-uniforms."""
    rng = np.random.default_rng(seed)
    q = (scale * rng.normal(size=(c, D))).astype(np.float32)
    mom = rng.normal(size=(c, D)).astype(np.float32)
    sign = np.where(rng.random((c, kk)) < 0.5, 1.0, -1.0).astype(np.float32)
    lua = np.log(np.maximum(rng.random((c, kk)), 1e-38)).astype(np.float32)
    lul = np.log(np.maximum(rng.random((c, 1 << kk)), 1e-38)) \
        .astype(np.float32)
    return q, mom, sign, lua, lul


def _jax_pg(weights, c):
    w1, b1, w2, b2, x = weights
    dec = {"params": {"Dense_0": {"kernel": w1, "bias": b1},
                      "Dense_1": {"kernel": w2, "bias": b2}}}
    r = 128 // LATENT
    packed = jfn.pack_decoder(dec, LATENT, HIDDEN, DATA)
    return jfn.make_packed_potential(
        *packed, jfn.pack_x(x, LATENT, c), SIGMA, NB // r, c, NB, LATENT,
        DATA, mm_dtype=jnp.float32)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _model_potential(weights):
    """pe/grad by autograd of the port's DSL model (the generic path)."""
    w1, b1, w2, b2, x = _t(*weights)
    dec = tdlgm.Decoder(LATENT, HIDDEN, DATA)
    params = {"Dense_0.weight": w1.T, "Dense_0.bias": b1,
              "Dense_1.weight": w2.T, "Dense_1.bias": b2}
    cfg = tdlgm.Config(latent_dim=LATENT, hidden=HIDDEN, data_dim=DATA,
                       num_chains=C)
    mcmc = MCMC(tdlgm.local_posterior_model(cfg, dec, params, SIGMA, x),
                num_warmup=0, num_samples=1, num_chains=C, device="cpu")
    return mcmc._potential_and_grad


def test_dense_potential_matches_jax_and_autograd():
    weights = _weights(0)
    q = _streams(1)[0] * 1.4
    jpe, jg = _jax_pg(weights, C)(jnp.asarray(q))
    pe, g = tfn.fused_nuts_potential(torch.as_tensor(q), *_t(*weights),
                                     sigma=SIGMA)
    assert pe.shape == (C, 1) and g.shape == (C, D)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * scale)
    ape, ag = _model_potential(weights)(torch.as_tensor(q))
    np.testing.assert_allclose(pe[:, 0].numpy(), ape.detach().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), ag.detach().numpy(), rtol=0,
                               atol=1e-4 * scale)


def _gaussian(prec):
    """pe = 0.5 sum(prec q^2): (C, 1) pe for JAX, (C,) for the port."""
    def jpg(q):
        return 0.5 * jnp.sum(prec * q * q, 1, keepdims=True), prec * q

    tprec = torch.as_tensor(prec)

    def tpg(q):
        return 0.5 * torch.sum(tprec * q * q, 1), tprec * q

    return jpg, tpg


def _compare(got, want):
    names = ("q", "pe", "grad", "accept", "diverging", "depth", "num_steps",
             "h0")
    got = [np.asarray(a).reshape(C, -1) for a in got]
    want = [np.asarray(a).reshape(C, -1) for a in want]
    for i in (4, 5, 6):
        np.testing.assert_array_equal(got[i], want[i], err_msg=names[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5,
                               err_msg="q")
    for i in (1, 7):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5,
                                   err_msg=names[i])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-6,
                               err_msg="accept")


@pytest.mark.parametrize("eps", [0.05, 0.3, 80.0])
def test_core_matches_jax_core_gaussian(eps):
    """The one batched core against ``_nuts_transition_core`` on an
    anisotropic Gaussian: the same injected streams give the same tree.
    eps 80 makes every chain diverge."""
    rng = np.random.default_rng(3)
    prec = rng.uniform(0.5, 4.0, D).astype(np.float32)
    q, mom, sign, lua, lul = _streams(4)
    inv_mass = rng.uniform(0.5, 1.5, D).astype(np.float32)
    jpg, tpg = _gaussian(prec)
    jq = jnp.asarray(q)
    jpe, jg = jpg(jq)
    want = jfn._nuts_transition_core(
        jq, jpe, jg, jnp.asarray(mom), jnp.asarray(sign), jnp.asarray(lua),
        jnp.asarray(lul), jnp.asarray(eps, jnp.float32),
        jnp.asarray(inv_mass)[None], jpg, K)
    tq = torch.as_tensor(q)
    tpe, tg = tpg(tq)
    got = nuts_core(tpg, tq, tpe, tg, NUTSStreams(*_t(mom, sign, lua, lul)),
                    eps, torch.as_tensor(inv_mass), K)
    _compare(got, want)
    if eps > 10:
        assert bool(torch.all(got[4] == 1.0))
    else:
        assert bool(torch.all(got[5] >= 1.0))


@pytest.mark.parametrize("eps", [0.1, 0.35])
def test_reference_transition_matches_jax_core_dlgm(eps):
    """``reference_transition`` (the kernel's plain version) against the JAX
    core over the packed DLGM potential, from one state and one set of
    streams."""
    weights = _weights(5)
    q, mom, sign, lua, lul = _streams(6)
    inv_mass = np.full((1, D), 0.9, np.float32)
    jpg = _jax_pg(weights, C)
    jq = jnp.asarray(q)
    jpe, jg = jpg(jq)
    want = jfn._nuts_transition_core(
        jq, jpe, jg, jnp.asarray(mom), jnp.asarray(sign), jnp.asarray(lua),
        jnp.asarray(lul), jnp.asarray(eps, jnp.float32),
        jnp.asarray(inv_mass), jpg, K)
    tq = torch.as_tensor(q)
    tw = _t(*weights)
    tpe, tg = tfn.fused_nuts_potential(tq, *tw, sigma=SIGMA)
    before = tfn.LAUNCHES
    got = tfn.fused_nuts_transition(
        tq, tpe, tg, *_t(mom, sign, lua, lul), eps,
        torch.as_tensor(inv_mass), *tw, sigma=SIGMA, max_doublings=K)
    assert tfn.LAUNCHES == before        # a CPU tensor runs the plain path
    assert all(a.shape == (C, 1) for i, a in enumerate(got) if i not in
               (0, 2))
    _compare(got, want)
    assert bool(torch.any(got[0] != tq))


def test_state_consistency_under_zero_log_u():
    """The adversarial case of ``tests/test_fused_nuts.py``: every leaf
    log-uniform is exactly 0.  The first-leaf guard must still fill each
    subtree's proposal, so pe' == pe(q') holds."""
    weights = _weights(7)
    tw = _t(*weights)
    q, mom, sign, lua, lul = _streams(8)
    tq = torch.as_tensor(q)
    pe, g = tfn.fused_nuts_potential(tq, *tw, sigma=SIGMA)
    for eps in (0.05, 0.2, 0.5):
        out = tfn.reference_transition(
            tq, pe, g, *_t(mom, sign, lua), torch.zeros(C, 1 << K), eps,
            torch.ones(D), *tw, sigma=SIGMA, max_doublings=K)
        pe_chk, g_chk = tfn.fused_nuts_potential(out[0], *tw, sigma=SIGMA)
        np.testing.assert_allclose(out[1].numpy(), pe_chk.numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out[2].numpy(), g_chk.numpy())


def test_unsupported_device_and_shapes_raise():
    """Shapes the kernel does not take raise in the wrapper (its checks run
    before any launch, so they are tested here on CPU tensors)."""
    tw = _t(*_weights(0))
    q = torch.zeros(2, D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfn.fused_nuts_potential(q, *tw, sigma=SIGMA)
    q = torch.zeros(2, D)
    assert tfn._check_weights(q, *tw) == (NB, LATENT, HIDDEN, DATA)
    with pytest.raises(ValueError, match="w2"):
        tfn._check_weights(q, tw[0], tw[1], tw[2].T.contiguous(), *tw[3:])
    with pytest.raises(ValueError, match="q must be"):
        tfn._check_weights(torch.zeros(2, D + 1), *tw)
    with pytest.raises(ValueError, match="log_u_leaf"):
        tfn._check_rows(2, log_u_leaf=(torch.zeros(2, 1 << K), 1 << (K + 1)))


def _local_setup(chains, warmup, samples):
    w1, b1, w2, b2, x = _t(*_weights(9))
    dec = tdlgm.Decoder(LATENT, HIDDEN, DATA)
    params = {"Dense_0.weight": w1.T.contiguous(), "Dense_0.bias": b1,
              "Dense_1.weight": w2.T.contiguous(), "Dense_1.bias": b2}
    cfg = dataclasses.replace(
        tdlgm.Config(latent_dim=LATENT, hidden=HIDDEN, data_dim=DATA),
        num_chains=chains, num_warmup=warmup, num_samples=samples)
    return cfg, dec, params, x


def test_fused_sampler_matches_generic_posterior():
    """The two DLGM entry points on one local posterior (16 chains): the
    fused transition (plain version on the CPU) and the generic engine
    give marginal moments within MC error, as ``tests/test_fused_nuts.py``
    checks the JAX pair."""
    cfg, dec, params, x = _local_setup(16, 100, 100)
    mcmc_f, res_f = tdlgm.local_posterior_mcmc_fused(
        cfg, dec, params, SIGMA, x, max_doublings=5, run_seed=0)
    mcmc_g, res_g = tdlgm.local_posterior_mcmc(
        cfg, dec, params, SIGMA, x, 1, shared_adapt=True)
    zf = res_f.samples["z"].reshape(-1, D).numpy()
    zg = res_g.samples["z"].reshape(-1, D).numpy()
    assert np.isfinite(zf).all() and np.isfinite(zg).all()
    se = (zg.std(0) / np.sqrt(200.0) + zf.std(0) / np.sqrt(200.0)) + 0.02
    np.testing.assert_array_less(np.abs(zf.mean(0) - zg.mean(0)), 5 * se)
    np.testing.assert_allclose(zf.std(0), zg.std(0), rtol=0.25, atol=0.05)
    assert int(res_f.extra["diverging"].sum()) == 0
    assert mcmc_f.batched_transition is not None
    assert int(res_f.extra["tree_depth"].max()) <= 5


def test_dlgm_run_smoke_reports_nuts():
    """``dlgm.run`` at the smoke config (8 chains, per-chain adaptation)
    adds the NUTS half's numbers, as the JAX ``run`` does."""
    out = tdlgm.run(tdlgm.Config(smoke=True, device="cpu"))
    assert np.isfinite(out["nuts_min_ess"]) and out["nuts_min_ess"] > 0
    assert isinstance(out["nuts_divergences"], int)
    assert 0 <= out["nuts_divergences"] <= 8 * 100


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(x, y, acc, split):
    """``acc + x @ y`` with the kernel's operands: split (lo hi + hi lo + hi
    hi, float32 sums) or, without ``split``, one TF32 pass."""
    xh, yh = _tf32(x), _tf32(y)
    if split:
        xl, yl = _tf32(x - xh), _tf32(y - yh)
        acc = acc + xl @ yh
        acc = acc + xh @ yl
    return acc + xh @ yh


def _emulated_potential(w1, b1, w2, b2, x, sigma, q, grad_split=True):
    """The kernel's potential on the CPU: z W1 and a W2 always split (their
    sums enter pe), r W2^T and da W1^T split or one TF32 pass."""
    nb, data = x.shape
    latent = w1.shape[0]
    inv_s2, const = tfn._constants(nb, latent, data, sigma)
    c = q.shape[0]
    z = q.reshape(c, nb, latent)
    a = torch.tanh(_split_mm(z, w1, b1, True))
    res = _split_mm(a, w2, b2, True) - x
    pe = (0.5 * torch.sum(q * q, 1)
          + (0.5 * inv_s2) * torch.sum(res * res, (1, 2)) + const)
    da = _split_mm(res * inv_s2, w2.T, 0.0, grad_split) * (1.0 - a * a)
    return pe, q + _split_mm(da, w1.T, 0.0, grad_split).reshape(c, -1)


def _bench_potential_inputs(seed, chains=64):
    """A decoder at the NUTS bench widths (64 rows, latent 8, hidden 64,
    data 32) with the model's init, a data batch and chain states."""
    dec = tdlgm.Decoder(8, 64, 32, torch.Generator().manual_seed(seed))
    w = tfn.decoder_weights({k: p.detach() for k, p in dec.named_parameters()})
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(64, 32)).astype(np.float32))
    q = torch.as_tensor((0.7 * rng.normal(size=(chains, 512)))
                        .astype(np.float32))
    return w, x, q


@pytest.mark.parametrize("variant,within", [("split", True),
                                            ("tf32", False)])
def test_operand_split_precision(variant, within):
    """The kernel's operand handling emulated at the bench widths against
    the plain version: the three-pass split holds phase 8's limits (pe rel
    1e-5, grad 1e-4 of max|g|; ~2e-7 and ~5e-7 here); one TF32 pass on the
    gradient products does not hold the gradient's (~4e-4)."""
    for seed in (0, 1):
        w, x, q = _bench_potential_inputs(seed)
        pe_r, g_r = tfn.dense_potential(*w, x, 0.3)(q)
        pe, g = _emulated_potential(*w, x, 0.3, q, variant == "split")
        pe_rel = float(((pe - pe_r).abs() / pe_r.abs()).max())
        g_rel = float((g - g_r).abs().max() / g_r.abs().max())
        assert pe_rel <= 1e-5, pe_rel
        assert (g_rel <= 1e-4) == within, g_rel


def _ffma_design_takes(nb, latent, hidden, data, kk):
    """Whether the earlier fp32 FFMA design of the kernel (one block per
    chain, the decoder, its activations and the tree in shared memory)
    took the shape: its shared-memory floats against the 227 KB a block
    may hold."""
    pot = (latent * (hidden + 1) + hidden + hidden * (data + 1) + data
           + nb * data + nb * (hidden + 1) + nb * data)
    tree = (14 + 2 * kk) * nb * latent + 8 * (2 + 2 * tfn.MAX_DOUBLINGS)
    return 4 * (pot + tree) <= 232448


def test_kernel_takes_every_shape_of_the_ffma_design():
    """Every shape the fp32 design took over a grid of widths, depths and
    row counts (latent dividing 128, as the JAX kernel needs, and odd ones)
    is within the tensor-core kernel's 16 element groups a lane; the rest
    of its shapes fit by moving the packed weights or the tree's vectors to
    device memory, which the kernel decides on the card."""
    taken = 0
    for latent in (1, 2, 3, 4, 8, 16, 32, 64, 128):
        for nb in (1, 4, 16, 64, 100, 128, 160, 256, 300, 512, 1024, 2048,
                   3000, 4096):
            for hidden in (8, 16, 64, 128, 256):
                for data in (4, 8, 32, 64, 128):
                    for kk in (1, 6, 10, 12):
                        if _ffma_design_takes(nb, latent, hidden, data, kk):
                            taken += 1
                            assert tfn.element_groups(nb, latent) \
                                <= tfn.MAX_GROUPS, (nb, latent)
    assert taken > 1000


@pytest.mark.gpu
def test_kernel_potential_at_bench_widths():
    """On a CUDA card: the kernel's potential at the bench widths against
    the plain version with phase 8's limits, and against the CPU emulation
    of its own arithmetic much closer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    w, x, q = _bench_potential_inputs(2, chains=256)
    pe, g = tfn.fused_nuts_potential(q.to(dev), *(t.to(dev) for t in w),
                                     x.to(dev), sigma=0.3)
    pe, g = pe[:, 0].cpu(), g.cpu()
    for want, pe_lim, g_lim in (
            (tfn.dense_potential(*w, x, 0.3)(q), 1e-5, 1e-4),
            (_emulated_potential(*w, x, 0.3, q), 1e-6, 1e-5)):
        pe_rel = float(((pe - want[0]).abs() / want[0].abs()).max())
        g_rel = float((g - want[1]).abs().max() / want[1].abs().max())
        assert pe_rel <= pe_lim and g_rel <= g_lim, (pe_rel, g_rel)


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On a CUDA card: the kernel's potential and one transition equal the
    plain version's on the card (discrete outputs on every chain, values to
    rtol 1e-4), at the test shape and at K = 6 and 10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tw = [a.to(dev) for a in _t(*_weights(11))]
    for kk in (K, 6, 10):
        q, mom, sign, lua, lul = _t(*_streams(12, kk=kk))
        q = q.to(dev)
        pe, g = tfn.fused_nuts_potential(q, *tw, sigma=SIGMA)
        rpe, rg = tfn.dense_potential(*tw, SIGMA)(q)
        torch.testing.assert_close(pe[:, 0], rpe, rtol=1e-5, atol=0)
        args = (q, pe, g, mom.to(dev), sign.to(dev), lua.to(dev),
                lul.to(dev), 0.2, torch.ones(D, device=dev), *tw)
        before = tfn.LAUNCHES
        got = tfn.fused_nuts_transition(*args, sigma=SIGMA, max_doublings=kk)
        torch.cuda.synchronize()
        assert tfn.LAUNCHES == before + 1
        want = tfn.reference_transition(*args, sigma=SIGMA,
                                        max_doublings=kk)
        for i in (4, 5, 6):
            torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
        for i in (0, 1, 7):
            torch.testing.assert_close(got[i], want[i], rtol=1e-4,
                                       atol=1e-4)
    with pytest.raises(ValueError, match="max_doublings"):
        tfn.fused_nuts_transition(*args, sigma=SIGMA, max_doublings=13)
    with pytest.raises(ValueError, match="inv_mass"):
        tfn.fused_nuts_transition(*args[:8], torch.ones(2, D, device=dev),
                                  *tw, sigma=SIGMA, max_doublings=10)


# (nb, latent, hidden, data, K): the dlgm smoke config's widths; chunked
# hidden and data, whole chunks and partial; two row blocks a warp; two,
# four and eight latent tiles; packed weights too large for shared memory;
# tree vectors too large for it
WIDE_SHAPES = [(2, 3, 16, 8, 6), (64, 8, 128, 64, 6), (64, 8, 100, 40, 6),
               (300, 8, 64, 32, 6), (16, 16, 64, 32, 6), (32, 32, 64, 32, 6),
               (16, 64, 32, 16, 6), (64, 8, 512, 256, 6),
               (16, 128, 64, 32, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_kernel_matches_plain_at_other_widths(shape):
    """On a CUDA card: the kernel at widths other than the bench's (tile
    counts from the shape, chunked passes, several element groups a lane,
    packed weights or tree vectors in device memory) against the plain
    version: the potential to pe rel 1e-5 and grad 1e-4 of max|g|, one
    transition's discrete outputs equal on every chain and its values to
    1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    nb, latent, hidden, data, kk = shape
    rng = np.random.default_rng(nb + latent + hidden + data)
    w1 = rng.normal(size=(latent, hidden)) / np.sqrt(latent)
    b1 = 0.1 * rng.normal(size=hidden)
    w2 = rng.normal(size=(hidden, data)) / np.sqrt(hidden)
    b2 = 0.1 * rng.normal(size=data)
    x = rng.normal(size=(nb, data))
    tw = [torch.as_tensor(a.astype(np.float32), device=dev)
          for a in (w1, b1, w2, b2, x)]
    c, d = 32, nb * latent
    q = torch.as_tensor((0.5 * rng.normal(size=(c, d))).astype(np.float32),
                        device=dev)
    pe, g = tfn.fused_nuts_potential(q, *tw, sigma=SIGMA)
    rpe, rg = tfn.dense_potential(*tw, SIGMA)(q)
    assert float(((pe[:, 0] - rpe).abs() / rpe.abs()).max()) <= 1e-5
    assert float((g - rg).abs().max() / rg.abs().max()) <= 1e-4
    mom = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32),
                          device=dev)
    sign = torch.as_tensor(np.where(rng.random((c, kk)) < 0.5, 1.0, -1.0)
                           .astype(np.float32), device=dev)
    lua = torch.as_tensor(np.log(rng.random((c, kk))).astype(np.float32),
                          device=dev)
    lul = torch.as_tensor(np.log(rng.random((c, 1 << kk)))
                          .astype(np.float32), device=dev)
    eps = 0.5 / np.sqrt(1.0 + nb * data / SIGMA ** 2 / d)
    args = (q, rpe[:, None], rg, mom, sign, lua, lul, float(eps),
            torch.ones(d, device=dev), *tw)
    got = tfn.fused_nuts_transition(*args, sigma=SIGMA, max_doublings=kk)
    want = tfn.reference_transition(*args, sigma=SIGMA, max_doublings=kk)
    for i in (4, 5, 6):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
    for i in (0, 1, 7):
        torch.testing.assert_close(got[i], want[i], rtol=1e-4, atol=1e-4)
    assert float(got[6].mean()) > 2.0
