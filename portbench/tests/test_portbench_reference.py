"""The plain references against the port's plain CPU versions at a tiny
size: the same streams bit for bit, the same steps, potentials and
transitions to float32 rounding.  The references import nothing of the
port; these tests hold them against it."""

import numpy as np
import pytest
import torch

from portbench.harness import diagnostics
from portbench.reference import dlgm_nuts, dlgm_svi, nuts_adapt, philox


def test_vae_streams_bit_for_bit():
    from bayesic_tpu_torch.ops._kernel_common import philox_streams

    seed = 2**61 + 12345
    idx, eps = philox.vae_streams(seed, 7, 3, 16, 100, 5, "cpu")
    idx0, eps0 = philox_streams(seed, 7, 3, 16, 100, 5)
    assert torch.equal(idx, idx0) and torch.equal(eps, eps0)


def test_nuts_streams_bit_for_bit():
    from bayesic_tpu_torch.infer.mcmc.streams import StreamKey, nuts_streams

    seed, t = 2**40 + 99, 17
    chains = torch.tensor([0, 5, 1023])
    ours = philox.nuts_streams(seed, 2, t, chains, 12, 6, "cpu")
    theirs = nuts_streams(StreamKey(seed, 2, t), chains, 12, 6)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


def test_svi_steps_match_the_port():
    from bayesic_tpu_torch.ops import fused_vae as fv

    from portbench.harness import inputs

    cfg = dict(num_data=128, data_dim=6, latent_dim=3, hidden=10,
               obs_scale=0.3)
    x, _ = inputs.dlgm_data(cfg, 3, "cpu")
    p0, m0, v0 = inputs.dlgm_fused_init(cfg, 3, "cpu")
    seed = 987654321
    losses, path, grads = dlgm_svi.train(x, p0, seed=seed, steps=3, lr=1e-3,
                                         batch=32)
    idx, eps = philox.vae_streams(seed, 0, 3, 32, 128, 3, "cpu")
    p, m, _, l0 = fv.reference_train(x, p0, m0, v0, idx_stream=idx,
                                     eps_stream=eps, lr=1e-3)
    torch.testing.assert_close(losses, l0, rtol=1e-5, atol=1e-4)
    for k in p:
        torch.testing.assert_close(path[-1][k], p[k], rtol=1e-5, atol=1e-6)
    _, g0 = fv._step_math(tuple(p0[k] for k in fv.LEAVES), x[idx[0]], eps[0],
                          128 / 32)
    for k, g in zip(fv.LEAVES, g0):
        # the port's gradient is of the ELBO, the reference's of the loss
        torch.testing.assert_close(grads[k], -g, rtol=1e-4, atol=1e-4)


def test_nuts_transition_matches_the_port():
    from bayesic_tpu_torch.infer.mcmc.streams import StreamKey
    from bayesic_tpu_torch.ops.fused_nuts import (dense_potential,
                                                  fused_nuts_transition_keyed)

    g = torch.Generator().manual_seed(4)
    nb, z, h, d, c = 3, 2, 8, 5, 16
    w1, w2 = torch.randn(z, h, generator=g), torch.randn(h, d, generator=g)
    b1 = 0.1 * torch.randn(h, generator=g)
    b2 = 0.1 * torch.randn(d, generator=g)
    x = torch.randn(nb, d, generator=g)
    q = 0.3 * torch.randn(c, nb * z, generator=g)
    inv_mass = 0.5 + torch.rand(nb * z, generator=g)
    pe, grad = dense_potential(w1, b1, w2, b2, x, 0.5)(q)
    seed, t = 2**33 + 1, 11
    out = fused_nuts_transition_keyed(
        q, pe[:, None], grad, StreamKey(seed, 2, t), 0.2, inv_mass, w1, b1,
        w2, b2, x, sigma=0.5, max_doublings=5)
    pg = dlgm_nuts.make_potential(w1, b1, w2, b2, x, 0.5)
    streams = philox.nuts_streams(seed, 2, t, torch.arange(c), nb * z, 5,
                                  "cpu")
    q2, acc, n = dlgm_nuts.transition(pg, q, *streams, torch.tensor(0.2),
                                      inv_mass, 5)
    torch.testing.assert_close(q2, out[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc, out[3][:, 0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(n, out[6][:, 0])


def test_diagnostics_match_the_port():
    from bayesic_tpu_torch.utils import diagnostics as port

    x = torch.randn(8, 50, 3, generator=torch.Generator().manual_seed(2))
    x = torch.cumsum(0.3 * x, 1)
    torch.testing.assert_close(diagnostics.ess(x), port.ess(x))
    torch.testing.assert_close(diagnostics.split_rhat(x), port.split_rhat(x))


def test_init_uniforms_bit_for_bit():
    from bayesic_tpu_torch.infer.mcmc.streams import (INIT, StreamKey,
                                                      init_uniforms)

    seed, chains = 2**45 + 3, torch.tensor([0, 7, 1023])
    assert torch.equal(philox.init_uniforms(seed, chains, 40, "cpu"),
                       init_uniforms(StreamKey(seed, INIT, 0), chains, 40))


def test_svi_continues_a_carried_state_as_the_port():
    from bayesic_tpu_torch.ops import fused_vae as fv

    from portbench.harness import inputs

    cfg = dict(num_data=128, data_dim=6, latent_dim=3, hidden=10,
               obs_scale=0.3)
    x, _ = inputs.dlgm_data(cfg, 5, "cpu")
    p0, m0, v0 = inputs.dlgm_fused_init(cfg, 5, "cpu")
    seed, t0 = 123456789, 2**32 + 40
    idx, eps = philox.vae_streams(seed, 0, 2, 32, 128, 3, "cpu")
    p, m, v, _ = fv.reference_train(x, p0, m0, v0, idx_stream=idx,
                                    eps_stream=eps, lr=1e-3)
    losses, path, _ = dlgm_svi.train(x, p, m=m, v=v, t0=t0, seed=seed,
                                     steps=3, lr=1e-3, batch=32)
    idx, eps = philox.vae_streams(seed, t0, 3, 32, 128, 3, "cpu")
    p1, _, _, l1 = fv.reference_train(x, p, m, v, idx_stream=idx,
                                      eps_stream=eps, lr=1e-3, t0=t0)
    torch.testing.assert_close(losses, l1, rtol=1e-5, atol=1e-4)
    for k in p1:
        torch.testing.assert_close(path[-1][k], p1[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("warmup", [0, 19, 20, 60, 100, 150, 200, 1000])
def test_window_schedule_matches_the_port(warmup):
    from bayesic_tpu_torch.infer.mcmc.adapt import build_schedule

    in_slow, window_end = build_schedule(warmup)
    slow = np.zeros(warmup, bool)
    ends = np.zeros(warmup, bool)
    for a, b in nuts_adapt.windows(warmup):
        slow[a:b], ends[b - 1] = True, True
    assert np.array_equal(slow, in_slow) and np.array_equal(ends, window_end)


def test_adaptation_matches_the_port():
    from bayesic_tpu_torch.infer.mcmc import adapt

    g = torch.Generator().manual_seed(8)
    warmup, dim, chains = 200, 5, 64
    accept = 0.6 + 0.35 * torch.rand(warmup, generator=g)
    draws = torch.randn(warmup, chains, dim, generator=g) \
        * torch.linspace(0.1, 3.0, dim)
    in_slow, window_end = adapt.build_schedule(warmup)
    da = adapt.da_init(torch.tensor(0.2))
    wf = adapt.welford_init(dim)
    steps, masses = [], []
    for t in range(warmup):
        steps.append(torch.exp(da.log_step))
        da = adapt.da_update(da, accept[t])
        if in_slow[t]:
            wf = adapt.welford_update_batch(wf, draws[t])
        if window_end[t]:
            masses.append(adapt.welford_finalize(wf))
            wf = adapt.welford_init(dim)
            da = adapt.da_init(torch.exp(da.log_step))
    eps, step = nuts_adapt.dual_averaging(accept, warmup, 0.2)
    torch.testing.assert_close(eps.float(), torch.stack(steps), rtol=1e-5,
                               atol=0)
    assert float(step) == pytest.approx(float(torch.exp(da.log_step_avg)),
                                        rel=1e-5)
    wins = nuts_adapt.windows(warmup)
    assert len(wins) == len(masses)
    for (a, b), mass in zip(wins, masses):
        ref = nuts_adapt.window_variance(draws[a:b].reshape(-1, dim))
        torch.testing.assert_close(ref.float(), mass, rtol=1e-5, atol=0)
