"""The NUTS transition's draws made inside the kernels (the keyed entries of
``ops/fused_nuts.py`` and ``ops/fused_nuts_hier.py``) against
``infer/mcmc/streams.nuts_streams``.

The kernels rebuild every draw of a transition from (seed, phase, t,
logical chain, kind, lane) and draw a leaf's uniform only when they reach
that leaf, which is exact only if a draw does not depend on K: the first
test holds that.  On the CPU a keyed entry is ``nuts_streams`` then the
plain version, bit for bit.  On a card (tests marked ``gpu``, which skip
here) the kernels' draws equal ``nuts_streams`` on the card bit for bit,
and a keyed transition equals the injected kernel fed ``nuts_streams(key)``
bit for bit.
"""

import numpy as np
import pytest
import torch

from bayesic_tpu_torch.infer.mcmc import StreamKey, nuts_streams
from bayesic_tpu_torch.models import hier_logistic as thl
from bayesic_tpu_torch.ops import fused_nuts as tfn
from bayesic_tpu_torch.ops import fused_nuts_hier as tfnh

torch.set_num_threads(2)

C, K = 8, 5
KEYS = [StreamKey(7, 1, 3), StreamKey(2**40 + 9, 2, 2**33 + 5)]


@pytest.mark.parametrize("key", KEYS)
def test_draws_do_not_depend_on_k(key):
    """K = 6 is the first lanes of K = 10 for every kind (and D = 40 the
    first of D = 72): what the kernels' lazy leaf draws rely on."""
    small = nuts_streams(key, 16, 40, 6)
    big = nuts_streams(key, 16, 72, 10)
    for a, b in zip(small, big):
        assert torch.equal(a, b[:, :a.shape[1]])
    assert not torch.equal(small.mom, nuts_streams(key._replace(t=key.t + 1),
                                                   16, 40, 6).mom)


def _dlgm(seed):
    rng = np.random.default_rng(seed)
    nb, latent, hidden, data = 16, 8, 16, 8
    w = [rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2 else
         0.1 * rng.normal(size=s)
         for s in ((latent, hidden), (hidden,), (hidden, data), (data,))]
    x = rng.normal(size=(nb, data))
    q = 0.5 * rng.normal(size=(C, nb * latent))
    tw = [torch.as_tensor(a.astype(np.float32)) for a in (*w, x)]
    return torch.as_tensor(q.astype(np.float32)), tw


def _hier(seed):
    x, y, group, _ = thl.make_data(thl.Config(num_groups=8, obs_per_group=40,
                                              num_features=3))
    data = tfnh.hier_data(*(torch.as_tensor(a) for a in (x, y, group)), 8)
    rng = np.random.default_rng(seed)
    q = 0.4 * rng.normal(size=(C, 13)) + 0.5
    return torch.as_tensor(q.astype(np.float32)), data


def _keyed_and_plain(model, q, extra, key, eps, kk):
    """(keyed entry, plain version on nuts_streams(key)) on q's device."""
    n, d = q.shape
    s = nuts_streams(key, n, d, kk, q.device)
    inv_mass = torch.full((d,), 0.9, device=q.device)
    if model == "dlgm":
        kw = dict(sigma=0.4, max_doublings=kk)
        pe, g = tfn.fused_nuts_potential(q, *extra, sigma=0.4)
        keyed = tfn.fused_nuts_transition_keyed(q, pe, g, key, eps, inv_mass,
                                                *extra, **kw)
        want = (tfn.fused_nuts_transition if q.is_cuda else
                tfn.reference_transition)(q, pe, g, *s, eps, inv_mass, *extra,
                                          **kw)
    else:
        kw = dict(max_doublings=kk)
        pe, g = tfnh.fused_hier_nuts_potential(q, extra)
        keyed = tfnh.fused_hier_nuts_transition_keyed(q, pe, g, key, eps,
                                                      inv_mass, extra, **kw)
        want = (tfnh.fused_hier_nuts_transition if q.is_cuda else
                tfnh.reference_transition)(q, pe, g, *s, eps, inv_mass, extra,
                                           **kw)
    return keyed, want


@pytest.mark.parametrize("model,eps", [("dlgm", 0.1), ("dlgm", 0.4),
                                       ("hier", 0.05)])
def test_keyed_entry_is_plain_version_on_streams_cpu(model, eps):
    """On CPU tensors a keyed entry is ``reference_transition`` on
    ``nuts_streams(key)``, bit for bit, and launches nothing."""
    q, extra = _dlgm(3) if model == "dlgm" else _hier(3)
    mod = tfn if model == "dlgm" else tfnh
    before = mod.LAUNCHES
    got, want = _keyed_and_plain(model, q, extra, KEYS[0], eps, K)
    assert mod.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(torch.all(got[5] >= 1.0))


def test_draws_entry_and_width_checks_on_cpu():
    """The draws' check entry is ``nuts_streams`` on the CPU; shapes past
    the DLGM kernel's 16 element groups a lane raise before any build."""
    for a, b in zip(tfn.fused_nuts_draws(KEYS[1], 4, 24, 3, "cpu"),
                    nuts_streams(KEYS[1], 4, 24, 3)):
        assert torch.equal(a, b)
    for shape in ((4097, 8, 64, 32), (64, 136, 64, 32), (257, 72, 64, 32)):
        with pytest.raises(ValueError, match="does not take"):
            tfn._workspace(8, *shape, 6, True, "cpu")
    for shape, groups in (((64, 8, 64, 32), 1), ((64, 3, 16, 8), 1),
                          ((300, 8, 128, 64), 2), ((16, 128, 64, 32), 16),
                          ((4096, 1, 8, 4), 16)):
        assert tfn.element_groups(*shape[:2]) == groups
    with pytest.raises(ValueError, match="unsupported device"):
        tfn.fused_nuts_draws(KEYS[0], 4, 24, 3, "meta")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kk", [6, 10])
def test_kernel_draws_match_streams(kk):
    """On a CUDA card: the kernels' draw function (the check entry) equals
    ``nuts_streams`` on the card bit for bit, at the bench's 1024 chains x
    512 dims."""
    dev = _card()
    for key in KEYS:
        got = tfn.fused_nuts_draws(key, 1024, 512, kk, dev)
        want = nuts_streams(key, 1024, 512, kk, dev)
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a, b), (
                name, float((a - b).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["dlgm", "hier"])
@pytest.mark.parametrize("kk", [K, 10])
def test_keyed_kernel_matches_injected_kernel(model, kk):
    """On a CUDA card: the keyed transition equals the injected kernel fed
    ``nuts_streams(key)`` bit for bit, a second keyed call repeats the
    first, and each call counts one launch."""
    dev = _card()
    q, extra = _dlgm(4) if model == "dlgm" else _hier(4)
    q = q.to(dev)
    extra = [t.to(dev) for t in extra] if model == "dlgm" else \
        tfnh.HierData(*(t.to(dev) for t in extra))
    mod = tfn if model == "dlgm" else tfnh
    for key in KEYS:
        before = mod.LAUNCHES
        got, want = _keyed_and_plain(model, q, extra, key, 0.1, kk)
        again, _ = _keyed_and_plain(model, q, extra, key, 0.1, kk)
        torch.cuda.synchronize()
        assert mod.LAUNCHES == before + 4
        for i, (a, b, c) in enumerate(zip(got, want, again)):
            assert torch.equal(a, b), (i, float((a - b).abs().max()))
            assert torch.equal(a, c), i


@pytest.mark.gpu
def test_keyed_chain_base_on_card():
    """On a CUDA card: the DLGM keyed kernel launched on the upper half of
    the chains with ``chain0`` = the half draws those chains' streams, so
    its draws and outputs equal the upper half of the full-width launch's
    bit for bit (a chain-sharded rank's launch)."""
    dev = _card()
    n, half = 2 * C, C
    q, extra = _dlgm(5)
    q = torch.cat([q, 0.5 * q.flip(0)]).to(dev)
    extra = [t.to(dev) for t in extra]
    w, xb = extra[:4], extra[4]
    pe, grad = tfn.fused_nuts_potential(q, *w, xb, sigma=0.7)
    ones = torch.ones(q.shape[1], device=dev)
    kw = dict(sigma=0.7, max_doublings=K)
    for key in KEYS:
        drawn = tfn.fused_nuts_draws(key, half, q.shape[1], K, dev,
                                     chain0=half)
        full = nuts_streams(key, n, q.shape[1], K, dev)
        whole = tfn.fused_nuts_transition_keyed(q, pe, grad, key, 0.1, ones,
                                                *w, xb, **kw)
        upper = tfn.fused_nuts_transition_keyed(
            q[half:], pe[half:], grad[half:], key, 0.1, ones, *w, xb,
            chain0=half, **kw)
        for i, (a, b) in enumerate(zip((*drawn, *upper),
                                       (*full, *whole))):
            assert torch.equal(a, b[half:]), (i, float(
                (a - b[half:]).abs().max()))
