"""Parity of the port's GMM likelihood (``ops/gmm_logprob.py``) with the JAX
package.

Inputs are made with numpy and go to both packages.  The JAX side runs as
its own tests run it (``tests/test_kernels.py``): its Pallas kernels in
interpret mode (``BAYESIC_PALLAS=interpret``) and ``jax.grad`` of its
plain reference.  Tolerances: ll rtol 2e-5 (the interpret kernels' value
products are a 3-pass bf16 split, ~f32); gradients within 2e-5 of
max|g| + 1 against ``jax.grad`` of the reference (float32 sums in another
order), and within 5e-3 of max|g| + 1 against the interpret value+grad
kernel, whose gradient products run one bf16 pass by design and whose
d/dsigma comes through a cancelling identity (its own test allows 5e-3).

The kernels themselves run only on a CUDA card: ``test_kernels_match_plain``
is marked ``gpu`` and skips here.
"""

import jax
import numpy as np
import pytest
import torch

from bayesic_tpu.ops import gmm_logprob as jgl
from bayesic_tpu_torch.ops import gmm_logprob as tgl

torch.set_num_threads(2)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("BAYESIC_PALLAS", "interpret")


def _inputs(n=777, d=3, p=13, k=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    lw = rng.normal(size=(p, k))
    lw = (lw - np.log(np.exp(lw).sum(-1, keepdims=True))).astype(np.float32)
    mus = (2.0 * rng.normal(size=(p, k, d))).astype(np.float32)
    sig = np.exp(0.3 * rng.normal(size=(p, k))).astype(np.float32)
    return x, lw, mus, sig


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _jax_grads(x, lw, mus, sig, ct=None):
    ct = np.ones(lw.shape[0], np.float32) if ct is None else ct
    return jax.grad(lambda a, b, c: (jgl.gmm_loglik_reference(x, a, b, c)
                                     * ct).sum(), argnums=(0, 1, 2))(
        lw, mus, sig)


def _close_grads(got, want, atol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1.0
        np.testing.assert_allclose(g.detach().numpy() / scale, w / scale,
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [dict(), dict(n=513, d=1, p=1, k=2, seed=3),
                                   dict(n=300, d=2, p=37, k=3, seed=1)])
def test_loglik_matches_jax(pallas_interpret, shape):
    x, lw, mus, sig = _inputs(**shape)
    want = np.asarray(jgl.gmm_loglik(x, lw, mus, sig))
    np.testing.assert_allclose(
        np.asarray(jgl.gmm_loglik_reference(x, lw, mus, sig)), want,
        rtol=2e-5)
    for fn in (tgl.gmm_loglik, tgl.gmm_loglik_reference):
        got = fn(*_t(x, lw, mus, sig))
        assert got.shape == (lw.shape[0],)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


def test_backward_matches_jax(pallas_interpret):
    """Autograd through ``gmm_loglik`` with a random cotangent against
    jax.grad of the reference and of the interpret kernel's VJP; the data
    cotangent is NaN, as in the JAX package."""
    x, lw, mus, sig = _inputs(n=300, p=9)
    ct = np.random.default_rng(4).normal(size=9).astype(np.float32)
    xt, *params = _t(x, lw, mus, sig)
    xt.requires_grad_()
    for t in params:
        t.requires_grad_()
    ll = tgl.gmm_loglik(xt, *params)
    got = torch.autograd.grad(ll, [xt] + params, torch.as_tensor(ct))
    assert bool(torch.isnan(got[0]).all())
    _close_grads(got[1:], _jax_grads(x, lw, mus, sig, ct), 2e-5)
    kernel_vjp = jax.vjp(lambda a, b, c: jgl.gmm_loglik(x, a, b, c), lw, mus,
                         sig)[1](ct)
    _close_grads(got[1:], kernel_vjp, 2e-5)


def test_value_and_grad_matches_jax(pallas_interpret):
    x, lw, mus, sig = _inputs(n=777, d=2, p=300, k=3)
    ll, *grads = tgl.gmm_loglik_grad(*_t(x, lw, mus, sig))
    np.testing.assert_allclose(
        ll.numpy(), np.asarray(jgl.gmm_loglik_reference(x, lw, mus, sig)),
        rtol=2e-5)
    _close_grads(grads, _jax_grads(x, lw, mus, sig), 2e-5)
    kernel = jgl.gmm_loglik_grad(x, lw, mus, sig)
    np.testing.assert_allclose(ll.numpy(), np.asarray(kernel[0]), rtol=3e-5,
                               atol=3e-5)
    _close_grads(grads, kernel[1:], 5e-3)
    # the backward's plain version is the value+grad's times the cotangent
    ct = torch.linspace(-1.0, 2.0, 300)
    scaled = tgl.gmm_loglik_grad_reference(*_t(x, lw, mus, sig), ct)
    torch.testing.assert_close(scaled[1], ct[:, None] * grads[0])
    torch.testing.assert_close(scaled[2], ct[:, None, None] * grads[1])


def test_wrapper_checks():
    x, lw, mus, sig = _t(*_inputs(n=20, d=2, p=4, k=3))
    with pytest.raises(ValueError, match="unsupported device"):
        tgl.gmm_loglik_grad(x.to("meta"), lw.to("meta"), mus.to("meta"),
                            sig.to("meta"))
    with pytest.raises(ValueError, match="K <= 8"):
        tgl._check(x, torch.zeros(4, 9), torch.zeros(4, 9, 2),
                   torch.ones(4, 9))
    with pytest.raises(ValueError, match="mus"):
        tgl._check(x, lw, mus[:, :2], sig)


@pytest.mark.gpu
def test_kernels_match_plain():
    """On a CUDA card: forward, backward (autograd with a random
    cotangent) and value+grad kernels against their plain versions, at the
    compile-time K = 3, D = 2 instantiation and the general one; ll within
    1e-5 relative, gradients within 1e-4 of max|g|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for shape in (dict(n=2000, d=2, p=1000, k=3), dict(n=777, d=3, p=13,
                                                       k=4),
                  dict(n=4097, d=2, p=9, k=3, seed=2)):
        x, lw, mus, sig = (a.to(dev) for a in _t(*_inputs(**shape)))
        ct = torch.linspace(-1.0, 2.0, lw.shape[0], device=dev)
        before = dict(tgl.LAUNCHES)
        ll = tgl.gmm_loglik(x, lw, mus, sig)
        ref = tgl.gmm_loglik_reference(x, lw, mus, sig)
        torch.testing.assert_close(ll, ref, rtol=1e-5, atol=0)
        params = [t.clone().requires_grad_() for t in (lw, mus, sig)]
        got = torch.autograd.grad(tgl.gmm_loglik(x, *params), params, ct)
        vg = tgl.gmm_loglik_grad(x, lw, mus, sig)
        torch.cuda.synchronize()
        assert tgl.LAUNCHES["fwd"] == before["fwd"] + 2
        assert tgl.LAUNCHES["bwd"] == before["bwd"] + 1
        assert tgl.LAUNCHES["vg"] == before["vg"] + 1
        want = tgl.gmm_loglik_grad_reference(x, lw, mus, sig)
        want_ct = tgl.gmm_loglik_grad_reference(x, lw, mus, sig, ct)
        torch.testing.assert_close(vg[0], want[0], rtol=1e-5, atol=0)
        for g, w in list(zip(vg[1:], want[1:])) + list(zip(got,
                                                           want_ct[1:])):
            torch.testing.assert_close(
                g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
