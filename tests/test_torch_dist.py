"""Parity of the port's ``dist`` subset with ``bayesic_tpu.dist``: the same
numpy inputs through both, rtol 1e-6 (both float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.dist import transforms as jtr
from bayesic_tpu_torch.dist import transforms as ttr

torch.set_num_threads(2)

RTOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("loc_shape,scale_shape,x_shape", [
    ((), (), (7,)),
    ((3,), (), (5, 3)),
    ((4, 3), (3,), (4, 3)),
    ((), (2, 1), (2, 6)),
])
def test_normal_log_prob_matches_jax(loc_shape, scale_shape, x_shape):
    rng = _rng(1)
    loc = rng.normal(size=loc_shape).astype(np.float32)
    scale = rng.uniform(0.3, 2.0, size=scale_shape).astype(np.float32)
    x = rng.normal(size=x_shape).astype(np.float32)
    want = np.asarray(jdist.Normal(jnp.asarray(loc), jnp.asarray(scale))
                      .log_prob(jnp.asarray(x)))
    got = tdist.Normal(torch.as_tensor(loc), torch.as_tensor(scale)) \
        .log_prob(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_normal_float_params_match_jax():
    x = _rng(2).normal(size=(4, 5)).astype(np.float32)
    want = np.asarray(jdist.Normal(0.5, 1.5).log_prob(jnp.asarray(x)))
    got = tdist.Normal(0.5, 1.5).log_prob(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("batch,ndims", [((5, 3), 2), ((5, 3), 1),
                                         ((2, 4, 3), 2)])
def test_expand_to_event_shapes_and_log_prob(batch, ndims):
    jd = jdist.Normal(0.0, 1.0).expand(batch).to_event(ndims)
    td = tdist.Normal(0.0, 1.0).expand(batch).to_event(ndims)
    assert td.batch_shape == tuple(jd.batch_shape)
    assert td.event_shape == tuple(jd.event_shape)
    assert isinstance(td, tdist.Independent)
    x = _rng(3).normal(size=batch).astype(np.float32)
    want = np.asarray(jd.log_prob(jnp.asarray(x)))
    got = td.log_prob(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_expand_tensor_params_and_independent_expand():
    loc = torch.zeros(3)
    d = tdist.Normal(loc, 1.0).expand((4, 3))
    assert d.batch_shape == (4, 3) and tuple(d.loc.shape) == (4, 3)
    ind = tdist.Normal(0.0, 1.0).expand((3,)).to_event(1).expand((2,))
    assert ind.batch_shape == (2,) and ind.event_shape == (3,)
    assert tdist.Normal(0.0, 1.0).to_event(0).batch_shape == ()
    with pytest.raises(ValueError):
        tdist.Normal(0.0, 1.0).expand((3,)).to_event(2)


def test_sample_shape_device_and_moments():
    g = torch.Generator().manual_seed(0)
    d = tdist.Normal(2.0, 0.5).expand((4000, 3)).to_event(1)
    s = d.sample(g, (2,))
    assert tuple(s.shape) == (2, 4000, 3) and s.dtype == torch.float32
    assert abs(float(s.mean()) - 2.0) < 0.02
    assert abs(float(s.std()) - 0.5) < 0.02
    # a generator fixes the draw
    g2 = torch.Generator().manual_seed(0)
    torch.testing.assert_close(d.sample(g2, (2,)), s)


def test_exp_transform_matches_jax():
    u = _rng(4).normal(size=(6,)).astype(np.float32)
    je, te = jtr.Exp(), ttr.Exp()
    ut = torch.as_tensor(u)
    np.testing.assert_allclose(te.forward(ut).numpy(),
                               np.asarray(je.forward(jnp.asarray(u))),
                               rtol=RTOL)
    y = np.exp(u)
    np.testing.assert_allclose(te.inverse(torch.as_tensor(y)).numpy(),
                               np.asarray(je.inverse(jnp.asarray(y))),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(te.log_det_jacobian(ut).numpy(),
                               np.asarray(je.log_det_jacobian(
                                   jnp.asarray(u))), rtol=RTOL)
    # log-det is log |d exp(u)/du|, checked by autograd
    ur = ut.clone().requires_grad_(True)
    (dy,) = torch.autograd.grad(te.forward(ur).sum(), ur)
    np.testing.assert_allclose(torch.log(dy).numpy(),
                               te.log_det_jacobian(ut).numpy(), rtol=1e-6,
                               atol=1e-7)


def test_biject_to_and_constraints():
    assert isinstance(ttr.biject_to(tdist.constraints.positive), ttr.Exp)
    assert isinstance(ttr.biject_to(tdist.constraints.real), ttr.Identity)
    ident = ttr.Identity()
    tree = {"a": torch.ones(2)}
    assert ident.forward(tree) is tree and ident.inverse(tree) is tree
    x = torch.tensor([-1.0, 0.0, 2.0, float("inf")])
    assert tdist.constraints.positive(x).tolist() == [False, False, True,
                                                     True]
    assert tdist.constraints.real(x).tolist() == [True, True, True, False]
    assert tdist.Normal().support is tdist.constraints.real

    class Discrete:
        is_discrete = True
    with pytest.raises(ValueError):
        ttr.biject_to(Discrete())
