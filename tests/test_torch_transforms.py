"""Parity of the port's transforms and constraints with
``bayesic_tpu.dist.transforms`` / ``constraints``: every transform's
forward, inverse and log-det-Jacobian on the same seeded numpy points
(rtol 1e-5 / atol 1e-6), the log-det against autograd's Jacobian, the
shape maps, ``biject_to`` for every constraint (the same transform kind,
and an error for the discrete ones), and every constraint's check."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.dist import constraints as jc
from bayesic_tpu.dist import transforms as jt
from bayesic_tpu_torch.dist import constraints as tc
from bayesic_tpu_torch.dist import transforms as tt

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _f32(x):
    return np.asarray(x, np.float32)


# name -> (JAX transform, port transform, event size of u, u scale)
TRANSFORMS = {
    "Identity": (jt.Identity(), tt.Identity(), 3, 2.0),
    "Exp": (jt.Exp(), tt.Exp(), 3, 2.0),
    "Softplus": (jt.Softplus(), tt.Softplus(), 3, 2.0),
    "Sigmoid": (jt.Sigmoid(), tt.Sigmoid(), 3, 2.0),
    "Interval": (jt.Interval(-1.5, 2.5), tt.Interval(-1.5, 2.5), 3, 2.0),
    "Affine": (jt.Affine(0.5, -2.0), tt.Affine(0.5, -2.0), 3, 2.0),
    "Ordered": (jt.Ordered(), tt.Ordered(), 4, 1.0),
    "StickBreaking": (jt.StickBreaking(), tt.StickBreaking(), 3, 1.0),
    "CorrCholesky": (jt.CorrCholesky(), tt.CorrCholesky(), 6, 0.8),
    "LowerCholeskyTransform": (jt.LowerCholeskyTransform(),
                               tt.LowerCholeskyTransform(), 6, 0.8),
    "PositiveDefiniteTransform": (jt.PositiveDefiniteTransform(),
                                  tt.PositiveDefiniteTransform(), 6, 0.8),
    "Chain(Exp, Affine)": (jt.Chain(jt.Exp(), jt.Affine(1.5, 1.0)),
                           tt.Chain(tt.Exp(), tt.Affine(1.5, 1.0)), 3, 1.0),
    "Chain(Sigmoid, Interval-like Affine)": (
        jt.Chain(jt.Sigmoid(), jt.Affine(-1.0, 3.0)),
        tt.Chain(tt.Sigmoid(), tt.Affine(-1.0, 3.0)), 3, 1.0),
}


def _u(name, batch=(4,)):
    _, _, k, scale = TRANSFORMS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return _f32(rng.normal(size=batch + (k,)) * scale)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_forward_inverse_log_det_match_jax(name):
    jtf, ttf, _, _ = TRANSFORMS[name]
    u = _u(name)

    def jax_side(uu):
        # one jitted program: eager JAX compiles every primitive on first
        # use, several times the cost
        xx = jtf.forward(uu)
        return xx, jtf.inverse(xx), jtf.log_det_jacobian(uu)

    x_j, inv_j, ldj_j = map(np.array, jax.jit(jax_side)(jnp.asarray(u)))
    x_t = ttf.forward(torch.as_tensor(u))
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ttf.inverse(torch.as_tensor(x_j)).numpy(),
                               inv_j, rtol=1e-4, atol=1e-5)
    # the round trip recovers u (float32 through tanh/exp/cholesky)
    np.testing.assert_allclose(ttf.inverse(x_t).numpy(), u, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        ttf.log_det_jacobian(torch.as_tensor(u)).numpy(), ldj_j, rtol=RTOL,
        atol=ATOL)
    assert ttf.domain_event_dim == jtf.domain_event_dim
    assert ttf.codomain_event_dim == jtf.codomain_event_dim
    assert ttf.forward_shape(u.shape) == tuple(jtf.forward_shape(u.shape))
    assert ttf.inverse_shape(x_j.shape) == tuple(
        jtf.inverse_shape(x_j.shape))
    jcod, tcod = jtf.codomain, ttf.codomain
    assert (jcod is None) == (tcod is None)
    if jcod is not None:
        assert type(tcod).__name__ == type(jcod).__name__
        assert bool(tcod(x_t).all())


def _free(name, x):
    """The coordinates that the forward map actually moves."""
    m = x.shape[-1]
    if name == "CorrCholesky":
        row, col = torch.tril_indices(m, m, -1)
        return x[..., row, col]
    if name in ("LowerCholeskyTransform", "PositiveDefiniteTransform"):
        row, col = torch.tril_indices(m, m)
        return x[..., row, col]
    if name == "StickBreaking":
        return x[..., :-1]
    return x


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_log_det_is_autograd_jacobian(name):
    """log |det dF/du| against autograd in float64, the Jacobian taken on
    the coordinates the image is free in; elementwise transforms are
    summed over the event."""
    _, ttf, _, _ = TRANSFORMS[name]
    u = torch.as_tensor(_u(name, batch=())).double()
    jac = torch.autograd.functional.jacobian(
        lambda v: _free(name, ttf.forward(v)), u)
    _, logdet = torch.linalg.slogdet(jac)
    ldj = ttf.log_det_jacobian(u)
    if ttf.domain_event_dim == 0:
        ldj = ldj.sum()
    np.testing.assert_allclose(float(ldj), float(logdet), rtol=1e-9,
                               atol=1e-9)


def test_transforms_run_under_vmap_and_grad():
    """The generic MCMC takes vmap(grad) of the log-joint: every transform
    runs there (no in-place writes)."""
    for name, (_, ttf, _, _) in TRANSFORMS.items():
        u = torch.as_tensor(_u(name, batch=(3,)))

        def f(v):
            return ttf.log_det_jacobian(v).sum() + ttf.forward(v).sum()
        g = torch.func.vmap(torch.func.grad(f))(u)
        assert g.shape == u.shape and torch.isfinite(g).all(), name


# -- biject_to and the constraints ----------------------------------------

CONSTRAINTS = {
    "real": (jc.real, tc.real),
    "real_vector": (jc.real_vector, tc.real_vector),
    "positive": (jc.positive, tc.positive),
    "nonnegative": (jc.nonnegative, tc.nonnegative),
    "unit_interval": (jc.unit_interval, tc.unit_interval),
    "interval": (jc.interval(-1.0, 2.0), tc.interval(-1.0, 2.0)),
    "greater_than": (jc.greater_than(1.5), tc.greater_than(1.5)),
    "simplex": (jc.simplex, tc.simplex),
    "ordered": (jc.ordered, tc.ordered),
    "corr_cholesky": (jc.corr_cholesky, tc.corr_cholesky),
    "lower_cholesky": (jc.lower_cholesky, tc.lower_cholesky),
    "real_matrix": (jc.real_matrix, tc.real_matrix),
    "positive_definite": (jc.positive_definite, tc.positive_definite),
    "boolean": (jc.boolean, tc.boolean),
    "nonnegative_integer": (jc.nonnegative_integer, tc.nonnegative_integer),
    "integer_interval": (jc.integer_interval(0, 3),
                         tc.integer_interval(0, 3)),
}


def test_every_jax_constraint_is_ported():
    names = {n for n in dir(jc) if not n.startswith("_")
             and isinstance(getattr(jc, n), (jc.Constraint, type))
             and n != "Constraint"}
    names.discard("annotations")
    assert names == set(CONSTRAINTS)
    for n in names:
        assert hasattr(tc, n)


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_biject_to_same_kind_as_jax(name):
    jcon, tcon = CONSTRAINTS[name]
    assert tcon.is_discrete == jcon.is_discrete
    assert tcon.event_dim == jcon.event_dim
    assert repr(tcon) == repr(jcon)
    try:
        jtf = jt.biject_to(jcon)
    except ValueError:
        with pytest.raises(ValueError, match="discrete"):
            tt.biject_to(tcon)
        return
    ttf = tt.biject_to(tcon)
    assert type(ttf).__name__ == type(jtf).__name__
    if isinstance(jtf, jt.Chain):
        assert [type(p).__name__ for p in ttf.parts] == \
            [type(p).__name__ for p in jtf.parts]
    # the bijector lands inside the constraint
    k = {1: 6, 2: 6}.get(jcon.event_dim, 3)
    if name == "simplex":
        k = 3
    u = _f32(np.random.default_rng(len(name)).normal(size=(5, k)) * 0.7)
    x = ttf.forward(torch.as_tensor(u))
    assert bool(tcon(x).all())
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jax.jit(jtf.forward)(jnp.asarray(u))),
        rtol=RTOL, atol=ATOL)


def _cases():
    rng = np.random.default_rng(11)
    l3 = np.tril(rng.normal(size=(3, 3)), -1) + np.diag([0.5, 1.0, 2.0])
    corr = l3 / np.linalg.norm(l3, axis=-1, keepdims=True)
    spd = l3 @ l3.T
    big = np.asarray([[2e6, 1e6], [1e6, 2e6]], np.float32)
    big[0, 1] += 0.5           # float32 rounding-scale asymmetry at 1e6
    tiny_asym = np.asarray([[1e-3, 5e-4], [4e-4, 1e-3]], np.float32)
    return {
        "scalar": _f32([-2.0, -0.0, 0.0, 0.3, 1.0, 1.5, 2.0, 3.0, np.inf,
                        -np.inf, np.nan, 4.5, 2.5]),
        "vector": _f32([[0.2, 0.3, 0.5], [0.5, 0.6, -0.1], [1.0, 2.0, 3.0],
                        [3.0, 2.0, 1.0], [np.inf, 0.0, 1.0],
                        [0.0, 0.0, 1.0]]),
        "matrix": _f32(np.stack([l3, corr, spd, -spd, l3.T,
                                 np.full((3, 3), np.nan)])),
        "big": big[None],
        "tiny_asym": tiny_asym[None],
    }


@pytest.mark.parametrize("name", sorted(CONSTRAINTS))
def test_constraint_checks_match_jax(name):
    jcon, tcon = CONSTRAINTS[name]
    cases = _cases()
    keys = {0: ["scalar"], 1: ["vector"],
            2: ["matrix", "big", "tiny_asym"]}[jcon.event_dim]
    for key in keys:
        x = cases[key]
        want = np.asarray(jax.jit(jcon.__call__)(jnp.asarray(x)))
        got = tcon(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_positive_definite_relative_symmetry():
    """JAX ``tests/test_transforms.py:239``: large SPD matrices symmetric
    only to float32 rounding pass; tiny asymmetric ones fail."""
    cases = _cases()
    assert bool(tc.positive_definite(torch.as_tensor(cases["big"]))[0])
    assert not bool(tc.positive_definite(
        torch.as_tensor(cases["tiny_asym"]))[0])


def test_greater_than_chain_and_interval_repr():
    t = tt.biject_to(tc.greater_than(2.0))
    x = t.forward(torch.tensor([-3.0, 0.0, 4.0]))
    assert bool((x > 2.0).all())
    np.testing.assert_allclose(t.log_det_jacobian(
        torch.tensor([-3.0, 0.0, 4.0])).numpy(), [-3.0, 0.0, 4.0])
    assert repr(tt.Interval(0.0, 1.0)) == repr(jt.Interval(0.0, 1.0))
    assert math.isclose(float(tt.Interval(0.0, 4.0).log_det_jacobian(
        torch.tensor(0.0))), math.log(4.0) + 2 * math.log(0.5), rel_tol=1e-6)
