"""Parity of the port's ``core`` breadth with ``bayesic_tpu.core``:
``factor``, ``deterministic``, ``mask``/``scale`` on factor sites,
``uncondition``, ``Potential``, ``LocScaleReparam``, constrained matrix
and circular latents, and ``render_model``, on the same seeded numpy
inputs through both packages.  Log-density values at rtol 1e-5 /
atol 1e-6 (rtol 1e-4 / atol 1e-5 where they go through ``i0e`` or the
multivariate log-gamma), gradients at rtol 1e-4 / atol 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.core as jcore
import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.core as tcore
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu.core import handlers as jh
from bayesic_tpu_torch.core import handlers as th

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
SP_RTOL, SP_ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 1e-4, 1e-5

# both packages' namespaces, so one model body serves both
J = dict(core=jcore, dist=jdist, h=jh, a=jnp.asarray, zeros=jnp.zeros,
         exp=jnp.exp, sum=jnp.sum)
T = dict(core=tcore, dist=tdist, h=th, a=torch.as_tensor, zeros=torch.zeros,
         exp=torch.exp, sum=torch.sum)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _jax_reference(model, u):
    """The JAX package's ``build_logjoint`` of ``model``, the log-density's
    value and gradient and ``postprocess`` at ``u`` and ``.parts``, from
    one jitted program: the discovery trace and the replays run at trace
    time (eager JAX compiles every primitive on first use, several times
    the cost)."""
    box = {}

    def f(uu):
        info, ld, _, post = jcore.build_logjoint(model)
        box["info"] = info
        val, grad = jax.value_and_grad(ld)(uu)
        return val, grad, post(uu), ld.parts(uu)

    out = jax.jit(f)({k: jnp.asarray(v) for k, v in u.items()})
    val, grad, post, parts = jax.tree.map(np.asarray, out)
    return box["info"], float(val), grad, post, parts


def _torch_value_and_grads(logdensity, u):
    tu = {k: torch.as_tensor(v).requires_grad_(True) for k, v in u.items()}
    val = logdensity(tu)
    grads = torch.autograd.grad(val, list(tu.values()))
    return float(val.detach()), {k: g.numpy() for k, g in zip(tu, grads)}


def _assert_parity(model_of, u, value_tol=(RTOL, ATOL)):
    """Both packages' log-joints of one model body: site names and shapes,
    the value and gradient at ``u``.  Returns the JAX postprocess and
    parts at ``u`` and the port's (info, logdensity, postprocess)."""
    jinfo, jv, jg, jpost, jparts = _jax_reference(model_of(J), u)
    tinfo, tld, _, tpost = tcore.build_logjoint(model_of(T))
    assert tinfo.latent_names == jinfo.latent_names
    assert tinfo.deterministic_names == jinfo.deterministic_names
    assert tinfo.observed_names == jinfo.observed_names
    assert {k: tuple(v) for k, v in tinfo.unconstrained_shapes.items()} == \
        {k: tuple(v) for k, v in jinfo.unconstrained_shapes.items()}
    tv, tg = _torch_value_and_grads(tld, u)
    np.testing.assert_allclose(tv, jv, rtol=value_tol[0], atol=value_tol[1])
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=G_RTOL, atol=G_ATOL,
                                   err_msg=k)
    return (jpost, jparts), (tinfo, tld, tpost)


# -- factor, deterministic, mask, scale, uncondition -------------------------

def _factor_model(ns):
    d, c, a = ns["dist"], ns["core"], ns["a"]
    y = a(np.float32([0.3, -1.2, 0.8, 2.0]))

    def model():
        mu = c.sample("mu", d.Normal(0.0, 2.0))
        s = c.sample("s", d.HalfCauchy(1.5))
        c.deterministic("shift", mu + 1.0)
        c.factor("pen", -0.5 * (mu - 1.0) ** 2 * s)
        with ns["h"].scale(factor=0.5):
            c.factor("half", -s * s)
        with c.plate("data", 4):
            c.sample("obs", d.Normal(mu, s), obs=y)
    return model


def test_factor_and_deterministic_match_jax():
    u = {"mu": np.float32(0.4), "s": np.float32(-0.3)}
    (jp, (jprior, jlik)), (ti, tld, tpost) = _assert_parity(_factor_model,
                                                             u)
    assert ti.deterministic_names == ("shift",)
    tp = tpost({k: torch.as_tensor(v) for k, v in u.items()})
    assert set(tp) == set(jp) == {"mu", "s", "shift"}
    for k in jp:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=RTOL)
    # .parts: the factors sit with the likelihood; .prior is the first part
    tu = {k: torch.as_tensor(v) for k, v in u.items()}
    tprior, tlik = tld.parts(tu)
    np.testing.assert_allclose(float(tprior), float(jprior), rtol=RTOL)
    np.testing.assert_allclose(float(tlik), float(jlik), rtol=RTOL)
    np.testing.assert_allclose(float(tld.prior(tu)), float(jprior),
                               rtol=RTOL)


def test_mask_handler_masks_factor_sites():
    """JAX ``tests/test_logjoint.py::test_mask_handler_masks_factor_sites``
    in both packages."""
    def model_of(ns):
        c, d, a = ns["core"], ns["dist"], ns["a"]
        vals = a(np.float32([1.0, 2.0, 4.0]))
        keep = a(np.asarray([True, False, True]))

        def model():
            c.sample("mu", d.Normal(0.0, 1.0))
            with ns["h"].mask(mask=keep):
                c.factor("pen", vals)
        return model

    u = {"mu": np.float32(0.0)}
    _, (_, tld, _) = _assert_parity(model_of, u)
    got = float(tld({"mu": torch.tensor(0.0)}))
    np.testing.assert_allclose(got, -0.5 * math.log(2 * math.pi) + 5.0,
                               rtol=1e-6)


def test_uncondition_resamples_observed_sites():
    def model_of(ns):
        c, d, a = ns["core"], ns["dist"], ns["a"]
        y = a(np.float32([10.0, 20.0, 30.0]))

        def model():
            mu = c.sample("mu", d.Normal(0.0, 1.0))
            c.sample("obs", d.Normal(mu, 0.1).expand((3,)).to_event(1),
                     obs=y)
        return model

    jtr = jh.trace(jh.seed(jh.uncondition(model_of(J)),
                           rng_key=jax.random.PRNGKey(0))).get_trace()
    ttr = th.trace(th.seed(th.uncondition(model_of(T)),
                           rng_key=torch.Generator().manual_seed(0))
                   ).get_trace()
    for tr in (jtr, ttr):
        site = tr["obs"]
        assert not site["is_observed"]
        v = _np(site["value"])
        assert v.shape == (3,)
        # redrawn around mu ~ N(0, 1), not the observed 10, 20, 30
        assert np.all(np.abs(v) < 6.0)
    # a plain trace keeps the observation
    ttr2 = th.trace(th.seed(model_of(T),
                            rng_key=torch.Generator().manual_seed(0))
                    ).get_trace()
    assert ttr2["obs"]["is_observed"]


def test_enumerated_latent_site_raises_naming_it():
    """A site marked for enumeration whose support size is unknown (a
    Poisson) raises and names the site, in both packages; the mark stays
    in the trace."""
    def model_of(d, core, rate, obs):
        def model():
            core.sample("z", d.Poisson(rate), infer={"enumerate": True})
            core.sample("x", d.Normal(0.0, 1.0), obs=obs)
        return model

    tmodel = model_of(tdist, tcore, torch.tensor(3.0), torch.tensor(0.5))
    jmodel = model_of(jdist, jcore, jnp.asarray(3.0), jnp.asarray(0.5))
    with pytest.raises(ValueError, match="enumerate 'z'.*support size"):
        tcore.build_logjoint(tmodel)
    with pytest.raises(ValueError, match="enumerate 'z'.*support size"):
        jcore.build_logjoint(jmodel)
    tr = th.trace(th.seed(tmodel, rng_key=torch.Generator().manual_seed(0))
                  ).get_trace()
    assert tr["z"]["infer"] == {"enumerate": True}


# -- Potential ---------------------------------------------------------------

def test_potential_flat_vector_matches_jax():
    """One flat vector fed to both packages' ``Potential`` gives the same
    value and gradient: the port ravels in ``ravel_pytree``'s order (dict
    keys sorted), not the model's site order."""
    def model_of(ns):
        c, d, a = ns["core"], ns["dist"], ns["a"]
        x = a(np.float32([[0.5, -1.0], [1.5, 0.3], [-0.7, 0.9]]))
        y = a(np.float32([0.2, 1.1, -0.4]))

        def model():
            w = c.sample("w", d.Normal(0.0, 1.0).expand((2,)).to_event(1))
            sigma = c.sample("sigma", d.Gamma(2.0, 1.0))
            b = c.sample("b", d.Normal(0.0, 1.0))
            c.sample("obs", d.Normal(x @ w + b, sigma).to_event(1), obs=y)
        return model

    ex = {"w": np.zeros(2, np.float32), "sigma": np.float32(0.0),
          "b": np.float32(0.0)}
    box = {}

    def jax_potential(qq):
        _, jld, _, _ = jcore.build_logjoint(model_of(J))
        jpot = jcore.Potential(jld, {k: jnp.asarray(v)
                                     for k, v in ex.items()})
        box["dim"] = jpot.dim
        return jpot.value_and_grad(qq)

    _, tld, _, _ = tcore.build_logjoint(model_of(T))
    tpot = tcore.Potential(tld, {k: torch.as_tensor(v)
                                 for k, v in ex.items()})
    q = np.float32([0.3, -0.2, 0.5, -1.1])      # b, sigma, w0, w1
    jv, jg = jax.jit(jax_potential)(jnp.asarray(q))
    assert tpot.dim == box["dim"] == 4
    tv, tg = tpot.value_and_grad(torch.as_tensor(q))
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=G_RTOL,
                               atol=G_ATOL)
    tu = tpot.unravel(torch.as_tensor(q))
    assert float(tu["b"]) == q[0] and float(tu["sigma"]) == q[1]
    np.testing.assert_array_equal(tu["w"].numpy(), q[2:])
    np.testing.assert_allclose(float(tpot(torch.as_tensor(q))),
                               -float(tld(tu)), rtol=1e-6)
    # batched over leading dims, as the samplers call it
    qb = torch.as_tensor(np.stack([q, q * 0.5]))
    vb, gb = torch.func.vmap(tpot.value_and_grad)(qb)
    np.testing.assert_allclose(float(vb[0]), float(tv), rtol=1e-6)


# -- LocScaleReparam ---------------------------------------------------------

def _centered(ns):
    c, d, a = ns["core"], ns["dist"], ns["a"]

    def centered():
        mu = c.sample("mu", d.Normal(0.0, 5.0))
        tau = c.sample("tau", d.HalfNormal(2.0))
        theta = c.sample("theta",
                         d.Normal(mu, tau).expand((4,)).to_event(1))
        c.sample("obs", d.Normal(theta, 1.0).to_event(1),
                 obs=a(np.float32([1.0, -1.0, 2.0, 0.5])))
    return centered


def _manual(ns):
    c, d, a = ns["core"], ns["dist"], ns["a"]

    def manual_nc():
        mu = c.sample("mu", d.Normal(0.0, 5.0))
        tau = c.sample("tau", d.HalfNormal(2.0))
        raw = c.sample("theta_decentered",
                       d.Normal(0.0, 1.0).expand((4,)).to_event(1))
        theta = c.deterministic("theta", mu + tau * raw)
        c.sample("obs", d.Normal(theta, 1.0).to_event(1),
                 obs=a(np.float32([1.0, -1.0, 2.0, 0.5])))
    return manual_nc


@pytest.mark.parametrize("centered", [0.0, 0.4])
def test_loc_scale_reparam_matches_manual_and_jax(centered):
    """JAX ``tests/test_logjoint.py:226`` in both packages, and the
    rewritten model's density across packages (also partly centered)."""
    u = {"mu": np.float32(0.4), "tau": np.float32(-0.2),
         "theta_decentered": np.float32([0.1, -0.5, 1.0, 0.0])}

    def auto(ns):
        return ns["core"].reparam(
            _centered(ns),
            config={"theta": ns["core"].LocScaleReparam(centered)})

    (jp, _), (ti, tld, tpost) = _assert_parity(auto, u)
    assert set(ti.latent_names) == {"mu", "tau", "theta_decentered"}
    assert ti.deterministic_names == ("theta",)
    tp = tpost({k: torch.as_tensor(v) for k, v in u.items()})
    np.testing.assert_allclose(tp["theta"].numpy(), np.asarray(jp["theta"]),
                               rtol=RTOL, atol=ATOL)
    if centered == 0.0:
        _, mld, _, mpost = tcore.build_logjoint(_manual(T))
        tu = {k: torch.as_tensor(v) for k, v in u.items()}
        np.testing.assert_allclose(float(tld(tu)), float(mld(tu)),
                                   rtol=1e-6)
        np.testing.assert_allclose(tp["theta"].numpy(),
                                   mpost(tu)["theta"].numpy(), rtol=1e-6)


def test_reparam_eight_schools_under_vmap_grad():
    """The 8-schools model non-centered by ``reparam`` runs under the
    generic MCMC's ``vmap(grad)`` and matches a per-point evaluation."""
    y = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sig = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def centered():
        mu = tcore.sample("mu", tdist.Normal(0.0, 5.0))
        tau = tcore.sample("tau", tdist.HalfCauchy(5.0))
        theta = tcore.sample("theta", tdist.Normal(mu, tau).expand((8,))
                             .to_event(1))
        tcore.sample("obs", tdist.Normal(theta, sig).to_event(1), obs=y)

    model = tcore.reparam(centered, config={"theta": tcore.LocScaleReparam()})
    info, ld, _, _ = tcore.build_logjoint(model)
    from bayesic_tpu_torch.infer.svi.guides import unraveler
    dim, unravel, _ = unraveler(info)
    assert dim == 10
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(3, dim))
                        .astype(np.float32))
    g, v = torch.func.vmap(torch.func.grad_and_value(
        lambda qq: ld(unravel(qq))))(q)
    for i in range(3):
        qi = q[i].clone().requires_grad_(True)
        vi = ld(unravel(qi))
        (gi,) = torch.autograd.grad(vi, qi)
        np.testing.assert_allclose(float(v[i]), float(vi.detach()),
                                   rtol=1e-6)
        np.testing.assert_allclose(g[i].numpy(), gi.numpy(), rtol=1e-5,
                                   atol=1e-6)


# -- constrained and circular latent sites -----------------------------------

def _lkj_model(ns):
    c, d = ns["core"], ns["dist"]

    def model():
        c.sample("L", d.LKJCholesky(3, 2.0))
    return model


def _wishart_model(ns):
    c, d, a = ns["core"], ns["dist"], ns["a"]
    s0 = np.float32([[1.0, 0.0], [0.3, 0.8]])
    xs = np.float32([[0.5, -0.2], [1.0, 0.4], [-0.3, 0.8]])

    def model():
        lam = c.sample("lam", d.Wishart(4.0, a(s0)))
        chol = ns["chol_inv"](lam)
        c.sample("obs", d.MultivariateNormal(
            ns["zeros"](2), scale_tril=chol).expand((3,)).to_event(1),
            obs=a(xs))
    return model


J["chol_inv"] = lambda m: jnp.linalg.cholesky(jnp.linalg.inv(m))
T["chol_inv"] = lambda m: torch.linalg.cholesky(torch.linalg.inv(m))


def _vonmises_model(ns):
    c, d, a = ns["core"], ns["dist"], ns["a"]

    def model():
        loc = c.sample("loc", d.VonMises(0.5, 2.0))
        c.sample("obs", d.VonMises(loc, 4.0).expand((3,)).to_event(1),
                 obs=a(np.float32([0.3, 0.9, -0.2])))
    return model


def _truncated_model(ns):
    c, d, a = ns["core"], ns["dist"], ns["a"]

    def model():
        mu = c.sample("mu", d.Truncated(d.Normal(0.0, 5.0), lower=0.0,
                                        upper=3.0))
        c.sample("obs", d.Normal(mu, 1.0).expand((4,)).to_event(1),
                 obs=a(np.float32([1.2, 0.4, 2.2, 1.9])))
    return model


@pytest.mark.parametrize("name,model_of,u,tol", [
    ("LKJCholesky", _lkj_model,
     {"L": np.float32([0.3, -0.8, 0.5])}, (RTOL, ATOL)),
    ("Wishart", _wishart_model,
     {"lam": np.float32([0.2, -0.3, 0.1])}, (SP_RTOL, SP_ATOL)),
    ("VonMises", _vonmises_model,
     {"loc": np.float32(0.7)}, (SP_RTOL, SP_ATOL)),
    ("Truncated", _truncated_model,
     {"mu": np.float32(-0.4)}, (RTOL, ATOL)),
])
def test_constrained_latents_match_jax(name, model_of, u, tol):
    """The log-density and its gradient at fixed unconstrained points:
    CorrCholesky, PositiveDefiniteTransform and Interval bijectors through
    ``build_logjoint``'s unconstrained shapes."""
    _, (ti, tld, _) = _assert_parity(model_of, u, value_tol=tol)
    # the same under the generic MCMC's vmap(grad)
    k, = u
    q = torch.as_tensor(np.stack([u[k], u[k] * 0.5]))
    g, v = torch.func.vmap(torch.func.grad_and_value(
        lambda qq: tld({k: qq})))(q)
    want = float(tld({k: q[0]}))
    np.testing.assert_allclose(float(v[0]), want, rtol=1e-6)
    assert torch.isfinite(g).all()


# -- render_model ------------------------------------------------------------

def _render_model(ns):
    c, d, a = ns["core"], ns["dist"], ns["a"]
    x = a(np.float32(np.linspace(-1, 1, 10)))

    def model():
        w = c.param("w", a(np.float32([0.5, 1.0])),
                    constraint=d.constraints.positive)
        mu = c.sample("mu", d.Normal(0.0, 1.0))
        tau = c.sample("tau", d.HalfCauchy(2.0))
        corr = c.sample("corr", d.LKJCholesky(3, 1.5))
        c.deterministic("mu2", mu * 2.0 + corr[0, 0] * ns["sum"](w))
        with c.plate("data", 10, subsample_size=5) as idx:
            c.sample("obs", d.Normal(mu, tau), obs=x[idx])
        c.sample("k", d.Poisson(3.0), obs=a(np.float32(2.0)))
    return model


def test_render_model_text_matches_jax():
    box = {}

    def jax_render(key):
        # traced, not run: the text needs only the sites' shapes
        box["text"] = jcore.render_model(_render_model(J), rng_key=key)
        return jnp.zeros(())

    jax.jit(jax_render)(jax.random.PRNGKey(0))
    want = box["text"]
    got = tcore.render_model(_render_model(T))
    assert got == want
    assert "biject=CorrCholesky" in got and "det    mu2" in got
