"""Parity of the port's discrete enumeration (``core/logjoint.py``:
marginalised log-density and parts, ``sample_enum``, ``given_enum`` and the
errors) with the JAX package.

Every model of the JAX package's enumeration tests (``tests/test_logjoint.py``)
is written once over a small namespace of array helpers and built in both
packages; inputs come from numpy with a seed.  Tolerances: rtol 1e-5 (atol
1e-6 where a gradient crosses zero) for values and gradients in float32 on
both sides; ``sample_enum`` given JAX's Gumbel noise must draw the same
assignments exactly.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesic_tpu.core as jcore
import bayesic_tpu.dist as jdist
import bayesic_tpu_torch.core as tcore
import bayesic_tpu_torch.dist as tdist
from bayesic_tpu_torch.core import handlers as th

RTOL, ATOL = 1e-5, 1e-6

J = types.SimpleNamespace(core=jcore, dist=jdist, arr=jnp.asarray,
                          where=jnp.where, f32=lambda a: a.astype(jnp.float32))
T = types.SimpleNamespace(core=tcore, dist=tdist,
                          arr=lambda a: torch.as_tensor(np.asarray(a)),
                          where=torch.where, f32=lambda a: a.float())


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- the models of tests/test_logjoint.py:293-418 and :522 -------------------

def _scalar_categorical(ns):
    def model():
        z = ns.core.sample("z", ns.dist.Categorical(
            probs=ns.arr(np.float32([0.2, 0.5, 0.3]))),
            infer={"enumerate": True})
        locs = ns.arr(np.float32([-2.0, 0.0, 2.0]))
        ns.core.sample("obs", ns.dist.Normal(locs[z], 1.0),
                       obs=ns.arr(np.float32(0.7)))
    return model


def _dummy_site_mixture(ns):
    yv = ns.arr(np.random.default_rng(0).normal(1.5, 1.0, 30)
                .astype(np.float32))

    def model():
        mu = ns.core.sample("mu", ns.dist.Normal(0.0, 5.0))
        z = ns.core.sample("z", ns.dist.Bernoulli(probs=0.5),
                           infer={"enumerate": True})
        shift = ns.where(z == 1, 0.0, 0.0)
        ns.core.sample("obs", ns.dist.Normal(mu + shift, 1.0)
                       .expand((30,)).to_event(1), obs=yv)
    return model


def _batched_mixture(ns, n=12):
    yv = ns.arr(np.random.default_rng(1).normal(0.5, 1.3, n)
                .astype(np.float32))
    pi, locs = ns.arr(np.float32([0.3, 0.7])), ns.arr(np.float32([-1., 2.]))

    def model():
        mu = ns.core.sample("mu", ns.dist.Normal(0.0, 3.0))
        z = ns.core.sample("z", ns.dist.Categorical(probs=pi),
                           sample_shape=(n,), infer={"enumerate": True})
        ns.core.sample("obs", ns.dist.Normal(mu + locs[z], 1.0), obs=yv)

    def model_mix():
        mu = ns.core.sample("mu", ns.dist.Normal(0.0, 3.0))
        ns.core.sample("obs", ns.dist.MixtureSameFamily(
            ns.dist.Categorical(probs=pi), ns.dist.Normal(mu + locs, 1.0)),
            obs=yv)
    return model, model_mix


def _two_scalar_sites(ns):
    locs = ns.arr(np.float32([-2.0, 0.0, 2.0]))

    def model():
        z1 = ns.core.sample("z1", ns.dist.Categorical(
            probs=ns.arr(np.float32([0.2, 0.5, 0.3]))),
            infer={"enumerate": True})
        z2 = ns.core.sample("z2", ns.dist.Bernoulli(probs=0.4),
                            infer={"enumerate": True})
        loc = locs[z1] * ns.where(z2 == 1, 1.0, -1.0)
        ns.core.sample("obs", ns.dist.Normal(loc, 1.0),
                       obs=ns.arr(np.float32(0.4)))
    return model


def _full_plate(ns, n=8):
    yv = ns.arr(np.linspace(-1, 1, n).astype(np.float32))

    def model():
        z = ns.core.sample("z", ns.dist.Bernoulli(probs=0.3),
                           infer={"enumerate": True})
        loc = ns.where(z == 1, 1.0, -1.0)
        with ns.core.plate("data", n, subsample_size=n) as idx:
            ns.core.sample("obs", ns.dist.Normal(loc, 1.0), obs=yv[idx])
    return model


def _parts_model(ns):
    def model():
        mu = ns.core.sample("mu", ns.dist.Normal(0.0, 2.0))
        z = ns.core.sample("z", ns.dist.Categorical(
            probs=ns.arr(np.float32([0.2, 0.8]))),
            infer={"enumerate": True})
        locs = ns.arr(np.float32([-1.0, 1.0]))
        ns.core.sample("obs", ns.dist.Normal(mu + locs[z], 1.0),
                       obs=ns.arr(np.float32(0.7)))
    return model


def _scalar_and_batched(ns, first_scalar, with_mu=False):
    n = 3
    yv = ns.arr(np.float32([0.3, -1.2, 0.8]))

    def model():
        mu = ns.core.sample("mu", ns.dist.Normal(0.0, 1.0)) if with_mu \
            else 0.0
        if first_scalar:
            b = ns.core.sample("a_switch", ns.dist.Bernoulli(0.7),
                               infer={"enumerate": True})
            a = ns.core.sample("z_assign", ns.dist.Bernoulli(0.4),
                               sample_shape=(n,), infer={"enumerate": True})
        else:
            a = ns.core.sample("assign", ns.dist.Bernoulli(0.4),
                               sample_shape=(n,), infer={"enumerate": True})
            b = ns.core.sample("switch", ns.dist.Bernoulli(0.7),
                               infer={"enumerate": True})
        loc = ns.f32(a) * 2.0 + ns.f32(b) * 0.5 + mu
        ns.core.sample("obs", ns.dist.Normal(loc, 1.0), obs=yv)
    return model


def _mixture_40(ns):
    mus = np.array([-2.0, 2.0], np.float32)
    rng = np.random.default_rng(0)
    z_true = rng.integers(0, 2, 40)
    x = ns.arr((mus[z_true] + 0.5 * rng.normal(size=40)).astype(np.float32))

    def model():
        mu = ns.core.sample("mu", ns.dist.Normal(0.0, 5.0).expand((2,))
                            .to_event(1))
        z = ns.core.sample("z", ns.dist.Categorical(
            logits=ns.arr(np.zeros(2, np.float32))),
            sample_shape=(40,), infer={"enumerate": True})
        ns.core.sample("obs", ns.dist.Normal(mu[z], 0.5), obs=x)
    return model


def _dependent_scalars(ns):
    table = ns.arr(np.float32([[0.0, 1.0], [1.0, 0.0]]))

    def model():
        ns.core.sample("c", ns.dist.Normal(0.0, 1.0))
        a = ns.core.sample("a", ns.dist.Categorical(
            logits=ns.arr(np.float32([0.0, 0.5]))),
            infer={"enumerate": True})
        b = ns.core.sample("b", ns.dist.Categorical(logits=table[a]),
                           infer={"enumerate": True})
        ns.core.sample("obs", ns.dist.Normal(a + b * 1.0, 0.8),
                       obs=ns.arr(np.float32(1.3)))
    return model


MODELS = {
    "scalar_categorical": (_scalar_categorical, {}),
    "dummy_site_mixture": (_dummy_site_mixture, {"mu": ()}),
    "batched_mixture": (lambda ns: _batched_mixture(ns)[0], {"mu": ()}),
    "two_scalar_sites": (_two_scalar_sites, {}),
    "full_plate": (_full_plate, {}),
    "parts_model": (_parts_model, {"mu": ()}),
    "scalar_then_batched": (lambda ns: _scalar_and_batched(ns, True, True),
                            {"mu": ()}),
    "batched_then_scalar": (lambda ns: _scalar_and_batched(ns, False, True),
                            {"mu": ()}),
    "mixture_40": (_mixture_40, {"mu": (2,)}),
    "dependent_scalars": (_dependent_scalars, {"c": ()}),
}


def _points(shapes, seed, n=3):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(0.0, 1.5, s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


def _t(u):
    return {k: torch.as_tensor(v) for k, v in u.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_enumerated_density_and_parts_match_jax(name):
    make, shapes = MODELS[name]
    jinfo, jld, _, _ = jcore.build_logjoint(make(J))
    tinfo, tld, _, _ = tcore.build_logjoint(make(T))
    assert tinfo.enum_sites == jinfo.enum_sites
    assert tinfo.enum_shapes == {k: tuple(v) for k, v in
                                 jinfo.enum_shapes.items()}
    assert tinfo.enum_pad == jinfo.enum_pad
    assert tinfo.latent_names == jinfo.latent_names
    @jax.jit
    def jall(u):
        return (jax.value_and_grad(jld)(u), jld.parts(u),
                jax.grad(lambda uu: jld.parts(uu)[1])(u))

    for u in _points(shapes, seed=len(name)):
        (jv, jg), (jlp, jll), jgl = jall(u)
        _close(tld(_t(u)), jv)
        tlp, tll = tld.parts(_t(u))
        _close(tlp, jlp)
        _close(tll, jll)
        _close(tld.prior(_t(u)), jlp)
        if u:
            tg = torch.func.grad(lambda uu: tld(uu))(_t(u))
            for k in u:
                _close(tg[k], jg[k])
            # the parts' gradients, through the likelihood
            tgl = torch.func.grad(lambda uu: tld.parts(uu)[1])(_t(u))
            for k in u:
                _close(tgl[k], jgl[k])


def test_batched_site_equals_mixture_marginal_under_vmap():
    """The plate-local marginal equals ``MixtureSameFamily``'s, also
    batched over points by ``torch.func.vmap`` (as ``MCMC`` evaluates
    it)."""
    model, model_mix = _batched_mixture(T, n=64)
    _, ld, _, _ = tcore.build_logjoint(model)
    _, ld_mix, _, _ = tcore.build_logjoint(model_mix)
    mus = torch.tensor([-0.5, 0.0, 1.7, 3.0])
    got = torch.func.vmap(lambda m: ld({"mu": m}))(mus)
    want = torch.stack([ld_mix({"mu": m}) for m in mus])
    _close(got, want)
    g = torch.func.vmap(torch.func.grad(lambda m: ld({"mu": m})))(mus)
    gm = torch.stack([torch.func.grad(lambda m: ld_mix({"mu": m}))(m)
                      for m in mus])
    _close(g, gm, rtol=1e-4, atol=1e-5)


def test_no_enumerated_site_keeps_the_plain_path():
    def model():
        mu = tcore.sample("mu", tdist.Normal(0.0, 1.0))
        tcore.sample("obs", tdist.Normal(mu, 1.0), obs=torch.tensor(0.3))
    info, ld, _, _ = tcore.build_logjoint(model)
    assert info.enum_sites == {} and info.enum_pad == 0
    assert ld.sample_enum({"mu": torch.tensor(0.0)}) == {}


# -- sample_enum and given_enum ----------------------------------------------

def _jax_gumbels(jinfo, key):
    """The Gumbel noise ``jax.random.categorical`` adds for each site of
    the JAX ``sample_enum(u, key)``: site e's key is fold_in(key, e), e its
    index among the sorted enumerated sites, and the noise has the shape
    of the site's logits (*site shape, K) -- size 1 in the plate dims
    where a scalar site eliminated after a plate-local one summed them."""
    index = {n: e for e, n in enumerate(sorted(jinfo.enum_sites))}

    def draw(name, shape):
        return torch.as_tensor(np.array(jax.random.gumbel(
            jax.random.fold_in(key, index[name]), shape, jnp.float32)))
    return draw


@pytest.mark.parametrize("name", ["mixture_40", "dependent_scalars",
                                  "scalar_then_batched",
                                  "batched_then_scalar", "two_scalar_sites",
                                  "batched_mixture"])
def test_sample_enum_given_jax_draws(name):
    make, shapes = MODELS[name]
    jinfo, jld, _, _ = jcore.build_logjoint(make(J))
    _, tld, _, _ = tcore.build_logjoint(make(T))
    jdraw = jax.jit(jld.sample_enum)
    for i, u in enumerate(_points(shapes, seed=7, n=8)):
        key = jax.random.PRNGKey(i)
        want = jdraw(u, key)
        got = tld.sample_enum(_t(u), gumbels=_jax_gumbels(jinfo, key))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            assert got[k].dtype == torch.int32


def test_sample_enum_honors_scale_and_draws_from_a_generator():
    """A ``handlers.scale`` factor tempers the conditional (the JAX test's
    oracle, tests/test_infer_discrete.py:92), here with the port drawing
    its own noise: 20,000 draws within 4.5 SE of the tempered Bayes rule."""
    def model():
        z = tcore.sample("z", tdist.Categorical(logits=torch.zeros(2)),
                         infer={"enumerate": True})
        tcore.sample("obs", tdist.Normal(z * 2.0, 1.0),
                     obs=torch.tensor(0.8))
    c, s = 0.3, 20000
    _, ld, _, _ = tcore.build_logjoint(th.scale(model, factor=c))
    gen = torch.Generator().manual_seed(0)
    noise = -torch.log(-torch.log(torch.rand((s, 2), generator=gen)))
    draws = torch.func.vmap(lambda g: ld.sample_enum(
        {}, gumbels={"z": g})["z"])(noise).float()
    lp = np.array([np.log(0.5) - 0.5 * 0.8 ** 2,
                   np.log(0.5) - 0.5 * 1.2 ** 2]) * c
    p1 = 1.0 / (1.0 + np.exp(lp[0] - lp[1]))
    assert abs(float(draws.mean()) - p1) < 4.5 * np.sqrt(p1 * (1 - p1) / s)
    one = ld.sample_enum({}, torch.Generator().manual_seed(1))
    assert one["z"].shape == () and one["z"].dtype == torch.int32


@pytest.mark.parametrize("name", ["mixture_40", "scalar_then_batched",
                                  "parts_model"])
def test_given_enum_matches_jax(name):
    make, shapes = MODELS[name]
    jinfo, jld, _, _ = jcore.build_logjoint(make(J))
    _, tld, _, _ = tcore.build_logjoint(make(T))
    rng = np.random.default_rng(3)
    jvg = jax.jit(jax.value_and_grad(jld.given_enum))
    for u in _points(shapes, seed=11):
        z = {n: rng.integers(0, k, jinfo.enum_shapes[n]).astype(np.int32)
             for n, k in jinfo.enum_sites.items()}
        jv, jg = jvg(u, z)
        tz = {n: torch.as_tensor(v) for n, v in z.items()}
        tg, tv = torch.func.grad_and_value(
            lambda uu: tld.given_enum(uu, tz))(_t(u))
        _close(tv, jv)
        for k in u:
            _close(tg[k], jg[k])


# -- the errors --------------------------------------------------------------

def _cross_rank(ns):
    def model():
        a = ns.core.sample("a", ns.dist.Bernoulli(0.4), sample_shape=(3,),
                           infer={"enumerate": True})
        b = ns.core.sample("b", ns.dist.Bernoulli(0.6),
                           sample_shape=(2, 3), infer={"enumerate": True})
        ns.core.sample("obs", ns.dist.Normal(ns.f32(a) + ns.f32(b), 1.0),
                       obs=ns.arr(np.zeros((2, 3), np.float32)))
    return model


def _rank_past(ns):
    def model():
        z = ns.core.sample("z", ns.dist.Bernoulli(0.4),
                           infer={"enumerate": True})
        loc = ns.f32(z)[..., None] + ns.arr(np.zeros(2, np.float32))
        ns.core.sample("obs", ns.dist.Normal(loc, 1.0),
                       obs=ns.arr(np.zeros(2, np.float32)))
    return model


def _mixed_scales(ns):
    y = ns.arr(np.linspace(-1, 1, 16).astype(np.float32))

    def model():
        z = ns.core.sample("z", ns.dist.Bernoulli(0.4), sample_shape=(4,),
                           infer={"enumerate": True})
        with ns.core.plate("data", 16, subsample_size=4) as idx:
            ns.core.sample("obs", ns.dist.Normal(ns.f32(z), 1.0),
                           obs=y[idx])
    return model


def _discrete_unmarked(ns):
    def model():
        ns.core.sample("k", ns.dist.Bernoulli(0.4))
    return model


@pytest.mark.parametrize("make, match, when", [
    (_cross_rank, "different ranks", "density"),
    (_rank_past, "rank 3 > 2", "density"),
    (_mixed_scales, "different plate scales", "density"),
    (_mixed_scales, "subsample-free", "sample_enum"),
    (_discrete_unmarked, "'k' is discrete", "build"),
])
def test_errors_match_jax(make, match, when):
    subs = {"data__idx": np.arange(4, dtype=np.int32)}
    for ns, pkg in ((J, jcore), (T, tcore)):
        with pytest.raises(ValueError, match=match):
            _, ld, _, _ = pkg.build_logjoint(make(ns))
            sub = {k: ns.arr(v) for k, v in subs.items()}
            if when == "density":
                ld({}, subsample=sub if make is _mixed_scales else None)
            elif when == "sample_enum":
                if ns is J:
                    ld.sample_enum({}, jax.random.PRNGKey(0))
                else:
                    ld.sample_enum({}, torch.Generator().manual_seed(0))


def test_scalar_batched_orders_match_brute_force():
    """Both site orders of the :522 regression against the explicit sum
    over all 2 x 2^3 assignments (float64 reference)."""
    yv = np.float64([0.3, -1.2, 0.8])
    ref = -np.inf
    for b in (0, 1):
        for ac in itertools.product((0, 1), repeat=3):
            lp = np.log(0.7 if b else 0.3)
            for i, a in enumerate(ac):
                lp += (np.log(0.4 if a else 0.6)
                       - 0.5 * (yv[i] - (2.0 * a + 0.5 * b)) ** 2
                       - 0.5 * np.log(2 * np.pi))
            ref = np.logaddexp(ref, lp)
    for first in (True, False):
        _, ld, _, _ = tcore.build_logjoint(_scalar_and_batched(T, first))
        _close(ld({}), ref)
