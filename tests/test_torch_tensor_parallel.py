"""The port's ``"model"`` mesh axis (``bayesic_tpu_torch.parallel.tp``,
``mesh.enter`` / ``gather`` / ``reduce``, ``dlgm.run_svi(model_sharding=)``)
against the JAX package's three ``"model"``-axis cases of
``tests/test_sharding.py`` and against the port's unsharded path.

One gloo world of ``torch_parallel_worker.WORLD`` CPU ranks (mode ``tp``)
runs every multi-rank case, with the deadline and collective timeout of
``test_torch_parallel.py``'s worlds, while this process computes the JAX
side (on the 8-device virtual mesh of ``conftest.py``) and the port's
single-process side.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import bayesic_tpu.dist as jdist
import torch_parallel_worker as W
from bayesic_tpu.core import build_logjoint as jbuild_logjoint
from bayesic_tpu.core import sample as jsample
from bayesic_tpu.infer.svi import SVI as JSVI
from bayesic_tpu.infer.svi import MeanFieldGuide as JMeanField
from bayesic_tpu.models import dlgm as jdlgm
from bayesic_tpu.models import matrix_fact as jmf
from bayesic_tpu.parallel import make_mesh as jmake_mesh
from bayesic_tpu_torch.core import build_logjoint
from bayesic_tpu_torch.infer.svi import MeanFieldGuide
from bayesic_tpu_torch.interop import state_dict_to_flax
from bayesic_tpu_torch.models import dlgm
from bayesic_tpu_torch.models import matrix_fact as mf
from test_torch_parallel import _World, _one_thread

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)      # float32 sums in another order


def _flax_decoder(dtype=jnp.float32):
    """The JAX DLGM's decoder module and its init, as its
    ``make_model_and_guide`` draws it at ``TP_DLGM``."""
    cfg = W.TP_DLGM
    dec = jdlgm.Decoder(cfg["data_dim"], cfg["hidden"], dtype=dtype)
    params = dec.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, cfg["latent_dim"])))
    return dec, params


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The world, started with the module's first test, after the flax
    decoder's parameters are written for it."""
    d = tmp_path_factory.mktemp("tp")
    _, params = _flax_decoder()
    np.savez(os.path.join(d, "decoder.npz"), **{
        f"{layer}/{k}": np.asarray(a)
        for layer, leaves in params["params"].items()
        for k, a in leaves.items()})
    w = _World(d, "tp", W.WORLD, init=f"file://{d}/rendezvous")
    yield w
    w.close()


def _rows(a, rank):
    per = a.shape[0] // W.WORLD
    return a[rank * per:(rank + 1) * per]


# ---------------------------------------------------------------------------
# single-process sides, computed while the world runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mf():
    """The JAX MF guide case at ``TP_MF``'s sizes on TP_MF_SEEDS keys, its
    flat vector split over the 8 devices' ``"model"`` axis."""
    cfg = jmf.Config(**{k: v for k, v in W.TP_MF.items() if k != "device"},
                     smoke=False)
    users, items, ratings, _ = jmf.make_data(cfg)
    args = (users, items, ratings)
    svi = JSVI(jmf.make_model(cfg), JMeanField, optax.adam(W.TP_MF_LR),
               model_args=args)
    sh = NamedSharding(jmake_mesh({"model": 8}), P("model"))
    runs = []
    for seed in range(W.TP_MF_SEEDS):
        key = jax.random.PRNGKey(seed)
        state = svi.init(key)
        state = state._replace(params=jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sh), state.params))
        runs.append(svi.run(key, W.TP_MF_STEPS, model_args=args,
                            state=state))
    return runs


@pytest.fixture(scope="module")
def port_runs():
    """The port's unsharded DLGM runs (both compute dtypes) and MF run."""
    with _one_thread():
        out = {}
        for dt, steps in (("float32", W.TP_DLGM["steps"]),
                          ("bfloat16", W.TP_BF16_STEPS)):
            r = dlgm.run_svi(dlgm.Config(**dict(W.TP_DLGM, steps=steps,
                                                compute_dtype=dt)),
                             generator=torch.Generator().manual_seed(0))
            out[dt] = r
        out["mf"] = W.mf_svi(mf.Config(**W.TP_MF), MeanFieldGuide).run(
            torch.Generator().manual_seed(0), W.TP_MF_STEPS)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    return {prefix: tree.detach().numpy()}


# ---------------------------------------------------------------------------
# (1) the mesh
# ---------------------------------------------------------------------------

def test_two_axis_mesh_and_its_groups(world):
    """``make_mesh({"data": 2, "model": 2})`` lays the ranks out as JAX lays
    its devices out (row-major), and ``psum`` / ``gather`` over one axis
    stay inside that axis's group; a size the ranks do not fill raises."""
    sizes = tuple(W.TP_MESH.values())
    assert jmake_mesh({"data": 2, "model": 4}).shape == {"data": 2,
                                                         "model": 4}
    for r, o in enumerate(world.outputs()):
        assert tuple(o["mesh/shape"]) == sizes
        assert tuple(o["mesh/names"]) == tuple(W.TP_MESH)
        d, m = np.unravel_index(r, sizes)
        assert tuple(o["mesh/coords"]) == (d, m)
        group = {"data": [dd * sizes[1] + m for dd in range(sizes[0])],
                 "model": [d * sizes[1] + mm for mm in range(sizes[1])]}
        for axis, ranks in group.items():
            np.testing.assert_array_equal(o[f"mesh/psum/{axis}"],
                                          [float(sum(ranks))])
            np.testing.assert_array_equal(o[f"mesh/gather/{axis}"],
                                          np.asarray(ranks, np.float32))
        assert str(o["mesh/bad"]).startswith("ValueError: mesh {'data': 3}")


# ---------------------------------------------------------------------------
# (2) the collectives' gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["reduce", "gather", "gather_enter"])
def test_collective_gradients_match_unsharded_autograd(world, name):
    """Every rank's loss and gradients equal ``torch.autograd.grad`` of the
    unsharded function: the replicated ``x``'s whole gradient on every rank
    (not P times it) and each rank's rows of ``w`` and ``v``."""
    x, w, v = (torch.tensor(a, requires_grad=True) for a in W.tp_inputs())
    loss = W.tp_functions(x, w, v)[name]
    grads = torch.autograd.grad(loss, (x, w, v), allow_unused=True)
    want = dict(zip("xwv", (None if g is None else g.numpy()
                            for g in grads)))
    for r, o in enumerate(world.outputs()):
        np.testing.assert_allclose(o[f"grad/{name}/loss"],
                                   loss.detach().numpy(), **FLOAT_TOL)
        np.testing.assert_allclose(o[f"grad/{name}/x"], want["x"],
                                   **FLOAT_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(o[f"grad/{name}/w"],
                                   _rows(want["w"], r), **FLOAT_TOL)
        assert (f"grad/{name}/v" in o) == (want["v"] is not None)
        if want["v"] is not None:
            np.testing.assert_allclose(o[f"grad/{name}/v"],
                                       _rows(want["v"], r), **FLOAT_TOL)


# ---------------------------------------------------------------------------
# (3) the observation-sharded log-density
# ---------------------------------------------------------------------------

def test_observation_sharded_logdensity_matches_jax(world):
    """The JAX test's model and data: value and gradient equal to JAX's
    ``logdensity`` on the observations under ``P("model")`` over 8 devices
    and to the port's unsharded ``logdensity``, within rtol 1e-5."""
    y = W.obs_data()

    def jmodel(ya):
        mu = jsample("mu", jdist.Normal(0.0, 10.0))
        jsample("obs", jdist.Normal(mu, 1.0).expand(ya.shape).to_event(1),
                obs=ya)

    _, jld, _, _ = jbuild_logjoint(jmodel, jnp.asarray(y))
    ys = jax.device_put(jnp.asarray(y),
                        NamedSharding(jmake_mesh({"model": 8}), P("model")))
    u = {"mu": jnp.asarray(W.TP_OBS_MU)}
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda uu, d: jld(uu, model_args=(d,))))(u, ys)

    yt = torch.as_tensor(y)
    _, tld, _, _ = build_logjoint(W.obs_model, yt,
                                  rng_key=torch.Generator().manual_seed(0))
    mu = torch.tensor(W.TP_OBS_MU, requires_grad=True)
    tval = tld({"mu": mu}, model_args=(yt,))
    tgrad = torch.autograd.grad(tval, mu)[0]
    for o in world.outputs():
        for got, want in ((o["obs/value"], jval), (o["obs/grad"],
                                                   jgrad["mu"]),
                          (o["obs/value"], tval.detach()),
                          (o["obs/grad"], tgrad)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert "subsamples a plate" in str(o["obs/refused"])


# ---------------------------------------------------------------------------
# (4) the DLGM decoder split by columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_decoder_matches_flax(world, dtype):
    """flax's decoder parameters, carried across by ``interop`` and split
    by ``shard_params``: each rank holds (8, 4) and (4, 32) kernels, the
    sharded forward gives flax's mu on every rank within 1e-5, in float32
    and with flax's ``dtype=bfloat16`` compute, and ``gather_params`` then
    ``interop.state_dict_to_flax`` give flax's parameters back exactly."""
    dec, params = _flax_decoder(jnp.dtype(dtype))
    want = np.asarray(dec.apply(params, jnp.asarray(W.decoder_z())))
    hidden, data_dim = W.TP_DLGM["hidden"], W.TP_DLGM["data_dim"]
    for o in world.outputs():
        np.testing.assert_array_equal(
            o["decoder/shapes"],
            [[hidden // W.WORLD, W.TP_DLGM["latent_dim"]],
             [data_dim // W.WORLD, hidden]])
        np.testing.assert_allclose(o[f"decoder/mu/{dtype}"], want,
                                   rtol=1e-5, atol=1e-5)
        back = state_dict_to_flax({
            k[len("decoder/gathered/"):]: torch.as_tensor(a)
            for k, a in o.items() if k.startswith("decoder/gathered/")})
        for layer, leaves in params["params"].items():
            for k, a in leaves.items():
                np.testing.assert_array_equal(back["params"][layer][k],
                                              np.asarray(a))


def _run_close(got, want, dtype, err_msg):
    """The DLGM run's limit on a parameter or Adam moment: the JAX test's
    rtol/atol 5e-3 in float32; in bf16, where each rank's part of a
    gradient is rounded to bf16 (2^-8) before the parts are summed, 5 such
    roundings of the leaf's largest entry (2e-2 of it)."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3,
                                   err_msg=err_msg)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), err_msg


# the losses' limit: the JAX test's rtol/atol 2e-4 in float32; 1e-3 in bf16
LOSS_TOL = {"float32": 2e-4, "bfloat16": 1e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlgm_model_sharded_run_matches_replicated(world, port_runs, dtype):
    """``dlgm.run_svi(model_sharding=)`` over 4 ranks against the port's
    replicated run: the losses within the JAX test's rtol/atol 2e-4 and the
    gathered parameters and Adam moments within 5e-3 (float32; bf16
    ``_run_close``); each rank's decoder kernels still its slices at the
    end, and every replicated leaf the same bits on every rank."""
    loss_tol = LOSS_TOL[dtype]
    ref = port_runs[dtype]
    want = _leaves(ref["result"].params)
    want_mu = _leaves(ref["result"].state.opt_state.mu)
    outs = world.outputs()
    pre = f"dlgm/{dtype}"
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"{pre}/losses"], ref["losses"],
                                   rtol=loss_tol, atol=loss_tol)
        for k, a in want.items():
            _run_close(o[f"{pre}/params{k}"], a, dtype, k)
        for k, a in want_mu.items():
            _run_close(o[f"{pre}/adam_mu{k}"], a, dtype, f"Adam mu {k}")
        n_sharded = 0
        for k, a in want.items():
            local = o[f"{pre}/local{k}"]
            if "decoder" in k and a.ndim == 2:
                assert local.shape == (a.shape[0] // W.WORLD, a.shape[1])
                n_sharded += 1
            else:
                np.testing.assert_array_equal(
                    local, outs[0][f"{pre}/local{k}"],
                    err_msg=f"rank {r}: {k}")
        assert n_sharded == 2


# ---------------------------------------------------------------------------
# (5) the mean-field guide's parameters split
# ---------------------------------------------------------------------------

def test_sharded_mf_guide_matches_replicated(world, port_runs):
    """At 35 items the flat vector (496) splits over 4 ranks: each rank
    holds 124 entries of loc and of log_scale (its own init and
    ``shard_params`` of the replicated one alike), and 50 steps equal the
    replicated run within 2e-4, as do the sharded guide's ``entropy`` and
    ``stats`` those of the gathered parameters.  At the JAX test's 32 items
    (481) ``shard_params`` raises rather than leave the vector whole."""
    ref = port_runs["mf"]
    guide = W.mf_svi(mf.Config(**W.TP_MF), MeanFieldGuide).guide
    want = {k: v.numpy() for k, v in ref.params.items()}
    outs = world.outputs()
    for o in outs:
        assert int(o["mf/dim"]) == 496
        np.testing.assert_array_equal(o["mf/local_sizes"],
                                      [496 // W.WORLD] * 4)
        assert bool(o["mf/init_equal"])
        np.testing.assert_allclose(o["mf/0/losses"], ref.losses.numpy(),
                                   rtol=2e-4, atol=2e-4)
        for k, a in want.items():
            np.testing.assert_allclose(o[f"mf/0/params/{k}"], a, rtol=2e-4,
                                       atol=2e-4, err_msg=k)
            np.testing.assert_array_equal(o[f"mf/0/params/{k}"],
                                          outs[0][f"mf/0/params/{k}"])
        gathered = {k: torch.as_tensor(o[f"mf/0/params/{k}"]) for k in want}
        np.testing.assert_allclose(o["mf/entropy"],
                                   guide.entropy(gathered).numpy(), rtol=1e-6)
        for i, part in enumerate(guide.stats(gathered)):
            for site, a in part.items():
                np.testing.assert_array_equal(o[f"mf/stats/{i}/{site}"],
                                              a.numpy())
        assert "does not split over the 4 ranks" in str(o["mf/small"])


def test_sharded_mf_guide_matches_jax_in_law(world, jax_mf):
    """The JAX guide case's sharded runs (noise from ``jax.random``, so
    equal only in law) against the port's sharded runs, TP_MF_SEEDS seeds
    each: the seed means of the last 10 losses and of the mean log_scale
    within 4 standard errors of their difference (each side's spread over
    its seeds).  JAX's loc really is split over its ``"model"`` axis."""
    for run in jax_mf:
        assert tuple(run.params["loc"].sharding.spec) == ("model",)
    o = world.outputs()[0]
    seeds = range(W.TP_MF_SEEDS)
    stats = {
        "last losses": (
            [float(np.mean(np.asarray(r.losses)[-10:])) for r in jax_mf],
            [float(np.mean(o[f"mf/{s}/losses"][-10:])) for s in seeds]),
        "log_scale": (
            [float(np.mean(np.asarray(r.params["log_scale"])))
             for r in jax_mf],
            [float(np.mean(o[f"mf/{s}/params/log_scale"])) for s in seeds]),
    }
    for name, (j, t) in stats.items():
        se = np.sqrt(np.var(j, ddof=1) / len(j) + np.var(t, ddof=1) / len(t))
        assert abs(np.mean(j) - np.mean(t)) < 4 * se, (name, j, t)
