"""The port's multi-rank layer (``bayesic_tpu_torch.parallel``,
``utils.checkpoint``, ``MCMC(chain_sharding=)``, the DLGM's sharded entry
points) against the JAX package and against its own single-process path.

One gloo world of ``torch_parallel_worker.WORLD`` CPU ranks runs every
multi-rank case (its ranks write their outputs to ``.npz`` files), while
this process computes the single-process and JAX sides; a second world of
two ranks, started with ``torchrun``'s variables, runs the launcher's
cases, and two more of two ranks a run that loses a rank after its
checkpoint and the restart from that checkpoint.  Each world has a deadline and each collective a timeout, so a
failed or hung rank fails the tests that read its outputs.  The JAX side
runs on the 8-device virtual mesh of ``conftest.py``.
"""

import contextlib
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import bayesic_tpu.dist as jdist
import bayesic_tpu.parallel.resample as jres
import torch_parallel_worker as W
from bayesic_tpu.core import sample as jsample
from bayesic_tpu.infer.mcmc import MCMC as JMCMC
from bayesic_tpu.infer.svi import SVI as JSVI
from bayesic_tpu.infer.svi import MeanFieldGuide as JMeanField
from bayesic_tpu.models import matrix_fact as jmf
from bayesic_tpu.ops import fused_linreg as jfl
from bayesic_tpu.parallel import dp_svi_run as jdp_svi_run
from bayesic_tpu.parallel import make_mesh as jmake_mesh
from bayesic_tpu.parallel import launcher as jlauncher
from bayesic_tpu.parallel import mesh as jmesh
from bayesic_tpu.parallel.dp_fused import dp_gram as jdp_gram
from bayesic_tpu.utils import checkpoint as jckpt
from bayesic_tpu_torch.infer.mcmc import StreamKey, nuts_streams
from bayesic_tpu_torch.models import dlgm, gmm, linreg
from bayesic_tpu_torch.models import matrix_fact as mf
from bayesic_tpu_torch.ops import fused_hier as fh
from bayesic_tpu_torch.ops import fused_linreg as fl
from bayesic_tpu_torch.ops import fused_nuts as fn
from bayesic_tpu_torch.parallel import launcher, mesh
from bayesic_tpu_torch.utils import checkpoint as ckpt
from bayesic_tpu_torch.utils import diagnostics as diag

WORKER = os.path.abspath(W.__file__)
DEADLINE = 240          # seconds a world may take, start-up included


class _World:
    """``n`` worker processes of one world, started at once; ``outputs``
    waits for them (killing them past the deadline) and returns each
    rank's ``.npz`` as a dict."""

    def __init__(self, outdir, mode, n, init="", env=None):
        self.outdir, self.n = str(outdir), n
        self.start = time.monotonic()
        base = dict(os.environ, PYTHONPATH=W.ROOT + os.pathsep
                    + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        self.procs = [
            subprocess.Popen(
                [sys.executable, WORKER, mode, str(r), str(n), init,
                 self.outdir],
                env={**base, **(env(r) if env else {})},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        self._out = None

    def returncodes(self):
        """Each rank's exit code, once every rank has exited."""
        for p in self.procs:
            left = DEADLINE - (time.monotonic() - self.start)
            try:
                p.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                self.close()
                raise AssertionError(f"the world passed its {DEADLINE} s "
                                     f"deadline") from None
        return [p.returncode for p in self.procs]

    def outputs(self):
        if self._out is None:
            errs = []
            for p in self.procs:
                left = DEADLINE - (time.monotonic() - self.start)
                try:
                    _, err = p.communicate(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    self.close()
                    raise AssertionError(f"the world passed its "
                                         f"{DEADLINE} s deadline")
                errs.append(err)
            bad = [(r, p.returncode, e[-3000:]) for r, (p, e)
                   in enumerate(zip(self.procs, errs)) if p.returncode]
            assert not bad, f"ranks failed: {bad}"
            self._out = []
            for r in range(self.n):
                with np.load(os.path.join(self.outdir, f"rank{r}.npz")) as f:
                    self._out.append(dict(f))
        return self._out

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_world(outdir, mode):
    """A world of ``LAUNCHER_WORLD`` ranks started with torchrun's
    variables."""
    port = str(_free_port())
    return _World(outdir, mode, W.LAUNCHER_WORLD, env=lambda r: {
        "RANK": str(r), "LOCAL_RANK": str(r),
        "WORLD_SIZE": str(W.LAUNCHER_WORLD), "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": port})


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """The main, launcher and crash worlds, started when the module's first
    test starts, so that they run while this process computes the other
    sides."""
    d = tmp_path_factory.mktemp("world")
    main = _World(d, "world", W.WORLD, init=f"file://{d}/rendezvous")
    launch = _torchrun_world(tmp_path_factory.mktemp("launcher"), "launcher")
    crash = _torchrun_world(tmp_path_factory.mktemp("crash"), "crash")
    yield main, launch, crash
    for w in (main, launch, crash):
        w.close()


@pytest.fixture
def world(worlds):
    return worlds[0]


@pytest.fixture
def launcher_world(worlds):
    return worlds[1]


@pytest.fixture
def crash_world(worlds):
    return worlds[2]


@contextlib.contextmanager
def _one_thread():
    """Run this process's torch on one thread, as the world's ranks do: a
    CPU reduction's order, and so its bits, depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _same_on_every_rank(outs, prefix):
    for k in outs[0]:
        if k.startswith(prefix):
            for r, o in enumerate(outs[1:], 1):
                np.testing.assert_array_equal(o[k], outs[0][k],
                                              err_msg=f"rank {r}: {k}")


def _params(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# exact against the JAX package
# ---------------------------------------------------------------------------

def _fp_tree(rng, flip=False):
    f = rng.normal(0, 1, (5, 7)).astype(np.float32)
    i = rng.integers(-2**31, 2**31 - 1, (9,), dtype=np.int64) \
        .astype(np.int32)
    u = rng.integers(0, 2**32 - 1, (4, 3), dtype=np.uint64) \
        .astype(np.uint32)
    if flip:
        f.view(np.uint32)[2, 3] ^= 1
    return {"w": f, "key": u, "nested": {"count": i,
                                        "pair": (f[:2] * 3.0, i[:4])}}


def test_replicated_fingerprint_equals_jax_bit_for_bit():
    tree = _fp_tree(np.random.default_rng(0))
    want = int(jlauncher.replicated_fingerprint(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    got = launcher.replicated_fingerprint(
        {"w": torch.as_tensor(tree["w"]), "key": torch.as_tensor(tree["key"]),
         "nested": {"count": torch.as_tensor(tree["nested"]["count"]),
                    "pair": tuple(map(torch.as_tensor,
                                      tree["nested"]["pair"]))}})
    assert got == want
    flipped = _fp_tree(np.random.default_rng(0), flip=True)
    assert launcher.replicated_fingerprint(
        {k: v for k, v in tree.items()} | {"w": torch.as_tensor(
            flipped["w"])}) != got
    # integers keep every bit: values 1 apart near 2^31 differ
    assert launcher.replicated_fingerprint(
        torch.tensor([2**31 - 2], dtype=torch.int64)) != \
        launcher.replicated_fingerprint(
            torch.tensor([2**31 - 1], dtype=torch.int64))


@pytest.mark.parametrize("size,parts", [(64, 4), (12, 3), (7, 1), (10, 4)])
def test_local_slice_and_host_shard_equal_jax(size, parts):
    a = np.arange(size * 2).reshape(size, 2)
    if size % parts:
        with pytest.raises(AssertionError):
            jmesh.local_slice(size, parts, 0)
        with pytest.raises(ValueError, match="not divisible"):
            mesh.local_slice(size, parts, 0)
        with pytest.raises(ValueError, match="not divisible"):
            launcher.host_shard(a, parts, 0)
        return
    for i in range(parts):
        assert mesh.local_slice(size, parts, i) == \
            jmesh.local_slice(size, parts, i)
        np.testing.assert_array_equal(
            launcher.host_shard(torch.as_tensor(a), parts, i).numpy(),
            jlauncher.host_shard(a, parts, i))


def test_checkpoint_restores_jax_file_and_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"b": rng.normal(size=(3,)).astype(np.float32),
            "a": {"w": rng.normal(size=(2, 4)).astype(np.float32),
                  "pair": (np.arange(5, dtype=np.int32),
                           rng.normal(size=(1,)).astype(np.float32))}}
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jax.tree_util.tree_map(jnp.asarray, tree))
    pair = (torch.zeros(5, dtype=torch.int32), torch.zeros(1))
    target = {"b": torch.zeros(3), "a": {"w": torch.zeros(2, 4),
                                         "pair": pair}}
    got = ckpt.restore(path, target)
    np.testing.assert_array_equal(got["b"].numpy(), tree["b"])
    np.testing.assert_array_equal(got["a"]["w"].numpy(), tree["a"]["w"])
    assert got["a"]["pair"][0].dtype == torch.int32
    np.testing.assert_array_equal(got["a"]["pair"][0].numpy(),
                                  tree["a"]["pair"][0])
    # the port's own trees: NamedTuples, numbers and a generator
    svi, _ = W.linear_svi(*W.linear_data())
    gen = torch.Generator().manual_seed(4)
    state = svi.run(gen, 3).state
    path2 = ckpt.save(str(tmp_path / "port.npz"), state)
    back = ckpt.restore(path2, svi.init(torch.Generator().manual_seed(9)))
    assert back.step == state.step and back.opt_state.count == 3
    for a, b in zip(jax.tree_util.tree_leaves(
            (state.params, state.opt_state.mu, state.opt_state.nu)),
            jax.tree_util.tree_leaves(
                (back.params, back.opt_state.mu, back.opt_state.nu))):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=back.key),
                       torch.rand(4, generator=state.key))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, {"b": torch.zeros(4), "a": target["a"]})


# ---------------------------------------------------------------------------
# particle-sharded SMC, the item-sharded dense MF objective, file shards
# (first: their one-process sides run while the world does)
# ---------------------------------------------------------------------------

def _cat(outs, key):
    return np.concatenate([o[key] for o in outs])


@pytest.mark.parametrize("mode", W.GMM_MODES)
def test_particle_sharded_gmm_matches_one_process(world, mode):
    """``gmm.run(particle_sharding=)`` at the smoke size on the plain
    versions: the one-process run's stages, ancestors, particles, log Z
    and predictive gap."""
    with _one_thread():
        ref = gmm.run(gmm.Config(smoke=True, mode=mode, device="cpu"))
    outs = world.outputs()
    _same_on_every_rank(outs, f"gmm/{mode}")
    out = outs[0]
    res = ref["result"]
    assert int(out[f"gmm/{mode}/num_stages"]) == ref["num_stages"]
    np.testing.assert_array_equal(out[f"gmm/{mode}/ancestors"],
                                  res.ancestors.numpy())
    np.testing.assert_allclose(out[f"gmm/{mode}/q"], res.unconstrained,
                               rtol=1e-6, atol=1e-6)
    for k in ("log_evidence", "gap", "accept_rate"):
        np.testing.assert_allclose(out[f"gmm/{mode}/{k}"], ref[k],
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("routing", ["ring", "all_gather"])
def test_sharded_resampler_equals_jax_systematic_ancestors(world, routing):
    """64 particles over the world's ranks: both routings give the JAX
    package's ancestors and rows exactly."""
    lw, parts = W.resample_inputs()
    key = jax.random.PRNGKey(1)
    assert np.float32(jax.random.uniform(key)) == np.float32(W.RES_U0)
    anc = np.asarray(jres.systematic_ancestors(key, jnp.asarray(lw)))
    outs = world.outputs()
    np.testing.assert_array_equal(_cat(outs, f"resample/{routing}/anc"), anc)
    for k, v in parts.items():
        # payload rows are exact copies
        np.testing.assert_array_equal(_cat(outs, f"resample/{routing}/{k}"),
                                      v[anc])


def test_ring_resampler_million_particles(world):
    """2^20 particles by the ring: routing each particle's own global index
    reproduces the ancestors, and every count is within 1 of N w_i (JAX
    ``test_sharding.py``)."""
    outs = world.outputs()
    anc = _cat(outs, "resample/big/anc")
    np.testing.assert_array_equal(_cat(outs, "resample/big/routed"), anc)
    lw = 3.0 * np.random.default_rng(W.RES_SEED).normal(0, 1, W.RES_BIG) \
        .astype(np.float32)
    w = np.exp(lw.astype(np.float64) - lw.max())
    w /= w.sum()
    counts = np.bincount(anc, minlength=W.RES_BIG)
    assert np.max(np.abs(counts - W.RES_BIG * w)) <= 1.0 + 1e-3


@pytest.mark.parametrize("case", list(W.SMC_CASES))
def test_particle_sharded_smc_matches_one_process(world, case):
    """The JAX tests' SMC models with the particles over the world's
    ranks: the one-process run's stages and ancestors, its particles and
    log Z to 1e-6."""
    with _one_thread():
        ref = W.run_smc(case)
    outs = world.outputs()
    _same_on_every_rank(outs, f"smc/{case}")
    out = outs[0]
    assert ref.num_stages >= 2
    assert int(out[f"smc/{case}/stages"]) == ref.num_stages
    if case == "multihost":
        resampled = ref.ancestors != torch.arange(ref.ancestors.shape[1])
        assert bool(resampled.any())
    np.testing.assert_array_equal(out[f"smc/{case}/ancestors"],
                                  ref.ancestors.numpy())
    np.testing.assert_allclose(out[f"smc/{case}/q"], ref.unconstrained,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[f"smc/{case}/log_w"], ref.log_weights,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[f"smc/{case}/log_z"], ref.log_evidence,
                               rtol=1e-6, atol=1e-6)


def test_dense_mf_sharded_loss_and_grads_equal_jax(world):
    """The item-sharded objective's loss and every gradient against JAX
    ``dense_neg_elbo`` at ``test_mf_dense_sharded.py``'s config, at its
    tolerances."""
    cfg = mf.Config(**W.MF)
    users, items, ratings, _ = mf.make_data(cfg)
    cnt, rsum, sqsum, n = jmf.dense_stats(users, items, ratings,
                                          cfg.num_users, cfg.num_items)
    params = jax.tree_util.tree_map(jnp.asarray, W.mf_params(cfg))
    ref, gref = jax.jit(jax.value_and_grad(jmf.dense_neg_elbo),
                        static_argnums=5)(params, cnt, rsum, sqsum, float(n),
                                          cfg.noise)
    outs = world.outputs()
    _same_on_every_rank(outs, "mf/loss")
    for site in ("u", "bu", "m"):
        _same_on_every_rank(outs, f"mf/grads/{site}")
    np.testing.assert_allclose(outs[0]["mf/loss"], float(ref), rtol=2e-6)
    for site in params:
        for j in range(2):
            key = f"mf/grads/{site}/{j}"
            got = _cat(outs, key) if site in ("v", "bi") else outs[0][key]
            np.testing.assert_allclose(got, np.asarray(gref[site][j]),
                                       rtol=3e-5, atol=3e-5, err_msg=key)


def test_run_dense_sharded_matches_run_dense(world):
    cfg = mf.Config(**W.MF)
    with _one_thread():
        ref = mf.run_dense(cfg)
    out = world.outputs()[0]
    _same_on_every_rank(world.outputs(), "mf/losses")
    np.testing.assert_allclose(out["mf/losses"], ref["losses"], rtol=1e-4)
    assert abs(float(out["mf/rmse"]) - ref["rmse"]) < 5e-3
    assert float(out["mf/rmse"]) < 1.3 * cfg.noise


def test_file_shards_follow_the_jax_arithmetic(world):
    """Each rank reads rows [rank * per, (rank + 1) * per) of the file the
    ranks wrote, per = n // ranks: the synthetic arrays' rows, the last
    n % ranks read by none."""
    cfg = mf.Config(**W.MF_FILE)
    want = mf.make_data(cfg)[:3]
    per = cfg.num_ratings // W.WORLD
    for r, o in enumerate(world.outputs()):
        for k, a in zip(("users", "items", "ratings"), want):
            np.testing.assert_array_equal(o[f"file/{k}"],
                                          a[r * per:(r + 1) * per])


@pytest.mark.parametrize("shared", [False, True])
def test_chain_sharded_mcmc_matches_one_process(world, shared):
    """8 chains over the world's ranks: five warmup and five sampling
    transitions equal the one-process run; a 150 + 150 run's posterior
    mean lies within 4 MCSE of the analytic one and within 0.05 of the
    JAX package's chain-sharded run."""
    with _one_thread():
        short = W.run_mcmc(W.MCMC_SHORT, shared)
    yv = W.mcmc_data()

    def jmodel():
        mu = jsample("mu", jdist.Normal(0.0, 5.0))
        jsample("obs", jdist.Normal(mu, 1.0).expand((30,)).to_event(1),
                obs=jnp.asarray(yv))

    jres = JMCMC(model=jmodel, num_warmup=W.MCMC_LONG,
                 num_samples=W.MCMC_LONG, num_chains=W.MCMC_CHAINS,
                 init_step_size=0.5, shared_adapt=shared,
                 chain_sharding=NamedSharding(jmake_mesh({"chain": 8}),
                                              P("chain"))
                 ).run(jax.random.PRNGKey(0))

    outs = world.outputs()
    per = W.MCMC_CHAINS // W.WORLD
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(
            o[f"local_chains/{shared}/{W.MCMC_SHORT}"],
            np.arange(r * per, (r + 1) * per))
    _same_on_every_rank(outs, f"mcmc/{shared}")
    out = outs[0]
    np.testing.assert_array_equal(out[f"mcmc/{shared}/{W.MCMC_SHORT}/chains"],
                                  np.arange(W.MCMC_CHAINS))
    np.testing.assert_allclose(out[f"mcmc/{shared}/{W.MCMC_SHORT}/q"],
                               short.unconstrained.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        out[f"mcmc/{shared}/{W.MCMC_SHORT}/step_size"],
        short.extra["step_size"].numpy(), rtol=1e-6)

    post_var = 1.0 / (1.0 / 25.0 + 30.0)
    post_mean = post_var * float(yv.sum())
    mu = out[f"mcmc/{shared}/{W.MCMC_LONG}/q"][:, :, 0]
    assert abs(mu.mean() - post_mean) < 4.0 * float(diag.mcse(mu))
    assert abs(mu.mean() - float(jnp.mean(jres.unconstrained))) < 0.05


def test_dp_gram_equals_jax_and_the_plain_gram(world):
    x, y, _, _ = linreg.make_data(linreg.Config(n=4096, dim=16))
    packed = jfl.pack_data(x, y)
    want_jax = np.asarray(jdp_gram(packed, jmake_mesh({"data": 8})))[:18,
                                                                      :18]
    plain = fl.gram(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    outs = world.outputs()
    _same_on_every_rank(outs, "dp_gram")
    got = outs[0]["dp_gram"]
    np.testing.assert_allclose(got, want_jax, rtol=2e-5, atol=2e-2)
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-2)


def test_mesh_helpers(world):
    outs = world.outputs()
    n = W.WORLD
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["mesh/put_sharded"],
                                      np.arange(3.0 * r, 3.0 * r + 3)[None])
        np.testing.assert_array_equal(o["mesh/put_replicated"], [0.0, 0.0])
        np.testing.assert_array_equal(o["mesh/pmax"], [n - 1.0])
        np.testing.assert_array_equal(o["mesh/all_gather"], np.arange(n))
        np.testing.assert_array_equal(o["mesh/psum"], [n, n, 2.0 * n])


def test_ppermute_moves_each_leaf_one_place_round_the_ring(world):
    outs = world.outputs()
    n = W.WORLD
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["mesh/ppermute/a"],
                                      np.full(3, float((r + 1) % n)))
        np.testing.assert_array_equal(o["mesh/ppermute/b"],
                                      [(r + 1) % n, (r + 1) % n])
        np.testing.assert_array_equal(o["mesh/ppermute/back"],
                                      np.full(3, float(r)))


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh({"data": 1})


# ---------------------------------------------------------------------------
# the sharded runs against the port's single-process path
# ---------------------------------------------------------------------------

def test_dp_svi_run_matches_single_process_and_jax(world):
    x, y = W.linear_data()
    svi, args = W.linear_svi(x, y)
    ref = svi.run(torch.Generator().manual_seed(0), W.LIN_STEPS,
                  model_args=args)

    def jmodel(xa, ya):
        w = jsample("w", jdist.Normal(0.0, 2.0))
        b = jsample("b", jdist.Normal(0.0, 2.0))
        jsample("obs", jdist.Normal(w * xa + b, 0.4).to_event(1), obs=ya)

    jsvi = JSVI(jmodel, JMeanField, optax.adam(W.LIN_LR),
                model_args=(jnp.asarray(x), jnp.asarray(y)))
    jres = jdp_svi_run(jsvi, jmake_mesh({"data": 8}), jax.random.PRNGKey(0),
                       (jnp.asarray(x), jnp.asarray(y)), W.LIN_STEPS)

    outs = world.outputs()
    _same_on_every_rank(outs, "dp_svi")
    got = _params(outs[0], "dp_svi/params")
    np.testing.assert_allclose(outs[0]["dp_svi/losses"], ref.losses.numpy(),
                               rtol=2e-4, atol=2e-4)
    for k, v in ref.params.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["loc"], np.asarray(jres.params["loc"]),
                               atol=0.03)


def test_dlgm_run_svi_data_sharded_matches_single_process(world):
    ref = dlgm.run_svi(dlgm.Config(**W.DLGM),
                       generator=torch.Generator().manual_seed(0))
    outs = world.outputs()
    _same_on_every_rank(outs, "dlgm")
    np.testing.assert_allclose(outs[0]["dlgm/losses"], ref["losses"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[0]["dlgm/sigma_x"], ref["sigma_x"],
                               rtol=2e-3, atol=2e-3)
    got = _params(outs[0], "dlgm/decoder")
    for k, v in ref["decoder_params"].items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=2e-3, atol=2e-3)


def _hier_start(cfg):
    loc, ls, opt = fh.init_params(cfg.num_groups, cfg.num_features)
    return loc, ls, opt


def test_hier_replicated_train_equals_one_process(world):
    cfg, hx, hy, hg = W.hier_rows()
    rows = tuple(map(torch.as_tensor, (hx, hy, hg)))
    local = W.hier_local_train(W.HIER_ROWS, cfg.batch_size, W.HIER_REP_STEPS,
                               cfg.lr, W.HIER_REP_STEPS)
    with _one_thread():
        state, losses = local(rows, _hier_start(cfg), 5, 0)
    outs = world.outputs()
    _same_on_every_rank(outs, "hier_rep")
    np.testing.assert_array_equal(outs[0]["hier_rep/losses"], losses.numpy())
    got = _params(outs[0], "hier_rep/state")
    for k, v in zip(("0", "1", "2/0", "2/1", "2/2", "2/3"),
                    (state[0], state[1], *state[2])):
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-4, atol=1e-4)


def test_hier_segment_averaged_matches_one_process(world):
    cfg, hx, hy, hg = W.hier_rows()
    total = W.HIER_SEGMENTS * W.HIER_SPS
    loc, ls, _, _ = fh.fused_train(
        *map(torch.as_tensor, (hx, hy, hg)), *_hier_start(cfg)[:2],
        steps=total, lr0=cfg.lr, lr_total=total, seed=11,
        batch=cfg.batch_size)
    outs = world.outputs()
    _same_on_every_rank(outs, "hier_seg")
    losses = outs[0]["hier_seg/losses"]
    assert losses.shape == (total,) and losses[-1] < losses[0]
    j = cfg.num_groups
    got = outs[0]["hier_seg/state/0"]
    want = loc.numpy()
    assert abs(got[0] - want[0]) < 0.15                     # mu
    assert abs(np.exp(got[1]) - np.exp(want[1])) < 0.3      # tau
    np.testing.assert_allclose(got[2 + j:], want[2 + j:], atol=0.15)
    np.testing.assert_allclose(got[2:2 + j], want[2:2 + j], atol=0.35)


@pytest.mark.parametrize("case", ["raises", "warns", "silent"])
def test_segment_bias_guard(world, case):
    out = world.outputs()[0]

    def get(name):
        return (str(out[f"guard/{name}/outcome"]),
                [w for w in out[f"guard/{name}/warnings"] if w])

    if case == "raises":
        outcome, warned = get("raises")
        assert outcome.startswith("raised") \
            and "hierarchical scale" in outcome and not warned
        assert get("accepted") == ("ran", [])
    elif case == "warns":
        outcome, warned = get("warns")
        assert outcome == "ran" and len(warned) == 1 \
            and "hierarchical scale" in warned[0]
    else:
        assert get("short") == ("ran", [])
        assert get("declared_flat") == ("ran", [])


def test_vae_segment_averaged_trains(world):
    losses = world.outputs()[0]["vae/losses"]
    assert losses.shape == (W.VAE_SEGMENTS * W.VAE_SPS,)
    assert np.isfinite(losses).all()
    assert losses[-30:].mean() < losses[:30].mean()


def test_chain_base_selects_the_global_chains_streams():
    key, n, dim, kk = StreamKey(7, 1, 3), 16, 5, 4
    full = nuts_streams(key, n, dim, kk)
    for chain0 in (0, 8, 12):
        part = nuts_streams(key, chain0 + torch.arange(4), dim, kk)
        drawn = fn.fused_nuts_draws(key, 4, dim, kk, "cpu", chain0=chain0)
        for a, b, c in zip(part, drawn, full):
            assert torch.equal(a, c[chain0:chain0 + 4])
            assert torch.equal(b, c[chain0:chain0 + 4])
    # a keyed transition over the upper half of the chains with chain0 =
    # n / 2 equals the upper half of the full-width transition
    g = torch.Generator().manual_seed(0)
    nb, latent, hidden, data = 2, 3, 5, 4
    w = (torch.randn(latent, hidden, generator=g) * 0.5,
         torch.randn(hidden, generator=g) * 0.1,
         torch.randn(hidden, data, generator=g) * 0.5,
         torch.randn(data, generator=g) * 0.1)
    xb = torch.randn(nb, data, generator=g)
    q = torch.randn(n, nb * latent, generator=g)
    pe, grad = fn.fused_nuts_potential(q, *w, xb, sigma=0.5)
    ones = torch.ones(nb * latent)
    kw = dict(sigma=0.5, max_doublings=kk)
    whole = fn.fused_nuts_transition_keyed(q, pe, grad, key, 0.1, ones, *w,
                                           xb, **kw)
    h = n // 2
    upper = fn.fused_nuts_transition_keyed(q[h:], pe[h:], grad[h:], key, 0.1,
                                           ones, *w, xb, chain0=h, **kw)
    for a, b in zip(upper, whole):
        assert torch.equal(a, b[h:])
    with pytest.raises(ValueError, match="chain0"):
        fn._key_words(key, -1)


def test_chain_sharded_fused_nuts_matches_one_process(world):
    cfg, dec, dparams, sig, xb = W.fnuts_inputs()
    with _one_thread():
        _, ref = dlgm.local_posterior_mcmc_fused(cfg, dec, dparams, sig, xb,
                                                 max_doublings=4, run_seed=5)
    outs = world.outputs()
    _same_on_every_rank(outs, "fnuts")
    # not bit for bit here: the plain version's batched products round a
    # chain's sums by the CPU matmul's blocking of the batch (C/S chains a
    # rank, C here); the kernel computes each chain alone, and chip_smoke
    # holds the sharded run on the card to the unsharded one bit for bit
    np.testing.assert_allclose(outs[0]["fnuts/q"], ref.unconstrained.numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the launcher: torchrun's variables, desync detection, checkpoint/resume
# ---------------------------------------------------------------------------

def test_launcher_env_world_sync_desync_and_resume(launcher_world):
    outs = launcher_world.outputs()
    assert [bool(o["primary"]) for o in outs] == [True, False]
    assert all(bool(o["sync"]) for o in outs)
    assert outs[0]["fingerprint"] == outs[1]["fingerprint"]
    for o in outs:
        assert str(o["desync"]).startswith("DesyncError")
        # resumed from the step-100 checkpoint = the uninterrupted run
        assert o["resumed_fingerprint"] == o["fingerprint"]
        assert int(o["resumed_step"]) == W.LAUNCH_STEPS
        np.testing.assert_array_equal(o["resumed_losses"], o["losses"])
    # and the run is the single-process one up to fp32 sums
    x, y = W.linear_data(W.LAUNCH_N, seed=0)
    svi, args = W.linear_svi(x, y)
    ref = svi.run(torch.Generator().manual_seed(0), W.LAUNCH_STEPS,
                  model_args=args)
    np.testing.assert_allclose(outs[0]["losses"], ref.losses.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_fault_injection_rank_dies_then_restart(crash_world, launcher_world,
                                                tmp_path):
    """Rank 1 exits right after the checkpoint's barrier, and rank 0 fails
    at its next collective; a restart at the same world size from the
    checkpoint lands on the uninterrupted run bit for bit."""
    codes = crash_world.returncodes()
    assert codes[1] == W.CRASH_CODE and codes[0] not in (0, W.CRASH_CODE)
    resume = _torchrun_world(crash_world.outdir, "resume")
    try:
        outs = resume.outputs()
    finally:
        resume.close()
    ref = launcher_world.outputs()[0]
    for o in outs:
        assert bool(o["sync"])
        assert o["fingerprint"] == ref["fingerprint"]
        assert int(o["step"]) == W.LAUNCH_STEPS
        np.testing.assert_array_equal(o["losses"],
                                      ref["losses"][W.LAUNCH_SAVE:])
