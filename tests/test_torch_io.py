"""The port's ratings files (``bayesic_tpu_torch.io``) against the JAX
package's: each package reads the other's files, in the native loader and
in the numpy path, with the cases of ``tests/test_io.py``; and
``matrix_fact``'s ``data_file`` path."""

import os

import numpy as np
import pytest

from bayesic_tpu.io import RatingsDataset as JDataset
from bayesic_tpu.io import write_ratings as jwrite
from bayesic_tpu.models import matrix_fact as jmf
from bayesic_tpu_torch.io import RatingsDataset, load_native, write_ratings
from bayesic_tpu_torch.io import ratings as ratings_mod
from bayesic_tpu_torch.models import matrix_fact as mf

# (writer, reader): the JAX package writes and the port reads, and the
# other way round
DIRECTIONS = {"jax_to_port": (jwrite, RatingsDataset),
              "port_to_jax": (write_ratings, JDataset)}


@pytest.fixture
def columns():
    rng = np.random.default_rng(0)
    n = 10_000
    return (rng.integers(0, 500, n).astype(np.int32),
            rng.integers(0, 200, n).astype(np.int32),
            rng.normal(3.5, 1.0, n).astype(np.float32))


def test_native_loader_builds():
    lib = load_native()
    assert lib is load_native()
    assert any(f.name.startswith("libratings_loader_")
               for f in ratings_mod._BUILD_DIR.iterdir())


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_roundtrip_and_shards(tmp_path, columns, direction, use_native):
    write, reader = DIRECTIONS[direction]
    users, items, vals = columns
    path = str(tmp_path / "ratings.btpr")
    write(path, users, items, vals)
    with reader(path, use_native=use_native) as ds:
        assert len(ds) == users.shape[0]
        u, i, r = ds.read_shard(0, len(ds))
        np.testing.assert_array_equal(u, users)
        np.testing.assert_array_equal(i, items)
        np.testing.assert_array_equal(r, vals)
        # a host's shard (the second half)
        u2, i2, r2 = ds.read_shard(5000, 5000)
        np.testing.assert_array_equal(u2, users[5000:])
        np.testing.assert_array_equal(i2, items[5000:])
        np.testing.assert_array_equal(r2, vals[5000:])
        with pytest.raises(IndexError):
            ds.read_shard(9000, 2000)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_batches_are_valid_samples(tmp_path, columns, direction, use_native):
    """Every sampled triple is in the data set, the batch means sit at the
    data's mean, and the port's batches are the JAX package's for the same
    seed (the same native sampler; numpy's generator)."""
    write, reader = DIRECTIONS[direction]
    users, items, vals = columns
    path = str(tmp_path / "ratings.btpr")
    write(path, users, items, vals)
    lookup = {}
    for u, i, r in zip(users, items, vals):
        lookup.setdefault(int(u), set()).add((int(i),
                                              np.float32(r).tobytes()))
    with reader(path, use_native=use_native) as ds, \
            JDataset(path, use_native=use_native) as jds, \
            RatingsDataset(path, use_native=use_native) as tds:
        it = ds.batches(256, seed=7)
        means = []
        for _ in range(20):
            u, i, r = next(it)
            assert u.shape == (256,)
            for k in range(0, 256, 64):
                assert (int(i[k]), np.float32(r[k]).tobytes()) in \
                    lookup[int(u[k])]
            means.append(r.mean())
        assert abs(np.mean(means) - vals.mean()) < 0.1
        jit, tit = jds.batches(64, seed=3), tds.batches(64, seed=3)
        for _ in range(5):
            for a, b in zip(next(jit), next(tit)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False])
def test_bad_file_rejected(tmp_path, use_native):
    p = tmp_path / "junk.btpr"
    p.write_bytes(b"not a ratings file at all....")
    with pytest.raises(IOError):
        RatingsDataset(str(p), use_native=use_native)
    # a header that claims more rows than the file holds
    q = tmp_path / "short.btpr"
    write_ratings(str(q), *(np.zeros(10, t) for t in (np.int32, np.int32,
                                                      np.float32)))
    q.write_bytes(q.read_bytes()[:-4])
    with pytest.raises(IOError):
        RatingsDataset(str(q), use_native=use_native)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A source g++ cannot compile raises with the compiler's message: the
    loader does not fall back to numpy."""
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ratings_mod, "_SRC", bad)
    monkeypatch.setattr(ratings_mod, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ratings_mod, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cc"):
        load_native()
    path = str(tmp_path / "r.btpr")
    write_ratings(path, np.zeros(3, np.int32), np.zeros(3, np.int32),
                  np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        RatingsDataset(path)


def _small(**kw):
    return dict(num_users=50, num_items=30, num_factors=4, num_ratings=5000,
                **kw)


def test_make_data_from_file_equals_the_synthetic_arrays(tmp_path):
    """A missing file is generated from the synthetic recipe and written;
    reading it back, and the JAX package reading it, gives the synthetic
    arrays."""
    path = str(tmp_path / "mf.btpr")
    want = mf.make_data(mf.Config(**_small()))[:3]
    for _ in range(2):          # written on the first call, read on both
        got = mf.make_data(mf.Config(**_small(), data_file=path))
        assert got[3] is None
        for a, b in zip(got[:3], want):
            np.testing.assert_array_equal(a, b)
    assert os.path.getsize(path) == 16 + 12 * 5000
    jgot = jmf.make_data(jmf.Config(**_small(), data_file=path))
    for a, b in zip(jgot[:3], want):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_run_takes_the_files_rating_count(tmp_path):
    """``run`` re-syncs ``num_ratings`` to the file's count, as the JAX
    package does: 4,000 ratings in the file, 5,000 in the config (the
    plate would otherwise index past the file's rows)."""
    path = str(tmp_path / "mf.btpr")
    write_ratings(path, *mf.make_data(mf.Config(**dict(_small(),
                                                       num_ratings=4000)))
                  [:3])
    out = mf.run(mf.Config(**_small(), steps=5, batch_size=512,
                           data_file=path, device="cpu"))
    assert out["losses"].shape == (5,)
    assert np.isfinite(out["losses"]).all()
