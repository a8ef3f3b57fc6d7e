"""Ratings files: the columnar binary format, mmap'd reads of a host's
shard, and a threaded with-replacement minibatch sampler.

Counterpart of ``bayesic_tpu/io/ratings.py``, on the same file format
(``_MAGIC``), so either package reads the other's files.  The native
loader (``cpp/ratings_loader.cc``, bound with ``ctypes``) is built with
``g++`` at its first use into ``csrc/build/`` under a name that carries a
hash of the source, so an edited source is rebuilt and a stale library is
never loaded; a failed build raises with the compiler's output.  The
numpy path is the loader's plain version, chosen by ``use_native=False``;
it reads the same rows, and its minibatches are uniform draws with
replacement from numpy's generator (the native sampler's streams are its
own).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["RatingsDataset", "write_ratings", "load_native"]

_MAGIC = 0x4254505230303131
_SRC = Path(__file__).resolve().parent / "cpp" / "ratings_loader.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None
_lib_lock = threading.Lock()


def _declare(lib):
    vp, u64 = ctypes.c_void_p, ctypes.c_uint64
    lib.btpr_open.restype = vp
    lib.btpr_open.argtypes = [ctypes.c_char_p]
    lib.btpr_size.restype = u64
    lib.btpr_size.argtypes = [vp]
    lib.btpr_read_shard.restype = ctypes.c_int
    lib.btpr_read_shard.argtypes = [vp, u64, u64, vp, vp, vp]
    lib.btpr_batch_start.restype = vp
    lib.btpr_batch_start.argtypes = [vp, u64, u64, ctypes.c_int]
    lib.btpr_batch_next.restype = u64
    lib.btpr_batch_next.argtypes = [vp, vp, vp, vp]
    lib.btpr_batch_close.restype = None
    lib.btpr_batch_close.argtypes = [vp]
    lib.btpr_close.restype = None
    lib.btpr_close.argtypes = [vp]


def load_native():
    """Build (once per source hash) and load the native loader.  Raises
    ``RuntimeError`` with the compiler's output if ``g++`` fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(_SRC.read_bytes())
        h.update(" ".join(_CXX_FLAGS).encode())
        so = _BUILD_DIR / f"libratings_loader_{h.hexdigest()[:16]}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
                out = Path(tmp) / so.name
                cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(out)]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                except FileNotFoundError as e:
                    raise RuntimeError(f"g++ not found: {e}") from None
                if proc.returncode:
                    raise RuntimeError(
                        f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(out, so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


def write_ratings(path, users, items, ratings):
    """Write the columnar binary format: magic, count, then the users,
    items and ratings columns.  The file appears whole or not at all (a
    temporary file in the same directory, then a rename), so ranks that
    write the same file at once leave one whole copy."""
    users = np.ascontiguousarray(users, np.int32)
    items = np.ascontiguousarray(items, np.int32)
    ratings = np.ascontiguousarray(ratings, np.float32)
    n = users.shape[0]
    if items.shape != (n,) or ratings.shape != (n,):
        raise ValueError(f"columns of unequal length: {users.shape}, "
                         f"{items.shape}, {ratings.shape}")
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(struct.pack("<QQ", _MAGIC, n))
            f.write(users.tobytes())
            f.write(items.tobytes())
            f.write(ratings.tobytes())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


class RatingsDataset:
    """An mmap'd ratings file with host-shard reads and a prefetching
    minibatch iterator; ``use_native=False`` reads it with numpy."""

    def __init__(self, path, use_native=True):
        self.path = path
        self.native = bool(use_native)
        self._iters = set()
        if self.native:
            lib = load_native()
            self._h = lib.btpr_open(os.fsencode(path))
            if not self._h:
                raise IOError(f"could not open ratings file {path}")
            self._n = int(lib.btpr_size(self._h))
        else:
            with open(path, "rb") as f:
                head = f.read(16)
            if len(head) < 16:
                raise IOError(f"{path} is too short for a ratings file")
            magic, n = struct.unpack("<QQ", head)
            size = os.path.getsize(path)
            if magic != _MAGIC or n > (size - 16) // 12:
                raise IOError(f"bad magic or count in {path}")
            self._n = int(n)
            self._mm = np.memmap(path, np.uint8, "r")
            self._users = self._mm[16:16 + 4 * n].view(np.int32)
            self._items = self._mm[16 + 4 * n:16 + 8 * n].view(np.int32)
            self._ratings = self._mm[16 + 8 * n:16 + 12 * n].view(np.float32)

    def __len__(self):
        return self._n

    def read_shard(self, start, count):
        """The contiguous rows [start, start + count) as (users, items,
        ratings): a host's shard."""
        if start < 0 or count < 0 or start + count > self._n:
            raise IndexError(f"shard [{start}, {start + count}) out of "
                             f"range of {self._n} ratings")
        u = np.empty(count, np.int32)
        i = np.empty(count, np.int32)
        r = np.empty(count, np.float32)
        if self.native:
            rc = load_native().btpr_read_shard(self._h, start, count, _ptr(u),
                                               _ptr(i), _ptr(r))
            if rc:
                raise IOError(f"btpr_read_shard failed ({rc})")
        else:
            u[:] = self._users[start:start + count]
            i[:] = self._items[start:start + count]
            r[:] = self._ratings[start:start + count]
        return u, i, r

    def batches(self, batch_size, seed=0, num_threads=4):
        """Infinite iterator of minibatches drawn uniformly with
        replacement; the native path gathers the next batch on worker
        threads while the caller consumes the current one."""
        if not self.native:
            rng = np.random.default_rng(seed)
            while True:
                idx = rng.integers(0, self._n, batch_size)
                yield (self._users[idx], self._items[idx],
                       self._ratings[idx])
        lib = load_native()
        it = lib.btpr_batch_start(self._h, batch_size, seed, num_threads)
        if not it:
            raise ValueError(f"cannot sample batches of {batch_size}")
        self._iters.add(it)
        try:
            # close() may have torn the iterator down: calling into the
            # freed handle would be a use after free
            while it in self._iters:
                u = np.empty(batch_size, np.int32)
                i = np.empty(batch_size, np.int32)
                r = np.empty(batch_size, np.float32)
                if lib.btpr_batch_next(it, _ptr(u), _ptr(i), _ptr(r)) == 0:
                    return
                yield u, i, r
        finally:
            if it in self._iters:
                self._iters.discard(it)
                lib.btpr_batch_close(it)

    def close(self):
        if self.native and self._h:
            lib = load_native()
            # stop the batch iterators before unmapping: their worker
            # threads read the mapping
            for it in list(self._iters):
                self._iters.discard(it)
                lib.btpr_batch_close(it)
            lib.btpr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
