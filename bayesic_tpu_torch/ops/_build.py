"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

The sources have a plain C interface and are bound with ``ctypes``: a build
takes seconds, where one that includes PyTorch's headers takes minutes.
The library lands in ``csrc/build/`` under a name that carries a hash of
the sources, so an edited source is rebuilt and a stale library is never
loaded.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load", "build_log",
           "error_string"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
_log = ""


def _nvcc():
    home = os.environ.get("CUDA_HOME")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_vae_scratch_floats.argtypes = [i32, i32, i32, i32]
    lib.fused_vae_scratch_floats.restype = ctypes.c_size_t
    lib.fused_vae_train.argtypes = (
        [vp] * 8 + [i32] * 6 + [ctypes.c_longlong, i32, ctypes.c_float,
                                ctypes.c_float, ctypes.c_ulonglong, vp])
    lib.fused_vae_train.restype = i32
    lib.bt_error_string.argtypes = [i32]
    lib.bt_error_string.restype = ctypes.c_char_p


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib, _log
    with _lock:
        if _lib is not None:
            return _lib
        cus, cuhs = _sources()
        h = hashlib.sha256()
        for f in cus + cuhs:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"libbayesic_kernels_{h.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cus)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            _log = res.stdout + res.stderr
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


def build_log():
    """nvcc's output of this process's build ('' if the library was
    already built): the ``-Xptxas -v`` register and spill summary."""
    return _log


def error_string(err):
    lib = load()
    return lib.bt_error_string(int(err)).decode()
