"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

The sources have a plain C interface and are bound with ``ctypes``: a build
takes seconds, where one that includes PyTorch's headers takes minutes.
Each ``.cu`` compiles in its own ``nvcc`` process, all started together,
and one more links them into a library that lands in ``csrc/build/`` under
a name that carries a hash of the sources, so an edited source is rebuilt
and a stale library is never loaded.  A missing ``nvcc`` or a failed build
raises.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
                                ctypes.c_float, ctypes.c_ulonglong, i32, vp])
    lib.fused_vae_train.restype = i32
    lib.bt_error_string.argtypes = [i32]
    lib.bt_error_string.restype = ctypes.c_char_p
    f32 = ctypes.c_float
    sz = ctypes.c_size_t
    lib.fused_nuts_workspace_bytes.argtypes = [i32] * 7
    lib.fused_nuts_workspace_bytes.restype = sz
    # a keyed entry's seed, phase, step and chain base
    key = [ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint]
    lib.fused_nuts_transition.argtypes = (
        [vp] * 23 + [sz] + [i32] * 6 + [f32, f32, vp])
    lib.fused_nuts_transition.restype = i32
    lib.fused_nuts_transition_keyed.argtypes = (
        [vp] * 19 + [sz] + [i32] * 6 + [f32, f32] + key + [vp])
    lib.fused_nuts_transition_keyed.restype = i32
    lib.fused_nuts_potential.argtypes = [vp] * 9 + [sz] + [i32] * 5 + [f32,
                                                                      vp]
    lib.fused_nuts_potential.restype = i32
    lib.fused_nuts_draws.argtypes = [vp] * 4 + [i32] * 3 + key + [vp]
    lib.fused_nuts_draws.restype = i32
    lib.fused_hier_geometry.argtypes = [i32] * 3 + [vp]
    lib.fused_hier_geometry.restype = i32
    lib.fused_hier_train.argtypes = (
        [vp] * 10 + [i32] * 5 + [ctypes.c_longlong, i32, f32, i32, f32,
                                 ctypes.c_ulonglong, vp])
    lib.fused_hier_train.restype = i32
    lib.fused_hier_probe.argtypes = (
        lib.fused_hier_train.argtypes[:-1] + [vp, vp])
    lib.fused_hier_probe.restype = i32
    lib.fused_hier_nuts_geometry.argtypes = [i32] * 5 + [vp]
    lib.fused_hier_nuts_geometry.restype = i32
    lib.fused_hier_nuts_transition.argtypes = [vp] * 21 + [i32] * 6 + [f32,
                                                                       vp]
    lib.fused_hier_nuts_transition.restype = i32
    lib.fused_hier_nuts_transition_keyed.argtypes = (
        [vp] * 17 + [i32] * 6 + [f32] + key + [vp])
    lib.fused_hier_nuts_transition_keyed.restype = i32
    lib.fused_hier_nuts_potential.argtypes = [vp] * 7 + [i32] * 5 + [vp]
    lib.fused_hier_nuts_potential.restype = i32
    lib.gmm_loglik_fwd.argtypes = [vp] * 5 + [i32] * 4 + [vp]
    lib.gmm_loglik_fwd.restype = i32
    lib.gmm_loglik_bwd.argtypes = [vp] * 8 + [i32] * 4 + [vp]
    lib.gmm_loglik_bwd.restype = i32
    lib.gmm_loglik_vg.argtypes = [vp] * 8 + [i32] * 4 + [vp]
    lib.gmm_loglik_vg.restype = i32
    lib.gmm_loglik_geometry.argtypes = [i32] * 5 + [vp]
    lib.gmm_loglik_geometry.restype = i32
    lib.smc_gmm_mutate_smem_bytes.argtypes = [i32] * 3
    lib.smc_gmm_mutate_smem_bytes.restype = ctypes.c_size_t
    lib.smc_gmm_mutate_geometry.argtypes = [i32] * 3 + [vp]
    lib.smc_gmm_mutate_geometry.restype = i32
    lib.smc_gmm_mutate.argtypes = [vp] * 11 + [i32] * 6 + [f32, f32, vp]
    lib.smc_gmm_mutate.restype = i32
    lib.fused_linreg_train.argtypes = (
        [vp] * 9 + [i32] * 2 + [ctypes.c_longlong, i32, f32, i32, f32, f32,
                                ctypes.c_ulonglong, vp])
    lib.fused_linreg_train.restype = i32
    lib.fused_linreg_probe.argtypes = (
        lib.fused_linreg_train.argtypes[:-1] + [vp, vp])
    lib.fused_linreg_probe.restype = i32
    lib.mf_dense_scratch_floats.argtypes = [i32] * 3
    lib.mf_dense_scratch_floats.restype = ctypes.c_size_t
    lib.mf_dense_cell_grads.argtypes = [vp] * 8 + [i32] * 4 + [vp]
    lib.mf_dense_cell_grads.restype = i32


def _run_all(cmds):
    """Run the commands side by side; returns their combined output, or
    raises with it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    bad = [(c, p.returncode) for c, p in zip(cmds, procs) if p.returncode]
    if bad:
        raise RuntimeError(f"nvcc failed ({bad[0][1]}): "
                           f"{' '.join(bad[0][0])}\n{log}")
    return log


def _compile(cus, tmp, so):
    """One nvcc per source, all at once, then one link; the library is
    moved into place only when complete."""
    nvcc = _nvcc()
    objs = [tmp / (cu.stem + ".o") for cu in cus]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)]
                    for cu, o in zip(cus, objs)])
    out = tmp / so.name
    log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(out),
                      *map(str, objs)]])
    os.replace(out, so)
    return log


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
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                _log = _compile(cus, Path(tmp), so)
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
