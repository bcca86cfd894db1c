"""Build and load the package's CUDA kernels.

The sources under ``ccfindr_tpu_torch/csrc`` have a plain C interface
and are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared
library at first use, cached under ``ccfindr_tpu_torch/_build/`` by a
hash of the sources and flags, and loaded with ``ctypes``.  Nothing is
compiled or loaded when this module is imported.  There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if path is None and os.path.exists(os.path.join(cuda_home, "bin/nvcc")):
        path = os.path.join(cuda_home, "bin/nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "ccfindr_tpu_torch are built at first use")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libccfindr_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these exact sources
    exists; returns its path.  ``verbose`` prints ptxas's register,
    shared-memory and spill report of a fresh build."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr, flush=True)
    os.replace(tmp, so)   # atomic: no reader sees a half-written library
    return so


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "sol_xpass": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                  _P, _P, _P, _P, _P],
    "sol_w_post": [_I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "sol_h_post": [_I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "sol_finish": [_I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                   _I, _I, _I, _I, _D, _P, _P],
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib
