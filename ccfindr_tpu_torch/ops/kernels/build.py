"""Build and load the package's CUDA kernels.

The sources under ``ccfindr_tpu_torch/csrc`` have a plain C interface
and are compiled with ``nvcc`` for Hopper (``sm_90a``) at first use:
one ``nvcc -c`` a source, all started together, then one link into a
shared library, cached under ``ccfindr_tpu_torch/_build/`` by a hash of
the sources and flags, and loaded with ``ctypes``.  Nothing is compiled
or loaded when this module is imported.  There is no fallback: a
missing ``nvcc`` or a failed build raises.
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

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")


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


def _run_all(cmds):
    """Run the commands concurrently; raise on the first that failed.
    Returns their joined stderr (ptxas's reports)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}\n{err}")
    return "".join(err for _, err in outs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these exact sources
    exists; returns its path.  ``verbose`` prints ptxas's register,
    shared-memory and spill report of a fresh build."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o")
                for p in sorted(CSRC.glob("*.cu"))]
        report = _run_all(
            [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, str(p)]
             for o, p in zip(objs, sorted(CSRC.glob("*.cu")))])
        lib = os.path.join(tmp, so.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        if verbose:
            print(report, flush=True)
        os.replace(lib, so)   # atomic: no reader sees a half-written library
    return so


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_int64
_SIGNATURES = {
    "sol_xpass": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _P, _P, _P, _P, _P],
    "sol_w_post": [_I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "sol_h_post": [_I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "sol_finish": [_I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                   _I, _I, _I, _I, _D, _P, _P],
    "ml_hpass": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "ml_wpass": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "ml_xlog_sum": [_P, _I, _I, _P, _P],
    "sp_rowpass": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _L, _P, _P, _P, _P],
    "sp_colpass": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P, _P],
    "fused_xpass": [_I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P],
    "fused_sum": [_I, _P, _I, _I, _P, _I, _I, _P, _P, _P],
    "epi_w_post": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "epi_h_post": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "ss_xpass": [_I, _I, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "elbo_xpass": [_I, _I, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                   _P],
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


# ---------------------------------------------------------------------
# What every wrapper shares
# ---------------------------------------------------------------------

# the C entry points' type codes
TCODE = {torch.float32: 0, torch.float64: 1}
XCODE = {torch.int8: 0, torch.int16: 1, torch.float32: 2, torch.float64: 3}


def stream() -> int:
    """PyTorch's current CUDA stream, as the C entry points take it."""
    return torch.cuda.current_stream().cuda_stream


def check_launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require_cuda(*ts):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                             f"{t.device}")
