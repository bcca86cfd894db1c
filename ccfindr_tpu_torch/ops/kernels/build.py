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


# ptxas's register, shared-memory and spill report of this process's
# build ("" where the library was already built)
PTXAS_REPORT = {"text": ""}


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these exact sources
    exists; returns its path.  ``verbose`` prints ptxas's register,
    shared-memory and spill report of a fresh build (kept in
    :data:`PTXAS_REPORT` either way)."""
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
        PTXAS_REPORT["text"] = report
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
                  _I, _I, _P, _P, _P, _P, _P],
    "sol_w_post": [_I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "sol_h_post": [_I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "sol_finish": [_I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                   _I, _I, _I, _I, _D, _P, _P],
    "ml_hpass": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "ml_wpass": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "sp_rowpass": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                   _I, _L, _P, _P, _P, _P, _P, _P],
    "sp_colpass": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P,
                   _P],
    "fused_xpass": [_I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P],
    "fused_sum": [_I, _P, _I, _I, _P, _I, _I, _P, _P, _P],
    "div_rn_check": [_P, _P, _L, _P, _P],
    "epi_w_post": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "epi_h_post": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "ss_xpass": [_I, _I, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "elbo_xpass": [_I, _I, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                   _P, _P, _P],
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


def launch(entry, *args):
    """Launch a kernel: the one way into the C entry points.

    ``entry`` is a name of the package's library (:data:`_SIGNATURES`)
    or a ctypes function of another build with the same convention
    (the benchmarks' variants).  ``args`` are its arguments but the
    last: tensors go as their data pointers, None as NULL.  Every tensor
    must lie on one CUDA device (:func:`require_cuda`); that device is
    entered for the call and its current stream passed last.  So a
    kernel runs on the card that holds its tensors, after the work
    queued there, whatever the caller's current device."""
    dev = require_cuda(*(a for a in args if isinstance(a, torch.Tensor)))
    fn = getattr(library(), entry) if isinstance(entry, str) else entry
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    with torch.cuda.device(dev):
        rc = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(getattr(fn, "__name__", entry), rc)


def check_launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


_TICKETS = {}


def tickets(nb, device):
    """The per-lane ticket counters (at least ``nb`` int32, all 0) that
    a kernel ending in ``reduce.cuh``'s ``lane_tail_sum`` takes: the
    last block of a lane to finish adds the lane's partials and puts its
    counter back to 0.  Allocated zeroed once for each device and stream
    and cached (reallocated only when ``nb`` outgrows it), so a sweep
    pays no memset."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < nb:
        t = torch.zeros(max(nb, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def require_cuda(*ts):
    """The one CUDA device that holds the tensors ``ts``; raises where
    one is not a CUDA tensor or they lie on more than one device (a
    kernel reads its tensors where they are: nothing is copied)."""
    devs = {t.device for t in ts}
    for d in devs:
        if d.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA tensors, got {d}")
    if len(devs) != 1:
        raise ValueError("a kernel's tensors must lie on one CUDA device, "
                         f"got {sorted(map(str, devs)) or 'none'}")
    return devs.pop()
