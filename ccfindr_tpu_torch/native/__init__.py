"""The native (C++) MatrixMarket reader and writer, bound via ctypes.

Copy of ``ccfindr_tpu.native`` (``mmio.cpp`` unchanged).  Built with
``g++`` at first use into the package's build directory
(``ccfindr_tpu_torch/_build/``, never next to the sources) and cached
there by a hash of the source; ``io.read_mtx``/``write_mtx`` take their
pure-Python route where no ``g++`` is present (host I/O only, as in the
JAX package).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "mmio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lib = None
_build_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libccfindr_native_{digest}.so"


def _build(so: Path) -> bool:
    """Compile ``mmio.cpp`` into ``so``: into a temporary file first,
    then renamed, so that concurrent first uses never load half a
    library."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-pthread", "-o",
                        tmp, str(_SRC)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """Load (building if needed) the native library; None if it cannot
    be built."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    so = _lib_path()
    if not so.exists() and not _build(so):
        _build_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        _build_failed = True
        return None
    ip, dp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)
    lib.mtx_parse.restype = ctypes.c_int
    lib.mtx_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                              ctypes.c_long, ip, ip, dp]
    lib.mtx_parse_mt.restype = ctypes.c_int
    lib.mtx_parse_mt.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                 ctypes.c_long, ip, ip, dp, ctypes.c_int]
    lib.mtx_write_body.restype = ctypes.c_int
    lib.mtx_write_body.argtypes = [ctypes.c_char_p, ctypes.c_long, ip, ip,
                                   dp, ctypes.c_int]
    _lib = lib
    return _lib
