"""Host utilities: phase timings and the compressed X storage type."""

from __future__ import annotations

import contextlib
import time

import numpy as _np


def auto_storage_dtype(mat):
    """Pick the compressed on-device X dtype for ``storage_dtype='auto'``.

    Raw UMI counts are small integers; storing X as int8/int16 on
    device cuts the per-sweep X stream 4x/2x with EXACT math — the
    sweep converts each element to the factor type before any
    arithmetic.  Returns
    ``numpy.int8``/``numpy.int16`` when every entry is an integer that
    fits, else ``None`` (normalized/float matrices and counts beyond
    int16 keep the full-precision stream).

    The integrality scan runs in bounded chunks so the atlas-scale
    matrix (2e9 elements) never allocates a full-size temporary.
    """
    if mat.size == 0:
        return None
    mx = float(mat.max())
    if mx > _np.iinfo(_np.int16).max or float(mat.min()) < 0:
        return None
    rows = max(1, (1 << 24) // max(1, int(mat.shape[-1])))
    for i0 in range(0, mat.shape[0], rows):
        blk = mat[i0:i0 + rows]
        if not _np.array_equal(blk, _np.round(blk)):
            return None
    return _np.int8 if mx <= _np.iinfo(_np.int8).max else _np.int16


class Timings:
    """Lightweight phase timer; accumulates (name, seconds, extras)."""

    def __init__(self):
        self.records: list[dict] = []

    @contextlib.contextmanager
    def phase(self, name: str, **extras):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append(
                dict(name=name, seconds=time.perf_counter() - t0,
                     **extras))

    def summary(self) -> list[dict]:
        out = []
        for rec in self.records:
            d = dict(rec)
            sweeps = d.get("total_sweeps")
            if sweeps:
                d["sweeps_per_sec"] = sweeps / d["seconds"]
            out.append(d)
        return out
