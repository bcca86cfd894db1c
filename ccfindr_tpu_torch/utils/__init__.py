"""Host utilities: the device check, phase timings, the trace context
(:func:`profile_trace`) and the compressed X storage type."""

from __future__ import annotations

import contextlib
import time

import numpy as _np
import torch

from .profiling import profile_trace  # noqa: F401


def resolve_device(device):
    """``torch.device(device)``; raises when a CUDA device is asked for
    and none is present.  The drivers and the public constructors (which
    default to ``device="cuda"``) share it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "plain PyTorch path")
    return device


_LANE_SUM_WIDTH = 32


def lane_sum(t, ndim=1, dtype=None):
    """Sum over the trailing ``ndim`` axes of ``t``, in an order fixed by
    their extent alone: 32 consecutive entries at a time (zero-padded),
    then 32 of those sums, and so on to one.

    ``torch.sum`` picks its blocking on the CPU and on the card from
    the whole shape, leading lanes included, so a lane's sum can change
    in its last bits when the lane batch shrinks.  Here every level
    reduces 32-wide rows, whose order does not depend on how many rows
    there are: a lane's result is the same bits in a batch of any size,
    which the chunked and lane-compacted drivers rely on.  ``dtype``
    casts first (float64 sums of float32 entries)."""
    lead = t.shape[:t.dim() - ndim]
    v = t.reshape(*lead, -1)
    if dtype is not None:
        v = v.to(dtype)
    w = _LANE_SUM_WIDTH
    while True:
        k = v.shape[-1]
        if k % w:
            v = torch.nn.functional.pad(v, (0, w - k % w))
        v = v.view(*lead, -1, w).sum(-1)
        if k <= w:
            return v[..., 0]


def lane_partials(t):
    """The first two levels of :func:`lane_sum`'s tree over the last
    axis of ``t``: (..., ceil(k / 1024)).  Where ``t``'s cells are a
    piece of a longer row that starts on a multiple of 1,024 cells,
    these are that row's partials at that level, so ``lane_sum`` over
    the pieces' partials joined in order is the row's ``lane_sum``, bit
    for bit (the cell shards of a mesh, ``parallel.hshards.hsum``)."""
    w = _LANE_SUM_WIDTH
    v = t
    for _ in range(2):
        k = v.shape[-1]
        if k % w:
            v = torch.nn.functional.pad(v, (0, w - k % w))
        v = v.view(*v.shape[:-1], -1, w).sum(-1)
    return v


# lanes a product of lane_matmul: 4 had the least mean sweep time of the
# forms timed by tools/bench_lane_matmul.py (1 to 4 lanes, bundled and
# 10x shapes, both dense routes, VB and ML) on an H100
LANE_MATMUL_CHUNK = 4
# the boundary every operand and output of lane_matmul's products starts
# on, so that the library picks one algorithm for every window of lanes
# (cuBLAS and MKL choose kernels by the operands' alignment as well as
# their shape)
_LANE_ALIGN = {"cuda": 256, "cpu": 64}


def _aligned(t, align):
    """``t`` itself when its data starts on an ``align``-byte boundary,
    else a contiguous copy (a fresh allocation is aligned)."""
    if t.data_ptr() % align == 0:
        return t
    return t.clone()


def lane_matmul(a, b):
    """``a @ b`` for ``a (..., p, q)`` and ``b (..., q, s)``, whose
    lanes (the leading axes, broadcast) each get the same bits in a
    batch of any size.

    A batched ``torch.matmul`` leaves the algorithm to the library,
    which picks it on the card by the batch count as well as the shape:
    a lane's product could change its last bits when the batch does
    (lane compaction, a process's share of the grid).  Here every
    product is a batch of exactly :data:`LANE_MATMUL_CHUNK` lanes:
    windows of consecutive lanes, the last one ending at the last lane
    (it may repeat lanes of the one before, which get the same bits),
    or, with fewer lanes, one batch padded with copies of the last
    lane.  The operands are made
    contiguous and every window starts on a :data:`_LANE_ALIGN`
    boundary, so that every product has the same shape, strides and
    alignment whatever the lane count.  Two 2-D operands are one
    product."""
    if a.dim() == 2 and b.dim() == 2:
        return a @ b
    chunk = LANE_MATMUL_CHUNK
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    p, s = a.shape[-2], b.shape[-1]
    a = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    a, b = a.contiguous(), b.contiguous()
    nl = a.shape[0]
    if nl < chunk:
        pad = chunk - nl
        o = torch.matmul(torch.cat([a, a[-1:].expand(pad, -1, -1)]),
                         torch.cat([b, b[-1:].expand(pad, -1, -1)]))
        return o[:nl].view(*lead, p, s)
    out = torch.empty(nl, p, s, dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    align = _LANE_ALIGN.get(a.device.type, 64)
    for i0 in range(0, nl, chunk):
        i = min(i0, nl - chunk)
        ai = _aligned(a[i:i + chunk], align)
        bi = _aligned(b[i:i + chunk], align)
        oi = out[i:i + chunk]
        if oi.data_ptr() % align == 0:
            torch.matmul(ai, bi, out=oi)
        else:
            oi.copy_(torch.matmul(ai, bi))
    return out.view(*lead, p, s)


def lgamma_sum(x, device=None):
    """``sum lgamma(x + 1)`` of a dense X in float64 on ``device``
    (default: X's), a block of rows at a time, so that no float64 copy
    of a large X is formed.  An X held elsewhere (a mesh's, on the host)
    crosses a block at a time and gives the same bits."""
    device = x.device if device is None else torch.device(device)
    rows = max(1, (1 << 24) // max(1, x.shape[1]))
    return sum(torch.lgamma(x[i:i + rows].to(device, torch.float64) + 1.0)
               .sum() for i in range(0, x.shape[0], rows))


def lane_colsum(t, dtype=None):
    """:func:`lane_sum` over axis -2 of ``t`` (..., rows, cols): the
    column sums, (..., cols)."""
    return lane_sum(t.transpose(-1, -2), 1, dtype)


def auto_storage_dtype(mat):
    """Pick the compressed on-device X dtype for ``storage_dtype='auto'``.

    Raw UMI counts are small integers; storing X as int8/int16 on
    device cuts the per-sweep X stream 4x/2x with EXACT math — the
    sweep converts each element to the factor type before any
    arithmetic.  Returns
    ``numpy.int8``/``numpy.int16`` when every entry is an integer that
    fits, else ``None`` (normalized/float matrices and counts beyond
    int16 keep the full-precision stream).

    The integrality scan runs in bounded chunks of the flattened array
    so the atlas-scale matrix (2e9 elements) never allocates a
    full-size temporary.
    """
    if mat.size == 0:
        return None
    mx = float(mat.max())
    if mx > _np.iinfo(_np.int16).max or float(mat.min()) < 0:
        return None
    flat = _np.ravel(mat)
    for i0 in range(0, flat.size, 1 << 24):
        blk = flat[i0:i0 + (1 << 24)]
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
