"""The fused X pass of the VB sweep as hand-written CUDA, with its plain
PyTorch version.

Counterpart of ``ccfindr_tpu/ops/pallas/vb_kernels.py``, under its
names: :func:`fused_pallas_raw` returns ``swn = (x/wth) lh^T``, ``shn =
lw^T (x/wth)`` and ``xlog = sum x log wth`` with ``wth = lw lh``, for a
lane batch, in the JAX package's layouts (``x (np, mp)``, ``lw (B, np,
rp)``, ``lh (B, rp, mp)``; ``swn`` like ``lw``, ``shn`` like ``lh``,
``xlog (B,)`` float64).  On CUDA tensors it launches E1 ``fused_xpass``
(``layout='gm'`` replaces ``_fused_gm_kernel``, ``'cm'``
``_fused_cm_kernel``) and E1s ``fused_sum`` of ``csrc/epi.cu``; on CPU
tensors it takes :func:`fused_xpass_plain`; there is no fallback
between them.  No padding contract: rows of ``lw`` past the true gene
count and columns of ``lh`` past the true cell count meet zero rows
and columns of ``x``, and rank rows past ``r`` are zero.

``DEFAULT_BN``/``DEFAULT_BM`` and :func:`_fused_layout` are the JAX
package's, kept for the driver's routing between the cell-major sweep
(``ops/kernels/sol.py``) and the gene-major one
(``ops/kernels/epilogue.py``); the kernels here have no TPU tiles.
"""

from __future__ import annotations

import torch

from ..sparse import fold_dterm  # noqa: F401  (the JAX module's name)
from .build import TCODE, XCODE, check_launch, library, require_cuda, stream
from .sol import MAX_RP, bf16_round

DEFAULT_BN = 1024
DEFAULT_BM = 512

# E1's chunk of its outer axis starts here and doubles until the
# per-chunk partials take no more bytes than X (csrc/epi.cu)
CHUNK = 512

# launches per kernel since the last reset (bumped only where a kernel
# is launched)
LAUNCHES = {"fused_xpass_cm": 0, "fused_xpass_gm": 0, "fused_sum": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fused_layout(np_, mp_, rp_, itemsize=4):
    """'cm' (cell-major) unless swn's VMEM residency (n x 128 lanes
    physical) is the binding constraint and the gene-major shn
    residency fits.

    The budget is a quarter of v5e VMEM (128 MB): prefer cm whenever
    it fits — Mosaic compile time for gm's full-array shn block grows
    pathologically with the cell count (measured: 100k cells never
    finished compiling in 25 min; cm compiled in 11 s), so gm is only
    for huge GENE panels where cm's swn residency cannot fit."""
    budget = 32 * 2 ** 20
    cm_resident = np_ * max(rp_, 128) * itemsize
    gm_resident = max(rp_, 8) * mp_ * itemsize
    if cm_resident <= budget or cm_resident <= gm_resident:
        return "cm"
    return "gm"


def _check(x, lw, lh, layout):
    if layout not in ("cm", "gm"):
        raise ValueError(f"unknown layout {layout!r}")
    if lw.dtype not in TCODE or lh.dtype != lw.dtype:
        raise TypeError(f"lw and lh must share float32 or float64, got "
                        f"{lw.dtype} and {lh.dtype}")
    if x.dtype not in XCODE:
        raise TypeError(f"X must be int8, int16, float32 or float64, "
                        f"got {x.dtype}")
    if x.dim() != 2 or lw.dim() != 3:
        raise ValueError("X must be (np, mp) and lw (B, np, rp)")
    np_, mp_ = x.shape
    nb, npw, rp_ = lw.shape
    if npw != np_ or lh.shape != (nb, rp_, mp_):
        raise ValueError(f"shape mismatch: X {tuple(x.shape)}, lw "
                         f"{tuple(lw.shape)}, lh {tuple(lh.shape)}")
    if not 0 < rp_ <= MAX_RP:
        raise ValueError(f"rank {rp_} must be in [1, {MAX_RP}]")
    if len({x.device, lw.device, lh.device}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{ {x.device, lw.device, lh.device} }")
    for name, t in (("x", x), ("lw", lw), ("lh", lh)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_xpass_plain(x, lw, lh, mxu_bf16=False):
    """E1 + E1s's function: ``(swn (B, np, rp), shn (B, rp, mp), xlog
    (B,) f64)``.  ``mxu_bf16`` rounds lw, lh and u to bf16 before the
    products; the sums and ``log(wth)`` stay in the factor dtype."""
    dt = lw.dtype
    xf = x.to(dt)
    if mxu_bf16:
        lw, lh = bf16_round(lw), bf16_round(lh)
    wth = lw @ lh
    u = xf / wth
    if mxu_bf16:
        u = bf16_round(u)
    swn = u @ lh.transpose(-1, -2)
    shn = lw.transpose(-1, -2) @ u
    xlog = (xf * torch.log(wth)).sum((-2, -1), dtype=torch.float64)
    return swn, shn, xlog


def fused_chunk(x, lw, layout):
    """E1's chunk of its outer axis (genes for 'gm', cells for 'cm'):
    :data:`CHUNK`, doubled while the per-chunk partials would take
    more bytes than X."""
    np_, mp_ = x.shape
    nb, _, rp_ = lw.shape
    outer, inner = (np_, mp_) if layout == "gm" else (mp_, np_)
    xbytes = x.numel() * x.element_size()
    chunk = CHUNK
    while (chunk < outer and nb * -(-outer // chunk) * rp_ * inner
           * lw.element_size() > xbytes):
        chunk *= 2
    return chunk


def fused_xpass(x, lw, lh, *, layout, mxu_bf16=False):
    """Launch E1.  Returns ``(full, part, xlog_part)``: for 'gm' ``swn
    (B, np, rp)``, the shn partials ``(B, ngc, rp, mp)``; for 'cm'
    ``shn (B, rp, mp)``, the swn partials ``(B, ncc, np, rp)``; and the
    per-chunk ``sum x log wth`` ``(B, nchunk)`` float64."""
    require_cuda(x, lw, lh)
    np_, mp_ = x.shape
    nb, _, rp_ = lw.shape
    chunk = fused_chunk(x, lw, layout)
    gm = layout == "gm"
    nchunk = -(-(np_ if gm else mp_) // chunk)
    full = torch.empty(*((nb, np_, rp_) if gm else (nb, rp_, mp_)),
                       dtype=lw.dtype, device=x.device)
    part = torch.empty(*((nb, nchunk, rp_, mp_) if gm
                         else (nb, nchunk, np_, rp_)),
                       dtype=lw.dtype, device=x.device)
    xlog_part = torch.empty(nb, nchunk, dtype=torch.float64,
                            device=x.device)
    rc = library().fused_xpass(
        TCODE[lw.dtype], XCODE[x.dtype], int(gm), int(bool(mxu_bf16)),
        x.data_ptr(), lw.data_ptr(), lh.data_ptr(), nb, np_, mp_, rp_,
        chunk, full.data_ptr(), part.data_ptr(), xlog_part.data_ptr(),
        stream())
    check_launch("fused_xpass", rc)
    LAUNCHES[f"fused_xpass_{layout}"] += 1
    return full, part, xlog_part


def fused_sum(part, xlog_part):
    """Launch E1s: ``(part.sum(1) in the factor dtype, xlog_part.sum(1))``,
    each summed in float64 in chunk order."""
    require_cuda(part, xlog_part)
    nb, nchunk = part.shape[:2]
    out = torch.empty(nb, *part.shape[2:], dtype=part.dtype,
                      device=part.device)
    xlog = torch.empty(nb, dtype=torch.float64, device=part.device)
    rc = library().fused_sum(
        TCODE[part.dtype], part.data_ptr(), nchunk, out[0].numel(),
        xlog_part.data_ptr(), xlog_part.shape[1], nb, out.data_ptr(),
        xlog.data_ptr(), stream())
    check_launch("fused_sum", rc)
    LAUNCHES["fused_sum"] += 1
    return out, xlog


def fused_pallas_raw(x, lw, lh, *, layout="cm", mxu_bf16=False):
    """The fused X pass: ``(swn (B, np, rp), shn (B, rp, mp), xlog (B,)
    float64)``.  E1 + E1s on CUDA tensors, :func:`fused_xpass_plain` on
    CPU tensors.  ``layout`` picks E1's loop order ('gm' keeps a gene
    chunk's swn on chip and is the JAX driver's choice for large gene
    panels, 'cm' the dual); both give the same values.  ``mxu_bf16``
    (``precision='bf16'``) rounds the products' operands to bf16."""
    _check(x, lw, lh, layout)
    if x.device.type == "cpu":
        return fused_xpass_plain(x, lw, lh, mxu_bf16)
    full, part, xlog_part = fused_xpass(x, lw, lh, layout=layout,
                                        mxu_bf16=mxu_bf16)
    other, xlog = fused_sum(part, xlog_part)
    if layout == "gm":
        return full, other, xlog
    return other, full, xlog
