"""The X passes of the VB sweep as hand-written CUDA, with their plain
PyTorch versions.

Counterpart of ``ccfindr_tpu/ops/pallas/vb_kernels.py``, under its
names, for a lane batch in the JAX package's layouts (``x (np, mp)``,
``lw (B, np, rp)``, ``lh (B, rp, mp)``):

* the fused X pass :func:`fused_pallas_raw` returns ``swn = (x/wth)
  lh^T``, ``shn = lw^T (x/wth)`` and ``xlog = sum x log wth`` with ``wth
  = lw lh`` (``swn`` like ``lw``, ``shn`` like ``lh``, ``xlog (B,)``
  float64).  On CUDA tensors it launches E1 ``fused_xpass``
  (``layout='gm'`` replaces ``_fused_gm_kernel``, ``'cm'``
  ``_fused_cm_kernel``) and E1s ``fused_sum`` of ``csrc/epi.cu``; on
  CPU tensors it takes :func:`fused_xpass_plain`.  No padding contract:
  rows of ``lw`` past the true gene count and columns of ``lh`` past the
  true cell count meet zero rows and columns of ``x``, and rank rows
  past ``r`` are zero.
* :func:`fused_pallas_padded`, :func:`fused_pallas` and
  :func:`make_fused_backend` wrap that pass as ``vb_run``'s fused
  function ``(swn, shn, dterm)`` (the factors padded to X's extents,
  the data term folded): the X pass of a gene-sharded or gene-major
  mesh (``parallel.sharded.make_fused_sharded``), each block of X in
  the layout ``_fused_layout`` picks for it;
* the two-pass backend (``backend='pallas2pass'``):
  :func:`suffstats_pallas` (``(sw, sh)``; P1 ``ss_xpass`` of
  ``csrc/pass2.cu``, E1's gene-major walk without the ``x log wth``
  sum, replaces ``_suffstats_kernel``, + E1s) and
  :func:`elbo_data_pallas` (the ELBO data term; P2 ``elbo_xpass``
  replaces ``_elbo_kernel``: a block a strip of :data:`P2_BAND` genes x
  :data:`P2_CHUNK` cells, its float products split-TF32 on the tensor
  cores; the strips' partials are added by each lane's last block),
  paired by
  :func:`make_pallas_backend` for ``ops.vb.vb_run``.  They take X
  zero-padded by :func:`pad_matrix` or not (the kernels read it in
  place); the true ``(n, m, r)`` come from the factors ``lw (B, n, r)``,
  ``lh (B, r, m)``.  Their plain versions are :func:`suffstats_plain`
  and :func:`elbo_data_plain`.

There is no fallback between a kernel and its plain version: the plain
version is taken only for CPU tensors.  ``DEFAULT_BN``/``DEFAULT_BM``
and :func:`_fused_layout` are the JAX package's, kept for the driver's
routing between the cell-major sweep (``ops/kernels/sol.py``) and the
gene-major one (``ops/kernels/epilogue.py``) and for
:func:`pad_matrix`; the kernels have no TPU tiles.
"""

from __future__ import annotations

import torch

from ..sparse import fold_dterm  # noqa: F401  (the JAX module's name)
from .build import TCODE, XCODE, launch, tickets
from .sol import DEFAULT_BM, DEFAULT_BN, MAX_RP, bf16_round

# E1's chunk of its outer axis starts here and doubles until the
# per-chunk partials take no more bytes than X (csrc/fused.cuh); the
# smaller the chunk, the more blocks share the card (at 100,000 x 4,096
# and 3 lanes of rank 16: 1,173 blocks of 256 genes, 4.4 waves of two
# blocks an SM, against 588 of 512)
CHUNK = 256
# P1 walks E1's gene-major order at any gene count: its chunk starts at
# one subtile (64 genes) and doubles while the grid (chunks x lanes)
# would pass this many blocks, a few an SM of the H100's 132, or the
# partials would take more bytes than X
PASS2_CHUNK = 64
PASS2_BLOCKS = 4 * 132
# P2's strip: a block owns P2_BAND genes x P2_CHUNK cells of one lane
# (csrc/pass2.cu kP2Band, kP2Chunk).  Constants, never derived from the
# lane count, so a lane's partials and its bits do not depend on its
# batch (resume, compaction)
P2_BAND = 64
P2_CHUNK = 1024

# launches per kernel since the last reset (bumped only where a kernel
# is launched)
LAUNCHES = {"fused_xpass_cm": 0, "fused_xpass_gm": 0, "fused_sum": 0,
            "ss_xpass": 0, "elbo_xpass": 0}


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


def fused_chunk(x, layout, nb, rp, itemsize):
    """E1's (and P1's) chunk of its outer axis (genes for 'gm', cells
    for 'cm') for ``nb`` lanes of rank ``rp`` in factors of ``itemsize``
    bytes: :data:`CHUNK`, doubled while the per-chunk partials would
    take more bytes than X.

    The chunk fixes the order in which a lane's partials are added, so
    a run that re-batches its lanes (the drivers' ``checkpoint_every``
    and ``compact_every``) computes it once, for the full batch, and
    pins it."""
    np_, mp_ = x.shape
    outer, inner = (np_, mp_) if layout == "gm" else (mp_, np_)
    xbytes = x.numel() * x.element_size()
    chunk = CHUNK
    while (chunk < outer and nb * -(-outer // chunk) * rp * inner
           * itemsize > xbytes):
        chunk *= 2
    return chunk


def fused_xpass(x, lw, lh, *, layout, mxu_bf16=False, chunk=None):
    """Launch E1.  Returns ``(full, part, xlog_part)``: for 'gm' ``swn
    (B, np, rp)``, the shn partials ``(B, ngc, rp, mp)``; for 'cm'
    ``shn (B, rp, mp)``, the swn partials ``(B, ncc, np, rp)``; and the
    per-chunk ``sum x log wth`` ``(B, nchunk)`` float64.  ``chunk``
    (default :func:`fused_chunk` of this batch) pins the chunk."""
    np_, mp_ = x.shape
    nb, _, rp_ = lw.shape
    if chunk is None:
        chunk = fused_chunk(x, layout, nb, rp_, lw.element_size())
    gm = layout == "gm"
    nchunk = -(-(np_ if gm else mp_) // chunk)
    full = torch.empty(*((nb, np_, rp_) if gm else (nb, rp_, mp_)),
                       dtype=lw.dtype, device=x.device)
    part = torch.empty(*((nb, nchunk, rp_, mp_) if gm
                         else (nb, nchunk, np_, rp_)),
                       dtype=lw.dtype, device=x.device)
    xlog_part = torch.empty(nb, nchunk, dtype=torch.float64,
                            device=x.device)
    launch("fused_xpass", TCODE[lw.dtype], XCODE[x.dtype], int(gm),
           int(bool(mxu_bf16)), x, lw, lh, nb, np_, mp_, rp_, chunk, full,
           part, xlog_part)
    LAUNCHES[f"fused_xpass_{layout}"] += 1
    return full, part, xlog_part


def fused_sum(part, xlog_part):
    """Launch E1s: ``(part.sum(1) in the factor dtype, xlog_part.sum(1))``,
    each summed in float64 in chunk order."""
    nb, nchunk = part.shape[:2]
    out = torch.empty(nb, *part.shape[2:], dtype=part.dtype,
                      device=part.device)
    xlog = torch.empty(nb, dtype=torch.float64, device=part.device)
    launch("fused_sum", TCODE[part.dtype], part, nchunk, out[0].numel(),
           xlog_part, xlog_part.shape[1], nb, out, xlog)
    LAUNCHES["fused_sum"] += 1
    return out, xlog


def fused_pallas_raw(x_pad, lw_p, lh_p, *, bn=DEFAULT_BN, bm=DEFAULT_BM,
                     layout="cm", mxu_bf16=False, chunk=None):
    """The fused X pass: ``(swn (B, np, rp), shn (B, rp, mp), xlog (B,)
    float64)``.  E1 + E1s on CUDA tensors, :func:`fused_xpass_plain` on
    CPU tensors.  ``layout`` picks E1's loop order ('gm' keeps a gene
    chunk's swn on chip and is the JAX driver's choice for large gene
    panels, 'cm' the dual); both give the same values.  ``mxu_bf16``
    (``precision='bf16'``) rounds the products' operands to bf16; the
    JAX tiles ``bn``/``bm`` are accepted and unused; ``chunk``, the
    port's own keyword, pins E1's chunk (:func:`fused_chunk`)."""
    x, lw, lh = x_pad, lw_p, lh_p
    _check(x, lw, lh, layout)
    if x.device.type == "cpu":
        return fused_xpass_plain(x, lw, lh, mxu_bf16)
    full, part, xlog_part = fused_xpass(x, lw, lh, layout=layout,
                                        mxu_bf16=mxu_bf16, chunk=chunk)
    other, xlog = fused_sum(part, xlog_part)
    if layout == "gm":
        return full, other, xlog
    return other, full, xlog


def _pad_factors(lw, lh, np_, mp_, rp_):
    """The JAX function's padding of a lane batch: W rows -> 1, ranks ->
    0; H ranks -> 0, columns -> 1 (a padded row or column of X is 0 and
    meets a positive ``wth``)."""
    n, r = lw.shape[-2:]
    m = lh.shape[-1]
    pad = torch.nn.functional.pad
    lw_p = pad(pad(lw, (0, 0, 0, np_ - n), value=1.0), (0, rp_ - r))
    lh_p = pad(pad(lh, (0, mp_ - m), value=1.0), (0, 0, 0, rp_ - r))
    return lw_p.contiguous(), lh_p.contiguous()


def fused_pallas_padded(x_pad, lw, lh, *, n, m, r, bn, bm, layout=None,
                        mxu_bf16=False, chunk=None):
    """The fused X pass for ``vb_run(fused=...)``: ``(swn (B, n, r), shn
    (B, r, m), dterm (B,))``, the numerators (sw = lw*swn, sh = lh*shn)
    and the ELBO data term of the same (lw, lh), folded by
    :func:`fold_dterm` in JAX's order.  E1 + E1s on CUDA tensors
    (:func:`fused_pallas_raw`), its plain version on CPU tensors.

    ``x_pad`` is read in place whatever its padding; the factors ``lw
    (B, n, r)``, ``lh (B, r, m)`` (or JAX's unbatched ``(n, r)``, ``(r,
    m)``) are padded to its extents and to ``rp = round_up(max(r, 8),
    8)`` ranks.  ``layout`` (default: :func:`_fused_layout` on the
    extents padded to the JAX tiles ``bn``/``bm``, as the JAX function
    picks it on its padded X) is E1's loop order; ``chunk``, the port's
    own keyword, pins E1's chunk (default :func:`fused_chunk` of this
    batch)."""
    one = lw.dim() == 2
    if one:
        lw, lh = lw[None], lh[None]
    if (lw.shape[-2], lh.shape[-1], lw.shape[-1]) != (n, m, r):
        raise ValueError(f"(n, m, r) = {(n, m, r)} are not the factors' "
                         f"extents")
    np_, mp_ = x_pad.shape
    rp_ = -(-max(r, 8) // 8) * 8
    if layout is None:
        layout = _fused_layout(-(-np_ // bn) * bn, -(-mp_ // bm) * bm, rp_)
    lw_p, lh_p = _pad_factors(lw, lh, np_, mp_, rp_)
    swn_p, shn_p, xlog = fused_pallas_raw(x_pad, lw_p, lh_p, layout=layout,
                                          mxu_bf16=mxu_bf16, chunk=chunk)
    swn = swn_p[..., :n, :r]
    shn = shn_p[..., :r, :m]
    dterm = fold_dterm(swn, shn, lw, lh, xlog)
    return (swn[0], shn[0], dterm[0]) if one else (swn, shn, dterm)


def fused_pallas(x, lw, lh, bn: int = DEFAULT_BN, bm: int = DEFAULT_BM,
                 layout=None, mxu_bf16=False, *, chunk=None):
    """Single-pass fused backend for ``ops.vb.vb_run(fused=...)``:
    ``(swn, shn, dterm)`` for the SAME (lw, lh), reading X once.  The
    JAX function pads X to its tiles every call; E1 has no tiles and
    reads X in place, so nothing is copied (:func:`fused_pallas_padded`
    takes the layout decision on the extents the tiles would give).
    ``mxu_bf16`` rounds the products' operands to bf16
    (``precision='bf16'``, also on the mesh path through
    ``parallel.sharded.make_fused_sharded``)."""
    n, r = lw.shape[-2:]
    m = lh.shape[-1]
    return fused_pallas_padded(x, lw, lh, n=n, m=m, r=r, bn=bn, bm=bm,
                               layout=layout, mxu_bf16=mxu_bf16,
                               chunk=chunk)


def make_fused_backend(bn: int = DEFAULT_BN, bm: int = DEFAULT_BM):
    """Fused function for ``vb_run``'s single-pass path over
    :func:`fused_pallas`."""
    def fused(x, lw, lh):
        return fused_pallas(x, lw, lh, bn=bn, bm=bm)

    return fused


# ---------------------------------------------------------------------
# The two-pass backend (backend='pallas2pass')
# ---------------------------------------------------------------------

def pad_matrix(x, bn: int = DEFAULT_BN, bm: int = DEFAULT_BM):
    """Zero-pad a count matrix to multiples of (bn, bm), once a
    factorization (the JAX function's padding; zeros add nothing to any
    output, and the kernels read X in place whatever its padding)."""
    n, m = x.shape
    np_, mp_ = -(-n // bn) * bn, -(-m // bm) * bm
    if (np_, mp_) == (n, m):
        return x
    return torch.nn.functional.pad(x, (0, mp_ - m, 0, np_ - n))


def _check_pass2(x, lw, lh):
    if lw.dtype not in TCODE or lh.dtype != lw.dtype:
        raise TypeError(f"lw and lh must share float32 or float64, got "
                        f"{lw.dtype} and {lh.dtype}")
    if x.dtype not in XCODE:
        raise TypeError(f"X must be int8, int16, float32 or float64, "
                        f"got {x.dtype}")
    if x.dim() != 2 or lw.dim() != 3 or lh.dim() != 3:
        raise ValueError("X must be (np, mp), lw (B, n, r), lh (B, r, m)")
    nb, n, r = lw.shape
    m = lh.shape[-1]
    if lh.shape != (nb, r, m) or x.shape[0] < n or x.shape[1] < m:
        raise ValueError(f"shape mismatch: X {tuple(x.shape)}, lw "
                         f"{tuple(lw.shape)}, lh {tuple(lh.shape)}")
    if not 0 < r <= MAX_RP:
        raise ValueError(f"rank {r} must be in [1, {MAX_RP}]")
    if len({x.device, lw.device, lh.device}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{ {x.device, lw.device, lh.device} }")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def suffstats_plain(x, lw, lh):
    """P1 + E1s's function: ``(swn (B, n, r), shn (B, r, m))`` =
    ``((x/wth) lh^T, lw^T (x/wth))``, ``wth = lw lh``, over ``x[:n,
    :m]``."""
    n, m = lw.shape[-2], lh.shape[-1]
    xf = x[:n, :m].to(lw.dtype)
    u = xf / (lw @ lh)
    return u @ lh.transpose(-1, -2), lw.transpose(-1, -2) @ u


def xlogx(t):
    """``t log t``, 0 where ``t`` is 0 (the JAX wrapper's guard)."""
    pos = t > 0
    return torch.where(pos, t * torch.log(torch.where(pos, t, 1.0)), 0.0)


def elbo_data_plain(x, lw, lh):
    """P2's function, in ``_elbo_kernel``'s unfolded form: ``-sum
    x (S/wth - log wth)`` over ``x[:n, :m]`` with ``S = (lw log lw) lh +
    lw (lh log lh)``, each term in the factor dtype, summed in float64:
    (B,) float64."""
    n, m = lw.shape[-2], lh.shape[-1]
    xf = x[:n, :m].to(lw.dtype)
    wth = lw @ lh
    s = xlogx(lw) @ lh + lw @ xlogx(lh)
    t = xf * (s / wth - torch.log(wth))
    return -t.sum((-2, -1), dtype=torch.float64)


def pass2_chunk(x, n, m, nb, r, itemsize):
    """P1's gene chunk for ``nb`` lanes of rank ``r`` over the true
    ``(n, m)`` of ``x``: :data:`PASS2_CHUNK`, doubled while the grid
    would pass :data:`PASS2_BLOCKS` blocks or the shn partials would take
    more bytes than X.  It fixes the order in which a lane's partials
    are added, so the driver pins the full batch's (as
    :func:`fused_chunk`'s)."""
    xbytes = x.numel() * x.element_size()
    chunk = PASS2_CHUNK
    while chunk < n and (nb * -(-n // chunk) > PASS2_BLOCKS
                         or nb * -(-n // chunk) * r * m * itemsize > xbytes):
        chunk *= 2
    return chunk


def ss_xpass(x, lw, lh, *, chunk=None):
    """Launch P1 on ``x`` read in place (row stride ``x.shape[1]``).
    Returns ``(swn (B, n, r), shn_part (B, ngc, r, m))``, the shn
    partials of ``ngc`` gene chunks; ``chunk`` (default
    :func:`pass2_chunk` of this batch) pins the chunk."""
    nb, n, r = lw.shape
    m = lh.shape[-1]
    if chunk is None:
        chunk = pass2_chunk(x, n, m, nb, r, lw.element_size())
    swn = torch.empty_like(lw)
    part = torch.empty(nb, -(-n // chunk), r, m, dtype=lw.dtype,
                       device=x.device)
    launch("ss_xpass", TCODE[lw.dtype], XCODE[x.dtype], x, x.shape[1], lw,
           lh, nb, n, m, r, chunk, swn, part)
    LAUNCHES["ss_xpass"] += 1
    return swn, part


def elbo_part_width(n, m):
    """P2's partials a lane over the true ``(n, m)``: one a strip,
    ``ceil(n / P2_BAND) * ceil(m / P2_CHUNK)``, whatever the lane
    count."""
    return -(-n // P2_BAND) * -(-m // P2_CHUNK)


def elbo_xpass(x, lw, lwl, lh, lhl):
    """Launch P2 on ``x`` read in place: ``-sum x (S/wth - log wth)``
    (B,) float64, and the per-strip partials ``(B, elbo_part_width(n,
    m))`` float64 that it adds in strip order (gene band major);
    ``lwl``/``lhl`` are :func:`xlogx` of ``lw``/``lh``."""
    nb, n, r = lw.shape
    m = lh.shape[-1]
    part = torch.empty(nb, elbo_part_width(n, m), dtype=torch.float64,
                       device=x.device)
    out = torch.empty(nb, dtype=torch.float64, device=x.device)
    launch("elbo_xpass", TCODE[lw.dtype], XCODE[x.dtype], x, x.shape[1], lw,
           lwl, lh, lhl, nb, n, m, r, part, tickets(nb, x.device), out)
    LAUNCHES["elbo_xpass"] += 1
    return out, part


def suffstats_pallas_padded(x_pad, lw, lh, *, n, m, r, bn, bm, chunk=None):
    """The numerators ``(swn (B, n, r), shn (B, r, m))``: P1 + E1s on
    CUDA tensors, :func:`suffstats_plain` on CPU tensors.  ``(n, m, r)``
    must be the factors' extents; ``bn``/``bm`` (the JAX tiles, required
    as in JAX) are accepted and not used; ``chunk``, the port's own
    keyword, pins P1's gene chunk (:func:`pass2_chunk`)."""
    lw, lh = lw.contiguous(), lh.contiguous()
    _check_pass2(x_pad, lw, lh)
    if (lw.shape[-2], lh.shape[-1], lw.shape[-1]) != (n, m, r):
        raise ValueError(f"(n, m, r) = {(n, m, r)} are not the factors' "
                         f"extents")
    if x_pad.device.type == "cpu":
        return suffstats_plain(x_pad, lw, lh)
    swn, part = ss_xpass(x_pad, lw, lh, chunk=chunk)
    empty = torch.zeros(lw.shape[0], 0, dtype=torch.float64,
                        device=x_pad.device)
    return swn, fused_sum(part, empty)[0]


def suffstats_pallas(x, lw, lh, bn: int = DEFAULT_BN, bm: int = DEFAULT_BM,
                     *, chunk=None):
    """Drop-in for ``ops.vb.suffstats_dense``: ``(sw, sh) = (lw * swn,
    lh * shn)``.  ``x`` may be pre-padded (:func:`pad_matrix`); the true
    shapes come from ``lw (B, n, r)``/``lh (B, r, m)``."""
    nb, n, r = lw.shape
    m = lh.shape[-1]
    swn, shn = suffstats_pallas_padded(pad_matrix(x, bn, bm), lw, lh, n=n,
                                       m=m, r=r, bn=bn, bm=bm, chunk=chunk)
    return lw * swn, lh * shn


def elbo_data_pallas_padded(x_pad, lw, lh, *, n, m, r, bn, bm):
    """The ELBO data term (B,) in the factor dtype: P2 on CUDA
    tensors, :func:`elbo_data_plain` on CPU tensors.  ``bn``/``bm`` (the
    JAX tiles, required as in JAX) are accepted and not used."""
    lw, lh = lw.contiguous(), lh.contiguous()
    _check_pass2(x_pad, lw, lh)
    if (lw.shape[-2], lh.shape[-1], lw.shape[-1]) != (n, m, r):
        raise ValueError(f"(n, m, r) = {(n, m, r)} are not the factors' "
                         f"extents")
    if x_pad.device.type == "cpu":
        return elbo_data_plain(x_pad, lw, lh).to(lw.dtype)
    return elbo_xpass(x_pad, lw, xlogx(lw), lh, xlogx(lh))[0].to(lw.dtype)


def elbo_data_pallas(x, lw, lh, bn: int = DEFAULT_BN, bm: int = DEFAULT_BM):
    """Drop-in for ``ops.vb.elbo_data_term``."""
    nb, n, r = lw.shape
    m = lh.shape[-1]
    return elbo_data_pallas_padded(pad_matrix(x, bn, bm), lw, lh, n=n, m=m,
                                   r=r, bn=bn, bm=bm)


def make_pallas_backend(bn: int = DEFAULT_BN, bm: int = DEFAULT_BM, *,
                        chunk=None):
    """``(suffstats, data_term)`` for ``ops.vb.vb_run`` over a
    :func:`pad_matrix`-padded X: ``vb_factorize(backend='pallas2pass')``.
    ``chunk`` pins P1's gene chunk (:func:`pass2_chunk`)."""
    def suffstats(x, lw, lh):
        return suffstats_pallas(x, lw, lh, bn, bm, chunk=chunk)

    def data_term(x, lw, lh):
        return elbo_data_pallas(x, lw, lh, bn, bm)

    return suffstats, data_term
