"""The sparse capacity passes as hand-written CUDA, with their plain
PyTorch versions.

Counterpart of the Pallas kernel ``ccfindr_tpu/ops/tile.py:348
_tile_kernel``, in ``csrc/sparse.cu``: S1 ``sp_rowpass`` walks the CSR
of a :class:`~ccfindr_tpu_torch.ops.tile.TileCounts` one gene row a
warp, a nonzero and its whole factor row a thread up to rank 32 (``wth``
and ``a = x/wth`` at each nonzero, ``swn``, ``a`` in CSR order,
per-block sums of ``x log wth`` that each lane's last block adds in
block order); S2 ``sp_colpass`` walks its CSC one cell a warp, a few
threads a nonzero, each a 16-byte slice of its ``lw`` row (``shn``
from S1's ``a``, read through ``perm``).
:func:`rowpass_plain` and :func:`colpass_plain` are the same functions
in plain PyTorch (the COO pass of :mod:`ccfindr_tpu_torch.ops.sparse`);
:func:`rowpass` and :func:`colpass` take them only for tensors on the
CPU and launch the kernels for CUDA tensors, with no fallback between
them.

Factors carry a leading lane axis B: ``lw (B, n, r)``, ``lht (B, m, r)``
(lh transposed, contiguous), float32 or float64, ``r <= 128``; ``a``
is ``(B, nnz)`` in the factor dtype.  ``mxu_bf16`` (``precision=
'bf16'``, the tile kernel's mode) rounds the factor rows each pass
gathers and ``a`` to bf16 (``csrc/bf16.cuh``), the sums staying in the
factor dtype, but at the nonzeros of the layout's ``tail`` (the JAX
layout's overflow tail, which its bf16 pass takes unrounded).
"""

from __future__ import annotations

import torch

from .. import sparse
from . import sol
from .build import TCODE, XCODE, launch, tickets

# gene rows (S1) or cells (S2) one block of csrc/sparse.cu owns
ROWS = 8
MAX_R = 128
VAL_DTYPES = (torch.int16, torch.float32, torch.float64)

# launches per kernel since the last reset (bumped only where a kernel
# is launched)
LAUNCHES = {"sp_rowpass": 0, "sp_colpass": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lane_groups(nb, nnz, itemsize):
    """The lane groups a VB pass runs S1 and S2 over: S1 stores ``a =
    x/wth`` at every nonzero of every lane for S2 to read, ``(B, nnz)``
    in the factor dtype, 1.12 GB a lane of float32 at the JAX package's
    oversize shape (279 M nonzeros), 42.4 GB for a scan of 38 lanes.
    ``ops.tile.fused_tile`` runs S1 then S2 on consecutive groups whose
    ``a`` takes at most ``sol.LANE_GROUP_BYTES`` (``sol.lane_groups``),
    so that one group's ``a`` lives at a time.  A block of either kernel
    is one lane's, so a lane's bits do not depend on its group."""
    return sol.lane_groups(nb, nnz * itemsize)


def _check_factor(tc, f, rows, name):
    if f.dtype not in TCODE:
        raise TypeError(f"factors must be float32 or float64, got {f.dtype}")
    if f.dim() != 3 or f.shape[1] != rows:
        raise ValueError(f"{name} must be (B, {rows}, r), got "
                         f"{tuple(f.shape)}")
    if not 0 < f.shape[2] <= MAX_R:
        raise ValueError(f"rank {f.shape[2]} must be in [1, {MAX_R}]")
    if not f.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if f.device != tc.device:
        raise ValueError(f"tensors on several devices: {f.device}, "
                         f"{tc.device}")


def _check_layout(tc):
    if tc.val.dtype not in VAL_DTYPES:
        raise TypeError(f"values must be int16, float32 or float64, got "
                        f"{tc.val.dtype}")
    for name, dt, size in (("indptr", torch.int64, tc.n + 1),
                           ("col", torch.int32, tc.nnz),
                           ("colptr", torch.int64, tc.m + 1),
                           ("row", torch.int32, tc.nnz),
                           ("perm", torch.int32, tc.nnz),
                           ("tail", torch.uint8, tc.nnz)):
        t = getattr(tc, name)
        if t is None and name == "tail":
            continue
        if (t.dtype != dt or t.shape != (size,) or not t.is_contiguous()
                or t.device != tc.device):
            raise ValueError(f"layout field {name} must be a contiguous "
                             f"({size},) {dt} on {tc.device}")


def _check_rowpass(tc, lw, lht):
    _check_layout(tc)
    _check_factor(tc, lw, tc.n, "lw")
    _check_factor(tc, lht, tc.m, "lht")
    if lht.shape[0] != lw.shape[0] or lht.shape[2] != lw.shape[2] \
            or lht.dtype != lw.dtype:
        raise ValueError(f"lw {tuple(lw.shape)} {lw.dtype} and lht "
                         f"{tuple(lht.shape)} {lht.dtype} do not match")


def _check_colpass(tc, a, lw):
    _check_layout(tc)
    _check_factor(tc, lw, tc.n, "lw")
    if a.shape != (lw.shape[0], tc.nnz) or a.dtype != lw.dtype \
            or not a.is_contiguous() or a.device != tc.device:
        raise ValueError(f"a must be a contiguous (B, nnz) = "
                         f"({lw.shape[0]}, {tc.nnz}) {lw.dtype} tensor")


def _flags(do_elbo, nb, dev):
    """The per-lane ELBO flags as S1 takes them: (B,) float64."""
    if do_elbo is None:
        return torch.ones(nb, dtype=torch.float64, device=dev)
    return torch.as_tensor(do_elbo, device=dev).to(
        torch.float64).expand(nb).contiguous()


# ---------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------

def rowpass_plain(tc, lw, lht, do_elbo=None, want_swn=True, want_a=True,
                  want_xlog=True, mxu_bf16=False):
    """S1's function: ``(swn (B, n, r), a (B, nnz), xlog (B,)
    float64)``, None where not wanted."""
    swn, _, a, xlog = sparse.coo_pass(
        tc.csr_rows(), tc.col, tc.val, lw, lht, m=tc.m, want_swn=want_swn,
        want_shn=False, want_a=want_a, want_xlog=want_xlog, do_elbo=do_elbo,
        mxu_bf16=mxu_bf16, tail=tc.tail)
    return swn, a, xlog


def colpass_plain(tc, a, lw, mxu_bf16=False):
    """S2's function: ``shn (B, r, m)``."""
    return sparse.coo_colpass(tc.csr_rows(), tc.col, a, lw, tc.m,
                              mxu_bf16, tc.tail).transpose(-1, -2)


# ---------------------------------------------------------------------
# CUDA wrappers (one per kernel)
# ---------------------------------------------------------------------

def sp_rowpass(tc, lw, lht, do_elbo=None, want_swn=True, want_a=True,
               want_xlog=True, mxu_bf16=False):
    """Launch S1.  Returns ``(swn (B, n, r), a (B, nnz), xlog (B,)
    float64, xlog_part (B, ceil(n/8)) float64)``, None where not wanted:
    ``xlog`` is the sum of the per-block partials ``xlog_part``, added in
    block order by each lane's last block."""
    nb, n, r = lw.shape
    dev = lw.device
    swn = torch.empty_like(lw) if want_swn else None
    a = (torch.empty(nb, tc.nnz, dtype=lw.dtype, device=dev) if want_a
         else None)
    part, xlog = ((torch.empty(nb, -(-n // ROWS), dtype=torch.float64,
                               device=dev),
                   torch.empty(nb, dtype=torch.float64, device=dev))
                  if want_xlog else (None, None))
    flags = _flags(do_elbo, nb, dev)
    launch("sp_rowpass", TCODE[lw.dtype], XCODE[tc.val.dtype],
           int(bool(mxu_bf16)), tc.indptr, tc.col, tc.val,
           tc.tail if mxu_bf16 else None, lw, lht, flags,
           nb, n, tc.m, r, tc.nnz, swn, a, part,
           tickets(nb, dev) if want_xlog else None, xlog)
    LAUNCHES["sp_rowpass"] += 1
    return swn, a, xlog, part


def sp_colpass(tc, a, lw, mxu_bf16=False):
    """Launch S2: ``shn (B, r, m)``.  ``lw`` goes to the kernel 16-byte
    aligned (copied where it is not), so that its instantiation, and the
    order of each sum, depend on ``r`` and the dtype alone."""
    if lw.data_ptr() % 16:
        lw = lw.clone()
    nb, n, r = lw.shape
    shn = torch.empty(nb, r, tc.m, dtype=lw.dtype, device=lw.device)
    launch("sp_colpass", TCODE[lw.dtype], int(bool(mxu_bf16)), tc.colptr,
           tc.row, tc.perm, tc.tail if mxu_bf16 else None, a, lw, nb, n,
           tc.m, r, tc.nnz, shn)
    LAUNCHES["sp_colpass"] += 1
    return shn


def rowpass(tc, lw, lht, do_elbo=None, want_swn=True, want_a=True,
            want_xlog=True, mxu_bf16=False):
    """The row pass: ``(swn, a, xlog (B,) float64)`` — S1 on CUDA
    tensors, :func:`rowpass_plain` on CPU tensors."""
    _check_rowpass(tc, lw, lht)
    if tc.device.type == "cpu":
        return rowpass_plain(tc, lw, lht, do_elbo, want_swn, want_a,
                             want_xlog, mxu_bf16)
    return sp_rowpass(tc, lw, lht, do_elbo, want_swn, want_a, want_xlog,
                      mxu_bf16)[:3]


def colpass(tc, a, lw, mxu_bf16=False):
    """The column pass: ``shn (B, r, m)`` — S2 on CUDA tensors,
    :func:`colpass_plain` on CPU tensors."""
    _check_colpass(tc, a, lw)
    if tc.device.type == "cpu":
        return colpass_plain(tc, a, lw, mxu_bf16)
    return sp_colpass(tc, a, lw, mxu_bf16)
