"""The JAX package's ELL layout and passes, over the port's CSR kernels.

Counterpart of ``ccfindr_tpu.ops.ell``, under its names.  The JAX
package stored the nonzeros twice, as fixed-width slots by gene and by
cell plus small COO overflow tails, because the TPU runs XLA scatters
one at a time: its passes are gathers and slot-axis reductions.  The
card has no such limit, and the port already has a gather-only pair of
passes over both orders of the nonzeros: S1 over the CSR and S2 over
its CSC permutation (``csrc/sparse.cu``, :mod:`ccfindr_tpu_torch.ops.tile`).

So :class:`EllCounts` keeps JAX's fields (the slots and the tails, which
the builders lay out as JAX does) and builds once, in its constructor,
a :class:`~ccfindr_tpu_torch.ops.tile.TileCounts` view of the same
nonzeros (:attr:`EllCounts.csr`), on their device by sorts and searches.
The passes are :func:`ccfindr_tpu_torch.ops.tile.fused_tile`,
``tile_ml_h`` and ``tile_ml_w`` over that view: S1/S2 on the card,
their plain versions on CPU tensors.  The view keeps the entries with
``val > 0`` (JAX's passes mask with ``gv > 0``) and stores their values
by ``ops.tile``'s rule, so an ELL pass launches the instances of S1/S2
that ``from_scipy_tile``'s layout launches and gives its bits.
``vb_factorize``/``factorize(sparse_layout='ell')`` build the CSR layout
at once, as ``'coo'`` does.

Factors carry a leading lane axis (``lw (B, n, r)``, ``lh (B, r, m)``);
JAX's unbatched ``(n, r)``/``(r, m)`` are taken too.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import resolve_device
from .sparse import Shards, _batched, _np_dtype, _sorted_csr
from .tile import _csc_order, _values, fused_tile, tile_ml_h, tile_ml_w

_FIELDS = ("gcol", "gval", "crow", "cval", "gtrow", "gtcol", "gtval",
           "ctrow", "ctcol", "ctval")


class EllCounts:
    """Dual hybrid ELL+COO count matrix, the JAX package's layout.

    ``gcol``/``gval`` ``(n_pad, Kg)``: by-gene slots, padded rows to
    ``n_pad`` and slots with ``(col=m, val=0)``; ``crow``/``cval``
    ``(m_pad, Kc)``: by-cell slots, padded with ``(row=n, val=0)``;
    ``gtrow, gtcol, gtval`` and ``ctrow, ctcol, ctval``: the flat COO
    overflow tails (possibly of length 0) of the entries past the
    widths; ``n``, ``m`` the extents, ``bn``, ``bm`` JAX's scan blocks
    (kept, not used).

    :attr:`csr` is the same nonzeros (those with ``val > 0``) as a
    :class:`~ccfindr_tpu_torch.ops.tile.TileCounts`, built once here
    from the by-gene slots and tail, over which the passes run."""

    def __init__(self, gcol, gval, crow, cval, gtrow, gtcol, gtval, ctrow,
                 ctcol, ctval, n, m, bn, bm):
        self.gcol, self.gval, self.crow, self.cval = gcol, gval, crow, cval
        self.gtrow, self.gtcol, self.gtval = gtrow, gtcol, gtval
        self.ctrow, self.ctcol, self.ctval = ctrow, ctcol, ctval
        self.n, self.m, self.bn, self.bm = int(n), int(m), int(bn), int(bm)
        self.csr, self._neg = _ell_view(self)

    @property
    def device(self):
        return self.gval.device

    @property
    def val(self):
        """Every nonzero value once: the view's (in CSR order, stored
        by ``ops.tile``'s rule), then any negative entries, which the
        passes skip.  The hoisted ``sum lgamma(x + 1)`` of ``ops.vb`` and
        the ML constant read it; JAX's ``val`` holds the slots' zero
        padding too, whose ``lgamma(1)`` adds 0."""
        if self._neg.numel() == 0:
            return self.csr.val
        return torch.cat([self.csr.val.to(self._neg.dtype), self._neg])

    def to(self, device):
        """The same layout on ``device`` (the view moved, not rebuilt)."""
        out = copy.copy(self)
        for f in _FIELDS:
            setattr(out, f, getattr(self, f).to(device))
        out.csr, out._neg = self.csr.to(device), self._neg.to(device)
        return out


def _ell_view(ec):
    """``(TileCounts, negative values)`` of an EllCounts: the by-gene
    slots' and tail's entries with ``val > 0``, sorted into CSR order on
    their device (within a row the slots hold the first nonzeros and the
    tail the rest, columns ascending; padding holds ``val = 0``)."""
    n_pad, kg = ec.gcol.shape
    rows = torch.arange(n_pad, device=ec.gval.device)[:, None].expand(
        n_pad, kg)
    r = torch.cat([rows.reshape(-1), ec.gtrow.long()])
    c = torch.cat([ec.gcol.reshape(-1), ec.gtcol]).long()
    v = torch.cat([ec.gval.reshape(-1), ec.gtval])
    pos = v > 0
    view = _sorted_csr(r[pos], c[pos], v[pos], ec.n, ec.m)
    if not view.nnz or bool(((view.val <= np.iinfo(np.int16).max)
                             & (view.val == view.val.round())).all()):
        view.val = view.val.to(torch.int16)
    return view, v[v < 0]


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _width(counts, quantile, lane=128):
    if len(counts) == 0:
        return lane
    w = int(np.quantile(counts, quantile)) if quantile < 1.0 \
        else int(counts.max())
    return max(lane, _round_up(w, lane))


def _block(rows_total, width, r_max=64, budget=1 << 25):
    """JAX's row-block size for its scan (kept as a field)."""
    b = max(8, budget // max(1, width * r_max * 4))
    b = 1 << int(np.floor(np.log2(b)))
    return int(min(b, _round_up(rows_total, 8)))


def _clean_csr(mat):
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    return csr


def from_scipy_ell(mat, dtype=torch.float32, quantile: float = 0.98,
                   lane: int = 128, device="cuda") -> EllCounts:
    """The dual hybrid ELL+COO layout of a scipy sparse (or dense)
    matrix, JAX's arrays exactly, on ``device`` (the card unless the
    caller asks for the CPU), with its CSR view.  ``lane`` floors and
    rounds the ELL widths (tests shrink it to exercise the tails).  The
    slots are filled on ``device`` (:func:`_ell_fields`)."""
    device = resolve_device(device)
    csr = _clean_csr(mat)
    n, m = csr.shape
    kg = _width(np.diff(csr.indptr), quantile, lane)
    kc = _width(np.bincount(csr.indices, minlength=m), quantile, lane)
    bn = _block(n, kg)
    bm = _block(m, kc)
    return EllCounts(**_ell_fields(csr, kg, kc, _round_up(n, bn),
                                   _round_up(m, bm), dtype, device),
                     n=n, m=m, bn=bn, bm=bm)


def _ell_fields(csr, kg, kc, n_pad, m_pad, dtype, device):
    """EllCounts' arrays of a cleaned CSR, built on ``device`` from its
    three arrays: the slot fill is one scatter a side, and the by-cell
    side takes the CSC order of ``ops.tile``'s layout (a stable sort of
    the columns).  At the oversize configuration's 279 M nonzeros a host
    build took ~54 s on the card's host."""
    n, m = csr.shape
    indptr = torch.as_tensor(csr.indptr.astype(np.int64), device=device)
    col = torch.as_tensor(csr.indices.astype(np.int32), device=device)
    data = torch.as_tensor(csr.data, device=device).to(dtype)
    gcol, gval, gtrow, gtcol, gtval = _ell_of(indptr, col, data, kg, m,
                                              n_pad)
    colptr, row, perm = _csc_order(indptr, col, n, m)
    del col
    crow, cval, ctcol, ctrow, ctval = _ell_of(
        colptr, row, data[perm.long()], kc, n, m_pad)
    return dict(gcol=gcol, gval=gval, crow=crow, cval=cval, gtrow=gtrow,
                gtcol=gtcol, gtval=gtval, ctrow=ctrow, ctcol=ctcol,
                ctval=ctval)


def _ell_of(indptr, indices, data, width, dummy_idx, rows_pad):
    """Rows (CSR/CSC) -> fixed-width ELL slots + overflow COO tail, on
    the device of the tensors.

    Returns (idx (rows_pad, width) int32, val (rows_pad, width),
    tail_row, tail_idx, tail_val) with tail_* flat tensors for entries
    beyond ``width``; the slots past the rows and their ends hold
    ``dummy_idx`` and 0.
    """
    dev = indices.device
    nrows = indptr.numel() - 1
    counts = indptr.diff()
    rows = torch.repeat_interleave(
        torch.arange(nrows, dtype=torch.int64, device=dev), counts)
    pos = torch.arange(indices.numel(), dtype=torch.int64, device=dev)
    pos -= indptr[:-1].repeat_interleave(counts)
    main = pos < width
    flat = (rows * width + pos)[main]
    idx = torch.full((rows_pad, width), dummy_idx, dtype=torch.int32,
                     device=dev)
    val = torch.zeros((rows_pad, width), dtype=data.dtype, device=dev)
    idx.view(-1)[flat] = indices[main].to(torch.int32)
    val.view(-1)[flat] = data[main]
    del flat, pos
    tail = ~main
    return (idx, val, rows[tail].to(torch.int32),
            indices[tail].to(torch.int32), data[tail])


def from_dense_ell(x, dtype=torch.float32, quantile: float = 0.98,
                   device="cuda") -> EllCounts:
    import scipy.sparse as sp

    return from_scipy_ell(sp.csr_matrix(np.asarray(x)), dtype=dtype,
                          quantile=quantile, device=device)


def from_scipy_ell_sharded(mat, n_shards: int, m_pad: int | None = None,
                           dtype=torch.float32, quantile: float = 0.98,
                           lane: int = 128, device="cuda") -> Shards:
    """Cell-sharded dual ELL: :class:`~ccfindr_tpu_torch.ops.sparse.Shards`
    of ``n_shards`` :class:`EllCounts`, shard ``s`` holding the cells
    ``[s m_loc, (s+1) m_loc)`` with LOCAL cell indices and ``m = m_loc
    = m_pad // n_shards``.

    Widths, blocks and tail lengths are global, so that every shard has
    JAX's shapes, and the tails are padded with the discard coordinates
    ``(n, m_loc, 0)`` (JAX stacks the shards on a leading axis; the port
    keeps one layout a shard).  The shards' views store one value type,
    chosen on the whole matrix; ``Shards.val`` is the one-device
    layout's ``val``, on the host.  All shards lie on ``device``
    (``Shards.to`` spreads them over a mesh)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    csr = _clean_csr(mat)
    csc = csr.tocsc()
    n, m = csc.shape
    if m_pad is None:
        m_pad = -(-m // n_shards) * n_shards
    if m_pad % n_shards != 0:
        raise ValueError(f"m_pad={m_pad} not divisible by {n_shards}")
    m_loc = m_pad // n_shards
    np_dtype = _np_dtype(dtype)

    blocks = []
    for s in range(n_shards):
        j0, j1 = s * m_loc, min((s + 1) * m_loc, m)
        blocks.append(sp.csr_matrix(csc[:, j0:max(j1, j0)]))

    # global static widths: per-(gene, shard) and per-cell nnz counts
    kg = _width(np.concatenate(
        [np.diff(b.indptr) for b in blocks]), quantile, lane)
    kc = _width(np.diff(csc.indptr), quantile, lane)
    bn = _block(n, kg)
    bm = _block(m_loc, kc)
    n_pad, m_loc_pad = _round_up(n, bn), _round_up(m_loc, bm)

    parts = []
    for b in blocks:
        if b.shape[1] < m_loc:
            b.resize(n, m_loc)     # the padded cells: empty columns
        parts.append(_ell_fields(b, kg, kc, n_pad, m_loc_pad, dtype,
                                 device))

    # tails pad to the max length with discard-slot coordinates
    # (idx_out = n or m_loc, val = 0 — contributes exactly nothing)
    tg = max(p["gtrow"].numel() for p in parts)
    tc = max(p["ctrow"].numel() for p in parts)

    def _pad(f, idx_out, idx_in, val, t, out_dummy, in_dummy):
        pad = t - f[idx_out].numel()
        f[idx_out] = torch.cat([f[idx_out], f[idx_out].new_full(
            (pad,), out_dummy)])
        f[idx_in] = torch.cat([f[idx_in], f[idx_in].new_full(
            (pad,), in_dummy)])
        f[val] = torch.cat([f[val], f[val].new_zeros(pad)])

    # the one-device layout's values: the positive ones in CSR order by
    # ops.tile's rule, then the negative ones
    data = csr.data.astype(np_dtype)
    vals = _values(data[data > 0], dtype)
    whole = np.concatenate([vals.astype(np_dtype), data[data < 0]]) \
        if (data < 0).any() else vals
    shards = []
    for f in parts:
        _pad(f, "gtrow", "gtcol", "gtval", tg, n, m_loc)
        # by-cell tail: idx_out = cell (ctcol), idx_in = gene (ctrow)
        _pad(f, "ctcol", "ctrow", "ctval", tc, m_loc, n)
        ec = EllCounts(**f, n=n, m=m_loc, bn=bn, bm=bm)
        ec.csr.val = ec.csr.val.to(torch.from_numpy(vals).dtype)
        shards.append(ec)
    return Shards(shards, n, m_loc, torch.as_tensor(whole))


def fused_ell(ec: EllCounts, lw, lh):
    """Single-pass fused backend over the layout: ``(swn, shn, dterm)``
    as ``ops.vb.fused_dense`` returns them, with sw = lw*swn, sh =
    lh*shn: :func:`ccfindr_tpu_torch.ops.tile.fused_tile` over
    :attr:`EllCounts.csr` (S1/S2 on the card)."""
    lw, lh, one = _batched(lw, lh)
    swn, shn, dterm = fused_tile(ec.csr, lw.contiguous(), lh)
    return (swn[0], shn[0], dterm[0]) if one else (swn, shn, dterm)


def make_ell_fused():
    """Fused function for ``vb_run(fused=...)`` over an EllCounts."""
    def fused(x, lw, lh):
        return fused_ell(x, lw, lh)

    return fused


def ell_ml_h(ec: EllCounts, w, h):
    """ML H phase over the nonzeros: ``(hn, xlogwh)`` with hn = w^T
    (x/wh) and xlogwh = sum x log(wh) (the contract of
    ``ops.ml.ml_run(fused_h=...)``): ``ops.tile.tile_ml_h`` over
    :attr:`EllCounts.csr` (S1 + S2)."""
    w, h, one = _batched(w, h)
    hn, xlog = tile_ml_h(ec.csr, w.contiguous(), h)
    return (hn[0], xlog[0]) if one else (hn, xlog)


def ell_ml_w(ec: EllCounts, w, h):
    """ML W phase: wn = (x/wh) h^T for the updated h:
    ``ops.tile.tile_ml_w`` over :attr:`EllCounts.csr` (S1)."""
    w, h, one = _batched(w, h)
    wn = tile_ml_w(ec.csr, w.contiguous(), h)
    return wn[0] if one else wn


def make_ell_ml_backend():
    """(fused_h, fused_w) pair for ``ops.ml.ml_run`` over an EllCounts."""
    def fused_h(x, w, h):
        return ell_ml_h(x, w, h)

    def fused_w(x, w, h):
        return ell_ml_w(x, w, h)

    return fused_h, fused_w
