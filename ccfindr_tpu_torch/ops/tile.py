"""The sparse backend's layout and phases: CSR on the card, the CUDA
kernels S1/S2 over it.

Counterpart of ``ccfindr_tpu.ops.tile``, under its names.  The JAX
package cut X into TPU tiles of fixed-width slots for a Pallas kernel
that densified them in VMEM; the port keeps X as CSR plus the
permutation to its CSC order (:class:`TileCounts`) and runs the phases
as two kernels (``csrc/sparse.cu``): S1 forms ``wth`` and ``a = x/wth``
at the nonzeros of each gene row and sums ``swn``, S2 sums ``shn`` for
each cell from the same ``a``.  The plain PyTorch version of both is
:func:`ccfindr_tpu_torch.ops.sparse.coo_pass`.

* VB: :func:`fused_tile` -> ``(swn, shn, dterm)`` as
  ``ops.vb.fused_dense`` (S1 + S2 + M3, the ELBO fold in torch);
* ML: :func:`tile_ml_h` -> ``(hn, sum x log wh)`` (S1 + S2 + M3) and
  :func:`tile_ml_w` -> ``wn`` (S1 alone);
* a cell-sharded mesh: :func:`from_scipy_tile_sharded`, one layout a
  cell shard, whose passes ``parallel.sharded.make_tile_fused_sharded``
  and ``make_tile_ml_sharded`` run shard by shard.

Factors carry a leading lane axis: ``lw (B, n, r)``, ``lh (B, r, m)``.
Neither X nor any (n, m) array is ever formed densely.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from .kernels import sparse as spk
from .sparse import Shards, fold_dterm


class TileCounts:
    """X as CSR with the permutation to its CSC order.

    (The name is the JAX package's; this layout holds no TPU tiles.)

    * ``indptr (n+1,)`` int64, ``col (nnz,)`` int32, ``val (nnz,)``:
      the CSR, rows sorted by column, no explicit zeros.  ``val`` is
      int16 for integer counts up to 32,767 (exact), else the factor
      dtype; it holds every nonzero once, which is what the hoisted
      ``sum lgamma(x+1)`` of ``ops.vb`` and the ML constant read.
    * ``colptr (m+1,)`` int64, ``row (nnz,)`` int32: the CSC's column
      pointers and row indices; ``perm (nnz,)`` int32: the CSR position
      of each CSC position.
    * ``tail (nnz,)`` uint8 or None: 1 at the nonzeros that the JAX
      package's slot layout sends to its COO overflow tail, whose
      operands its bf16 mode leaves unrounded (:func:`_flag_bf16_tail`,
      for ``precision='bf16'`` only); None where no nonzero is flagged,
      and in the float layouts.
    * ``slots``: the constructor's ``(bm, quantile, kt_cap)``, the JAX
      slot layout whose tail that is.
    """

    def __init__(self, indptr, col, val, colptr, row, perm, n, m,
                 tail=None, slots=(None, 0.99, 64)):
        self.indptr, self.col, self.val = indptr, col, val
        self.colptr, self.row, self.perm = colptr, row, perm
        self.n, self.m = int(n), int(m)
        self.tail, self.slots = tail, slots
        self._csr_rows = None

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def device(self):
        return self.val.device

    def csr_rows(self):
        """The row of each nonzero in CSR order (int64), for the plain
        versions; built once."""
        if self._csr_rows is None:
            self._csr_rows = torch.repeat_interleave(
                torch.arange(self.n, device=self.device),
                self.indptr.diff())
        return self._csr_rows

    def to(self, device):
        """The same layout on ``device``."""
        return TileCounts(*(getattr(self, f).to(device) for f in (
            "indptr", "col", "val", "colptr", "row", "perm")), self.n,
            self.m, tail=None if self.tail is None else self.tail.to(device),
            slots=self.slots)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.val.cpu().numpy(),
                              self.col.cpu().numpy(),
                              self.indptr.cpu().numpy()),
                             shape=(self.n, self.m))


def from_scipy_tile(mat, dtype=torch.float32, bn: int | None = None,
                    bm: int | None = None, quantile: float = 0.99,
                    kt_cap: int = 64, pack="auto",
                    device="cuda") -> TileCounts:
    """The layout of a scipy sparse (or dense) matrix, on ``device``
    (the card unless the caller asks for the CPU).
    Built once a factorization, in O(nnz) on the host and a sort on
    ``device``.

    Integer counts in [0, 32767] are stored as int16 (the kernels
    convert them in registers, exactly); any other values in ``dtype``.
    ``bn``, ``bm``, ``quantile``, ``kt_cap`` and ``pack`` shape the JAX
    package's TPU slot layout, which the CSR layout does not hold; the
    layout keeps ``bm``, ``quantile`` and ``kt_cap`` (:attr:`TileCounts.
    slots`), from which :func:`_flag_bf16_tail` flags that layout's
    overflow tail, which JAX's bf16 pass takes unrounded.
    """
    device = resolve_device(device)
    csr = _clean_csr(mat)
    return _layout(csr, _values(csr.data, dtype), device,
                   (bm, quantile, kt_cap))


# ---------------------------------------------------------------------
# The JAX package's overflow tail (ccfindr_tpu/ops/tile.py:127-182),
# computed on the host from the CSR: its blocks and slot width, and the
# slot each nonzero takes in ``_build_slots``'s order
# ---------------------------------------------------------------------

def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _pick_bm(m, bm):
    """The JAX layout's cell block (``_pick_blocks``'s ``bm``; its gene
    block does not change the tail)."""
    return min(128, _round_up(m, 128)) if bm is None else bm


def _pick_width(cnts, quantile, kt_cap):
    """The JAX layout's slot width from the nonempty per-(gene, cell
    block) counts: ``_pick_width``."""
    if len(cnts) == 0:
        return 8
    w = (int(np.quantile(cnts, quantile)) if quantile < 1.0
         else int(cnts.max()))
    return int(min(_round_up(kt_cap, 8), max(8, _round_up(w, 8))))


def _slot_positions(indptr, indices, bm):
    """``(pos, cnts)`` of a CSR without duplicates: each nonzero's slot
    in its (gene, ``bm``-cell block) group, counted in CSR order
    (columns ascending within a gene, as ``_build_slots`` takes them),
    and the nonzero count of every nonempty group in that order."""
    nnz = len(indices)
    if nnz == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    tj = indices // bm
    change = np.empty(nnz, bool)
    change[0] = True
    np.not_equal(tj[1:], tj[:-1], out=change[1:])
    del tj
    change[indptr[:-1][np.diff(indptr) > 0]] = True
    starts = np.flatnonzero(change)
    del change
    cnts = np.diff(np.append(starts, nnz))
    pos = np.arange(nnz, dtype=np.int64)
    pos -= np.repeat(starts, cnts)
    return pos, cnts


def _flag_bf16_tail(layout):
    """Set :attr:`TileCounts.tail` of ``layout`` (a :class:`TileCounts`,
    or the :class:`Shards` of :func:`from_scipy_tile_sharded`) to the
    nonzeros that ``ccfindr_tpu.ops.tile.from_scipy_tile`` (or its
    ``_sharded``) with the constructor's keywords
    (:attr:`TileCounts.slots`) puts in its COO overflow tail: past the
    slot width of their (gene, ``bm``-cell block) group, the width the
    ``quantile`` of the group sizes rounded up to 8, at most ``kt_cap``.
    Shards take their blocks from the local cells and one width from all
    shards' groups, as JAX's do.  Computed on the host from the layout's
    CSR, for ``precision='bf16'`` only (the constructors keep JAX's
    signatures, and the float layouts have no tail); returns
    ``layout``."""
    shards = list(layout) if isinstance(layout, Shards) else [layout]
    bm, quantile, kt_cap = shards[0].slots
    slots = [_slot_positions(tc.indptr.cpu().numpy(), tc.col.cpu().numpy(),
                             _pick_bm(tc.m, bm)) for tc in shards]
    kt = _pick_width(np.concatenate([c for _, c in slots]), quantile,
                     kt_cap)
    for tc, (pos, _) in zip(shards, slots):
        flags = pos >= kt
        tc.tail = (torch.as_tensor(flags.view(np.uint8), device=tc.device)
                   if flags.any() else None)
    return layout


def _clean_csr(mat):
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat, copy=True)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    return csr


def _values(data, dtype):
    """The stored values: int16 for integer counts in [0, 32767]
    (exact), else ``dtype``."""
    if len(data) == 0 or (data.min() >= 0
                          and data.max() <= np.iinfo(np.int16).max
                          and (np.issubdtype(data.dtype, np.integer)
                               or np.array_equal(data, np.round(data)))):
        return data.astype(np.int16)
    return data.astype(torch.empty((), dtype=dtype).numpy().dtype)


def _layout(csr, vals, device, slots) -> TileCounts:
    """The layout of a cleaned CSR with its stored values ``vals`` and
    the JAX slot keywords ``slots``."""
    n, m = csr.shape
    nnz = csr.nnz
    if nnz >= 2 ** 31:
        raise ValueError(f"{nnz} nonzeros: the layout's int32 positions "
                         "take fewer than 2**31")

    def t(a, d):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=d),
                               device=device)

    indptr, col = t(csr.indptr, np.int64), t(csr.indices, np.int32)
    colptr, row, perm = _csc_order(indptr, col, n, m)
    return TileCounts(indptr=indptr, col=col, val=t(vals, vals.dtype),
                      colptr=colptr, row=row, perm=perm, n=n, m=m,
                      slots=slots)


def _csc_order(indptr, col, n, m):
    """``(colptr, row, perm)`` of a CSR's ``indptr``/``col`` on their
    device: a stable sort of the column indices, so that rows ascend
    within a column (scipy's CSC order; on the card it replaced a host
    conversion that took ~8 s of a ~20 s layout build at the oversize
    configuration's 279 M nonzeros)."""
    dev = col.device
    perm = torch.argsort(col, stable=True)
    colptr = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    colptr[1:] = torch.cumsum(torch.bincount(col, minlength=m), 0)
    rows = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev), indptr.diff())
    row = rows[perm]
    del rows
    return colptr, row, perm.to(torch.int32)


def from_dense_tile(x, dtype=torch.float32, device="cuda",
                    **kw) -> TileCounts:
    """:func:`from_scipy_tile` of a dense matrix; ``kw`` are its layout
    keywords (accepted and not used)."""
    import scipy.sparse as sp

    return from_scipy_tile(sp.csr_matrix(np.asarray(x)), dtype=dtype,
                           device=device, **kw)


def from_scipy_tile_sharded(mat, n_shards: int, m_pad: int | None = None,
                            dtype=torch.float32, bn: int | None = None,
                            bm: int | None = None, quantile: float = 0.99,
                            kt_cap: int = 64, pack="auto",
                            device="cuda") -> Shards:
    """Cell-sharded layout: :class:`Shards` of ``n_shards``
    :class:`TileCounts`, shard ``s`` holding the cells ``[s m_loc, (s+1)
    m_loc)`` of X with LOCAL column indices and ``m = m_loc = m_pad //
    n_shards`` (the padded cells past X's own are empty columns).

    One value type for all shards, chosen on the whole matrix as
    :func:`from_scipy_tile` chooses it, so the shards and a one-device
    layout hold the same values; ``Shards.val`` is the one-device
    layout's ``val``.  All shards lie on ``device`` (``Shards.to``
    spreads them over a mesh).  The TPU slot keywords (``bn``, ``bm``,
    ``quantile``, ``kt_cap``, ``pack``) shape no array; each shard keeps
    ``bm``, ``quantile`` and ``kt_cap`` for :func:`_flag_bf16_tail`, as
    :func:`from_scipy_tile`."""
    device = resolve_device(device)
    csr = _clean_csr(mat)
    n, m = csr.shape
    if m_pad is None:
        m_pad = -(-m // n_shards) * n_shards
    if m_pad % n_shards != 0:
        raise ValueError(f"m_pad={m_pad} not divisible by {n_shards}")
    m_loc = m_pad // n_shards
    vals = _values(csr.data, dtype)
    csc = csr.tocsc()
    shards = []
    for s in range(n_shards):
        j0, j1 = s * m_loc, min((s + 1) * m_loc, m)
        blk = _clean_csr(csc[:, j0:max(j1, j0)])
        if j1 - j0 < m_loc:
            blk.resize(n, m_loc)
        shards.append(_layout(blk, blk.data.astype(vals.dtype), device,
                              (bm, quantile, kt_cap)))
    return Shards(shards, n, m_loc, torch.as_tensor(vals))


def fused_tile(tc: TileCounts, lw, lh, do_elbo=None, mxu_bf16=False):
    """Single-pass fused backend over the layout: ``(swn (B, n, r), shn
    (B, r, m), dterm (B,))`` as ``ops.vb.fused_dense`` returns them,
    with sw = lw*swn, sh = lh*shn.

    ``do_elbo`` (B,) skips the O(nnz) ``x log wth`` for the lanes where
    it is 0 (the ``elbo_every`` cadence); their ``dterm`` is then
    meaningless and must not be read (``ops.vb._vb_run_fused`` guards
    this).  ``mxu_bf16`` (``precision='bf16'``) rounds S1/S2's gathered
    factor rows and ``a = x/wth`` to bf16, as the JAX tile kernel rounds
    its operands, except at the nonzeros of :attr:`TileCounts.tail`,
    which JAX's COO overflow tail takes unrounded
    (``ccfindr_tpu/ops/tile.py:611-621``; :func:`_flag_bf16_tail` sets
    it).  S1 and S2 run over lane groups of bounded ``a`` bytes
    (``kernels.sparse.lane_groups``), each lane's bits those of the
    whole batch."""
    nb = lw.shape[0]
    groups = spk.lane_groups(nb, tc.nnz, lw.element_size())
    if len(groups) == 1:
        swn, a, xlog = spk.rowpass(tc, lw, lh.transpose(-1, -2).contiguous(),
                                   do_elbo=do_elbo, mxu_bf16=mxu_bf16)
        shn = spk.colpass(tc, a, lw, mxu_bf16=mxu_bf16)
        del a
        return swn, shn, fold_dterm(swn, shn, lw, lh, xlog)
    # S1 and S2 a lane group at a time (spk.lane_groups): one group's
    # a = x/wth lives at a time
    if do_elbo is not None:
        do_elbo = torch.as_tensor(do_elbo, device=lw.device).expand(nb)
    swn, shn = torch.empty_like(lw), torch.empty_like(lh)
    xlog = torch.empty(nb, dtype=torch.float64, device=lw.device)
    for g in groups:
        swn[g], a, xlog[g] = spk.rowpass(
            tc, lw[g], lh[g].transpose(-1, -2).contiguous(),
            do_elbo=None if do_elbo is None else do_elbo[g],
            mxu_bf16=mxu_bf16)
        shn[g] = spk.colpass(tc, a, lw[g], mxu_bf16=mxu_bf16)
        del a
    return swn, shn, fold_dterm(swn, shn, lw, lh, xlog)


def make_tile_fused(mxu_bf16=False):
    """Fused function for ``vb_run(fused=...)``/``vb_factorize(backend=
    'sparse')``; it takes ``vb_run``'s ``do_elbo`` flag."""
    def fused(x, lw, lh, do_elbo=None):
        return fused_tile(x, lw, lh, do_elbo=do_elbo, mxu_bf16=mxu_bf16)

    return fused


def tile_ml_h(tc: TileCounts, w, h):
    """ML H phase: ``(hn (B, r, m), xlogwh (B,) float64)`` with hn =
    w^T (x/wh) and xlogwh = sum x log(wh) (the contract of
    ``ops.ml.ml_run(fused_h=...)``)."""
    _, a, xlog = spk.rowpass(tc, w, h.transpose(-1, -2).contiguous(),
                             want_swn=False)
    return spk.colpass(tc, a, w), xlog


def tile_ml_w(tc: TileCounts, w, h):
    """ML W phase: ``wn (B, n, r) = (x/wh) h^T`` for the updated h."""
    return spk.rowpass(tc, w, h.transpose(-1, -2).contiguous(),
                       want_a=False, want_xlog=False)[0]


def make_tile_ml_backend():
    """(fused_h, fused_w) pair for ``ops.ml.ml_run`` over a
    :class:`TileCounts`: ``factorize(backend='sparse')``."""
    return tile_ml_h, tile_ml_w
