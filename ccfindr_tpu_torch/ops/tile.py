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
    """

    def __init__(self, indptr, col, val, colptr, row, perm, n, m):
        self.indptr, self.col, self.val = indptr, col, val
        self.colptr, self.row, self.perm = colptr, row, perm
        self.n, self.m = int(n), int(m)
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
            self.m)

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
    Built once a factorization on the host, in O(nnz).

    Integer counts in [0, 32767] are stored as int16 (the kernels
    convert them in registers, exactly); any other values in ``dtype``.
    ``bn``, ``bm``, ``quantile``, ``kt_cap`` and ``pack`` shape the JAX
    package's TPU slot layout; the CSR layout has no slots, so they are
    accepted and not used.
    """
    device = resolve_device(device)
    csr = _clean_csr(mat)
    return _layout(csr, _values(csr.data, dtype), device)


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
                          and np.array_equal(data, np.round(data))):
        return data.astype(np.int16)
    return data.astype(torch.empty((), dtype=dtype).numpy().dtype)


def _layout(csr, vals, device) -> TileCounts:
    """The layout of a cleaned CSR with its stored values ``vals``."""
    import scipy.sparse as sp

    n, m = csr.shape
    nnz = csr.nnz
    if nnz >= 2 ** 31:
        raise ValueError(f"{nnz} nonzeros: the layout's int32 positions "
                         "take fewer than 2**31")
    # the CSC order: a CSC conversion of the positions 0..nnz-1
    pos = sp.csr_matrix((np.arange(nnz, dtype=np.int64), csr.indices,
                         csr.indptr), shape=(n, m)).tocsc()

    def t(a, d):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=d),
                               device=device)

    return TileCounts(indptr=t(csr.indptr, np.int64),
                      col=t(csr.indices, np.int32), val=t(vals, vals.dtype),
                      colptr=t(pos.indptr, np.int64),
                      row=t(pos.indices, np.int32),
                      perm=t(pos.data, np.int32), n=n, m=m)


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
    ``quantile``, ``kt_cap``, ``pack``) are accepted and not used."""
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
        shards.append(_layout(blk, blk.data.astype(vals.dtype), device))
    return Shards(shards, n, m_loc, torch.as_tensor(vals))


def fused_tile(tc: TileCounts, lw, lh, do_elbo=None, mxu_bf16=False):
    """Single-pass fused backend over the layout: ``(swn (B, n, r), shn
    (B, r, m), dterm (B,))`` as ``ops.vb.fused_dense`` returns them,
    with sw = lw*swn, sh = lh*shn.

    ``do_elbo`` (B,) skips the O(nnz) ``x log wth`` for the lanes where
    it is 0 (the ``elbo_every`` cadence); their ``dterm`` is then
    meaningless and must not be read (``ops.vb._vb_run_fused`` guards
    this).  ``mxu_bf16`` (``precision='bf16'``) rounds S1/S2's gathered
    factor rows and ``a = x/wth`` to bf16.  The JAX tile kernel rounds
    the same operands, but not those of its COO overflow tail
    (``ccfindr_tpu/ops/tile.py:611-621``); this layout has no tail."""
    swn, a, xlog = spk.rowpass(tc, lw, lh.transpose(-1, -2).contiguous(),
                               do_elbo=do_elbo, mxu_bf16=mxu_bf16)
    shn = spk.colpass(tc, a, lw, mxu_bf16=mxu_bf16)
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
