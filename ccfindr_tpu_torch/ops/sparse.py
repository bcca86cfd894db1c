"""Sparse count-matrix passes over the nonzeros, in plain PyTorch.

Counterpart of ``ccfindr_tpu.ops.sparse``.  The reference densifies X
before every sweep (as.matrix at R/bayesian.R:339); every X-dependent
quantity of a sweep touches only the nonzeros:

* the sw-numerator ``(X/wth) @ lh^T`` and the sh-numerator
  ``lw^T @ (X/wth)`` need ``x / wth`` only where ``x > 0``;
* the ELBO's ``-sum lgamma(x+1)`` and ``sum x log wth`` vanish at 0.

So a sweep costs O(nnz r) instead of O(n m r).  :func:`coo_pass`
gathers the factor rows of a chunk of nonzeros and scatters with
``index_add_``, over the same leading lane axis as the rest of the port
(factors ``lw (B, n, r)``, ``lh (B, r, m)``).  It is the plain version
of the CUDA kernels S1/S2 (:mod:`ccfindr_tpu_torch.ops.kernels.sparse`),
which run the sparse backend over the CSR layout of
:mod:`ccfindr_tpu_torch.ops.tile`.

The JAX package's COO API (:class:`SparseCounts`, :func:`from_scipy`,
:func:`suffstats_coo`, :func:`elbo_data_coo`, :func:`fused_coo`, ...)
keeps its layout: flat COO padded to a chunk multiple with dummy
coordinates ``(n, m)``.  Its passes are
:func:`ccfindr_tpu_torch.ops.tile.fused_tile`'s (S1/S2, their plain
versions on CPU tensors) over a CSR view of the same nonzeros, built
once by the constructor (:attr:`SparseCounts.csr`): one implementation
of the pass, and on the card no ``index_add_``, whose atomics add in a
varying order.  ``vb_factorize(sparse_layout='coo')`` therefore builds
the CSR layout at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lane_sum, resolve_device
from .kernels.sol import bf16_round

# nonzeros a chunk gathers at once (bounds the (B, chunk, r) temporaries)
CHUNK = 1 << 16


def coo_pass(row, col, val, lw, lht, *, m, want_swn=True, want_shn=True,
             want_a=False, want_xlog=True, do_elbo=None, mxu_bf16=False,
             tail=None):
    """One pass over the nonzeros ``(row[p], col[p], val[p])`` for a
    lane batch ``lw (B, n, r)``, ``lht (B, m, r)`` (lh transposed).

    At each nonzero ``wth = lw[row] . lht[col]`` (a non-positive one is
    replaced by 1, as in the JAX package) and ``a = val / wth``.
    Returns ``(swn (B, n, r), shn_t (B, m, r), a (B, nnz), xlog (B,)
    float64)``: ``swn`` sums ``a lht[col]`` into ``row``, ``shn_t``
    sums ``a lw[row]`` into ``col``, ``a`` in the order of the
    nonzeros, ``xlog`` the sum of ``val log wth`` (0 for a lane whose
    ``do_elbo`` is 0).  An output whose ``want_*`` is False is None.
    ``mxu_bf16`` (``precision='bf16'``) rounds the gathered factor rows
    to bf16 before ``wth`` and ``a`` after the division; ``a`` is
    returned rounded, and the sums and ``log(wth)`` stay in the factor
    dtype.  ``tail`` (nnz,) flags the nonzeros that keep their operands
    unrounded under ``mxu_bf16`` (``ops.tile.TileCounts.tail``).
    """
    nb, n, r = lw.shape
    dt, dev = lw.dtype, lw.device
    nnz = val.shape[0]
    swn = torch.zeros_like(lw) if want_swn else None
    shn_t = (torch.zeros(nb, m, r, dtype=dt, device=dev) if want_shn
             else None)
    a_all = torch.empty(nb, nnz, dtype=dt, device=dev) if want_a else None
    xlog = torch.zeros(nb, dtype=torch.float64, device=dev)
    for p0 in range(0, nnz, CHUNK):
        rr = row[p0:p0 + CHUNK].long()
        cc = col[p0:p0 + CHUNK].long()
        vv = val[p0:p0 + CHUNK].to(dt)
        lw_g = lw[:, rr]                          # (B, chunk, r)
        lh_g = lht[:, cc]
        if mxu_bf16:
            keep = _keep(tail, p0, len(rr))
            lw_g, lh_g = _operand(lw_g, keep), _operand(lh_g, keep)
            wth = _s1_dot(lw_g, lh_g)
        else:
            wth = (lw_g * lh_g).sum(-1)
        safe = torch.where(wth > 0, wth, 1.0)
        a = vv / safe                             # (B, chunk)
        if mxu_bf16:
            a = _operand(a, None if keep is None else keep[..., 0])
        if want_swn:
            swn.index_add_(1, rr, a[..., None] * lh_g)
        if want_shn:
            shn_t.index_add_(1, cc, a[..., None] * lw_g)
        if want_a:
            a_all[:, p0:p0 + CHUNK] = a
        if want_xlog:
            xlog += (vv * torch.log(safe)).sum(-1, dtype=torch.float64)
    if not want_xlog:
        xlog = None
    elif do_elbo is not None:
        xlog = torch.where(do_elbo > 0, xlog, 0.0)
    return swn, shn_t, a_all, xlog


def _keep(tail, p0, size):
    """The tail flags of nonzeros ``p0 .. p0 + size`` as a (size, 1)
    bool, None without a tail."""
    if tail is None:
        return None
    return tail[p0:p0 + size].bool()[:, None]


def _operand(t, keep):
    """``t`` rounded to bf16 but where ``keep`` (broadcast against its
    trailing axes)."""
    if keep is None:
        return bf16_round(t)
    return torch.where(keep, t, bf16_round(t))


def _s1_dot(u, v):
    """``sum u v`` over the last axis in S1's order (``csrc/sparse.cu``):
    up to r = 32 a thread adds its nonzero's products in component
    order; above, the group walk spreads the components over the 32
    lanes of a warp (four a lane), each lane's products added in turn,
    then a butterfly across the warp.  Under ``mxu_bf16`` every product
    of two rounded operands is exact, so this gives S1's ``wth`` bit for
    bit, and with it S1's rounding of ``a = x/wth`` to bf16 (a ``wth``
    one ulp away could round ``a`` to its neighbour, 2^-8 of it)."""
    r = u.shape[-1]
    p = u * v
    if r <= 32:
        s = p[..., 0]
        for k in range(1, r):
            s = s + p[..., k]
        return s
    g, kp = 32, 4
    p = torch.nn.functional.pad(p, (0, g * kp - r)).unflatten(-1, (kp, g))
    s = p[..., 0, :]
    for j in range(1, kp):
        s = s + p[..., j, :]
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def coo_colpass(row, col, a, lw, m, mxu_bf16=False, tail=None):
    """``shn_t (B, m, r)``: ``a[:, p] lw[:, row[p]]`` summed into
    ``col[p]`` over the nonzeros (``mxu_bf16``: the rows of ``lw``
    rounded to bf16, but at the nonzeros that ``tail`` flags)."""
    nb, _, r = lw.shape
    if mxu_bf16 and tail is None:
        lw, mxu_bf16 = bf16_round(lw), False
    shn_t = torch.zeros(nb, m, r, dtype=lw.dtype, device=lw.device)
    for p0 in range(0, col.shape[0], CHUNK):
        rr = row[p0:p0 + CHUNK].long()
        cc = col[p0:p0 + CHUNK].long()
        lw_g = lw[:, rr]
        if mxu_bf16:
            lw_g = _operand(lw_g, _keep(tail, p0, len(rr)))
        shn_t.index_add_(1, cc, a[:, p0:p0 + CHUNK, None] * lw_g)
    return shn_t


def fold_dterm(swn, shn, lw, lh, xlog):
    """The ELBO data term from a fused pass's outputs, in the factor
    dtype and in JAX's argument order: ``-(sum swn lw log lw + sum shn
    lh log lh) + xlog`` a lane, for ``swn``/``lw (B, n, r)``,
    ``shn``/``lh (B, r, m)`` and ``xlog (B,)`` (the fold of
    ``ccfindr_tpu.ops.pallas.vb_kernels.fold_dterm``; the sums are taken
    in float64)."""
    f64 = torch.float64
    return (xlog - lane_sum(swn * (lw * torch.log(lw)), 2, f64)
            - lane_sum(shn * (lh * torch.log(lh)), 2, f64)).to(lw.dtype)


# ---------------------------------------------------------------------
# The JAX package's COO API (ccfindr_tpu/ops/sparse.py)
# ---------------------------------------------------------------------

def _csr_view(row, col, val, n, m):
    """The nonzeros of a COO (dummies ``row == n`` and zeros dropped) as
    the CSR layout of :class:`~ccfindr_tpu_torch.ops.tile.TileCounts`,
    built on their device by sorts and searches: no scatter, no atomic.
    A repeated coordinate stays two nonzeros (they add in the passes)."""
    keep = (row < n) & (val != 0)
    return _sorted_csr(row[keep], col[keep], val[keep], n, m)


def _sorted_csr(row, col, val, n, m):
    """The nonzeros ``(row[p], col[p], val[p])`` (no dummies) as the CSR
    layout of :class:`~ccfindr_tpu_torch.ops.tile.TileCounts`, on their
    device, by sorts and searches (the CSC order
    :func:`~ccfindr_tpu_torch.ops.tile._csc_order`'s)."""
    from .tile import TileCounts, _csc_order

    r, c, v = row.long(), col.long(), val
    order = torch.argsort(r * m + c, stable=True)
    r, c, v = r[order], c.to(torch.int32)[order], v[order]
    indptr = torch.searchsorted(r, torch.arange(n + 1, device=row.device))
    colptr, rowc, perm = _csc_order(indptr, c, n, m)
    return TileCounts(indptr=indptr, col=c, val=v.contiguous(),
                      colptr=colptr, row=rowc, perm=perm, n=n, m=m)


class SparseCounts:
    """Chunk-padded COO count matrix, the JAX package's layout.

    ``row``/``col`` (nnz_pad,) int32 with the dummy coordinate ``(n,
    m)`` in the padding, ``val`` (nnz_pad,) in the factor dtype (0 in the
    padding); ``n``, ``m`` the extents.  :attr:`csr` is the same
    nonzeros as a :class:`~ccfindr_tpu_torch.ops.tile.TileCounts` (CSR
    plus the CSC permutation), built once by the constructor, over which
    the passes (S1/S2) and the products of ``ops.rsvd`` run."""

    def __init__(self, row, col, val, n, m):
        self.row, self.col, self.val = row, col, val
        self.n, self.m = int(n), int(m)
        self.csr = _csr_view(row, col, val, self.n, self.m)
        self._live = None

    @property
    def device(self):
        return self.val.device

    def live(self):
        """``(row, col, val)`` without the dummy padding (the gathers of
        :func:`elbo_data_coo` take the real indices only); built once."""
        if self._live is None:
            keep = self.row < self.n
            self._live = (self.row[keep], self.col[keep], self.val[keep])
        return self._live

    def to(self, device):
        """The same matrix on ``device``."""
        return SparseCounts(self.row.to(device), self.col.to(device),
                            self.val.to(device), self.n, self.m)


class Shards(tuple):
    """A cell-sharded sparse layout: one layout a cell shard, in shard
    order, each with its cells' nonzeros only and shard-local column
    indices (a :class:`SparseCounts` or a
    :class:`~ccfindr_tpu_torch.ops.tile.TileCounts`).

    ``n`` is the gene count, ``m`` the local cell count ``m_pad //
    len(self)``; ``val`` holds every nonzero of the whole X once, on the
    host, in the order of the one-device layout (the loops' ``sum
    lgamma(x + 1)`` and the ML constant read it, and so give a one-device
    run's bits).  Where the JAX package stacks the shards on a leading
    axis laid out over the mesh, the port keeps one layout a shard, each
    on its own device (:meth:`to`)."""

    def __new__(cls, shards, n, m, val):
        self = super().__new__(cls, shards)
        self.n, self.m, self.val = int(n), int(m), val
        return self

    @property
    def device(self):
        return self[0].device

    def to(self, devices):
        """The shards moved each to its device (one a shard, in order)."""
        devices = list(devices)
        if len(devices) != len(self):
            raise ValueError(f"{len(self)} shards, {len(devices)} devices")
        return Shards([s.to(d) for s, d in zip(self, devices)], self.n,
                      self.m, self.val)


def _pad_coo(rows, cols, vals, n, m, chunk, np_dtype):
    pad = (-len(rows)) % chunk
    return (np.concatenate([rows.astype(np.int32),
                            np.full(pad, n, np.int32)]),
            np.concatenate([cols.astype(np.int32),
                            np.full(pad, m, np.int32)]),
            np.concatenate([vals.astype(np_dtype), np.zeros(pad, np_dtype)]))


def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def from_scipy(mat, dtype=torch.float32, chunk: int = 1 << 16,
               device="cuda") -> SparseCounts:
    """Build a chunk-padded SparseCounts from a scipy sparse matrix, on
    ``device`` (the card unless the caller asks for the CPU)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    coo = sp.coo_matrix(mat)
    row, col, val = _pad_coo(coo.row, coo.col, coo.data, coo.shape[0],
                             coo.shape[1], chunk, _np_dtype(dtype))

    def t(a):
        return torch.as_tensor(a, device=device)

    return SparseCounts(row=t(row), col=t(col), val=t(val), n=coo.shape[0],
                        m=coo.shape[1])


def from_dense(x, dtype=torch.float32, chunk: int = 1 << 16,
               device="cuda") -> SparseCounts:
    import scipy.sparse as sp

    return from_scipy(sp.csr_matrix(np.asarray(x)), dtype=dtype,
                      chunk=chunk, device=device)


def from_scipy_sharded(mat, n_shards: int, m_pad: int | None = None,
                       dtype=torch.float32, chunk: int = 1 << 16,
                       device="cuda") -> Shards:
    """Cell-sharded COO: nonzeros partitioned by equal cell ranges.

    Returns :class:`Shards` of ``n_shards`` SparseCounts, shard ``s``
    holding the cells ``[s m_loc, (s+1) m_loc)`` with LOCAL column
    indices and ``m = m_loc = m_pad // n_shards``; each pads to the
    largest local nonzero count (a chunk multiple) with the dummy
    coordinate ``(n, m_loc)``, as the JAX function's stacked arrays.
    All shards lie on ``device``; ``Shards.to`` spreads them over a
    mesh's devices."""
    import scipy.sparse as sp

    device = resolve_device(device)
    csc = sp.csc_matrix(mat)
    n, m = csc.shape
    if m_pad is None:
        m_pad = -(-m // n_shards) * n_shards
    if m_pad % n_shards != 0:
        raise ValueError(f"m_pad={m_pad} not divisible by {n_shards}")
    m_loc = m_pad // n_shards
    np_dtype = _np_dtype(dtype)
    locs = []
    for s in range(n_shards):
        j0, j1 = s * m_loc, min((s + 1) * m_loc, m)
        block = sp.coo_matrix(csc[:, j0:max(j1, j0)])
        locs.append((block.row, block.col, block.data))
    nnz_pad = -(-max(max(len(r) for r, _, _ in locs), 1) // chunk) * chunk
    shards = []
    for r, c, v in locs:
        row, col, val = _pad_coo(r, c, v, n, m_loc, nnz_pad, np_dtype)
        shards.append(SparseCounts(
            *(torch.as_tensor(a, device=device) for a in (row, col, val)),
            n=n, m=m_loc))
    whole = sp.coo_matrix(mat)
    return Shards(shards, n, m_loc,
                  torch.as_tensor(whole.data.astype(np_dtype)))


def lgamma_term(sc: SparseCounts):
    """sum_ij lgamma(x_ij + 1) — only nonzeros contribute."""
    return torch.lgamma(sc.val + 1.0).sum()


def _batched(lw, lh):
    """The factors with a lane axis: JAX's unbatched ``(n, r)``/``(r,
    m)`` get one (and the caller drops it again)."""
    if lw.dim() == 2:
        return lw[None], lh[None], True
    return lw, lh, False


def suffstats_coo(sc: SparseCounts, lw, lh, chunk: int = 1 << 16):
    """(sw, sh) sufficient stats over nonzeros: sw = lw * ((X/wth)
    lh^T), sh = lh * (lw^T (X/wth)), as the dense pass, at O(nnz r):
    S1 + S2 over :attr:`SparseCounts.csr`, as :func:`fused_coo`, without
    the ``x log wth`` sum.  ``chunk`` (JAX's gather width) is accepted
    and not used."""
    from .kernels import sparse as spk

    lw, lh, one = _batched(lw, lh)
    lw = lw.contiguous()
    swn, a, _ = spk.rowpass(sc.csr, lw, lh.transpose(-1, -2).contiguous(),
                            want_xlog=False)
    sw, sh = lw * swn, lh * spk.colpass(sc.csr, a, lw)
    return (sw[0], sh[0]) if one else (sw, sh)


def elbo_data_coo(sc: SparseCounts, lw, lh, chunk: int = 1 << 16):
    """-sum_{x>0} x (S/wth - log wth) with S = (lw log lw) lh + lw (lh
    log lh), a lane.  The JAX function's form: gathers of the factor
    rows at the nonzeros and an ordered sum, no scatter, on either
    device."""
    lw, lh, one = _batched(lw, lh)
    row, col, val = sc.live()
    lwl, lht = lw * torch.log(lw), lh.transpose(-1, -2)
    lhl = lht * torch.log(lht)
    acc = torch.zeros(lw.shape[0], dtype=lw.dtype, device=lw.device)
    for p0 in range(0, val.shape[0], chunk):
        rr = row[p0:p0 + chunk].long()
        cc = col[p0:p0 + chunk].long()
        vv = val[p0:p0 + chunk].to(lw.dtype)
        lw_g, lh_g = lw[:, rr], lht[:, cc]
        wth = (lw_g * lh_g).sum(-1)
        s = (lwl[:, rr] * lh_g).sum(-1) + (lw_g * lhl[:, cc]).sum(-1)
        safe = torch.where(wth > 0, wth, 1.0)
        t = torch.where(vv > 0, vv * (s / safe - torch.log(safe)), 0.0)
        acc = acc - t.sum(-1)
    return acc[0] if one else acc


def fused_coo(sc: SparseCounts, lw, lh, chunk: int = 1 << 16):
    """One pass over the nonzeros: ``(swn, shn, dterm)``, the suffstat
    numerators (sw = lw*swn, sh = lh*shn) and the ELBO data term for the
    same (lw, lh), as ``ops.vb.fused_dense`` returns them; the
    S-dependent part of the ELBO folds into the numerators
    (:func:`fold_dterm`).  It is :func:`ccfindr_tpu_torch.ops.tile.fused_tile`
    over :attr:`SparseCounts.csr`; ``chunk`` (JAX's gather width) is
    accepted and not used."""
    from .tile import fused_tile

    lw, lh, one = _batched(lw, lh)
    swn, shn, dterm = fused_tile(sc.csr, lw.contiguous(), lh)
    return (swn[0], shn[0], dterm[0]) if one else (swn, shn, dterm)


def make_sparse_fused(chunk: int = 1 << 16):
    """Fused function for vb_run(fused=...)/vb_factorize(backend=
    'sparse', sparse_layout='coo')."""
    def fused(x, lw, lh):
        return fused_coo(x, lw, lh, chunk=chunk)

    return fused


def make_sparse_backend(chunk: int = 1 << 16):
    """(suffstats, data_term) pair operating on SparseCounts 'x'."""
    def sparse_suffstats(x, lw, lh):
        return suffstats_coo(x, lw, lh, chunk=chunk)

    def sparse_data_term(x, lw, lh):
        return elbo_data_coo(x, lw, lh, chunk=chunk)

    return sparse_suffstats, sparse_data_term
