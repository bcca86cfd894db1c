"""X laid out on a device grid, and the dense passes over its blocks.

Counterpart of the parts of ``ccfindr_tpu/parallel/sharded.py`` that the
dense mesh routes need.  The JAX package puts X on the mesh as one
GSPMD-sharded array, and XLA adds the cross-device sums of the dense
passes.  Here :class:`ShardedCounts` holds X as its (gene shard, cell
shard) blocks, each on its device of one runs row of the mesh, and
:func:`fused_sharded`, :func:`suffstats_sharded` and
:func:`data_term_sharded` (the hooks of ``ops.vb.vb_run``) compute each
block's products on the block's device in batches of a fixed lane
count (``utils.lane_matmul``),
then add the block partials on the row's first device in shard order:
``swn`` over cell shards, ``shn`` over gene shards.  With one block
they compute what ``ops.vb.fused_dense``, ``suffstats_dense`` and
``elbo_data_term`` compute, bit for bit.

The cell-major kernel sweep over the same layout is
``ops/kernels/sol_sharded.py``.  The JAX package's ``make_*_sharded``
functions are here under their names, each returning the hooks of
``ops.vb.vb_run`` or ``ops.ml.ml_run`` that run a kernel wrapper on
every shard and add the partials in shard order, genes then cells, on
the lanes' device (where the JAX package ``psum``s, in an order it
leaves open):

* :func:`make_fused_sharded` — E1 + E1s (``vb_kernels.fused_pallas``)
  on each (gene, cell) block of a :class:`ShardedCounts`: ``swn`` added
  over cell shards, ``shn`` over gene shards, the data term folded a
  block and added over both (the gene-sharded or gene-major ``'pallas'``
  mesh);
* :func:`make_tile_fused_sharded`, :func:`make_sparse_fused_sharded`,
  :func:`make_ell_fused_sharded` — S1/S2 (``ops.tile.fused_tile``,
  ``ops.sparse.fused_coo``, ``ops.ell.fused_ell``) on each cell shard
  of a :class:`~ccfindr_tpu_torch.ops.sparse.Shards` layout;
* :func:`make_ml_sharded` (M1/M2) and :func:`make_tile_ml_sharded`
  (S1/S2): the ML phases, the H numerator cell-local, ``x log wh`` and
  the W numerator added over shards;
* :func:`make_pass2_sharded` (port only) — P1 + E1s and P2 on each
  block: ``backend='pallas2pass'`` on a mesh.

Every pass takes ``lh``/``h`` joined or as its cell shards
(``parallel.hshards.HShards``, each on its shard's device, as the drivers
carry it on a mesh, the JAX driver's ``P(runs, None, cells)``): joined,
a shard's columns cross to its device and its H-side output (``shn``,
``hn``) comes back and is joined on the lanes' device, as before; as
shards, each shard's ``lh`` is read where it lies and its H-side output
stays there, added over gene shards on the shard's device, so that no
H-family tensor is joined.  The gene-sharded passes take ``lw`` likewise,
joined or as its gene shards (the JAX driver's ``P(runs, genes, None)``,
shard g on ``devices[g, 0]``): as shards, block (g, c) reads shard g,
copied only where the block lies on another device, and the W-side
output (``swn``) is added over cell shards on ``devices[g, 0]`` and
stays there, so that no W-family tensor is joined either; the data
terms are finished on the row's first device from the shards' partials
(``hshards.hsum``).  A shard on another device than its shard of X
raises.  A joined ``lw`` and the per-lane flags cross to each shard's
device and the W-side outputs (``swn``, ``wn``, the data terms) come
back to the lanes' device; where every shard is on the lanes' device
nothing crosses.  Each kernel runs on the
card that holds its shard (``ops.kernels.build.launch``).  A pass over
the shards goes in three stages: the lanes are copied to every shard's
device, then every shard's work is issued, then the outputs come back.
A copy between cards runs on its source's stream, after the work queued
there, so a copy issued after a shard's launch on the lanes' device
would hold the next card back until that launch ended; staged, the
cards run their shards at once, with no host sync between them.  The
kernels that add a lane's partials through a ticket counter (M1, S1,
P2) launch one shard after the other on a device's stream, which the
counters need.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lane_matmul, lane_sum, lgamma_sum
from . import hshards
from .hshards import HShards, hmap, hsum


def _bounds(extent, parts):
    step = extent // parts
    return [(k * step, (k + 1) * step) for k in range(parts)]


class ShardedCounts:
    """X (n, m) on a (genes, cells) grid of devices, one runs row of a
    mesh: block (g, c) holds rows ``rows[g]`` and columns ``cols[c]`` on
    ``devices[g, c]``; a block on X's own device is a view of it, the
    others are copies (:meth:`packed` gives every block contiguous).
    The drivers give X from the host, so a device holds its own blocks
    and no more.

    X is not kept whole.  What the convergence loops take from the whole
    X is taken here, with the single-device arithmetic so that a mesh run
    gives its bits: :attr:`lgx`, ``sol``'s float64 ``sum lgamma(x + 1)``
    on the row's first device (:attr:`device`), and :attr:`val`, the
    nonzeros in row-major order from which ``ops.vb`` takes its own,
    kept on the host.  ``n`` and ``m`` must divide by the grid (the
    drivers pad them)."""

    def __init__(self, x, devices):
        devices = np.asarray(devices, dtype=object)
        ng, nc = devices.shape
        n, m = x.shape
        if n % ng or m % nc:
            raise ValueError(f"X {n} x {m} does not split into {ng} gene "
                             f"and {nc} cell shards")
        self.devices = devices
        self.device = torch.device(devices[0, 0])
        self.shape, self.dtype = x.shape, x.dtype
        self.rows = _bounds(n, ng)
        self.cols = _bounds(m, nc)
        self.blocks = tuple(
            tuple(x[g0:g1, c0:c1].to(devices[g, c])
                  for c, (c0, c1) in enumerate(self.cols))
            for g, (g0, g1) in enumerate(self.rows))
        self._packed = None
        self.lgx = lgamma_sum(x, self.device)
        self.val = x[x != 0].cpu()

    def packed(self):
        """The blocks, each contiguous (the kernels that read a block in
        place take no row stride): a view is copied once, at first use,
        and kept; a copy is itself."""
        if self._packed is None:
            self._packed = tuple(tuple(b.contiguous() for b in row)
                                 for row in self.blocks)
        return self._packed

    def shard_h(self, t):
        """An H-family tensor (..., m) as its cell shards, each
        contiguous on its shard's device (the gene-shard-0 row):
        ``hshards.shard_h``."""
        return hshards.shard_h(t, self)

    def gather_h(self, parts):
        """Inverse of :meth:`shard_h`: the shards in order, joined on
        :attr:`device`."""
        return hshards.gather(HShards(parts), self.device)


def place_counts(x, mesh):
    """X laid out once on each runs row of ``mesh``: a list of
    :class:`ShardedCounts`, one a row."""
    return [ShardedCounts(x, row) for row in mesh.devices]


def _mT(a):
    return a.transpose(-1, -2)


def _xpass(x: ShardedCounts, lw, lh, with_xlog=True):
    """The dense X pass block by block: (swn, shn, sum x log(wth) or
    None), the block partials added in shard order on lw's device."""
    def block(xb, lwg, lhc):
        xf = xb.to(lw.dtype)
        wth = lane_matmul(lwg, lhc)
        u = xf / wth
        return (lane_matmul(u, _mT(lhc)), lane_matmul(_mT(lwg), u),
                lane_sum(xf * torch.log(wth), 2) if with_xlog else None)

    return _fold_blocks(_blocks(x, block, lw, lh, x.blocks), lw, lh)


def _shn_term(shn, lh):
    return shn * (lh * torch.log(lh))


def fused_sharded(x: ShardedCounts, lw, lh):
    """``ops.vb.fused_dense`` over the blocks: (swn, shn, dterm)."""
    swn, shn, xlog = _xpass(x, lw, lh)
    dev = hshards.home(lw)
    dterm = (-(hsum(hmap(_shn_term, swn, lw), 2, dev)
               + hsum(hmap(_shn_term, shn, lh), 2, dev)) + xlog)
    return swn, shn, dterm


def suffstats_sharded(x: ShardedCounts, lw, lh):
    """``ops.vb.suffstats_dense`` over the blocks: (sw, sh)."""
    swn, shn, _ = _xpass(x, lw, lh, with_xlog=False)
    return hmap(torch.mul, lw, swn), hmap(torch.mul, lh, shn)


def data_term_sharded(x: ShardedCounts, lw, lh):
    """``ops.vb.elbo_data_term`` over the blocks: (B,)."""
    return fused_sharded(x, lw, lh)[2]


# ---------------------------------------------------------------------
# The JAX package's make_*_sharded functions (ccfindr_tpu/parallel/sharded.py)
# ---------------------------------------------------------------------

def _grid(mesh, x, genes=True):
    """The (genes, cells) shards of ``x`` checked against the mesh (its
    cell axis alone for the ML passes, which shard X's cells only, as
    the JAX package's do)."""
    want = (mesh.shape["genes"] if genes else 1, mesh.shape["cells"])
    got = ((len(x.rows), len(x.cols)) if isinstance(x, ShardedCounts)
           else (1, len(x)))
    if got != want:
        raise ValueError(f"X is laid out on {got[0]} gene x {got[1]} cell "
                         f"shards; the mesh has {want[0]} x {want[1]}")


def _add(acc, part):
    return part if acc is None else acc + part


def _to(t, dev):
    return None if t is None else t.to(dev)


def _blocks(x: ShardedCounts, fn, lw, lh, blocks=None):
    """``fn(block, lw_g, lh_c)`` on every (gene, cell) block in order,
    genes then cells: a list of (g, c, outputs) with the outputs moved to
    the lanes' device.  ``lw_g``/``lh_c`` are the lanes' gene rows and
    cell columns of the block, contiguous on its device; ``fn`` returns a
    tuple ``(row part, column part, scalar)``.  ``lh`` given as cell
    shards gives each block its shard, and the column part stays on the
    shard's device; ``lw`` given as gene shards gives each block its
    gene shard, and the row part stays on the shard's device
    (``devices[g, 0]``).  ``blocks`` (default :meth:`ShardedCounts.packed`)
    are the blocks ``fn`` reads.  In three stages (the module
    docstring): every block's lanes cross first, then every ``fn`` is
    issued, then the outputs come back."""
    dev = hshards.home(lw)
    blocks = x.packed() if blocks is None else blocks
    if isinstance(lh, HShards):
        hshards.check(lh, x)
        home_c = lh.devices
        lh_of = list(lh)
    else:
        home_c = [dev] * len(x.cols)
        lh_of = [lh[..., c0:c1] for c0, c1 in x.cols]
    if isinstance(lw, HShards):
        hshards.check(lw, x)
        home_g = lw.devices
        lw_of = list(lw)
    else:
        home_g = [dev] * len(x.rows)
        lw_of = [lw[..., g0:g1, :] for g0, g1 in x.rows]
    work = [(g, c, b, lw_of[g].to(b.device).contiguous(),
             lh_of[c].to(b.device).contiguous())
            for g in range(len(x.rows)) for c, b in enumerate(blocks[g])]
    res = [(g, c, fn(xb, lw_g, lh_c)) for g, c, xb, lw_g, lh_c in work]
    del work
    return [(g, c, tuple(_to(t, (home_g[g], home_c[c], dev)[i])
                         for i, t in enumerate(r))) for g, c, r in res]


def _fold_blocks(parts, lw=None, lh=None):
    """Block outputs ``(row part, column part, scalar)`` (each may be
    None) added in shard order: a gene shard's rows (``swn``, ``wn``)
    over cells, then joined over genes (kept as the gene shards where
    ``lw`` came as gene shards, each where :func:`_blocks` left it); a
    cell shard's columns (``shn``, ``hn``) over genes, then joined over
    cells (kept as the cell shards where ``lh`` came as cell shards);
    the scalar over all blocks."""
    ng = 1 + max(g for g, _, _ in parts)
    nc = 1 + max(c for _, c, _ in parts)
    rows, cols, tot = [None] * ng, [None] * nc, None
    for g, c, (rp, cp, sc) in parts:
        if rp is not None:
            rows[g] = _add(rows[g], rp)
        if cp is not None:
            cols[c] = _add(cols[c], cp)
        if sc is not None:
            tot = _add(tot, sc)
    return (_joined(rows, lw, hshards.GENES),
            _joined(cols, lh, hshards.CELLS), tot)


def _joined(parts, ref, axis):
    """A fold's per-shard outputs: None, the shards on ``axis`` (``ref``
    given as shards) or joined along it."""
    if parts[0] is None:
        return None
    if isinstance(ref, HShards):
        return HShards(parts, axis)
    return torch.cat(parts, axis)


def make_fused_sharded(mesh, fused_local=None, bn: int = None,
                       bm: int = None, mxu_bf16: bool = False):
    """Fused function for ``ops.vb.vb_run(fused=...)`` over a mesh,
    genes and cells: ``fused(x, lw, lh) -> (swn, shn, dterm)`` for
    ``x`` a :class:`ShardedCounts` of the mesh's grid.

    ``fused_local(x_block, lw_g, lh_c) -> (swn_part, shn_part,
    dterm_part)`` runs on each block's device; the default is E1 + E1s
    (``ops.kernels.vb_kernels.fused_pallas``, ``mxu_bf16`` for
    ``precision='bf16'``) in the layout ``_fused_layout`` picks on the
    block's extents padded to the JAX tiles ``bn``/``bm``, with E1's
    chunk from the block's extents and the lane width alone (never the
    lane count, so that compaction and resume keep their bits).  The
    block partials are added in shard order: ``swn`` over cell shards,
    ``shn`` over gene shards, ``dterm`` (folded a block) over both."""
    from ..ops.kernels import vb_kernels as vbk

    if fused_local is None:
        tiles = dict(bn=bn or vbk.DEFAULT_BN, bm=bm or vbk.DEFAULT_BM)

        def fused_local(x, lw, lh):
            rp = -(-max(lw.shape[-1], 8) // 8) * 8
            layout = vbk._fused_layout(
                -(-x.shape[0] // tiles["bn"]) * tiles["bn"],
                -(-x.shape[1] // tiles["bm"]) * tiles["bm"], rp)
            chunk = vbk.fused_chunk(x, layout, 1, rp, lw.element_size())
            return vbk.fused_pallas(x, lw, lh, layout=layout,
                                    mxu_bf16=mxu_bf16, chunk=chunk,
                                    **tiles)

    def fused(x, lw, lh):
        _grid(mesh, x)
        return _fold_blocks(_blocks(x, lambda *a: tuple(fused_local(*a)),
                                    lw, lh), lw, lh)

    return fused


def _cell_shards(x, fn, lh, lw, *rest, cols=()):
    """``fn(shard, lh_c, lw, *rest)`` on every cell shard of a sparse
    :class:`~ccfindr_tpu_torch.ops.sparse.Shards` layout in order, the
    lanes (``lw`` and ``rest``: factors and flags replicated over the
    shards, or None) moved to the shard's device; the outputs come back
    to ``lw``'s device, but for those at the indices ``cols`` (the
    H-side outputs) where ``lh`` is given as cell shards: those stay on
    their shard's device.  In :func:`_blocks`'s three stages."""
    dev = lw.device
    keep = isinstance(lh, HShards)
    if keep:
        hshards.check(lh, x)
        lh_of = list(lh)
    else:
        lh_of = [lh[..., c * x.m:(c + 1) * x.m] for c in range(len(x))]
    work = [(tc, lh_of[c].to(tc.device).contiguous(),
             [_to(t, tc.device) for t in (lw,) + rest])
            for c, tc in enumerate(x)]
    res = [fn(tc, lh_c, *rest_c) for tc, lh_c, rest_c in work]
    del work
    return [tuple(t if keep and i in cols else t.to(dev)
                  for i, t in enumerate(r)) for r in res]


def _join(parts, lh):
    """Cell shards' H-side outputs: kept as shards where ``lh`` came as
    shards, else joined on the lanes' device."""
    return HShards(parts) if isinstance(lh, HShards) else torch.cat(parts, -1)


def _sparse_fused(x, lw, lh, local):
    """The sparse VB pass over cell shards: ``swn`` and the folded data
    terms added in shard order, ``shn`` cell-local."""
    swn, shn, dterm = None, [], None
    for sw, sh, dt in local:
        swn = _add(swn, sw)
        shn.append(sh)
        dterm = _add(dterm, dt)
    return swn, _join(shn, lh), dterm


def make_sparse_fused_sharded(mesh, chunk: int = 1 << 16):
    """Fused sparse function for ``ops.vb.vb_run(fused=...)`` over a
    cell-sharded mesh: ``ops.sparse.fused_coo`` (S1/S2 on the card) on
    each shard of ``from_scipy_sharded``'s layout; ``swn`` and the data
    term added in shard order, ``shn`` cell-local."""
    from ..ops import sparse as sk

    def fused(x, lw, lh):
        _grid(mesh, x)
        return _sparse_fused(x, lw, lh, _cell_shards(
            x, lambda tc, lh_c, lw_d: sk.fused_coo(tc, lw_d, lh_c,
                                                   chunk=chunk), lh, lw,
            cols=(1,)))

    return fused


def make_ell_fused_sharded(mesh):
    """Fused function for ``ops.vb.vb_run(fused=...)`` over a
    cell-sharded mesh: ``ops.ell.fused_ell`` (S1/S2 over each shard's
    CSR view) on each shard of ``from_scipy_ell_sharded``'s layout;
    ``swn`` and the data term added in shard order, ``shn``
    cell-local."""
    from ..ops import ell as ek

    def fused(x, lw, lh):
        _grid(mesh, x)
        return _sparse_fused(x, lw, lh, _cell_shards(
            x, lambda ec, lh_c, lw_d: ek.fused_ell(ec, lw_d, lh_c), lh, lw,
            cols=(1,)))

    return fused


def make_tile_fused_sharded(mesh, mxu_bf16: bool = False):
    """Fused sparse function for ``ops.vb.vb_run(fused=...)`` over a
    cell-sharded mesh: ``ops.tile.fused_tile`` (S1/S2) on each shard of
    ``from_scipy_tile_sharded``'s layout, with ``vb_run``'s ``do_elbo``
    flag (the ``elbo_every`` cadence) and ``mxu_bf16``
    (``precision='bf16'``); ``swn`` and the data term added in shard
    order, ``shn`` cell-local."""
    from ..ops import tile as tl

    def fused(x, lw, lh, do_elbo=None):
        _grid(mesh, x)
        return _sparse_fused(x, lw, lh, _cell_shards(
            x, lambda tc, lh_c, lw_d, de: tl.fused_tile(
                tc, lw_d, lh_c, do_elbo=de, mxu_bf16=mxu_bf16),
            lh, lw, do_elbo, cols=(1,)))

    return fused


def make_tile_ml_sharded(mesh):
    """``(fused_h, fused_w)`` for ``ops.ml.ml_run`` over a cell-sharded
    sparse layout: ``ops.tile.tile_ml_h``/``tile_ml_w`` (S1/S2) a shard;
    the H numerator stays cell-local, ``x log wh`` and the W numerator
    are added in shard order."""
    from ..ops import tile as tl

    def fused_h(x, w, h):
        _grid(mesh, x, genes=False)
        hn, xlw = [], None
        for hn_c, xl in _cell_shards(
                x, lambda tc, h_c, w_d: tl.tile_ml_h(tc, w_d, h_c), h, w,
                cols=(0,)):
            hn.append(hn_c)
            xlw = _add(xlw, xl)
        return _join(hn, h), xlw

    def fused_w(x, w, h):
        _grid(mesh, x, genes=False)
        wn = None
        for (part,) in _cell_shards(
                x, lambda tc, h_c, w_d: (tl.tile_ml_w(tc, w_d, h_c),), h, w):
            wn = _add(wn, part)
        return wn

    return fused_h, fused_w


def _ml_block_pair(mesh, h_fn, w_fn):
    """``(fused_h, fused_w)`` over the blocks of a :class:`ShardedCounts`
    laid out on ``mesh``'s grid, from a block's ``h_fn(x, w, h) -> (hn,
    xlw)`` and ``w_fn(x, w, h) -> wn``: ``hn`` added over gene shards
    (cell-local), ``x log wh`` over all blocks, ``wn`` over cell shards,
    in shard order."""
    def fused_h(x, w, h):
        _grid(mesh, x, genes=False)
        _, hn, xlw = _fold_blocks(_blocks(
            x, lambda *a: (None,) + tuple(h_fn(*a)), w, h), lh=h)
        return hn, xlw

    def fused_w(x, w, h):
        _grid(mesh, x, genes=False)
        return _fold_blocks(_blocks(
            x, lambda *a: (w_fn(*a), None, None), w, h))[0]

    return fused_h, fused_w


def make_ml_sharded(mesh, bn: int = None, bm: int = None):
    """``(fused_h, fused_w)`` for ``ops.ml.ml_run`` over a mesh: M1/M2
    (``ops.kernels.ml.ml_h_pallas``/``ml_w_pallas``) on each block of a
    :class:`ShardedCounts`; the H numerator and H stay cell-local, the W
    numerator and ``x log wh`` are added in shard order.  ``bn``/``bm``
    (the JAX tiles) are accepted and not used."""
    from ..ops.kernels import ml as mlk

    return _ml_block_pair(mesh, mlk.ml_h_pallas, mlk.ml_w_pallas)


def ml_dense_sharded(mesh):
    """``(fused_h, fused_w)`` of ``ops.ml.ml_h_dense``/``ml_w_dense``
    over the blocks of a :class:`ShardedCounts` (``factorize``'s
    ``'dense'`` and ``'dense_fused'`` on a mesh)."""
    from ..ops import ml as ml_ops

    return _ml_block_pair(mesh, ml_ops.ml_h_dense, ml_ops.ml_w_dense)


def make_pass2_sharded(mesh):
    """``(suffstats, data_term)`` for ``ops.vb.vb_run`` over a mesh
    (``backend='pallas2pass'``; a port addition, the JAX package lets
    GSPMD split its two passes): P1 + E1s and P2
    (``vb_kernels.suffstats_pallas_padded``, ``elbo_data_pallas_padded``)
    on each block of a :class:`ShardedCounts`, P1's gene chunk from the
    block's extents and the rank alone; the partials added in shard
    order."""
    from ..ops.kernels import vb_kernels as vbk

    # the padded functions' JAX tile keywords, which they do not use
    tiles = dict(bn=vbk.DEFAULT_BN, bm=vbk.DEFAULT_BM)

    def ss_block(x, lw, lh):
        nb, n, r = lw.shape
        m = lh.shape[-1]
        chunk = vbk.pass2_chunk(x, n, m, 1, r, lw.element_size())
        return vbk.suffstats_pallas_padded(x, lw, lh, n=n, m=m, r=r,
                                           chunk=chunk, **tiles)

    def dt_block(x, lw, lh):
        _, n, r = lw.shape
        return None, None, vbk.elbo_data_pallas_padded(
            x, lw, lh, n=n, m=lh.shape[-1], r=r, **tiles)

    def suffstats(x, lw, lh):
        _grid(mesh, x)
        swn, shn, _ = _fold_blocks(_blocks(
            x, lambda *a: tuple(ss_block(*a)) + (None,), lw, lh), lw, lh)
        return hmap(torch.mul, lw, swn), hmap(torch.mul, lh, shn)

    def data_term(x, lw, lh):
        _grid(mesh, x)
        return _fold_blocks(_blocks(x, dt_block, lw, lh))[2]

    return suffstats, data_term
