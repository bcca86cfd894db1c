"""X laid out on a device grid, and the dense passes over its blocks.

Counterpart of the parts of ``ccfindr_tpu/parallel/sharded.py`` that the
dense mesh routes need.  The JAX package puts X on the mesh as one
GSPMD-sharded array, and XLA adds the cross-device sums of the dense
passes.  Here :class:`ShardedCounts` holds X as its (gene shard, cell
shard) blocks, each on its device of one runs row of the mesh, and
:func:`fused_sharded`, :func:`suffstats_sharded` and
:func:`data_term_sharded` (the hooks of ``ops.vb.vb_run``) compute each
block's products on the block's device with plain ``torch.matmul``,
then add the block partials on the row's first device in shard order:
``swn`` over cell shards, ``shn`` over gene shards.  With one block
they compute what ``ops.vb.fused_dense``, ``suffstats_dense`` and
``elbo_data_term`` compute, bit for bit.

The cell-major kernel sweep over the same layout is
``ops/kernels/sol_sharded.py``.  The gene-major and sparse mesh passes
(``make_fused_sharded`` and its siblings) are not ported yet (ROADMAP
A7b).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lane_sum, lgamma_sum


def _bounds(extent, parts):
    step = extent // parts
    return [(k * step, (k + 1) * step) for k in range(parts)]


class ShardedCounts:
    """X (n, m) on a (genes, cells) grid of devices, one runs row of a
    mesh: block (g, c) holds rows ``rows[g]`` and columns ``cols[c]`` on
    ``devices[g, c]``; a block on X's own device is a view of it, the
    others are copies.  The drivers give X from the host, so a device
    holds its own blocks and no more.

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
        self.lgx = lgamma_sum(x, self.device)
        self.val = x[x != 0].cpu()

    def shard_h(self, t):
        """An H-family tensor (..., m) as its cell shards, each
        contiguous on its shard's device (the gene-shard-0 row)."""
        return tuple(t[..., c0:c1].to(self.devices[0, c]).contiguous()
                     for c, (c0, c1) in enumerate(self.cols))

    def gather_h(self, parts):
        """Inverse of :meth:`shard_h`: the shards in order, joined on
        :attr:`device`."""
        return torch.cat([p.to(self.device) for p in parts], -1)


def place_counts(x, mesh):
    """X laid out once on each runs row of ``mesh``: a list of
    :class:`ShardedCounts`, one a row."""
    return [ShardedCounts(x, row) for row in mesh.devices]


def _mT(a):
    return a.transpose(-1, -2)


def _xpass(x: ShardedCounts, lw, lh, with_xlog=True):
    """The dense X pass block by block: (swn, shn, sum x log(wth) or
    None), the block partials added in shard order on lw's device."""
    dev = lw.device
    swn = [None] * len(x.rows)
    shn = [None] * len(x.cols)
    xlog = None
    for g, (g0, g1) in enumerate(x.rows):
        for c, (c0, c1) in enumerate(x.cols):
            xb = x.blocks[g][c]
            d = xb.device
            lwg = lw[..., g0:g1, :].to(d)
            lhc = lh[..., c0:c1].to(d)
            xf = xb.to(lw.dtype)
            wth = lwg @ lhc
            u = xf / wth
            sw = (u @ _mT(lhc)).to(dev)
            sh = (_mT(lwg) @ u).to(dev)
            swn[g] = sw if c == 0 else swn[g] + sw
            shn[c] = sh if g == 0 else shn[c] + sh
            if with_xlog:
                xl = lane_sum(xf * torch.log(wth), 2).to(dev)
                xlog = xl if xlog is None else xlog + xl
    return torch.cat(swn, -2), torch.cat(shn, -1), xlog


def fused_sharded(x: ShardedCounts, lw, lh):
    """``ops.vb.fused_dense`` over the blocks: (swn, shn, dterm)."""
    swn, shn, xlog = _xpass(x, lw, lh)
    dterm = (-(lane_sum(swn * (lw * torch.log(lw)), 2)
               + lane_sum(shn * (lh * torch.log(lh)), 2)) + xlog)
    return swn, shn, dterm


def suffstats_sharded(x: ShardedCounts, lw, lh):
    """``ops.vb.suffstats_dense`` over the blocks: (sw, sh)."""
    swn, shn, _ = _xpass(x, lw, lh, with_xlog=False)
    return lw * swn, lh * shn


def data_term_sharded(x: ShardedCounts, lw, lh):
    """``ops.vb.elbo_data_term`` over the blocks: (B,)."""
    return fused_sharded(x, lw, lh)[2]
