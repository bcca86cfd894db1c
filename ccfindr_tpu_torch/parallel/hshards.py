"""The mesh's state as its shards, as the JAX driver's ``_place_sharded``
lays it out: the H family by cells (``P(runs, None, cells)``), the W
family by genes (``P(runs, genes, None)``).

An H-family tensor (``eh``, ``lh``, ``dh``, the ``shn`` of a pass, the
ML ``h`` and its cluster ids, a mesh's ``cell_mask``: anything whose
last axis is the cells) is carried on a mesh as an :class:`HShards` of
axis -1: its cell shards in shard order, each contiguous on the device
of its shard of X (``ShardedCounts.devices[0, c]``, or the c-th layout
of a sparse ``Shards``).  On a mesh with ``genes > 1`` a W-family
tensor (``ew``, ``lw``, ``dw``, the ``swn`` of a pass: anything whose
axis -2 is the genes; the gene mask as its column ``(n, 1)``) is an
HShards of axis -2: its gene shards, shard g over ``ShardedCounts.rows[g]``
on the device of its gene row's first block, ``devices[g, 0]``.  The
hypers and the per-lane scalars stay on the reduce device, the runs
row's first device, which holds the first shard of each family.

* :func:`hmap` runs a function on every shard, the other tensors it
  takes copied to each shard's device first, then every shard's work
  issued, so that no copy waits behind another shard's work; it refuses
  cell shards and gene shards in one call;
* :func:`hsum` is ``utils.lane_sum`` over the cells (cell shards) or
  over the genes and ranks together (gene shards), :func:`colsum` is
  ``utils.lane_colsum`` over the genes: each shard gives the first two
  levels of the sum's 32-wide tree (``utils.lane_partials``; a gene
  shard of a row-major (n, r) tensor is a contiguous piece of its
  flattened rows, and its column sums run over the transposed shard),
  and the reduce device finishes the tree over them in shard order.
  Where every shard spans a multiple of 1,024 cells or genes, these are
  the sums of the joined tensor, bit for bit (the sums over the cells
  alone, and those over the genes and ranks together, also with a
  ragged last shard; those over the rank rows and the cells together
  need the rows to start on a multiple of 1,024); a lone shard takes
  the whole sum itself;
* :func:`shard_h`/:func:`shard_w`/:func:`gather` lay a joined tensor out
  and join it again (the starts, the results, the checkpoints);
* :func:`take`/:func:`put`/:func:`like` select and write lanes and lay
  a host array out like a carry, for lane compaction and resume.

A plain tensor passes through each of them as it did before the mesh
carried shards: ``hmap(fn, t)`` is ``fn(t)``, ``hsum(t, k, dev)`` is
``lane_sum(t, k)``.  A shard on a device other than its layout's raises;
nothing joins the shards to carry on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lane_colsum, lane_partials, lane_sum

CELLS, GENES = -1, -2
_AXIS_NAME = {CELLS: "cell", GENES: "gene"}


class HShards(tuple):
    """A mesh-state tensor as its shards along ``axis`` (-1: the cells
    of an H-family tensor (..., m); -2: the genes of a W-family tensor
    (..., n, r)), in shard order, each on its shard's device."""

    def __new__(cls, parts, axis=CELLS):
        parts = tuple(parts)
        if not parts:
            raise ValueError("an HShards holds one shard at least")
        if axis not in _AXIS_NAME:
            raise ValueError(f"shards split axis -1 (cells) or -2 (genes), "
                             f"not {axis}")
        self = super().__new__(cls, parts)
        self.axis = axis
        return self

    @property
    def shape(self):
        """The joined tensor's shape."""
        s = list(self[0].shape)
        s[self.axis] = sum(p.shape[self.axis] for p in self)
        return torch.Size(s)

    @property
    def dtype(self):
        return self[0].dtype

    @property
    def devices(self):
        return [p.device for p in self]

    def clone(self):
        return self.map(lambda p: p.clone())

    def map(self, fn):
        """``fn`` on every shard, as shards on the same axis."""
        return HShards((fn(p) for p in self), self.axis)


def home(t):
    """The device of a tensor, or of the first of its shards (the reduce
    device: the runs row's first device holds the first shard of either
    axis)."""
    return t[0].device if isinstance(t, HShards) else t.device


def _device(d):
    """``d`` as the device a tensor placed there reports (a CUDA device
    named without its index is the current one)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def cell_layout(x):
    """``[((c0, c1), device), ...]``: each cell shard's columns and
    device, of a ``parallel.sharded.ShardedCounts`` (its gene-shard-0
    row) or a sparse ``ops.sparse.Shards`` layout."""
    if hasattr(x, "cols"):
        return [(cols, _device(d)) for cols, d in zip(x.cols, x.devices[0])]
    return [((c * x.m, (c + 1) * x.m), _device(s.device))
            for c, s in enumerate(x)]


def gene_layout(x):
    """``[((g0, g1), device), ...]``: each gene shard's rows and device,
    the first block of its gene row (``devices[g, 0]``), of a
    ``parallel.sharded.ShardedCounts`` (the sparse layouts shard cells
    only)."""
    return [(rows, _device(d)) for rows, d in zip(x.rows, x.devices[:, 0])]


def gene_sharded(x):
    """True where ``x`` (a layout) splits the genes over several
    shards, and the mesh carries the W family as gene shards."""
    return hasattr(x, "rows") and len(x.rows) > 1


def layout(axis, x):
    """:func:`cell_layout` or :func:`gene_layout` of ``x`` by ``axis``."""
    return cell_layout(x) if axis == CELLS else gene_layout(x)


def cut(a, axis, a0, a1):
    """``a``'s entries a0:a1 along ``axis`` (-1 or -2), a tensor or an
    array."""
    return a[(Ellipsis, slice(a0, a1)) + (slice(None),) * (-1 - axis)]


def _shard(t, x, axis):
    return HShards((torch.empty_like(cut(t, axis, a0, a1), device=d,
                                     memory_format=torch.contiguous_format)
                    .copy_(cut(t, axis, a0, a1))
                    for (a0, a1), d in layout(axis, x)), axis)


def shard_h(t, x):
    """``t`` (..., m) laid out as ``x``'s cell shards: an
    :class:`HShards`, each shard a contiguous copy on its device (a
    shard on the joined tensor's own device is a copy too, so that the
    carry never aliases the caller's tensor)."""
    return _shard(t, x, CELLS)


def shard_w(t, x):
    """``t`` (..., n, r) laid out as ``x``'s gene shards (each a
    contiguous copy on ``devices[g, 0]``), as :func:`shard_h` lays out
    the cells; the gene mask goes as its column ``(n, 1)``."""
    return _shard(t, x, GENES)


def check(t, x):
    """Raise unless the shards of ``t`` lie each on its layout shard's
    device, at its width."""
    lay = layout(t.axis, x)
    name = _AXIS_NAME[t.axis]
    fam = "H" if t.axis == CELLS else "W"
    if len(t) != len(lay):
        raise ValueError(f"{fam} carried as {len(t)} shards; the layout "
                         f"has {len(lay)}")
    for c, (p, ((a0, a1), d)) in enumerate(zip(t, lay)):
        if p.device != d:
            raise ValueError(f"{fam} shard {c} lies on {p.device}; its "
                             f"{name}s' shard of X lies on {d}")
        if p.shape[t.axis] != a1 - a0:
            raise ValueError(f"{fam} shard {c} spans {p.shape[t.axis]} "
                             f"{name}s; its shard of X spans {a1 - a0}")


def _on(a, dev, cache):
    if not isinstance(a, torch.Tensor) or a.device == dev:
        return a
    key = (id(a), dev)
    if key not in cache:
        cache[key] = a.to(dev)
    return cache[key]


def hmap(fn, *args):
    """``fn`` on each shard: the :class:`HShards` among ``args`` give
    their c-th shard, every other tensor is copied to the shard's device
    (all copies first, then every shard's ``fn``).  Returns shards on
    the same axis, or a tuple of them where ``fn`` returns a tuple (None
    stays None).  Without an HShards among ``args``, ``fn(*args)``.
    Shards of both axes in one call raise: their devices differ."""
    shards = [a for a in args if isinstance(a, HShards)]
    if not shards:
        return fn(*args)
    axis, devs = shards[0].axis, shards[0].devices
    for s in shards[1:]:
        if s.axis != axis:
            raise ValueError(f"{_AXIS_NAME[s.axis]} shards meet "
                             f"{_AXIS_NAME[axis]} shards")
        if s.devices != devs:
            raise ValueError(f"shards on {s.devices} meet shards on "
                             f"{devs}")
    cache = {}
    moved = [[a[c] if isinstance(a, HShards) else _on(a, d, cache)
              for a in args] for c, d in enumerate(devs)]
    outs = [fn(*a) for a in moved]
    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else HShards(o, axis)
                     for o in zip(*outs))
    return HShards(outs, axis)


def _finish(parts, dev, ndim=1):
    """The tree of :func:`utils.lane_sum` finished on ``dev`` over the
    shards' level-2 partials, joined in shard order."""
    return lane_sum(torch.cat([p.to(dev) for p in parts], -1), ndim)


def hsum(t, ndim, dev):
    """``utils.lane_sum(t, ndim)`` on ``dev``: a plain tensor's own sum,
    or the shards' from each shard's level-2 partials, joined on ``dev``
    in shard order and summed on up the tree (see the module docstring):
    cell shards (..., [r,] m_c) over their last ``ndim`` axes, gene
    shards (..., n_g, r) over both (``ndim`` 2)."""
    if not isinstance(t, HShards):
        return lane_sum(t, ndim)
    if len(t) == 1:
        return lane_sum(t[0], ndim).to(dev)
    if t.axis == GENES:
        if ndim != 2:
            raise ValueError("gene shards sum over the genes and ranks "
                             "together (ndim 2)")
        return _finish([lane_partials(p.flatten(-2)) for p in t], dev)
    return _finish([lane_partials(p) for p in t], dev, ndim)


def colsum(t, dev):
    """``utils.lane_colsum(t)`` (..., r) on ``dev`` of a tensor (..., n,
    r) or its gene shards: each shard's level-2 partials over its
    transposed (r, n_g), joined along the genes."""
    if not isinstance(t, HShards):
        return lane_colsum(t)
    if t.axis != GENES:
        raise ValueError("colsum runs over the genes of gene shards")
    if len(t) == 1:
        return lane_colsum(t[0]).to(dev)
    return _finish([lane_partials(p.transpose(-1, -2)) for p in t], dev)


def gather(t, dev):
    """Shards joined on ``dev`` (a plain tensor moved there)."""
    if not isinstance(t, HShards):
        return t.to(dev)
    return torch.cat([p.to(dev) for p in t], t.axis)


def to_numpy(t):
    """A tensor or its shards on the host, the shards joined there."""
    if isinstance(t, HShards):
        return np.concatenate([p.detach().cpu().numpy() for p in t], t.axis)
    return t.detach().cpu().numpy()


def take(t, sel):
    """Lanes ``sel`` (an index tensor) of a tensor or of every shard."""
    if isinstance(t, HShards):
        return t.map(lambda p: p[sel.to(p.device)])
    return t[sel.to(t.device)]


def put(t, sel, src):
    """``t[sel] = src`` on a tensor or shard by shard."""
    if isinstance(t, HShards):
        for p, s in zip(t, src):
            p[sel.to(p.device)] = s
    else:
        t[sel.to(t.device)] = src


def lanes(t, sl):
    """Leading-axis slice ``sl`` of a tensor or of every shard."""
    if isinstance(t, HShards):
        return t.map(lambda p: p[sl])
    return t[sl]


def like(a, ref):
    """The host array ``a`` laid out as ``ref``: split into ``ref``'s
    shards on their devices, or one tensor on ``ref``'s device."""
    if isinstance(ref, HShards):
        at = np.cumsum([0] + [p.shape[ref.axis] for p in ref])
        return HShards((torch.as_tensor(np.ascontiguousarray(
            cut(a, ref.axis, a0, a1)), device=p.device)
            for p, a0, a1 in zip(ref, at, at[1:])), ref.axis)
    return torch.as_tensor(a, device=ref.device)


def move(t, devs):
    """Shards with shard c moved to ``devs[c]`` (another runs row's
    shard devices)."""
    return HShards((p.to(d) for p, d in zip(t, devs)), t.axis)


def cat_lanes(parts, devs):
    """Shards of lane groups joined along the lanes, shard by shard on
    ``devs`` (one group: itself)."""
    if len(parts) == 1:
        return parts[0]
    return HShards((torch.cat([p[c].to(d) for p in parts])
                    for c, d in enumerate(devs)), parts[0].axis)
