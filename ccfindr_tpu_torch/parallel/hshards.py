"""The H family of a mesh run as its cell shards, as the JAX driver's
``_place_sharded`` lays it out (``P(runs, None, cells)``).

An H-family tensor (``eh``, ``lh``, ``dh``, the ``shn`` of a pass, the
ML ``h`` and its cluster ids, a mesh's ``cell_mask``: anything whose
last axis is the cells) is carried on a mesh as an :class:`HShards`:
its cell shards in shard order, each contiguous on the device of its
shard of X (``ShardedCounts.devices[0, c]``, or the c-th layout of a
sparse ``Shards``).  The W family, the hypers and the per-lane scalars
stay on the reduce device, the runs row's first device; the W side
reaches the shards only as what they read.

* :func:`hmap` runs a function on every shard, the other tensors it
  takes copied to each shard's device first, then every shard's work
  issued, so that no copy waits behind another shard's work;
* :func:`hsum` is ``utils.lane_sum`` over the cells: each shard gives
  the first two levels of the sum's 32-wide tree
  (``utils.lane_partials``), and the reduce device finishes the tree
  over them in shard order.  Where every shard spans a multiple of
  1,024 cells, these are the sums of the joined tensor, bit for bit (the
  sums over the cells alone also with a ragged last shard; those over
  the rank rows and the cells together need the rows to start on a
  multiple of 1,024); a lone shard takes the whole sum itself;
* :func:`shard_h`/:func:`gather` lay a joined tensor out and join it
  again (the starts, the results, the checkpoints);
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

from ..utils import lane_partials, lane_sum


class HShards(tuple):
    """An H-family tensor (..., m) as its cell shards (..., m_c), in
    shard order, each on its shard's device."""

    def __new__(cls, parts):
        parts = tuple(parts)
        if not parts:
            raise ValueError("an HShards holds one shard at least")
        return super().__new__(cls, parts)

    @property
    def shape(self):
        """The joined tensor's shape."""
        return torch.Size(self[0].shape[:-1]
                          + (sum(p.shape[-1] for p in self),))

    @property
    def dtype(self):
        return self[0].dtype

    @property
    def devices(self):
        return [p.device for p in self]

    def clone(self):
        return HShards(p.clone() for p in self)


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


def shard_h(t, x):
    """``t`` (..., m) laid out as ``x``'s cell shards: an
    :class:`HShards`, each shard a contiguous copy on its device (a
    shard on the joined tensor's own device is a copy too, so that the
    carry never aliases the caller's tensor)."""
    return HShards(torch.empty_like(t[..., c0:c1], device=d,
                                    memory_format=torch.contiguous_format)
                   .copy_(t[..., c0:c1]) for (c0, c1), d in cell_layout(x))


def check(t, x):
    """Raise unless the shards of ``t`` lie each on its layout shard's
    device, at its width."""
    lay = cell_layout(x)
    if len(t) != len(lay):
        raise ValueError(f"H carried as {len(t)} shards; the layout has "
                         f"{len(lay)}")
    for c, (p, ((c0, c1), d)) in enumerate(zip(t, lay)):
        if p.device != d:
            raise ValueError(f"H shard {c} lies on {p.device}; its cells' "
                             f"shard of X lies on {d}")
        if p.shape[-1] != c1 - c0:
            raise ValueError(f"H shard {c} spans {p.shape[-1]} cells; its "
                             f"shard of X spans {c1 - c0}")


def _on(a, dev, cache):
    if not isinstance(a, torch.Tensor) or a.device == dev:
        return a
    key = (id(a), dev)
    if key not in cache:
        cache[key] = a.to(dev)
    return cache[key]


def hmap(fn, *args):
    """``fn`` on each cell shard: the :class:`HShards` among ``args``
    give their c-th shard, every other tensor is copied to the shard's
    device (all copies first, then every shard's ``fn``).  Returns an
    HShards, or a tuple of them where ``fn`` returns a tuple (None stays
    None).  Without an HShards among ``args``, ``fn(*args)``."""
    shards = [a for a in args if isinstance(a, HShards)]
    if not shards:
        return fn(*args)
    devs = shards[0].devices
    for s in shards[1:]:
        if s.devices != devs:
            raise ValueError(f"H shards on {s.devices} meet shards on "
                             f"{devs}")
    cache = {}
    moved = [[a[c] if isinstance(a, HShards) else _on(a, d, cache)
              for a in args] for c, d in enumerate(devs)]
    outs = [fn(*a) for a in moved]
    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else HShards(o)
                     for o in zip(*outs))
    return HShards(outs)


def hsum(t, ndim, dev):
    """``utils.lane_sum(t, ndim)`` on ``dev`` for ``t`` (..., [r,] m):
    a plain tensor's own sum, or an HShards' from each shard's level-2
    partials, joined on ``dev`` in shard order and summed on up the
    tree (see the module docstring)."""
    if not isinstance(t, HShards):
        return lane_sum(t, ndim)
    if len(t) == 1:
        return lane_sum(t[0], ndim).to(dev)
    parts = [lane_partials(p) for p in t]
    return lane_sum(torch.cat([p.to(dev) for p in parts], -1), ndim)


def gather(t, dev):
    """An HShards joined on ``dev`` (a plain tensor moved there)."""
    if not isinstance(t, HShards):
        return t.to(dev)
    return torch.cat([p.to(dev) for p in t], -1)


def to_numpy(t):
    """A tensor or an HShards on the host, the shards joined there."""
    if isinstance(t, HShards):
        return np.concatenate([p.detach().cpu().numpy() for p in t], -1)
    return t.detach().cpu().numpy()


def take(t, sel):
    """Lanes ``sel`` (an index tensor) of a tensor or of every shard."""
    if isinstance(t, HShards):
        return HShards(p[sel.to(p.device)] for p in t)
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
        return HShards(p[sl] for p in t)
    return t[sl]


def like(a, ref):
    """The host array ``a`` laid out as ``ref``: split into ``ref``'s
    shards on their devices, or one tensor on ``ref``'s device."""
    if isinstance(ref, HShards):
        out, at = [], 0
        for p in ref:
            w = p.shape[-1]
            out.append(torch.as_tensor(np.ascontiguousarray(
                a[..., at:at + w]), device=p.device))
            at += w
        return HShards(out)
    return torch.as_tensor(a, device=ref.device)


def move(t, devs):
    """An HShards with shard c moved to ``devs[c]`` (another runs row's
    shard devices)."""
    return HShards(p.to(d) for p, d in zip(t, devs))


def cat_lanes(parts, devs):
    """HShards of lane groups joined along the lanes, shard by shard on
    ``devs`` (one group: itself)."""
    if len(parts) == 1:
        return parts[0]
    return HShards(torch.cat([p[c].to(d) for p in parts])
                   for c, d in enumerate(devs))
