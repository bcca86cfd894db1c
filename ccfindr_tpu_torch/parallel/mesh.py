"""Device grids for the cell-sharded runs, and the process group.

Counterpart of ``ccfindr_tpu/parallel/mesh.py``.  The JAX package lays
a run out on a ``jax.sharding.Mesh`` and lets GSPMD insert the
cross-device sums.  Here a mesh is a (runs, genes, cells) grid of
``torch.device``s that one process drives: the drivers give each
(gene, cell) block of X to its device, every kernel runs on the card
that holds its tensors (``ops.kernels.build.launch``), and every
cross-shard sum is the shards' partials added in shard order on the
row's first device, so a run gives the same bits whatever the devices.
``make_mesh()`` lays the grid over every visible card, one shard a
card; the shards of a row are issued back to back, so distinct cards
run them at once.  The runs rows run one after the other, also on
distinct cards (rows at once, a host thread a row, were measured
slower on one card and on four).  A device may also be listed more
than once:
``make_mesh(cells=4, devices=["cuda:0"] * 4)`` runs four cell shards
one after the other on one card, and ``devices=["cpu"] * 4`` on the
host.  Over several processes (``init_distributed``) each process lays
its share of the lanes over a mesh of its own, on its own card where
it is given one.
"""

from __future__ import annotations

import numpy as np
import torch

AXES = ("runs", "genes", "cells")


class Mesh:
    """A (runs, genes, cells) grid of devices.

    ``devices`` is the numpy object array of ``torch.device``s,
    ``shape`` the axis sizes by name, as ``jax.sharding.Mesh`` gives
    them."""

    axis_names = AXES

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 3:
            raise ValueError("a mesh is a (runs, genes, cells) grid")
        # a shard runs its kernels or their plain versions by the type of
        # its device, so one mesh holds one type
        if len({torch.device(d).type for d in devices.flat}) > 1:
            raise ValueError("a mesh's devices must all be of one type "
                             "(all CUDA devices or all 'cpu')")
        self.devices = devices

    @property
    def shape(self):
        return dict(zip(AXES, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(runs: int = 1, cells: int | None = None, genes: int = 1,
              devices=None) -> Mesh:
    """Build a ('runs', 'genes', 'cells') mesh over ``devices`` (default:
    every CUDA device).

    ``runs`` splits the (rank, restart) lane batch into contiguous
    groups, ``cells`` the cell axis of X and H, ``genes`` the gene axis
    of X and W.  Defaults: genes=1, the remaining devices on cells.
    The counts must multiply to the number of devices, as in the JAX
    package; a device may appear several times (its shards then run one
    after the other on it), and all must be of one type."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if cells is None:
        if n % (runs * genes) != 0:
            raise ValueError(
                f"{n} devices not divisible by runs*genes="
                f"{runs * genes}")
        cells = n // (runs * genes)
    if runs * genes * cells != n:
        raise ValueError(f"runs*genes*cells = {runs * genes * cells} "
                         f"!= {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(runs, genes, cells))


def cell_sharding(mesh: Mesh, kind: str) -> tuple:
    """The mesh axis of each array axis of the common layouts, as the
    JAX package's PartitionSpecs give them: 'x' (genes x cells), 'w'
    (the W family, replicated over cells), 'h' (r x cells), the batched
    'bw'/'bh' with a leading runs axis, 'scalar' and 'bscalar'."""
    g = "genes" if "genes" in mesh.axis_names else None
    return {
        "x": (g, "cells"),
        "w": (g, None),
        "h": (None, "cells"),
        "bw": ("runs", g, None),
        "bh": ("runs", None, "cells"),
        "scalar": (),
        "bscalar": ("runs",),
    }[kind]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join a group of ``num_processes`` processes; returns True.

    One process (``num_processes`` None or 1) is a no-op returning
    False.  Otherwise the default ``torch.distributed`` group forms over
    gloo at ``coordinator_address`` (``"host:port"``, process 0 serves
    it), with this process as rank ``process_id``.  What the drivers
    exchange (``parallel.schedule``) is host numpy, so the group is
    gloo's, and several processes may share one card.  A group that
    cannot form raises; the run never carries on as one process."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"a group of {num_processes} processes needs "
            "coordinator_address ('host:port') and process_id")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    return True
