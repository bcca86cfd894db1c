"""Device grids for the cell-sharded runs, in one process.

Counterpart of ``ccfindr_tpu/parallel/mesh.py``.  The JAX package lays
a run out on a ``jax.sharding.Mesh`` and lets GSPMD insert the
cross-device sums.  Here a mesh is a (runs, genes, cells) grid of
``torch.device``s that one process drives: the drivers give each
(gene, cell) block of X to its device, and every cross-shard sum is the
shards' partials added in shard order on the row's first device, so a
run is deterministic whatever the devices.  A device may be listed more
than once: ``make_mesh(cells=4, devices=["cuda:0"] * 4)`` runs four
cell shards on one card, and ``devices=["cpu"] * 4`` on the host.
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
    package; a device may appear several times, and all must be of one
    type."""
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
    """A no-op returning False for one process.  Several processes (the
    JAX package's multi-host restart farm) are not ported yet."""
    if num_processes is None or num_processes <= 1:
        return False
    raise NotImplementedError(
        "distributed runs over several processes are not ported to "
        "ccfindr_tpu_torch yet (ROADMAP A7c)")
