"""Work scheduling for rank scans over several processes.

Counterpart of ``ccfindr_tpu/parallel/schedule.py`` (the reference's
Rmpi restart farm, ``Rmpi::mpi.applyLB``, R/bayesian.R:260-263): the
(rank, run) grid is statically partitioned across processes, each runs
its share as one lane batch on its own device, and the per-item results
(log evidences, sweep counts, cluster ids) are all-gathered so that
every process makes the identical best-of-runs selection; the winning
factors are then broadcast from their owner.

The exchanges move host numpy arrays through ``torch.distributed`` on
its default process group (``parallel.mesh.init_distributed``, gloo):
each array crosses as a CPU tensor of its own dtype, so its bits arrive
unchanged.  Numpy in, numpy out, with the JAX package's signatures.
"""

from __future__ import annotations

import numpy as np
import torch


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def partition_items(n_items: int, n_procs: int, proc_id: int
                    ) -> np.ndarray:
    """Indices of the work items owned by ``proc_id``: round-robin, so
    that the (rank, run) items of one rank spread across processes
    (ranks differ in cost; round-robin balances them)."""
    return np.arange(proc_id, n_items, n_procs)


def rank_run_grid(ranks, nrun: int) -> list[tuple[int, int]]:
    """The flattened (rank, run) work grid, rank-major."""
    return [(r, i) for r in ranks for i in range(nrun)]


def gather_results(local_values: np.ndarray, local_idx: np.ndarray,
                   n_items: int, fill=-np.inf, process_count=None):
    """All-gather scalar per-item results across processes.

    Each item is owned by exactly one process (:func:`partition_items`),
    so the elementwise max over the gathered (procs, n_items) table is
    the full vector; ``fill`` must be below any real value.  One process
    scatters its values into the global slots."""
    if process_count is None:
        process_count = _world_size()
    out = np.full(n_items, fill, dtype=np.float64)
    out[np.asarray(local_idx, dtype=np.int64)] = local_values
    if process_count == 1:
        return out
    gathered = _allgather(out)             # (procs, n_items)
    return np.max(gathered, axis=0)


def gather_rows(local_rows, local_idx, n_items: int, row_len: int,
                process_count=None):
    """All-gather per-item int32 vector results (the per-restart hard
    cluster assignments the ML consensus needs, m each).  Non-owners
    contribute zero rows, so the sum over the gathered (procs, n_items,
    row_len) table is the full matrix."""
    if process_count is None:
        process_count = _world_size()
    out = np.zeros((n_items, row_len), np.int32)
    if len(local_idx):
        out[np.asarray(local_idx, dtype=np.int64)] = local_rows
    if process_count == 1:
        return out
    gathered = _allgather(out)             # (procs, n_items, row_len)
    return gathered.sum(axis=0, dtype=np.int32)


def _allgather(arr: np.ndarray) -> np.ndarray:
    """The all-gather seam (tests patch it): ``arr`` from every process
    of the default group, stacked as ``(procs, *arr.shape)`` in rank
    order, in ``arr``'s dtype."""
    dist = torch.distributed
    t = torch.from_numpy(np.ascontiguousarray(arr))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def _broadcast(arr: np.ndarray, src: int) -> np.ndarray:
    """The broadcast seam (tests patch it): process ``src``'s ``arr`` on
    every process of the default group, in ``arr``'s dtype.  The bytes
    cross in C order on every process, whatever ``arr``'s strides."""
    t = torch.from_numpy(np.array(arr, order="C"))
    torch.distributed.broadcast(t, src=src)
    return t.numpy()


def exchange_winner(tree_or_zeros, is_owner: bool, owner: int,
                    process_count=None):
    """Replicate the winning (best-evidence) factors to every process.

    ``tree_or_zeros`` is a dict of numpy arrays, the same shapes and
    dtypes on every process: the candidate on the owner, zeros elsewhere.
    Each array is broadcast from the owner, so the result is identical
    everywhere, as Rmpi gathers the workers' results to the driver
    (R/bayesian.R:262-268).  (JAX's all-gathers every process's array
    and keeps the owner's row: the same result, at ``nproc`` times the
    bytes.)"""
    if process_count is None:
        process_count = _world_size()
    if process_count == 1:
        return tree_or_zeros
    return {k: _broadcast(v, owner) for k, v in tree_or_zeros.items()}
