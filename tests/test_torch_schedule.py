"""``ccfindr_tpu_torch.parallel.schedule`` against
``ccfindr_tpu.parallel.schedule``: every function on the same numpy
inputs, for one process and for 2 and 3 simulated processes, with both
modules' ``_allgather`` seams patched the same way (the seam hands each
process the stack of every process's array, as the group would).
Results must be equal, values and dtypes.
"""

import numpy as np
import pytest

from ccfindr_tpu.parallel import schedule as js
from ccfindr_tpu_torch.parallel import schedule as ts


def _grid(nproc, n_items, seed):
    """Each process's share and the values it holds for it."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 10.0, size=n_items)     # above every fill
    rows = rng.integers(0, 7, size=(n_items, 5)).astype(np.int32)
    shares = [js.partition_items(n_items, nproc, p) for p in range(nproc)]
    return vals, rows, shares


def _patch_seams(monkeypatch, stacked):
    """Both seams return ``stacked[key]`` for the array they are given,
    found by its shape and dtype (one exchange a key)."""
    def fake(arr):
        return stacked[(arr.shape, np.asarray(arr).dtype.str)]

    monkeypatch.setattr(js, "_allgather", fake)
    monkeypatch.setattr(ts, "_allgather", fake)


@pytest.mark.parametrize("n_items,nproc,pid", [
    (9, 1, 0), (9, 2, 0), (9, 2, 1), (7, 3, 2), (2, 3, 2), (0, 2, 1)])
def test_partition_items(n_items, nproc, pid):
    a = js.partition_items(n_items, nproc, pid)
    b = ts.partition_items(n_items, nproc, pid)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype


@pytest.mark.parametrize("ranks,nrun", [([2, 3, 4], 3), ([5], 1), ([], 2)])
def test_rank_run_grid(ranks, nrun):
    assert ts.rank_run_grid(ranks, nrun) == js.rank_run_grid(ranks, nrun)


@pytest.mark.parametrize("nproc", [1, 2, 3])
@pytest.mark.parametrize("fill", [-np.inf, -1.0])
def test_gather_results(monkeypatch, nproc, fill):
    n_items = 8
    vals, _, shares = _grid(nproc, n_items, seed=nproc)
    local = [np.full(n_items, fill) for _ in range(nproc)]
    for p, idx in enumerate(shares):
        local[p][idx] = vals[idx]
    _patch_seams(monkeypatch, {((n_items,), "<f8"): np.stack(local)})
    for p, idx in enumerate(shares):
        a = js.gather_results(vals[idx], idx, n_items, fill=fill,
                              process_count=nproc)
        b = ts.gather_results(vals[idx], idx, n_items, fill=fill,
                              process_count=nproc)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
        if nproc > 1:
            np.testing.assert_array_equal(b, vals)


@pytest.mark.parametrize("nproc", [1, 2, 3])
def test_gather_rows(monkeypatch, nproc):
    n_items, row_len = 4, 5
    _, rows, shares = _grid(nproc, n_items, seed=10 + nproc)
    local = [np.zeros((n_items, row_len), np.int32) for _ in range(nproc)]
    for p, idx in enumerate(shares):
        local[p][idx] = rows[idx]
    _patch_seams(monkeypatch,
                 {((n_items, row_len), "<i4"): np.stack(local)})
    for p, idx in enumerate(shares):
        a = js.gather_rows(rows[idx], idx, n_items, row_len,
                           process_count=nproc)
        b = ts.gather_rows(rows[idx], idx, n_items, row_len,
                           process_count=nproc)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
        if nproc > 1:
            np.testing.assert_array_equal(b, rows)


@pytest.mark.parametrize("nproc,owner", [(1, 0), (2, 1), (3, 0), (3, 2)])
def test_exchange_winner(monkeypatch, nproc, owner):
    """JAX's all-gather and owner's row against the port's broadcast
    from the owner (its seam hands back the owner's array)."""
    rng = np.random.default_rng(owner)
    win = dict(w=rng.normal(size=(6, 3)).astype(np.float32),
               hyper=rng.normal(size=4))
    trees = [win if p == owner else
             {k: np.zeros_like(v) for k, v in win.items()}
             for p in range(nproc)]
    _patch_seams(monkeypatch, {
        (v.shape, v.dtype.str): np.stack([t[k] for t in trees])
        for k, v in win.items()})
    srcs = []

    def bcast(arr, src):
        srcs.append(src)
        return next(np.array(v) for v in trees[src].values()
                    if v.shape == arr.shape and v.dtype == arr.dtype)

    monkeypatch.setattr(ts, "_broadcast", bcast)
    for p in range(nproc):
        a = js.exchange_winner(trees[p], p == owner, owner,
                               process_count=nproc)
        b = ts.exchange_winner(trees[p], p == owner, owner,
                               process_count=nproc)
        assert set(a) == set(b) == set(win)
        for k in win:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
            np.testing.assert_array_equal(b[k], win[k])
            assert b[k].dtype == win[k].dtype
    assert set(srcs) <= {owner}
    assert len(srcs) == (0 if nproc == 1 else nproc * len(win))


def test_exchange_winner_only_broadcasts(monkeypatch):
    """The winner crosses once an array, from its owner: no all-gather."""
    def refuse(arr):
        raise AssertionError("exchange_winner all-gathered")

    calls = []

    def bcast(arr, src):
        calls.append((arr.shape, arr.dtype, src))
        return np.full_like(arr, 7.0)

    monkeypatch.setattr(ts, "_allgather", refuse)
    monkeypatch.setattr(ts, "_broadcast", bcast)
    tree = dict(w=np.zeros((2, 3), np.float32), hyper=np.zeros(4))
    got = ts.exchange_winner(tree, False, 1, process_count=3)
    assert calls == [((2, 3), np.float32, 1), ((4,), np.float64, 1)]
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k], np.full_like(v, 7.0))
        assert got[k].dtype == v.dtype


_WINNER_PEER = """
import sys, numpy as np, ccfindr_tpu_torch as ct
from ccfindr_tpu_torch.parallel import schedule
pid = int(sys.argv[2])
assert ct.init_distributed(sys.argv[1], 2, pid) is True
w = np.arange(12, dtype=np.float32).reshape(3, 4).T      # Fortran order
tree = dict(w=w if pid == 1 else np.zeros((4, 3), np.float32),
            hyper=np.array([0.1, 0.2, 0.3, 0.4]) * (pid == 1))
got = schedule.exchange_winner(tree, pid == 1, 1)
assert got["w"].dtype == np.float32 and got["hyper"].dtype == np.float64
assert np.array_equal(got["w"], w), got["w"]
assert np.array_equal(got["hyper"], [0.1, 0.2, 0.3, 0.4]), got["hyper"]
print("winner ok", flush=True)
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def test_exchange_winner_over_gloo():
    """Two real processes in a gloo group: the owner's arrays, one of
    them in Fortran order, arrive on both with their values and dtypes
    (the broadcast moves C-order bytes)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WINNER_PEER, f"127.0.0.1:{port}", str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(2)]
    try:
        logs = [pr.communicate(timeout=120)[0] for pr in procs]
    finally:
        for pr in procs:
            pr.kill()
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, log
        assert "winner ok" in log, log


def test_process_count_defaults_to_the_group():
    """With no group initialised the port counts one process, as JAX's
    process_count() does in one process."""
    import jax

    assert jax.process_count() == 1
    vals = np.array([1.5, 2.5])
    np.testing.assert_array_equal(
        ts.gather_results(vals, np.arange(2), 2),
        js.gather_results(vals, np.arange(2), 2))
    tree = dict(w=np.ones((2, 2)))
    assert ts.exchange_winner(tree, True, 0) is tree


def threads_as_processes(nproc, fn, *modules):
    """``[fn(pid) for pid in range(nproc)]`` run at once, a thread each,
    standing for ``nproc`` processes: the ``_allgather`` seam of every
    schedule module in ``modules`` stacks the threads' arrays in pid
    order behind a barrier, as the group's all-gather would, and the
    port's ``_broadcast`` seam hands every thread the source's array.
    The seams are put back after; an exception in a thread is raised
    here."""
    import threading

    bar = threading.Barrier(nproc, timeout=120)
    slots = [None] * nproc
    tls = threading.local()

    def allgather(arr):
        slots[tls.pid] = np.array(arr)
        bar.wait()
        out = np.stack(slots)
        bar.wait()
        return out

    def broadcast(arr, src):
        return allgather(arr)[src]

    results, errors = [None] * nproc, []

    def body(pid):
        tls.pid = pid
        try:
            results[pid] = fn(pid)
        except BaseException as exc:       # noqa: BLE001 - re-raised below
            errors.append(exc)
            bar.abort()

    seams = [(m, name, f) for m in modules
             for name, f in (("_allgather", allgather),
                             ("_broadcast", broadcast)) if hasattr(m, name)]
    saved = [getattr(m, name) for m, name, _ in seams]
    for m, name, f in seams:
        setattr(m, name, f)
    try:
        threads = [threading.Thread(target=body, args=(p,))
                   for p in range(nproc)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for (m, name, _), f in zip(seams, saved):
            setattr(m, name, f)
    if errors:
        raise errors[0]
    return results


def test_threads_as_processes_gathers_in_pid_order():
    got = threads_as_processes(
        3, lambda p: ts.gather_results(np.array([10.0 + p]), [p], 3,
                                       process_count=3), ts)
    for g in got:
        np.testing.assert_array_equal(g, [10.0, 11.0, 12.0])
    assert ts._allgather.__name__ == "_allgather"
    assert ts._broadcast.__name__ == "_broadcast"
