"""Variational-Bayes factorization driver in PyTorch.

Counterpart of ``ccfindr_tpu.drivers.vb_driver.vb_factorize``
(reference vb_factorize / vb_iterate, R/bayesian.R:229-390):

* restarts and ranks are an explicit lane axis: the batched rank scan
  pads every (rank, run) lane to ``max(ranks)`` with prefix rank masks
  and runs them as one lane batch; the sequential loop runs one rank's
  ``nrun`` restarts at a time;
* ``backend='pallas'`` runs the sweep as the CUDA kernels of
  :mod:`ccfindr_tpu_torch.ops.kernels.sol` on the card (their plain
  PyTorch version on the CPU), or, on the gene panels for which the
  JAX driver picks its gene-major sweep (above 65,536 genes), those of
  :mod:`ccfindr_tpu_torch.ops.kernels.epilogue`; ``'pallas2pass'`` runs
  the two passes of :mod:`ccfindr_tpu_torch.ops.kernels.vb_kernels`
  (P1/P2) in ``ops.vb.vb_run``; ``backend='sparse'`` keeps X as its
  nonzeros and runs the sweep as the CUDA kernels of
  :mod:`ccfindr_tpu_torch.ops.kernels.sparse`; ``'dense'`` and
  ``'dense_fused'`` are the matmul parity paths of
  :mod:`ccfindr_tpu_torch.ops.vb`;
* ``mesh`` (``parallel.mesh.make_mesh``) pads the cell and gene axes
  to the mesh as the JAX driver does, lays X out on each runs row of
  the mesh (``parallel.sharded``) and runs contiguous groups of lanes,
  one a runs row: ``'pallas'`` with the cell-sharded kernel sweep of
  :mod:`ccfindr_tpu_torch.ops.kernels.sol_sharded` (or, gene-sharded or
  gene-major, the fused X pass a block), ``'sparse'``,
  ``'pallas2pass'``, ``'dense'`` and ``'dense_fused'`` with the shard
  passes of ``parallel.sharded``;
* ``distributed`` splits the batched (rank, run) grid round-robin
  across processes (``parallel.schedule``) and exchanges the
  evidences and the winners, so every process returns the single
  process's result;
* ``checkpoint_every``/``compact_every`` run the loop in chunks of
  sweeps (:func:`_chunked_vb`), with the carry saved between chunks and
  only the running lanes in the next chunk; ``checkpoint_dir`` alone
  saves each finished rank of the sequential scan;
* degeneracy (a uniform basis column) aborts the rank scan for that
  run, and best-of-nrun selection fills the measure table, as in the
  reference (R/bayesian.R:268-291, 368-378).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import pandas as pd
import torch

from ..container import SCSet
from ..ops import consensus as cons
from ..ops import tile as tile_ops
from ..ops import vb as vb_ops
from ..ops.kernels import epilogue as epi_ops
from ..ops.kernels import sol as sol_ops
from ..ops.kernels import sol_sharded
from ..ops.kernels import vb_kernels as vbk
from ..ops.kernels.vb_kernels import (DEFAULT_BM, DEFAULT_BN,
                                      _fused_layout)
from ..ops.vb import Hyper, VBRunResult, VBState
from ..parallel import schedule, sharded
from ..parallel.mesh import init_distributed
from ..utils import Timings, auto_storage_dtype, resolve_device


def _sparse_counts(obj):
    """The CSR of an SCSet, with the drivers' empty row/column guards
    taken on it: nothing is densified."""
    import scipy.sparse as sp

    mat = sp.csr_matrix(obj.counts)
    if (np.asarray(mat.sum(axis=1)).ravel() == 0).any():
        raise ValueError("Input matrix contains empty rows")
    if (np.asarray(mat.sum(axis=0)).ravel() == 0).any():
        raise ValueError("Input matrix contains empty columns")
    return mat


def _dense_counts(obj, np_dtype):
    """The dense layouts' X in ``np_dtype``, with the drivers' empty
    row/column guards, and the values the storage checks read: X's
    stored values in ``np_dtype`` (its zeros change none of their
    answers once no row or column is empty).  Guards and values are
    taken on the sparse counts, at the cost of X's nonzeros; for counts
    (nonnegative) they give the dense X's answers, and where a sum could
    cancel the dense X's sums decide."""
    import scipy.sparse as sp

    c = obj.counts
    if not c.has_canonical_format:       # duplicates add, as in the dense X
        c = c.copy()
        c.sum_duplicates()
    c = sp.csr_matrix(c, dtype=np_dtype)
    mat = _as_counts_matrix(obj, np_dtype)
    vals = c.data
    on = mat if vals.size and vals.min() < 0 else c
    if (np.asarray(on.sum(axis=1)).ravel() == 0).any():
        raise ValueError("Input matrix contains empty rows")
    if (np.asarray(on.sum(axis=0)).ravel() == 0).any():
        raise ValueError("Input matrix contains empty columns")
    return mat, vals


def _storage_dtype(vals, storage_dtype):
    """The integer dtype X is stored in on the card (None: the factor
    dtype), from the values :func:`_dense_counts` returns:
    ``storage_dtype='auto'`` picks one (:func:`auto_storage_dtype`); a
    given one must be an integer dtype that holds every count."""
    if isinstance(storage_dtype, str) and storage_dtype == "auto":
        storage_dtype = auto_storage_dtype(vals)
    if storage_dtype is None:
        return None
    sd = np.dtype(storage_dtype)
    if sd.kind not in "iu":
        raise ValueError("storage_dtype must be an integer dtype")
    if np.any(vals != np.round(vals)):
        raise ValueError(
            "storage_dtype requires integer counts (normalized "
            "matrices are float — factorize raw counts instead)")
    if float(vals.max()) > np.iinfo(sd).max:
        raise ValueError(
            f"counts up to {vals.max():.0f} overflow "
            f"storage_dtype {sd.name}; use a wider type")
    return sd


def _check_sparse_options(sparse_layout, storage_dtype, layouts):
    if sparse_layout not in layouts:
        raise ValueError(f"unknown sparse_layout {sparse_layout!r}")
    if storage_dtype is not None and not (
            isinstance(storage_dtype, str) and storage_dtype == "auto"):
        raise ValueError("storage_dtype applies to the dense layouts; the "
                         "sparse backend already stores only nonzeros")


def _as_counts_matrix(obj, dtype):
    if isinstance(obj, SCSet):
        return obj.counts_dense(dtype=np.dtype(dtype))
    return np.asarray(obj, dtype=np.dtype(dtype))


def _pad_state_rank(st: VBState, rmax_):
    """Pad a rank-r state to rmax_ components; the fill values are
    re-masked by the loop's rank-mask handling."""
    r0 = st.ew.shape[1]
    if r0 == rmax_:
        return st
    pw = (0, rmax_ - r0)
    ph = (0, 0, 0, rmax_ - r0)
    pad = torch.nn.functional.pad
    return st._replace(
        ew=pad(st.ew, pw), dw=pad(st.dw, pw),
        lw=pad(st.lw, pw, value=1.0),
        eh=pad(st.eh, ph), dh=pad(st.dh, ph),
        lh=pad(st.lh, ph, value=1.0))


def _stack(states):
    return type(states[0])(*(torch.stack(fs) for fs in zip(*states)))


def process_grid(distributed, count=None, pid=None):
    """The JAX driver's process detection: ``(nproc, pid)``.

    ``distributed`` a dict joins the group first (``init_distributed``);
    False or None is one process.  Otherwise ``count``/``pid`` (the
    drivers' ``_process_count``/``_process_id``), or the initialised
    ``torch.distributed`` group's size and rank, or one process."""
    if isinstance(distributed, dict):
        init_distributed(**distributed)
        distributed = "auto"
    if distributed in (False, None):
        return 1, 0
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    if count is None:
        count = dist.get_world_size() if live else 1
    if pid is None:
        pid = dist.get_rank() if live else 0
    return int(count), int(pid)


# the run keywords that carry one entry a lane
_LANE_KW = ("rank_mask", "r_true", "lk0_init")


def _run_rows(run_fn, rows, st, hy, kw, dev):
    """The mesh's ``runs`` axis: the lane batch split into contiguous
    groups, one a runs row (``rows``, X laid out on each), each group run
    on its row's first device; the results joined in lane order on
    ``dev``.  Every lane runs alone in its kernels' blocks and is frozen
    on its own, so its numbers do not depend on the grouping.  The rows
    run one after the other, on one card or on distinct cards: the runs
    axis divides the lanes, not the time (rows in threads of their own,
    at once, were measured slower on one card and on four, ROADMAP
    A13)."""
    nb = st.lw.shape[0]
    outs = []
    for x_row, lanes in zip(rows, np.array_split(np.arange(nb),
                                                 len(rows))):
        if len(lanes) == 0:
            continue
        sel = slice(int(lanes[0]), int(lanes[-1]) + 1)
        d = x_row.device

        def part(t):
            return t[sel].to(d)

        kw_g = {k: ((v[sel] if k in _LANE_KW else v).to(d)
                    if isinstance(v, torch.Tensor) else v)
                for k, v in kw.items()}
        outs.append(run_fn(x_row, type(st)(*map(part, st)),
                           type(hy)(*map(part, hy)), **kw_g))
    return _cat_field(outs, dev)


def _cat_field(parts, dev):
    """Results of the lane groups joined field by field on ``dev``."""
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(_cat_field(list(fs), dev)
                                for fs in zip(*parts)))
    return torch.cat([p.to(dev) for p in parts])


def _rank_ckpt_path(ckpt_dir, rank):
    return os.path.join(ckpt_dir, f"vb_rank{rank}.npz")


def _save_rank_ckpt(ckpt_dir, rank, rdat_col, imax, res):
    """Persist one completed rank: all runs' log evidences and the best
    run's factors and hypers (the JAX package's file and keys)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez_compressed(
        _rank_ckpt_path(ckpt_dir, rank), rdat=rdat_col, imax=imax,
        ew=res["ew"], eh=res["eh"], dw=res["dw"], dh=res["dh"],
        hyper=np.asarray([res["hyper"][k] for k in
                          ("aw", "bw", "ah", "bh")]),
        n_iter=res["n_iter"], nunif=res["nunif"])


def _load_rank_ckpt(ckpt_dir, rank):
    if ckpt_dir is None:
        return None
    path = _rank_ckpt_path(ckpt_dir, rank)
    if not os.path.exists(path):
        return None
    d = np.load(path)
    hy = d["hyper"]
    res = dict(ew=d["ew"], eh=d["eh"], dw=d["dw"], dh=d["dh"],
               hyper=dict(aw=float(hy[0]), bw=float(hy[1]),
                          ah=float(hy[2]), bh=float(hy[3])),
               n_iter=int(d["n_iter"]), nunif=int(d["nunif"]))
    return d["rdat"], int(d["imax"]), res


def chunk_lanes(n_rec, nb):
    """The global lanes of the next chunk and how many are real: the
    running ones (``n_rec < 0``), in order.  A single running lane of a
    batch of several is run twice: torch takes other matmul and
    reduction paths for one lane than for several, so a lone lane would
    round otherwise than it did in the full batch; the copy's results
    are dropped."""
    live = np.nonzero(n_rec < 0)[0]
    if len(live) == 1 and nb > 1:
        return np.concatenate([live, live]), 1
    return live, len(live)


def _chunked_vb(call, states, hypers, nb, itmax, every, ckpt_file, verbose,
                stats=None):
    """Run a lane batch in chunks of ``every`` sweeps, with the carry
    checkpointed between chunks and converged lanes compacted out.

    ``call(states, hypers, itmax, it0, lk0, lanes) -> VBRunResult`` runs
    the lanes ``lanes`` (global indices into the batch, so that the
    caller can take their rank masks) from sweep ``it0`` to ``itmax``
    with the per-lane ELBO ``lk0``, through the loops' exact ``it0`` /
    ``lk0_init`` continuation.  Between chunks the full carry (states,
    hypers, per-lane ELBO, the absolute sweep index) stays on the device
    and is saved to ``ckpt_file`` when given, which a later call resumes
    from.  A lane whose stopping rule fired is frozen and leaves the
    batch: the next chunk runs the running lanes only (see
    :func:`chunk_lanes`).  The loops freeze lanes, the kernels add each
    lane's partials in an order that does not depend on the batch (the
    drivers pin the blockings that would), and the torch reductions of
    the loops are ``utils.lane_sum``, so the result is the uninterrupted
    run's, bit for bit.  ``stats['lane_sweeps']`` counts the lane-sweeps
    the chunks executed.
    """
    dev = states.lw.device
    ref_t = states.lw.dtype
    it0 = 1
    n_rec = np.full(nb, -1, np.int64)
    hf = np.zeros(nb, bool)
    last_niter = np.zeros(nb, np.int64)
    gs = VBState(*(f.clone() for f in states))
    gh = Hyper(*(f.clone() for f in hypers))
    glml = torch.zeros(nb, dtype=ref_t, device=dev)
    if ckpt_file is not None and os.path.exists(ckpt_file):
        z = np.load(ckpt_file)
        it0 = int(z["it0"])
        n_rec = z["n_rec"]
        hf = z["hf"].astype(bool)
        last_niter = np.where(n_rec >= 0, n_rec, it0 - 1)

        def dev_t(a):
            return torch.as_tensor(a, device=dev)

        gs = VBState(*(dev_t(z[f"st_{f}"]) for f in VBState._fields))
        gh = Hyper(*(dev_t(z[f"hy_{f}"]) for f in Hyper._fields))
        glml = dev_t(z["lk0"]).to(ref_t)
        if verbose >= 1:
            print(f"Resumed sweep checkpoint at iteration {it0}")

    first = it0 == 1
    t_last = time.perf_counter()
    while True:
        end = min(it0 - 1 + every, itmax)
        if first:
            lanes, nreal = np.arange(nb), nb
            first = False
        else:
            lanes, nreal = chunk_lanes(n_rec, nb)
            if nreal == 0:
                break
        sel_t = torch.as_tensor(lanes, device=dev)
        out = call(VBState(*(f[sel_t] for f in gs)),
                   Hyper(*(f[sel_t] for f in gh)), end, it0, glml[sel_t],
                   lanes)
        real = sel_t[:nreal]
        for g, o in zip(gs + gh, out.state + out.hyper):
            g[real] = o[:nreal]
        glml[real] = out.lml[:nreal]
        o_niter = out.n_iter[:nreal].cpu().numpy()
        o_done = out.done[:nreal].cpu().numpy()
        if stats is not None:
            # executed rounds: the loop stops when every lane of this
            # chunk is done, which can be before the chunk's bound
            rounds = max(0, int(o_niter.max()) - it0 + 1)
            stats["lane_sweeps"] = (stats.get("lane_sweeps", 0)
                                    + len(lanes) * rounds)
        hf[lanes[:nreal]] |= out.hyper_failed[:nreal].cpu().numpy()
        last_niter[lanes[:nreal]] = o_niter
        # the done flag tells a lane that converged exactly at the
        # chunk's bound from one that ran out of chunk
        sel = (o_done | (o_niter < end)) & (n_rec[lanes[:nreal]] < 0)
        n_rec[lanes[:nreal][sel]] = o_niter[sel]
        if end >= itmax or (n_rec >= 0).all():
            break
        it0 = end + 1
        if ckpt_file is not None:
            save = dict(it0=it0, lk0=glml.cpu().numpy(), n_rec=n_rec, hf=hf)
            for f in VBState._fields:
                save[f"st_{f}"] = getattr(gs, f).cpu().numpy()
            for f in Hyper._fields:
                save[f"hy_{f}"] = getattr(gh, f).cpu().numpy()
            np.savez(ckpt_file, **save)
        if verbose >= 2:
            now = time.perf_counter()
            print(f"checkpointed at sweep {end}: "
                  f"{int((n_rec >= 0).sum())}/{nb} converged"
                  + (f", batch compacted to {len(lanes)}"
                     if len(lanes) < nb else "")
                  + f" [{now - t_last:.2f}s]")
            t_last = now

    if ckpt_file is not None and os.path.exists(ckpt_file):
        os.remove(ckpt_file)
    return VBRunResult(state=gs, hyper=gh, lml=glml,
                       n_iter=np.where(n_rec >= 0, n_rec, last_niter),
                       hyper_failed=hf, done=n_rec >= 0)


def _record_multihost(out, my_idx, ranks, nrun, n, m, Tol, unif_stop,
                      verbose, nproc, pid, rdat, results, run_alive,
                      np_dtype):
    """Merge this process's share of a batched run over several processes
    into the (rdat, results) tables (the JAX driver's function).

    The lanes' log evidences, sweep counts and degenerate-column counts
    are all-gathered, so that every process makes the identical
    rank-scan abort and best-of-run selection (R/bayesian.R:268-291,
    368-378); only each rank's winner crosses, from its owner
    (``schedule.exchange_winner``), in the run's dtype."""
    nrank = len(ranks)
    nb_all = nrank * nrun

    # local degeneracy counts (uniform basis columns at the true rank)
    nunif_loc = np.empty(len(my_idx))
    for b, t in enumerate(np.asarray(my_idx)):
        rank = ranks[int(t) // nrun]
        ew = out.state.ew[b][:n, :rank]
        nunif_loc[b] = int(
            ((ew.max(axis=0) - ew.min(axis=0)) < float(Tol)).sum())
    lml_loc = (np.asarray(out.lml, np.float64) if len(my_idx)
               else np.zeros(0))
    niter_loc = (np.asarray(out.n_iter, np.float64) if len(my_idx)
                 else np.zeros(0))
    lml_glob = schedule.gather_results(lml_loc, my_idx, nb_all,
                                       process_count=nproc)
    nunif_glob = schedule.gather_results(nunif_loc, my_idx, nb_all,
                                         fill=-1.0, process_count=nproc)
    niter_glob = schedule.gather_results(niter_loc, my_idx, nb_all,
                                         fill=-1.0, process_count=nproc)

    # the identical kill/record pass on every process
    for k, rank in enumerate(ranks):
        for i in range(nrun):
            if not run_alive[i]:
                continue
            t = k * nrun + i
            nunif_i = int(nunif_glob[t])
            if nunif_i > 0:
                if pid == 0:
                    print(f"Warning: Rank {rank} has {nunif_i} "
                          "constant column(s).")
                if unif_stop:
                    if pid == 0:
                        print("Warning: Rank scan stopped for rank >= "
                              f"{rank}")
                    if k == 0:
                        raise ValueError("Rerun with lower ranks")
                    run_alive[i] = False
                    continue
            rdat[i, k] = lml_glob[t]

    # each rank's winner, from its owner
    local_pos = {int(t): b for b, t in enumerate(np.asarray(my_idx))}
    for k, rank in enumerate(ranks):
        if not np.isfinite(rdat[:, k]).any():
            continue
        imax = int(np.argmax(rdat[:, k]))
        t = k * nrun + imax
        owner = t % nproc                   # the round-robin partition
        if owner == pid:
            b = local_pos[t]
            cand = dict(
                ew=out.state.ew[b][:n, :rank], eh=out.state.eh[b][:rank, :m],
                dw=out.state.dw[b][:n, :rank], dh=out.state.dh[b][:rank, :m],
                hyper=np.asarray([out.hyper.aw[b], out.hyper.bw[b],
                                  out.hyper.ah[b], out.hyper.bh[b]],
                                 np.float64))
        else:
            cand = dict(ew=np.zeros((n, rank), np_dtype),
                        eh=np.zeros((rank, m), np_dtype),
                        dw=np.zeros((n, rank), np_dtype),
                        dh=np.zeros((rank, m), np_dtype),
                        hyper=np.zeros(4))
        cand = schedule.exchange_winner(cand, owner == pid, owner,
                                        process_count=nproc)
        hy = cand["hyper"]
        results[imax][k] = dict(
            ew=cand["ew"], eh=cand["eh"], dw=cand["dw"], dh=cand["dh"],
            hyper=dict(aw=float(hy[0]), bw=float(hy[1]),
                       ah=float(hy[2]), bh=float(hy[3])),
            n_iter=int(niter_glob[t]), nunif=int(nunif_glob[t]))
        if verbose >= 2 and pid == 0:
            print(f"Rank = {rank}: best log(evidence) = "
                  f"{rdat[imax, k]:.6g} (run {imax + 1}, process "
                  f"{owner})")


def _mesh_layout(mesh, backend, mat, x_dtype, dtype, n_pad, m_pad,
                 overrides):
    """X laid out once on each runs row of ``mesh`` (the JAX driver's
    ``_place_sharded``), zero-padded to the mesh: the sparse layout a
    cell shard (``from_scipy_tile_sharded``), the dense ones a (gene,
    cell) block (``parallel.sharded.place_counts``; the two-pass
    backend in the factor dtype, as the JAX driver keeps it), or, for
    the user's ``suffstats``/``data_term`` on a dense backend, the whole
    padded X on the row's first device.  Each device gets its own blocks only,
    converted on the host (a compressed X crosses, not float32)."""
    ncells = mesh.shape["cells"]
    if backend == "sparse":
        base = tile_ops.from_scipy_tile_sharded(mat, ncells, m_pad=m_pad,
                                                dtype=dtype, device="cpu")
        return [base.to(row[0]) for row in mesh.devices]
    n, m = mat.shape
    x = torch.as_tensor(mat).to(dtype=dtype if backend == "pallas2pass"
                                else x_dtype)
    if (n_pad, m_pad) != (n, m):
        x = torch.nn.functional.pad(x, (0, m_pad - m, 0, n_pad - n))
    if overrides:
        return [x.to(row[0, 0]) for row in mesh.devices]
    return sharded.place_counts(x, mesh)


def vb_factorize(object, ranks=2, nrun=1, verbose=2,
                 initializer="random", Itmax=10000,
                 hyper_update=(True, True, True, True),
                 gamma_a=1.0, gamma_b=1.0, Tol=1e-5,
                 hyper_update_n0=10, hyper_update_dn=1,
                 connectivity=False, fudge=None, unif_stop=True,
                 dtype=None, seed=0, mesh=None, backend="dense",
                 batch_ranks="auto", checkpoint_dir=None,
                 checkpoint_every=None, compact_every=None,
                 suffstats=None, data_term=None,
                 distributed="auto", svd_method="auto",
                 storage_dtype="auto", sparse_layout="auto", elbo_every=1,
                 precision="f32", _process_count=None, _process_id=None,
                 device="cuda"):
    """Bayesian NMF inference of a count matrix.

    The keywords mirror the reference (R/bayesian.R:229-236) and the
    JAX package.  ``device`` (default ``"cuda"``) is where the lanes
    run; it raises when no card is present.  ``dtype=None`` is float32
    on the card and float64 on the CPU.  ``backend``:

    * ``'dense'`` (default) — matmul sweep, two passes over X;
    * ``'dense_fused'`` — matmul sweep, one pass over X (deferred ELBO);
    * ``'pallas'`` — the hand-written CUDA sweep on the card, its plain
      PyTorch version on the CPU: the cell-major sweep K1-K4
      (ops/kernels/sol.py, ``csrc/sol.cu``), or, where the JAX driver's
      ``_fused_layout`` answers ``'gm'`` on its padded extents (more
      than 65,536 genes), the gene-major sweep E1-E3 + K4
      (ops/kernels/epilogue.py, ``csrc/epi.cu``);
    * ``'pallas2pass'`` — the suffstats and the ELBO data term as two
      passes over X, P1 and P2 of ``csrc/pass2.cu``
      (ops/kernels/vb_kernels.py), in the two-pass loop of
      ``ops.vb.vb_run``; X crosses zero-padded in the factor dtype;
    * ``'sparse'`` — X as its nonzeros only, never densified (the
      capacity path for atlas-scale matrices): CSR on the device and
      the CUDA kernels S1/S2 (ops/tile.py, ``csrc/sparse.cu``) on the
      card, their plain PyTorch version on the CPU.  ``sparse_layout``
      ``'auto'``, ``'tile'``, ``'coo'`` and ``'ell'`` all take this
      layout: the JAX package's COO and ELL passes
      (``ops.sparse.fused_coo``, ``ops.ell.fused_ell``) are in the port
      ``fused_tile`` over a CSR view of the same nonzeros, so ``'coo'``
      and ``'ell'`` build the CSR layout at once, on one device and on a
      mesh.  ``'coo'`` keeps ``elbo_every`` and ``precision='bf16'``,
      which the JAX package's COO scan refuses; ``'ell'`` refuses them
      as the JAX package's ELL scan does.

    ``suffstats``/``data_term`` (``(x, lw, lh)`` of a lane batch ->
    ``(sw, sh)`` and ``(B,)``) override the backend's passes; on
    ``'pallas'`` they replace its kernel loops by ``ops.vb.vb_run`` over
    the zero-padded X, as in the JAX driver (on a mesh the functions take
    the whole padded X, as JAX hands them its sharded array).

    ``mesh`` (``make_mesh(runs, cells, genes, devices)``, where a
    device may repeat) runs the scan over a device grid in this
    process, as the JAX driver runs it over a ``jax`` mesh: the cell
    axis (and with ``genes > 1`` the gene axis) is zero-padded to the
    mesh and masked, X is laid out on each runs row, the lane batch is
    split into contiguous groups, one a runs row, and the shards'
    partials are added in shard order (``parallel/sharded.py``).
    ``'pallas'`` runs the cell-sharded kernel sweep K1s, K2, K3s, K4
    (ops/kernels/sol_sharded.py), or, with ``genes > 1`` or where
    ``_fused_layout`` answers ``'gm'``, the fused X pass E1 + E1s a
    block (``make_fused_sharded``) in ``ops.vb.vb_run``; ``'sparse'``
    S1/S2 a cell shard (``make_tile_fused_sharded``, for every
    ``sparse_layout``); ``'pallas2pass'`` P1 +
    E1s and P2 a block (``make_pass2_sharded``); ``'dense'`` and
    ``'dense_fused'`` the block passes of ``parallel/sharded.py``, also
    gene-sharded.

    ``elbo_every=k`` evaluates the ELBO and the stopping test only
    every k-th sweep (``'sparse'``, and ``'pallas'`` on cell-major
    shapes, on one device or a mesh).  ``precision='bf16'`` rounds the
    X pass's operands to bfloat16, accumulating in float32 (``'pallas'``
    on cell-major shapes, and ``'sparse'``).  As in the JAX package,
    the gene-major route and ``'pallas2pass'`` refuse both.

    ``batch_ranks='auto'`` batches all (rank, run) lanes when there
    are several ranks, unless ``checkpoint_dir`` is given without
    ``checkpoint_every`` (per-rank checkpoints need the sequential
    scan).  ``checkpoint_every=K`` runs the loop in chunks of K sweeps
    and saves the carry after each (into ``checkpoint_dir``, where a
    rerun resumes it); ``compact_every=K`` chunks without files.  Either
    runs only the lanes still running in each chunk, and the result is
    the uninterrupted run's, bit for bit.  ``checkpoint_dir`` alone
    saves each finished rank of the sequential scan, and a rerun
    restores it.  ``storage_dtype='auto'`` keeps integer counts that fit
    in int8/int16 compressed on the device (exact: the sweep converts
    them to the factor type in registers).

    ``distributed`` runs the scan over several processes, as the JAX
    package runs the reference's Rmpi restart farm (R/bayesian.R:260-263):
    a dict joins the group (``init_distributed``'s keywords), ``'auto'``
    takes an initialised ``torch.distributed`` group, False or None is
    one process (``_process_count``/``_process_id`` stand in for the
    group's size and rank).  Over N > 1 processes the (rank, run) grid
    is one lane batch, split round-robin (``parallel.schedule``): every
    process draws every lane's start in order and runs its own share
    (with the chunks pinned for the whole grid), on its device or over
    its own ``mesh``; the evidences are all-gathered, every process
    makes the same selection, and each rank's winner is broadcast from
    its owner, so every process returns the single process's result,
    bit for bit, on the CPU and on the card (the dense routes' products
    go in batches of a fixed lane count, ``utils.lane_matmul``, so a
    share rounds as the full batch does).
    Checkpoints of the chunked batch are ``vb_sweeps_batch_p{pid}.npz``.
    ``svd_method`` (``'auto'``,
    ``'exact'``, ``'randomized'``) is ``ops.vb.vb_init_svd``'s: above
    4096 on the short axis ``'auto'`` takes the randomized SVD on the
    device, whose start differs from JAX's only through its random test
    matrix.

    Returns a new :class:`SCSet` with ranks/basis/dbasis/coeff/dcoeff
    and the measure table (rank, lml, aw, bw, ah, bh, nunif) filled.
    """
    nproc, pid = process_grid(distributed, _process_count, _process_id)
    if nproc > 1:
        # the (rank, run) grid is partitioned across the processes
        batch_ranks = True
    if backend not in ("dense", "dense_fused", "pallas", "pallas2pass",
                       "sparse"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "sparse":
        _check_sparse_options(sparse_layout, storage_dtype,
                              ("auto", "tile", "coo", "ell"))
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    if backend == "sparse" and sparse_layout == "ell":
        # the JAX driver's ELL scan has neither
        # (ccfindr_tpu/drivers/vb_driver.py:803-815)
        if elbo_every != 1:
            raise ValueError(
                "elbo_every is supported by backend='pallas' (single "
                "device or cell-sharded mesh; cell-major shapes) and "
                "the tile-sparse backend")
        if precision == "bf16":
            raise ValueError(
                "precision='bf16' is supported by backend='pallas' and "
                "the tile-sparse backend (single device or cell-sharded "
                "mesh)")
    if precision == "bf16" and backend not in ("pallas", "sparse"):
        raise ValueError("precision='bf16' is supported by "
                         "backend='pallas' (cell-major shapes) and "
                         "backend='sparse'")
    if int(elbo_every) < 1:
        raise ValueError(f"elbo_every must be a positive integer, got "
                         f"{elbo_every!r}")
    if elbo_every != 1 and backend not in ("pallas", "sparse"):
        raise ValueError("elbo_every is supported by backend='pallas' and "
                         "backend='sparse'")
    overrides = {k: v for k, v in (("suffstats", suffstats),
                                   ("data_term", data_term))
                 if v is not None}
    if overrides and backend == "pallas" and (elbo_every != 1
                                              or precision == "bf16"):
        raise ValueError("elbo_every and precision='bf16' need the kernel "
                         "loops of backend='pallas', which suffstats/"
                         "data_term replace")

    device = resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    if np.isscalar(ranks):
        ranks = [int(ranks)]
    ranks = [int(r) for r in ranks]
    if initializer in ("svd", "svd2") and nrun > 1:
        # identical deterministic restarts: one reproduces them all
        if verbose >= 1:
            print(f"Note: initializer={initializer!r} is "
                  "deterministic; running 1 restart (the reference's "
                  f"{nrun} would be identical).")
        nrun = 1

    obj = object if isinstance(object, SCSet) else SCSet(
        count=object, remove_zeros=False)
    if backend == "sparse":
        # no densification anywhere: guards, shapes and the device
        # layout all come from the CSR
        mat = _sparse_counts(obj)
    else:
        mat, vals = _dense_counts(obj, np_dtype)
    n, m = mat.shape
    ranks = [r for r in ranks if r <= m]
    for r in ranks:
        if r > min(n, m):
            raise ValueError("Rank exceeded min(nrow,ncol)")
    # mesh mode: the cell axis (and the gene axis of a gene-sharded mesh)
    # zero-padded to the mesh and masked, as the JAX driver pads it
    # (ccfindr_tpu/drivers/vb_driver.py:584-615)
    n_pad, m_pad = n, m
    mesh_kwargs = {}
    if mesh is not None:
        ng, ncells = mesh.shape["genes"], mesh.shape["cells"]
        m_pad = sol_ops.round_up(m, ncells)
        n_pad = sol_ops.round_up(n, ng)
        if backend == "sparse" and ng > 1:
            raise ValueError("gene-axis sharding applies to the dense "
                             "layouts; the sparse layouts shard cells")
        # the JAX driver's mesh routes for 'pallas': the cell-sharded
        # sweep, or the fused X pass a (gene, cell) block where genes
        # are sharded or _fused_layout answers 'gm' on the padded extents
        fused_mesh = backend == "pallas" and not overrides and (
            ng > 1 or _fused_layout(
                n_pad, m_pad, sol_ops.round_up(max(max(ranks), 8), 8))
            != "cm")
        if fused_mesh and elbo_every != 1:
            raise ValueError("elbo_every is supported by backend='pallas' "
                             "on cell-major shapes (one device or a "
                             "cell-sharded mesh) and by backend='sparse'")
        if m_pad != m:
            mesh_kwargs.update(cell_mask=torch.as_tensor(
                (np.arange(m_pad) < m).astype(np_dtype), device=device),
                m_true=m)
        if n_pad != n:
            mesh_kwargs.update(gene_mask=torch.as_tensor(
                (np.arange(n_pad) < n).astype(np_dtype), device=device),
                n_true=n)

    gamma_a = np.atleast_1d(np.asarray(gamma_a, dtype=float))
    gamma_b = np.atleast_1d(np.asarray(gamma_b, dtype=float))
    aw0, ah0 = float(gamma_a[0]), float(gamma_a[-1])
    bw0, bh0 = float(gamma_b[0]), float(gamma_b[-1])
    h1 = Hyper(aw=aw0, bw=bw0, ah=ah0, bh=bh0)
    hyper_mask = tuple(bool(b) for b in hyper_update)
    gen = torch.Generator().manual_seed(int(seed))

    # compressed integer X storage (exact; see utils.auto_storage_dtype);
    # validated on 'pallas2pass' too, whose X stays in the factor dtype
    x_dtype = dtype
    sd = None if backend == "sparse" else _storage_dtype(vals, storage_dtype)
    if sd is not None and backend != "pallas2pass":
        x_dtype = torch.from_numpy(np.zeros(0, sd)).dtype

    run_kwargs = dict(tol=float(Tol), fudge=fudge, hyper_mask=hyper_mask,
                      n0=int(hyper_update_n0), dn=int(hyper_update_dn),
                      **mesh_kwargs)
    run_fn = vb_ops.vb_run
    # the blocking a route's kernels would choose from the lane count,
    # pinned for the full batch (see pinned() below)
    pin = None
    rows = None
    if mesh is not None:
        rows = _mesh_layout(mesh, backend, mat, x_dtype, dtype, n_pad, m_pad,
                            overrides)
        if backend == "sparse":
            run_kwargs.update(fused=sharded.make_tile_fused_sharded(
                mesh, mxu_bf16=precision == "bf16"),
                elbo_every=int(elbo_every))
        elif overrides:
            # the user's passes take the whole padded X, as the JAX
            # driver hands them its sharded array; 'dense_fused' keeps
            # its fused pass, which vb_run prefers, as in JAX
            if backend == "dense_fused":
                run_kwargs["fused"] = vb_ops.fused_dense
        elif backend == "pallas2pass":
            ss, dt = sharded.make_pass2_sharded(mesh)
            run_kwargs.update(suffstats=ss, data_term=dt)
        elif fused_mesh:
            run_kwargs["fused"] = sharded.make_fused_sharded(
                mesh, mxu_bf16=precision == "bf16")
        elif backend == "pallas":
            run_fn = sol_ops.vb_run_sol
            run_kwargs.update(
                sweep_fn=sol_sharded.make_sol_sweep_sharded(mesh),
                elbo_every=int(elbo_every), mxu_bf16=precision == "bf16")
        elif backend == "dense_fused":
            run_kwargs["fused"] = sharded.fused_sharded
        else:
            run_kwargs.update(suffstats=sharded.suffstats_sharded,
                              data_term=sharded.data_term_sharded)
    elif backend == "sparse":
        x = tile_ops.from_scipy_tile(mat, dtype=dtype, device=device)
        run_kwargs.update(fused=tile_ops.make_tile_fused(
            mxu_bf16=precision == "bf16"), elbo_every=int(elbo_every))
    elif backend == "pallas2pass" or (backend == "pallas" and overrides):
        # the JAX driver's two-pass layout: X zero-padded to its tiles
        # (ccfindr_tpu/drivers/vb_driver.py:700-708), read in place
        x = vbk.pad_matrix(torch.as_tensor(mat).to(dtype=x_dtype)
                           .to(device))
        if backend == "pallas2pass":
            pin = "pass2"
    else:
        x = torch.as_tensor(mat).to(dtype=x_dtype).to(device)
        if backend == "pallas":
            # the JAX driver's choice between its two single-device
            # sweeps (ccfindr_tpu/drivers/vb_driver.py:775-801), on its
            # padded extents: gene-major above 65,536 genes
            layout = _fused_layout(sol_ops.round_up(n, DEFAULT_BN),
                                   sol_ops.round_up(m, DEFAULT_BM),
                                   sol_ops.round_up(max(max(ranks), 8), 8))
            if layout == "cm":
                run_fn = sol_ops.vb_run_sol
                run_kwargs.update(elbo_every=int(elbo_every),
                                  mxu_bf16=precision == "bf16")
            else:
                if elbo_every != 1:
                    raise ValueError("elbo_every is supported by "
                                     "backend='pallas' on cell-major "
                                     "shapes and by backend='sparse'")
                if precision == "bf16":
                    raise ValueError("precision='bf16' is supported by "
                                     "backend='pallas' on cell-major "
                                     "shapes")
                run_fn = functools.partial(epi_ops.vb_run_epi,
                                           layout=layout)
                pin = "gm"
        elif backend == "dense_fused":
            run_kwargs["fused"] = vb_ops.fused_dense
    itmax = int(Itmax)
    every = checkpoint_every or compact_every

    def pinned(nb, r):
        """The run's keywords for ``nb`` lanes of rank ``r``: E1's and
        P1's gene chunk depend on the lane count, so a batch pins the
        chunk its full width gives, and its compacted chunks keep it."""
        kw = dict(run_kwargs)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if pin == "gm":
            kw["chunk"] = vbk.fused_chunk(
                x, "gm", nb, sol_ops.round_up(max(r, 8), 8), itemsize)
        elif pin == "pass2":
            ss, dt = vbk.make_pallas_backend(
                chunk=vbk.pass2_chunk(x, n, m, nb, r, itemsize))
            kw.update(suffstats=ss, data_term=dt)
        kw.update(overrides)
        return kw

    def run_lanes(states, hypers, name, rmask=None, rtrue=None,
                  nb_pin=None):
        """Run a lane batch (whole, or in chunks with checkpoints and
        compaction); returns the result on the host and the chunks'
        lane-sweeps (None unchunked).  ``nb_pin`` is the lane count the
        chunks are pinned for (a process's share pins the whole grid's)."""
        nb = states.lw.shape[0]
        kw = pinned(nb_pin or nb, states.lw.shape[-1])

        def call(st, hy, im, i0, l0, lanes):
            if rmask is not None:
                sel = torch.as_tensor(lanes, device=device)
                kw.update(rank_mask=rmask[sel], r_true=rtrue[sel])
            if rows is not None:
                return _run_rows(run_fn, rows, st, hy,
                                 dict(kw, itmax=im, it0=i0, lk0_init=l0),
                                 device)
            return run_fn(x, st, hy, itmax=im, it0=i0, lk0_init=l0, **kw)

        if not every:
            return vb_ops.state_to_numpy(call(
                states, hypers, itmax, 1, None, np.arange(nb))), None
        ckf = None
        if checkpoint_every and checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            ckf = os.path.join(checkpoint_dir, name)
        stats = {}
        out = _chunked_vb(call, states, hypers, nb, itmax, int(every), ckf,
                          verbose, stats=stats)
        return vb_ops.state_to_numpy(out), stats.get("lane_sweeps", 0)

    def init_state(rank):
        """A lane's initial state, drawn at the true shape and then
        padded to the mesh, so that a padded mesh run consumes the
        random stream of a run on one device."""
        if initializer == "random":
            st = vb_ops.vb_init_random(gen, n, m, rank, h1, dtype, device)
        else:
            st = vb_ops.vb_init_svd(mat, rank, h1, variant=initializer,
                                    dtype=dtype, method=svd_method,
                                    seed=seed, device=device)
        if (n_pad, m_pad) == (n, m):
            return st
        pad = torch.nn.functional.pad
        ph, pw = (0, m_pad - m), (0, 0, 0, n_pad - n)
        return st._replace(
            eh=pad(st.eh, ph), dh=pad(st.dh, ph),
            lh=pad(st.lh, ph, value=1.0), ew=pad(st.ew, pw),
            dw=pad(st.dw, pw), lw=pad(st.lw, pw, value=1.0))

    def hyper_batch(nb):
        return Hyper(*(torch.full((nb,), v, dtype=dtype, device=device)
                       for v in (aw0, bw0, ah0, bh0)))

    timings = Timings()
    nrank = len(ranks)
    rdat = np.full((nrun, nrank), -np.inf)
    results = [[None] * nrank for _ in range(nrun)]
    run_alive = np.ones(nrun, dtype=bool)
    conav_acc = {}

    def _record(out, b, i, k, rank):
        """Record one (run, rank) lane; returns False and kills the run
        on degeneracy (reference R/bayesian.R:368-378)."""
        ew = out.state.ew[b][:n, :rank]
        eh = out.state.eh[b][:rank, :m]
        unif_i = (ew.max(axis=0) - ew.min(axis=0)) < float(Tol)
        nunif_i = int(unif_i.sum())
        if nunif_i > 0:
            cols = np.nonzero(unif_i)[0] + 1
            print(f"Warning: Rank {rank} column "
                  f"{','.join(map(str, cols))} constant.")
            if unif_stop:
                print(f"Warning: Rank scan stopped for rank >= {rank}")
                if k == 0:
                    raise ValueError("Rerun with lower ranks")
                run_alive[i] = False
                return False
        lml = float(out.lml[b])
        rdat[i, k] = lml
        results[i][k] = dict(
            ew=ew, eh=eh, dw=out.state.dw[b][:n, :rank],
            dh=out.state.dh[b][:rank, :m],
            hyper=dict(aw=float(out.hyper.aw[b]),
                       bw=float(out.hyper.bw[b]),
                       ah=float(out.hyper.ah[b]),
                       bh=float(out.hyper.bh[b])),
            n_iter=int(out.n_iter[b]), nunif=nunif_i)
        if connectivity:
            cnn = cons.connectivity(h=eh)
            acc, cnt = conav_acc.get(rank, (0.0, 0))
            conav_acc[rank] = (acc + cnn, cnt + 1)
        if verbose >= 2:
            msg = (f"Rank = {rank}: Nsteps = {int(out.n_iter[b])}, "
                   f"log(evidence) = {lml:.6g}, hyper = "
                   f"({out.hyper.aw[b]:.4g},{out.hyper.bw[b]:.4g},"
                   f"{out.hyper.ah[b]:.4g},{out.hyper.bh[b]:.4g})")
            if connectivity:
                acc, cnt = conav_acc[rank]
                msg += f", dispersion = {cons.dispersion(acc / cnt, m):.6g}"
            print(msg)
        return True

    if batch_ranks == "auto":
        # per-rank checkpoints need the sequential scan
        batch_ranks = len(ranks) > 1 and (checkpoint_dir is None
                                          or checkpoint_every is not None)
    if batch_ranks:
        rmax_ = max(ranks)
        nb_all = nrank * nrun
        rank_arr_all = np.repeat(np.asarray(ranks, np.int64), nrun)
        # this process's share of the grid (all of it in one process)
        my_idx = schedule.partition_items(nb_all, nproc, pid)
        nb = len(my_idx)
        owned = set(my_idx.tolist())
        if initializer == "random":
            # every process draws every lane's start in order and keeps
            # its own, so that lane t starts as in one process
            drawn = {}
            for t in range(nb_all):
                st = init_state(rmax_)
                if t in owned:
                    drawn[t] = st
            states = [drawn[int(t)] for t in my_idx]
        else:
            # deterministic starts, for the ranks of the owned lanes only
            per_rank = {r: _pad_state_rank(init_state(r), rmax_)
                        for r in sorted({int(rank_arr_all[t])
                                         for t in owned})}
            states = [per_rank[int(rank_arr_all[t])] for t in my_idx]
        out = None
        if nb == 0:
            # more processes than lanes: this one owns none, and joins
            # every exchange with an empty share
            if verbose >= 1:
                print(f"process {pid}: idle ({nb_all} (rank, run) items "
                      f"across {nproc} processes)")
        else:
            rank_arr = rank_arr_all[my_idx]
            rmask = torch.as_tensor(
                (np.arange(rmax_)[None, :] < rank_arr[:, None]
                 ).astype(np_dtype), device=device)
            rtrue = torch.as_tensor(rank_arr.astype(np_dtype), device=device)
            ckname = ("vb_sweeps_batch.npz" if nproc == 1
                      else f"vb_sweeps_batch_p{pid}.npz")
            with timings.phase("vb_rank_batch", ranks=list(ranks),
                               nrun=nrun):
                out, chunked = run_lanes(_stack(states), hyper_batch(nb),
                                         ckname, rmask, rtrue,
                                         nb_pin=nb_all)
            timings.records[-1]["total_sweeps"] = int(out.n_iter.sum())
            # a lane batch runs every lane until all stop, nb x the most
            # sweeps; a chunked run counts what its chunks executed
            timings.records[-1]["lane_sweeps_executed"] = (
                chunked if chunked is not None
                else nb * (int(np.max(out.n_iter)) + 1))
            timings.records[-1]["n_iter"] = out.n_iter.tolist()
            if out.hyper_failed.any():
                print("Warning: hyperparameter update did not converge "
                      "in some runs")
            if nproc == 1:
                for k, rank in enumerate(ranks):
                    for i in range(nrun):
                        if run_alive[i]:
                            _record(out, k * nrun + i, i, k, rank)
        if nproc > 1:
            _record_multihost(out, my_idx, ranks, nrun, n, m, Tol,
                              unif_stop, verbose, nproc, pid, rdat,
                              results, run_alive, np_dtype)
        ranks_iter = []
    else:
        ranks_iter = list(enumerate(ranks))

    for k, rank in ranks_iter:
        if not run_alive.any():
            break
        if verbose == 1:
            print(f"[{k + 1}/{nrank}] rank {rank} ...", flush=True)
        # drawn whether or not the rank restores: the random stream of
        # the later ranks stays the same
        states = [init_state(rank)
                  for _ in range(nrun if initializer == "random" else 1)]
        ckpt = _load_rank_ckpt(checkpoint_dir, rank)
        if ckpt is not None and len(ckpt[0]) == nrun:
            rdat_col, imax, res = ckpt
            rdat[:, k] = rdat_col
            results[imax][k] = res
            if verbose >= 1:
                print(f"Rank = {rank}: restored from checkpoint")
            continue
        with timings.phase("vb_rank", rank=rank, nrun=nrun):
            out, _ = run_lanes(_stack(states), hyper_batch(len(states)),
                               f"vb_sweeps_rank{rank}.npz")
        timings.records[-1]["total_sweeps"] = int(out.n_iter.sum())
        timings.records[-1]["n_iter"] = out.n_iter.tolist()
        if out.hyper_failed.any():
            print("Warning: hyperparameter update did not converge "
                  "in some runs")
        for i in range(nrun):
            if run_alive[i]:
                _record(out, i, i, k, rank)
        if checkpoint_dir is not None and np.isfinite(rdat[:, k]).any():
            imax = int(np.argmax(rdat[:, k]))
            _save_rank_ckpt(checkpoint_dir, rank, rdat[:, k], imax,
                            results[imax][k])

    # best-of-nrun selection per rank (reference R/bayesian.R:268-291)
    ranks2, lmls, basis, dbasis, coeff, dcoeff = [], [], [], [], [], []
    awd, bwd, ahd, bhd, nunifd = [], [], [], [], []
    for k, rank in enumerate(ranks):
        if not np.isfinite(rdat[:, k]).any():
            continue
        imax = int(np.argmax(rdat[:, k]))
        res = results[imax][k]
        ranks2.append(rank)
        lmls.append(rdat[imax, k])
        basis.append(np.asarray(res["ew"]))
        coeff.append(np.asarray(res["eh"]))
        dbasis.append(np.sqrt(np.asarray(res["dw"])))
        dcoeff.append(np.sqrt(np.asarray(res["dh"])))
        awd.append(res["hyper"]["aw"])
        bwd.append(res["hyper"]["bw"])
        ahd.append(res["hyper"]["ah"])
        bhd.append(res["hyper"]["bh"])
        nunifd.append(res["nunif"])

    out_obj = obj[np.arange(obj.n_genes), np.arange(obj.n_cells)]
    out_obj.ranks = ranks2
    out_obj.basis = basis
    out_obj.dbasis = dbasis
    out_obj.coeff = coeff
    out_obj.dcoeff = dcoeff
    out_obj.measure = pd.DataFrame(dict(
        rank=ranks2, lml=lmls, aw=awd, bw=bwd, ah=ahd, bh=bhd,
        nunif=nunifd))
    out_obj.metadata["timings"] = timings.summary()
    out_obj.validate()
    return out_obj
