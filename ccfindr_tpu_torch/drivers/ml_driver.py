"""Maximum-likelihood factorization driver in PyTorch.

Counterpart of ``ccfindr_tpu.drivers.ml_driver.factorize`` (reference
factorize, R/factorize.R:139-276): rank sweep x ``nsmpl`` randomized
replicates x ``nrun`` restarts.

* restarts and ranks are an explicit lane axis: the batched rank scan
  pads every (rank, run) lane to ``max(ranks)`` with prefix rank masks
  and runs them as one lane batch; the sequential loop runs one rank's
  ``nrun`` restarts at a time;
* ``backend='pallas'`` runs the H and W phases as the CUDA kernels of
  :mod:`ccfindr_tpu_torch.ops.kernels.ml` on the card (their plain
  PyTorch versions on the CPU); ``backend='sparse'`` keeps X as its
  nonzeros and runs them as the CUDA kernels of
  :mod:`ccfindr_tpu_torch.ops.kernels.sparse`; ``'dense'`` and
  ``'dense_fused'`` are the matmul paths of
  :mod:`ccfindr_tpu_torch.ops.ml`;
* consensus statistics stream through
  :class:`~ccfindr_tpu_torch.ops.consensus.ConsensusAccumulator`: exact
  dispersion without the m(m-1)/2 connectivity vector, and a
  subsampled cophenetic above ``cophenetic_max_cells``;
* ``mesh`` lays X out a cell shard a device and runs the shard passes
  of :mod:`ccfindr_tpu_torch.parallel.sharded`;
* ``distributed`` splits the restarts round-robin across processes
  and all-gathers what the consensus needs (``parallel.schedule``);
* ``checkpoint_every``/``compact_every`` run the loop in chunks of
  sweeps (:func:`_chunked_ml`, the twin of the VB driver's), and
  ``checkpoint_dir`` keeps each finished sample of a randomized scan.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from ..container import SCSet
from ..ops import consensus as cons
from ..ops import ml as ml_ops
from ..ops import tile as tile_ops
from ..ops.kernels import ml as ml_kernels
from ..utils import Timings, resolve_device
from ..parallel import hshards, schedule, sharded
from ..parallel.hshards import HShards
from .vb_driver import (_cat_field, _check_sparse_options, _dense_counts,
                        _sparse_counts, _storage_dtype, chunk_lanes,
                        process_grid)


def initial_factors(seed, ismpl, pairs, nrank, nrun, n, m, rank, dtype,
                    device):
    """The initial factors of every lane of one batch: ``(w0 (B, n,
    rank), h0 (B, rank, m))`` with lane b = ``pairs[b] = (k, i)``, the
    ``i``-th restart of the ``k``-th rank of sample ``ismpl``.

    Each lane draws :func:`~ccfindr_tpu_torch.ops.ml.ml_init` from its
    own ``torch.Generator``, seeded from (seed, sample, rank index,
    restart), so a lane's draw does not depend on which batch runs it.
    Every lane of :func:`factorize` is drawn here and nowhere else."""
    ws, hs = [], []
    for k, i in pairs:
        ss = np.random.SeedSequence([int(seed), ismpl * nrank + k, i])
        gen = torch.Generator().manual_seed(
            int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        w, h = ml_ops.ml_init(gen, n, m, rank, dtype, device)
        ws.append(w)
        hs.append(h)
    return torch.stack(ws), torch.stack(hs)


def _chunked_ml(call, w0, h0, nb, itmax, every, ckpt_file, verbose):
    """Run a lane batch of ``ml_run`` in chunks of ``every`` sweeps,
    with the carry checkpointed between chunks and converged lanes
    compacted out: the ML twin of ``vb_driver._chunked_vb``.

    ``call(w, h, cid, zstep, lk0, itmax, it0, lanes) -> MLRunResult``
    runs the global lanes ``lanes`` through ``ml_run``'s exact
    ``it0``/``lk0_init``/``cid0``/``zstep0`` continuation.  The carry
    (factors, likelihoods, the connectivity streaks and assignments,
    the absolute sweep index) stays on the device and is saved to
    ``ckpt_file`` when given; a later call resumes it.  The result is
    the uninterrupted run's, bit for bit.  ``h`` and the assignments
    carried as cell shards stay so (lanes taken and written shard by
    shard, the shards joined on the host for a checkpoint and laid out
    as ``h0`` on resume).
    """
    dev, ref_t = w0.device, w0.dtype
    it0 = 1
    n_rec = np.full(nb, -1, np.int64)
    g = None
    if ckpt_file is not None and os.path.exists(ckpt_file):
        z = np.load(ckpt_file)
        it0 = int(z["it0"])
        n_rec = z["n_rec"]

        def dev_t(a):
            return torch.as_tensor(a, device=dev)

        g = ml_ops.MLRunResult(
            w=dev_t(z["w"]), h=hshards.like(z["h"], h0),
            lkh=dev_t(z["lk0"]),
            n_iter=dev_t(np.where(n_rec >= 0, n_rec, 0)),
            cid=hshards.like(z["cid"], h0), zstep=dev_t(z["zstep"]),
            done=dev_t(n_rec >= 0))
        if verbose >= 1:
            print(f"Resumed ML sweep checkpoint at iteration {it0}")

    while True:
        end = min(it0 - 1 + every, itmax)
        if g is None:
            lanes, nreal = np.arange(nb), nb
            out = call(w0, h0, None,
                       torch.zeros(nb, dtype=torch.int32, device=dev),
                       torch.full((nb,), -np.inf, dtype=ref_t, device=dev),
                       end, it0, lanes)
            g = ml_ops.MLRunResult(*(f.clone() for f in out))
        else:
            lanes, nreal = chunk_lanes(n_rec, nb)
            if nreal == 0:
                break
            sel = torch.as_tensor(lanes, device=dev)
            out = call(g.w[sel], hshards.take(g.h, sel),
                       hshards.take(g.cid, sel), g.zstep[sel],
                       g.lkh[sel], end, it0, lanes)
            real = sel[:nreal]
            for gf, of in zip(g, out):
                hshards.put(gf, real, hshards.lanes(of, slice(0, nreal)))
        o_niter = out.n_iter[:nreal].cpu().numpy()
        loc = out.done[:nreal].cpu().numpy() | (o_niter < end)
        sel_n = loc & (n_rec[lanes[:nreal]] < 0)
        n_rec[lanes[:nreal][sel_n]] = o_niter[sel_n]
        if end >= itmax or (n_rec >= 0).all():
            break
        it0 = end + 1
        if ckpt_file is not None:
            np.savez(ckpt_file, it0=it0, lk0=g.lkh.cpu().numpy(),
                     cid=hshards.to_numpy(g.cid),
                     zstep=g.zstep.cpu().numpy(), n_rec=n_rec,
                     w=g.w.cpu().numpy(), h=hshards.to_numpy(g.h))
        if verbose >= 2:
            print(f"ML checkpointed at sweep {end}: "
                  f"{int((n_rec >= 0).sum())}/{nb} converged")

    if ckpt_file is not None and os.path.exists(ckpt_file):
        os.remove(ckpt_file)
    return g


def _shuffle_sparse_columns(csr, rng):
    """Sparse analog of the reference's per-column shuffle
    (R/factorize.R:172-173): each column's nonzeros move to a uniform
    random subset of rows (shuffling a column with its zeros included
    is exactly that), preserving sparsity end to end.  The JAX
    package's function, so one ``rng`` stream gives the same matrix."""
    import scipy.sparse as sp

    csc = sp.csc_matrix(csr)
    n, m = csc.shape
    rows = np.empty_like(csc.indices)
    for j in range(m):
        j0, j1 = csc.indptr[j], csc.indptr[j + 1]
        k = j1 - j0
        if k:
            rows[j0:j1] = rng.permutation(n)[:k]
    out = sp.csc_matrix((csc.data, rows, csc.indptr), shape=(n, m))
    out.sum_duplicates()
    return sp.csr_matrix(out)


def _ml_mesh_layout(mesh, backend, mat, x_dtype, dtype, m_pad):
    """X laid out once on each runs row of ``mesh``, a cell shard on
    each device of the row's first gene shard (the JAX driver shards
    X's cells only, P(None, 'cells'), replicated over 'genes'): the
    sparse layout of ``from_scipy_tile_sharded``, or the zero-padded
    dense X's blocks (``parallel.sharded.ShardedCounts``)."""
    if backend == "sparse":
        base = tile_ops.from_scipy_tile_sharded(
            mat, mesh.shape["cells"], m_pad=m_pad, dtype=dtype, device="cpu")
        return [base.to(row[0]) for row in mesh.devices]
    x = torch.as_tensor(mat).to(dtype=x_dtype)
    x = torch.nn.functional.pad(x, (0, m_pad - x.shape[1]))
    return [sharded.ShardedCounts(x, row[:1]) for row in mesh.devices]


def _ml_rows(rows, w, h, c0, z0, l0, kw, dev):
    """The mesh's ``runs`` axis for ``ml_run``: the lane batch split into
    contiguous groups, one a runs row (``rows``, X laid out on each), each
    run on its row's first device, the results joined in lane order on
    ``dev``; ``h`` and the ids as cell shards go to each row's shard
    devices, as ``vb_driver._run_rows`` moves them.  A lane's numbers do
    not depend on the grouping.  The rows run one after the other, as
    ``vb_driver._run_rows``'s do."""
    nb = w.shape[0]
    outs = []
    for x_row, lanes in zip(rows, np.array_split(np.arange(nb),
                                                 len(rows))):
        if len(lanes) == 0:
            continue
        sel = slice(int(lanes[0]), int(lanes[-1]) + 1)
        d = x_row.device
        devs = [dv for _, dv in hshards.cell_layout(x_row)]

        def part(t):
            if isinstance(t, HShards):
                return hshards.move(hshards.lanes(t, sel), devs)
            return None if t is None else t[sel].to(d)

        kw_g = dict(kw)
        if kw.get("rank_mask") is not None:
            kw_g["rank_mask"] = part(kw["rank_mask"])
        outs.append(ml_ops.ml_run(x_row, part(w), part(h), lk0_init=part(l0),
                                  cid0=part(c0), zstep0=part(z0), **kw_g))
    return _cat_field(outs, dev)


def factorize(object, ranks=2, nrun=20, randomize=False, nsmpl=1,
              verbose=2, Itmax=10000, ncnn_step=40,
              criterion="likelihood", linkage="average", Tol=1e-5,
              store_connectivity=False, dtype=None, seed=0,
              backend="dense", mesh=None, batch_ranks="auto",
              prior=False, gamma_a=1.0, gamma_b=1.0,
              cophenetic_max_cells=10000, cophenetic_nsub=3,
              storage_dtype="auto", sparse_layout="auto",
              checkpoint_dir=None, checkpoint_every=None,
              compact_every=None, distributed="auto", _process_count=None,
              _process_id=None, device="cuda"):
    """ML (Lee–Seung KL) NMF over a rank sweep.

    The keywords mirror the reference (R/factorize.R:139-143) and the
    JAX package.  ``device`` (default ``"cuda"``) is where the lanes
    run; it raises when no card is present.  ``dtype=None`` is float32
    on the card and float64 on the CPU.  With ``randomize=True`` each of
    ``nsmpl`` replicates shuffles every column of the count matrix (the
    JAX package's numpy stream, so the shuffled matrices are the same)
    and the measures are averaged with standard errors.  ``backend``:

    * ``'dense'`` (default) — matmul sweep, likelihood as a third pass;
    * ``'dense_fused'`` — matmul phases, deferred likelihood (two passes
      over X a sweep);
    * ``'pallas'`` — the deferred-likelihood loop over the hand-written
      CUDA phases (``csrc/ml.cu``) on the card, their plain PyTorch
      versions on the CPU;
    * ``'sparse'`` — the same loop over X's nonzeros only, never
      densified: CSR on the device and the CUDA kernels S1/S2
      (``csrc/sparse.cu``; ``sparse_layout='tile'``, the ``'auto'``
      default); ``randomize`` shuffles the nonzeros of each column.
      ``sparse_layout='ell'`` (the JAX package's ELL phases,
      ``ops.ell.ell_ml_h``/``ell_ml_w``, which are S1/S2 over a CSR view
      of the same nonzeros) runs this layout too, and refuses
      ``randomize`` and a ``mesh`` as the JAX driver does.

    ``batch_ranks='auto'`` batches all (rank, run) lanes when there are
    several ranks.  ``storage_dtype='auto'`` keeps integer counts that
    fit in int8/int16 compressed on the device (exact).  ``prior=True``
    enables the gamma-prior MAP terms with ``gamma_a``/``gamma_b``.
    Above ``cophenetic_max_cells`` cells the cophenetic correlation is
    the mean of ``cophenetic_nsub`` exact subsampled draws (standard
    errors in ``metadata['cophenetic_se']``).

    ``checkpoint_every=K`` runs the loop in chunks of K sweeps and
    saves the carry after each into ``checkpoint_dir`` (a rerun resumes
    it); ``compact_every=K`` chunks without files; either runs only the
    lanes still running in each chunk, and the result is the
    uninterrupted run's, bit for bit.  ``checkpoint_dir`` also keeps
    each finished sample's statistics and winning factors (not under
    ``store_connectivity``), so a rerun of a crashed multi-sample scan
    skips them.

    ``mesh`` (``make_mesh``, where a device may repeat) runs the scan
    over a device grid in this process, as the JAX driver runs it over a
    ``jax`` mesh: the cell axis is zero-padded to the mesh (the initial
    factors drawn at the padded width, as in JAX; the likelihood
    normalised by the true extents), X is laid out a cell shard on each
    runs row, the lane batch is split into contiguous groups, one a runs
    row, and the deferred-likelihood loop runs the shard passes of
    ``parallel/sharded.py``: M1/M2 (``'pallas'``, ``make_ml_sharded``),
    S1/S2 (``'sparse'``, ``make_tile_ml_sharded``), or the matmul phases
    (``'dense'``, ``'dense_fused'``), the H numerator cell-local and the
    W numerator and ``x log wh`` added in shard order.  (JAX's
    ``'dense'`` keeps its three-pass loop on a mesh that divides the
    cells; the port takes the two-pass loop, which stops at the same
    sweep.)

    ``distributed`` (as in ``vb_factorize``: a dict of
    ``init_distributed``'s keywords, ``'auto'`` an initialised group)
    runs the scan over several processes, as the JAX driver does: the
    (sample, rank, restart) grid is split round-robin at restart
    granularity (``((ismpl * nrank + k) * nrun + i) % nproc == pid``),
    every restart's likelihood, sweep count and cluster ids are
    all-gathered, every process computes the same consensus, and each
    rank's best factors are broadcast from their owner, so every
    process returns the single process's result, bit for bit, on the
    CPU and on the card.
    It needs the batched scan, and, as in the JAX package, refuses a
    ``mesh``.  Checkpoint files carry the process: ``..._p{pid}.npz``.

    Returns a new :class:`SCSet` with ranks/basis/coeff and the measure
    table (rank, likelihood, dispersion, cophenetic; with the standard
    errors r_se, d_se, c_se for randomized replicates) filled.
    """
    nproc, pid = process_grid(distributed, _process_count, _process_id)
    if backend not in ("dense", "dense_fused", "pallas", "sparse"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "sparse":
        _check_sparse_options(sparse_layout, storage_dtype,
                              ("auto", "tile", "ell"))
        if sparse_layout == "ell":
            # the JAX driver's refusals (ccfindr_tpu/drivers/
            # ml_driver.py:260-266)
            if randomize:
                raise ValueError("randomize with backend='sparse' "
                                 "needs sparse_layout='tile'")
            if mesh is not None:
                raise ValueError("the ELL ML layout is single-device; "
                                 "use sparse_layout='tile' with a mesh")
    if criterion not in ("likelihood", "connectivity"):
        raise ValueError("Unknown stopping criterion.")

    device = resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    if np.isscalar(ranks):
        ranks = [int(ranks)]
    ranks = [int(r) for r in ranks]

    obj = object if isinstance(object, SCSet) else SCSet(
        count=object, remove_zeros=False)
    if backend == "sparse":
        mat0 = _sparse_counts(obj)        # nothing is densified
    else:
        mat0, vals = _dense_counts(obj, np_dtype)
    n, m = mat0.shape

    # compressed integer X storage (exact; see utils.auto_storage_dtype)
    x_dtype = dtype
    sd = None if backend == "sparse" else _storage_dtype(vals, storage_dtype)
    if sd is not None:
        x_dtype = torch.from_numpy(np.zeros(0, sd)).dtype

    pn = float(gamma_a) - 1.0 if prior else 0.0
    pd_ = float(gamma_a) / float(gamma_b) if prior else 0.0
    run_kwargs = dict(tol=float(Tol), criterion=criterion,
                      ncnn_step=int(ncnn_step), pn=pn, pd=pd_)
    # mesh: the cell axis zero-padded to the 'cells' axis (the likelihood
    # normalised by the true (n, m) through nm_true), X laid out a cell
    # shard on each runs row, the lanes split over the runs rows
    # (ccfindr_tpu/drivers/ml_driver.py:301-394)
    m_pad = m
    if mesh is not None:
        m_pad = -(-m // mesh.shape["cells"]) * mesh.shape["cells"]
        if backend == "sparse":
            fh, fw = sharded.make_tile_ml_sharded(mesh)
        elif backend == "pallas":
            fh, fw = sharded.make_ml_sharded(mesh)
        else:
            fh, fw = sharded.ml_dense_sharded(mesh)
        run_kwargs.update(fused_h=fh, fused_w=fw, nm_true=(n, m))
    elif backend == "dense_fused":
        run_kwargs.update(fused_h=ml_ops.ml_h_dense,
                          fused_w=ml_ops.ml_w_dense)
    elif backend == "pallas":
        fh, fw = ml_kernels.make_ml_backend()
        run_kwargs.update(fused_h=fh, fused_w=fw)
    elif backend == "sparse":
        fh, fw = tile_ops.make_tile_ml_backend()
        run_kwargs.update(fused_h=fh, fused_w=fw)

    nrank = len(ranks)
    if batch_ranks == "auto":
        batch_ranks = nrank > 1 or nproc > 1
    if nproc > 1:
        if not batch_ranks:
            raise ValueError("factorize over several processes needs "
                             "batch_ranks")
        if mesh is not None:
            raise ValueError("factorize over several processes partitions "
                             "the restarts across them; a mesh is not "
                             "combined with it")
    timings = Timings()
    coph_ses = []
    wdat, hdat = [None] * nrank, [None] * nrank
    rdat = [[] for _ in range(nrank)]
    ddat = [[] for _ in range(nrank)]
    cdat = [[] for _ in range(nrank)]
    conav_last = None

    def consensus_stats(cids, lkhs, niters, label="", quiet=False):
        """Best-of-run selection + streaming consensus over restarts
        (reference R/factorize.R:214-226)."""
        acc = cons.ConsensusAccumulator(m)
        rmax, imax = -np.inf, 0
        for i in range(len(lkhs)):
            acc.add(cids[i])
            lk = float(lkhs[i])
            if (i == 0 or lk > rmax) and not np.isnan(lk):
                rmax, imax = lk, i
            if verbose >= 2 and not quiet:
                print(f"Run #{i + 1}{label}: Nsteps = {int(niters[i])},"
                      f" likelihood = {lk:.6g}, "
                      f"dispersion = {acc.dispersion():.6g}")
        disp = acc.dispersion()
        if m <= cophenetic_max_cells:
            conav = acc.conav()
            coph = cons.cophenet(conav, m, method=linkage)
        else:
            conav = None
            coph, coph_se = cons.cophenet_subsampled(
                acc, cophenetic_max_cells, method=linkage,
                nsub=cophenetic_nsub, seed=seed)
            coph_ses.append(coph_se)
        return imax, rmax, disp, coph, conav

    itmax = int(Itmax)
    every = checkpoint_every or compact_every

    def run(x, ismpl, pairs, r, name, ckname, **record):
        """One lane batch of rank ``r`` to convergence (in chunks under
        ``checkpoint_every``/``compact_every``); the batched scan masks
        each lane's rank rows past its own rank."""
        # on a mesh h0 is drawn on the host and laid out as the cell
        # shards of the first runs row (the JAX driver's P(runs, None,
        # cells)), each on its shard's device
        w0, h0 = initial_factors(seed, ismpl, pairs, nrank, nrun, n, m_pad,
                                 r, dtype, "cpu" if mesh is not None
                                 else device)
        if mesh is not None:
            w0, h0 = w0.to(device), hshards.shard_h(h0, x[0])
        kw = dict(run_kwargs)
        rmask = None
        if batch_ranks:
            rank_arr = np.asarray([ranks[k] for k, _ in pairs])
            rmask = torch.as_tensor(
                (np.arange(r)[None, :] < rank_arr[:, None]
                 ).astype(np_dtype), device=device)

        def call(w, h, c0, z0, l0, im, i0, lanes):
            if rmask is not None:
                kw["rank_mask"] = rmask[torch.as_tensor(lanes,
                                                        device=device)]
            if mesh is not None:
                return _ml_rows(x, w, h, c0, z0, l0,
                                dict(kw, itmax=im, it0=i0), device)
            return ml_ops.ml_run(x, w, h, itmax=im, it0=i0, lk0_init=l0,
                                 cid0=c0, zstep0=z0, **kw)

        with timings.phase(name, sample=ismpl, **record):
            if every:
                ckf = None
                if checkpoint_every and checkpoint_dir is not None:
                    os.makedirs(checkpoint_dir, exist_ok=True)
                    ckf = os.path.join(checkpoint_dir, ckname)
                res = _chunked_ml(call, w0, h0, len(pairs), itmax,
                                  int(every), ckf, verbose)
            else:
                res = call(w0, h0, None, None, None, itmax, 1,
                           np.arange(len(pairs)))
            out = ml_ops.ml_state_to_numpy(res)
        rec = timings.records[-1]
        rec["total_sweeps"] = int(out.n_iter.sum())
        rec["lane_sweeps_executed"] = len(pairs) * (
            int(out.n_iter.max()) + 1)
        rec["n_iter"] = out.n_iter.tolist()
        return out

    def sample(ismpl):
        """One replicate: shuffle (``randomize``), run the lane batches,
        and the consensus of each rank: ``{k: dict(rmax, disp, coph,
        wmax, hmax)}``."""
        nonlocal conav_last
        if randomize:
            # per-sample deterministic stream (the JAX package's own)
            rng_i = np.random.default_rng(
                np.random.SeedSequence([seed, 104729 + ismpl]))
            if backend == "sparse":
                mat = _shuffle_sparse_columns(mat0, rng_i)
            else:
                mat = np.empty_like(mat0)
                for j in range(m):
                    mat[:, j] = rng_i.permutation(mat0[:, j])
        else:
            mat = mat0
        # this process's share: every restart of the grid, or, over
        # several processes, its round-robin part of (sample, rank, run)
        pairs = [(k, i) for k in range(nrank) for i in range(nrun)
                 if ((ismpl * nrank + k) * nrun + i) % nproc == pid]
        if pairs:
            with timings.phase("ml_setup", sample=ismpl):
                if mesh is not None:
                    x = _ml_mesh_layout(mesh, backend, mat, x_dtype, dtype,
                                        m_pad)
                elif backend == "sparse":
                    x = tile_ops.from_scipy_tile(mat, dtype=dtype,
                                                 device=device)
                else:
                    x = torch.as_tensor(mat).to(device=device, dtype=x_dtype)

        out = None
        if batch_ranks:
            if pairs:
                out = run(x, ismpl, pairs, max(ranks), "ml_rank_batch",
                          f"ml_sweeps_s{ismpl}_p{pid}.npz",
                          ranks=list(ranks), nrun=nrun)
            groups = [(k, ranks[k], list(range(k * nrun, (k + 1) * nrun)),
                       out) for k in range(nrank)]
        else:
            groups = []
            for k, rank in enumerate(ranks):
                if verbose > 0:
                    print(f"Rank {rank} [{k + 1}/{nrank}]")
                o = run(x, ismpl, [(k, i) for i in range(nrun)], rank,
                        "ml_rank", f"ml_sweeps_s{ismpl}_r{rank}_p{pid}.npz",
                        rank=rank, nrun=nrun)
                groups.append((k, rank, list(range(nrun)), o))
        if nproc > 1:
            return merge(ismpl, pairs, out)

        local = {}
        for k, rank, idxs, o in groups:
            # padded-rank lanes: slice the factors to the true rank
            # (padded rows are eps, never an argmax)
            label = f" rank {rank}" if batch_ranks else ""
            with timings.phase("ml_consensus", sample=ismpl, rank=rank):
                imax, rmax, disp, coph, conav = consensus_stats(
                    [o.cid[b][:m] for b in idxs], [o.lkh[b] for b in idxs],
                    [o.n_iter[b] for b in idxs], label)
            local[k] = dict(rmax=rmax, disp=disp, coph=coph,
                            wmax=np.asarray(o.w[idxs[imax]][:, :rank]),
                            hmax=np.asarray(o.h[idxs[imax]][:rank, :m]))
            conav_last = conav
            if verbose >= 1:
                print(f"Sample# {ismpl + 1}: rank {rank}: "
                      f"Max(likelihood) = {rmax:.6g}, dispersion = "
                      f"{disp:.6g}, cophenetic = {coph:.6g}")
        return local

    def merge(ismpl, pairs, out):
        """One sample's consensus over several processes (the JAX
        driver's restart-granular merge): every restart's likelihood,
        sweep count and cluster ids all-gathered, the same consensus on
        every process, each rank's best factors from their owner."""
        nonlocal conav_last
        nit_all = nrank * nrun
        loc_idx = np.asarray([k * nrun + i for k, i in pairs], np.int64)
        if pairs:
            lkh_loc = np.asarray(out.lkh, np.float64)
            nit_loc = np.asarray(out.n_iter, np.float64)
            cid_loc = np.asarray(out.cid)[:, :m]
        else:
            lkh_loc, nit_loc = np.zeros(0), np.zeros(0)
            cid_loc = np.zeros((0, m), np.int32)
        lkh_glob = schedule.gather_results(lkh_loc, loc_idx, nit_all,
                                           process_count=nproc)
        nit_glob = schedule.gather_results(nit_loc, loc_idx, nit_all,
                                           fill=-1.0, process_count=nproc)
        cid_glob = schedule.gather_rows(cid_loc, loc_idx, nit_all, m,
                                        process_count=nproc)
        local = {}
        for k, rank in enumerate(ranks):
            sl = slice(k * nrun, (k + 1) * nrun)
            with timings.phase("ml_consensus", sample=ismpl, rank=rank):
                imax, rmax, disp, coph, conav = consensus_stats(
                    list(cid_glob[sl]), list(lkh_glob[sl]),
                    list(nit_glob[sl]), f" rank {rank}", quiet=pid != 0)
            owner = ((ismpl * nrank + k) * nrun + imax) % nproc
            if owner == pid:
                b = pairs.index((k, imax))
                cand = dict(w=out.w[b][:, :rank], h=out.h[b][:rank, :m])
            else:
                cand = dict(w=np.zeros((n, rank), np_dtype),
                            h=np.zeros((rank, m), np_dtype))
            cand = schedule.exchange_winner(cand, owner == pid, owner,
                                            process_count=nproc)
            local[k] = dict(rmax=rmax, disp=disp, coph=coph,
                            wmax=cand["w"], hmax=cand["h"])
            conav_last = conav
            if verbose >= 1 and pid == 0:
                print(f"Sample# {ismpl + 1}: rank {rank}: "
                      f"Max(likelihood) = {rmax:.6g}, dispersion = "
                      f"{disp:.6g}, cophenetic = {coph:.6g}")
        return local

    # sample-level progress: each finished sample's statistics and
    # winning factors, so a crashed multi-sample scan skips them on a
    # rerun (not under store_connectivity: the last sample's consensus
    # cannot be rebuilt from them)
    progress_file = None
    progress = {}
    if checkpoint_dir is not None and not store_connectivity:
        os.makedirs(checkpoint_dir, exist_ok=True)
        progress_file = os.path.join(checkpoint_dir,
                                     f"ml_progress_p{pid}.npz")
        if os.path.exists(progress_file):
            z = np.load(progress_file)
            progress = {key: z[key] for key in z.files}

    for ismpl in range(nsmpl):
        if progress_file is not None and all(
                f"r_s{ismpl}_k{k}" in progress for k in range(nrank)):
            local = {}
            for k in range(nrank):
                key = f"s{ismpl}_k{k}"
                stats = progress[f"r_{key}"]
                local[k] = dict(rmax=float(stats[0]), disp=float(stats[1]),
                                coph=float(stats[2]),
                                wmax=progress[f"w_{key}"],
                                hmax=progress[f"h_{key}"])
            if verbose >= 1:
                print(f"Sample# {ismpl + 1}: restored from checkpoint")
        else:
            local = sample(ismpl)
            if progress_file is not None:
                for k in range(nrank):
                    key = f"s{ismpl}_k{k}"
                    progress[f"r_{key}"] = np.asarray(
                        [local[k]["rmax"], local[k]["disp"],
                         local[k]["coph"]], np.float64)
                    progress[f"w_{key}"] = local[k]["wmax"]
                    progress[f"h_{key}"] = local[k]["hmax"]
                np.savez(progress_file, **progress)
        for k in range(nrank):
            res = local[k]
            if ismpl == 0:
                wdat[k], hdat[k] = res["wmax"].copy(), res["hmax"].copy()
            else:
                wdat[k] += res["wmax"]
                hdat[k] += res["hmax"]
            rdat[k].append(float(res["rmax"]))
            ddat[k].append(float(res["disp"]))
            cdat[k].append(float(res["coph"]))

    if progress_file is not None and os.path.exists(progress_file):
        os.remove(progress_file)

    for k in range(nrank):
        wdat[k] /= nsmpl
        hdat[k] /= nsmpl
    rave = [float(np.mean(v)) for v in rdat]
    dave = [float(np.mean(v)) for v in ddat]
    cave = [float(np.mean(v)) for v in cdat]

    out_obj = obj[np.arange(obj.n_genes), np.arange(obj.n_cells)]
    out_obj.ranks = list(ranks)
    out_obj.basis = [np.asarray(w) for w in wdat]
    out_obj.coeff = [np.asarray(h) for h in hdat]
    out_obj.dbasis = [np.zeros_like(w) for w in wdat]
    out_obj.dcoeff = [np.zeros_like(h) for h in hdat]
    if randomize and nsmpl > 1:
        denom = np.sqrt(nsmpl - 1)
        rste = [float(np.std(v, ddof=1) / denom) for v in rdat]
        dste = [float(np.std(v, ddof=1) / denom) for v in ddat]
        cste = [float(np.std(v, ddof=1) / denom) for v in cdat]
        out_obj.measure = pd.DataFrame(dict(
            rank=ranks, likelihood=rave, r_se=rste, dispersion=dave,
            d_se=dste, cophenetic=cave, c_se=cste))
    else:
        out_obj.measure = pd.DataFrame(dict(
            rank=ranks, likelihood=rave, dispersion=dave,
            cophenetic=cave))
    if coph_ses:
        out_obj.metadata["cophenetic_se"] = coph_ses
        out_obj.metadata["cophenetic_subsampled"] = dict(
            max_cells=int(cophenetic_max_cells),
            nsub=int(cophenetic_nsub))
    if store_connectivity:
        out_obj.metadata.update(nrun=nrun, connectivity=conav_last)
    out_obj.metadata["timings"] = timings.summary()
    out_obj.validate()
    return out_obj
