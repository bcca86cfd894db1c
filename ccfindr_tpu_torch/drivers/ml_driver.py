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
  PyTorch versions on the CPU); ``'dense'`` and ``'dense_fused'`` are
  the matmul paths of :mod:`ccfindr_tpu_torch.ops.ml`;
* consensus statistics stream through
  :class:`~ccfindr_tpu_torch.ops.consensus.ConsensusAccumulator`: exact
  dispersion without the m(m-1)/2 connectivity vector, and a
  subsampled cophenetic above ``cophenetic_max_cells``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from ..container import SCSet
from ..ops import consensus as cons
from ..ops import ml as ml_ops
from ..ops.kernels import ml as ml_kernels
from ..utils import Timings, auto_storage_dtype
from .vb_driver import _not_ported, _resolve_device


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
      versions on the CPU.

    ``batch_ranks='auto'`` batches all (rank, run) lanes when there are
    several ranks.  ``storage_dtype='auto'`` keeps integer counts that
    fit in int8/int16 compressed on the device (exact).  ``prior=True``
    enables the gamma-prior MAP terms with ``gamma_a``/``gamma_b``.
    Above ``cophenetic_max_cells`` cells the cophenetic correlation is
    the mean of ``cophenetic_nsub`` exact subsampled draws (standard
    errors in ``metadata['cophenetic_se']``).

    Options of the JAX package that the port does not carry yet raise
    ``NotImplementedError`` naming the ROADMAP item that brings them:
    ``mesh`` and ``distributed`` (A7), ``checkpoint_dir``/
    ``checkpoint_every``/``compact_every`` (A3), ``backend='sparse'``
    (A6).

    Returns a new :class:`SCSet` with ranks/basis/coeff and the measure
    table (rank, likelihood, dispersion, cophenetic; with the standard
    errors r_se, d_se, c_se for randomized replicates) filled.
    """
    if mesh is not None:
        raise _not_ported("mesh", "A7")
    if distributed not in ("auto", False, None) or (
            _process_count not in (None, 1)):
        raise _not_ported("distributed", "A7")
    if checkpoint_dir is not None or checkpoint_every is not None:
        raise _not_ported("checkpoint_dir/checkpoint_every", "A3")
    if compact_every is not None:
        raise _not_ported("compact_every", "A3")
    if backend == "sparse":
        raise _not_ported("backend='sparse'", "A6")
    if backend not in ("dense", "dense_fused", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if criterion not in ("likelihood", "connectivity"):
        raise ValueError("Unknown stopping criterion.")

    device = _resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    if np.isscalar(ranks):
        ranks = [int(ranks)]
    ranks = [int(r) for r in ranks]

    obj = object if isinstance(object, SCSet) else SCSet(
        count=object, remove_zeros=False)
    mat0 = obj.counts_dense(dtype=np_dtype)
    n, m = mat0.shape
    if (mat0.sum(axis=1) == 0).any():
        raise ValueError("Input matrix contains empty rows")
    if (mat0.sum(axis=0) == 0).any():
        raise ValueError("Input matrix contains empty columns")

    # compressed integer X storage (exact; see utils.auto_storage_dtype)
    x_dtype = dtype
    if isinstance(storage_dtype, str) and storage_dtype == "auto":
        storage_dtype = auto_storage_dtype(mat0)
    if storage_dtype is not None:
        sd = np.dtype(storage_dtype)
        if sd.kind not in "iu":
            raise ValueError("storage_dtype must be an integer dtype")
        if np.any(mat0 != np.round(mat0)):
            raise ValueError(
                "storage_dtype requires integer counts (normalized "
                "matrices are float — factorize raw counts instead)")
        if float(mat0.max()) > np.iinfo(sd).max:
            raise ValueError(
                f"counts up to {mat0.max():.0f} overflow "
                f"storage_dtype {sd.name}; use a wider type")
        x_dtype = torch.from_numpy(np.zeros(0, sd)).dtype

    pn = float(gamma_a) - 1.0 if prior else 0.0
    pd_ = float(gamma_a) / float(gamma_b) if prior else 0.0
    run_kwargs = dict(tol=float(Tol), criterion=criterion,
                      ncnn_step=int(ncnn_step), itmax=int(Itmax), pn=pn,
                      pd=pd_)
    if backend == "dense_fused":
        run_kwargs.update(fused_h=ml_ops.ml_h_dense,
                          fused_w=ml_ops.ml_w_dense)
    elif backend == "pallas":
        fh, fw = ml_kernels.make_ml_backend()
        run_kwargs.update(fused_h=fh, fused_w=fw)

    nrank = len(ranks)
    if batch_ranks == "auto":
        batch_ranks = nrank > 1
    timings = Timings()
    coph_ses = []
    wdat, hdat = [None] * nrank, [None] * nrank
    rdat = [[] for _ in range(nrank)]
    ddat = [[] for _ in range(nrank)]
    cdat = [[] for _ in range(nrank)]
    conav_last = None

    def consensus_stats(cids, lkhs, niters, label=""):
        """Best-of-run selection + streaming consensus over restarts
        (reference R/factorize.R:214-226)."""
        acc = cons.ConsensusAccumulator(m)
        rmax, imax = -np.inf, 0
        for i in range(len(lkhs)):
            acc.add(cids[i])
            lk = float(lkhs[i])
            if (i == 0 or lk > rmax) and not np.isnan(lk):
                rmax, imax = lk, i
            if verbose >= 2:
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

    def run(x, ismpl, pairs, r, name, **record):
        """One lane batch of rank ``r`` to convergence; the batched scan
        masks each lane's rank rows past its own rank."""
        w0, h0 = initial_factors(seed, ismpl, pairs, nrank, nrun, n, m, r,
                                 dtype, device)
        kw = dict(run_kwargs)
        if batch_ranks:
            rank_arr = np.asarray([ranks[k] for k, _ in pairs])
            kw["rank_mask"] = torch.as_tensor(
                (np.arange(r)[None, :] < rank_arr[:, None]
                 ).astype(np_dtype), device=device)
        with timings.phase(name, sample=ismpl, **record):
            out = ml_ops.ml_state_to_numpy(ml_ops.ml_run(x, w0, h0, **kw))
        rec = timings.records[-1]
        rec["total_sweeps"] = int(out.n_iter.sum())
        rec["lane_sweeps_executed"] = len(pairs) * (
            int(out.n_iter.max()) + 1)
        rec["n_iter"] = out.n_iter.tolist()
        return out

    for ismpl in range(nsmpl):
        if randomize:
            # per-sample deterministic stream (the JAX package's own)
            rng_i = np.random.default_rng(
                np.random.SeedSequence([seed, 104729 + ismpl]))
            mat = np.empty_like(mat0)
            for j in range(m):
                mat[:, j] = rng_i.permutation(mat0[:, j])
        else:
            mat = mat0
        with timings.phase("ml_setup", sample=ismpl):
            x = torch.as_tensor(mat).to(device=device, dtype=x_dtype)

        if batch_ranks:
            pairs = [(k, i) for k in range(nrank) for i in range(nrun)]
            out = run(x, ismpl, pairs, max(ranks), "ml_rank_batch",
                      ranks=list(ranks), nrun=nrun)
            groups = [(k, ranks[k], list(range(k * nrun, (k + 1) * nrun)),
                       out) for k in range(nrank)]
        else:
            groups = []
            for k, rank in enumerate(ranks):
                if verbose > 0:
                    print(f"Rank {rank} [{k + 1}/{nrank}]")
                out = run(x, ismpl, [(k, i) for i in range(nrun)], rank,
                          "ml_rank", rank=rank, nrun=nrun)
                groups.append((k, rank, list(range(nrun)), out))

        for k, rank, idxs, o in groups:
            # padded-rank lanes: slice the factors to the true rank
            # (padded rows are eps, never an argmax)
            label = f" rank {rank}" if batch_ranks else ""
            with timings.phase("ml_consensus", sample=ismpl, rank=rank):
                imax, rmax, disp, coph, conav = consensus_stats(
                    [o.cid[b] for b in idxs], [o.lkh[b] for b in idxs],
                    [o.n_iter[b] for b in idxs], label)
            wmax = np.asarray(o.w[idxs[imax]][:, :rank])
            hmax = np.asarray(o.h[idxs[imax]][:rank, :])
            conav_last = conav
            if verbose >= 1:
                print(f"Sample# {ismpl + 1}: rank {rank}: "
                      f"Max(likelihood) = {rmax:.6g}, dispersion = "
                      f"{disp:.6g}, cophenetic = {coph:.6g}")
            if ismpl == 0:
                wdat[k], hdat[k] = wmax.copy(), hmax.copy()
            else:
                wdat[k] += wmax
                hdat[k] += hmax
            rdat[k].append(float(rmax))
            ddat[k].append(float(disp))
            cdat[k].append(float(coph))

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
