"""Variational-Bayes factorization driver in PyTorch.

Counterpart of ``ccfindr_tpu.drivers.vb_driver.vb_factorize``
(reference vb_factorize / vb_iterate, R/bayesian.R:229-390):

* restarts and ranks are an explicit lane axis: the batched rank scan
  pads every (rank, run) lane to ``max(ranks)`` with prefix rank masks
  and runs them as one lane batch; the sequential loop runs one rank's
  ``nrun`` restarts at a time;
* ``backend='pallas'`` runs the sweep as the CUDA kernels of
  :mod:`ccfindr_tpu_torch.ops.kernels.sol` on the card (their plain
  PyTorch version on the CPU); ``'dense'`` and ``'dense_fused'`` are
  the matmul parity paths of :mod:`ccfindr_tpu_torch.ops.vb`;
* degeneracy (a uniform basis column) aborts the rank scan for that
  run, and best-of-nrun selection fills the measure table, as in the
  reference (R/bayesian.R:268-291, 368-378).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from ..container import SCSet
from ..ops import consensus as cons
from ..ops import vb as vb_ops
from ..ops.kernels import sol as sol_ops
from ..ops.vb import Hyper, VBState
from ..utils import Timings, auto_storage_dtype


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to "
                               f"ccfindr_tpu_torch yet (ROADMAP {item})")


def _resolve_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "plain PyTorch path")
    return device


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


def vb_factorize(object, ranks=2, nrun=1, verbose=2,
                 initializer="random", Itmax=10000,
                 hyper_update=(True, True, True, True),
                 gamma_a=1.0, gamma_b=1.0, Tol=1e-5,
                 hyper_update_n0=10, hyper_update_dn=1,
                 connectivity=False, fudge=None, unif_stop=True,
                 dtype=None, seed=0, mesh=None, backend="dense",
                 batch_ranks="auto", checkpoint_dir=None,
                 checkpoint_every=None, compact_every=None,
                 distributed="auto", svd_method="auto",
                 storage_dtype="auto", elbo_every=1, precision="f32",
                 device="cuda"):
    """Bayesian NMF inference of a count matrix.

    The keywords mirror the reference (R/bayesian.R:229-236) and the
    JAX package.  ``device`` (default ``"cuda"``) is where the lanes
    run; it raises when no card is present.  ``dtype=None`` is float32
    on the card and float64 on the CPU.  ``backend``:

    * ``'dense'`` (default) — matmul sweep, two passes over X;
    * ``'dense_fused'`` — matmul sweep, one pass over X (deferred ELBO);
    * ``'pallas'`` — the hand-written CUDA sweep
      (ops/kernels/sol.py, ``csrc/sol.cu``) on the card, its plain
      PyTorch version on the CPU.  ``elbo_every=k`` evaluates the ELBO
      and the stopping test only every k-th sweep on this backend.

    ``batch_ranks='auto'`` batches all (rank, run) lanes when there
    are several ranks.  ``storage_dtype='auto'`` keeps integer counts
    that fit in int8/int16 compressed on the device (exact: the sweep
    converts them to the factor type in registers).

    Options of the JAX package that the port does not carry yet raise
    ``NotImplementedError`` naming the ROADMAP item that brings them:
    ``mesh``, ``distributed``, ``checkpoint_*``, ``compact_every``,
    ``backend='sparse'``/``'pallas2pass'``, ``precision='bf16'`` and
    ``svd_method='randomized'``.

    Returns a new :class:`SCSet` with ranks/basis/dbasis/coeff/dcoeff
    and the measure table (rank, lml, aw, bw, ah, bh, nunif) filled.
    """
    if mesh is not None:
        raise _not_ported("mesh", "A7")
    if distributed not in ("auto", False, None):
        raise _not_ported("distributed", "A7")
    if checkpoint_dir is not None or checkpoint_every is not None:
        raise _not_ported("checkpoint_dir/checkpoint_every", "A3")
    if compact_every is not None:
        raise _not_ported("compact_every", "A3")
    if backend in ("sparse", "pallas2pass"):
        raise _not_ported(f"backend={backend!r}",
                          "A6" if backend == "sparse" else "B5")
    if backend not in ("dense", "dense_fused", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if precision == "bf16":
        raise _not_ported("precision='bf16'", "B1")
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    if svd_method == "randomized":
        raise _not_ported("svd_method='randomized'", "A8")
    if elbo_every != 1 and backend != "pallas":
        raise ValueError("elbo_every is supported by backend='pallas'")

    device = _resolve_device(device)
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
    mat = _as_counts_matrix(obj, np_dtype)
    n, m = mat.shape
    if (mat.sum(axis=1) == 0).any():
        raise ValueError("Input matrix contains empty rows")
    if (mat.sum(axis=0) == 0).any():
        raise ValueError("Input matrix contains empty columns")
    ranks = [r for r in ranks if r <= m]
    for r in ranks:
        if r > min(n, m):
            raise ValueError("Rank exceeded min(nrow,ncol)")
    if svd_method == "auto":
        if initializer in ("svd", "svd2") and min(n, m) > 4096:
            raise _not_ported("svd_method='randomized' (chosen by "
                              "'auto' above 4096)", "A8")
        svd_method = "exact"

    gamma_a = np.atleast_1d(np.asarray(gamma_a, dtype=float))
    gamma_b = np.atleast_1d(np.asarray(gamma_b, dtype=float))
    aw0, ah0 = float(gamma_a[0]), float(gamma_a[-1])
    bw0, bh0 = float(gamma_b[0]), float(gamma_b[-1])
    h1 = Hyper(aw=aw0, bw=bw0, ah=ah0, bh=bh0)
    hyper_mask = tuple(bool(b) for b in hyper_update)
    gen = torch.Generator().manual_seed(int(seed))

    # compressed integer X storage (exact; see utils.auto_storage_dtype)
    x_dtype = dtype
    if isinstance(storage_dtype, str) and storage_dtype == "auto":
        storage_dtype = auto_storage_dtype(mat)
    if storage_dtype is not None:
        sd = np.dtype(storage_dtype)
        if sd.kind not in "iu":
            raise ValueError("storage_dtype must be an integer dtype")
        if np.any(mat != np.round(mat)):
            raise ValueError(
                "storage_dtype requires integer counts (normalized "
                "matrices are float — factorize raw counts instead)")
        if float(mat.max()) > np.iinfo(sd).max:
            raise ValueError(
                f"counts up to {mat.max():.0f} overflow "
                f"storage_dtype {sd.name}; use a wider type")
        x_dtype = torch.from_numpy(np.zeros(0, sd)).dtype
    x = torch.as_tensor(mat).to(device=device, dtype=x_dtype)

    run_kwargs = dict(tol=float(Tol), fudge=fudge, hyper_mask=hyper_mask,
                      n0=int(hyper_update_n0), dn=int(hyper_update_dn))
    if backend == "pallas":
        run_fn = sol_ops.vb_run_sol
        run_kwargs["elbo_every"] = int(elbo_every)
    else:
        run_fn = vb_ops.vb_run
        if backend == "dense_fused":
            run_kwargs["fused"] = vb_ops.fused_dense
    itmax = int(Itmax)

    def init_state(rank):
        if initializer == "random":
            return vb_ops.vb_init_random(gen, n, m, rank, h1, dtype,
                                         device)
        return vb_ops.vb_init_svd(mat, rank, h1, variant=initializer,
                                  dtype=dtype, method=svd_method,
                                  seed=seed, device=device)

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
        batch_ranks = len(ranks) > 1
    if batch_ranks:
        rmax_ = max(ranks)
        nb = nrank * nrun
        rank_arr = np.repeat(np.asarray(ranks, np.int64), nrun)
        if initializer == "random":
            states = [init_state(rmax_) for _ in range(nb)]
        else:
            per_rank = {r: _pad_state_rank(init_state(r), rmax_)
                        for r in ranks}
            states = [per_rank[int(r)] for r in rank_arr]
        rmask = torch.as_tensor(
            (np.arange(rmax_)[None, :] < rank_arr[:, None]
             ).astype(np_dtype), device=device)
        rtrue = torch.as_tensor(rank_arr.astype(np_dtype), device=device)
        with timings.phase("vb_rank_batch", ranks=list(ranks), nrun=nrun):
            out = run_fn(x, _stack(states), hyper_batch(nb), itmax=itmax,
                         rank_mask=rmask, r_true=rtrue, **run_kwargs)
            out = vb_ops.state_to_numpy(out)
        timings.records[-1]["total_sweeps"] = int(out.n_iter.sum())
        timings.records[-1]["lane_sweeps_executed"] = (
            nb * (int(np.max(out.n_iter)) + 1))
        if out.hyper_failed.any():
            print("Warning: hyperparameter update did not converge "
                  "in some runs")
        for k, rank in enumerate(ranks):
            for i in range(nrun):
                if run_alive[i]:
                    _record(out, k * nrun + i, i, k, rank)
        ranks_iter = []
    else:
        ranks_iter = list(enumerate(ranks))

    for k, rank in ranks_iter:
        if not run_alive.any():
            break
        if verbose == 1:
            print(f"[{k + 1}/{nrank}] rank {rank} ...", flush=True)
        states = [init_state(rank)
                  for _ in range(nrun if initializer == "random" else 1)]
        with timings.phase("vb_rank", rank=rank, nrun=nrun):
            out = run_fn(x, _stack(states), hyper_batch(len(states)),
                         itmax=itmax, **run_kwargs)
            out = vb_ops.state_to_numpy(out)
        timings.records[-1]["total_sweeps"] = int(out.n_iter.sum())
        if out.hyper_failed.any():
            print("Warning: hyperparameter update did not converge "
                  "in some runs")
        for i in range(nrun):
            if run_alive[i]:
                _record(out, i, i, k, rank)

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
