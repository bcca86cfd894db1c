"""Maximum-likelihood (Lee–Seung KL) NMF core in PyTorch.

Counterpart of ``ccfindr_tpu.ops.ml`` (reference R/factorize.R:2-49).
The functions keep the JAX package's names and argument order; where
the JAX package vmapped ``ml_run`` over restarts, the port carries an
explicit leading lane axis:

* factors are ``w (B, n, r)`` and ``h (B, r, m)``, a lane's rank mask
  ``(B, r)``, its hard assignment ``(B, m)``; the per-sweep math
  (:func:`ml_sweep`, :func:`likelihood`, :func:`hard_assign`, ...)
  broadcasts over any leading axes, so it also takes one unbatched
  ``(n, r)``/``(r, m)`` pair;
* the convergence loop (:func:`ml_run`) is a Python loop over the lane
  batch.  Each lane keeps its own sweep counter, and a lane whose
  stopping rule fired (or whose sweep bound ran out) is frozen, as
  ``vmap`` of a ``while_loop`` freezes it, so ``n_iter``, ``lkh`` and
  ``cid`` of every lane equal those of the vmapped JAX loop.

The connectivity criterion decides partition equality from the r x r
contingency table (see ``ccfindr_tpu.ops.ml``), O(m + r^2) a lane.

On a mesh the deferred-likelihood loop may carry ``h`` and its cluster
ids as cell shards (``parallel.hshards.HShards``), as the JAX driver
places ``h0`` (``P(runs, None, cells)``): the H update, the frozen-lane
selects and the hard assignments run on each shard's device, the sums
over cells are finished from the shards' partials (``hshards.hsum``)
and the contingency tables are added over the shards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.hshards import HShards, hmap, hsum, to_numpy
from ..utils import lane_colsum, lane_matmul, lane_sum, resolve_device


def _mT(a):
    return a.transpose(-1, -2)


def ml_sweep(x, w, h, eps, pn=0.0, pd=0.0, rank_mask=None):
    """One KL multiplicative update of H then W (reference nmf_updateR,
    R/factorize.R:2-27).

    ``pn``/``pd`` are the optional gamma-prior MAP terms added to the
    numerators/denominators; ``rank_mask`` (..., r) pins masked rank
    components at ``eps`` (a tensor in the factor dtype).
    """
    xf = x.to(w.dtype)
    h = (h * lane_matmul(_mT(w), xf / lane_matmul(w, h)) + pn) \
        / (lane_colsum(w)[..., :, None] + pd)
    h = torch.maximum(h, eps)
    if rank_mask is not None:
        h = torch.where(rank_mask[..., :, None] > 0, h, eps)
    w = (w * lane_matmul(xf / lane_matmul(w, h), _mT(h)) + pn) \
        / (lane_sum(h)[..., None, :] + pd)
    w = torch.maximum(w, eps)
    if rank_mask is not None:
        w = torch.where(rank_mask[..., None, :] > 0, w, eps)
    return w, h


def likelihood(x, w, h, lgx_zero_term):
    """Per-element Poisson log-likelihood, KL form (reference
    R/factorize.R:40-49); ``lgx_zero_term`` = sum_{x>0}(-x log x + x).
    One value per lane."""
    xf = x.to(w.dtype)
    wh = lane_matmul(w, h)
    val = lane_sum(xf * torch.log(wh) - wh, 2) + lgx_zero_term
    return val / (x.shape[-2] * x.shape[-1])


def likelihood_const(x, dtype=None):
    """The data-only term sum_{x>0}(-x log x + x) of the likelihood.
    ``x`` is a dense tensor or a sparse layout, whose ``.val`` holds
    every nonzero once (zeros contribute 0 either way)."""
    if not isinstance(x, torch.Tensor):
        x = x.val
    if dtype is not None:
        x = x.to(dtype)
    pos = x > 0
    xl = torch.where(pos, -x * torch.log(torch.where(pos, x, 1.0)) + x,
                     0.0)
    return xl.sum()


def _argmax_rank(h):
    return torch.argmax(h, dim=-2).to(torch.int32)


def hard_assign(h):
    """argmax cluster id per cell (0-based) over the rank axis -2.
    Ties go to the first maximal index, as ``jnp.argmax`` has it
    (``torch.argmax`` documents the same rule).  Cell shards give the
    ids as cell shards."""
    return hmap(_argmax_rank, h)


def _contingency(cid0, cid1, r):
    idx = cid0.to(torch.int64) * r + cid1.to(torch.int64)
    tab = torch.zeros(idx.shape[:-1] + (r * r,), dtype=torch.int64,
                      device=idx.device)
    return tab.scatter_add_(-1, idx, torch.ones_like(idx))


def partitions_equal(cid0, cid1, r: int):
    """True iff two hard assignments induce the same comembership, per
    lane: the r x r contingency table of (cid0, cid1) has at most one
    nonzero entry in every row and every column.  ``cid0``/``cid1``
    are (..., m), or cell shards, whose tables (exact integer counts)
    are added on the first shard's device; the result is (...,)."""
    tab = hmap(lambda a, b: _contingency(a, b, r), cid0, cid1)
    if isinstance(tab, HShards):
        tab = sum(t.to(tab[0].device) for t in tab)
    nz = (tab > 0).view(tab.shape[:-1] + (r, r))
    rows_ok = (nz.sum(-1) <= 1).all(-1)
    cols_ok = (nz.sum(-2) <= 1).all(-1)
    return rows_ok & cols_ok


class MLRunResult(NamedTuple):
    w: torch.Tensor
    h: torch.Tensor
    lkh: torch.Tensor
    n_iter: torch.Tensor
    cid: torch.Tensor
    # connectivity-criterion streak counter at exit (0 under the
    # likelihood criterion): part of the resume carry
    zstep: torch.Tensor
    # True iff the stopping rule fired (vs the sweep bound running out)
    done: torch.Tensor


def ml_h_dense(x, w, h):
    """H-phase as matmuls: the H-update numerator w^T(x/wh) and the
    likelihood data term sum x*log(wh) for the same (w, h)."""
    xf = x.to(w.dtype)
    wh = lane_matmul(w, h)
    return lane_matmul(_mT(w), xf / wh), lane_sum(xf * torch.log(wh), 2)


def ml_w_dense(x, w, h):
    """W-phase as matmuls: the W-update numerator (x/wh) h^T."""
    return lane_matmul(x.to(w.dtype) / lane_matmul(w, h), _mT(h))


# ---------------------------------------------------------------------
# Convergence loops over a lane batch (reference R/factorize.R:187-213)
# ---------------------------------------------------------------------

def _lanes(flag, t):
    return flag.view(flag.shape + (1,) * (t.dim() - flag.dim()))


def _where_lanes(flag, new, old):
    return torch.where(_lanes(flag, new), new, old)


def _pick(flag, new, old):
    """Per lane: ``new`` where ``flag``, else ``old`` (cell shards shard
    by shard)."""
    return hmap(_where_lanes, flag, new, old)


def _cid_start(h, cid0):
    nb, m = h.shape[0], h.shape[-1]
    if cid0 is None:
        return torch.zeros(nb, m, dtype=torch.int32, device=h.device)
    return torch.as_tensor(cid0, device=h.device).to(torch.int32) \
        .expand(nb, m).clone()


def _loop_start(w0, h0, tol, lk0_init, it0, cid0, zstep0):
    nb = w0.shape[0]
    dev, ref_t = w0.device, w0.dtype
    eps = torch.tensor(torch.finfo(ref_t).eps, dtype=ref_t, device=dev)
    tol = torch.as_tensor(tol, dtype=ref_t, device=dev)
    lk = torch.as_tensor(-np.inf if lk0_init is None else lk0_init,
                         dtype=ref_t, device=dev).expand(nb).clone()
    it = torch.full((nb,), int(it0), dtype=torch.int64, device=dev)
    cid = hmap(_cid_start, h0, cid0)
    zstep = (torch.zeros(nb, dtype=torch.int32, device=dev)
             if zstep0 is None
             else torch.as_tensor(zstep0, device=dev).to(torch.int32)
             .expand(nb).clone())
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    return eps, tol, lk, it, cid, zstep, done


def ml_run(x, w0, h0, *, itmax=10000, tol: float = 1e-5,
           criterion: str = "likelihood", ncnn_step: int = 40,
           fused_h=None, fused_w=None, nm_true=None,
           pn=0.0, pd=0.0, rank_mask=None,
           it0=1, lk0_init=None, cid0=None, zstep0=None) -> MLRunResult:
    """Iterate :func:`ml_sweep` to convergence for a lane batch
    ``w0 (B, n, r)``, ``h0 (B, r, m)``.

    criterion='likelihood': a lane stops when |lkold - lk| <
    tol*|lkold|.  criterion='connectivity': it stops after
    ``ncnn_step`` consecutive sweeps with an unchanged hard partition.

    ``fused_h``/``fused_w`` (``ml_h_dense``/``ml_w_dense``, the CUDA
    pair of :func:`ccfindr_tpu_torch.ops.kernels.ml.make_ml_backend`, or
    the sparse pair of :func:`ccfindr_tpu_torch.ops.tile.
    make_tile_ml_backend` over a ``TileCounts`` X):
    ``fused_h(x, w, h) -> (hn (B,r,m), xlogwh (B,))``, ``fused_w(x, w,
    h') -> wn (B,n,r)``, select the deferred-likelihood loop
    :func:`_ml_run_fused` (two passes over X a sweep instead of three,
    the identical stopping sequence).  ``nm_true`` overrides the
    (n, m) the likelihood is normalised by (default: the factors'
    extents).

    ``rank_mask`` (B, r) and ``lk0_init`` (B,), ``cid0`` (B, m),
    ``zstep0`` (B,) are per lane; ``it0`` resumes every lane at one
    sweep index: pass a bounded call's ``n_iter + 1``, ``lkh``, ``cid``
    and ``zstep`` with its final (w, h) and the loop continues the exact
    stopping sequence of one uninterrupted run.

    Unlike the JAX package's eager connectivity loop, which drops
    ``pn``/``pd`` and ``rank_mask`` (so a masked lane of a batched rank
    scan runs at the full padded rank), this loop applies them, as both
    fused loops of the JAX package do.
    """
    if criterion not in ("likelihood", "connectivity"):
        raise ValueError("Unknown stopping criterion.")
    if fused_h is None and isinstance(h0, HShards):
        raise ValueError("h carried as cell shards needs the fused "
                         "passes of a mesh (fused_h/fused_w)")
    if fused_h is not None:
        return _ml_run_fused(x, w0, h0, itmax=itmax, tol=tol,
                             criterion=criterion, ncnn_step=ncnn_step,
                             fused_h=fused_h, fused_w=fused_w,
                             nm_true=nm_true, pn=pn, pd=pd,
                             rank_mask=rank_mask, it0=it0,
                             lk0_init=lk0_init, cid0=cid0, zstep0=zstep0)
    eps, tol, lk, it, cid, zstep, done = _loop_start(
        w0, h0, tol, lk0_init, it0, cid0, zstep0)
    lgconst = likelihood_const(x, w0.dtype)
    r = h0.shape[-2]
    conn = criterion == "connectivity"
    w, h = w0, h0
    while True:
        active = (~done) & (it <= itmax)
        if not bool(active.any()):
            break
        w1, h1 = ml_sweep(x, w, h, eps, pn=pn, pd=pd, rank_mask=rank_mask)
        lk1 = likelihood(x, w1, h1, lgconst)
        if conn:
            c1 = hard_assign(h1)
            same = (it > 1) & partitions_equal(cid, c1, r)
            z1 = torch.where(same, zstep + 1, 0).to(torch.int32)
            stop = z1 == ncnn_step
            cid = _pick(active, c1, cid)
            zstep = torch.where(active, z1, zstep)
        else:
            stop = torch.abs(lk - lk1) < tol * torch.abs(lk)
        w = _pick(active, w1, w)
        h = _pick(active, h1, h)
        lk = torch.where(active, lk1, lk)
        done = torch.where(active, stop, done)
        it = it + active.to(it.dtype)
    if not conn:
        zstep = torch.zeros_like(zstep)
    return MLRunResult(w=w, h=h, lkh=lk, n_iter=it - 1, cid=hard_assign(h),
                       zstep=zstep, done=done)


def _ml_run_fused(x, w0, h0, *, itmax, tol, criterion, ncnn_step,
                  fused_h, fused_w, nm_true=None, pn=0.0, pd=0.0,
                  rank_mask=None, it0=1, lk0_init=None, cid0=None,
                  zstep0=None) -> MLRunResult:
    """Deferred-likelihood loop over the single-pass H and W phases
    (see ``ccfindr_tpu.ops.ml._ml_run_fused``).

    criterion='likelihood': iteration i completes the likelihood of
    sweep i-1 from fused_h's x*log(wh) sum (same (w, h)), checks the
    stopping rule one iteration late on identical inputs, then performs
    sweep i; so ``n_iter = it - 2``.  criterion='connectivity': the
    partition check needs only the updated H; the final likelihood
    costs one more fused_h after the loop.  On resume the check of
    sweep it0-1 belongs to the previous call (``valid`` guard).
    """
    eps, tol, lk2, it, cid, zstep, done = _loop_start(
        w0, h0, tol, lk0_init, it0, cid0, zstep0)
    ref_t = w0.dtype
    lgconst = likelihood_const(x, ref_t)
    r = h0.shape[-2]
    n, m = nm_true if nm_true is not None else (w0.shape[-2], h0.shape[-1])
    it_start = int(it0)

    dev = w0.device

    def lk_of(xlw, w, h):
        # -sum(wh) reduces in rank space: colSums(w) . rowSums(h)
        return ((xlw.to(ref_t) - lane_sum(lane_colsum(w) * hsum(h, 1, dev))
                 + lgconst)
                / (n * m))

    def h_update(h, hn, csum, rank_mask, eps):
        h1 = torch.maximum((h * hn + pn) / (csum + pd), eps)
        if rank_mask is not None:
            h1 = torch.where(rank_mask[..., :, None] > 0, h1, eps)
        return h1

    def do_sweep(w, h, hn):
        h1 = hmap(h_update, h, hn, lane_colsum(w)[..., :, None], rank_mask,
                  eps)
        wn = fused_w(x, w, h1)
        w1 = torch.maximum((w * wn + pn) / (hsum(h1, 1, dev)[..., None, :]
                                            + pd), eps)
        if rank_mask is not None:
            w1 = torch.where(rank_mask[..., None, :] > 0, w1, eps)
        return w1, h1

    w, h = w0, h0
    if criterion == "likelihood":
        while True:
            active = (~done) & (it <= itmax + 1)
            if not bool(active.any()):
                break
            hn, xlw = fused_h(x, w, h)
            lk_prev = lk_of(xlw, w, h)        # likelihood of sweep it-1
            checked = ((it - 1) >= it_start) & (it >= 2)
            conv = checked & (torch.abs(lk2 - lk_prev) < tol * torch.abs(lk2))
            take = active & ~conv & (it <= itmax)
            w1, h1 = do_sweep(w, h, hn)
            w = _pick(take, w1, w)
            h = _pick(take, h1, h)
            lk2 = torch.where(active & checked, lk_prev, lk2)
            done = torch.where(active, conv, done)
            it = it + active.to(it.dtype)
        return MLRunResult(w=w, h=h, lkh=lk2, n_iter=it - 2,
                           cid=hard_assign(h), zstep=torch.zeros_like(zstep),
                           done=done)

    while True:
        active = (~done) & (it <= itmax)
        if not bool(active.any()):
            break
        hn, _ = fused_h(x, w, h)
        w1, h1 = do_sweep(w, h, hn)
        c1 = hard_assign(h1)
        same = (it > 1) & partitions_equal(cid, c1, r).to(it.device)
        z1 = torch.where(same, zstep + 1, 0).to(torch.int32)
        w = _pick(active, w1, w)
        h = _pick(active, h1, h)
        cid = _pick(active, c1, cid)
        zstep = torch.where(active, z1, zstep)
        done = torch.where(active, z1 == ncnn_step, done)
        it = it + active.to(it.dtype)
    _, xlw = fused_h(x, w, h)
    return MLRunResult(w=w, h=h, lkh=lk_of(xlw, w, h), n_iter=it - 1,
                       cid=cid, zstep=zstep, done=done)


def ml_init(generator, n, m, rank, dtype=torch.float32, device="cuda"):
    """Uniform-random init (reference R/factorize.R:30-38) from the
    explicit ``torch.Generator``: drawn on the generator's device in
    float64, then cast and moved, so a seed gives the same factors on
    any ``device``."""
    device = resolve_device(device)
    gdev = generator.device
    w = torch.rand((n, rank), generator=generator, dtype=torch.float64,
                   device=gdev)
    h = torch.rand((rank, m), generator=generator, dtype=torch.float64,
                   device=gdev)
    return (w.to(device=device, dtype=dtype),
            h.to(device=device, dtype=dtype))


# ---------------------------------------------------------------------
# Lane batches carried between the two packages
# ---------------------------------------------------------------------

def ml_state_from_numpy(obj, device="cuda", dtype=None):
    """Carry a JAX package ``MLRunResult`` (passed through ``np.asarray``
    field by field), a ``(w, h)`` pair of lane batches, or one array
    into the port's tensors on ``device``; floating fields take
    ``dtype`` when given."""
    device = resolve_device(device)
    if isinstance(obj, tuple):
        fields = [ml_state_from_numpy(f, device, dtype) for f in obj]
        if type(obj).__name__ == "MLRunResult":
            return MLRunResult(*fields)
        return tuple(fields)
    t = torch.tensor(np.asarray(obj), device=device)    # a copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def ml_state_to_numpy(obj):
    """Inverse of :func:`ml_state_from_numpy`: the same tuple (or
    ``MLRunResult``) with every tensor as a host numpy array (cell
    shards joined on the host)."""
    if isinstance(obj, HShards):
        return to_numpy(obj)
    if isinstance(obj, tuple):
        fields = [ml_state_to_numpy(f) for f in obj]
        return type(obj)(*fields) if hasattr(obj, "_fields") \
            else tuple(fields)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)
