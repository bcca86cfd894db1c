"""The VB sweep as hand-written CUDA, with its plain PyTorch version.

Counterpart of ``ccfindr_tpu/ops/pallas/sol.py``.  One sweep is four
CUDA kernels launched in order on the current stream of the card that
holds the tensors (``csrc/sol.cu``): K1 ``xpass`` (suffstats, ``x*log(wth)``,
``rowSums(eh)``), K2 ``w_post`` (W gamma posterior), K3 ``h_post`` (H
gamma posterior) and K4 ``finish`` (ELBO pieces and the damped hyper
Newton).  :func:`sol_sweep_plain` is the same sweep in plain PyTorch
(``torch.matmul`` for the three products, full-matrix elementwise
math); :func:`sol_sweep` takes it only for tensors on the CPU and
launches the kernels for CUDA tensors, with no fallback between them.
``mxu_bf16`` (``precision='bf16'``) rounds the X pass's operands to
bf16.  :func:`deferred_loop`, the convergence loop of
:func:`vb_run_sol`, also runs the gene-major sweep of
:mod:`.epilogue`, whose posterior kernels feed K4.

Layouts carry a leading lane axis B: X ``(np, mp)`` shared by all
lanes; W transposed ``lwt (B, rp, np)``; ``lh``/``eh (B, rp, mp)``;
``sc (B, 8)`` float64 ``[aw, bw, ah, bh, fudge, r_live, lgx,
do_elbo]``; the result ``scal (B, 16)`` float64 in the slot layout
below.  ``n``/``m_arr`` are the gene/cell counts of the state (columns
past them are padding: X 0, lwt/lh 1, eh 0), ``m_live`` the live cells
of a mesh-padded cell axis (cells in ``[m_live, m_arr)`` pinned
at ``fudge``), ``r`` the state's rank (rows in ``[r, rp)`` pad 0; rows
in ``[r_live, r)`` are a lane's masked components, pinned at
``fudge``).
"""

from __future__ import annotations

import functools

import torch

from .build import TCODE, XCODE, launch
from ...parallel.sharded import ShardedCounts
from ...utils import lgamma_sum
from ..vb import (VBRunResult, VBState, digamma_approx,
                  digamma_gammaln_both, gammaln_approx,
                  mask_initial_state, trigamma)

# the JAX package's tile sizes (ccfindr_tpu/ops/pallas/vb_kernels.py),
# taken by the JAX-named entry points and left unused: the kernels pick
# their own tiles
DEFAULT_BN = 1024
DEFAULT_BM = 512

# scal slots (csrc/sol.cu enum)
(XLOG, U2, U3, SEW, SLW, SEH, SLH, DTW, DTH,
 PEND, DTERM, AW, BW, AH, BH, HFAIL) = range(16)
NSCAL = 16

# tiling of csrc/sol.cu: a K1 block covers CHUNK = (genes, cells) of X
# (the one place K1's chunks are set), a K2/K3 block all rank rows of
# POST_COLS long-axis columns of a lane (csrc/post.cuh kPostCols, a
# thread an entry), one rank-sum and scalar partial a block.  The chunks
# and POST_COLS fix the order of the partial sums, so they depend on no
# lane count (resume and lane compaction stay bit-exact), and both divide
# 512: a cell shard whose extent is a multiple of 512 gives the
# single-device partials (sol_sharded).  At 256 x 256, the 10x shape
# (4,096 x 8,192, 6 lanes) launches 3,072 K1 blocks and a 2,048-cell
# shard 768 (2.9 waves at two blocks an SM on 132 SMs); at 32 columns K2
# launches 768 blocks, K3 1,536 and K3s on a shard 384.
CHUNK = (256, 256)
POST_COLS = 32
MAX_RP = 128

# K1's partials grow with X and the lane count: at the atlas shape
# (20,480 x 100,352, 392 cell chunks x 80 gene chunks, rp 24) they take
# 1.54 GB a lane, 58.6 GB for a batch of 38 lanes, which did not fit
# beside the carry on an 80 GB card once the allocator had split its
# cached blocks.  :func:`sol_sweep` launches K1-K3 over consecutive
# groups of lanes whose partials take at most LANE_GROUP_BYTES
# (:func:`lane_groups`), then K4 once on all lanes.  A lane's partials
# depend on CHUNK and POST_COLS alone, never on the lanes beside it, so
# grouping keeps every lane's bits; the 10x batch (6 lanes, 16.8 MB of
# partials a lane) is one group.
LANE_GROUP_BYTES = 16 << 30

# the convergence loop asks the device whether any lane is still
# running every HOST_CHECK_EVERY sweeps (one device->host sync each);
# stopped lanes are frozen, so any value gives the same result
HOST_CHECK_EVERY = 1

# launches per kernel since the last reset (bumped only where a kernel
# is launched)
LAUNCHES = {"xpass": 0, "w_post": 0, "h_post": 0, "finish": 0}



def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _check(x, lwt, lh, eh, sc, n, m, r, w_rowmajor=False):
    """Validate what the kernels (and the plain version) take: W as
    ``lwt (B, rp, np)``, or as ``lw (B, np, rp)`` when ``w_rowmajor``
    (the epilogue sweep's layout)."""
    if lwt.dtype not in TCODE:
        raise TypeError(f"factors must be float32 or float64, got "
                        f"{lwt.dtype}")
    if x.dtype not in XCODE:
        raise TypeError(f"X must be int8, int16, float32 or float64, "
                        f"got {x.dtype}")
    if lh.dtype != lwt.dtype or eh.dtype != lwt.dtype:
        raise TypeError("lwt, lh and eh must share one dtype")
    if sc.dtype != torch.float64:
        raise TypeError("sc must be float64")
    if x.dim() != 2 or lwt.dim() != 3:
        raise ValueError("X must be (np, mp) and lwt (B, rp, np)")
    np_, mp_ = x.shape
    nb, rp_, npw = lwt.shape
    if w_rowmajor:
        npw, rp_ = rp_, npw
    if npw != np_ or lh.shape != (nb, rp_, mp_) or eh.shape != lh.shape:
        raise ValueError(f"shape mismatch: X {tuple(x.shape)}, lwt "
                         f"{tuple(lwt.shape)}, lh {tuple(lh.shape)}, eh "
                         f"{tuple(eh.shape)}")
    if sc.shape != (nb, 8):
        raise ValueError(f"sc must be ({nb}, 8), got {tuple(sc.shape)}")
    if rp_ % 8 or rp_ > MAX_RP or not 0 < r <= rp_:
        raise ValueError(f"padded rank {rp_} must be a multiple of 8, "
                         f"at most {MAX_RP}, and hold r={r}")
    if not (0 < n <= np_ and 0 < m <= mp_):
        raise ValueError(f"true extents ({n}, {m}) exceed X {np_}x{mp_}")
    devs = {t.device for t in (x, lwt, lh, eh, sc)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    for name, t in (("x", x), ("lwt", lwt), ("lh", lh), ("eh", eh),
                    ("sc", sc)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------
# Plain PyTorch version, phase by phase
# ---------------------------------------------------------------------

def bf16_round(t):
    """``t`` rounded to the nearest bfloat16, kept in its dtype: the
    ``precision='bf16'`` operands of the X pass (``csrc/bf16.cuh``)."""
    return t.to(torch.bfloat16).to(t.dtype)


def xpass_plain(x, lwt, lh, eh, sc, mxu_bf16=False):
    """K1's function: (swnt (B,rp,np), shn (B,rp,mp), xlog (B,) f64,
    ehs (B,rp) f64 = rowSums of the incoming eh).  ``mxu_bf16`` rounds
    lwt, lh and u to bf16 before the products (the JAX kernel's
    ``mxu_bf16``); the sums and ``log(wth)`` stay in the factor dtype."""
    dt = lwt.dtype
    xf = x.to(dt)
    if mxu_bf16:
        lwt, lh = bf16_round(lwt), bf16_round(lh)
    wth = lwt.transpose(-1, -2) @ lh
    u = xf / wth
    if mxu_bf16:
        u = bf16_round(u)
    swnt = lh @ u.transpose(-1, -2)
    shn = lwt @ u
    xlog = torch.where(sc[:, 7] > 0,
                       (xf * torch.log(wth)).sum((-2, -1),
                                                 dtype=torch.float64),
                       0.0)
    return swnt, shn, xlog, eh.sum(-1, dtype=torch.float64)


def xpass_partials_plain(x, lwt, lh, eh, sc, mxu_bf16=False):
    """K1's output at its chunks (:data:`CHUNK`):
    (swn_part (B, ncc, rp, np), shn_part (B, ngc, rp, mp), xlog_part
    (B, ngc*ncc) f64 in (gene chunk, cell chunk) order, ehs_part (B, ncc,
    rp) f64), each partial the sum over one chunk.  K2/K3/K4 add them in
    chunk order in float64; summed so they give :func:`xpass_plain`'s
    values up to the order of the sums inside a chunk."""
    gch, cch = CHUNK
    dt = lwt.dtype
    xf = x.to(dt)
    if mxu_bf16:
        lwt, lh = bf16_round(lwt), bf16_round(lh)
    wth = lwt.transpose(-1, -2) @ lh
    u = xf / wth
    if mxu_bf16:
        u = bf16_round(u)
    np_, mp_ = x.shape
    gs = [slice(g0, g0 + gch) for g0 in range(0, np_, gch)]
    cs = [slice(c0, c0 + cch) for c0 in range(0, mp_, cch)]
    swn = torch.stack([lh[..., c] @ u[..., c].transpose(-1, -2)
                       for c in cs], 1)
    shn = torch.stack([lwt[..., g] @ u[:, g] for g in gs], 1)
    xl = xf * torch.log(wth)
    xlog = torch.stack([xl[:, g, c].sum((-2, -1), dtype=torch.float64)
                        for g in gs for c in cs], 1)
    xlog = torch.where(sc[:, 7:8] > 0, xlog, 0.0)
    ehs = torch.stack([eh[..., c].sum(-1, dtype=torch.float64)
                       for c in cs], 1)
    return swn, shn, xlog, ehs


def post_plain(sfx, lf, denom, a, b, fudge, r_live, r, ncol, npin=None):
    """K2/K3's function (``_post_tile``, post_kernel of
    ``csrc/post.cuh``): the gamma posterior of one factor in (rank rows,
    long-axis columns) layout.  ``denom`` (B, rp) float64 enters the
    beta; a, b, fudge, r_live are (B,) in the factor dtype; ``ncol`` is
    the live long-axis extent and ``npin`` (default ``ncol``) the extent
    whose non-live rank rows are pinned at ``fudge`` (the JAX H
    epilogue's ``m_live`` and ``m``).

    Returns (e, ln, d, rank_sums (B,rp) f64, scalars (B,4) f64 =
    [U, sum e, sum logl, dterm])."""
    dt = lf.dtype
    _, rows, cols = lf.shape
    row = torch.arange(rows, device=lf.device)[:, None]
    col = torch.arange(cols, device=lf.device)[None, :]
    live = (row.to(dt) < r_live[:, None, None]) & (col < ncol)
    pin = (row < r) & (col < (ncol if npin is None else npin))
    a3, b3, f3 = a[:, None, None], b[:, None, None], fudge[:, None, None]

    be = (1.0 / (a[:, None] / b[:, None] + denom.to(dt)))[..., None]
    log_be = torch.log(be)
    al = a3 + lf * sfx
    psi, lgam = digamma_gammaln_both(al)
    e = torch.where(live, al * be, 0.0)
    ln_raw = torch.exp(psi) * be
    pad = torch.where(row < r, 1.0, 0.0).to(dt)
    ln = torch.where(live, torch.maximum(ln_raw, f3),
                     torch.where(pin, f3, pad))
    d = torch.where(live, al * (be * be), 0.0)
    u = torch.where(live, -(a3 / b3) * e + al * (1.0 + log_be) + lgam,
                    0.0)
    logl = torch.where(live & (ln_raw > f3), psi + log_be,
                       torch.where(live, torch.log(f3), 0.0))
    dterm = torch.where(live, sfx * lf * torch.log(torch.where(live, lf,
                                                               1.0)),
                        0.0)
    f64 = torch.float64
    scal = torch.stack([t.sum((-2, -1), dtype=f64)
                        for t in (u, e, logl, dterm)], dim=-1)
    return e, ln, d, e.sum(-1, dtype=f64), scal


def _newton_plain(aw0, ah0, bw0, bh0, lwm, ewm, lhm, ehm, mask, niter,
                  tol):
    """``_newton_scalar`` per lane: Newton on the gamma shapes with
    iterated halving (non-finite steps zeroed), means closed-form."""
    def nstep(a0, mean_e, mean_l, b0, enabled):
        if not enabled:
            return torch.zeros_like(a0)
        return ((torch.log(a0) - digamma_approx(a0) - mean_e / b0 + 1.0
                 + mean_l - torch.log(b0))
                / (1.0 / a0 - trigamma(a0)))

    def pstep(a0, d):
        d = torch.where(torch.isfinite(d), d, 0.0)
        for _ in range(4096):
            bad = a0 - d <= 0
            if not bool(bad.any()):
                break
            d = torch.where(bad, d * 0.5, d)
        return d

    aw1, ah1 = aw0, ah0
    failed = torch.zeros(aw0.shape, dtype=torch.bool, device=aw0.device)
    if mask[0] or mask[2]:
        done = torch.zeros_like(failed)
        for _ in range(niter - 1):
            active = ~done
            if not bool(active.any()):
                break
            dw = pstep(aw1, nstep(aw1, ewm, lwm, bw0, mask[0]))
            dh = pstep(ah1, nstep(ah1, ehm, lhm, bh0, mask[2]))
            a1 = aw1 - dw
            h1 = ah1 - dh
            df = (1.0 - a1 / aw1) ** 2 + (1.0 - h1 / ah1) ** 2
            aw1 = torch.where(active, a1, aw1)
            ah1 = torch.where(active, h1, ah1)
            done = torch.where(active, df < tol, done)
        failed = ~done
    bw1 = ewm if mask[1] else bw0
    bh1 = ehm if mask[3] else bh0
    return aw1, bw1, ah1, bh1, failed


def finish_plain(sc, xlog, csum, wscal, rsum, hscal, n, m, dt, mask,
                 niter, tol):
    """K4's function: scal (B, 16) float64.  The ELBO is assembled in
    float64, the Newton runs in the factor dtype ``dt``."""
    aw, bw, ah, bh = sc[:, 0], sc[:, 1], sc[:, 2], sc[:, 3]
    r_live, lgx = sc[:, 5], sc[:, 6]
    nr = n * r_live
    rm = r_live * m
    u1 = -(csum * rsum).sum(-1) - lgx
    const_w = nr * (aw * torch.log(aw / bw) - gammaln_approx(aw))
    const_h = rm * (ah * torch.log(ah / bh) - gammaln_approx(ah))
    scal = torch.zeros(sc.shape[0], NSCAL, dtype=torch.float64,
                       device=sc.device)
    scal[:, XLOG] = xlog
    scal[:, [U2, SEW, SLW, DTW]] = wscal
    scal[:, [U3, SEH, SLH, DTH]] = hscal
    scal[:, PEND] = u1 + wscal[:, 0] + const_w + hscal[:, 0] + const_h
    scal[:, DTERM] = -(wscal[:, 3] + hscal[:, 3]) + xlog
    aw1, bw1, ah1, bh1, failed = _newton_plain(
        aw.to(dt), ah.to(dt), bw.to(dt), bh.to(dt),
        (wscal[:, 2] / nr).to(dt), (wscal[:, 1] / nr).to(dt),
        (hscal[:, 2] / rm).to(dt), (hscal[:, 1] / rm).to(dt),
        mask, niter, tol)
    scal[:, AW] = aw1.double()
    scal[:, BW] = bw1.double()
    scal[:, AH] = ah1.double()
    scal[:, BH] = bh1.double()
    scal[:, HFAIL] = failed.double()
    return scal


def sol_sweep_plain(x_pad, lwt_p, lh_p, eh_p, sc, *, n, m_arr, m_live, r,
                    bn=DEFAULT_BN, bm=DEFAULT_BM, hyper_mask=(True,) * 4,
                    newton_niter=100, newton_tol=1e-4, mxu_bf16=False):
    """One VB sweep in plain PyTorch; the function K1-K4 compute, with
    :func:`sol_sweep`'s arguments.

    Returns (ewt, lwtn, dwt, eh, lhn, dh, scal)."""
    x, lwt, lh, eh, m = x_pad, lwt_p, lh_p, eh_p, m_arr
    _check(x, lwt, lh, eh, sc, n, m, r)
    dt = lwt.dtype
    a = [sc[:, q].to(dt) for q in range(6)]
    aw, bw, ah, bh, fudge, r_live = a
    swnt, shn, xlog, ehs = xpass_plain(x, lwt, lh, eh, sc, mxu_bf16)
    ewt, lwtn, dwt, csum, wscal = post_plain(swnt, lwt, ehs, aw, bw,
                                             fudge, r_live, r, n)
    ehn, lhn, dhn, rsum, hscal = post_plain(shn, lh, csum, ah, bh,
                                            fudge, r_live, r, m_live,
                                            npin=m)
    scal = finish_plain(sc, xlog, csum, wscal, rsum, hscal, n, m_live, dt,
                        tuple(bool(v) for v in hyper_mask),
                        newton_niter, newton_tol)
    return ewt, lwtn, dwt, ehn, lhn, dhn, scal


# ---------------------------------------------------------------------
# CUDA wrappers (one per kernel)
# ---------------------------------------------------------------------

def launch_xpass(x, lwt, lh, eh, sc, mxu_bf16=False):
    """K1 on ``x``, which may be a column window of a larger X (read in
    place through its row stride).  Returns the partials of
    :func:`xpass_partials_plain` (swn_part (B, ncc, rp, np), shn_part
    (B, ngc, rp, mp), xlog_part (B, ngc*ncc) f64, ehs_part (B, ncc, rp)
    f64) with ncc/ngc the cell/gene chunks (:data:`CHUNK`) of X.  The
    wrappers :func:`xpass` and ``sol_sharded.xpass_shard`` count the
    launch."""
    if x.stride(1) != 1:
        raise ValueError("X's columns must be contiguous")
    nb, rp_, np_ = lwt.shape
    mp_ = x.shape[1]
    gch, cch = CHUNK
    ncc, ngc = -(-mp_ // cch), -(-np_ // gch)
    swn_part = torch.empty(nb, ncc, rp_, np_, dtype=lwt.dtype,
                           device=x.device)
    shn_part = torch.empty(nb, ngc, rp_, mp_, dtype=lwt.dtype,
                           device=x.device)
    xlog_part = torch.empty(nb, ngc * ncc, dtype=torch.float64,
                            device=x.device)
    ehs_part = torch.empty(nb, ncc, rp_, dtype=torch.float64,
                           device=x.device)
    launch("sol_xpass", TCODE[lwt.dtype], XCODE[x.dtype],
           int(bool(mxu_bf16)), x, lwt, lh, eh, sc, nb, np_, mp_,
           x.stride(0), rp_, gch, cch, swn_part, shn_part, xlog_part,
           ehs_part)
    return swn_part, shn_part, xlog_part, ehs_part


def xpass(x, lwt, lh, eh, sc, mxu_bf16=False):
    """Launch K1: the partials of :func:`launch_xpass`."""
    out = launch_xpass(x, lwt, lh, eh, sc, mxu_bf16)
    LAUNCHES["xpass"] += 1
    return out


def _post(name, sfx_part, lf, denom_part, sc, r, *extents):
    nb, rp_, ext = lf.shape
    nblk = -(-ext // POST_COLS)
    e = torch.empty_like(lf)
    ln = torch.empty_like(lf)
    d = torch.empty_like(lf)
    rsum_part = torch.empty(nb, nblk, rp_, dtype=torch.float64,
                            device=lf.device)
    scal_part = torch.empty(nb, nblk, 4, dtype=torch.float64,
                            device=lf.device)
    launch(name, TCODE[lf.dtype], sfx_part, sfx_part.shape[1], lf,
           denom_part, denom_part.shape[1], sc, nb, ext, rp_, r, *extents,
           e, ln, d, rsum_part, scal_part)
    return e, ln, d, rsum_part, scal_part


def w_post(swn_part, lwt, ehs_part, sc, r, n):
    """Launch K2: (ewt, lwtn, dwt, csum_part, wscal_part)."""
    out = _post("sol_w_post", swn_part, lwt, ehs_part, sc, r, n)
    LAUNCHES["w_post"] += 1
    return out


def launch_h_post(shn_part, lh, csum_part, sc, r, m_live, m_pin):
    """K3 with the live cells ``m_live`` and the pinned extent
    ``m_pin``: (ehn, lhn, dhn, rsum_part, hscal_part).  The wrappers
    :func:`h_post` and ``sol_sharded.h_post_shard`` count the
    launch."""
    return _post("sol_h_post", shn_part, lh, csum_part, sc, r, m_live,
                 m_pin)


def h_post(shn_part, lh, csum_part, sc, r, m_live, m=None):
    """Launch K3 (``m``, default ``m_live``, the pinned extent):
    (ehn, lhn, dhn, rsum_part, hscal_part)."""
    out = launch_h_post(shn_part, lh, csum_part, sc, r, m_live,
                        m_live if m is None else m)
    LAUNCHES["h_post"] += 1
    return out


def finish(sc, xlog_part, csum_part, wscal_part, rsum_part, hscal_part,
           *, n, m, dt, hyper_mask, newton_niter, newton_tol):
    """Launch K4: scal (B, 16) float64."""
    nb, _, rp_ = csum_part.shape
    scal = torch.empty(nb, NSCAL, dtype=torch.float64, device=sc.device)
    mask = sum(1 << i for i, v in enumerate(hyper_mask) if v)
    launch("sol_finish", TCODE[dt], sc, xlog_part, xlog_part.shape[1],
           csum_part, wscal_part, csum_part.shape[1], rsum_part, hscal_part,
           rsum_part.shape[1], nb, rp_, n, m, mask, int(newton_niter),
           float(newton_tol), scal)
    LAUNCHES["finish"] += 1
    return scal


def lane_part_bytes(np_, mp_, rp_, itemsize):
    """Bytes of K1's swn and shn partials for one lane of an (np_, mp_)
    X at padded rank ``rp_``."""
    gch, cch = CHUNK
    return (-(-mp_ // cch) * np_ + -(-np_ // gch) * mp_) * rp_ * itemsize


def lane_groups(nb, lane_bytes):
    """Consecutive lane slices, as few as keep each group's partials
    (``lane_bytes`` a lane) within :data:`LANE_GROUP_BYTES` and of sizes
    that differ by one at most (a group of one lane where a lane alone
    exceeds it)."""
    per = max(1, int(LANE_GROUP_BYTES // max(1, lane_bytes)))
    ng = -(-nb // per)
    bounds = [nb * g // ng for g in range(ng + 1)]
    return [slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]


def xpass_post(x, lwt, lh, eh, sc, *, n, m_live, m, r, mxu_bf16=False):
    """K1, then K2 and K3 on its partials, for one group of lanes:
    (ewt, lwtn, dwt, ehn, lhn, dhn, xlog_part, csum_part, wscal_part,
    rsum_part, hscal_part), the partials K4 reads."""
    swn_part, shn_part, xlog_part, ehs_part = xpass(x, lwt, lh, eh, sc,
                                                    mxu_bf16)
    ewt, lwtn, dwt, csum_part, wscal_part = w_post(swn_part, lwt,
                                                   ehs_part, sc, r, n)
    del swn_part
    ehn, lhn, dhn, rsum_part, hscal_part = h_post(shn_part, lh,
                                                  csum_part, sc, r, m_live,
                                                  m)
    return (ewt, lwtn, dwt, ehn, lhn, dhn, xlog_part, csum_part,
            wscal_part, rsum_part, hscal_part)


def sol_sweep(x_pad, lwt_p, lh_p, eh_p, sc, *, n, m_arr, m_live, r,
              bn=DEFAULT_BN, bm=DEFAULT_BM, hyper_mask=(True,) * 4,
              newton_niter=100, newton_tol=1e-4, mxu_bf16=False):
    """One VB sweep: K1-K4 on CUDA tensors, :func:`sol_sweep_plain` on
    CPU tensors.  The arguments are JAX's: ``x_pad`` (np, mp), the
    factors ``lwt_p``/``lh_p``/``eh_p`` padded with a leading lane axis,
    ``m_arr`` the state's cell extent (cells past it are padding) and
    ``m_live`` its live cells (those in ``[m_live, m_arr)`` pinned at
    ``fudge``); ``bn``/``bm`` are accepted and unused (the kernels tile
    X themselves).  K1-K3 run over the lane groups of
    :func:`lane_groups`, K4 once.  Returns (ewt, lwtn, dwt, eh, lhn, dh,
    scal)."""
    x, lwt, lh, eh, m = x_pad, lwt_p, lh_p, eh_p, m_arr
    _check(x, lwt, lh, eh, sc, n, m, r)
    if x.device.type == "cpu":
        return sol_sweep_plain(x, lwt, lh, eh, sc, n=n, m_arr=m,
                               m_live=m_live, r=r, hyper_mask=hyper_mask,
                               newton_niter=newton_niter,
                               newton_tol=newton_tol, mxu_bf16=mxu_bf16)
    return sweep_kernels(x, lwt, lh, eh, sc, n=n, m_live=m_live, m=m, r=r,
                         hyper_mask=hyper_mask, newton_niter=newton_niter,
                         newton_tol=newton_tol, mxu_bf16=mxu_bf16)


def sweep_kernels(x, lwt, lh, eh, sc, *, n, m_live, m, r, hyper_mask,
                  newton_niter, newton_tol, mxu_bf16):
    """The kernel sweep of :func:`sol_sweep`: :func:`xpass_post` on each
    lane group of :func:`lane_groups`, the groups' outputs joined on the
    lane axis, then K4 once on all lanes."""
    nb, rp_, np_ = lwt.shape
    groups = lane_groups(nb, lane_part_bytes(np_, x.shape[1], rp_,
                                             lwt.element_size()))
    outs = [xpass_post(x, lwt[g], lh[g], eh[g], sc[g], n=n, m_live=m_live,
                       m=m, r=r, mxu_bf16=mxu_bf16) for g in groups]
    out = outs[0] if len(outs) == 1 else [torch.cat(t) for t in zip(*outs)]
    del outs
    scal = finish(sc, *out[6:], n=n, m=m_live, dt=lwt.dtype,
                  hyper_mask=hyper_mask, newton_niter=newton_niter,
                  newton_tol=newton_tol)
    return (*out[:6], scal)


# ---------------------------------------------------------------------
# Convergence loop over a lane batch
# ---------------------------------------------------------------------

def vb_run_sol(x_pad, state0: VBState, hyper0, *, itmax: int = 10000,
               tol: float = 1e-5, fudge=None, hyper_mask=(True,) * 4,
               n0: int = 10, dn: int = 1, bn: int = DEFAULT_BN,
               bm: int = DEFAULT_BM, cell_mask=None, m_true=None,
               rank_mask=None, r_true=None, it0: int = 1, lk0_init=None,
               elbo_every: int = 1, mxu_bf16: bool = False,
               sweep_fn=None) -> VBRunResult:
    """The deferred-ELBO convergence loop of ``ccfindr_tpu``'s
    ``vb_run_sol`` over a lane batch, one :func:`sol_sweep` a sweep.

    ``x_pad`` is the (n, m) count matrix (or a zero-padded copy;
    columns past the state's extents are padding; the JAX tiles
    ``bn``/``bm`` are accepted and unused); ``state0``/``hyper0`` are
    lane-batched; ``rank_mask`` (B, r) and ``r_true`` (B,) give each
    lane's live rank prefix; ``cell_mask`` (m,) and ``m_true`` the live
    cells of a mesh-padded cell axis (a prefix: the cells past ``m_true``
    are pinned at ``fudge``).  Each lane keeps its own sweep counter
    and is frozen once its stopping rule fired or its sweep bound ran
    out, so the host may test for running lanes only every
    ``HOST_CHECK_EVERY`` sweeps: extra sweeps leave frozen lanes
    unchanged.  ``mxu_bf16`` (``precision='bf16'``) rounds the X pass's
    operands to bf16.
    ``sweep_fn`` swaps the sweep: ``sol_sweep_plain`` to time the plain
    version on the card, or the cell-sharded sweep of
    ``sol_sharded.make_sol_sweep_sharded`` with ``x`` laid out on the
    mesh (``parallel.sharded.ShardedCounts``).
    """
    sweep = functools.partial(sweep_fn if sweep_fn is not None
                              else sol_sweep, mxu_bf16=mxu_bf16)
    return deferred_loop(x_pad, state0, hyper0, sweep, w_rowmajor=False,
                         cell_mask=cell_mask, m_true=m_true,
                         itmax=itmax, tol=tol, fudge=fudge,
                         hyper_mask=hyper_mask, n0=n0, dn=dn,
                         rank_mask=rank_mask, r_true=r_true, it0=it0,
                         lk0_init=lk0_init, elbo_every=elbo_every)


def deferred_loop(x, state0: VBState, hyper0, sweep, *, w_rowmajor,
                  cell_mask=None, m_true=None, itmax, tol, fudge,
                  hyper_mask, n0, dn, rank_mask, r_true, it0, lk0_init,
                  elbo_every) -> VBRunResult:
    """The deferred-ELBO loop shared by :func:`vb_run_sol` and
    ``ops/kernels/epilogue.py::vb_run_epi``.

    ``sweep(x, lw, lh, eh, sc, n=, m_arr=, m_live=, r=, hyper_mask=)``
    returns ``(ew, lw, dw, eh, lh, dh, scal)`` with ``scal`` in K4's
    slot layout; W is carried padded as ``(B, rp, np)`` (``w_rowmajor``
    False, the sol sweep) or ``(B, np, rp)`` (True, the JAX layout of
    the epilogue sweep).  ``m_arr`` is the state's cell extent,
    ``m_live`` (``m_true``, default ``m_arr``) the live cells that
    normalize the ELBO;
    ``cell_mask`` pins the others on entry, as the JAX loops do.  With
    ``x`` laid out on a mesh (``ShardedCounts``), the H family is
    carried as its cell shards, each on its shard's device.
    """
    nb, n, r = state0.lw.shape
    m = state0.lh.shape[-1]
    m_live = m if m_true is None else int(m_true)
    ref_t = state0.lw.dtype
    dev = state0.lw.device
    np_, mp_ = x.shape
    rp_ = round_up(max(r, 8), 8)
    if fudge is None:
        fudge = torch.finfo(ref_t).eps
    fudge = torch.as_tensor(fudge, dtype=ref_t, device=dev)
    tol = torch.as_tensor(tol, dtype=ref_t, device=dev)
    sharded = isinstance(x, ShardedCounts)
    lgx = x.lgx if sharded else lgamma_sum(x)
    state0 = mask_initial_state(state0, rank_mask, fudge, cell_mask)
    r_live = (r_true.to(torch.float64) if rank_mask is not None
              else torch.full((nb,), float(r), dtype=torch.float64,
                              device=dev))

    def pad_w(a, fill):         # (B, n, r) -> (B, rp, np) or (B, np, rp)
        if w_rowmajor:
            out = torch.zeros(nb, np_, rp_, dtype=ref_t, device=dev)
            out[:, n:, :r] = fill
            out[:, :n, :r] = a
            return out
        out = torch.zeros(nb, rp_, np_, dtype=ref_t, device=dev)
        out[:, :r, n:] = fill
        out[:, :r, :n] = a.transpose(-1, -2)
        return out

    def pad_h(a, fill):         # (B, r, m) -> (B, rp, mp), or its shards
        out = torch.zeros(nb, rp_, mp_, dtype=ref_t, device=dev)
        out[:, :r, m:] = fill
        out[:, :r, :m] = a
        return x.shard_h(out) if sharded else out

    lw = pad_w(state0.lw, 1.0)
    ew = pad_w(state0.ew, 0.0)
    dw = pad_w(state0.dw, 0.0)
    lh = pad_h(state0.lh, 1.0)
    eh = pad_h(state0.eh, 0.0)
    dh = pad_h(state0.dh, 0.0)
    aw, bw, ah, bh = (h.to(ref_t).expand(nb).clone() for h in hyper0)
    it = torch.full((nb,), int(it0), dtype=torch.int64, device=dev)
    lk0 = torch.as_tensor(0.0 if lk0_init is None else lk0_init,
                          dtype=ref_t, device=dev).expand(nb).clone()
    lkh = state0.lkh.to(ref_t).expand(nb).clone()
    pending = torch.zeros(nb, dtype=torch.float64, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    hfail = torch.zeros_like(done)
    fud64 = fudge.to(torch.float64).expand(nb)
    lgx_b = lgx.expand(nb)
    nm = float(n) * float(m_live)

    def keep(flag, new, old):   # per lane: new where flag, else old
        if isinstance(old, tuple):
            return tuple(keep(flag, a, b) for a, b in zip(new, old))
        flag = flag.to(old.device).view((nb,) + (1,) * (old.dim() - 1))
        return torch.where(flag, new, old)

    sweeps = 0
    while True:
        active = (~done) & (it <= itmax + 1)
        if sweeps % HOST_CHECK_EVERY == 0 and not bool(active.any()):
            break
        sweeps += 1
        itp = it - 1
        elbo_now = ((itp % elbo_every == 0) if elbo_every > 1
                    else torch.ones_like(done))
        sc = torch.stack([aw.double(), bw.double(), ah.double(),
                          bh.double(), fud64, r_live, lgx_b,
                          elbo_now.double()], dim=1).contiguous()
        (ew_n, lw_n, dw_n, eh_n, lh_n, dh_n, scal) = sweep(
            x, lw, lh, eh, sc, n=n, m_arr=m, m_live=m_live, r=r,
            hyper_mask=hyper_mask)

        # complete sweep it-1's ELBO (deferred data term)
        lkh_prev = ((pending + scal[:, DTERM]) / nm).to(ref_t)
        valid = (itp >= it0) & elbo_now
        conv = (valid & (itp > 1) & (itp > n0) & (lkh_prev >= lk0)
                & (torch.abs(1.0 - lkh_prev / lk0) < tol))
        stop = (torch.isnan(lkh_prev) & valid) | conv
        lk0 = torch.where(active & valid & ~stop, lkh_prev, lk0)
        lkh = torch.where(active & valid, lkh_prev, lkh)

        do_sweep = active & ~stop & (it <= itmax)
        do_hyper = do_sweep & (it > n0) & (it % dn == 0)
        aw = torch.where(do_hyper, scal[:, AW].to(ref_t), aw)
        bw = torch.where(do_hyper, scal[:, BW].to(ref_t), bw)
        ah = torch.where(do_hyper, scal[:, AH].to(ref_t), ah)
        bh = torch.where(do_hyper, scal[:, BH].to(ref_t), bh)
        hfail = hfail | (do_hyper & (scal[:, HFAIL] > 0))
        lw = keep(do_sweep, lw_n, lw)
        lh = keep(do_sweep, lh_n, lh)
        ew = keep(do_sweep, ew_n, ew)
        eh = keep(do_sweep, eh_n, eh)
        dw = keep(do_sweep, dw_n, dw)
        dh = keep(do_sweep, dh_n, dh)
        pending = torch.where(do_sweep, scal[:, PEND], pending)
        done = torch.where(active, stop, done)
        it = it + active.to(it.dtype)

    def unpad_w(a):
        if w_rowmajor:
            return a[:, :n, :r]
        return a[:, :r, :n].transpose(-1, -2)

    if sharded:
        lh, eh, dh = (x.gather_h(t) for t in (lh, eh, dh))

    state = VBState(ew=unpad_w(ew), eh=eh[:, :r, :m], lw=unpad_w(lw),
                    lh=lh[:, :r, :m], dw=unpad_w(dw), dh=dh[:, :r, :m],
                    lkh=lkh)
    hyper = type(hyper0)(aw=aw, bw=bw, ah=ah, bh=bh)
    return VBRunResult(state=state, hyper=hyper, lml=lk0, n_iter=it - 2,
                       hyper_failed=hfail, done=done)
