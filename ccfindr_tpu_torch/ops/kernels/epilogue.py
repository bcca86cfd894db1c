"""The gene-major VB sweep: the fused X pass and the gamma-posterior
epilogues as hand-written CUDA, and its convergence loop.

Counterpart of ``ccfindr_tpu/ops/pallas/epilogue.py``, under its names.
A sweep (:func:`epi_sweep`) is five launches on the current stream of
the tensors' card: E1
``fused_xpass`` + E1s ``fused_sum`` (:mod:`.vb_kernels`), E2
``epi_w_post`` (W gamma posterior, replaces ``_w_epilogue_kernel``), E3
``epi_h_post`` (H, replaces ``_h_epilogue_kernel``) and K4
``sol_finish`` of :mod:`.sol`, which reads E2's and E3's per-block
partials and assembles the ELBO and the damped hyper Newton, as it does
in the cell-major sweep (JAX's ``vb_run_sol`` is the drop-in twin of
``vb_run_epi``, and K4 computes what ``ops.vb.hyper_update(means=...)``
computes in the JAX loop).  :func:`epi_sweep_plain` is the same sweep in
plain PyTorch; :func:`epi_sweep` takes it only for CPU tensors.

Layouts are the JAX package's with a leading lane axis B: X ``(np,
mp)``; ``lw``/``ew``/``dw`` ``(B, np, rp)``; ``lh``/``eh``/``dh``
``(B, rp, mp)``; ``sc (B, 8)`` float64 and the result ``scal (B, 16)``
in the slot layout of :mod:`.sol`.  Rows of W past the true gene count
``n`` and columns of H past ``m`` are padding (1 in ``lw``/``lh`` for
rank rows below ``r``, 0 elsewhere); H columns in ``[m_live, m)`` are
mesh cell padding, pinned at ``fudge``.
"""

from __future__ import annotations


import torch

from . import sol
from .build import TCODE, launch
from .sol import DEFAULT_BM, DEFAULT_BN
from .vb_kernels import (fused_chunk, fused_pallas_raw,
                         fused_xpass_plain)
from ..vb import VBRunResult, VBState
from ...utils import lane_sum

# E2's genes a block (csrc/epi_w.cuh kE2Cols): one partial a block of
# colSums(ew) and of W's ELBO scalars, which E3 and K4 read.  A
# constant, never derived from the lane count, so a lane's partials and
# bits do not depend on its batch.  E3's block is sol.POST_COLS cells
# (post.cuh's kPostCols), one partial a block
E2_COLS = 256

# launches per kernel since the last reset (bumped only where a kernel
# is launched)
LAUNCHES = {"epi_w_post": 0, "epi_h_post": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _partials(nb, ext, rp, dev, cols):
    nblk = -(-ext // cols)
    return (torch.empty(nb, nblk, rp, dtype=torch.float64, device=dev),
            torch.empty(nb, nblk, 4, dtype=torch.float64, device=dev))


def epi_w_post(swn, lw, ehs_part, sc, r, n):
    """Launch E2 on ``swn``/``lw (B, np, rp)`` with ``ehs_part (B, nd,
    rp)`` the partials of rowSums(eh): ``(ew, lwn, dw, csum_part (B,
    nblk, rp), wscal_part (B, nblk, 4))``, one partial a block of
    :data:`E2_COLS` genes, in K4's layout."""
    nb, np_, rp_ = lw.shape
    ew, lwn, dw = (torch.empty_like(lw) for _ in range(3))
    csum_part, wscal_part = _partials(nb, np_, rp_, lw.device, E2_COLS)
    launch("epi_w_post", TCODE[lw.dtype], swn, lw, ehs_part,
           ehs_part.shape[1], sc, nb, np_, rp_, r, n, ew, lwn, dw, csum_part,
           wscal_part)
    LAUNCHES["epi_w_post"] += 1
    return ew, lwn, dw, csum_part, wscal_part


def epi_h_post(shn, lh, csum_part, sc, r, m_live, m):
    """Launch E3 on ``shn``/``lh (B, rp, mp)`` with E2's ``csum_part``:
    ``(eh, lhn, dh, rsum_part, hscal_part)``."""
    nb, rp_, mp_ = lh.shape
    eh, lhn, dh = (torch.empty_like(lh) for _ in range(3))
    rsum_part, hscal_part = _partials(nb, mp_, rp_, lh.device,
                                      sol.POST_COLS)
    launch("epi_h_post", TCODE[lh.dtype], shn, lh, csum_part,
           csum_part.shape[1], sc, nb, mp_, rp_, r, m_live, m, eh, lhn, dh,
           rsum_part, hscal_part)
    LAUNCHES["epi_h_post"] += 1
    return eh, lhn, dh, rsum_part, hscal_part


def _post_plain(swn, shn, lw, lh, ehs, sc, r, n, m_live, m):
    """E2 and E3's function on the JAX layouts, through
    :func:`.sol.post_plain` on W transposed."""
    dt = lw.dtype
    aw, bw, ah, bh, fudge, r_live = (sc[:, q].to(dt) for q in range(6))
    ewt, lwt, dwt, csum, wscal = sol.post_plain(
        swn.transpose(-1, -2), lw.transpose(-1, -2), ehs, aw, bw, fudge,
        r_live, r, n)
    eh, lhn, dh, rsum, hscal = sol.post_plain(shn, lh, csum, ah, bh, fudge,
                                              r_live, r, m_live, npin=m)
    w = tuple(t.transpose(-1, -2).contiguous() for t in (ewt, lwt, dwt))
    return w + (csum, wscal, eh, lhn, dh, rsum, hscal)


def posterior_update_pallas(swn_p, shn_p, lw_p, lh_p, ehs, hyper_vec,
                            fudge, *, n, m, r, bn=DEFAULT_BN, bm=DEFAULT_BM,
                            r_live=None, m_live=None):
    """The full gamma-posterior update on the X pass's outputs: E2 + E3
    on CUDA tensors, their plain version on CPU tensors.

    ``swn_p``/``lw_p`` are ``(B, np, rp)``, ``shn_p``/``lh_p`` ``(B, rp,
    mp)`` (the JAX tiles ``bn``/``bm`` are accepted and unused),
    ``ehs (B, rp)`` the rowSums of the current ``eh``, ``hyper_vec (B,
    4)`` = ``[aw, bw, ah, bh]``, ``fudge`` a scalar or ``(B,)``;
    ``r_live (B,)`` (default ``r``) the live rank prefix of each lane,
    ``m_live`` (default ``m``) the real cell count under mesh padding.
    Returns the dict of the JAX function: the new factors ``ew``, ``lw``,
    ``dw``, ``eh``, ``lh``, ``dh``; ``csum``/``rsum (B, rp)`` (colSums
    of the new ew, rowSums of the new eh); and the per-lane sums ``u2``,
    ``u3``, ``sum_ew``, ``sum_log_lw``, ``sum_eh``, ``sum_log_lh``,
    ``dterm_w``, ``dterm_h`` (the last two for the INPUT lw/lh), in
    float64."""
    swn, shn, lw, lh = swn_p, shn_p, lw_p, lh_p
    nb = lw.shape[0]
    dev = lw.device
    m_live = m if m_live is None else int(m_live)
    f64 = torch.float64

    def lanes(v):
        return torch.as_tensor(v, dtype=f64, device=dev).expand(nb)

    sc = torch.stack([hyper_vec[:, 0].to(f64), hyper_vec[:, 1].to(f64),
                      hyper_vec[:, 2].to(f64), hyper_vec[:, 3].to(f64),
                      lanes(fudge), lanes(r if r_live is None else r_live),
                      lanes(0.0), lanes(1.0)], dim=1).contiguous()
    ehs = ehs.to(f64)
    if lw.device.type == "cpu":
        (ew, lwn, dw, csum, wscal, eh, lhn, dh, rsum,
         hscal) = _post_plain(swn, shn, lw, lh, ehs, sc, r, n, m_live, m)
    else:
        ew, lwn, dw, csum_p, wscal_p = epi_w_post(
            swn, lw, ehs[:, None, :].contiguous(), sc, r, n)
        eh, lhn, dh, rsum_p, hscal_p = epi_h_post(shn, lh, csum_p, sc, r,
                                                  m_live, m)
        csum, wscal, rsum, hscal = (p.sum(1) for p in (csum_p, wscal_p,
                                                       rsum_p, hscal_p))
    return dict(ew=ew, lw=lwn, dw=dw, eh=eh, lh=lhn, dh=dh, csum=csum,
                rsum=rsum, u2=wscal[:, 0], sum_ew=wscal[:, 1],
                sum_log_lw=wscal[:, 2], dterm_w=wscal[:, 3],
                u3=hscal[:, 0], sum_eh=hscal[:, 1],
                sum_log_lh=hscal[:, 2], dterm_h=hscal[:, 3])


# ---------------------------------------------------------------------
# One sweep
# ---------------------------------------------------------------------

def epi_sweep_plain(x, lw, lh, eh, sc, *, n, m, r, hyper_mask=(True,) * 4,
                    m_live=None, newton_niter=100, newton_tol=1e-4):
    """One gene-major VB sweep in plain PyTorch; the function E1, E1s,
    E2, E3 and K4 compute (E1's loop order does not change it).
    Returns (ew, lwn, dw, eh, lhn, dh, scal)."""
    sol._check(x, lw, lh, eh, sc, n, m, r, w_rowmajor=True)
    m_live = m if m_live is None else m_live
    swn, shn, xlog = fused_xpass_plain(x, lw, lh)
    ehs = eh.sum(-1, dtype=torch.float64)
    (ew, lwn, dw, csum, wscal, ehn, lhn, dh, rsum,
     hscal) = _post_plain(swn, shn, lw, lh, ehs, sc, r, n, m_live, m)
    scal = sol.finish_plain(sc, xlog, csum, wscal, rsum, hscal, n, m_live,
                            lw.dtype, tuple(bool(v) for v in hyper_mask),
                            newton_niter, newton_tol)
    return ew, lwn, dw, ehn, lhn, dh, scal


def epi_sweep(x, lw, lh, eh, sc, *, n, m, r, hyper_mask=(True,) * 4,
              layout="cm", m_live=None, newton_niter=100,
              newton_tol=1e-4, chunk=None):
    """One gene-major VB sweep: E1 + E1s (``layout``), E2, E3 and K4 on
    CUDA tensors, :func:`epi_sweep_plain` on CPU tensors.  ``m`` is the
    cell extent of the state, ``m_live`` (default ``m``) its live cells;
    ``chunk`` pins E1's chunk (:func:`.vb_kernels.fused_chunk`).
    Returns (ew, lwn, dw, eh, lhn, dh, scal)."""
    sol._check(x, lw, lh, eh, sc, n, m, r, w_rowmajor=True)
    m_live = m if m_live is None else m_live
    if x.device.type == "cpu":
        return epi_sweep_plain(x, lw, lh, eh, sc, n=n, m=m, r=r,
                               hyper_mask=hyper_mask, m_live=m_live,
                               newton_niter=newton_niter,
                               newton_tol=newton_tol)
    swn, shn, xlog = fused_pallas_raw(x, lw, lh, layout=layout, chunk=chunk)
    ehs_part = lane_sum(eh, 1, torch.float64)[:, None, :]
    ew, lwn, dw, csum_part, wscal_part = epi_w_post(swn, lw, ehs_part, sc,
                                                    r, n)
    ehn, lhn, dh, rsum_part, hscal_part = epi_h_post(shn, lh, csum_part, sc,
                                                     r, m_live, m)
    scal = sol.finish(sc, xlog[:, None], csum_part, wscal_part, rsum_part,
                      hscal_part, n=n, m=m_live, dt=lw.dtype,
                      hyper_mask=hyper_mask, newton_niter=newton_niter,
                      newton_tol=newton_tol)
    return ew, lwn, dw, ehn, lhn, dh, scal


# ---------------------------------------------------------------------
# Convergence loop over a lane batch
# ---------------------------------------------------------------------

def vb_run_epi(x_pad, state0: VBState, hyper0, *, itmax: int = 10000,
               tol: float = 1e-5, fudge=None, hyper_mask=(True,) * 4,
               n0: int = 10, dn: int = 1, bn: int = DEFAULT_BN,
               bm: int = DEFAULT_BM, layout: str = "cm", cell_mask=None,
               m_true=None, rank_mask=None, r_true=None, it0: int = 1,
               lk0_init=None, chunk=None) -> VBRunResult:
    """``ccfindr_tpu``'s ``vb_run_epi`` over a lane batch: the
    deferred-ELBO loop of :func:`.sol.vb_run_sol` with one
    :func:`epi_sweep` a sweep, W carried in the JAX layout.

    ``x_pad`` is the (n, m) count matrix or a zero-padded copy;
    ``state0``/``hyper0`` are lane-batched; ``rank_mask (B, r)`` and
    ``r_true (B,)`` give each lane's live rank prefix; ``cell_mask``
    (m,) and ``m_true`` (at most the state's cell count) the live cells
    of a mesh-padded cell axis (a prefix), the cells past it pinned at
    ``fudge`` as the JAX loop pins them; ``it0``/``lk0_init`` resume a
    bounded run exactly.  ``layout`` picks E1's loop order; ``chunk``
    pins E1's chunk (default: the one :func:`.vb_kernels.fused_chunk`
    gives this batch).  A chunked or lane-compacted driver pins the full
    batch's chunk, so that a lane's partials are added in one order
    whatever the batch.  The JAX tile sizes ``bn``/``bm`` are accepted
    and unused; ``chunk`` is the port's own keyword.
    """
    nb, _, r = state0.lw.shape
    if chunk is None:
        chunk = fused_chunk(x_pad, layout, nb, sol.round_up(max(r, 8), 8),
                            state0.lw.element_size())

    def sweep(x, lw, lh, eh, sc, *, m_arr, **kw):
        return epi_sweep(x, lw, lh, eh, sc, m=m_arr, layout=layout,
                         chunk=chunk, **kw)

    return sol.deferred_loop(x_pad, state0, hyper0, sweep, w_rowmajor=True,
                             cell_mask=cell_mask, m_true=m_true,
                             itmax=itmax, tol=tol,
                             fudge=fudge, hyper_mask=hyper_mask, n0=n0,
                             dn=dn, rank_mask=rank_mask, r_true=r_true,
                             it0=it0, lk0_init=lk0_init, elbo_every=1)
