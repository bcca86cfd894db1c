"""The plain reference of a VB rank scan, in PyTorch.

Variational-Bayes NMF of a count matrix X (genes x cells) under gamma
priors, as ccfindR's ``vb_factorize`` defines it (R/bayesian.R:229-390,
src/vbnmf_update.cpp:16-102): each (rank, run) lane starts from gamma
draws, runs ``Itmax`` CAVI sweeps with the empirical-Bayes Newton
update of the hyperparameters after sweep ``n0``, and a rank keeps the
run of highest log evidence.  Written from those equations as plain
dense tensor operations, lane batch by lane batch, with no kernel, cache
or layout of the program under test; it imports nothing of it.

Two precisions: ``'f64'`` is the yardstick (every operation in float64);
``'tf32'`` is the control, float32 whose products round their operands
to TF32's 10-bit mantissa first (as a tensor-core product does), the
step below the float32 the configurations state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32_EPS = float(torch.finfo(torch.float32).eps)
PRECISIONS = ("f64", "tf32")


def round_tf32(t):
    """float32 to the nearest value with a 10-bit mantissa, ties away
    from zero (``cvt.rna.tf32.f32``)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _matmul(precision):
    if precision == "tf32":
        return lambda a, b: torch.matmul(round_tf32(a), round_tf32(b))
    return torch.matmul


class Counts(NamedTuple):
    """X on the device as the reference reads it: the dense counts, the
    flat positions and values of its nonzeros, and sum(lgamma(x + 1))."""
    x: torch.Tensor
    nz: torch.Tensor
    xv: torch.Tensor
    lgx: float


def counts(x):
    """:class:`Counts` of a dense (n, m) count tensor."""
    flat = x.reshape(-1)
    nz = torch.nonzero(flat).squeeze(1)
    xv = flat[nz].to(torch.float64)
    return Counts(x=x, nz=nz, xv=xv, lgx=float(torch.lgamma(xv + 1.0).sum()))


def starts(seed, n, m, rmax, lanes, hyper=(1.0, 1.0, 1.0, 1.0)):
    """The random starts of the lanes ``lanes`` (lane t = k * nrun + i
    for rank index k and run i) of a scan seeded by ``seed``: a
    ``torch.Generator`` on the host seeded by it draws, lane after lane,
    W (n, rmax) from gamma(aw, bw / aw) and then H (rmax, m) from
    gamma(ah, bh / ah), in float64, which the scan keeps in float32.
    Returns {t: (w, h)} as float64 tensors on the host."""
    aw, bw, ah, bh = (float(v) for v in hyper)
    gen = torch.Generator().manual_seed(int(seed))
    want = set(int(t) for t in lanes)
    out = {}
    for t in range(max(want) + 1):
        w = torch._standard_gamma(torch.full((n, rmax), aw,
                                             dtype=torch.float64),
                                  generator=gen) * (bw / aw)
        h = torch._standard_gamma(torch.full((rmax, m), ah,
                                             dtype=torch.float64),
                                  generator=gen) * (bh / ah)
        if t in want:
            out[t] = (w.float().double(), h.float().double())
    return out


class Lanes(NamedTuple):
    """A lane batch's result, float64 numpy: lml (B,), ew/dw (B, n, r),
    eh/dh (B, r, m), the hyperparameters (B,) each."""
    lml: np.ndarray
    ew: np.ndarray
    eh: np.ndarray
    dw: np.ndarray
    dh: np.ndarray
    aw: np.ndarray
    bw: np.ndarray
    ah: np.ndarray
    bh: np.ndarray


def _xpass(cx, lw, lh, mm):
    """The statistics of one pass over X for the factors (lw, lh):
    swn = (X / WH) H^T, shn = W^T (X / WH) with W = lw, H = lh, and the
    ELBO's data term -sum(swn lw log lw) - sum(shn lh log lh)
    + sum(x log WH)."""
    b = lw.shape[0]
    wth = mm(lw, lh)
    xlog = (torch.index_select(wth.view(b, -1), 1, cx.nz).log_()
            * cx.xv.to(wth.dtype)).sum(-1)
    a = torch.div(cx.x, wth, out=wth)
    swn = mm(a, lh.transpose(-1, -2))
    shn = mm(lw.transpose(-1, -2), a)
    del a, wth
    dterm = (xlog - (swn * lw * torch.log(lw)).sum((-2, -1))
             - (shn * lh * torch.log(lh)).sum((-2, -1)))
    return swn, shn, dterm


def _posterior(sw, sh, eh_old, hy, fudge, lgx):
    """The gamma posterior of W and H from the statistics sw = lw * swn
    and sh = lh * shn, and the new state's ELBO terms that need no pass
    over X."""
    n, r = sw.shape[-2:]
    m = sh.shape[-1]
    dt = sw.dtype
    aw, bw, ah, bh = (h.to(dt)[:, None, None] for h in hy)
    bew = 1.0 / (aw / bw + eh_old.sum(-1)[:, None, :])
    alw = aw + sw
    ew = alw * bew
    beh = 1.0 / (ah / bh + ew.sum(-2)[:, :, None])
    lw = torch.clamp_min(torch.exp(torch.digamma(alw)) * bew, fudge)
    dw = alw * bew ** 2
    u2 = (-(aw / bw) * ew + alw * (1.0 + torch.log(bew))
          + torch.lgamma(alw)).sum((-2, -1))
    alh = ah + sh
    eh = alh * beh
    lh = torch.clamp_min(torch.exp(torch.digamma(alh)) * beh, fudge)
    dh = alh * beh ** 2
    u3 = (-(ah / bh) * eh + alh * (1.0 + torch.log(beh))
          + torch.lgamma(alh)).sum((-2, -1))
    aw, bw, ah, bh = (h.to(dt) for h in hy)
    u1 = -(ew.sum(-2) * eh.sum(-1)).sum(-1) - lgx
    u2 = u2 + n * r * (aw * torch.log(aw / bw) - torch.lgamma(aw))
    u3 = u3 + r * m * (ah * torch.log(ah / bh) - torch.lgamma(ah))
    return (ew, lw, dw, eh, lh, dh), (u1 + u2 + u3).double()


def _newton_step(a0, mean_e, mean_l, b0):
    return ((torch.log(a0) - torch.digamma(a0) - mean_e / b0 + 1.0
             + mean_l - torch.log(b0))
            / (1.0 / a0 - torch.polygamma(1, a0)))


def _positive(a0, d):
    """Halve d until a0 - d > 0 (R/bayesian.R:28-35)."""
    bad = a0 - d <= 0
    while bool(bad.any()):
        d = torch.where(bad, d * 0.5, d)
        bad = a0 - d <= 0
    return d


def _hyper(hy, means, niter=100, tol=1e-4):
    """The empirical-Bayes update (R/bayesian.R:2-53): damped Newton on
    the shapes from the old hyperparameters, stopped once a step changes
    them by less than ``tol`` in squared relative terms, then the means
    set to the factors' means.  Float64 throughout."""
    aw0, bw0, ah0, bh0 = hy
    lwm, ewm, lhm, ehm = means
    aw, ah = aw0, ah0
    done = torch.zeros_like(aw, dtype=torch.bool)
    for _ in range(niter - 1):
        active = ~done
        if not bool(active.any()):
            break
        aw1 = aw - _positive(aw, _newton_step(aw, ewm, lwm, bw0))
        ah1 = ah - _positive(ah, _newton_step(ah, ehm, lhm, bh0))
        df = (1.0 - aw1 / aw) ** 2 + (1.0 - ah1 / ah) ** 2
        aw = torch.where(active, aw1, aw)
        ah = torch.where(active, ah1, ah)
        done = torch.where(active, df < tol, done)
    return (aw, ewm, ah, ehm)


def vb_lanes(cx, w0, h0, itmax, precision="f64", fudge=F32_EPS,
             hyper=(1.0, 1.0, 1.0, 1.0), n0=10, dn=1):
    """``itmax`` sweeps of a batch of lanes of one rank from the starts
    ``w0`` (B, n, r) and ``h0`` (B, r, m), on X's device; returns
    :class:`Lanes`.  The log evidence is the ELBO of the state after
    the last sweep, over n * m."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.float64 if precision == "f64" else torch.float32
    dev = cx.x.device
    mm = _matmul(precision)
    lw = w0.to(dev, dt)
    lh = h0.to(dev, dt)
    eh = lh
    b, n, r = lw.shape
    m = lh.shape[-1]
    hy = tuple(torch.full((b,), float(v), dtype=torch.float64, device=dev)
               for v in hyper)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for it in range(1, itmax + 1):
            swn, shn, _ = _xpass(cx, lw, lh, mm)
            (ew, lw, dw, eh, lh, dh), pending = _posterior(
                swn * lw, shn * lh, eh, hy, fudge, cx.lgx)
            del swn, shn
            if it > n0 and it % dn == 0:
                means = tuple(t.double() / d for t, d in (
                    (torch.log(lw).sum((-2, -1)), n * r),
                    (ew.sum((-2, -1)), n * r),
                    (torch.log(lh).sum((-2, -1)), r * m),
                    (eh.sum((-2, -1)), r * m)))
                hy = _hyper(hy, means)
        _, _, dterm = _xpass(cx, lw, lh, mm)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lml = (pending + dterm.double()) / (float(n) * float(m))

    def host(t):
        return t.double().cpu().numpy()

    return Lanes(lml=host(lml), ew=host(ew), eh=host(eh), dw=host(dw),
                 dh=host(dh), aw=host(hy[0]), bw=host(hy[1]),
                 ah=host(hy[2]), bh=host(hy[3]))


def rank_scan(cx, seed, ranks, nrun, itmax, check, precision="f64"):
    """The reference's answer for the ranks at positions ``check`` of a
    scan over ``ranks`` x ``nrun`` lanes seeded by ``seed``: {rank:
    :class:`Lanes` of its ``nrun`` runs}.  Every lane is drawn at the
    largest rank and keeps its first r components."""
    n, m = cx.x.shape
    rmax = max(ranks)
    lanes = [k * nrun + i for k in check for i in range(nrun)]
    st = starts(seed, n, m, rmax, lanes)
    out = {}
    for k in check:
        r = ranks[k]
        idx = [k * nrun + i for i in range(nrun)]
        w0 = torch.stack([st[t][0][:, :r] for t in idx])
        h0 = torch.stack([st[t][1][:r, :] for t in idx])
        out[r] = vb_lanes(cx, w0, h0, itmax, precision)
    return out


def select(lanes):
    """Best of the runs of one rank (R/bayesian.R:268-291): the index of
    the highest log evidence."""
    return int(np.argmax(lanes.lml))
