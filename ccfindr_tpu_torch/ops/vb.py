"""Variational-Bayes NMF core in PyTorch.

Counterpart of ``ccfindr_tpu.ops.vb`` (reference math
src/vbnmf_update.cpp:16-102, driver loop R/bayesian.R:303-390).  The
functions keep the JAX package's names and argument order; where the
JAX package batched restarts with ``vmap``, the port carries an
explicit leading lane axis:

* a lane-batched :class:`VBState` holds ``ew``/``lw``/``dw`` of shape
  ``(B, n, r)``, ``eh``/``lh``/``dh`` of shape ``(B, r, m)`` and
  ``lkh`` of shape ``(B,)``; :class:`Hyper` fields are ``(B,)``;
* the per-sweep math (:func:`posterior_update`, :func:`vb_sweep`,
  :func:`hyper_update`, ...) broadcasts over any leading axes, so it
  also takes one unbatched state with 0-d hypers;
* the convergence loops (:func:`vb_run`, :func:`_vb_run_fused`) are
  Python loops over the lane batch.  Each lane keeps its own sweep
  counter, and a lane whose stopping rule fired is frozen (its carry
  no longer changes), as ``vmap`` of a ``while_loop`` freezes it.

On a mesh the H family (``eh``, ``lh``, ``dh``, the passes' ``shn`` and
the ``cell_mask``) may be carried as its cell shards, and on a mesh with
``genes > 1`` the W family (``ew``, ``lw``, ``dw``, the passes' ``swn``
and the ``gene_mask``, as its column) as its gene shards
(``parallel.hshards.HShards``), as the JAX driver lays them out: every
function here then runs each side on its shards' devices
(``hshards.hmap``) and finishes every sum over cells or genes on the
reduce device, the runs row's first, from the shards' partials
(``hshards.hsum``, ``hshards.colsum``).  With every shard a multiple of
1,024 cells or genes, the result is the joined state's, bit for bit.

All functions preserve the factor dtype: float32 on the card, float64
on the CPU for parity with the JAX package's x64 tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.hshards import HShards, colsum, hmap, home, hsum, to_numpy
from ..utils import lane_matmul, lane_sum, resolve_device


class Hyper(NamedTuple):
    """Gamma-prior hyperparameters: shapes (aw, ah), means (bw, bh)."""
    aw: torch.Tensor
    bw: torch.Tensor
    ah: torch.Tensor
    bh: torch.Tensor


class VBState(NamedTuple):
    """Mean-field gamma posterior state (see ``ccfindr_tpu.ops.vb``).

    ew/eh: posterior means of W (n,r) and H (r,m); lw/lh: geometric
    means exp(E[log .]); dw/dh: posterior variances; lkh: per-element
    ELBO.  Lane-batched states carry a leading lane axis on each field.
    """
    ew: torch.Tensor
    eh: torch.Tensor
    lw: torch.Tensor
    lh: torch.Tensor
    dw: torch.Tensor
    dh: torch.Tensor
    lkh: torch.Tensor


class VBRunResult(NamedTuple):
    state: VBState
    hyper: Hyper
    lml: torch.Tensor           # recorded log evidence (lk0)
    n_iter: torch.Tensor
    hyper_failed: torch.Tensor
    # True iff the stopping rule fired, False iff the sweep bound ran out
    done: torch.Tensor


# ---------------------------------------------------------------------
# State carried between the two packages
# ---------------------------------------------------------------------

def state_from_numpy(obj, device="cuda", dtype=None):
    """Carry a (possibly nested) NamedTuple of arrays — a JAX package
    ``VBState``/``Hyper``/``VBRunResult`` passed through ``np.asarray``
    field by field, or the arrays themselves — into the port's tensors
    on ``device``.  Floating fields take ``dtype`` when given; the
    NamedTuple types map onto this module's classes by name."""
    device = resolve_device(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = {"VBState": VBState, "Hyper": Hyper,
               "VBRunResult": VBRunResult}.get(type(obj).__name__,
                                                type(obj))
        return cls(*(state_from_numpy(f, device, dtype) for f in obj))
    t = torch.tensor(np.asarray(obj), device=device)    # a copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def state_to_numpy(obj):
    """Inverse of :func:`state_from_numpy`: the same NamedTuple with
    every tensor as a host numpy array (an H family carried as shards
    joined on the host)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(state_to_numpy(f) for f in obj))
    if isinstance(obj, (torch.Tensor, HShards)):
        return to_numpy(obj)
    return np.asarray(obj)


# ---------------------------------------------------------------------
# Special functions (Bernoulli-series twins of the JAX package's)
# ---------------------------------------------------------------------

def _horner(coeffs, z):
    acc = torch.full_like(z, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * z + c
    return acc


def trigamma(x):
    """psi'(x) for x > 0: recurrence to x >= 10 + Bernoulli asymptotic
    series (Abramowitz & Stegun 6.4.12)."""
    shift = 10.0
    acc = torch.zeros_like(x)
    xs = x
    for _ in range(10):
        lt = xs < shift
        acc = acc + torch.where(lt, 1.0 / (xs * xs), 0.0)
        xs = torch.where(lt, xs + 1.0, xs)
    z = 1.0 / (xs * xs)
    series = _horner([-691.0 / 2730.0, 5.0 / 66.0, -1.0 / 30.0,
                      1.0 / 42.0, -1.0 / 30.0, 1.0 / 6.0], z)
    return acc + 1.0 / xs + 0.5 * z + z / xs * series


def digamma_approx(x):
    """psi(x) for x > 0: recurrence to x >= 10 + Bernoulli asymptotic
    series (rel err < 1e-12 in f64 for x in [1e-4, 1e9])."""
    shift = 10.0
    acc = torch.zeros_like(x)
    xs = x
    for _ in range(10):
        lt = xs < shift
        acc = acc + torch.where(lt, 1.0 / xs, 0.0)
        xs = torch.where(lt, xs + 1.0, xs)
    z = 1.0 / (xs * xs)
    series = _horner([1.0 / 12.0, -691.0 / 32760.0, 1.0 / 132.0,
                      -1.0 / 240.0, 1.0 / 252.0, -1.0 / 120.0,
                      1.0 / 12.0], z)
    return torch.log(xs) - 0.5 / xs - z * series - acc


_HALF_LOG_2PI = 0.9189385332046727417803297364056176


def gammaln_approx(x):
    """lgamma(x) for x > 0: recurrence to x >= 10 + Stirling series."""
    shift = 10.0
    prod = torch.ones_like(x)
    xs = x
    for _ in range(10):
        lt = xs < shift
        prod = torch.where(lt, prod * xs, prod)
        xs = torch.where(lt, xs + 1.0, xs)
    z = 1.0 / (xs * xs)
    series = _horner([1.0 / 156.0, -691.0 / 360360.0, 1.0 / 1188.0,
                      -1.0 / 1680.0, 1.0 / 1260.0, -1.0 / 360.0,
                      1.0 / 12.0], z)
    return ((xs - 0.5) * torch.log(xs) - xs + _HALF_LOG_2PI
            + series / xs - torch.log(prod))


def digamma_gammaln_both(x):
    """(psi(x), lgamma(x)) sharing ONE recurrence shift chain.

    float32 shifts to x >= 6 in 6 steps with a 3-term series
    (truncation ~2.5e-9, below f32 eps); float64 keeps the full 10/7
    configuration.  The CUDA posterior kernels branch the same way on
    their factor type (csrc/specials.cuh).
    """
    f32 = x.dtype == torch.float32
    shift, steps = (6.0, 6) if f32 else (10.0, 10)
    acc = torch.zeros_like(x)
    prod = torch.ones_like(x)
    xs = x
    for _ in range(steps):
        lt = xs < shift
        acc = acc + torch.where(lt, 1.0 / xs, 0.0)
        prod = prod * torch.where(lt, xs, 1.0)
        xs = torch.where(lt, xs + 1.0, xs)
    z = 1.0 / (xs * xs)
    logxs = torch.log(xs)
    if f32:
        dig_series = _horner([1.0 / 252.0, -1.0 / 120.0, 1.0 / 12.0], z)
        lg_series = _horner([1.0 / 1260.0, -1.0 / 360.0, 1.0 / 12.0], z)
    else:
        dig_series = _horner([1.0 / 12.0, -691.0 / 32760.0,
                              1.0 / 132.0, -1.0 / 240.0, 1.0 / 252.0,
                              -1.0 / 120.0, 1.0 / 12.0], z)
        lg_series = _horner([1.0 / 156.0, -691.0 / 360360.0,
                             1.0 / 1188.0, -1.0 / 1680.0,
                             1.0 / 1260.0, -1.0 / 360.0, 1.0 / 12.0], z)
    psi = logxs - 0.5 / xs - z * dig_series - acc
    lgam = ((xs - 0.5) * logxs - xs + _HALF_LOG_2PI
            + lg_series / xs - torch.log(prod))
    return psi, lgam


# ---------------------------------------------------------------------
# Dense sufficient statistics and ELBO data term ('dense' parity path)
# ---------------------------------------------------------------------

def _mT(a):
    return a.transpose(-1, -2)


def suffstats_dense(x, lw, lh):
    """sw = lw * ((x / (lw@lh)) @ lh^T),  sh = lh * (lw^T @ (x / (lw@lh)))."""
    xf = x.to(lw.dtype)
    wth = lane_matmul(lw, lh)
    xw = xf / wth
    return lw * lane_matmul(xw, _mT(lh)), lh * lane_matmul(_mT(lw), xw)


def elbo_data_term(x, lw, lh):
    """-sum x*(S/wth - log wth), S = (lw log lw)@lh + lw@(lh log lh),
    in the folded form that shares the suffstat GEMMs."""
    xf = x.to(lw.dtype)
    wth = lane_matmul(lw, lh)
    u = xf / wth
    return (-lane_sum(lane_matmul(u, _mT(lh)) * (lw * torch.log(lw)), 2)
            - lane_sum(lane_matmul(_mT(lw), u) * (lh * torch.log(lh)), 2)
            + lane_sum(xf * torch.log(wth), 2))


def fused_dense(x, lw, lh):
    """Single-pass dense backend: suffstat numerators + ELBO data term
    for the same (lw, lh), sharing wth and x/wth.

    Returns (swn, shn, dterm) with sw = lw*swn, sh = lh*shn."""
    xf = x.to(lw.dtype)
    wth = lane_matmul(lw, lh)
    a = xf / wth
    swn = lane_matmul(a, _mT(lh))
    shn = lane_matmul(_mT(lw), a)
    dterm = (-(lane_sum(swn * (lw * torch.log(lw)), 2)
               + lane_sum(shn * (lh * torch.log(lh)), 2))
             + lane_sum(xf * torch.log(wth), 2))
    return swn, shn, dterm


# ---------------------------------------------------------------------
# Gamma-posterior update
# ---------------------------------------------------------------------

def _mat(h):
    """Lane scalar (...,) -> (..., 1, 1) to broadcast against factors."""
    return h[..., None, None]


def _gene_col(gene_mask):
    """The gene mask as the column (n_pad, 1) that masks W's rows (its
    gene shards already are)."""
    if gene_mask is None or isinstance(gene_mask, HShards):
        return gene_mask
    return gene_mask[:, None]


def posterior_update(sw, sh, state: VBState, hyper: Hyper, fudge, lgx,
                     cell_mask=None, m_true=None, rank_mask=None,
                     r_true=None, gene_mask=None, n_true=None):
    """Gamma-posterior update from sufficient statistics plus the ELBO
    terms that need no pass over X.

    Returns ``(new_state, pending)`` with ``pending`` the unnormalized
    partial ELBO  -sum(ew@eh) - lgx + U2 + U3  (see
    ``ccfindr_tpu.ops.vb.posterior_update``).  Padding contributes
    nothing, as in the JAX package:

    * ``rank_mask`` (..., r) marks the live components of a batched rank
      scan (prefix masks), ``r_true`` (...,) their count: masked
      components have ew/eh/dw/dh zeroed, lw/lh pinned at ``fudge``, and
      drop out of U2/U3;
    * ``cell_mask`` (m_pad,) marks the real cells of a mesh-padded cell
      axis, ``m_true`` their count: padded eh/dh are zeroed, lh pinned at
      ``fudge``, and U3 is mask-summed;
    * ``gene_mask`` (n_pad,) marks the real genes of a gene-sharded
      mesh, ``n_true`` their count: padded ew (before it feeds the H
      beta) and dw rows are zeroed, lw rows pinned at 1, and U2 is
      mask-summed.

    ``sh``, the state's H family and ``cell_mask`` may be cell shards,
    ``sw``, the state's W family and the gene mask's column (n_pad, 1)
    gene shards (``parallel.hshards.HShards``, see the module
    docstring).
    """
    n = n_true if n_true is not None else state.lw.shape[-2]
    r = state.lw.shape[-1]
    m = m_true if m_true is not None else state.lh.shape[-1]
    r_eff = r_true if r_true is not None else r
    dev = home(state.lw)
    aw, bw, ah, bh = hyper
    aw_, bw_, ah_, bh_ = _mat(aw), _mat(bw), _mat(ah), _mat(bh)
    mg = _gene_col(gene_mask)

    bew = 1.0 / (aw_ / bw_ + hsum(state.eh, 1, dev)[..., None, :])
    # padded gene rows must be dead before colSums(ew) feeds beh
    alw, ew = hmap(_w_alpha, sw, aw_, bew, mg)
    beh = 1.0 / (ah_ / bh_ + colsum(ew, dev)[..., :, None])
    ew, lw, dw, u2_elem = hmap(_w_posterior, alw, ew, aw_, bw_, bew, fudge,
                               rank_mask, mg)
    eh, lh, dh, u3_elem = hmap(_h_posterior, sh, ah_, bh_, beh, fudge,
                               rank_mask, cell_mask)

    u1_part = -lane_sum(colsum(ew, dev) * hsum(eh, 1, dev)) - lgx
    u2 = (hsum(u2_elem, 2, dev)
          + n * r_eff * (aw * torch.log(aw / bw) - torch.lgamma(aw)))
    u3 = (hsum(u3_elem, 2, dev)
          + r_eff * m * (ah * torch.log(ah / bh) - torch.lgamma(ah)))
    pending = u1_part + u2 + u3
    return (VBState(ew=ew, eh=eh, lw=lw, lh=lh, dw=dw, dh=dh,
                    lkh=state.lkh), pending)


def _w_alpha(sw, aw_, bew, mg):
    """The W posterior's shape and mean on one shard of genes (or the
    whole W), the mean's padded gene rows zeroed: ``(alw, ew)``."""
    alw = aw_ + sw
    ew = alw * bew                    # must precede the eh update
    if mg is not None:
        ew = ew * mg
    return alw, ew


def _w_posterior(alw, ew, aw_, bw_, bew, fudge, rank_mask, mg):
    """The rest of the W half of :func:`posterior_update` on one shard of
    genes (or the whole W): ``(ew, lw, dw, u2_elem)``."""
    lw = torch.maximum(torch.exp(torch.digamma(alw)) * bew, fudge)
    dw = alw * bew ** 2
    if rank_mask is not None:
        mw = rank_mask[..., None, :]
        ew = ew * mw
        dw = dw * mw
        lw = torch.where(mw > 0, lw, fudge)
    if mg is not None:
        dw = dw * mg
        lw = torch.where(mg > 0, lw, 1.0)
    u2_elem = (-(aw_ / bw_) * ew + alw * (1.0 + torch.log(bew))
               + torch.lgamma(alw))
    if rank_mask is not None:
        u2_elem = u2_elem * rank_mask[..., None, :]
    if mg is not None:
        u2_elem = u2_elem * mg
    return ew, lw, dw, u2_elem


def _h_posterior(sh, ah_, bh_, beh, fudge, rank_mask, cell_mask):
    """The H half of :func:`posterior_update` on one shard of cells (or
    the whole H): ``(eh, lh, dh, u3_elem)``."""
    alh = ah_ + sh
    eh = alh * beh
    lh = torch.maximum(torch.exp(torch.digamma(alh)) * beh, fudge)
    dh = alh * beh ** 2
    if rank_mask is not None:
        mh = rank_mask[..., :, None]
        eh = eh * mh
        dh = dh * mh
        lh = torch.where(mh > 0, lh, fudge)
    if cell_mask is not None:
        eh = eh * cell_mask
        dh = dh * cell_mask
        lh = torch.where(cell_mask > 0, lh, fudge)
    u3_elem = (-(ah_ / bh_) * eh + alh * (1.0 + torch.log(beh))
               + torch.lgamma(alh))
    if rank_mask is not None:
        u3_elem = u3_elem * rank_mask[..., :, None]
    if cell_mask is not None:
        u3_elem = u3_elem * cell_mask
    return eh, lh, dh, u3_elem


def vb_sweep(x, state: VBState, hyper: Hyper, fudge, lgx,
             suffstats=suffstats_dense, data_term=elbo_data_term,
             cell_mask=None, m_true=None, rank_mask=None, r_true=None,
             gene_mask=None, n_true=None) -> VBState:
    """One CAVI sweep (reference src/vbnmf_update.cpp:33-90):
    suffstats, posterior update, and the new state's ELBO in ``lkh``.

    ``suffstats(x, lw, lh) -> (sw, sh)`` and ``data_term(x, lw, lh) ->
    (B,)`` are the injection points of the two-pass kernels
    (``ops.kernels.vb_kernels.make_pallas_backend``) and of the mesh
    passes (``parallel.sharded``); with those ``x`` may be padded, so
    the true (n, m) come from ``n_true``/``m_true`` or the state.  The
    masks: see :func:`posterior_update`."""
    n = n_true if n_true is not None else state.lw.shape[-2]
    m = m_true if m_true is not None else state.lh.shape[-1]
    sw, sh = suffstats(x, state.lw, state.lh)
    new, pending = posterior_update(
        sw, sh, state, hyper, fudge, lgx, cell_mask=cell_mask,
        m_true=m_true, rank_mask=rank_mask, r_true=r_true,
        gene_mask=gene_mask, n_true=n_true)
    lkh = (pending + data_term(x, new.lw, new.lh)) / (float(n) * float(m))
    return new._replace(lkh=lkh)


# ---------------------------------------------------------------------
# Empirical-Bayes hyperparameter update (reference R/bayesian.R:2-53)
# ---------------------------------------------------------------------

def _factor_means(state: VBState, cell_mask=None, m_true=None,
                  rank_mask=None, r_true=None, gene_mask=None,
                  n_true=None):
    """(mean log lw, mean ew, mean log lh, mean eh) over the real
    entries, as the JAX package masks them."""
    n_pad = state.lw.shape[-2]
    r_pad, m_pad = state.lh.shape[-2:]
    dev = home(state.lw)
    if cell_mask is None and rank_mask is None and gene_mask is None:
        return (hsum(hmap(torch.log, state.lw), 2, dev) / (n_pad * r_pad),
                hsum(state.ew, 2, dev) / (n_pad * r_pad),
                hsum(hmap(torch.log, state.lh), 2, dev) / (r_pad * m_pad),
                hsum(state.eh, 2, dev) / (r_pad * m_pad))
    n_eff = n_true if n_true is not None else n_pad
    m_eff = m_true if m_true is not None else m_pad
    r_eff = r_true if r_true is not None else r_pad
    ones = torch.ones((1, 1), dtype=state.lw.dtype, device=dev)
    denom_w = n_eff * r_eff
    denom_h = r_eff * m_eff
    logw = hmap(_masked_log_w, state.lw, ones, rank_mask,
                _gene_col(gene_mask))
    logh = hmap(_masked_log, state.lh, ones, rank_mask, cell_mask)
    return (hsum(logw, 2, dev) / denom_w,
            hsum(state.ew, 2, dev) / denom_w,     # ew is 0 in padding
            hsum(logh, 2, dev) / denom_h,
            hsum(state.eh, 2, dev) / denom_h)    # eh is 0 in padding


def _masked_log_w(lw, ones, rank_mask, mg):
    """log lw, 0 where the W mask is, times the mask where there is one
    (one shard of genes, or the whole W)."""
    mask_w = ones
    if rank_mask is not None:
        mask_w = mask_w * rank_mask[..., None, :]
    if mg is not None:
        mask_w = mask_w * mg
    logw = torch.where(mask_w > 0, torch.log(lw), 0.0)
    if rank_mask is not None or mg is not None:
        return logw * mask_w
    return logw


def _masked_log(lh, ones, rank_mask, cell_mask):
    """log lh times the H mask, 0 where the mask is (one shard of
    cells, or the whole H)."""
    mask_h = ones
    if rank_mask is not None:
        mask_h = mask_h * rank_mask[..., :, None]
    if cell_mask is not None:
        mask_h = mask_h * cell_mask
    return torch.where(mask_h > 0, torch.log(lh), 0.0) * mask_h


def hyper_update(mask, state: VBState, hyper: Hyper, niter: int = 100,
                 tol: float = 1e-4, cell_mask=None, m_true=None,
                 rank_mask=None, r_true=None, gene_mask=None, n_true=None,
                 means=None):
    """Damped-Newton update of the gamma shapes + closed-form means.

    ``mask`` is a 4-tuple of bools for (aw, bw, ah, bh); a False entry
    keeps that hyperparameter (including ``bh``: ``bh1 = ehm if
    mask[3] else bh0``, as the JAX package has it).  Returns
    ``(new_hyper, failed)`` with ``failed`` set per lane where the
    Newton did not reach ``tol`` in ``niter - 1`` steps.  The masks
    restrict the factor means to the real entries (see
    :func:`posterior_update`).  ``means`` supplies (lwm, ewm, lhm, ehm)
    directly; ``state`` may then be None.
    """
    mask = tuple(bool(b) for b in mask)
    aw0, bw0, ah0, bh0 = hyper
    if not any(mask):
        return hyper, torch.zeros(aw0.shape, dtype=torch.bool,
                                  device=aw0.device)
    if means is None:
        means = _factor_means(state, cell_mask, m_true, rank_mask, r_true,
                              gene_mask, n_true)
    lwm, ewm, lhm, ehm = means

    if mask[0] or mask[2]:
        def newton_step(a0, mean_e, mean_l, b0, enabled):
            if not enabled:
                return torch.zeros_like(a0)
            return ((torch.log(a0) - torch.digamma(a0) - mean_e / b0
                     + 1.0 + mean_l - torch.log(b0))
                    / (1.0 / a0 - trigamma(a0)))

        def positive_step(a0, d):
            # halve d until a0 - d > 0 (reference R/bayesian.R:28-35),
            # in the closed form k = floor(log2(d/a0)) + 1; scaling by
            # 2^-k is exact, and one select each way absorbs log2 ulps
            k = torch.clamp_min(torch.floor(torch.log2(d / a0)) + 1.0,
                                0.0)
            k = torch.where((d > 0) & torch.isfinite(d), k, 0.0)
            ki = torch.clamp(k, 0.0, 2100.0).to(torch.int32)
            d2 = torch.ldexp(d, -ki)
            d2 = torch.where(a0 - d2 <= 0, d2 * 0.5, d2)
            over = (ki >= 1) & (d > 0) & (a0 - d2 * 2.0 > 0)
            return torch.where(over, d2 * 2.0, d2)

        aw, ah = aw0, ah0
        done = torch.zeros(aw0.shape, dtype=torch.bool, device=aw0.device)
        for _ in range(niter - 1):
            active = ~done
            if not bool(active.any()):
                break
            dw = positive_step(aw, newton_step(aw, ewm, lwm, bw0, mask[0]))
            dh = positive_step(ah, newton_step(ah, ehm, lhm, bh0, mask[2]))
            aw1 = aw - dw
            ah1 = ah - dh
            df = (1.0 - aw1 / aw) ** 2 + (1.0 - ah1 / ah) ** 2
            aw = torch.where(active, aw1, aw)
            ah = torch.where(active, ah1, ah)
            done = torch.where(active, df < tol, done)
        failed = ~done
    else:
        aw, ah = aw0, ah0
        failed = torch.zeros(aw0.shape, dtype=torch.bool,
                             device=aw0.device)
    bw1 = ewm if mask[1] else bw0
    bh1 = ehm if mask[3] else bh0
    return Hyper(aw=aw, bw=bw1, ah=ah, bh=bh1), failed


# ---------------------------------------------------------------------
# Initialization (reference vb_init, R/bayesian.R:109-171)
# ---------------------------------------------------------------------

def vb_init_random(generator, n, m, rank, hyper: Hyper,
                   dtype=torch.float32, device="cuda") -> VBState:
    """Random init: W, H drawn from the gamma priors with the explicit
    ``torch.Generator`` (drawn on the generator's device in float64,
    then cast and moved, so a seed gives the same state on any
    ``device``)."""
    device = resolve_device(device)
    aw, bw, ah, bh = (float(v) for v in hyper)
    gdev = generator.device
    w = torch._standard_gamma(
        torch.full((n, rank), aw, dtype=torch.float64, device=gdev),
        generator=generator) * (bw / aw)
    h = torch._standard_gamma(
        torch.full((rank, m), ah, dtype=torch.float64, device=gdev),
        generator=generator) * (bh / ah)
    w = w.to(device=device, dtype=dtype)
    h = h.to(device=device, dtype=dtype)
    return VBState(ew=w, eh=h, lw=w, lh=h, dw=torch.zeros_like(w),
                   dh=torch.zeros_like(h),
                   lkh=torch.tensor(-np.inf, dtype=dtype, device=device))


def vb_init_svd(x, rank, hyper: Hyper, variant: str = "svd2",
                dtype=torch.float32, method: str = "auto",
                seed: int = 0, device="cuda") -> VBState:
    """Deterministic SVD-based inits.

    ``'svd'``  — NNDSVD (Boutsidis & Gallopoulos 2008) with the correct
    negative-part norms; ``'svd2'`` — truncated SVD, absolute values,
    scaled so mean(h) = bh (reference R/bayesian.R:150-159).
    ``method``: ``'exact'`` — host Lanczos with a seeded start vector,
    or a full SVD for small shapes; ``'randomized'`` —
    :func:`ccfindr_tpu_torch.ops.rsvd.randomized_svd` on ``device`` in
    ``dtype`` (dense products, or CSR products for a sparse X, never
    densified); ``'auto'``, the default, as in the JAX package: exact
    up to 4096 on the short axis, randomized above it and for a
    :class:`~ccfindr_tpu_torch.ops.sparse.SparseCounts`.  ``x`` may be
    dense, scipy sparse or a SparseCounts.

    The randomized start draws its test matrix Omega from a
    ``torch.Generator`` seeded by ``seed``, where the JAX package draws
    it from ``jax.random``: above 4096 the default start differs from
    JAX's only through Omega's draw, and with JAX's Omega it is JAX's
    start.
    """
    import scipy.sparse as sp

    from .sparse import SparseCounts

    device = resolve_device(device)
    if isinstance(x, SparseCounts):
        n, m = x.n, x.m
        sparse_in = True
    else:
        sparse_in = sp.issparse(x)
        x = sp.csr_matrix(x).astype(np.float64) if sparse_in else np.asarray(x)
        n, m = x.shape
    if method == "auto":
        method = ("randomized" if min(n, m) > 4096
                  or isinstance(x, SparseCounts) else "exact")
    if method == "randomized":
        from . import rsvd
        from .sparse import from_scipy

        if isinstance(x, SparseCounts):
            x = x.to(device)
        elif sparse_in:
            x = from_scipy(x, dtype=dtype, device=device)
        else:
            # X's own values to the device, converted there: the values
            # of a float64 copy on the host, without its 8 bytes an
            # element (16 GB at the atlas shape, made again a rank)
            x = torch.as_tensor(np.ascontiguousarray(x),
                                device=device).to(dtype)
        u, s, vt = (t.cpu().numpy().astype(np.float64)
                    for t in rsvd.randomized_svd(x, rank, seed=seed))
    elif method != "exact":
        raise ValueError(f"unknown svd method {method!r}")
    else:
        if not sparse_in:
            x = np.asarray(x, dtype=np.float64)
        if min(n, m) / 2 > rank:
            import scipy.sparse.linalg as spla

            # seeded start vector: svds defaults to a RANDOM v0
            v0 = np.random.default_rng(seed).standard_normal(min(n, m))
            u, s, vt = spla.svds(x, k=rank, v0=v0)
            order = np.argsort(-s)
            u, s, vt = u[:, order], s[order], vt[order]
        else:
            xd = x.toarray() if sparse_in else x
            u, s, vt = np.linalg.svd(xd, full_matrices=False)
            u, s, vt = u[:, :rank], s[:rank], vt[:rank]

    if variant == "svd":
        w = np.zeros((n, rank))
        h = np.zeros((rank, m))
        d1 = np.sqrt(s[0])
        w[:, 0] = d1 * u[:, 0]
        sgn = np.sign(w[0, 0]) if w[0, 0] != 0 else 1.0
        if sgn < 0:
            w = -w
        h[0, :] = sgn * d1 * vt[0]
        for k in range(1, rank):
            xv, yv = u[:, k], vt[k]
            xp, xn = np.maximum(xv, 0), np.maximum(-xv, 0)
            yp, yn = np.maximum(yv, 0), np.maximum(-yv, 0)
            xpn, ypn = np.linalg.norm(xp), np.linalg.norm(yp)
            xnn, ynn = np.linalg.norm(xn), np.linalg.norm(yn)
            mp, mn = xpn * ypn, xnn * ynn
            if mp >= mn:
                uu, vv, sig = xp / max(xpn, 1e-300), yp / max(ypn, 1e-300), mp
            else:
                uu, vv, sig = xn / max(xnn, 1e-300), yn / max(ynn, 1e-300), mn
            w[:, k] = np.sqrt(s[k] * sig) * uu
            h[k, :] = np.sqrt(s[k] * sig) * vv
        eps = np.finfo(np.float64).eps
        w = np.maximum(w, eps)
        h = np.maximum(h, eps)
    elif variant == "svd2":
        w = np.abs(u)
        h = np.abs(np.diag(s) @ vt)
        scale = float(hyper.bh) / h.mean()
        h = h * scale
        w = w / scale
    else:
        raise ValueError(f"Unknown initializer {variant!r}")

    w = torch.as_tensor(w, dtype=dtype, device=device)
    h = torch.as_tensor(h, dtype=dtype, device=device)
    return VBState(ew=w, eh=h, lw=w, lh=h, dw=torch.zeros_like(w),
                   dh=torch.zeros_like(h),
                   lkh=torch.tensor(-np.inf, dtype=dtype, device=device))


# ---------------------------------------------------------------------
# Convergence loops over a lane batch (reference R/bayesian.R:337-352)
# ---------------------------------------------------------------------

def _lanes(active, t):
    """Broadcast a (B,) lane flag against a lane-batched tensor."""
    return active.view(active.shape + (1,) * (t.dim() - active.dim()))


def _select(active, new, old):
    """Per lane: ``new`` where ``active``, else ``old`` (NamedTuples
    field by field, shards shard by shard)."""
    if isinstance(new, HShards):
        return hmap(_where_lanes, active, new, old)
    if isinstance(new, tuple):
        return type(new)(*(_select(active, a, b)
                           for a, b in zip(new, old)))
    return _where_lanes(active, new, old)


def _where_lanes(active, new, old):
    return torch.where(_lanes(active, new), new, old)


def mask_initial_state(state0: VBState, rank_mask, fudge, cell_mask=None,
                       gene_mask=None) -> VBState:
    """Zero the padded rank components, mesh-padded cells and genes of a
    lane-batched initial state (lw/lh pinned at ``fudge``, padded lw rows
    at 1), as every JAX loop does on entry."""
    if rank_mask is not None or gene_mask is not None:
        ew, lw, dw = hmap(_mask_w, state0.ew, state0.lw, state0.dw,
                          rank_mask, _gene_col(gene_mask), fudge)
        state0 = state0._replace(ew=ew, lw=lw, dw=dw)
    if rank_mask is not None or cell_mask is not None:
        eh, lh, dh = hmap(_mask_h, state0.eh, state0.lh, state0.dh,
                          rank_mask, cell_mask, fudge)
        state0 = state0._replace(eh=eh, lh=lh, dh=dh)
    return state0


def _mask_w(ew, lw, dw, rank_mask, mg, fudge):
    """:func:`mask_initial_state` on the W family (one shard of genes,
    or the whole W)."""
    if rank_mask is not None:
        mw = rank_mask[..., None, :]
        ew, dw = ew * mw, dw * mw
        lw = torch.where(mw > 0, lw, fudge)
    if mg is not None:
        ew, dw = ew * mg, dw * mg
        lw = torch.where(mg > 0, lw, 1.0)
    return ew, lw, dw


def _mask_h(eh, lh, dh, rank_mask, cell_mask, fudge):
    """:func:`mask_initial_state` on the H family (one shard of cells,
    or the whole H)."""
    if rank_mask is not None:
        mh = rank_mask[..., :, None]
        eh, dh = eh * mh, dh * mh
        lh = torch.where(mh > 0, lh, fudge)
    if cell_mask is not None:
        eh, dh = eh * cell_mask, dh * cell_mask
        lh = torch.where(cell_mask > 0, lh, fudge)
    return eh, lh, dh


def _loop_scalars(x, state0, fudge, tol, lk0_init, it0):
    ref_t = state0.lw.dtype
    dev = home(state0.lw)
    nb = state0.lw.shape[0]
    if fudge is None:
        fudge = torch.finfo(ref_t).eps
    fudge = torch.as_tensor(fudge, dtype=ref_t, device=dev)
    tol = torch.as_tensor(tol, dtype=ref_t, device=dev)
    # lgamma(0 + 1) = 0: the sum runs over the nonzeros only (a sparse
    # layout's .val holds each once), in row-major order, so a
    # zero-padded X gives the same bits as the unpadded one (a mesh's
    # X keeps its nonzeros on the host: they cross here)
    xval = x[x != 0] if isinstance(x, torch.Tensor) else x.val
    lgx = lane_sum(torch.lgamma(xval.to(dev, ref_t) + 1.0))
    lk0 = torch.as_tensor(0.0 if lk0_init is None else lk0_init,
                          dtype=ref_t, device=dev).expand(nb).clone()
    it = torch.full((nb,), int(it0), dtype=torch.int64, device=dev)
    false = torch.zeros(nb, dtype=torch.bool, device=dev)
    return fudge, tol, lgx, lk0, it, false


def vb_run(x, state0: VBState, hyper0: Hyper, *, itmax: int = 10000,
           tol: float = 1e-5, fudge=None, hyper_mask=(True,) * 4,
           n0: int = 10, dn: int = 1, suffstats=suffstats_dense,
           data_term=elbo_data_term, fused=None,
           cell_mask=None, m_true=None, rank_mask=None, r_true=None,
           gene_mask=None, n_true=None, it0=1,
           lk0_init=None, elbo_every: int = 1) -> VBRunResult:
    """Iterate :func:`vb_sweep` to convergence for a lane batch.

    Stopping mirrors the reference (R/bayesian.R:345-348): after the
    first ``n0`` sweeps, stop when the ELBO is non-decreasing and its
    relative change is below ``tol`` (or on NaN); ``lml`` is the ELBO
    of the penultimate sweep.  ``x`` is a dense tensor, or the sparse
    layout ``ops.tile.TileCounts`` that ``fused`` takes.
    ``suffstats``/``data_term`` replace the two passes of
    :func:`vb_sweep` (lane-batched: ``suffstats(x, lw (B,n,r), lh
    (B,r,m)) -> (sw, sh)``, ``data_term(x, lw, lh) -> (B,)``).  ``fused``
    (a ``(x, lw, lh) -> (swn, shn, dterm)`` function such as
    :func:`fused_dense`) selects the deferred-ELBO loop
    :func:`_vb_run_fused`, which ignores ``suffstats``/``data_term``;
    ``elbo_every=k`` then checks the ELBO every k-th sweep only, and
    ``fused`` must take the ``do_elbo`` flag.  The masks and true
    extents of a mesh-padded or rank-padded run are those of
    :func:`posterior_update`.  ``it0``/``lk0_init`` resume a bounded run
    exactly.
    """
    masks = dict(cell_mask=cell_mask, m_true=m_true, rank_mask=rank_mask,
                 r_true=r_true, gene_mask=gene_mask, n_true=n_true)
    if elbo_every != 1 and fused is None:
        raise ValueError("elbo_every needs a fused backend whose "
                         "kernel takes the do_elbo flag")
    if fused is not None:
        return _vb_run_fused(x, state0, hyper0, itmax=itmax, tol=tol,
                             fudge=fudge, hyper_mask=hyper_mask, n0=n0,
                             dn=dn, fused=fused, it0=it0,
                             lk0_init=lk0_init, elbo_every=elbo_every,
                             **masks)
    fudge, tol, lgx, lk0, it, done = _loop_scalars(
        x, state0, fudge, tol, lk0_init, it0)
    hfail = done.clone()
    state = mask_initial_state(state0, rank_mask, fudge, cell_mask,
                               gene_mask)
    hyper = hyper0
    while True:
        active = (~done) & (it <= itmax)
        if not bool(active.any()):
            break
        st = vb_sweep(x, state, hyper, fudge, lgx, suffstats=suffstats,
                      data_term=data_term, **masks)
        do_hyper = (it > n0) & (it % dn == 0)
        new_hyper, failed = hyper_update(hyper_mask, st, hyper, **masks)
        hyper_n = _select(do_hyper, new_hyper, hyper)
        lkh = st.lkh
        conv = ((it > 1) & (it > n0) & (lkh >= lk0)
                & (torch.abs(1.0 - lkh / lk0) < tol))
        stop = torch.isnan(lkh) | conv
        state = _select(active, st, state)
        hyper = _select(active, hyper_n, hyper)
        hfail = hfail | (active & do_hyper & failed)
        lk0 = torch.where(active & ~stop, lkh, lk0)
        done = torch.where(active, stop, done)
        it = it + active.to(it.dtype)
    return VBRunResult(state=state, hyper=hyper, lml=lk0,
                       n_iter=it - 1, hyper_failed=hfail, done=done)


def _vb_run_fused(x, state0: VBState, hyper0: Hyper, *, itmax, tol,
                  fudge, hyper_mask, n0, dn, fused, cell_mask=None,
                  m_true=None, rank_mask=None, r_true=None, gene_mask=None,
                  n_true=None, it0=1, lk0_init=None,
                  elbo_every: int = 1) -> VBRunResult:
    """Deferred-ELBO loop over a fused single-pass function: fused
    iteration i completes sweep i-1's ELBO while its suffstats begin
    sweep i (see ``ccfindr_tpu.ops.vb._vb_run_fused``).  With
    ``elbo_every=k > 1`` only the sweeps ``itp % k == 0`` are checked,
    and ``fused`` gets ``do_elbo`` (B,) so that it can skip the data
    term's ``x log wth`` on the others; stopping is conservative, as
    the ELBO is monotone."""
    masks = dict(cell_mask=cell_mask, m_true=m_true, rank_mask=rank_mask,
                 r_true=r_true, gene_mask=gene_mask, n_true=n_true)
    n = n_true if n_true is not None else state0.lw.shape[-2]
    m = m_true if m_true is not None else state0.lh.shape[-1]
    fudge, tol, lgx, lk0, it, done = _loop_scalars(
        x, state0, fudge, tol, lk0_init, it0)
    hfail = done.clone()
    pending = torch.zeros_like(lk0)
    state = mask_initial_state(state0, rank_mask, fudge, cell_mask,
                               gene_mask)
    hyper = hyper0
    it_start = int(it0)
    while True:
        active = (~done) & (it <= itmax + 1)
        if not bool(active.any()):
            break
        itp = it - 1                      # the sweep being checked
        if elbo_every > 1:
            elbo_now = itp % elbo_every == 0
            swn, shn, dterm = fused(x, state.lw, state.lh,
                                    do_elbo=elbo_now.to(lk0.dtype))
        else:
            elbo_now = True
            swn, shn, dterm = fused(x, state.lw, state.lh)
        lkh_prev = (pending + dterm) / (float(n) * float(m))
        valid = (itp >= it_start) & elbo_now
        conv = (valid & (itp > 1) & (itp > n0) & (lkh_prev >= lk0)
                & (torch.abs(1.0 - lkh_prev / lk0) < tol))
        stop = (torch.isnan(lkh_prev) & valid) | conv
        lk0_n = torch.where(valid & ~stop, lkh_prev, lk0)
        st = state._replace(lkh=torch.where(valid, lkh_prev, state.lkh))

        do_sweep = (~stop) & (it <= itmax)
        new_state, new_pending = posterior_update(
            hmap(torch.mul, state.lw, swn), hmap(torch.mul, state.lh, shn),
            st, hyper,
            fudge, lgx, **masks)
        # each (B, r, m) array is 3.4 GB at 38 lanes of the oversize
        # configuration: drop every one as soon as it is read
        del swn, shn
        do_hyper = do_sweep & (it > n0) & (it % dn == 0)
        new_hyper, failed = hyper_update(hyper_mask, new_state, hyper,
                                         **masks)
        st = _select(do_sweep, new_state, st)
        del new_state
        hyper = _select(active & do_hyper, new_hyper, hyper)
        hfail = hfail | (active & do_hyper & failed)
        state = _select(active, st, state)
        del st
        pending = torch.where(active & do_sweep, new_pending, pending)
        lk0 = torch.where(active, lk0_n, lk0)
        done = torch.where(active, stop, done)
        it = it + active.to(it.dtype)
    return VBRunResult(state=state, hyper=hyper, lml=lk0,
                       n_iter=it - 2, hyper_failed=hfail, done=done)


def uniform_columns(ew, tol):
    """Per-column degeneracy flags |max - min| < tol
    (reference R/bayesian.R:368-369)."""
    return (ew.amax(-2) - ew.amin(-2)) < tol
