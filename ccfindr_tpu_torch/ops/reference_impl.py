"""Pure-NumPy float64 reference implementations of the update math.

This module is the rebuild's analog of the reference's dual R/C++
implementation pair (R/bayesian.R:56-106 vs src/vbnmf_update.cpp:16-102,
switched by useC): a slow, maximally-transparent float64 oracle that the
JAX/Pallas production kernels are differential-tested against.

Formulas follow the model
    X_ij ~ Poisson((W H)_ij),
    W_ik ~ Gamma(shape aw, mean bw)   (rate aw/bw),
    H_kj ~ Gamma(shape ah, mean bh),
with one CAVI sweep per call (Cemgil 2009; see SURVEY.md Appendix A).
"""

from __future__ import annotations

import numpy as np
from scipy.special import digamma, gammaln, polygamma

EPS = np.finfo(np.float64).eps


def vb_sweep_np(x, lw, lh, ew, eh, aw, bw, ah, bh, fudge=EPS):
    """One variational-Bayes CAVI sweep in float64.

    Mirrors reference vbnmf_updateR (R/bayesian.R:56-106) /
    vbnmf_update (src/vbnmf_update.cpp:16-102).

    Returns dict with posterior means (ew, eh), geometric means
    (lw, lh), variances (dw, dh), gamma params (alw, bew, alh, beh),
    and the per-element log evidence ``lkh``.
    """
    x = np.asarray(x, dtype=np.float64)
    n, m = x.shape

    wth = lw @ lh
    xw = x / wth
    sw = lw * (xw @ lh.T)
    sh = lh * (lw.T @ xw)

    alw = aw + sw
    bew = 1.0 / (aw / bw + eh.sum(axis=1)[None, :])
    ew = alw * bew                       # must precede the eh update
    alh = ah + sh
    beh = 1.0 / (ah / bh + ew.sum(axis=0)[:, None])
    eh = alh * beh

    lw = np.exp(digamma(alw)) * bew
    lh = np.exp(digamma(alh)) * beh
    lw = np.maximum(lw, fudge)
    lh = np.maximum(lh, fudge)

    dw = alw * bew ** 2
    dh = alh * beh ** 2

    wth = lw @ lh
    s = (lw * np.log(lw)) @ lh + lw @ (lh * np.log(lh))
    u1 = (-ew @ eh - gammaln(x + 1.0)
          - x * (s / wth - np.log(wth)))
    u2 = (-(aw / bw) * ew - gammaln(aw) + aw * np.log(aw / bw)
          + alw * (1.0 + np.log(bew)) + gammaln(alw))
    u3 = (-(ah / bh) * eh - gammaln(ah) + ah * np.log(ah / bh)
          + alh * (1.0 + np.log(beh)) + gammaln(alh))
    lkh = (u1.sum() + u2.sum() + u3.sum()) / (n * m)

    return dict(ew=ew, eh=eh, lw=lw, lh=lh, dw=dw, dh=dh,
                alw=alw, bew=bew, alh=alh, beh=beh, lkh=lkh)


def hyper_update_np(mask, lw, lh, ew, eh, aw, bw, ah, bh,
                    niter=100, tol=1e-4, strict=True):
    """Empirical-Bayes gamma-hyperparameter update in float64.

    Mirrors reference hyper_update (R/bayesian.R:2-53): damped Newton on
    the shapes (aw, ah), closed-form means (bw, bh).

    ``mask`` is 4 booleans for (aw, bw, ah, bh).  Note: the reference
    always assigns ``bh <- ehm`` even when mask[3] is FALSE
    (R/bayesian.R:50-51, a latent bug); here mask[3]=False correctly
    keeps bh fixed.
    """
    if not any(mask):
        return aw, bw, ah, bh
    lwm = np.mean(np.log(lw))
    lhm = np.mean(np.log(lh))
    ewm = np.mean(ew)
    ehm = np.mean(eh)
    aw0, ah0 = aw, ah
    if mask[0] or mask[2]:
        converged = False
        for _ in range(niter - 1):
            dw_ = ((np.log(aw0) - digamma(aw0) - ewm / bw + 1.0 + lwm
                    - np.log(bw)) / (1.0 / aw0 - polygamma(1, aw0))
                   if mask[0] else 0.0)
            dh_ = ((np.log(ah0) - digamma(ah0) - ehm / bh + 1.0 + lhm
                    - np.log(bh)) / (1.0 / ah0 - polygamma(1, ah0))
                   if mask[2] else 0.0)
            aw1 = aw0 - dw_
            ah1 = ah0 - dh_
            while aw1 <= 0:
                dw_ /= 2.0
                aw1 = aw0 - dw_
            while ah1 <= 0:
                dh_ /= 2.0
                ah1 = ah0 - dh_
            df = (1.0 - aw1 / aw0) ** 2 + (1.0 - ah1 / ah0) ** 2
            if df < tol:
                converged = True
                break
            aw0, ah0 = aw1, ah1
        if not converged and strict:
            raise RuntimeError("Hyper-parameter update failed to converge")
    else:
        aw1, ah1 = aw0, ah0
    bw1 = ewm if mask[1] else bw
    bh1 = ehm if mask[3] else bh
    return aw1, bw1, ah1, bh1


def ml_sweep_np(x, w, h, eps=EPS):
    """One Lee–Seung KL multiplicative update (H then W) in float64.

    Mirrors reference nmf_updateR (R/factorize.R:2-27) with the default
    prior=FALSE path (the reference never invokes the prior branch from
    its driver; R/factorize.R:192).
    """
    x = np.asarray(x, dtype=np.float64)
    h = h * (w.T @ (x / (w @ h))) / w.sum(axis=0)[:, None]
    h = np.maximum(h, eps)
    w = w * ((x / (w @ h)) @ h.T) / h.sum(axis=1)[None, :]
    w = np.maximum(w, eps)
    return w, h


def likelihood_np(x, w, h):
    """Per-element Poisson log-likelihood in KL form
    (reference R/factorize.R:40-49)."""
    x = np.asarray(x, dtype=np.float64)
    wh = w @ h
    val = np.sum(x * np.log(wh) - wh)
    z = x[x > 0]
    val += np.sum(-z * np.log(z) + z)
    return val / x.size
