"""Sparse count-matrix passes over the nonzeros, in plain PyTorch.

Counterpart of ``ccfindr_tpu.ops.sparse``.  The reference densifies X
before every sweep (as.matrix at R/bayesian.R:339); every X-dependent
quantity of a sweep touches only the nonzeros:

* the sw-numerator ``(X/wth) @ lh^T`` and the sh-numerator
  ``lw^T @ (X/wth)`` need ``x / wth`` only where ``x > 0``;
* the ELBO's ``-sum lgamma(x+1)`` and ``sum x log wth`` vanish at 0.

So a sweep costs O(nnz r) instead of O(n m r).  :func:`coo_pass`
gathers the factor rows of a chunk of nonzeros and scatters with
``index_add_``, over the same leading lane axis as the rest of the port
(factors ``lw (B, n, r)``, ``lh (B, r, m)``).  It is the plain version
of the CUDA kernels S1/S2 (:mod:`ccfindr_tpu_torch.ops.kernels.sparse`),
which run the sparse backend over the CSR layout of
:mod:`ccfindr_tpu_torch.ops.tile`.
"""

from __future__ import annotations

import torch

from ..utils import lane_sum
from .kernels.sol import bf16_round

# nonzeros a chunk gathers at once (bounds the (B, chunk, r) temporaries)
CHUNK = 1 << 16


def coo_pass(row, col, val, lw, lht, *, m, want_swn=True, want_shn=True,
             want_a=False, want_xlog=True, do_elbo=None, mxu_bf16=False):
    """One pass over the nonzeros ``(row[p], col[p], val[p])`` for a
    lane batch ``lw (B, n, r)``, ``lht (B, m, r)`` (lh transposed).

    At each nonzero ``wth = lw[row] . lht[col]`` (a non-positive one is
    replaced by 1, as in the JAX package) and ``a = val / wth``.
    Returns ``(swn (B, n, r), shn_t (B, m, r), a (B, nnz), xlog (B,)
    float64)``: ``swn`` sums ``a lht[col]`` into ``row``, ``shn_t``
    sums ``a lw[row]`` into ``col``, ``a`` in the order of the
    nonzeros, ``xlog`` the sum of ``val log wth`` (0 for a lane whose
    ``do_elbo`` is 0).  An output whose ``want_*`` is False is None.
    ``mxu_bf16`` (``precision='bf16'``) rounds the gathered factor rows
    to bf16 before ``wth`` and ``a`` after the division; ``a`` is
    returned rounded, and the sums and ``log(wth)`` stay in the factor
    dtype.
    """
    nb, n, r = lw.shape
    dt, dev = lw.dtype, lw.device
    nnz = val.shape[0]
    swn = torch.zeros_like(lw) if want_swn else None
    shn_t = (torch.zeros(nb, m, r, dtype=dt, device=dev) if want_shn
             else None)
    a_all = torch.empty(nb, nnz, dtype=dt, device=dev) if want_a else None
    xlog = torch.zeros(nb, dtype=torch.float64, device=dev)
    for p0 in range(0, nnz, CHUNK):
        rr = row[p0:p0 + CHUNK].long()
        cc = col[p0:p0 + CHUNK].long()
        vv = val[p0:p0 + CHUNK].to(dt)
        lw_g = lw[:, rr]                          # (B, chunk, r)
        lh_g = lht[:, cc]
        if mxu_bf16:
            lw_g, lh_g = bf16_round(lw_g), bf16_round(lh_g)
            wth = _s1_dot(lw_g, lh_g)
        else:
            wth = (lw_g * lh_g).sum(-1)
        safe = torch.where(wth > 0, wth, 1.0)
        a = vv / safe                             # (B, chunk)
        if mxu_bf16:
            a = bf16_round(a)
        if want_swn:
            swn.index_add_(1, rr, a[..., None] * lh_g)
        if want_shn:
            shn_t.index_add_(1, cc, a[..., None] * lw_g)
        if want_a:
            a_all[:, p0:p0 + CHUNK] = a
        if want_xlog:
            xlog += (vv * torch.log(safe)).sum(-1, dtype=torch.float64)
    if not want_xlog:
        xlog = None
    elif do_elbo is not None:
        xlog = torch.where(do_elbo > 0, xlog, 0.0)
    return swn, shn_t, a_all, xlog


def _s1_dot(u, v):
    """``sum u v`` over the last axis in S1's order (``csrc/sparse.cu``):
    up to r = 32 a thread adds its nonzero's products in component
    order; above, the group walk spreads the components over the 32
    lanes of a warp (four a lane), each lane's products added in turn,
    then a butterfly across the warp.  Under ``mxu_bf16`` every product
    of two rounded operands is exact, so this gives S1's ``wth`` bit for
    bit, and with it S1's rounding of ``a = x/wth`` to bf16 (a ``wth``
    one ulp away could round ``a`` to its neighbour, 2^-8 of it)."""
    r = u.shape[-1]
    p = u * v
    if r <= 32:
        s = p[..., 0]
        for k in range(1, r):
            s = s + p[..., k]
        return s
    g, kp = 32, 4
    p = torch.nn.functional.pad(p, (0, g * kp - r)).unflatten(-1, (kp, g))
    s = p[..., 0, :]
    for j in range(1, kp):
        s = s + p[..., j, :]
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def coo_colpass(row, col, a, lw, m, mxu_bf16=False):
    """``shn_t (B, m, r)``: ``a[:, p] lw[:, row[p]]`` summed into
    ``col[p]`` over the nonzeros (``mxu_bf16``: the rows of ``lw``
    rounded to bf16)."""
    nb, _, r = lw.shape
    if mxu_bf16:
        lw = bf16_round(lw)
    shn_t = torch.zeros(nb, m, r, dtype=lw.dtype, device=lw.device)
    for p0 in range(0, col.shape[0], CHUNK):
        rr = row[p0:p0 + CHUNK].long()
        cc = col[p0:p0 + CHUNK].long()
        shn_t.index_add_(1, cc, a[:, p0:p0 + CHUNK, None] * lw[:, rr])
    return shn_t


def fold_dterm(swn, shn, lw, lh, xlog):
    """The ELBO data term from a fused pass's outputs, in the factor
    dtype and in JAX's argument order: ``-(sum swn lw log lw + sum shn
    lh log lh) + xlog`` a lane, for ``swn``/``lw (B, n, r)``,
    ``shn``/``lh (B, r, m)`` and ``xlog (B,)`` (the fold of
    ``ccfindr_tpu.ops.pallas.vb_kernels.fold_dterm``; the sums are taken
    in float64)."""
    f64 = torch.float64
    return (xlog - lane_sum(swn * (lw * torch.log(lw)), 2, f64)
            - lane_sum(shn * (lh * torch.log(lh)), 2, f64)).to(lw.dtype)
