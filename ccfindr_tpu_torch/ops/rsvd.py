"""Randomized truncated SVD on the device (the irlba analog at scale).

Counterpart of ``ccfindr_tpu.ops.rsvd``.  The reference starts VB-NMF
from a truncated SVD by irlba on the host (R/bayesian.R:150-159); at
atlas scale a host Lanczos is the bottleneck.  This module runs the
Halko-Martinsson-Tropp randomized range finder on the device: the only
operations that touch X are tall products ``X @ Omega`` and ``X^T @ Q``,
by ``torch.matmul`` for a dense X; for a sparse one, by the port's CSR
column pass S2 (``csrc/sparse.cu``) over X's layout and over X^T's own
layout (built once): a library's sparse product on the card may add
with atomics and change its bits from call to call, S2 adds each sum in
a fixed order.  Then ``torch.linalg.qr`` and a small
``torch.linalg.svd``.  None of these was a Pallas kernel in the JAX
package.

Algorithm (``n_iter`` power iterations, re-orthogonalised each
half-step)::

    Y = X @ Omega;  Q = qr(Y)
    repeat n_iter times:  Q = qr(X^T @ Q);  Q = qr(X @ Q)
    B = Q^T @ X  (k x m);  svd(B) -> (u_b, s, vt);  U = Q @ u_b

Omega is drawn by :func:`_draw_omega` from a ``torch.Generator`` seeded
by ``seed``; the JAX package draws it from ``jax.random``, so the two
starts differ only through Omega (the parity tests hand the port JAX's
draw).
"""

from __future__ import annotations

import torch

from .sparse import SparseCounts
from .tile import TileCounts


def _draw_omega(m, k, dtype, seed, device):
    """The (m, k) standard normal test matrix: drawn in float64 on the
    host from a generator seeded by ``seed``, then cast and moved, so a
    seed gives the same Omega on any device."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(m, k, generator=gen, dtype=torch.float64).to(
        device=device, dtype=dtype)


def _layout(x):
    return x.csr if isinstance(x, SparseCounts) else x


def _transposed(tc: TileCounts) -> TileCounts:
    """X^T's layout from X's: its CSR is X's CSC and its CSC X's CSR
    (the positions permuted by the inverse of X's ``perm``)."""
    perm = tc.perm.long()
    return TileCounts(indptr=tc.colptr, col=tc.row,
                      val=tc.val[perm].contiguous(), colptr=tc.indptr,
                      row=tc.col, perm=torch.argsort(perm).to(torch.int32),
                      n=tc.m, m=tc.n)


def _pair(x, dtype):
    """``((X, its values), (X^T, its values))``, each a layout and its
    values in ``dtype`` in the layout's CSR order as S2 takes them (one
    lane); built once a layout and dtype."""
    tc = _layout(x)
    cache = tc.__dict__.setdefault("_rsvd_pair", {})
    if dtype not in cache:
        tt = _transposed(tc)
        cache[dtype] = ((tc, tc.val.to(dtype)[None].contiguous()),
                        (tt, tt.val.to(dtype)[None].contiguous()))
    return cache[dtype]


def _colpass(tc, vals, dense):
    """``tc^T @ dense`` by the column pass S2 (``ops.kernels.sparse.
    colpass``: a warp a column, each sum in a fixed order, no atomic; its
    plain version on the CPU), at most ``MAX_R`` columns of ``dense`` a
    launch."""
    from .kernels import sparse as spk

    out = [spk.colpass(tc, vals, dense[None, :, j:j + spk.MAX_R]
                       .contiguous())[0].T
           for j in range(0, dense.shape[1], spk.MAX_R)]
    return torch.cat(out, 1) if len(out) > 1 else out[0]


def coo_matmul(sc: SparseCounts, b, chunk: int = 1 << 16):
    """X @ b for sparse X (n x m) and dense b (m, k) — O(nnz k): the
    column pass over X^T's own layout.  ``chunk`` (the JAX scan's) is
    accepted and not used."""
    tt, vals = _pair(sc, b.dtype)[1]
    return _colpass(tt, vals, b)


def coo_rmatmul(sc: SparseCounts, a, chunk: int = 1 << 16):
    """X^T @ a for sparse X (n x m) and dense a (n, k) — O(nnz k): the
    column pass over X's layout."""
    tc, vals = _pair(sc, a.dtype)[0]
    return _colpass(tc, vals, a)


def randomized_svd(x, rank: int, oversample: int = 10, n_iter: int = 4,
                   seed: int = 0, dtype=None):
    """Top-``rank`` SVD triplet (u, s, vt) of X by randomized range
    finding.  X is a dense tensor (or array), a :class:`SparseCounts` or
    a :class:`TileCounts` (CSR products, no densification); the work
    runs on X's device, in ``dtype`` (default: X's floating type, the
    layouts' factor dtype for a sparse X, float32 for its int16
    counts)."""
    if isinstance(x, (SparseCounts, TileCounts)):
        n, m = x.n, x.m
        if dtype is None:
            dtype = (x.val.dtype if x.val.dtype.is_floating_point
                     else torch.float32)
        device = x.device

        def mv(b):
            return coo_matmul(x, b)

        def rmv(a):
            return coo_rmatmul(x, a)
    else:
        x = torch.as_tensor(x)
        if dtype is None:
            dtype = (x.dtype if x.dtype.is_floating_point
                     else torch.float32)
        x = x.to(dtype)
        n, m = x.shape
        device = x.device

        def mv(b):
            return x @ b

        def rmv(a):
            return x.T @ a

    k = min(rank + oversample, min(n, m))
    omega = _draw_omega(m, k, dtype, seed, device)
    q, _ = torch.linalg.qr(mv(omega))
    for _ in range(n_iter):
        z, _ = torch.linalg.qr(rmv(q))
        q, _ = torch.linalg.qr(mv(z))
    b = rmv(q).T                               # (k, m)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :rank], s[:rank], vt[:rank]
