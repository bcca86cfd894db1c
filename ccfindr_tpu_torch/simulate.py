"""Simulated count-data generators.

Equivalents of the reference's two simulators
(reference: R/utils.R:757-797 simulate_data, R/utils.R:826-846
simulate_whx).  ``simulate_whx`` draws W, H exactly from the VB model's
gamma priors and X ~ Poisson(WH) — a statistical correctness oracle for
the VB path (planted-rank recovery).
"""

from __future__ import annotations

import numpy as np


def simulate_data(nfeatures: int, nsamples, generate_factors: bool = False,
                  nfactor: int = 10, alpha0: float = 0.5,
                  shuffle: bool = True, seed=None):
    """Generate clustered count data (reference R/utils.R:757-797).

    With ``generate_factors=True`` returns dict(w, h, x) with planted
    block factors and X ~ Poisson(WH); otherwise returns a count matrix
    sampled from per-cluster multinomials with Dirichlet(alpha0) gene
    probabilities.
    """
    rng = np.random.default_rng(seed)
    nsamples = np.asarray(nsamples, dtype=np.int64)
    rank = len(nsamples)

    if generate_factors:
        if nfeatures < rank:
            raise ValueError("No. of features too small for rank requested.")
        a = [nfeatures // rank] * (rank - 1)
        a.append(nfeatures - sum(a))
        H_blocks, W_blocks = [], []
        for k in range(rank):
            h = np.zeros((rank, nsamples[k]))
            h[k, :] = 1.0
            H_blocks.append(h)
            if a[k] == 0:
                continue
            w = np.zeros((a[k], rank))
            w[:, k] = rng.multinomial(a[k] * 5, np.full(a[k], 1.0 / a[k]))
            W_blocks.append(w)
        H = np.concatenate(H_blocks, axis=1)
        W = np.concatenate(W_blocks, axis=0)
        x = rng.poisson(W @ H).astype(np.float64)
        if shuffle:
            cel = rng.permutation(x.shape[1])
            x = x[:, cel]
            H = H[:, cel]
            gen = rng.permutation(x.shape[0])
            x = x[gen, :]
            W = W[gen, :]
        return {"w": W, "h": H, "x": x}

    cols = []
    q = rng.dirichlet(np.full(nfeatures, alpha0), size=rank)
    for k in range(rank):
        cols.append(rng.multinomial(nfeatures * nfactor, q[k],
                                    size=nsamples[k]).T)
    x = np.concatenate(cols, axis=1).astype(np.float64)
    if shuffle:
        x = x[:, rng.permutation(x.shape[1])]
    return x


def simulate_whx(nrow: int, ncol: int, rank: int, aw: float = 0.1,
                 bw: float = 1.0, ah: float = 0.1, bh: float = 1.0,
                 seed=None):
    """Sample (W, H, X) from the VB model's gamma priors
    (reference R/utils.R:826-846).

    W_ik ~ Gamma(shape=aw, mean=bw), H_kj ~ Gamma(shape=ah, mean=bh),
    X ~ Poisson(WH); empty rows/columns are dropped.
    """
    rng = np.random.default_rng(seed)
    w = rng.gamma(shape=aw, scale=bw / aw, size=(nrow, rank))
    h = rng.gamma(shape=ah, scale=bh / ah, size=(rank, ncol))
    x = rng.poisson(w @ h).astype(np.float64)
    i = x.sum(axis=1) > 0
    j = x.sum(axis=0) > 0
    return {"w": w[i, :], "h": h[:, j], "x": x[np.ix_(i, j)]}
