"""Consensus-clustering statistics (host-side NumPy/SciPy).

Equivalents of reference connectivity/dispersion/cophenet
(R/factorize.R:51-78).  These are O(m^2) post-processing statistics on
hard cluster assignments, computed on the host after device runs finish.
"""

from __future__ import annotations

import numpy as np
import scipy.cluster.hierarchy as sch


def connectivity(h=None, cid=None) -> np.ndarray:
    """Comembership indicator over cell pairs, condensed (upper-tri
    row-major, matching R's t(cnn)[lower.tri] ordering;
    reference R/factorize.R:51-59)."""
    if cid is None:
        cid = np.asarray(np.argmax(np.asarray(h), axis=0))
    else:
        cid = np.asarray(cid)
    eq = cid[:, None] == cid[None, :]
    iu = np.triu_indices(len(cid), k=1)
    return eq[iu].astype(np.float64)


def dispersion(cnn: np.ndarray, nc: int) -> float:
    """Dispersion rho of a (mean) connectivity vector
    (reference R/factorize.R:62-66)."""
    con = np.sum((cnn - 0.5) ** 2)
    return 1.0 / nc + 8.0 * con / nc ** 2


def cophenet(conav: np.ndarray, nc: int, method: str = "average") -> float:
    """Cophenetic correlation of hierarchical clustering on the
    consensus-distance matrix (reference R/factorize.R:69-78)."""
    d = 1.0 - np.asarray(conav)
    z = sch.linkage(d, method=method)
    coph_corr, _ = sch.cophenet(z, d)
    return float(coph_corr)


class ConsensusAccumulator:
    """Streaming consensus statistics over restarts, EXACT and
    O(runs^2 * (m + r^2)) — never materializes the m(m-1)/2
    connectivity vector the reference accumulates
    (R/factorize.R:214-216), which is 40 GB of doubles at m = 100k.

    Identities (M = sum over runs of the 0/1 comembership matrix):
    sum_ij M_ij   = sum_runs sum_k count_k^2           (cluster sizes)
    sum_ij M_ij^2 = sum_{r,s} ||table(l_r, l_s)||_F^2  (contingency)
    and the dispersion of the mean connectivity needs only those two
    scalars.  ``conav()`` materializes the condensed mean vector (for
    cophenetic correlation) and is gated by the caller at large m.
    """

    def __init__(self, m: int):
        self.m = int(m)
        self.labels: list[np.ndarray] = []
        self._sum_m = 0.0
        self._sum_m2 = 0.0

    def add(self, cid) -> None:
        cid = np.asarray(cid, np.int64)
        csq = float(np.sum(np.bincount(cid).astype(np.float64) ** 2))
        cross = 0.0
        k1 = int(cid.max()) + 1
        for prev in self.labels:
            k0 = int(prev.max()) + 1
            tab = np.bincount(prev * k1 + cid,
                              minlength=k0 * k1).astype(np.float64)
            cross += float(np.sum(tab ** 2))
        self._sum_m2 += 2.0 * cross + csq
        self._sum_m += csq
        self.labels.append(cid)

    @property
    def nrun(self) -> int:
        return len(self.labels)

    def dispersion(self) -> float:
        """Dispersion rho of the across-run mean connectivity — equals
        dispersion(conav/nrun, m) exactly (reference
        R/factorize.R:62-66)."""
        rr = float(self.nrun)
        m = self.m
        total = self._sum_m2 / rr ** 2 - self._sum_m / rr + m * m / 4.0
        con = (total - 0.25 * m) / 2.0      # strict upper-tri pairs
        return 1.0 / m + 8.0 * con / m ** 2

    def conav(self) -> np.ndarray:
        """Condensed mean connectivity (materializes m(m-1)/2 — only
        call when m is modest, e.g. for cophenet)."""
        out = np.zeros(self.m * (self.m - 1) // 2)
        for cid in self.labels:
            out += connectivity(cid=cid)
        return out / self.nrun

    def conav_subset(self, idx) -> np.ndarray:
        """Condensed mean connectivity restricted to the cell subset
        ``idx`` — EXACT on the subsample (a principal submatrix of the
        full consensus), |idx|(|idx|-1)/2 memory."""
        idx = np.asarray(idx)
        out = np.zeros(len(idx) * (len(idx) - 1) // 2)
        for cid in self.labels:
            out += connectivity(cid=cid[idx])
        return out / self.nrun


def cophenet_subsampled(acc: ConsensusAccumulator, max_cells: int,
                        method: str = "average", nsub: int = 3,
                        seed: int = 0) -> tuple[float, float]:
    """Subsampled cophenetic correlation for large cell counts.

    The reference computes the cophenetic on the full m x m consensus
    unconditionally (R/factorize.R:69-78) — 40 GB of condensed doubles
    at m = 100k.  Estimator: draw ``nsub`` random cell subsets of size
    ``max_cells``, compute the EXACT cophenetic of the consensus
    restricted to each subset (a principal submatrix, so each draw is
    the exact statistic of a uniformly subsampled experiment), and
    report (mean, standard error over draws).
    """
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(max(1, int(nsub))):
        idx = np.sort(rng.choice(acc.m, size=int(max_cells),
                                 replace=False))
        vals.append(cophenet(acc.conav_subset(idx), len(idx),
                             method=method))
    vals = np.asarray(vals)
    se = (float(vals.std(ddof=1) / np.sqrt(len(vals)))
          if len(vals) > 1 else float("nan"))
    return float(vals.mean()), se
