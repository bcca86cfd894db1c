"""Single-cell count-matrix container.

TPU-native re-design of the reference's ``scNMFSet`` S4 class
(reference: R/scNMF_class.R:66-96).  Instead of extending
SingleCellExperiment, :class:`SCSet` is a plain Python object holding

* ``counts``       — genes x cells count matrix (scipy CSR, kept sparse)
* ``row_data``     — pandas DataFrame of gene annotations
* ``col_data``     — pandas DataFrame of cell annotations
* ``ranks``        — list of rank values factorized so far
* ``basis``/``dbasis``   — per-rank W (genes x r) posterior mean / sd
* ``coeff``/``dcoeff``   — per-rank H (r x cells) posterior mean / sd
* ``measure``      — pandas DataFrame of per-rank quality measures
                     (the metrics/observability contract consumed by
                     optimal_rank and plot; reference R/bayesian.R:298-299,
                     R/factorize.R:264-269)

Subsetting with ``s[i, j]`` slices counts AND all per-rank factor
matrices coherently (reference R/scNMF_class.R:297-322).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.sparse as sp


def _as_csr(count):
    """Coerce a dense or sparse matrix to CSR with a numeric dtype."""
    if sp.issparse(count):
        mat = count.tocsr()
    else:
        mat = sp.csr_matrix(np.asarray(count))
    return mat


class SCSet:
    """Container for a genes x cells count matrix and factorization results.

    Equivalent of the reference's ``scNMFSet`` constructor
    (R/scNMF_class.R:86-96): rejects negative counts and optionally
    removes empty rows/columns.
    """

    def __init__(self, count=None, row_data=None, col_data=None,
                 remove_zeros: bool = True):
        if count is None:
            raise ValueError("count matrix required")
        mat = _as_csr(count)
        if mat.nnz and mat.data.min() < 0:
            raise ValueError("Count data contains negative values.")

        n, m = mat.shape
        if row_data is None:
            names = getattr(count, "index", None)
            row_data = pd.DataFrame(index=(names if names is not None
                                           else pd.RangeIndex(n)))
        elif not isinstance(row_data, pd.DataFrame):
            row_data = pd.DataFrame({"name": np.asarray(row_data)})
            row_data.index = row_data["name"]
        if col_data is None:
            names = getattr(count, "columns", None)
            col_data = pd.DataFrame(index=(names if names is not None
                                           else pd.RangeIndex(m)))
        elif not isinstance(col_data, pd.DataFrame):
            col_data = pd.DataFrame({"name": np.asarray(col_data)})
            col_data.index = col_data["name"]
        if len(row_data) != n:
            raise ValueError(f"row_data has {len(row_data)} rows, "
                             f"count has {n}")
        if len(col_data) != m:
            raise ValueError(f"col_data has {len(col_data)} rows, "
                             f"count has {m}")

        self._counts = mat
        self.row_data = row_data
        self.col_data = col_data
        self.ranks: list[int] = []
        self.basis: list[np.ndarray] = []
        self.dbasis: list[np.ndarray] = []
        self.coeff: list[np.ndarray] = []
        self.dcoeff: list[np.ndarray] = []
        self.measure: pd.DataFrame = pd.DataFrame()
        self.metadata: dict = {}

        if remove_zeros:
            _remove_zeros_inplace(self)

    # -- accessors (reference R/scNMF_class.R:130-285) ------------------
    @property
    def counts(self) -> sp.csr_matrix:
        return self._counts

    @counts.setter
    def counts(self, value):
        mat = _as_csr(value)
        if mat.shape != self._counts.shape:
            raise ValueError("replacement count matrix must keep shape "
                             f"{self._counts.shape}, got {mat.shape}")
        self._counts = mat

    @property
    def shape(self):
        return self._counts.shape

    @property
    def n_genes(self) -> int:
        return self._counts.shape[0]

    @property
    def n_cells(self) -> int:
        return self._counts.shape[1]

    @property
    def rownames(self):
        return self.row_data.index

    @property
    def colnames(self):
        return self.col_data.index

    def counts_dense(self, dtype=np.float32) -> np.ndarray:
        return np.asarray(self._counts.todense(), dtype=dtype)

    # -- validity (reference R/scNMF_class.R:324-333) -------------------
    def validate(self) -> None:
        if not (len(self.ranks) == len(self.basis) == len(self.coeff)):
            raise ValueError(
                "rank, basis, or coeff data length do not match.")

    def rank_index(self, rank: int) -> int:
        """Index into per-rank lists for a given rank value."""
        for i, r in enumerate(self.ranks):
            if r == rank:
                return i
        raise KeyError(f"rank {rank} not factorized; have {self.ranks}")

    def basis_at(self, rank: int) -> np.ndarray:
        return self.basis[self.rank_index(rank)]

    def coeff_at(self, rank: int) -> np.ndarray:
        return self.coeff[self.rank_index(rank)]

    def dbasis_at(self, rank: int) -> np.ndarray:
        return self.dbasis[self.rank_index(rank)]

    def dcoeff_at(self, rank: int) -> np.ndarray:
        return self.dcoeff[self.rank_index(rank)]

    # -- subsetting (reference R/scNMF_class.R:297-322) -----------------
    def __getitem__(self, key) -> "SCSet":
        if not isinstance(key, tuple) or len(key) != 2:
            raise IndexError("use s[i, j] with row and column selectors")
        i, j = key
        i = _norm_index(i, self.n_genes)
        j = _norm_index(j, self.n_cells)

        out = SCSet.__new__(SCSet)
        out._counts = self._counts[i][:, j]
        out.row_data = self.row_data.iloc[i]
        out.col_data = self.col_data.iloc[j]
        out.ranks = list(self.ranks)
        out.basis = [w[i, :] for w in self.basis]
        out.dbasis = [dw[i, :] for dw in self.dbasis]
        out.coeff = [h[:, j] for h in self.coeff]
        out.dcoeff = [dh[:, j] for dh in self.dcoeff]
        out.measure = self.measure.copy()
        out.metadata = dict(self.metadata)
        return out

    def __repr__(self) -> str:  # reference 'show', R/scNMF_class.R:111-119
        lines = [f"class: {type(self).__name__}",
                 f"dim: {self.n_genes} {self.n_cells}",
                 f"rownames: {list(self.rownames[:6])!r}",
                 f"colnames: {list(self.colnames[:6])!r}"]
        if self.ranks:
            lines.append(f"ranks: {self.ranks}")
        return "\n".join(lines)

    # -- plot (reference R/scNMF_class.R:583-623) -----------------------
    def plot(self, ax=None, show: bool = False):
        """Plot per-rank quality measures.

        Bayesian runs (column 2 named lml/E/evidence) get a single
        log-ML-vs-rank curve; ML runs get the likelihood/dispersion/
        cophenetic triptych.
        """
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        mx = self.measure
        if mx.empty:
            raise ValueError("Quality measure empty.")
        bayes = mx.columns[1] in ("lml", "E", "evidence")
        if bayes:
            if ax is None:
                _, ax = plt.subplots()
            ax.plot(mx["rank"], mx.iloc[:, 1], "o-", mfc="white")
            ax.set_xlabel("Rank")
            ax.set_ylabel("log ML")
            axes = ax
        else:
            _, axes = plt.subplots(1, 3, figsize=(12, 4))
            for a, col, lab in zip(
                    axes, ("likelihood", "dispersion", "cophenetic"),
                    ("Likelihood", "Dispersion", "Cophenetic")):
                a.plot(mx["rank"], mx[col], "o-", mfc="white")
                a.set_xlabel("Rank")
                a.set_ylabel(lab)
        if show:
            plt.show()
        return axes


def _norm_index(idx, size):
    """Normalize a row/col selector to an integer-position array."""
    if isinstance(idx, slice):
        return np.arange(size)[idx]
    idx = np.asarray(idx)
    if idx.dtype == bool:
        if idx.shape[0] != size:
            raise IndexError("boolean index length mismatch")
        return np.nonzero(idx)[0]
    return idx.astype(np.int64)


def _remove_zeros_inplace(obj: SCSet) -> None:
    mat = obj._counts
    gene0 = np.asarray(mat.sum(axis=1)).ravel() == 0
    cell0 = np.asarray(mat.sum(axis=0)).ravel() == 0
    if gene0.any() or cell0.any():
        keep_g = ~gene0
        keep_c = ~cell0
        obj._counts = mat[keep_g][:, keep_c]
        obj.row_data = obj.row_data.iloc[keep_g]
        obj.col_data = obj.col_data.iloc[keep_c]


def remove_zeros(obj):
    """Drop all-zero rows/columns (reference R/scNMF_class.R:636-656).

    Accepts an :class:`SCSet` (returns a new trimmed SCSet, slicing any
    factor matrices coherently) or a raw matrix (returns trimmed matrix).
    """
    if isinstance(obj, SCSet):
        mat = obj.counts
        gene0 = np.asarray(mat.sum(axis=1)).ravel() == 0
        cell0 = np.asarray(mat.sum(axis=0)).ravel() == 0
        if gene0.any() or cell0.any():
            return obj[~gene0, ~cell0]
        return obj
    mat = obj
    dense = not sp.issparse(mat)
    m = sp.csr_matrix(mat) if dense else mat
    gene0 = np.asarray(m.sum(axis=1)).ravel() == 0
    cell0 = np.asarray(m.sum(axis=0)).ravel() == 0
    if gene0.any() or cell0.any():
        m = m[~gene0][:, ~cell0]
        return np.asarray(m.todense()) if dense else m
    return obj


# Compatibility alias mirroring the reference class name.
scNMFSet = SCSet
