"""Generator for the bundled example dataset of ``ccfindr_tpu_torch``.

The port's twin of ``ccfindr_tpu/data/generate.py`` (NumPy and SciPy
only): the same names, the same draws in the same order, so the arrays
and the files it writes are the JAX package's, byte for byte.

The reference ships a real 10x PBMC subsample (1,030 genes x 450 cells
sampled from 5 purified immune subsets) as its vignette/test fixture.
Redistributing that data is not an option here, so the package bundles
a *synthetic* PBMC-like trio instead: five planted cell types whose
marker genes carry the standard immune symbols (CD3D, CD8A, GNLY,
MS4A1, LYZ, ...), X ~ Poisson(W.H), written in 10x format (matrix.mtx
+ genes.tsv + barcodes.tsv, and the planted labels in labels.tsv).

Deterministic: ``python -m ccfindr_tpu_torch.data.generate`` writes
bit-identical files into ``ccfindr_tpu_torch/data/pbmc_sim``.  On this
dataset the VB rank scan selects ropt = 5 and GSEA assigns all five
cell types (examples/pbmc_workflow_torch.py).
"""

from __future__ import annotations

import os

import numpy as np

# Marker panel per planted cell type (vignette marker sets,
# reference R/gsea.R:33-37 / ccfindR.Rmd:448).
MARKERS = {
    "B": ["CD74", "MS4A1", "CD79A", "CD79B", "CD19",
          "IGHM", "IGHD", "IGKC", "IGLC2",
          "HLA-DRA", "HLA-DRB1", "HLA-DPA1", "HLA-DQB1"],
    "CD8T": ["CD8A", "CD8B", "GZMK", "CCR7", "LTB", "CD2"],
    "CD4T": ["CD3D", "CD3E", "IL7R", "LEF1", "CD27", "TCF7"],
    "NK": ["GNLY", "NKG7", "GZMA", "GZMH", "KLRD1", "PRF1"],
    "Mono": ["S100A8", "S100A9", "CD14", "LYZ", "CFD", "FCN1"],
}

N_BACKGROUND = 700       # housekeeping genes expressed everywhere
CELLS_PER_TYPE = (100, 90, 85, 90, 85)    # 450 cells, like the PBMC set
SEED = 20260819


def build(seed: int = SEED):
    """Returns (x, gene_ids, gene_symbols, barcodes, labels)."""
    rng = np.random.default_rng(seed)
    k = len(MARKERS)
    marker_names = [g for gs in MARKERS.values() for g in gs]
    n_mark = len(marker_names)
    n = N_BACKGROUND + n_mark
    m = int(np.sum(CELLS_PER_TYPE))

    # W: background genes load on all factors (Dirichlet-ish gamma
    # profile, shared shape so clusters differ mainly in markers),
    # marker genes load strongly on their own factor only.
    w = rng.gamma(shape=0.35, scale=1.0, size=(n, k))
    base = rng.gamma(shape=1.5, scale=1.0, size=n)
    w = w + 0.12 * base[:, None]          # correlated background
    row = N_BACKGROUND
    for kk, genes in enumerate(MARKERS.values()):
        for _ in genes:
            w[row, :] *= 0.05             # almost off elsewhere
            w[row, kk] = rng.gamma(6.0, 2.5)   # strong own-type load
            row += 1
    w /= w.sum(axis=0, keepdims=True)     # factor profiles sum to 1

    # H: soft Dirichlet memberships concentrated on the cell's own type
    # (continuous within-cluster variation keeps ranks > 5 from
    # degenerating while the evidence still peaks at the true rank 5),
    # scaled by a lognormal library size so filter_cells has a real
    # distribution to cut.
    labels = np.repeat(np.arange(k), CELLS_PER_TYPE)
    lib = rng.lognormal(mean=np.log(1800.0), sigma=0.35, size=m)
    alpha = np.full((m, k), 0.08)
    alpha[np.arange(m), labels] = 8.0
    mem = np.vstack([rng.dirichlet(a) for a in alpha])   # (m, k)
    h = (mem * lib[:, None]).T

    x = rng.poisson(w @ h).astype(np.int64)

    # shuffle cells/genes so nothing downstream relies on block order
    cp = rng.permutation(m)
    gp = rng.permutation(n)
    x = x[np.ix_(gp, cp)]
    labels = labels[cp]

    symbols = ([f"BG{i + 1:04d}" for i in range(N_BACKGROUND)]
               + marker_names)
    symbols = [symbols[i] for i in gp]
    gene_ids = [f"SIM{i + 1:07d}" for i in range(n)]
    bases = np.array(list("ACGT"))
    barcodes = ["".join(rng.choice(bases, 14)) + "-1" for _ in range(m)]
    return x, gene_ids, symbols, barcodes, labels


def write(outdir: str | None = None, seed: int = SEED) -> str:
    if outdir is None:
        outdir = os.path.join(os.path.dirname(__file__), "pbmc_sim")
    os.makedirs(outdir, exist_ok=True)
    x, gene_ids, symbols, barcodes, labels = build(seed)
    import scipy.sparse as sp

    coo = sp.coo_matrix(x)
    order = np.lexsort((coo.row, coo.col))   # column-major, like 10x
    with open(os.path.join(outdir, "matrix.mtx"), "w") as f:
        f.write("%%MatrixMarket matrix coordinate integer general\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")
        for r, c, v in zip(coo.row[order], coo.col[order],
                           coo.data[order]):
            f.write(f"{r + 1} {c + 1} {v}\n")
    with open(os.path.join(outdir, "genes.tsv"), "w") as f:
        for gid, sym in zip(gene_ids, symbols):
            f.write(f"{gid}\t{sym}\n")
    with open(os.path.join(outdir, "barcodes.tsv"), "w") as f:
        f.write("\n".join(barcodes) + "\n")
    np.savetxt(os.path.join(outdir, "labels.tsv"), labels, fmt="%d")
    return outdir


if __name__ == "__main__":
    print(write())
