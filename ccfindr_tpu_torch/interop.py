"""Ecosystem interop: AnnData / h5ad / 10x HDF5 bridges.

Copy of ``ccfindr_tpu.interop`` on the port's :class:`SCSet`.  The
reference container plugs into Bioconductor by EXTENDING
SingleCellExperiment (reference R/scNMF_class.R:66-71); the analog here
is lossless conversion to and from **AnnData** — the scanpy
ecosystem's container — plus readers for the 10x HDF5 matrix format
modern Cell Ranger emits.

Layout mapping (AnnData is cells x genes; SCSet is genes x cells):

===================  =========================================
SCSet                AnnData
===================  =========================================
counts (n x m)       X = counts.T (CSR, m x n)
row_data             var  (gene annotations)
col_data             obs  (cell annotations)
basis[k]  (n x r)    varm['basis_rank{r}']
dbasis[k]            varm['dbasis_rank{r}']
coeff[k]  (r x m)    obsm['coeff_rank{r}']  (stored transposed)
dcoeff[k]            obsm['dcoeff_rank{r}']
ranks / measure      uns['ccfindr'] = {'ranks', 'measure', ...}
metadata             uns['ccfindr']['metadata'] (JSON-safe subset)
===================  =========================================

``anndata`` and ``h5py`` are SOFT dependencies: every function raises
a clear ImportError when the library is absent (this package never
requires them for the core factorization paths).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .container import SCSet


def _require(modname: str):
    try:
        return __import__(modname)
    except ImportError as e:                       # pragma: no cover
        raise ImportError(
            f"{modname} is required for this interop function "
            f"(pip install {modname}); the core ccfindr_tpu_torch "
            "factorization paths do not need it") from e


def to_anndata(obj: SCSet):
    """Convert an :class:`SCSet` (with any factorization results) to
    an ``anndata.AnnData`` — the rebuild's SingleCellExperiment hook
    (reference extends SCE, R/scNMF_class.R:66-71)."""
    import scipy.sparse as sp

    anndata = _require("anndata")

    x = sp.csr_matrix(obj.counts.T)
    var = obj.row_data.copy()
    obs = obj.col_data.copy()
    var.index = var.index.astype(str)
    obs.index = obs.index.astype(str)
    ad = anndata.AnnData(X=x, obs=obs, var=var)
    uns = {"ranks": list(obj.ranks)}
    if obj.measure is not None and len(obj.measure):
        uns["measure"] = obj.measure.copy()
    for k, r in enumerate(obj.ranks):
        ad.varm[f"basis_rank{r}"] = np.asarray(obj.basis[k])
        ad.obsm[f"coeff_rank{r}"] = np.asarray(obj.coeff[k]).T
        if k < len(obj.dbasis) and obj.dbasis[k] is not None:
            ad.varm[f"dbasis_rank{r}"] = np.asarray(obj.dbasis[k])
        if k < len(obj.dcoeff) and obj.dcoeff[k] is not None:
            ad.obsm[f"dcoeff_rank{r}"] = np.asarray(obj.dcoeff[k]).T
    ad.uns["ccfindr"] = uns
    return ad


def from_anndata(ad) -> SCSet:
    """Inverse of :func:`to_anndata`; also accepts plain AnnData
    objects from any scanpy workflow (factors optional)."""
    import scipy.sparse as sp

    x = ad.X
    if not sp.issparse(x):
        x = sp.csr_matrix(np.asarray(x))
    obj = SCSet(count=sp.csr_matrix(x.T),
                row_data=pd.DataFrame(ad.var),
                col_data=pd.DataFrame(ad.obs), remove_zeros=False)
    uns = dict(ad.uns.get("ccfindr", {}))
    ranks = [int(r) for r in uns.get("ranks", [])]
    if ranks:
        obj.ranks = ranks
        obj.basis = [np.asarray(ad.varm[f"basis_rank{r}"])
                     for r in ranks]
        obj.coeff = [np.asarray(ad.obsm[f"coeff_rank{r}"]).T
                     for r in ranks]
        obj.dbasis = [np.asarray(ad.varm[f"dbasis_rank{r}"])
                      if f"dbasis_rank{r}" in ad.varm.keys()
                      else np.zeros_like(obj.basis[i])
                      for i, r in enumerate(ranks)]
        obj.dcoeff = [np.asarray(ad.obsm[f"dcoeff_rank{r}"]).T
                      if f"dcoeff_rank{r}" in ad.obsm.keys()
                      else np.zeros_like(obj.coeff[i])
                      for i, r in enumerate(ranks)]
        if "measure" in uns:
            obj.measure = pd.DataFrame(uns["measure"])
    obj.validate()
    return obj


def write_h5ad(obj: SCSet, path: str) -> None:
    """Persist an SCSet as .h5ad (scanpy-readable)."""
    to_anndata(obj).write_h5ad(path)


def read_h5ad(path: str) -> SCSet:
    """Load an SCSet from .h5ad (any AnnData file works; ccfindr
    factors are restored when present)."""
    anndata = _require("anndata")
    return from_anndata(anndata.read_h5ad(path))


def read_10x_h5(path: str, genome: str | None = None) -> SCSet:
    """Read a 10x Genomics HDF5 feature-barcode matrix
    (CellRanger v2 per-genome groups or the v3 'matrix' group) into
    an :class:`SCSet` — the .h5 sibling of
    :func:`ccfindr_tpu_torch.read_10x`.
    """
    import scipy.sparse as sp

    h5py = _require("h5py")

    with h5py.File(path, "r") as f:
        if "matrix" in f:                          # CellRanger v3
            g = f["matrix"]
            feat = g["features"]
            row_data = pd.DataFrame({
                0: np.asarray(feat["id"]).astype(str),
                1: np.asarray(feat["name"]).astype(str),
            })
            if "feature_type" in feat:
                row_data[2] = np.asarray(
                    feat["feature_type"]).astype(str)
        else:                                      # CellRanger v2
            genomes = list(f.keys())
            if genome is None:
                if len(genomes) != 1:
                    raise ValueError(
                        f"multiple genomes {genomes}; pass genome=")
                genome = genomes[0]
            g = f[genome]
            row_data = pd.DataFrame({
                0: np.asarray(g["genes"]).astype(str),
                1: np.asarray(g["gene_names"]).astype(str),
            })
        data = np.asarray(g["data"])
        indices = np.asarray(g["indices"])
        indptr = np.asarray(g["indptr"])
        shape = tuple(np.asarray(g["shape"]))      # (genes, cells) CSC
        barcodes = np.asarray(g["barcodes"]).astype(str)
        mat = sp.csc_matrix((data, indices, indptr), shape=shape)

    col_data = pd.DataFrame({0: barcodes})
    row_data.index = row_data[0]
    col_data.index = col_data[0]
    return SCSet(count=sp.csr_matrix(mat), row_data=row_data,
                 col_data=col_data, remove_zeros=False)
