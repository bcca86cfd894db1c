"""10x Genomics I/O: MatrixMarket + gene/barcode TSV triples.

Copy of ``ccfindr_tpu.io`` (reference: R/utils.R:28-54 read_10x,
R/utils.R:867-884 write_10x).  The coordinate body is parsed and
written by the native C++ code of :mod:`ccfindr_tpu_torch.native`
where ``g++`` can build it, else by a NumPy fast path (np.loadtxt on
the coordinate block) rather than scipy.io.mmread's generic parser,
since count matrices are always "coordinate integer/real general".
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import scipy.sparse as sp

from .container import SCSet, remove_zeros


def _open_maybe_gz(path: str, mode: str = "rb"):
    """Binary handle, transparently gunzipping CellRanger v3 .gz
    files."""
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, mode)
    return open(path, mode)


def _read_mtx_header(path: str):
    """Returns (n, m, nnz, field, symmetry, n_header_lines).

    Count matrices are 'coordinate integer/real general', but
    Matrix::readMM (the reference's parser, R/utils.R:34) also accepts
    pattern and symmetric variants — handled here too.  'array'
    format, 'complex' field and 'hermitian' symmetry are rejected by
    name.
    """
    with _open_maybe_gz(path) as f:
        header = f.readline().decode()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path} is not a MatrixMarket file")
        parts = header.lower().split()
        if len(parts) < 5:
            raise ValueError(f"malformed MatrixMarket header: {header!r}")
        fmt, field, symmetry = parts[2], parts[3], parts[4]
        if fmt != "coordinate":
            raise ValueError(
                f"{path}: MatrixMarket format {fmt!r} is not supported "
                "(only 'coordinate'; dense 'array' files are not count "
                "matrices)")
        if field not in ("integer", "real", "pattern"):
            raise ValueError(
                f"{path}: MatrixMarket field {field!r} is not supported "
                "(only integer/real/pattern)")
        if symmetry not in ("general", "symmetric", "skew-symmetric"):
            raise ValueError(
                f"{path}: MatrixMarket symmetry {symmetry!r} is not "
                "supported (only general/symmetric/skew-symmetric)")
        nlines = 1
        line = f.readline().decode()
        nlines += 1
        while line.startswith("%"):
            line = f.readline().decode()
            nlines += 1
        n, m, nnz = (int(t) for t in line.split())
    return n, m, nnz, field, symmetry, nlines


def read_mtx(path: str) -> sp.csr_matrix:
    """Read a MatrixMarket coordinate file into CSR.

    Uses the native C++ parser (ccfindr_tpu_torch/native/mmio.cpp) when
    available — single buffered pass, ~20-50x faster than the
    pure-Python route at atlas scale — with a NumPy fallback.
    """
    import ctypes

    from .native import get_lib

    n, m, nnz, field, symmetry, nlines = _read_mtx_header(path)
    dtype = np.int64 if field in ("integer", "pattern") else np.float64

    lib = get_lib()
    if lib is not None and field != "pattern" \
            and not path.endswith(".gz"):
        rows = np.empty(nnz, np.int32)
        cols = np.empty(nnz, np.int32)
        vals = np.empty(nnz, np.float64)
        nthreads = min(os.cpu_count() or 1, 16)
        rc = lib.mtx_parse_mt(
            path.encode(), nlines, nnz,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nthreads)
        if rc == 0:
            return _assemble_coo(vals.astype(dtype), rows, cols, n, m,
                                 symmetry)
    # pure-Python fallback (and the pattern-field / gzip paths)
    with _open_maybe_gz(path) as f:
        for _ in range(nlines):
            f.readline()
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 3))
    if data.shape[0] != nnz:
        raise ValueError(f"{path}: expected {nnz} entries, "
                         f"got {data.shape[0]}")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(nnz, dtype)
    else:
        vals = data[:, 2].astype(dtype)
    return _assemble_coo(vals, rows, cols, n, m, symmetry)


def _assemble_coo(vals, rows, cols, n, m, symmetry) -> sp.csr_matrix:
    """Expand symmetric storage (lower triangle) to the full matrix."""
    if symmetry in ("symmetric", "skew-symmetric"):
        off = rows != cols
        sgn = -1 if symmetry == "skew-symmetric" else 1
        rows, cols, vals = (np.concatenate([rows, cols[off]]),
                            np.concatenate([cols, rows[off]]),
                            np.concatenate([vals, sgn * vals[off]]))
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()


def write_mtx(path: str, mat, field: str | None = None) -> None:
    """Write a sparse matrix as MatrixMarket coordinate format
    (native C++ body writer when available)."""
    import ctypes

    from .native import get_lib

    coo = sp.coo_matrix(mat)
    if field is None:
        field = ("integer" if np.issubdtype(coo.data.dtype, np.integer)
                 or np.all(coo.data == np.round(coo.data)) else "real")
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")

    lib = get_lib()
    if lib is not None:
        rows = np.ascontiguousarray(coo.row, np.int32)
        cols = np.ascontiguousarray(coo.col, np.int32)
        vals = np.ascontiguousarray(coo.data, np.float64)
        rc = lib.mtx_write_body(
            path.encode(), coo.nnz,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            1 if field == "integer" else 0)
        if rc == 0:
            return
    with open(path, "a") as f:
        if field == "integer":
            for r, c, v in zip(coo.row, coo.col, coo.data):
                f.write(f"{r + 1} {c + 1} {int(v)}\n")
        else:
            for r, c, v in zip(coo.row, coo.col, coo.data):
                f.write(f"{r + 1} {c + 1} {v:.10g}\n")


def read_10x(dir: str, count: str = "matrix.mtx", genes: str = "genes.tsv",
             barcodes: str = "barcodes.tsv",
             remove_zeros_: bool = True, **kw) -> SCSet:
    """Read 10x-format data into an :class:`SCSet`.

    Mirrors reference read_10x (R/utils.R:28-54): count matrix in
    MatrixMarket format plus genes.tsv / barcodes.tsv annotations.
    CellRanger v3 directories (``matrix.mtx.gz`` + ``features.tsv.gz``
    + ``barcodes.tsv.gz``) are auto-detected when the v2 names are
    absent — the format every modern Cell Ranger emits.
    """
    if "remove_zeros" in kw:  # keyword-compatible spelling
        remove_zeros_ = kw.pop("remove_zeros")
    if kw:
        raise TypeError(f"unexpected arguments {sorted(kw)}")
    if not os.path.isdir(dir):
        raise FileNotFoundError(f"Input directory {dir} does not exist")
    count_path = os.path.join(dir, count)
    genes_path = os.path.join(dir, genes)
    barcodes_path = os.path.join(dir, barcodes)
    if not os.path.exists(count_path):
        # CellRanger v3 naming (gzipped, features instead of genes)
        v3 = dict(count="matrix.mtx.gz", genes="features.tsv.gz",
                  barcodes="barcodes.tsv.gz")
        if os.path.exists(os.path.join(dir, v3["count"])):
            count_path = os.path.join(dir, v3["count"])
            if not os.path.exists(genes_path):
                genes_path = os.path.join(dir, v3["genes"])
            if not os.path.exists(barcodes_path):
                barcodes_path = os.path.join(dir, v3["barcodes"])
    for p in (count_path, genes_path, barcodes_path):
        if not os.path.exists(p):
            raise FileNotFoundError(f"File {p} does not exist")

    mat = read_mtx(count_path)
    glist = pd.read_csv(genes_path, sep=r"\s+", header=None, dtype=str)
    clist = pd.read_csv(barcodes_path, sep=r"\s+", header=None, dtype=str)
    glist.index = glist.iloc[:, 0]
    clist.index = clist.iloc[:, 0]

    obj = SCSet(count=mat, row_data=glist, col_data=clist,
                remove_zeros=False)
    if remove_zeros_:
        obj = remove_zeros(obj)
    return obj


def write_10x(obj: SCSet, dir: str, count: str = "matrix.mtx",
              genes: str = "genes.tsv", barcodes: str = "barcodes.tsv",
              version: int = 2):
    """Write SCSet contents in 10x format (reference R/utils.R:867-884).

    ``version=3`` writes the CellRanger v3 layout instead: gzipped
    ``matrix.mtx.gz`` / ``features.tsv.gz`` / ``barcodes.tsv.gz``.
    """
    import gzip
    import shutil

    os.makedirs(dir, exist_ok=True)
    if version == 3:
        count, genes, barcodes = ("matrix.mtx.gz", "features.tsv.gz",
                                  "barcodes.tsv.gz")
    mtx_path = os.path.join(dir, count)
    if mtx_path.endswith(".gz"):
        tmp = mtx_path[:-3]
        write_mtx(tmp, obj.counts)
        with open(tmp, "rb") as fin, gzip.open(mtx_path, "wb") as fout:
            shutil.copyfileobj(fin, fout)
        os.remove(tmp)
    else:
        write_mtx(mtx_path, obj.counts)

    def _tsv(df, name):
        p = os.path.join(dir, name)
        if p.endswith(".gz"):
            with gzip.open(p, "wt") as f:
                df.to_csv(f, sep="\t", header=False, index=False)
        else:
            df.to_csv(p, sep=" ", header=False, index=False)

    _tsv(obj.row_data, genes)
    _tsv(obj.col_data, barcodes)
    return obj
