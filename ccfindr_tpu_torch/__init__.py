"""ccfindr_tpu_torch — Bayesian NMF for single-cell count data in
PyTorch, with the VB sweep and the ML passes as hand-written CUDA for
NVIDIA Hopper.

The PyTorch counterpart of ``ccfindr_tpu`` (the JAX/Pallas package it
is held against): the same module names and public signatures, plain
functions on tensors with an explicit ``device``, explicit
``torch.Generator``s, and an explicit lane axis where the JAX package
used ``vmap``.  This package never imports JAX.
"""

from .container import SCSet, scNMFSet, remove_zeros  # noqa: F401
from .io import read_10x, read_mtx  # noqa: F401
from .qc import (filter_cells, filter_genes, plot_genes,  # noqa: F401
                 normalize_count, calc_vmr, has_mode)
from .simulate import simulate_data, simulate_whx  # noqa: F401
from .drivers import vb_factorize, factorize  # noqa: F401
from .select import optimal_rank, cluster_id, smooth_spline_df  # noqa: F401
from .interpret import (meta_genes, meta_gene_cv, write_meta,  # noqa: F401
                        gene_map, feature_map, cell_map,
                        visualize_clusters, gene_select)
from .tree import (build_tree, newick, rename_tips,  # noqa: F401
                   plot_tree)
from .gsea import assign_celltype, assignCelltype  # noqa: F401

# reference-compatible dotted-name alias (R: meta_gene.cv)
meta_gene = meta_gene_cv

__version__ = "0.1.0"

__all__ = [
    "SCSet", "scNMFSet", "remove_zeros",
    "read_10x", "read_mtx",
    "filter_cells", "filter_genes", "plot_genes", "normalize_count",
    "calc_vmr", "has_mode",
    "simulate_data", "simulate_whx",
    "vb_factorize", "factorize",
    "optimal_rank", "cluster_id", "smooth_spline_df",
    "meta_genes", "meta_gene_cv", "meta_gene", "write_meta", "gene_map",
    "feature_map", "cell_map", "visualize_clusters", "gene_select",
    "build_tree", "newick", "rename_tips", "plot_tree",
    "assign_celltype", "assignCelltype",
]
