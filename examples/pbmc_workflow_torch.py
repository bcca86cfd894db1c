"""End-to-end PBMC workflow on ccfindr_tpu_torch, the PyTorch/CUDA port
(the reference vignette, vignettes/ccfindR.Rmd:122-477; the port's twin
of examples/pbmc_workflow.py).

Reads a 10x trio (by default the bundled synthetic PBMC-like subsample:
1,030 genes x 450 cells drawn from five immune cell types), QC-filters,
runs the VB rank scan on the CUDA kernels (their plain PyTorch versions
with ``--device cpu``), selects the optimal rank (ground truth: 5),
extracts metagenes, builds the cluster tree, and assigns cell types by
marker-gene GSEA.  Prints ``optimal rank: R`` among its results.

Usage:  python examples/pbmc_workflow_torch.py [path/to/10x_dir]
            [--device cuda|cpu] [--nrun 5] [--dtype float32|float64]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import ccfindr_tpu_torch as ct  # noqa: E402

# vignette marker sets (reference R/gsea.R:33-37, ccfindR.Rmd:448), as
# examples/pbmc_workflow.py has them
MARKERS = {
    "B cell": ["CD74", "IG", "HLA"],
    "CD4+ T cell": ["CD3D", "CD3E", "IL7R", "LEF1"],
    "CD8+ T cell": ["CD8A", "CD8B", "GZMK", "CCR7", "LTB"],
    "Monocyte": ["S100A8", "S100A9", "LYZ", "CST3"],
    "NK cell": ["NKG7", "GNLY", "GZMB", "KLRD1"],
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tenx_dir", nargs="?",
                    help="a 10x directory (default: the bundled data)")
    ap.add_argument("--device", default="cuda",
                    help="where the lanes run (default: cuda)")
    ap.add_argument("--nrun", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    help="factor type (default: float32 on the card, "
                         "float64 on the CPU)")
    a = ap.parse_args(argv)

    import torch

    t0 = time.time()
    tenx_dir = a.tenx_dir
    if tenx_dir is None:
        from ccfindr_tpu_torch.data import pbmc_sim_dir
        tenx_dir = pbmc_sim_dir()
    s = ct.read_10x(tenx_dir)
    print(f"loaded {s.n_genes} genes x {s.n_cells} cells "
          f"({s.counts.nnz} nonzeros)")

    # QC (vignette thresholds, ccfindR.Rmd:236-276; the bundled
    # synthetic set has a tighter UMI distribution)
    umi_min, umi_max = ((300, 10000) if "extdata" in tenx_dir
                        else (700, 8000))
    s = ct.filter_cells(s, umi_min=umi_min, umi_max=umi_max, plot=False)
    s = ct.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                        plot=False)
    print(f"after QC: {s.n_genes} x {s.n_cells}")

    # VB rank scan: every (rank, restart) lane in one batch, each sweep
    # the CUDA kernels K1-K4 (csrc/sol.cu)
    dtype = None if a.dtype is None else getattr(torch, a.dtype)
    res = ct.vb_factorize(s, ranks=list(range(2, 9)), nrun=a.nrun,
                          verbose=1, Itmax=3000, seed=a.seed,
                          backend="pallas", device=a.device, dtype=dtype)
    opt = ct.optimal_rank(res)
    print(f"optimal rank: {opt['ropt']} (heterogeneity type "
          f"{opt['type']}; vignette ground truth: 5)")

    rank = opt["ropt"]
    cid = ct.cluster_id(res, rank=rank)
    print("cluster sizes:", np.bincount(np.asarray(cid))[1:])

    gene_names = res.row_data.iloc[:, 1].to_numpy()
    meta = ct.meta_genes(res, rank=rank, max_per_cluster=8,
                         gene_names=gene_names)
    for k, genes in enumerate(meta):
        print(f"  metagenes {k + 1}: {', '.join(map(str, genes[:8]))}")

    tree = ct.build_tree(res, rmax=rank)
    print("cluster hierarchy:", ct.newick(tree))

    es = ct.assign_celltype(res, rank=rank, gset=MARKERS,
                            gene_names=gene_names,
                            grp_prefix=("IG", "HLA"))
    print("\nGSEA enrichment (rows=cell types, cols=clusters):")
    print(es.round(3))
    best = es.idxmax(axis=0)
    for cl, cell_type in best.items():
        print(f"  cluster {cl}: {cell_type}")
    print(f"\ntotal {time.time() - t0:.1f}s")
    return dict(ropt=int(rank), celltypes=dict(best))


if __name__ == "__main__":
    main()
