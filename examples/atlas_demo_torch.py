"""Atlas-scale end-to-end demo on ccfindr_tpu_torch, the PyTorch/CUDA
port: the full ccfindR workflow at 100k cells (the port's twin of
examples/atlas_demo.py).

Simulates a planted 12-type atlas (20,480 genes x 100,352 cells), then
runs the complete pipeline on one NVIDIA GPU --

    QC (filter_cells/filter_genes) -> VB rank scan 2..20 x 2 restarts
    (one lane batch, int8 auto storage, backend='pallas': the CUDA
    kernels K1-K4 of csrc/sol.cu) -> optimal_rank -> cluster tree ->
    metagenes -> planted-type concordance -> subsampled t-SNE

-- printing the wall time of each phase and whether the planted
structure is recovered (ropt ~= 12, cluster assignments concordant with
the planted types).  The last line is one JSON object with the JAX
script's keys (metric, n_cells, ranks, ropt, concordance, phases_s,
total_s) and, beside them, the scan's peak device memory, the driver's
loop and set-up seconds, the sweeps each lane ran, the log evidence of
each rank (what optimal_rank reads), the peak host RSS and the card's
name and power limit.

Usage: python examples/atlas_demo_torch.py [--quick] [--device cuda|cpu]
  --quick shrinks to 2,048 genes x 2,048 cells and ranks 2..8 for a
  smoke run; --device cpu runs the kernels' plain PyTorch versions
  (float64) on the CPU.
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PLANT_RANK = 12


def simulate_atlas(n_genes=20480, n_cells=100352, rank=PLANT_RANK,
                   base_cells=2048, seed=0):
    """Planted-type atlas: per-type gamma gene programs, cells tiled
    from a base block (per-element Poisson sampling is slow on the host;
    tiling keeps generation O(base) with identical per-sweep device
    work).  Counts capped int8-safe so the driver's storage_dtype='auto'
    picks the compressed layout.  The draws of examples/atlas_demo.py's
    simulate_atlas, in the same order: the same matrix, bit for bit."""
    rng = np.random.default_rng(seed)
    tile = max(1, n_cells // base_cells)
    mb = n_cells // tile
    w = rng.gamma(0.35, 1.0, (n_genes, rank)).astype(np.float32)
    # unbalanced type proportions (realistic atlas)
    props = rng.dirichlet(np.full(rank, 1.5))
    types = rng.choice(rank, size=mb, p=props)
    h = np.zeros((rank, mb), np.float32)
    h[types, np.arange(mb)] = rng.gamma(3.0, 1.0, mb)
    h += rng.gamma(0.15, 0.3, (rank, mb))       # cross-type leakage
    # realistic sequencing depth: ~2,500 UMI/cell over 20k genes
    # (~8-10% nonzero, the density of scRNA data)
    scale = 2500.0 * mb / float(w.sum(axis=0) @ h.sum(axis=1))
    x = np.empty((n_genes, mb), np.int8)
    for i0 in range(0, n_genes, 2048):
        mu = (w[i0:i0 + 2048] @ h) * scale
        x[i0:i0 + 2048] = np.minimum(rng.poisson(mu), 127)
    x = np.tile(x, (1, tile))
    types = np.tile(types, tile)
    return x, types


def concordance(types, cid, rank=PLANT_RANK):
    """Permutation-free concordance of 0-based cluster ids ``cid`` with
    the planted ``types``: each planted type is mapped to its majority
    cluster and the partition agreement is scored."""
    remap = {}
    for t in range(rank):
        mask = types == t
        if mask.any():
            remap[t] = np.bincount(cid[mask], minlength=rank).argmax()
    return float(np.mean([remap[t] == c for t, c in zip(types, cid)
                          if t in remap]))


def run(x, types, ranks, nrun, itmax, device, initializer="random"):
    """The workflow after the simulation, on ccfindr_tpu_torch: QC, the
    batched VB rank scan on ``backend='pallas'`` on ``device``,
    optimal_rank, the tree, metagenes, the concordance at the planted
    rank (where scanned) and the t-SNE.  Returns a dict of the results
    (``res``, ``opt``, ``newick``, ``meta``, ``cid`` at the planted
    rank, ``concordance``, ``types`` after QC, ``n_cells``) and the
    per-phase walls (``phases``)."""
    import ccfindr_tpu_torch as ct

    phases = {}
    t0 = time.perf_counter()
    s = ct.SCSet(count=x)
    ncells0 = s.n_cells
    s = ct.filter_cells(s, umi_min=1, plot=False)
    s = ct.filter_genes(s, vmr_min=1.05, min_cells_expressed=50,
                        plot=False, verbose=False)
    if s.n_cells != ncells0:
        # default colnames are original column indices: map the planted
        # types through the surviving cells
        types = types[np.asarray(s.colnames, dtype=np.int64)]
    phases["qc"] = time.perf_counter() - t0
    print(f"QC: {s.n_genes} genes x {s.n_cells} cells kept "
          f"[{phases['qc']:.1f}s]", flush=True)

    t0 = time.perf_counter()
    res = ct.vb_factorize(s, ranks=ranks, nrun=nrun, verbose=1,
                          Itmax=itmax, seed=0, backend="pallas",
                          initializer=initializer, device=device)
    phases["rank_scan"] = time.perf_counter() - t0
    print(f"rank scan {ranks[0]}..{ranks[-1]} x {nrun} restarts "
          f"[{phases['rank_scan']:.1f}s]", flush=True)

    t0 = time.perf_counter()
    opt = ct.optimal_rank(res)
    phases["optimal_rank"] = time.perf_counter() - t0
    print(f"optimal rank: {opt['ropt']} (type {opt['type']}; "
          f"planted {PLANT_RANK})", flush=True)

    t0 = time.perf_counter()
    tree = ct.build_tree(res, rmax=opt["ropt"])
    newick = ct.newick(tree)
    phases["tree"] = time.perf_counter() - t0
    print(f"cluster tree to rank {opt['ropt']}: "
          f"{newick[:70]}... [{phases['tree']:.2f}s]", flush=True)

    t0 = time.perf_counter()
    meta = ct.meta_genes(res, rank=opt["ropt"], max_per_cluster=10)
    phases["metagenes"] = time.perf_counter() - t0

    # planted-type recovery at the planted rank (if scanned)
    concord, cid = None, None
    if PLANT_RANK in res.ranks:
        cid = ct.cluster_id(res, rank=PLANT_RANK).to_numpy() - 1
        concord = concordance(types, cid)
        print(f"cluster concordance with planted types at "
              f"r={PLANT_RANK}: {concord:.3f}", flush=True)

    t0 = time.perf_counter()
    try:
        import matplotlib
        matplotlib.use("Agg")
        ct.visualize_clusters(res, rank=opt["ropt"], max_cells=3000, seed=0)
        phases["tsne_3k"] = time.perf_counter() - t0
    except Exception as e:             # noqa: BLE001
        print("t-SNE skipped:", e)
    return dict(res=res, opt=opt, newick=newick, meta=meta, cid=cid,
                concordance=concord, types=types, n_cells=int(s.n_cells),
                phases=phases)


def card():
    """The card's name and power limit as nvidia-smi reports them, or
    why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="2,048 genes x 2,048 cells, ranks 2..8")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the lanes run (default: cuda)")
    a = ap.parse_args(argv)
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        sys.exit("atlas_demo_torch: no CUDA device (the kernels need one; "
                 "--device cpu runs their plain versions)")

    n_genes = 2048 if a.quick else 20480
    n_cells = 2048 if a.quick else 100352
    ranks = list(range(2, 9 if a.quick else 21))
    nrun, itmax = 2, 300
    gpu = card() if a.device == "cuda" else None
    if gpu is not None:
        print(gpu, flush=True)

    t0 = time.perf_counter()
    x, types = simulate_atlas(n_genes=n_genes, n_cells=n_cells,
                              base_cells=1024 if a.quick else 2048)
    t_sim = time.perf_counter() - t0
    print(f"atlas: {x.shape[0]} genes x {x.shape[1]} cells, "
          f"{PLANT_RANK} planted types [{t_sim:.1f}s]", flush=True)

    if a.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = run(x, types, ranks, nrun, itmax, a.device)
    res, opt, phases = out["res"], out["opt"], out["phases"]
    phases = {"simulate": t_sim, **phases}
    rec = res.metadata["timings"][0]
    loop_s = rec["seconds"]
    extra = {
        "device": a.device,
        "card": gpu,
        "scan_peak_device_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                 if a.device == "cuda" else None),
        "scan_loop_s": loop_s,
        "scan_setup_s": phases["rank_scan"] - loop_s,
        "lane_sweeps_executed": rec["lane_sweeps_executed"],
        "lane_sweeps_per_s": rec["lane_sweeps_executed"] / loop_s,
        "sweeps": rec["n_iter"],
        "lml": dict(zip(map(int, res.measure["rank"]),
                        map(float, res.measure["lml"]))),
        "peak_host_rss_gib": (resource.getrusage(resource.RUSAGE_SELF)
                              .ru_maxrss / 2 ** 20),
        "phases_s_unrounded": phases,
    }
    peak = extra["scan_peak_device_gib"]
    print(f"scan: loop {loop_s:.3f} s ({rec['lane_sweeps_executed']} "
          f"lane-sweeps, {extra['lane_sweeps_per_s']:.2f} lane-sweeps/s), "
          f"set-up and selection {extra['scan_setup_s']:.3f} s, peak device "
          f"memory {'not measured (cpu)' if peak is None else f'{peak:.3f} GiB'}"
          f", peak host RSS {extra['peak_host_rss_gib']:.2f} GiB", flush=True)
    total = sum(phases.values())
    print(json.dumps({"metric": "atlas_workflow",
                      "n_cells": out["n_cells"],
                      "ranks": f"{ranks[0]}..{ranks[-1]}",
                      "ropt": int(opt["ropt"]),
                      "concordance": out["concordance"],
                      "phases_s": {k: round(v, 1)
                                   for k, v in phases.items()},
                      "total_s": round(total, 1), **extra}), flush=True)
    return out


if __name__ == "__main__":
    main()
