#!/usr/bin/env python3
"""Smoke run of ccfindr_tpu_torch on one NVIDIA GPU.

Drives the port's paths through their public entry points, the
batched VB rank scan (``vb_factorize``, on both of its ``'pallas'``
routes and on ``'pallas2pass'``) and the ML rank scan (``factorize``),
on ``backend='pallas'`` and on ``backend='sparse'`` (also in bf16), and
their checkpoint, resume and lane compaction, after checking each CUDA
kernel of those paths against its plain PyTorch version on the card.
Phases (each prints its result and seconds):

1. device and build: requires a CUDA device, prints the card's name
   and power limit (nvidia-smi), builds the kernels with nvcc (one
   process a source, started together);
2. VB kernel vs plain, one sweep: a ragged case (737 x 450 X, 21 lanes
   of ranks 2..8 padded to 8) and the 10x-scale case (4096 x 8192,
   r=16, 3 lanes), X int8 and float32, do_elbo 1 and 0, factors in
   float64 and float32.  Tolerances (elementwise relative, each output
   array): float64 kernel 1e-10 on every output; float32 kernel 2e-4 on
   the factors and the new hypers, and 1e-5 on the per-element ELBO
   (pend + dterm) / (n m).  TF32 is off for the plain side.  Then K1
   alone (fused.cuh's walk) against the plain chunked reference
   (sol.xpass_partials_plain), partial by partial, on X read as a window
   of a wider matrix (its row stride), for every X type, bf16 off and
   on, rp 8 (21 lanes) and rp 128, factors float64 and float32: the
   swn/shn partials at the tolerances above, x*log(wth) per element at
   the ELBO's, rowSums(eh) to 1e-12;
3. the VB slice: read_10x(pbmc_sim_dir()) -> filter_cells ->
   filter_genes -> vb_factorize(ranks 2..8, nrun 3, backend='pallas',
   device='cuda') in float32 -> optimal_rank (must be 5) -> cluster_id
   (5 clusters) -> build_tree/newick (tips 5.1..5.5); every kernel's
   launch count must be > 0 and the four counts equal.  ropt for seeds
   1 and 2 is printed, not gated; with ``precision='bf16'`` ropt must
   be 5 for seed 0 (seeds 1 and 2 printed);
4. VB at 10x scale: vb_factorize on the 4096 x 8192 planted matrix
   (int8), ranks [8, 12, 16], nrun 2, Itmax 300: wall time and
   lane-sweeps per second (CUDA events, synchronised), the same loop on
   the plain version beside it, per-kernel times, and the peak device
   memory; the same scan with ``precision='bf16'`` beside it; K1's
   TFLOP/s of dense work at its chunks (sol.CHUNK) and its ptxas
   registers and spills (float32 factors, int8 X);
5. ML kernel vs plain: M1 ml_hpass (its tail adds each lane's x*log(wh)
   partials, where a separate M3 launch used to) and M2 ml_wpass
   on a ragged case (737 x 450, 12 lanes of ranks 4..6 x 4 padded to
   6, masked rows at eps) and the 10x case (4096 x 8192, 3 lanes of
   r = 16), X int8 and float32, factors float64 and float32.
   Tolerances (elementwise relative): float64 1e-10 on hn, wn and the
   x*log(wh) sum; float32 2e-4 on hn/wn and 1e-5 on the per-element
   likelihood (sum x log wh - sum wh + lgconst) / (n m); M1's tail equal
   to part.sum(-1) to 1e-14 and to the bits of a one-warp sum in M3's
   order.  Two launches must be bit-identical;
6. the ML workflow on the bundled data after phase 3's QC:
   factorize(ranks [4, 5, 6], nrun 4, Itmax 400, Tol 1e-4,
   backend='pallas', device='cuda').  In float64 it must equal the same
   call on backend='dense_fused' (n_iter of every lane, likelihood to
   1e-9, dispersion and cophenetic to 1e-12).  In float32, for seeds 0,
   1 and 2: a finite measure table; rank 5's dispersion >= 0.99 and the
   largest of the three for at least two of the seeds (one restart of
   four stuck in another optimum gives ~0.93, for some seeds of either
   package); seed 0's rank-5 clusters are 5 with concordance >= 0.95
   against the planted labels; M1 and M2 launched.  Then the workflow's
   last steps on phase 3's VB result: meta_genes/meta_gene_cv at rank
   5 and assign_celltype with the PBMC markers: all five types found;
7. ML at 10x scale: factorize on phase 4's planted matrix, ranks
   [8, 12, 16], nrun 2, Itmax 300: wall time, lane-sweeps per second,
   the same loop on the plain version, M1/M2 against plain, peak device
   memory;
8. sparse kernels vs plain: S1 sp_rowpass (with its tail) and S2 sp_colpass on
   the bundled 684 x 447 CSR after QC (21 lanes of ranks 2..8 padded to
   8, the masked components at fudge) and on phase 4's matrix masked to
   10% density as bench.py:62-63 masks it (3 lanes of r = 16), values
   int16 (the counts) and in the factor type (the counts + 0.25),
   factors float64 and float32, do_elbo 1 and 0.  Tolerances as phase 2: float64 1e-10 on every output;
   float32 2e-4 on swn, a and shn and 1e-5 on the per-element data
   term; S1's tail as M1's.  Two launches must be bit-identical;
9. the bundled workflow on backend='sparse': vb_factorize(ranks 2..8,
   nrun 3) in float64 must equal backend='dense_fused' (n_iter of every
   lane, lml to 1e-9); in float32 optimal_rank must be 5 for seed 0
   (seeds 1 and 2 printed); factorize(ranks [4, 5, 6], nrun 4, Itmax
   400, Tol 1e-4) in float64 must equal dense_fused as in phase 6; S1
   and S2 launched by both scans;
10. sparse at scale: the 10%-density matrix of phase 8, ranks [8, 12,
   16], nrun 2, Itmax 300, through vb_factorize and factorize, each on
   sparse and, beside it, on pallas over the same matrix: wall time,
   loop time, lane-sweeps per second, peak device memory, and the loop
   ratio sparse/pallas of each driver; S1/S2 against plain.
   Then the atlas leg: the JAX bench's atlas shape 20480 x 100352
   masked to 2% density (built on the host without the dense matrix),
   vb_factorize(backend='sparse', ranks [16], nrun 2, Itmax 20): its
   lane-sweeps per second and peak device memory beside the dense int8
   image it does not allocate; gated on a finite lml and the launch
   counts;
11. gene-major kernels vs plain: E1's inlined division against x / w bit
   for bit on 768 M samples; E1 fused_xpass in both layouts with
   bf16 off and on (+ E1s fused_sum), E2 epi_w_post and E3 epi_h_post
   (with m_live < m on the ragged case), on a ragged case (737 x 450,
   21 lanes of ranks 2..8 padded to 8) and at full width (phase 12's X,
   3 lanes of r = 16), factors float64 and float32: phase 2's
   tolerances, two launches bit-identical; the whole gene-major sweep
   (E1, E1s, E2, E3, K4) against its plain version on the ragged case;
   then vb_run_epi on the bundled lanes: layout 'cm' in float32 (the
   run E1 'cm' is counted and timed on), and both layouts in float64,
   which must equal vb_run_sol (n_iter of every lane, lml to 1e-9);
12. the gene-major slice: planted 100,000 x 4,096 int8 (0.41 GB), for
   which the driver's layout must be 'gm'; vb_factorize(ranks [8, 12,
   16], nrun 2, Itmax 100, backend='pallas') in float32: wall, loop,
   lane-sweeps per second, peak device memory, E1's partial bytes;
   gated on a finite lml, E1 'gm', E1s, E2, E3 and K4 launched with
   equal counts and K1-K3 not at all; vb_run_sol on the same lanes
   beside it; E1/E1s/E2/E3 against their plain versions (3 lanes);
13. two-pass kernels vs plain, one pass: P1 ss_xpass (+ E1s) and P2
   elbo_xpass (with its tail) on a ragged case (737 x 450, 21 lanes of ranks 2..8
   padded to 8, the masked components at fudge) and on phase 4's 10x
   matrix (3 lanes of r = 16), X in the factor dtype, factors float64
   and float32: float64 1e-10 on sw, sh and the data term; float32 2e-4
   on sw/sh and 1e-5 on the data term; two launches bit-identical, and
   a zero-padded X read in place gives the same bits; P2's tail as M1's;
   P1's time and ptxas registers and spills;
14. the pallas2pass slice: the bundled vb_factorize(ranks 2..8, nrun 3,
   backend='pallas2pass') in float64 must equal backend='dense' (n_iter
   of every lane, lml to 1e-9); in float32 ropt must be 5 for seed 0
   (seeds 1 and 2 printed), with P1, P2 and E1s launched equally often
   and K1-K4, E1-E3 not at all; the 10x scan (ranks [8, 12, 16], nrun 2,
   Itmax 300) beside backend='pallas': wall, loop, lane-sweeps per
   second, device launches a sweep, peak device memory;
15. bf16 on the sparse backend: S1/S2 with mxu_bf16 against their bf16
   plain versions on phase 8's two cases at the float32 tolerances; the
   bundled sparse scan with precision='bf16' (ropt 5 for seed 0, seeds
   1 and 2 printed); S1/S2 in both modes at phase 10's timing inputs;
   the 10x sparse VB scan in bf16 beside float32;
16. checkpoint and compaction: the bundled VB scan on backend='pallas'
   and on backend='sparse', and the bundled factorize(ranks [4, 5, 6],
   nrun 4, Itmax 400, Tol 1e-4, backend='pallas'), each interrupted
   after its second chunk of checkpoint_every=30, resumed, and run with
   compact_every=50: the resumed and the compacted runs must equal the
   uninterrupted one bit for bit (lml or likelihood, dispersion and
   cophenetic, basis, coeff, n_iter); the same for compact_every=50 on
   'pallas2pass' and on 'dense' (printed, not gated); the 10x VB scan
   with compact_every=50 beside the unchunked one (lane-sweeps executed
   and wall, printed);
17. the cell-sharded mesh: the mesh sweep's kernels (K1s per shard, K2
   on the gathered partials, K3s per shard, K4 on the gathered partials)
   against the plain sharded sweep on the bundled 684 x 447 split over
   4 shards (448 cells, the last shard ragged, 21 lanes of ranks 2..8
   padded to 8, int16) and on phase 4's 10x matrix over 4 shards (3
   lanes of r = 16, int8), factors float64 and float32, at phase 2's
   tolerances, two launches bit-identical; one shard, and at 10x two
   and four shards (4096 and 2048 cells, whole K1 cell chunks),
   bit-identical to the single-device K1-K4 sweep; the 10x scan of phase
   4 over make_mesh(cells=2 and 4) on one card, each bit-identical to
   the single-device scan (lml, n_iter), with the cells=4 run the path
   whose launches are counted (K1s and K3s four a sweep, K2 and K4 one,
   K1 and K3 none), wall, loop, lane-sweeps per second and peak memory
   beside the single-device scan, and each mesh loop's rate against one
   device's; a shard's K1s time; the bundled mesh scan (cells=4) with
   ropt 5 in float32 and with precision='bf16', elbo_every=5; 'dense'
   on the cells=4 mesh in float64 equal to 'dense' on one device (n_iter
   of every lane, lml to 1e-9).

Every kernel's entry in the kernels line has its launches on its path,
its error against plain, its time, its plain version's time, its bound
(the larger of bytes over 3.35 TB/s and flops over 67 TFLOP/s, from this
run's inputs) and the time of one PyTorch call computing the same
function where there is one.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``, printed only when
every phase passed.  Run from the root of the repository:
``python3 chip_smoke.py`` (``--phases 1,5`` runs a subset); it prints
its total time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

F64_TOL = 1e-10
F32_FACTOR_TOL = 2e-4
F32_ELBO_TOL = 1e-5
F32_LIK_TOL = 1e-5
KERNELS = ("xpass", "w_post", "h_post", "finish")
SOURCE = "ccfindr_tpu_torch/csrc/sol.cu"
REPLACES = "ccfindr_tpu/ops/pallas/sol.py:185"
ML_KERNELS = {"ml_hpass": "ccfindr_tpu/ops/pallas/ml_kernels.py:39",
              "ml_wpass": "ccfindr_tpu/ops/pallas/ml_kernels.py:64"}
# the kernels whose last block of a lane adds the lane's per-block
# partials (reduce.cuh lane_tail_sum), where M3 ml_xlog_sum was launched
TAILS = {"ml_hpass": "x*log(wh) per lane", "sp_rowpass": "x*log(wth) per lane",
         "elbo_xpass": "the data term per lane"}
TAIL_TOL = 1e-14
# ptxas's report of the X-pass template (fused.cuh): key -> the
# instantiation's mangled prefix (factor type, X type, gm, bf16, xlog,
# W rank-major) (the instantiations the phases time: K1 and E1 'gm' on
# int8 X, 'cm' on the bundled int16 X, P1 on float32 X)
XPASS_ENTRIES = {"xpass": "fused_xpass_kernelIfaLb1ELb0ELb1ELb1E",
                 "fused_xpass_gm": "fused_xpass_kernelIfaLb1ELb0ELb1ELb0E",
                 "fused_xpass_cm": "fused_xpass_kernelIfsLb0ELb0ELb1ELb0E",
                 "ss_xpass": "fused_xpass_kernelIffLb1ELb0ELb0ELb0E"}
ML_SOURCE = "ccfindr_tpu_torch/csrc/ml.cu"
SP_KERNELS = ("sp_rowpass", "sp_colpass")
SP_SOURCE = "ccfindr_tpu_torch/csrc/sparse.cu"
SP_REPLACES = "ccfindr_tpu/ops/tile.py:348"
EPI_KERNELS = {"fused_xpass_gm": "ccfindr_tpu/ops/pallas/vb_kernels.py:326",
               "fused_xpass_cm": "ccfindr_tpu/ops/pallas/vb_kernels.py:280",
               "fused_sum": "ccfindr_tpu/ops/pallas/vb_kernels.py:326",
               "epi_w_post": "ccfindr_tpu/ops/pallas/epilogue.py:71",
               "epi_h_post": "ccfindr_tpu/ops/pallas/epilogue.py:134"}
EPI_SOURCE = "ccfindr_tpu_torch/csrc/epi.cu"
P2_KERNELS = {"ss_xpass": "ccfindr_tpu/ops/pallas/vb_kernels.py:108",
              "elbo_xpass": "ccfindr_tpu/ops/pallas/vb_kernels.py:185"}
P2_SOURCE = "ccfindr_tpu_torch/csrc/pass2.cu"
# the cell-sharded sweep (phase 17): key -> (name, the TPU kernel)
_SSH = "ccfindr_tpu/ops/pallas/sol_sharded.py"
MESH_KERNELS = {"xpass_shard": ("sol_xpass_shard", f"{_SSH}:80"),
                "w_post_mesh": ("sol_w_post_gathered", f"{_SSH}:149"),
                "h_post_shard": ("sol_h_post_shard", f"{_SSH}:149"),
                "finish_mesh": ("sol_finish_gathered", f"{_SSH}:220")}
MESH_CELLS = 4                    # phase 17's shards, all on cuda:0
GM_SHAPE = (100_000, 4_096, 16)  # phase 12's planted X (genes, cells, rank)
# the least time of a kernel (H100 SXM data sheet: float32 outside the
# tensor cores, HBM3)
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# operations an entry of the posterior kernels (K2/K3, E2/E3), counted
# from csrc/post.cuh in float32: the shift chain and series of
# digamma/lgamma, two logs, one exp and the entry's sums
POST_OPS = 90
KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
ATLAS = (20480, 100352, 20, 0.02)   # bench.py:696 shape, bench.py:330 density
MARKERS = {                      # tests/test_integration_workflow.py:81-87
    "B cell": ["CD74", "IG", "HLA", "MS4A1", "CD79A"],
    "CD8+ T": ["CD8A", "CD8B", "GZMK", "CCR7", "LTB"],
    "CD4+ T": ["CD3D", "CD3E", "IL7R", "LEF1"],
    "NK": ["GNLY", "NKG7", "GZMA", "GZMH"],
    "Macrophage": ["S100A8", "S100A9", "CD14", "LYZ", "CFD"],
}


def planted(n, m, r, seed=0):
    """Planted-rank-r Poisson counts at mean 2.0, capped at 127 so that
    int8 storage is exact (the bench's problem, bench.py:35-69)."""
    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.5, 1.0, (n, r)).astype(np.float32)
    hf = rng.gamma(0.5, 1.0, (r, m)).astype(np.float32)
    scale = 2.0 * n * m / float(wf.sum(axis=0) @ hf.sum(axis=1))
    x = np.empty((n, m), np.int8)
    for i0 in range(0, n, 2048):
        mu = (wf[i0:i0 + 2048] @ hf) * scale
        x[i0:i0 + 2048] = np.minimum(rng.poisson(mu), 127)
    return x


def planted_10x():
    """Phase 4's and phase 7's X: planted 4096 x 8192, empty rows and
    columns dropped."""
    x_np = planted(4096, 8192, 16, seed=0)
    keep_r = x_np.sum(axis=1) > 0
    keep_c = x_np.sum(axis=0) > 0
    print(f"  planted X int8 (empty rows/cols dropped: "
          f"{int((~keep_r).sum())}/{int((~keep_c).sum())})")
    return np.ascontiguousarray(x_np[keep_r][:, keep_c])


def planted_gm():
    """Phase 11's and phase 12's X: planted 100,000 x 4,096 rank 16 int8
    (0.41 GB), empty rows and columns dropped; prints its host build
    time."""
    t0 = time.perf_counter()
    x_np = planted(*GM_SHAPE, seed=0)
    keep_r = x_np.sum(axis=1) > 0
    keep_c = x_np.sum(axis=0) > 0
    x_np = np.ascontiguousarray(x_np[keep_r][:, keep_c])
    print(f"  gene-major X {x_np.shape[0]} x {x_np.shape[1]} int8 (empty "
          f"rows/cols dropped: {int((~keep_r).sum())}/"
          f"{int((~keep_c).sum())}), {x_np.nbytes / 1e9:.3f} GB, built on "
          f"the host in {time.perf_counter() - t0:.1f} s", flush=True)
    return x_np


def masked_10x(x10, density=0.10, seed=4):
    """Phase 8's and phase 10's X: the planted 10x matrix masked to
    ``density`` as bench.py:62-63 masks it (a Bernoulli mask), empty
    rows and columns dropped.  Returns (dense int8, CSR) of one
    matrix."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    x = x10 * (rng.random(x10.shape) < density)
    x = x[x.sum(axis=1) > 0]
    x = np.ascontiguousarray(x[:, x.sum(axis=0) > 0])
    return x, sp.csr_matrix(x)


def atlas_csr(n, m, r, density, seed=0, block=1024):
    """Planted rank-r Poisson counts at mean 2.0 (as :func:`planted`),
    masked to ``density``, built without the dense matrix: the masked
    positions are drawn first, as a Bernoulli process by geometric gaps,
    and the Poisson counts only there, which gives the distribution of
    masking a dense draw.  Empty rows and columns are dropped."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.5, 1.0, (n, r)).astype(np.float32)
    hf = rng.gamma(0.5, 1.0, (r, m)).astype(np.float32)
    scale = 2.0 * n * m / float(wf.sum(axis=0) @ hf.sum(axis=1))
    hft = np.ascontiguousarray(hf.T)
    rows, cols, vals = [], [], []
    for i0 in range(0, n, block):
        nrow = min(block, n - i0)
        size = nrow * m
        pos = np.cumsum(rng.geometric(density, int(size * density * 1.1)
                                      + 1024)) - 1
        while pos[-1] < size:
            more = np.cumsum(rng.geometric(density, 1 << 16)) + pos[-1]
            pos = np.concatenate([pos, more])
        pos = pos[pos < size]
        ri, ci = pos // m, pos % m
        mu = np.einsum("ij,ij->i", wf[i0 + ri], hft[ci]) * scale
        v = np.minimum(rng.poisson(mu), 127)
        keep = v > 0
        rows.append((i0 + ri[keep]).astype(np.int32))
        cols.append(ci[keep].astype(np.int32))
        vals.append(v[keep].astype(np.int16))
    csr = sp.csr_matrix((np.concatenate(vals),
                         (np.concatenate(rows), np.concatenate(cols))),
                        shape=(n, m))
    keep_r = np.diff(csr.indptr) > 0
    keep_c = np.bincount(csr.indices, minlength=m) > 0
    if not keep_r.all():
        csr = csr[keep_r]
    if not keep_c.all():
        csr = csr[:, keep_c]
    return csr


def bundled_filtered():
    """The bundled pbmc_sim trio after the workflow's QC."""
    import ccfindr_tpu_torch as ct
    from ccfindr_tpu_torch.data import pbmc_sim_dir

    s = ct.read_10x(pbmc_sim_dir())
    s = ct.filter_cells(s, umi_min=700, umi_max=8000, plot=False)
    return ct.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                           plot=False, verbose=False)


def batch_record(f):
    """The lane batch's timing record of a batched factorize."""
    return next(r for r in f.metadata["timings"]
                if r["name"] == "ml_rank_batch")


def concordance(s, cid):
    """Best one-to-one agreement of rank-5 cluster ids with the planted
    labels of the bundled data."""
    import os

    from scipy.optimize import linear_sum_assignment

    from ccfindr_tpu_torch.data import pbmc_sim_dir

    d = pbmc_sim_dir()
    labels = np.loadtxt(os.path.join(d, "labels.tsv"), dtype=int)
    with open(os.path.join(d, "barcodes.tsv")) as fh:
        all_bc = fh.read().split()
    lab = labels[[all_bc.index(b) for b in s.col_data.index]]
    cm = np.zeros((5, 5))
    for c, lb in zip(np.asarray(cid) - 1, lab):
        cm[c, lb] += 1
    r, c = linear_sum_assignment(-cm)
    return cm[r, c].sum() / len(lab)


def rel_err(got, want):
    """Largest elementwise relative error (denominator floored at the
    dtype's smallest normal, so exact zeros must match exactly)."""
    import torch

    got = got.double()
    want = want.double()
    tiny = torch.finfo(torch.float32).tiny
    return float(((got - want).abs() / want.abs().clamp_min(tiny)).max())


def m3_order_sum(part):
    """Each lane's sum of ``part (B, nblk)`` in the order of a one-warp
    sum (M3's ``warp_strided_sum``): lane l adds the partials l, l + 32,
    ... in turn, then a butterfly over xor 16, 8, 4, 2, 1; lane 0's
    value.  Elementwise float64 adds, so the bits are the warp's."""
    import torch

    nb, nblk = part.shape
    acc = torch.zeros(nb, 32, dtype=torch.float64, device=part.device)
    for i0 in range(0, nblk, 32):
        cnt = min(32, nblk - i0)
        acc[:, :cnt] = acc[:, :cnt] + part[:, i0:i0 + cnt]
    idx = torch.arange(32, device=part.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, idx ^ o]
    return acc[:, 0]


def tail_check(total, part):
    """A producer's tail (each lane's sum of its per-block partials)
    against ``part.sum(-1)`` (relative, ``TAIL_TOL``) and against the
    bits of M3's order: (ok, relative error, bits equal)."""
    ref = part.sum(-1)
    err = float(((total - ref).abs() / ref.abs().clamp_min(1e-300)).max())
    same = bool((total == m3_order_sum(part)).all())
    return err <= TAIL_TOL and same, err, same


def div_rn_check(dev, n=1 << 26, rounds=12):
    """E1's inlined division (csrc/fused.cuh div_rn) against x / w on the
    card, bit for bit: w with random mantissas and exponents from 2^-62
    to 2^61 (div_rn's range [2^-60, 2^60) and past both ends); x in
    turns integer counts below 128, below 32768, and signed floats over
    the same exponents.  Returns (fast-path quotients, of them differing
    from the division, samples)."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import build

    gen = torch.Generator(device=dev).manual_seed(0)

    def floats(lo, hi):
        mant = torch.randint(0, 1 << 23, (n,), device=dev, generator=gen,
                             dtype=torch.int32)
        ex = torch.randint(lo, hi, (n,), device=dev, generator=gen,
                           dtype=torch.int32)
        return ((ex << 23) | mant).view(torch.float32)

    fast = differ = 0
    for it in range(rounds):
        w = floats(127 - 62, 127 + 62)
        if it % 3 == 2:
            x = floats(127 - 62, 127 + 62) * (1 - 2 * torch.randint(
                0, 2, (n,), device=dev, generator=gen)).float()
        else:
            x = torch.randint(0, 128 if it % 3 == 0 else 32768, (n,),
                              device=dev, generator=gen).float()
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        build.check_launch("div_rn_check", build.library().div_rn_check(
            x.data_ptr(), w.data_ptr(), n, out.data_ptr(), build.stream()))
        fast += int((out > 0).sum())
        differ += int((out == 2).sum())
    return fast, differ, n * rounds


def ptxas_resources(key):
    """Registers and spill bytes of one X-pass instantiation, from this
    process's build (``XPASS_ENTRIES``); a dict, or None where the
    library was not built in this process."""
    import re

    from ccfindr_tpu_torch.ops.kernels import build

    text = build.PTXAS_REPORT["text"]
    if not text:
        return None
    prefix = XPASS_ENTRIES[key]
    blocks = text.split("Compiling entry function")
    for blk in blocks[1:]:
        name = blk.split("'")[1] if "'" in blk else ""
        if prefix in name:
            regs = re.search(r"Used (\d+) registers", blk)
            st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", blk)
            smem = re.search(r"(\d+) bytes smem", blk)
            return dict(registers=int(regs.group(1)) if regs else None,
                        spill_stores=int(st.group(1)) if st else None,
                        spill_loads=int(st.group(2)) if st else None,
                        static_smem=int(smem.group(1)) if smem else None)
    return None


def sweep_inputs(x_np, ranks, r, dt, xdt, do_elbo, seed, dev):
    """Lane-batched sweep inputs in the kernel layout: lane b has live
    rank ranks[b] (rows [ranks[b], r) masked as a batched rank scan
    masks them), random gamma factors and hypers."""
    import torch

    from ccfindr_tpu_torch.ops.kernels.sol import round_up

    rng = np.random.default_rng(seed)
    n, m = x_np.shape
    nb = len(ranks)
    rp = round_up(max(r, 8), 8)
    fudge = float(torch.finfo(dt).eps)
    lwt = np.zeros((nb, rp, n))
    lh = np.zeros((nb, rp, m))
    eh = np.zeros((nb, rp, m))
    for b, rk in enumerate(ranks):
        lwt[b, :rk] = rng.gamma(1.0, 1.0, (rk, n))
        lh[b, :rk] = rng.gamma(1.0, 1.0, (rk, m))
        eh[b, :rk] = lh[b, :rk] * rng.uniform(0.8, 1.2, (rk, m))
        lwt[b, rk:r] = fudge
        lh[b, rk:r] = fudge
    lgx = float(torch.lgamma(torch.as_tensor(x_np, dtype=torch.float64)
                             + 1.0).sum())
    sc = np.zeros((nb, 8))
    sc[:, :4] = rng.uniform(0.5, 1.5, (nb, 4))
    sc[:, 4] = fudge
    sc[:, 5] = ranks
    sc[:, 6] = lgx
    sc[:, 7] = do_elbo
    t = lambda a, d=dt: torch.as_tensor(a, dtype=d, device=dev)  # noqa
    return (t(x_np, xdt), t(lwt), t(lh), t(eh), t(sc, torch.float64),
            dict(n=n, m=m, r=r))


def sol_kw(kw, m_live=None):
    """:func:`sweep_inputs`' extents as the cell-major sweeps take them
    (JAX's ``n``, ``m_arr``, ``m_live``, ``r``)."""
    return dict(n=kw["n"], m_arr=kw["m"],
                m_live=kw["m"] if m_live is None else m_live, r=kw["r"])


def compare_sweep(args, dt):
    """Kernel sweep vs plain sweep on the same inputs; returns a dict of
    errors and whether they are within the stated tolerances."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sol

    x, lwt, lh, eh, sc, kw = args
    got = sol.sol_sweep(x, lwt, lh, eh, sc, **sol_kw(kw))
    torch.cuda.synchronize()
    want = sol.sol_sweep_plain(x, lwt, lh, eh, sc, **sol_kw(kw))
    names = ("ewt", "lwtn", "dwt", "eh", "lhn", "dh")
    err = {k: rel_err(g, w) for k, g, w in zip(names, got, want)}
    gs, ws = got[6], want[6]
    nm = kw["n"] * kw["m"]
    err["elbo"] = rel_err((gs[:, sol.PEND] + gs[:, sol.DTERM]) / nm,
                          (ws[:, sol.PEND] + ws[:, sol.DTERM]) / nm)
    for slot, name in ((sol.AW, "aw"), (sol.BW, "bw"), (sol.AH, "ah"),
                       (sol.BH, "bh")):
        err[name] = rel_err(gs[:, slot], ws[:, slot])
    hfail_ok = bool((gs[:, sol.HFAIL] == ws[:, sol.HFAIL]).all())
    if dt == torch.float64:
        for slot, name in ((sol.PEND, "pend"), (sol.DTERM, "dterm"),
                           (sol.XLOG, "xlog")):
            err[name] = rel_err(gs[:, slot], ws[:, slot])
        ok = all(v <= F64_TOL for v in err.values())
    else:
        ok = (all(v <= F32_FACTOR_TOL for k, v in err.items()
                  if k != "elbo") and err["elbo"] <= F32_ELBO_TOL)
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    # K4's outputs as the loop reads them: the per-element ELBO and the
    # new hypers (pend alone is a sum over n*m elements)
    hyp = [sol.AW, sol.BW, sol.AH, sol.BH]
    abs_err = {
        "w_post": max(float((g - w).abs().max())
                      for g, w in zip(got[:3], want[:3])),
        "h_post": max(float((g - w).abs().max())
                      for g, w in zip(got[3:6], want[3:6])),
        "finish": max(float((gs[:, hyp] - ws[:, hyp]).abs().max()),
                      float(((gs[:, sol.PEND] + gs[:, sol.DTERM])
                             - (ws[:, sol.PEND] + ws[:, sol.DTERM])
                             ).abs().max()) / nm),
    }
    # K1 alone: its reduced partials against the plain X pass
    swn_p, shn_p, xlog_p, _ = sol.xpass(x, lwt, lh, eh, sc)
    swnt, shn, xlog, _ = sol.xpass_plain(x, lwt, lh, eh, sc)
    abs_err["xpass"] = max(float((swn_p.sum(1) - swnt).abs().max()),
                           float((shn_p.sum(1) - shn).abs().max()))
    err["xpass_swn"] = rel_err(swn_p.sum(1), swnt)
    err["xpass_shn"] = rel_err(shn_p.sum(1), shn)
    tol = F64_TOL if dt == torch.float64 else F32_FACTOR_TOL
    ok = ok and err["xpass_swn"] <= tol and err["xpass_shn"] <= tol
    return dict(ok=ok and hfail_ok and finite, err=err, abs_err=abs_err,
                hfail_equal=hfail_ok, finite=finite)


def compare_k1(args, dt, bf16):
    """K1 alone against the plain chunked reference
    (``sol.xpass_partials_plain``), partial by partial: the largest
    relative error of the swn/shn partials, the per-element x*log(wth)
    error, and whether they are within phase 2's tolerances."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sol

    x, lwt, lh, eh, sc, kw = args
    got = sol.xpass(x, lwt, lh, eh, sc, mxu_bf16=bf16)
    torch.cuda.synchronize()
    want = sol.xpass_partials_plain(x, lwt, lh, eh, sc, mxu_bf16=bf16)
    part = max(rel_err(g, w) for g, w in zip(got[:2], want[:2]))
    xlog = float((got[2] - want[2]).abs().max()) / (kw["n"] * kw["m"])
    ehs = rel_err(got[3], want[3])
    tol = F64_TOL if dt == torch.float64 else F32_FACTOR_TOL
    etol = F64_TOL if dt == torch.float64 else F32_ELBO_TOL
    ok = (part <= tol and xlog <= etol and ehs <= 1e-12
          and all(g.shape == w.shape for g, w in zip(got, want))
          and all(bool(torch.isfinite(g).all()) for g in got))
    return dict(ok=ok, part=part, xlog=xlog, ehs=ehs)


def epi_inputs(x_np, ranks, r, dt, xdt, seed, dev):
    """:func:`sweep_inputs` with W row-major, lw (B, n, rp): the
    gene-major sweep's layout."""
    x, lwt, lh, eh, sc, kw = sweep_inputs(x_np, ranks, r, dt, xdt, 1.0,
                                          seed, dev)
    return x, lwt.transpose(-1, -2).contiguous(), lh, eh, sc, kw


def fused_plain(x, lw, lh, bf16):
    """The plain X pass one lane at a time (bounds its n x m temporaries
    at full width); the same function as one call."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

    outs = [vbk.fused_xpass_plain(x, lw[b:b + 1], lh[b:b + 1], bf16)
            for b in range(lw.shape[0])]
    return tuple(torch.cat(t) for t in zip(*outs))


def compare_fused(x, lw, lh, layout, bf16, dt):
    """E1 + E1s vs the plain X pass on the same inputs, a second launch
    for bit-identity, and E1s alone against a torch sum of E1's
    partials."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

    got = vbk.fused_pallas_raw(x, lw, lh, layout=layout, mxu_bf16=bf16)
    again = vbk.fused_pallas_raw(x, lw, lh, layout=layout, mxu_bf16=bf16)
    torch.cuda.synchronize()
    want = fused_plain(x, lw, lh, bf16)
    nm = x.shape[0] * x.shape[1]
    err = dict(swn=rel_err(got[0], want[0]), shn=rel_err(got[1], want[1]),
               xlog=rel_err(got[2] / nm, want[2] / nm))
    _, part, xpart = vbk.fused_xpass(x, lw, lh, layout=layout,
                                     mxu_bf16=bf16)
    summed, _ = vbk.fused_sum(part, xpart)
    plain_sum = part.sum(1, dtype=torch.float64).to(dt)
    err["fused_sum"] = rel_err(summed, plain_sum)
    if dt == torch.float64:
        ok = all(v <= F64_TOL for v in err.values())
    else:
        ok = (max(err["swn"], err["shn"], err["fused_sum"]) <= F32_FACTOR_TOL
              and err["xlog"] <= F32_ELBO_TOL)
    det = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    abs_err = {f"fused_xpass_{layout}": max(
                   float((got[0] - want[0]).abs().max()),
                   float((got[1] - want[1]).abs().max())),
               "fused_sum": float((summed - plain_sum).abs().max())}
    return dict(ok=ok and det and finite, err=err, abs_err=abs_err,
                deterministic=det)


def compare_epi_post(x, lw, lh, eh, sc, kw, dt, m_live):
    """E2 + E3 vs their plain version on the plain X pass's outputs,
    and a second launch for bit-identity."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import epilogue as epi

    n, m, r = kw["n"], kw["m"], kw["r"]
    swn, shn, _ = fused_plain(x, lw, lh, False)
    ehs = eh.sum(-1, dtype=torch.float64)

    def launch():
        w = epi.epi_w_post(swn, lw, ehs[:, None], sc, r, n)
        return w, epi.epi_h_post(shn, lh, w[3], sc, r, m_live, m)

    (w, h), (w2, h2) = launch(), launch()
    torch.cuda.synchronize()
    want = epi._post_plain(swn, shn, lw, lh, ehs, sc, r, n, m_live, m)
    got = (w[0], w[1], w[2], w[3].sum(1), h[0], h[1], h[2], h[3].sum(1))
    names = ("ew", "lwn", "dw", "csum", "eh", "lhn", "dh", "rsum")
    err = {k: rel_err(g, v) for k, g, v in
           zip(names, got, want[:4] + want[5:9])}
    tol = F64_TOL if dt == torch.float64 else F32_FACTOR_TOL
    det = all(torch.equal(a, b) for a, b in zip(w + h, w2 + h2))
    abs_err = {"epi_w_post": max(float((g - v).abs().max())
                                 for g, v in zip(got[:3], want[:3])),
               "epi_h_post": max(float((g - v).abs().max())
                                 for g, v in zip(got[4:7], want[5:8]))}
    return dict(ok=all(v <= tol for v in err.values()) and det, err=err,
                abs_err=abs_err, deterministic=det)


def compare_epi_sweep(x, lw, lh, eh, sc, kw, dt):
    """The whole gene-major sweep (E1 'gm', E1s, E2, E3, K4) vs
    epi_sweep_plain, with phase 2's tolerances."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import epilogue as epi
    from ccfindr_tpu_torch.ops.kernels import sol

    got = epi.epi_sweep(x, lw, lh, eh, sc, layout="gm", **kw)
    torch.cuda.synchronize()
    want = epi.epi_sweep_plain(x, lw, lh, eh, sc, **kw)
    err = {k: rel_err(g, w) for k, g, w in
           zip(("ew", "lwn", "dw", "eh", "lhn", "dh"), got, want)}
    gs, ws = got[6], want[6]
    nm = kw["n"] * kw["m"]
    elbo = rel_err((gs[:, sol.PEND] + gs[:, sol.DTERM]) / nm,
                   (ws[:, sol.PEND] + ws[:, sol.DTERM]) / nm)
    hyp = [sol.AW, sol.BW, sol.AH, sol.BH]
    err["hypers"] = rel_err(gs[:, hyp], ws[:, hyp])
    if dt == torch.float64:
        ok = max(err.values()) <= F64_TOL and elbo <= F64_TOL
    else:
        ok = max(err.values()) <= F32_FACTOR_TOL and elbo <= F32_ELBO_TOL
    err["elbo"] = elbo
    ok = ok and bool((gs[:, sol.HFAIL] == ws[:, sol.HFAIL]).all())
    return dict(ok=ok, err=err)


def ml_inputs(x_np, ranks, r, dt, xdt, seed, dev):
    """Lane-batched ML factors (B, n, r)/(B, r, m): lane b has live
    rank ranks[b], its rows [ranks[b], r) pinned at eps as a batched
    rank scan pins them."""
    import torch

    rng = np.random.default_rng(seed)
    n, m = x_np.shape
    nb = len(ranks)
    eps = float(torch.finfo(dt).eps)
    w = rng.uniform(0.05, 1.0, (nb, n, r))
    h = rng.uniform(0.05, 1.0, (nb, r, m))
    for b, rk in enumerate(ranks):
        w[b, :, rk:] = eps
        h[b, rk:] = eps
    t = lambda a, d=dt: torch.as_tensor(a, dtype=d, device=dev)  # noqa
    return t(x_np, xdt), t(w), t(h)


def compare_ml(x, w, h, dt):
    """M1 (with its tail) and M2 vs their plain versions on the same
    inputs, M1's tail against its partials, and a second launch of each
    for bit-identity."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import ml as mlk
    from ccfindr_tpu_torch.ops.ml import likelihood_const

    def launch():
        hn, xlw, part = mlk.ml_hpass(x, w, h)
        return hn, part, xlw, mlk.ml_wpass(x, w, h)

    hn, part, xlw, wn = launch()
    torch.cuda.synchronize()
    hn_p, xlw_p = mlk.ml_h_plain(x, w, h)
    wn_p = mlk.ml_w_plain(x, w, h)
    n, m = x.shape
    rest = likelihood_const(x, torch.float64) - (
        w.double().sum(-2) * h.double().sum(-1)).sum(-1)
    err = dict(hn=rel_err(hn, hn_p), wn=rel_err(wn, wn_p),
               lik=rel_err((xlw + rest) / (n * m), (xlw_p + rest) / (n * m)))
    tail_ok, err["tail"], tail_bits = tail_check(xlw, part)
    if dt == torch.float64:
        err["xlog"] = rel_err(xlw, xlw_p)
        ok = all(v <= F64_TOL for v in err.values())
    else:
        ok = (err["hn"] <= F32_FACTOR_TOL and err["wn"] <= F32_FACTOR_TOL
              and err["lik"] <= F32_LIK_TOL)
    ok = ok and tail_ok
    again = launch()
    det = all(torch.equal(a, b) for a, b in zip((hn, part, xlw, wn), again))
    finite = all(bool(torch.isfinite(t).all()) for t in (hn, xlw, wn))
    abs_err = {"ml_hpass": float((hn - hn_p).abs().max()),
               "ml_wpass": float((wn - wn_p).abs().max())}
    return dict(ok=ok and det and finite, err=err, abs_err=abs_err,
                deterministic=det, finite=finite, tail_bits=tail_bits)


def sparse_inputs(csr, ranks, r, dt, vdt, seed, dev):
    """The layout of ``csr`` and lane-batched factors lw (B, n, r), lh
    (B, r, m): lane b has live rank ranks[b], its components [ranks[b],
    r) at fudge as a batched rank scan pins them.  ``vdt`` int16 keeps
    the integer counts (stored as int16); ``vdt`` == ``dt`` adds 0.25
    to each, so that the layout keeps them in ``dt``."""
    import torch

    from ccfindr_tpu_torch.ops import tile

    rng = np.random.default_rng(seed)
    n, m = csr.shape
    nb = len(ranks)
    fudge = float(torch.finfo(dt).eps)
    lw = rng.gamma(1.0, 1.0, (nb, n, r))
    lh = rng.gamma(1.0, 1.0, (nb, r, m))
    for b, rk in enumerate(ranks):
        lw[b, :, rk:] = fudge
        lh[b, rk:] = fudge
    if vdt != torch.int16:
        csr = csr.copy()
        csr.data = csr.data + 0.25
    tc = tile.from_scipy_tile(csr, dtype=dt, device=dev)
    assert tc.val.dtype == vdt, tc.val.dtype
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return tc, t(lw), t(lh)


def compare_sparse(tc, lw, lh, do_elbo, dt, bf16=False):
    """S1 (with its tail) and S2 vs their plain versions on the same
    inputs (the VB sweep's outputs: swn, a, shn and the per-element data
    term), S1's tail against its partials, and a second launch of each
    for bit-identity; ``bf16`` both in their mxu_bf16 mode."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sparse as spk
    from ccfindr_tpu_torch.ops.sparse import fold_dterm

    nb = lw.shape[0]
    flags = torch.full((nb,), float(do_elbo), device=lw.device)
    lht = lh.transpose(-1, -2).contiguous()

    def launch():
        swn, a, xlog = spk.rowpass(tc, lw, lht, do_elbo=flags,
                                   mxu_bf16=bf16)
        return swn, a, xlog, spk.colpass(tc, a, lw, mxu_bf16=bf16)

    swn, a, xlog, shn = launch()
    torch.cuda.synchronize()
    swn_p, a_p, xlog_p = spk.rowpass_plain(tc, lw, lht, do_elbo=flags,
                                           mxu_bf16=bf16)
    shn_p = spk.colpass_plain(tc, a_p, lw, mxu_bf16=bf16)
    nm = tc.n * tc.m
    d = fold_dterm(swn, shn, xlog, lw, lh) / nm
    d_p = fold_dterm(swn_p, shn_p, xlog_p, lw, lh) / nm
    err = dict(swn=rel_err(swn, swn_p), a=rel_err(a, a_p),
               shn=rel_err(shn, shn_p), dterm=rel_err(d, d_p))
    _, _, s1_xlog, s1_part = spk.sp_rowpass(tc, lw, lht, do_elbo=flags,
                                            mxu_bf16=bf16)
    tail_ok, tail_err, tail_bits = tail_check(s1_xlog, s1_part)
    if dt == torch.float64 and not bf16:
        err["xlog"] = rel_err(xlog, xlog_p)
        ok = all(v <= F64_TOL for v in err.values())
    else:
        ok = (max(err["swn"], err["a"], err["shn"]) <= F32_FACTOR_TOL
              and err["dterm"] <= F32_ELBO_TOL)
    err["tail"] = tail_err
    ok = ok and tail_ok and torch.equal(s1_xlog, xlog)
    again = launch()
    det = all(torch.equal(u, v) for u, v in zip((swn, a, xlog, shn), again))
    finite = all(bool(torch.isfinite(t).all()) for t in (swn, a, shn, d))
    abs_err = {"sp_rowpass": max(float((swn - swn_p).abs().max()),
                                 float((a - a_p).abs().max())),
               "sp_colpass": float((shn - shn_p).abs().max())}
    return dict(ok=ok and det and finite, err=err, abs_err=abs_err,
                deterministic=det, finite=finite)


def nbytes(*ts):
    """Bytes of the tensors (nested tuples and lists allowed)."""
    import torch

    tot = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            tot += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            tot += t.numel() * t.element_size()
    return tot


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def pass2_inputs(x_np, ranks, r, dt, seed, dev):
    """X in the factor dtype and lane-batched factors lw (B, n, r), lh
    (B, r, m): lane b has live rank ranks[b], its components [ranks[b],
    r) at fudge as a batched rank scan pins them."""
    import torch

    rng = np.random.default_rng(seed)
    n, m = x_np.shape
    fudge = float(torch.finfo(dt).eps)
    lw = rng.gamma(1.0, 1.0, (len(ranks), n, r))
    lh = rng.gamma(1.0, 1.0, (len(ranks), r, m))
    for b, rk in enumerate(ranks):
        lw[b, :, rk:] = fudge
        lh[b, rk:] = fudge
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return t(x_np), t(lw), t(lh)


def compare_pass2(x, lw, lh, dt):
    """P1 (+ E1s) and P2 (with its tail) vs their plain versions on the
    same inputs: (sw, sh) = (lw swn, lh shn) and the data term; P2's tail
    against its partials; a second launch bit-identical; X zero-padded
    by pad_matrix and read in place gives the same bits (the chunk
    pinned)."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

    nb, n, r = lw.shape
    m = lh.shape[-1]
    chunk = vbk.pass2_chunk(x, n, m, nb, r, lw.element_size())

    def launch(xx):
        swn, shn = vbk.suffstats_pallas_padded(xx, lw, lh, n=n, m=m, r=r,
                                               chunk=chunk)
        return swn, shn, vbk.elbo_data_pallas_padded(xx, lw, lh, n=n, m=m,
                                                     r=r)

    got, again, padded = launch(x), launch(x), launch(vbk.pad_matrix(x))
    torch.cuda.synchronize()
    swn_p, shn_p = vbk.suffstats_plain(x, lw, lh)
    d_p = vbk.elbo_data_plain(x, lw, lh)
    err = dict(sw=rel_err(lw * got[0], lw * swn_p),
               sh=rel_err(lh * got[1], lh * shn_p),
               dterm=rel_err(got[2], d_p))
    p2_out, p2_part = vbk.elbo_xpass(x, lw, vbk.xlogx(lw), lh, vbk.xlogx(lh))
    tail_ok, tail_err, _ = tail_check(p2_out, p2_part)
    if dt == torch.float64:
        ok = all(v <= F64_TOL for v in err.values())
    else:
        ok = (max(err["sw"], err["sh"]) <= F32_FACTOR_TOL
              and err["dterm"] <= F32_ELBO_TOL)
    err["tail"] = tail_err
    ok = ok and tail_ok and torch.equal(p2_out.to(lw.dtype), got[2])
    det = all(torch.equal(a, b) for a, b in zip(got, again))
    pad_same = all(torch.equal(a, b) for a, b in zip(got, padded))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    abs_err = {"ss_xpass": max(float((got[0] - swn_p).abs().max()),
                               float((got[1] - shn_p).abs().max())),
               "elbo_xpass": float((got[2].double() - d_p).abs().max())
               / (n * m)}
    return dict(ok=ok and det and pad_same and finite, err=err,
                abs_err=abs_err, deterministic=det, padded_same=pad_same)


def mesh_sweep(x, lwt, lh, eh, sc, cells, fn, **kw):
    """A sharded sweep ``fn`` over ``cells`` shards of X's device, the
    H family joined: (X laid out, the sweep's outputs)."""
    from ccfindr_tpu_torch.parallel.sharded import ShardedCounts

    xs = ShardedCounts(x, np.array([[x.device] * cells], dtype=object))
    out = fn(xs, lwt, xs.shard_h(lh), xs.shard_h(eh), sc, **kw)
    return xs, out[:3] + tuple(xs.gather_h(p) for p in out[3:6]) + out[6:]


def compare_mesh_sweep(args, cells, m_live, dt):
    """The mesh sweep's kernels vs its plain version on the same card
    tensors (phase 2's tolerances), two launches bit-identical, and K1s
    against its plain version shard by shard."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sol
    from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh

    x, lwt, lh, eh, sc, kw = args
    kw = sol_kw(kw, m_live)
    xs, got = mesh_sweep(x, lwt, lh, eh, sc, cells,
                         ssh.sharded_sweep_kernels, **kw)
    _, again = mesh_sweep(x, lwt, lh, eh, sc, cells,
                          ssh.sharded_sweep_kernels, **kw)
    torch.cuda.synchronize()
    _, want = mesh_sweep(x, lwt, lh, eh, sc, cells, ssh.sharded_sweep_plain,
                         **kw)
    names = ("ewt", "lwtn", "dwt", "eh", "lhn", "dh")
    err = {k: rel_err(g, w) for k, g, w in zip(names, got, want)}
    gs, ws = got[6], want[6]
    nm = kw["n"] * m_live
    err["elbo"] = rel_err((gs[:, sol.PEND] + gs[:, sol.DTERM]) / nm,
                          (ws[:, sol.PEND] + ws[:, sol.DTERM]) / nm)
    hyp = [sol.AW, sol.BW, sol.AH, sol.BH]
    for slot, name in zip(hyp, ("aw", "bw", "ah", "bh")):
        err[name] = rel_err(gs[:, slot], ws[:, slot])
    abs_err = {
        "w_post_mesh": max(float((g - w).abs().max())
                           for g, w in zip(got[:3], want[:3])),
        "h_post_shard": max(float((g - w).abs().max())
                            for g, w in zip(got[3:6], want[3:6])),
        "finish_mesh": max(float((gs[:, hyp] - ws[:, hyp]).abs().max()),
                           float(((gs[:, sol.PEND] + gs[:, sol.DTERM])
                                  - (ws[:, sol.PEND] + ws[:, sol.DTERM])
                                  ).abs().max()) / nm),
        "xpass_shard": 0.0}
    tol = F64_TOL if dt == torch.float64 else F32_FACTOR_TOL
    k1_ok = True
    for xb, lhs, ehs in zip(xs.blocks[0], xs.shard_h(lh), xs.shard_h(eh)):
        swn_p, shn_p, _, _ = ssh.xpass_shard(xb, lwt, lhs, ehs, sc)
        swnt, shn, _, _ = ssh.xpass_shard_plain(xb, lwt, lhs, ehs, sc)
        abs_err["xpass_shard"] = max(
            abs_err["xpass_shard"], float((swn_p.sum(1) - swnt).abs().max()),
            float((shn_p.sum(1) - shn).abs().max()))
        k1_ok = k1_ok and max(rel_err(swn_p.sum(1), swnt),
                              rel_err(shn_p.sum(1), shn)) <= tol
    if dt == torch.float64:
        for slot, name in ((sol.PEND, "pend"), (sol.DTERM, "dterm"),
                           (sol.XLOG, "xlog")):
            err[name] = rel_err(gs[:, slot], ws[:, slot])
        ok = all(v <= F64_TOL for v in err.values())
    else:
        ok = (all(v <= F32_FACTOR_TOL for k, v in err.items()
                  if k != "elbo") and err["elbo"] <= F32_ELBO_TOL)
    det = all(torch.equal(a, b) for a, b in zip(got, again))
    hf = bool(torch.equal(gs[:, sol.HFAIL], ws[:, sol.HFAIL]))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    return dict(ok=ok and k1_ok and det and hf and finite, err=err,
                abs_err=abs_err, deterministic=det)


def device_launches(fn):
    """Device kernel launches during ``fn()``, counted by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


class Interrupted(Exception):
    """Raised into a chunked driver to stand for a crash."""


def interrupting(module, name, after):
    """Patch ``module.name`` (``_chunked_vb`` or ``_chunked_ml``) so that
    the lane batch's chunk number ``after + 1`` raises
    :class:`Interrupted`, as a crash after ``after`` chunks would stop
    it; returns the original, which the caller puts back."""
    orig = getattr(module, name)
    calls = [0]

    def patched(call, *args, **kwargs):
        def wrapped(*a, **k):
            calls[0] += 1
            if calls[0] > after:
                raise Interrupted
            return call(*a, **k)
        return orig(wrapped, *args, **kwargs)

    setattr(module, name, patched)
    return orig


def same_vb(a, b):
    """Two vb_factorize results equal bit for bit: lml, basis, coeff and
    the batch's n_iter."""
    ok = (np.array_equal(a.measure["lml"], b.measure["lml"])
          and a.metadata["timings"][0]["n_iter"]
          == b.metadata["timings"][0]["n_iter"])
    return ok and all(np.array_equal(u, v) for f in ("basis", "coeff")
                      for u, v in zip(getattr(a, f), getattr(b, f)))


def same_ml(a, b):
    """Two factorize results equal bit for bit: the measure table
    (likelihood, dispersion, cophenetic), basis, coeff, n_iter."""
    ok = (np.array_equal(a.measure.values, b.measure.values)
          and batch_record(a)["n_iter"] == batch_record(b)["n_iter"])
    return ok and all(np.array_equal(u, v) for f in ("basis", "coeff")
                      for u, v in zip(getattr(a, f), getattr(b, f)))


class Smoke:
    def __init__(self, verbose):
        self.verbose = verbose
        self.kernels = {k: dict(name=f"sol_{k}", route="cuda",
                                source=SOURCE, replaces=REPLACES)
                        for k in KERNELS}
        self.kernels.update({k: dict(name=k, route="cuda", source=ML_SOURCE,
                                     replaces=rep)
                             for k, rep in ML_KERNELS.items()})
        self.kernels.update({k: dict(name=k, route="cuda", source=SP_SOURCE,
                                     replaces=SP_REPLACES)
                             for k in SP_KERNELS})
        self.kernels.update({k: dict(name=k, route="cuda", source=EPI_SOURCE,
                                     replaces=rep)
                             for k, rep in EPI_KERNELS.items()})
        self.kernels.update({k: dict(name=k, route="cuda", source=P2_SOURCE,
                                     replaces=rep)
                             for k, rep in P2_KERNELS.items()})
        self.kernels.update({k: dict(name=name, route="cuda", source=SOURCE,
                                     replaces=rep)
                             for k, (name, rep) in MESH_KERNELS.items()})
        for k, what in TAILS.items():
            self.kernels[k]["tail"] = (f"its last block of a lane adds "
                                       f"{what} (M3 folded in)")
        self.failed = []
        self.filtered = None     # the bundled data after QC (phase 3)
        self.vb_result = None    # phase 3's VB scan, for phase 6's GSEA
        self.x10 = None          # the planted 10x matrix (phase 4)
        self.x10m = None         # it masked to 10% density (phase 8)
        self.xgm = None          # phase 12's gene-major X (phase 11)

    def set_bound(self, k, moved, flops, library_ms=None):
        """The kernel's least time on the card, the larger of ``moved``
        bytes over the HBM rate and ``flops`` over the FP32 rate, and
        the time of one PyTorch call computing the same function."""
        tb = moved / HBM_BYTES * 1e3
        tf = flops / FP32_FLOPS * 1e3
        self.kernels[k].update(bound_ms=max(tb, tf),
                               bound_by="bytes" if tb >= tf else "operations",
                               library_ms=library_ms)

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception:
            traceback.print_exc()
            ok = False
        dt = time.perf_counter() - t0
        print(f"[phase {name}] {'PASS' if ok else 'FAIL'} in {dt:.1f} s",
              flush=True)
        if not ok:
            self.failed.append(name)

    # -- 1 ------------------------------------------------------------
    def device_and_build(self):
        import torch

        from ccfindr_tpu_torch.ops.kernels import build

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        self.smi = smi.stdout.strip().splitlines()[0]
        print(self.smi, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}", flush=True)
        t0 = time.perf_counter()
        so = build.build(verbose=self.verbose)
        build.library()
        print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return True

    # -- 2 ------------------------------------------------------------
    def kernel_vs_plain(self):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        cases = [("ragged", planted(737, 450, 5, seed=1),
                  [rk for rk in range(2, 9) for _ in range(3)], 8),
                 ("10x", planted(4096, 8192, 16, seed=2), [16] * 3, 16)]
        ok_all = True
        for cname, x_np, ranks, r in cases:
            for dt in (torch.float64, torch.float32):
                for xdt in (torch.int8, torch.float32):
                    for do_elbo in (1.0, 0.0):
                        args = sweep_inputs(x_np, ranks, r, dt, xdt,
                                            do_elbo, 3, dev)
                        res = compare_sweep(args, dt)
                        worst = max(res["err"].items(), key=lambda kv: kv[1])
                        print(f"  {cname} {str(dt)[6:]} X={str(xdt)[6:]} "
                              f"do_elbo={int(do_elbo)}: "
                              f"{'ok' if res['ok'] else 'MISMATCH'} "
                              f"worst {worst[0]}={worst[1]:.3g} "
                              f"elbo={res['err']['elbo']:.3g} "
                              f"hfail_equal={res['hfail_equal']}",
                              flush=True)
                        if not res["ok"]:
                            print(f"    errors: {res['err']}", flush=True)
                        ok_all = ok_all and res["ok"]
                        if (cname == "10x" and dt == torch.float32
                                and xdt == torch.int8 and do_elbo == 1.0):
                            for k in KERNELS:
                                self.kernels[k]["max_abs_err"] = \
                                    res["abs_err"][k]
                        del args
                torch.cuda.empty_cache()
        # K1 alone against the chunked plain reference: every X type,
        # bf16 off and on, rp 8, 16 and 128, ragged edges and X read as
        # a window of a wider matrix (its row stride)
        x_np = planted(737, 450 + 64, 5, seed=4)
        k1_cases = [("ragged", [rk for rk in range(2, 9) for _ in range(3)],
                     8), ("rp128", [128, 100], 128)]
        for cname, ranks, r in k1_cases:
            for dt in (torch.float64, torch.float32):
                for xdt in (torch.int8, torch.int16, torch.float32,
                            torch.float64):
                    for bf16 in (False, True):
                        x, lwt, lh, eh, sc, kw = sweep_inputs(
                            x_np, ranks, r, dt, xdt, 1.0, 5, dev)
                        lh, eh = (t[..., 32:32 + 450].contiguous()
                                  for t in (lh, eh))
                        win = x[:, 32:32 + 450]
                        res = compare_k1((win, lwt, lh, eh, sc,
                                          dict(kw, m=450)), dt, bf16)
                        print(f"  K1 {cname} {str(dt)[6:]} "
                              f"X={str(xdt)[6:]} (a window, row stride "
                              f"{win.stride(0)}) bf16={int(bf16)}: "
                              f"{'ok' if res['ok'] else 'MISMATCH'} "
                              f"partials {res['part']:.3g} xlog/element "
                              f"{res['xlog']:.3g} ehs {res['ehs']:.3g}",
                              flush=True)
                        ok_all = ok_all and res["ok"]
            torch.cuda.empty_cache()
        print(f"  tolerances: f64 {F64_TOL:g}; f32 factors/hypers "
              f"{F32_FACTOR_TOL:g}, elbo per element {F32_ELBO_TOL:g}")
        return ok_all

    # -- 3 ------------------------------------------------------------
    def slice(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import sol

        s = self.filtered = bundled_filtered()
        print(f"  filtered: {s.n_genes} genes x {s.n_cells} cells")
        kw = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                  backend="pallas", device="cuda", verbose=0)
        sol.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = self.vb_result = ct.vb_factorize(s, seed=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sol.LAUNCHES)
        for k in KERNELS:
            self.kernels[k]["launches"] = launches[k]
        print(f"  vb_factorize seed 0: {wall:.2f} s, launches {launches}")
        print(f.measure.to_string())
        opt = ct.optimal_rank(f)
        cid = ct.cluster_id(f, rank=5)
        nwk = ct.newick(ct.build_tree(f, rmax=5))
        print(f"  ropt={opt['ropt']} clusters={sorted(cid.unique())}")
        print(f"  newick {nwk}")
        ok = (opt["ropt"] == 5 and set(cid.unique()) == {1, 2, 3, 4, 5}
              and all(f"5.{i}" in nwk for i in range(1, 6))
              and bool(np.isfinite(f.measure["lml"]).all())
              and min(launches.values()) > 0
              and len(set(launches.values())) == 1)
        for seed in (1, 2):
            g = ct.vb_factorize(s, seed=seed, **kw)
            print(f"  seed {seed}: ropt={ct.optimal_rank(g)['ropt']} "
                  "(reported, not gated)")
        # precision='bf16': the X pass's operands rounded to bf16 (K1)
        for seed in (0, 1, 2):
            g = ct.vb_factorize(s, seed=seed, precision="bf16", **kw)
            ropt = ct.optimal_rank(g)["ropt"]
            print(f"  bf16 seed {seed}: ropt={ropt}"
                  + (" (gated: 5)" if seed == 0 else " (reported)"))
            if seed == 0:
                ok = ok and ropt == 5 and bool(
                    np.isfinite(g.measure["lml"]).all())
        return ok

    # -- 4 ------------------------------------------------------------
    def scale(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops import vb
        from ccfindr_tpu_torch.ops.kernels import sol

        torch.backends.cuda.matmul.allow_tf32 = False
        x_np = self.x10 = planted_10x()
        n, m = x_np.shape
        print(f"  X {n} x {m}")
        ranks, nrun, itmax = [8, 12, 16], 2, 300
        kw = dict(ranks=ranks, nrun=nrun, Itmax=itmax, backend="pallas",
                  device="cuda", verbose=0, seed=0)
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        f = ct.vb_factorize(x_np, **kw)
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
        rec = f.metadata["timings"][0]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  vb_factorize (kernels): {secs:.3f} s, "
              f"{rec['lane_sweeps_executed']} lane-sweeps -> "
              f"{rec['lane_sweeps_executed'] / secs:.1f} lane-sweeps/s, "
              f"peak device memory {peak:.2f} GiB")
        print(f.measure.to_string())
        torch.cuda.synchronize()
        start.record()
        g = ct.vb_factorize(x_np, precision="bf16", **kw)
        end.record()
        end.synchronize()
        secs16 = start.elapsed_time(end) / 1e3
        rec16 = g.metadata["timings"][0]
        ls16, ls32 = rec16["lane_sweeps_executed"], rec["lane_sweeps_executed"]
        print(f"  vb_factorize precision='bf16': {secs16:.3f} s, {ls16} "
              f"lane-sweeps -> {ls16 / secs16:.1f} lane-sweeps/s of wall "
              f"(float32 above: {ls32 / secs:.1f}); loop records bf16 "
              f"{rec16['seconds']:.3f} s, {ls16 / rec16['seconds']:.1f} "
              f"lane-sweeps/s, float32 {rec['seconds']:.3f} s, "
              f"{ls32 / rec['seconds']:.1f} lane-sweeps/s; lml "
              f"{g.measure['lml'].tolist()}")

        # the batched loop itself, kernels vs plain, on the same start
        dev = torch.device("cuda")
        x = torch.as_tensor(x_np, device=dev)
        gen = torch.Generator().manual_seed(0)
        h1 = vb.Hyper(1.0, 1.0, 1.0, 1.0)
        nb = len(ranks) * nrun
        rank_arr = np.repeat(ranks, nrun)
        states = [vb.vb_init_random(gen, n, m, 16, h1, torch.float32, dev)
                  for _ in range(nb)]
        st = vb.VBState(*(torch.stack(fs) for fs in zip(*states)))
        hy = vb.Hyper(*(torch.ones(nb, device=dev),) * 4)
        rmask = torch.as_tensor(
            (np.arange(16)[None] < rank_arr[:, None]).astype(np.float32),
            device=dev)
        rtrue = torch.as_tensor(rank_arr.astype(np.float32), device=dev)
        runs = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = sol.sol_sweep_plain if which == "plain" else None
            torch.cuda.synchronize()
            start.record()
            out = sol.vb_run_sol(x, st, hy, itmax=itmax, rank_mask=rmask,
                                 r_true=rtrue, sweep_fn=fn)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
            lane_sweeps = nb * (int(out.n_iter.max()) + 1)
            runs.setdefault(which, []).append(lane_sweeps / secs)
            print(f"  vb_run_sol {which}: {secs:.3f} s, "
                  f"{lane_sweeps / secs:.1f} lane-sweeps/s, "
                  f"lml {out.lml.tolist()}", flush=True)
            del out
            torch.cuda.empty_cache()

        # per-kernel times at this batch (6 lanes, rp 16, int8 X)
        lwt = torch.zeros(nb, 16, n, device=dev)
        lwt[:] = st.lw.transpose(-1, -2)
        lh = st.lh.contiguous()
        eh = st.eh.contiguous()
        sc = torch.stack([torch.ones(nb, dtype=torch.float64,
                                     device=dev)] * 4
                         + [torch.full((nb,), 1.2e-7, dtype=torch.float64,
                                       device=dev),
                            rtrue.double(),
                            torch.zeros(nb, dtype=torch.float64,
                                        device=dev),
                            torch.ones(nb, dtype=torch.float64,
                                       device=dev)], dim=1)
        dt = torch.float32
        a = [sc[:, q].to(dt) for q in range(6)]
        k1 = sol.xpass(x, lwt, lh, eh, sc)
        k2 = sol.w_post(k1[0], lwt, k1[3], sc, 16, n)
        k3 = sol.h_post(k1[1], lh, k2[3], sc, 16, m)
        p1 = sol.xpass_plain(x, lwt, lh, eh, sc)
        p2 = sol.post_plain(p1[0], lwt, p1[3], a[0], a[1], a[4], a[5],
                            16, n)
        p3 = sol.post_plain(p1[1], lh, p2[3], a[2], a[3], a[4], a[5],
                            16, m)
        fin = dict(n=n, m=m, dt=dt, hyper_mask=(True,) * 4,
                   newton_niter=100, newton_tol=1e-4)
        timed = {
            "xpass": (lambda: sol.xpass(x, lwt, lh, eh, sc),
                      lambda: sol.xpass_plain(x, lwt, lh, eh, sc)),
            "w_post": (lambda: sol.w_post(k1[0], lwt, k1[3], sc, 16, n),
                       lambda: sol.post_plain(p1[0], lwt, p1[3], a[0],
                                              a[1], a[4], a[5], 16, n)),
            "h_post": (lambda: sol.h_post(k1[1], lh, k2[3], sc, 16, m),
                       lambda: sol.post_plain(p1[1], lh, p2[3], a[2],
                                              a[3], a[4], a[5], 16, m)),
            "finish": (lambda: sol.finish(sc, k1[2], k2[3], k2[4], k3[3],
                                          k3[4], **fin),
                       lambda: sol.finish_plain(
                           sc, p1[2], p2[3], p2[4], p3[3], p3[4], n, m,
                           dt, (True,) * 4, 100, 1e-4)),
        }
        for k, (kern, plain) in timed.items():
            self.kernels[k]["ms"] = cuda_ms(kern, 20)
            self.kernels[k]["plain_ms"] = cuda_ms(plain, 5)
            print(f"  {k}: kernel {self.kernels[k]['ms']:.4f} ms, plain "
                  f"{self.kernels[k]['plain_ms']:.4f} ms", flush=True)
        # bounds at this shape: K1's products are needed at the nonzeros
        # of X only (u = 0 elsewhere), 6 rp flops a nonzero and lane;
        # the bytes are those of the function (the reduced swnt, shn,
        # ehs, csum, ... of the plain version), not the kernels'
        # per-chunk partials
        nnz = int((x != 0).sum())
        fin_out = sol.finish(sc, k1[2], k2[3], k2[4], k3[3], k3[4], **fin)
        self.set_bound("xpass", nbytes(x, lwt, lh, eh, sc, p1),
                       6 * 16 * nnz * nb)
        self.set_bound("w_post", nbytes(p1[0], lwt, p1[3], sc, p2),
                       POST_OPS * nb * 16 * n)
        self.set_bound("h_post", nbytes(p1[1], lh, p2[3], sc, p3),
                       POST_OPS * nb * 16 * m)
        self.set_bound("finish", nbytes(sc, p1[2], p2[3], p2[4], p3[3],
                                        p3[4], fin_out), 0)
        for k in KERNELS:
            print(f"  {k}: bound {self.kernels[k]['bound_ms']:.4f} ms "
                  f"({self.kernels[k]['bound_by']})")
        kk = self.kernels["xpass"]
        dense = 6 * 16 * n * m * nb
        print(f"  K1 at {n} x {m} int8, {nb} lanes of rp 16, chunk "
              f"{sol.CHUNK}: {kk['ms']:.4f} ms, {dense / kk['ms'] / 1e9:.2f}"
              f" TFLOP/s of dense work ({dense / 1e9:.1f} GFLOP), bound "
              f"{kk['bound_ms']:.4f} ms; ptxas {ptxas_resources('xpass')}",
              flush=True)
        print(f"  lane-sweeps/s kernel {runs['kernel']} plain "
              f"{runs['plain']}")
        return True


    # -- 5 ------------------------------------------------------------
    def ml_kernel_vs_plain(self):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        cases = [("ragged", planted(737, 450, 5, seed=1),
                  [rk for rk in range(4, 7) for _ in range(4)], 6),
                 ("10x", planted(4096, 8192, 16, seed=2), [16] * 3, 16)]
        ok_all = True
        for cname, x_np, ranks, r in cases:
            for dt in (torch.float64, torch.float32):
                for xdt in (torch.int8, torch.float32):
                    x, w, h = ml_inputs(x_np, ranks, r, dt, xdt, 5, dev)
                    res = compare_ml(x, w, h, dt)
                    print(f"  {cname} {str(dt)[6:]} X={str(xdt)[6:]}: "
                          f"{'ok' if res['ok'] else 'MISMATCH'} "
                          + " ".join(f"{k}={v:.3g}"
                                     for k, v in res["err"].items())
                          + f" deterministic={res['deterministic']}",
                          flush=True)
                    ok_all = ok_all and res["ok"]
                    if (cname == "10x" and dt == torch.float32
                            and xdt == torch.int8):
                        for k in ML_KERNELS:
                            self.kernels[k]["max_abs_err"] = \
                                res["abs_err"][k]
                    del x, w, h
                torch.cuda.empty_cache()
        print(f"  tolerances: f64 {F64_TOL:g}; f32 hn/wn "
              f"{F32_FACTOR_TOL:g}, likelihood per element {F32_LIK_TOL:g}")
        return ok_all

    # -- 6 ------------------------------------------------------------
    def ml_workflow(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import ml as mlk

        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        kw = dict(ranks=[4, 5, 6], nrun=4, Itmax=400, Tol=1e-4,
                  backend="pallas", device="cuda", verbose=0)

        # float64: the kernels against the matmul phases on the card
        a = ct.factorize(s, seed=0, dtype=torch.float64, **kw)
        b = ct.factorize(s, seed=0, dtype=torch.float64,
                         **dict(kw, backend="dense_fused"))
        nit_a = batch_record(a)["n_iter"]
        nit_b = batch_record(b)["n_iter"]
        lk_a = a.measure["likelihood"].to_numpy()
        lk_b = b.measure["likelihood"].to_numpy()
        lk_err = float(np.max(np.abs(lk_a - lk_b) / np.abs(lk_b)))
        dc_err = float(np.abs(a.measure[["dispersion", "cophenetic"]]
                              .values - b.measure[["dispersion",
                                                   "cophenetic"]].values)
                       .max())
        ok64 = nit_a == nit_b and lk_err <= 1e-9 and dc_err <= 1e-12
        print(f"  float64 pallas vs dense_fused: n_iter equal "
              f"{nit_a == nit_b} ({nit_a}), likelihood rel {lk_err:.3g}, "
              f"dispersion/cophenetic abs {dc_err:.3g}")
        print(a.measure.to_string())

        # float32: the documented call (seed 0) is the ML path's run
        mlk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = ct.factorize(s, seed=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(mlk.LAUNCHES)
        for k in ML_KERNELS:
            self.kernels[k]["launches"] = launches[k]
        print(f"  factorize float32 seed 0: {wall:.2f} s, launches "
              f"{launches}, n_iter {batch_record(f)['n_iter']}")
        disp_ok = 0
        finite = True
        for seed in (0, 1, 2):
            g = f if seed == 0 else ct.factorize(s, seed=seed, **kw)
            me = g.measure.set_index("rank")
            finite = finite and bool(np.isfinite(me.values).all())
            d5 = me["dispersion"][5]
            good = bool(d5 >= 0.99 and d5 == me["dispersion"].max())
            disp_ok += good
            print(f"  seed {seed}: dispersion "
                  f"{me['dispersion'].round(6).tolist()} cophenetic "
                  f"{me['cophenetic'].round(6).tolist()} -> rank 5 "
                  f"{'passes' if good else 'fails'}")
        cid = ct.cluster_id(f, rank=5)
        conc = concordance(f, cid)
        print(f"  seed 0 rank 5: {cid.nunique()} clusters, concordance "
              f"{conc:.4f}")
        ok32 = (finite and disp_ok >= 2 and cid.nunique() == 5
                and conc >= 0.95 and min(launches.values()) > 0)

        # the workflow's last steps on phase 3's VB scan
        vb = self.vb_result
        if vb is None:
            vb = ct.vb_factorize(s, ranks=list(range(2, 9)), nrun=3,
                                 Itmax=3000, backend="pallas",
                                 device="cuda", verbose=0, seed=0)
        genes = vb.row_data.iloc[:, 1].to_numpy()
        mg = ct.meta_genes(vb, rank=5, gene_names=genes)
        cv = ct.meta_gene_cv(vb, rank=5, gene_names=genes)
        es = ct.assign_celltype(vb, rank=5, gset=MARKERS, gene_names=genes,
                                grp_prefix=("IG", "HLA"))
        best = es.idxmax(axis=0)
        gsea_ok = best.nunique() == 5
        print(f"  metagenes: {[list(g[:3]) for g in mg]}; meta_gene_cv "
              f"{cv.shape}")
        print(f"  GSEA best type per cluster: {best.to_dict()}")
        return ok64 and ok32 and gsea_ok

    # -- 7 ------------------------------------------------------------
    def ml_scale(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.drivers.ml_driver import initial_factors
        from ccfindr_tpu_torch.ops import ml as ml_ops
        from ccfindr_tpu_torch.ops.kernels import ml as mlk

        torch.backends.cuda.matmul.allow_tf32 = False
        x_np = self.x10 if self.x10 is not None else planted_10x()
        n, m = x_np.shape
        ranks, nrun, itmax = [8, 12, 16], 2, 300
        kw = dict(ranks=ranks, nrun=nrun, Itmax=itmax, backend="pallas",
                  device="cuda", verbose=0, seed=0)
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        f = ct.factorize(x_np, **kw)
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
        recs = f.metadata["timings"]
        rec = batch_record(f)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  factorize (kernels) {n} x {m}: {secs:.3f} s, "
              f"{rec['lane_sweeps_executed']} lane-sweeps -> "
              f"{rec['lane_sweeps_executed'] / secs:.1f} lane-sweeps/s, "
              f"peak device memory {peak:.2f} GiB")
        print("  driver phases (host clock): " + ", ".join(
            f"{r['name']} {r['seconds']:.3f} s" for r in recs))
        print(f.measure.to_string())

        # the batched loop itself, kernels vs plain, on the same start
        dev = torch.device("cuda")
        x = torch.as_tensor(x_np, device=dev)
        pairs = [(k, i) for k in range(len(ranks)) for i in range(nrun)]
        w0, h0 = initial_factors(0, 0, pairs, len(ranks), nrun, n, m, 16,
                                 torch.float32, dev)
        rank_arr = np.repeat(ranks, nrun)
        rmask = torch.as_tensor(
            (np.arange(16)[None] < rank_arr[:, None]).astype(np.float32),
            device=dev)

        backends = {"kernel": mlk.make_ml_backend(),
                    "plain": (mlk.ml_h_plain, mlk.ml_w_plain)}
        runs = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            fh, fw = backends[which]
            torch.cuda.synchronize()
            start.record()
            out = ml_ops.ml_run(x, w0, h0, itmax=itmax, tol=1e-5,
                                rank_mask=rmask, fused_h=fh, fused_w=fw)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
            lane_sweeps = len(pairs) * (int(out.n_iter.max()) + 1)
            runs.setdefault(which, []).append(lane_sweeps / secs)
            print(f"  ml_run {which}: {secs:.3f} s, "
                  f"{lane_sweeps / secs:.1f} lane-sweeps/s, n_iter "
                  f"{out.n_iter.tolist()}", flush=True)
            del out
            torch.cuda.empty_cache()

        # per-kernel times at this batch (6 lanes, r 16, int8 X)
        timed = {
            "ml_hpass": (lambda: mlk.ml_hpass(x, w0, h0),
                         lambda: mlk.ml_h_plain(x, w0, h0)),
            "ml_wpass": (lambda: mlk.ml_wpass(x, w0, h0),
                         lambda: mlk.ml_w_plain(x, w0, h0)),
        }
        for k, (kern, plain) in timed.items():
            self.kernels[k]["ms"] = cuda_ms(kern, 20)
            self.kernels[k]["plain_ms"] = cuda_ms(plain, 5)
            print(f"  {k}: kernel {self.kernels[k]['ms']:.4f} ms, plain "
                  f"{self.kernels[k]['plain_ms']:.4f} ms", flush=True)
        # bounds: wh and the product are needed at the nonzeros of X
        # only (x / wh = 0 elsewhere), 2 r flops each a nonzero and lane
        nnz = int((x != 0).sum())
        nb = len(pairs)
        self.set_bound("ml_hpass",
                       nbytes(x, w0, h0, mlk.ml_hpass(x, w0, h0)[:2]),
                       4 * 16 * nnz * nb)
        self.set_bound("ml_wpass", nbytes(x, w0, h0, mlk.ml_wpass(x, w0, h0)),
                       4 * 16 * nnz * nb)
        for k in ML_KERNELS:
            print(f"  {k}: bound {self.kernels[k]['bound_ms']:.4f} ms "
                  f"({self.kernels[k]['bound_by']}), library "
                  f"{self.kernels[k]['library_ms']}")
        print(f"  lane-sweeps/s kernel {runs['kernel']} plain "
              f"{runs['plain']}")
        return bool(np.isfinite(f.measure.drop(columns="rank").values).all())


    # -- 8 ------------------------------------------------------------
    def sparse_kernel_vs_plain(self):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        if self.x10 is None:
            self.x10 = planted_10x()
        self.x10m = masked_10x(self.x10)
        print(f"  10x masked: {self.x10m[1].shape}, nnz "
              f"{self.x10m[1].nnz}")
        cases = [("ragged", s.counts,
                  [rk for rk in range(2, 9) for _ in range(3)], 8),
                 ("10x", self.x10m[1], [16] * 3, 16)]
        ok_all = True
        for cname, csr, ranks, r in cases:
            for dt in (torch.float64, torch.float32):
                for vdt in (torch.int16, dt):
                    tc, lw, lh = sparse_inputs(csr, ranks, r, dt, vdt, 7,
                                               dev)
                    for do_elbo in (1, 0):
                        res = compare_sparse(tc, lw, lh, do_elbo, dt)
                        print(f"  {cname} {str(dt)[6:]} val="
                              f"{str(vdt)[6:]} do_elbo={do_elbo}: "
                              f"{'ok' if res['ok'] else 'MISMATCH'} "
                              + " ".join(f"{k}={v:.3g}"
                                         for k, v in res["err"].items())
                              + f" deterministic={res['deterministic']}",
                              flush=True)
                        ok_all = ok_all and res["ok"]
                        if (cname == "10x" and dt == torch.float32
                                and vdt == torch.int16 and do_elbo == 1):
                            for k in SP_KERNELS:
                                self.kernels[k]["max_abs_err"] = \
                                    res["abs_err"][k]
                    del tc, lw, lh
                torch.cuda.empty_cache()
        print(f"  tolerances: f64 {F64_TOL:g}; f32 swn/a/shn "
              f"{F32_FACTOR_TOL:g}, data term per element {F32_ELBO_TOL:g}")
        return ok_all

    # -- 9 ------------------------------------------------------------
    def sparse_workflow(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import sparse as spk

        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        kw = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                  backend="sparse", device="cuda", verbose=0)

        def launches():
            return dict(spk.LAUNCHES)

        def reset():
            spk.reset_launches()
            torch.cuda.synchronize()

        # float64: the kernels against the matmul sweep on the card
        a = ct.vb_factorize(s, seed=0, dtype=torch.float64, **kw)
        b = ct.vb_factorize(s, seed=0, dtype=torch.float64,
                            **dict(kw, backend="dense_fused"))
        nit_a = a.metadata["timings"][0]["n_iter"]
        nit_b = b.metadata["timings"][0]["n_iter"]
        lml_err = float(np.max(np.abs(a.measure["lml"] - b.measure["lml"])
                               / np.abs(b.measure["lml"])))
        ok64 = nit_a == nit_b and lml_err <= 1e-9
        print(f"  VB float64 sparse vs dense_fused: n_iter equal "
              f"{nit_a == nit_b} ({nit_a}), lml rel {lml_err:.3g}")

        # float32: the documented call (seed 0) is the sparse VB path
        reset()
        t0 = time.perf_counter()
        f = ct.vb_factorize(s, seed=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        vb_counts = launches()
        for k in SP_KERNELS:
            self.kernels[k]["launches"] = vb_counts[k]
        opt = ct.optimal_rank(f)
        cid = ct.cluster_id(f, rank=5)
        print(f"  vb_factorize sparse float32 seed 0: {wall:.2f} s, "
              f"launches {vb_counts}")
        print(f.measure.to_string())
        print(f"  ropt={opt['ropt']} clusters={sorted(cid.unique())}")
        ok32 = (opt["ropt"] == 5 and set(cid.unique()) == {1, 2, 3, 4, 5}
                and bool(np.isfinite(f.measure["lml"]).all())
                and min(vb_counts.values()) > 0)
        for seed in (1, 2):
            g = ct.vb_factorize(s, seed=seed, **kw)
            print(f"  seed {seed}: ropt={ct.optimal_rank(g)['ropt']} "
                  "(reported, not gated)")

        # the ML scan: float64 sparse against dense_fused
        kwm = dict(ranks=[4, 5, 6], nrun=4, Itmax=400, Tol=1e-4,
                   device="cuda", verbose=0, seed=0, dtype=torch.float64)
        reset()
        am = ct.factorize(s, backend="sparse", **kwm)
        torch.cuda.synchronize()
        ml_counts = launches()
        bm = ct.factorize(s, backend="dense_fused", **kwm)
        nit_am, nit_bm = batch_record(am)["n_iter"], batch_record(bm)["n_iter"]
        lk_a = am.measure["likelihood"].to_numpy()
        lk_b = bm.measure["likelihood"].to_numpy()
        lk_err = float(np.max(np.abs(lk_a - lk_b) / np.abs(lk_b)))
        cols = ["dispersion", "cophenetic"]
        dc_err = float(np.abs(am.measure[cols].values
                              - bm.measure[cols].values).max())
        okml = (nit_am == nit_bm and lk_err <= 1e-9 and dc_err <= 1e-12
                and min(ml_counts.values()) > 0)
        print(f"  factorize float64 sparse vs dense_fused: n_iter equal "
              f"{nit_am == nit_bm} ({nit_am}), likelihood rel {lk_err:.3g}, "
              f"dispersion/cophenetic abs {dc_err:.3g}, launches "
              f"{ml_counts}")
        print(am.measure.to_string())
        return ok64 and ok32 and okml

    # -- 10 -----------------------------------------------------------
    def sparse_scale(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops import tile
        from ccfindr_tpu_torch.ops.kernels import sparse as spk

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        if self.x10m is None:
            self.x10m = masked_10x(self.x10 if self.x10 is not None
                                   else planted_10x())
        dense, csr = self.x10m
        n, m = csr.shape
        print(f"  X {n} x {m}, nnz {csr.nnz} "
              f"({csr.nnz / (n * m):.4f} of the entries)")
        kw = dict(ranks=[8, 12, 16], nrun=2, Itmax=300, device="cuda",
                  verbose=0, seed=0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def timed(fn, *args, **kwargs):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            return (out, start.elapsed_time(end) / 1e3,
                    torch.cuda.max_memory_allocated() / 2 ** 30)

        ok = True
        loop_rate = {}
        for name, fn, xin, backend, rec_name in (
                ("vb_factorize", ct.vb_factorize, csr, "sparse",
                 "vb_rank_batch"),
                ("vb_factorize", ct.vb_factorize, dense, "pallas",
                 "vb_rank_batch"),
                ("factorize", ct.factorize, csr, "sparse", "ml_rank_batch"),
                ("factorize", ct.factorize, dense, "pallas",
                 "ml_rank_batch")):
            f, secs, peak = timed(fn, xin, backend=backend, **kw)
            rec = next(r for r in f.metadata["timings"]
                       if r["name"] == rec_name)
            ls = rec["lane_sweeps_executed"]
            loop_rate[name, backend] = ls / rec["seconds"]
            print(f"  {name} {backend}: {secs:.3f} s, {ls} lane-sweeps -> "
                  f"{ls / secs:.1f} lane-sweeps/s, loop record "
                  f"{rec['seconds']:.3f} s ({loop_rate[name, backend]:.1f} "
                  f"lane-sweeps/s), peak device memory {peak:.3f} GiB",
                  flush=True)
            ok = ok and bool(np.isfinite(
                f.measure.drop(columns="rank").values).all())
        for name in ("vb_factorize", "factorize"):
            print(f"  {name} loop on this matrix: sparse/pallas = "
                  f"{loop_rate[name, 'sparse'] / loop_rate[name, 'pallas']:.3f}"
                  " (lane-sweeps/s of the loop records)", flush=True)

        # per-kernel times at this shape (6 lanes, r 16, float32, int16
        # values), the VB sweep's row pass with every output
        tc, lw, lh = sparse_inputs(csr, [8, 8, 12, 12, 16, 16], 16,
                                   torch.float32, torch.int16, 9, dev)
        lht = lh.transpose(-1, -2).contiguous()
        _, a, _, part = spk.sp_rowpass(tc, lw, lht)
        timed_k = {
            "sp_rowpass": (lambda: spk.sp_rowpass(tc, lw, lht),
                           lambda: spk.rowpass_plain(tc, lw, lht)),
            "sp_colpass": (lambda: spk.sp_colpass(tc, a, lw),
                           lambda: spk.colpass_plain(tc, a, lw)),
        }
        for k, (kern, plain) in timed_k.items():
            self.kernels[k]["ms"] = cuda_ms(kern, 20)
            self.kernels[k]["plain_ms"] = cuda_ms(plain, 5)
            print(f"  {k}: kernel {self.kernels[k]['ms']:.4f} ms, plain "
                  f"{self.kernels[k]['plain_ms']:.4f} ms", flush=True)
        # bounds: S1 forms wth and swn at each nonzero (4 r flops a
        # nonzero and lane), S2 shn (2 r); S2's function is one SpMM
        # for all lanes, shn^T = blockdiag_b(A_b^T) lw with A_b the
        # pattern of X holding lane b's a: torch.sparse.mm times it
        nbl, nnz = a.shape
        s1 = spk.sp_rowpass(tc, lw, lht)[:3]
        s2 = spk.sp_colpass(tc, a, lw)
        self.set_bound("sp_rowpass", nbytes(tc.indptr, tc.col, tc.val, lw,
                                            lht, s1), 4 * 16 * nnz * nbl)
        rows = tc.csr_rows()
        off = torch.arange(nbl, device=dev)[:, None]
        blk = torch.sparse_coo_tensor(
            torch.stack([(tc.col.long()[None] + off * m).reshape(-1),
                         (rows[None] + off * n).reshape(-1)]),
            a.reshape(-1), (nbl * m, nbl * n)).coalesce().to_sparse_csr()
        lw_flat = lw.reshape(nbl * n, 16)
        lib = torch.sparse.mm(blk, lw_flat).view(nbl, m, 16)
        lib_err = float((lib.transpose(-1, -2) - s2).abs().max())
        self.set_bound("sp_colpass", nbytes(tc.colptr, tc.row, tc.perm, a,
                                            lw, s2), 2 * 16 * nnz * nbl,
                       library_ms=cuda_ms(
                           lambda: torch.sparse.mm(blk, lw_flat), 20))
        for k in SP_KERNELS:
            print(f"  {k}: bound {self.kernels[k]['bound_ms']:.4f} ms "
                  f"({self.kernels[k]['bound_by']}), library "
                  f"{self.kernels[k]['library_ms']}")
        print(f"  torch.sparse.mm (one call, {nbl} lanes block-diagonal) "
              f"agrees with S2 to {lib_err:.3g} absolute")
        del tc, lw, lh, lht, a, part, s1, s2, blk, lib
        torch.cuda.empty_cache()

        # the atlas leg: capacity, not speed
        an, am_, ar, dens = ATLAS
        t0 = time.perf_counter()
        big = atlas_csr(an, am_, ar, dens)
        print(f"  atlas X {big.shape[0]} x {big.shape[1]} (from {an} x "
              f"{am_}, planted rank {ar}, mask {dens}), nnz {big.nnz}, "
              f"built on the host in {time.perf_counter() - t0:.1f} s; "
              f"its dense int8 image would be {an * am_ / 1e9:.2f} GB")
        spk.reset_launches()
        f, secs, peak = timed(ct.vb_factorize, big, ranks=[16], nrun=2,
                              Itmax=20, backend="sparse", device="cuda",
                              verbose=0, seed=0)
        rec = f.metadata["timings"][0]
        counts = dict(spk.LAUNCHES)
        ls = rec["total_sweeps"]
        print(f"  atlas vb_factorize sparse (ranks [16], nrun 2, Itmax 20): "
              f"{secs:.3f} s, loop record {rec['seconds']:.3f} s for {ls} "
              f"lane-sweeps -> {ls / rec['seconds']:.2f} lane-sweeps/s, "
              f"peak device memory {peak:.3f} GiB, launches {counts}, "
              f"lml {f.measure['lml'].tolist()}", flush=True)
        return (ok and bool(np.isfinite(f.measure["lml"]).all())
                and min(counts.values()) > 0)

    # -- 11 -----------------------------------------------------------
    def epi_kernel_vs_plain(self):
        import torch

        from ccfindr_tpu_torch.ops import vb
        from ccfindr_tpu_torch.ops.kernels import epilogue as epi
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        fast, differ, total = div_rn_check(dev)
        print(f"  E1's inlined division vs x / w: {fast} of {total} samples on "
              f"its fast path, {differ} of them with other bits", flush=True)
        div_ok = differ == 0 and fast > total // 2
        if self.xgm is None:
            self.xgm = planted_gm()
        cases = [("ragged", planted(737, 450, 5, seed=1),
                  [rk for rk in range(2, 9) for _ in range(3)], 8,
                  (torch.int8, torch.float32)),
                 ("full-width", self.xgm, [16] * 3, 16, (torch.int8,))]
        ok_all = True
        for cname, x_np, ranks, r, xdts in cases:
            for dt in (torch.float64, torch.float32):
                for xdt in xdts:
                    x, lw, lh, eh, sc, kw = epi_inputs(x_np, ranks, r, dt,
                                                       xdt, 3, dev)
                    tag = f"{cname} {str(dt)[6:]} X={str(xdt)[6:]}"
                    for layout in ("gm", "cm"):
                        for bf16 in (False, True):
                            res = compare_fused(x, lw, lh, layout, bf16, dt)
                            print(f"  {tag} E1 {layout} bf16={int(bf16)}: "
                                  f"{'ok' if res['ok'] else 'MISMATCH'} "
                                  + " ".join(f"{k}={v:.3g}" for k, v in
                                             res["err"].items())
                                  + f" deterministic={res['deterministic']}",
                                  flush=True)
                            ok_all = ok_all and res["ok"]
                            if (cname == "full-width" and not bf16
                                    and dt == torch.float32):
                                for k, v in res["abs_err"].items():
                                    self.kernels[k]["max_abs_err"] = v
                    m_live = kw["m"] - 7 if cname == "ragged" else kw["m"]
                    for ml in sorted({kw["m"], m_live}):
                        res = compare_epi_post(x, lw, lh, eh, sc, kw, dt, ml)
                        print(f"  {tag} E2/E3 m_live={ml}: "
                              f"{'ok' if res['ok'] else 'MISMATCH'} "
                              + " ".join(f"{k}={v:.3g}" for k, v in
                                         res["err"].items())
                              + f" deterministic={res['deterministic']}",
                              flush=True)
                        ok_all = ok_all and res["ok"]
                        if cname == "full-width" and dt == torch.float32:
                            for k, v in res["abs_err"].items():
                                self.kernels[k]["max_abs_err"] = v
                    if cname == "ragged":
                        res = compare_epi_sweep(x, lw, lh, eh, sc, kw, dt)
                        print(f"  {tag} sweep E1-E3+K4: "
                              f"{'ok' if res['ok'] else 'MISMATCH'} "
                              + " ".join(f"{k}={v:.3g}" for k, v in
                                         res["err"].items()), flush=True)
                        ok_all = ok_all and res["ok"]
                    del x, lw, lh, eh, sc
                    torch.cuda.empty_cache()
        print(f"  tolerances: f64 {F64_TOL:g}; f32 swn/shn/factors/hypers "
              f"{F32_FACTOR_TOL:g}, xlog and elbo per element "
              f"{F32_ELBO_TOL:g}")

        # the loop: vb_run_epi on the bundled lanes (phase 3's QC, ranks
        # 2..8 x 3, rmax 8, the driver's seed-0 draws) equals vb_run_sol
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        xb = torch.as_tensor(s.counts_dense(dtype=np.float32)
                             .astype(np.int16), device=dev)
        n, m = xb.shape
        ranks = np.repeat(np.arange(2, 9), 3)

        def lanes(dt):
            gen = torch.Generator().manual_seed(0)
            h1 = vb.Hyper(1.0, 1.0, 1.0, 1.0)
            sts = [vb.vb_init_random(gen, n, m, 8, h1, dt, dev)
                   for _ in ranks]
            st = vb.VBState(*(torch.stack(f) for f in zip(*sts)))
            hy = vb.Hyper(*(torch.ones(len(ranks), dtype=dt, device=dev),)
                          * 4)
            rm = torch.as_tensor((np.arange(8)[None] < ranks[:, None])
                                 .astype(float), dtype=dt, device=dev)
            rt = torch.as_tensor(ranks.astype(float), dtype=dt, device=dev)
            return st, hy, dict(itmax=3000, rank_mask=rm, r_true=rt)

        # E1 'cm' is reached by vb_run_epi(layout='cm'): its run, float32
        st, hy, kw = lanes(torch.float32)
        vbk.reset_launches()
        epi.reset_launches()
        sol.reset_launches()
        out = epi.vb_run_epi(xb, st, hy, layout="cm", **kw)
        torch.cuda.synchronize()
        counts = dict(vbk.LAUNCHES, **epi.LAUNCHES)
        self.kernels["fused_xpass_cm"]["launches"] = counts["fused_xpass_cm"]
        ok_cm = (counts["fused_xpass_cm"] > 0 and counts["fused_xpass_gm"] == 0
                 and counts["fused_xpass_cm"] == sol.LAUNCHES["finish"]
                 and bool(torch.isfinite(out.lml).all()))
        print(f"  vb_run_epi(layout='cm') float32, 21 bundled lanes: "
              f"n_iter {out.n_iter.tolist()}, launches {counts}, K4 "
              f"{sol.LAUNCHES['finish']}")
        lw = st.lw.contiguous()
        lh = st.lh.contiguous()
        e1 = vbk.fused_xpass(xb, lw, lh, layout="cm")
        k = "fused_xpass_cm"
        self.kernels[k]["ms"] = cuda_ms(
            lambda: vbk.fused_xpass(xb, lw, lh, layout="cm"), 20)
        self.kernels[k]["plain_ms"] = cuda_ms(
            lambda: vbk.fused_xpass_plain(xb, lw, lh), 20)
        self.set_bound(k, nbytes(xb, lw, lh, e1),
                       6 * 8 * int((xb != 0).sum()) * len(ranks))
        print(f"  {k} at this shape: kernel {self.kernels[k]['ms']:.4f} ms, "
              f"plain {self.kernels[k]['plain_ms']:.4f} ms, bound "
              f"{self.kernels[k]['bound_ms']:.4f} ms "
              f"({self.kernels[k]['bound_by']})", flush=True)
        for key in ("fused_xpass_gm", "fused_xpass_cm"):
            res = ptxas_resources(key)
            print(f"  ptxas {key} (float32): {res}", flush=True)
            self.kernels[key]["ptxas"] = res

        # float64: both layouts of vb_run_epi equal vb_run_sol
        st, hy, kw = lanes(torch.float64)
        a = sol.vb_run_sol(xb, st, hy, **kw)
        ok64 = True
        for layout in ("gm", "cm"):
            b = epi.vb_run_epi(xb, st, hy, layout=layout, **kw)
            same = bool(torch.equal(a.n_iter, b.n_iter))
            lml_err = rel_err(b.lml, a.lml)
            print(f"  float64 vb_run_epi({layout!r}) vs vb_run_sol: n_iter "
                  f"equal {same} ({b.n_iter.tolist()}), lml rel "
                  f"{lml_err:.3g}", flush=True)
            ok64 = ok64 and same and lml_err <= 1e-9
        return ok_all and ok_cm and ok64 and div_ok

    # -- 12 -----------------------------------------------------------
    def gene_major(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops import vb
        from ccfindr_tpu_torch.ops.kernels import epilogue as epi
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        if self.xgm is None:
            self.xgm = planted_gm()
        x_np = self.xgm
        n, m = x_np.shape
        ranks, nrun, itmax = [8, 12, 16], 2, 100
        layout = vbk._fused_layout(sol.round_up(n, vbk.DEFAULT_BN),
                                   sol.round_up(m, vbk.DEFAULT_BM), 16)
        print(f"  X {n} x {m}: the driver's layout is {layout!r}")
        kw = dict(ranks=ranks, nrun=nrun, Itmax=itmax, backend="pallas",
                  device="cuda", verbose=0, seed=0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for mod in (sol, vbk, epi):
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        start.record()
        f = ct.vb_factorize(x_np, **kw)
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end) / 1e3
        counts = dict(sol.LAUNCHES, **vbk.LAUNCHES, **epi.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rec = f.metadata["timings"][0]
        ls = rec["lane_sweeps_executed"]
        print(f"  vb_factorize gene-major (ranks {ranks}, nrun {nrun}, "
              f"Itmax {itmax}): wall {wall:.3f} s, loop {rec['seconds']:.3f}"
              f" s, {ls} lane-sweeps -> {ls / rec['seconds']:.1f} "
              f"lane-sweeps/s of loop ({ls / wall:.1f} of wall), peak "
              f"device memory {peak:.3f} GiB, n_iter {rec['n_iter']}")
        print(f"  launches {counts}")
        print(f.measure.to_string())
        path = ("fused_xpass_gm", "fused_sum", "epi_w_post", "epi_h_post")
        for k in path:
            self.kernels[k]["launches"] = counts[k]
        ok = (layout == "gm"
              and bool(np.isfinite(f.measure["lml"]).all())
              and counts["fused_xpass_gm"] > 0
              and len({counts[k] for k in path + ("finish",)}) == 1
              and counts["xpass"] == counts["w_post"] == counts["h_post"]
              == counts["fused_xpass_cm"] == 0)
        nb = len(ranks) * nrun
        xt = torch.as_tensor(x_np, device=dev)
        chunk = vbk.fused_chunk(xt, "gm", nb, 16, 4)
        pbytes = nb * -(-n // chunk) * 16 * m * 4
        print(f"  E1 'gm' chunk {chunk} genes: shn partials {pbytes / 1e9:.3f}"
              f" GB a sweep for {nb} lanes, X {xt.numel() / 1e9:.3f} GB")

        # beside it, for comparison only: the same lanes (the driver's
        # seed-0 draws) through the cell-major loop vb_run_sol
        gen = torch.Generator().manual_seed(0)
        h1 = vb.Hyper(1.0, 1.0, 1.0, 1.0)
        sts = [vb.vb_init_random(gen, n, m, 16, h1, torch.float32, dev)
               for _ in range(nb)]
        st = vb.VBState(*(torch.stack(t) for t in zip(*sts)))
        del sts
        hy = vb.Hyper(*(torch.ones(nb, device=dev),) * 4)
        ra = np.repeat(ranks, nrun)
        rm = torch.as_tensor((np.arange(16)[None] < ra[:, None])
                             .astype(np.float32), device=dev)
        rt = torch.as_tensor(ra.astype(np.float32), device=dev)
        torch.cuda.synchronize()
        start.record()
        out = sol.vb_run_sol(xt, st, hy, itmax=itmax, rank_mask=rm,
                             r_true=rt)
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
        ls_sol = nb * (int(out.n_iter.max()) + 1)
        best = out.lml.view(len(ranks), nrun).max(1).values.tolist()
        print(f"  vb_run_sol on the same lanes: {secs:.3f} s, {ls_sol} "
              f"lane-sweeps -> {ls_sol / secs:.1f} lane-sweeps/s, n_iter "
              f"{out.n_iter.tolist()}, best lml a rank {best} (gene-major "
              f"{f.measure['lml'].tolist()})", flush=True)
        del out, st
        torch.cuda.empty_cache()

        # per-kernel times at 3 lanes of r = 16 (float32, int8 X): the
        # plain versions are held to one sweep at that batch
        x, lw, lh, eh, sc, kwi = epi_inputs(x_np, [16] * 3, 16,
                                            torch.float32, torch.int8, 3,
                                            dev)
        e1 = vbk.fused_xpass(x, lw, lh, layout="gm")
        swn, shn, xlog = vbk.fused_pallas_raw(x, lw, lh, layout="gm")
        ehs = eh.sum(-1, dtype=torch.float64)
        e2 = epi.epi_w_post(swn, lw, ehs[:, None], sc, 16, n)
        e3 = epi.epi_h_post(shn, lh, e2[3], sc, 16, m, m)
        a = [sc[:, q].float() for q in range(6)]  # aw bw ah bh fudge r_live
        timed = {
            "fused_xpass_gm": (
                lambda: vbk.fused_xpass(x, lw, lh, layout="gm"),
                lambda: fused_plain(x, lw, lh, False), 5),
            "fused_sum": (lambda: vbk.fused_sum(e1[1], e1[2]),
                          lambda: e1[1].sum(1, dtype=torch.float64)
                          .float(), 20),
            "epi_w_post": (
                lambda: epi.epi_w_post(swn, lw, ehs[:, None], sc, 16, n),
                lambda: sol.post_plain(swn.transpose(-1, -2),
                                       lw.transpose(-1, -2), ehs, *a[:2],
                                       *a[4:], 16, n), 20),
            "epi_h_post": (
                lambda: epi.epi_h_post(shn, lh, e2[3], sc, 16, m, m),
                lambda: sol.post_plain(shn, lh, e2[3].sum(1), *a[2:], 16, m),
                20),
        }
        for k, (kern, plain, reps) in timed.items():
            self.kernels[k]["ms"] = cuda_ms(kern, reps)
            self.kernels[k]["plain_ms"] = cuda_ms(plain, 3)
        nnz = int((x != 0).sum())
        self.set_bound("fused_xpass_gm", nbytes(x, lw, lh, e1),
                       6 * 16 * nnz * 3)
        self.set_bound("fused_sum", nbytes(e1[1], e1[2], swn, xlog), 0)
        # E1s against one Tensor.sum of the same partials, in turns (E1s,
        # sum, sum, E1s; five rounds): the median and spread of each
        turns = {"fused_sum": [], "Tensor.sum": []}
        for _ in range(5):
            for which in ("fused_sum", "Tensor.sum", "Tensor.sum",
                          "fused_sum"):
                fn = ((lambda: vbk.fused_sum(e1[1], e1[2]))
                      if which == "fused_sum" else (lambda: e1[1].sum(1)))
                turns[which].append(cuda_ms(fn, 20))
        med = {k: float(np.median(v)) for k, v in turns.items()}
        spread = {k: max(v) - min(v) for k, v in turns.items()}
        self.kernels["fused_sum"].update(
            ms=med["fused_sum"], library_ms=med["Tensor.sum"],
            turns={k: [round(t, 5) for t in v] for k, v in turns.items()})
        print(f"  E1s vs Tensor.sum in turns (5 rounds of E1s, sum, sum, "
              f"E1s; 20 calls a reading): median {med['fused_sum']:.4f} vs "
              f"{med['Tensor.sum']:.4f} ms, spread {spread['fused_sum']:.4f}"
              f" vs {spread['Tensor.sum']:.4f} ms; E1s/sum = "
              f"{med['fused_sum'] / med['Tensor.sum']:.3f}", flush=True)
        kk = self.kernels["fused_xpass_gm"]
        dense = 6 * 16 * n * m * 3
        print(f"  E1 'gm' at {n} x {m}, 3 lanes of r 16: {kk['ms']:.3f} ms, "
              f"{dense / kk['ms'] / 1e9:.2f} TFLOP/s of dense work "
              f"({dense / 1e9:.1f} GFLOP), chunk "
              f"{vbk.fused_chunk(x, 'gm', 3, 16, 4)}; ptxas "
              f"{ptxas_resources('fused_xpass_gm')}", flush=True)
        self.set_bound("epi_w_post", nbytes(swn, lw, ehs, sc, e2),
                       POST_OPS * 3 * 16 * n)
        self.set_bound("epi_h_post", nbytes(shn, lh, e2[3], sc, e3),
                       POST_OPS * 3 * 16 * m)
        for k in timed:
            kk = self.kernels[k]
            print(f"  {k}: kernel {kk['ms']:.4f} ms, plain "
                  f"{kk['plain_ms']:.4f} ms, bound {kk['bound_ms']:.4f} ms "
                  f"({kk['bound_by']}), library {kk['library_ms']}",
                  flush=True)
        return ok

    # -- 13 -----------------------------------------------------------
    def pass2_kernel_vs_plain(self):
        import torch

        from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        if self.x10 is None:
            self.x10 = planted_10x()
        cases = [("ragged", planted(737, 450, 5, seed=1),
                  [rk for rk in range(2, 9) for _ in range(3)], 8),
                 ("10x", self.x10, [16] * 3, 16)]
        ok_all = True
        for cname, x_np, ranks, r in cases:
            for dt in (torch.float64, torch.float32):
                x, lw, lh = pass2_inputs(x_np, ranks, r, dt, 11, dev)
                res = compare_pass2(x, lw, lh, dt)
                print(f"  {cname} {str(dt)[6:]}: "
                      f"{'ok' if res['ok'] else 'MISMATCH'} "
                      + " ".join(f"{k}={v:.3g}" for k, v in res["err"].items())
                      + f" deterministic={res['deterministic']} "
                      f"padded_same={res['padded_same']}", flush=True)
                ok_all = ok_all and res["ok"]
                if cname == "10x" and dt == torch.float32:
                    for k, v in res["abs_err"].items():
                        self.kernels[k]["max_abs_err"] = v
                    self.pass2_times(x, lw, lh)
                del x, lw, lh
                torch.cuda.empty_cache()
        print(f"  tolerances: f64 {F64_TOL:g}; f32 sw/sh {F32_FACTOR_TOL:g}, "
              f"data term {F32_ELBO_TOL:g}")
        return ok_all

    def pass2_times(self, x, lw, lh):
        """P1's and P2's times at the 10x shape (3 lanes of r = 16,
        float32), their plain versions' and their bounds: the products
        are needed at the nonzeros of X only, 6 r flops a nonzero and
        lane each (P1: wth, swn, shn; P2: wth and the two halves of S)."""
        import torch

        from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

        nb, n, r = lw.shape
        chunk = vbk.pass2_chunk(x, n, lh.shape[-1], nb, r, lw.element_size())
        lwl, lhl = vbk.xlogx(lw), vbk.xlogx(lh)
        p1 = vbk.ss_xpass(x, lw, lh, chunk=chunk)
        p2 = vbk.elbo_xpass(x, lw, lwl, lh, lhl)[0]
        timed = {
            "ss_xpass": (lambda: vbk.ss_xpass(x, lw, lh, chunk=chunk),
                         lambda: vbk.suffstats_plain(x, lw, lh)),
            "elbo_xpass": (lambda: vbk.elbo_xpass(x, lw, lwl, lh, lhl),
                           lambda: vbk.elbo_data_plain(x, lw, lh)),
        }
        for k, (kern, plain) in timed.items():
            self.kernels[k]["ms"] = cuda_ms(kern, 10)
            self.kernels[k]["plain_ms"] = cuda_ms(plain, 3)
        nnz = int((x != 0).sum())
        self.set_bound("ss_xpass", nbytes(x, lw, lh, p1), 6 * r * nnz * nb)
        self.set_bound("elbo_xpass", nbytes(x, lw, lwl, lh, lhl, p2),
                       6 * r * nnz * nb)
        for k in timed:
            kk = self.kernels[k]
            print(f"  {k} at {x.shape[0]} x {x.shape[1]}, {nb} lanes of r "
                  f"{r}: kernel {kk['ms']:.4f} ms, plain {kk['plain_ms']:.4f}"
                  f" ms, bound {kk['bound_ms']:.4f} ms ({kk['bound_by']})",
                  flush=True)
        print(f"  P1 chunk {chunk} genes: {nb * -(-n // chunk)} blocks; "
              f"ptxas (float32 X and factors) "
              f"{ptxas_resources('ss_xpass')}")
        self.kernels["ss_xpass"]["ptxas"] = ptxas_resources("ss_xpass")

    # -- 14 -----------------------------------------------------------
    def pallas2pass_slice(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops import vb
        from ccfindr_tpu_torch.ops.kernels import epilogue as epi
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

        torch.backends.cuda.matmul.allow_tf32 = False
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        kw = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                  device="cuda", verbose=0)

        # float64: the two-pass kernels against the matmul sweep
        a = ct.vb_factorize(s, seed=0, dtype=torch.float64,
                            backend="pallas2pass", **kw)
        b = ct.vb_factorize(s, seed=0, dtype=torch.float64, backend="dense",
                            **kw)
        nit_a = a.metadata["timings"][0]["n_iter"]
        nit_b = b.metadata["timings"][0]["n_iter"]
        lml_err = float(np.max(np.abs(a.measure["lml"] - b.measure["lml"])
                               / np.abs(b.measure["lml"])))
        ok64 = nit_a == nit_b and lml_err <= 1e-9
        print(f"  float64 pallas2pass vs dense: n_iter equal "
              f"{nit_a == nit_b} ({nit_a}), lml rel {lml_err:.3g}")

        # float32 seed 0: the path's run, its launches counted
        for mod in (sol, vbk, epi):
            mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = ct.vb_factorize(s, seed=0, backend="pallas2pass", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sol.LAUNCHES, **vbk.LAUNCHES, **epi.LAUNCHES)
        for k in P2_KERNELS:
            self.kernels[k]["launches"] = counts[k]
        opt = ct.optimal_rank(f)
        print(f"  vb_factorize pallas2pass float32 seed 0: {wall:.2f} s, "
              f"ropt={opt['ropt']}, launches {counts}")
        print(f.measure.to_string())
        off = ("xpass", "w_post", "h_post", "finish", "fused_xpass_cm",
               "fused_xpass_gm", "epi_w_post", "epi_h_post")
        ok32 = (opt["ropt"] == 5 and counts["ss_xpass"] > 0
                and counts["ss_xpass"] == counts["elbo_xpass"]
                == counts["fused_sum"]
                and all(counts[k] == 0 for k in off)
                and bool(np.isfinite(f.measure["lml"]).all()))
        for seed in (1, 2):
            g = ct.vb_factorize(s, seed=seed, backend="pallas2pass", **kw)
            print(f"  seed {seed}: ropt={ct.optimal_rank(g)['ropt']} "
                  "(reported, not gated)")

        # the 10x scan beside backend='pallas' on the same matrix
        x_np = self.x10 if self.x10 is not None else planted_10x()
        n, m = x_np.shape
        kw10 = dict(ranks=[8, 12, 16], nrun=2, Itmax=300, device="cuda",
                    verbose=0, seed=0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        rate = {}
        for backend in ("pallas2pass", "pallas"):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            start.record()
            g = ct.vb_factorize(x_np, backend=backend, **kw10)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
            rec = g.metadata["timings"][0]
            ls = rec["lane_sweeps_executed"]
            rate[backend] = ls / rec["seconds"]
            print(f"  10x vb_factorize {backend}: wall {secs:.3f} s, loop "
                  f"{rec['seconds']:.3f} s, {ls} lane-sweeps -> "
                  f"{rate[backend]:.1f} lane-sweeps/s of loop "
                  f"({ls / secs:.1f} of wall), peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
                  f"lml {g.measure['lml'].tolist()}", flush=True)
            ok32 = ok32 and bool(np.isfinite(g.measure["lml"]).all())
        print(f"  10x loop pallas2pass/pallas = "
              f"{rate['pallas2pass'] / rate['pallas']:.3f}")

        # device launches a sweep of the two loops on the 10x lanes
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(0)
        h1 = vb.Hyper(1.0, 1.0, 1.0, 1.0)
        ra = np.repeat([8, 12, 16], 2)
        st = vb.VBState(*(torch.stack(t) for t in zip(
            *[vb.vb_init_random(gen, n, m, 16, h1, torch.float32, dev)
              for _ in ra])))
        hy = vb.Hyper(*(torch.ones(len(ra), device=dev),) * 4)
        rm = torch.as_tensor((np.arange(16)[None] < ra[:, None])
                             .astype(np.float32), device=dev)
        rt = torch.as_tensor(ra.astype(np.float32), device=dev)
        x32 = torch.as_tensor(x_np, dtype=torch.float32, device=dev)
        x8 = torch.as_tensor(x_np, device=dev)
        ss, dt = vbk.make_pallas_backend()
        sweeps = 10
        loops = {
            "pallas2pass": lambda: vb.vb_run(
                vbk.pad_matrix(x32), st, hy, itmax=sweeps, tol=0.0,
                rank_mask=rm, r_true=rt, suffstats=ss, data_term=dt),
            "pallas": lambda: sol.vb_run_sol(x8, st, hy, itmax=sweeps,
                                             tol=0.0, rank_mask=rm,
                                             r_true=rt),
        }
        for name, fn in loops.items():
            fn()
            nl = device_launches(fn)
            print(f"  {name} loop: {nl / sweeps:.1f} device launches a sweep "
                  f"({sweeps} sweeps at tol 0)", flush=True)
        return ok64 and ok32

    # -- 15 -----------------------------------------------------------
    def sparse_bf16(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import sparse as spk

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        if self.x10m is None:
            self.x10m = masked_10x(self.x10 if self.x10 is not None
                                   else planted_10x())
        cases = [("ragged", s.counts,
                  [rk for rk in range(2, 9) for _ in range(3)], 8),
                 ("10x", self.x10m[1], [16] * 3, 16)]
        ok_all = True
        for cname, csr, ranks, r in cases:
            for dt in (torch.float64, torch.float32):
                tc, lw, lh = sparse_inputs(csr, ranks, r, dt, torch.int16, 7,
                                           dev)
                res = compare_sparse(tc, lw, lh, 1, dt, bf16=True)
                print(f"  {cname} {str(dt)[6:]} bf16: "
                      f"{'ok' if res['ok'] else 'MISMATCH'} "
                      + " ".join(f"{k}={v:.3g}" for k, v in res["err"].items())
                      + f" deterministic={res['deterministic']}", flush=True)
                ok_all = ok_all and res["ok"]
                if cname == "10x" and dt == torch.float32:
                    for k in SP_KERNELS:
                        self.kernels[k]["bf16_max_abs_err"] = \
                            res["abs_err"][k]
                del tc, lw, lh
                torch.cuda.empty_cache()
        # both modes at phase 10's timing inputs (6 lanes, r 16, float32)
        tc, lw, lh = sparse_inputs(self.x10m[1], [8, 8, 12, 12, 16, 16], 16,
                                   torch.float32, torch.int16, 9, dev)
        lht = lh.transpose(-1, -2).contiguous()
        for bf16 in (False, True, True, False):
            _, a, _, _ = spk.sp_rowpass(tc, lw, lht, mxu_bf16=bf16)
            ms = (cuda_ms(lambda: spk.sp_rowpass(tc, lw, lht,
                                                 mxu_bf16=bf16), 20),
                  cuda_ms(lambda: spk.sp_colpass(tc, a, lw,
                                                 mxu_bf16=bf16), 20))
            print(f"  10x, 6 lanes, {'bf16' if bf16 else 'float32'}: "
                  f"sp_rowpass {ms[0]:.4f} ms, sp_colpass {ms[1]:.4f} ms")
            if bf16:
                for k, v in zip(SP_KERNELS, ms):
                    self.kernels[k]["bf16_ms"] = v
        del tc, lw, lh, lht, a
        print(f"  tolerances (float32's, both factor types): swn/a/shn "
              f"{F32_FACTOR_TOL:g}, data term per element {F32_ELBO_TOL:g}")

        kw = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                  backend="sparse", device="cuda", verbose=0,
                  precision="bf16")
        ok = ok_all
        for seed in (0, 1, 2):
            if seed == 0:
                spk.reset_launches()
            g = ct.vb_factorize(s, seed=seed, **kw)
            ropt = ct.optimal_rank(g)["ropt"]
            print(f"  sparse bf16 seed {seed}: ropt={ropt}"
                  + (f" (gated: 5), launches {dict(spk.LAUNCHES)}"
                     if seed == 0 else " (reported)"))
            if seed == 0:
                ok = ok and ropt == 5 and bool(
                    np.isfinite(g.measure["lml"]).all()) and min(
                    spk.LAUNCHES.values()) > 0

        # the 10x sparse VB scan, bf16 beside float32
        kw10 = dict(ranks=[8, 12, 16], nrun=2, Itmax=300, device="cuda",
                    verbose=0, seed=0, backend="sparse")
        for prec in ("bf16", "f32"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = ct.vb_factorize(self.x10m[1], precision=prec, **kw10)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec = g.metadata["timings"][0]
            ls = rec["lane_sweeps_executed"]
            print(f"  10x sparse vb_factorize {prec}: wall {wall:.3f} s, loop "
                  f"{rec['seconds']:.3f} s, {ls} lane-sweeps -> "
                  f"{ls / rec['seconds']:.1f} lane-sweeps/s of loop, n_iter "
                  f"{rec['n_iter']}, lml {g.measure['lml'].tolist()}",
                  flush=True)
            ok = ok and bool(np.isfinite(g.measure["lml"]).all())
        return ok

    # -- 16 -----------------------------------------------------------
    def checkpointing(self):
        import os
        import tempfile

        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.drivers import ml_driver as md
        from ccfindr_tpu_torch.drivers import vb_driver as vd
        from ccfindr_tpu_torch.utils import lane_sum

        dev = torch.device("cuda")
        # the loops' fixed-order reduction: a lane's sum is the same
        # bits in a batch of any size
        gen = torch.Generator(device=dev).manual_seed(0)
        probe_ok = True
        for shape in ((21, 684 * 8), (21, 8, 447), (21, 4089 * 16)):
            t = torch.rand(shape, generator=gen, device=dev)
            full = lane_sum(t, len(shape) - 1)
            for nb in (1, 2, 3, 7, 16):
                probe_ok &= bool(torch.equal(
                    lane_sum(t[5:5 + nb].clone(), len(shape) - 1),
                    full[5:5 + nb]))
        print(f"  lane_sum of 1..16 lanes equals the 21-lane batch's bits: "
              f"{probe_ok}")

        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        tmp = tempfile.mkdtemp(prefix="ccfindr_ck_")
        ok = probe_ok

        def three_runs(fn, module, name, kw, ckname):
            """The run interrupted after two chunks of 30 sweeps, resumed,
            and compacted every 50 sweeps, against ``base``."""
            ck = os.path.join(tmp, f"{name}_{kw['backend']}")
            orig = interrupting(module, name, 2)
            stopped = False
            try:
                fn(s, checkpoint_dir=ck, checkpoint_every=30, **kw)
            except Interrupted:
                stopped = True
            finally:
                setattr(module, name, orig)
            left = os.path.exists(os.path.join(ck, ckname))
            resumed = fn(s, checkpoint_dir=ck, checkpoint_every=30, **kw)
            compacted = fn(s, compact_every=50, **kw)
            return stopped and left, resumed, compacted

        for backend in ("pallas", "sparse"):
            kw = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                      backend=backend, device="cuda", verbose=0, seed=0)
            base = (self.vb_result if backend == "pallas"
                    and self.vb_result is not None
                    else ct.vb_factorize(s, **kw))
            t0 = time.perf_counter()
            stopped, b, c = three_runs(ct.vb_factorize, vd, "_chunked_vb",
                                       kw, "vb_sweeps_batch.npz")
            rb, rc = same_vb(base, b), same_vb(base, c)
            print(f"  VB {backend}: interrupted with its checkpoint left "
                  f"{stopped}; resumed == uninterrupted {rb}; "
                  f"compact_every=50 == uninterrupted {rc} "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
            ok = ok and stopped and rb and rc

        # the routes whose resume the card does not gate: the two-pass
        # loop (kernels P1/P2 and the lane_sum glue) and the dense
        # parity route (cuBLAS batched matmuls), compacted
        for backend in ("pallas2pass", "dense"):
            kw = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                      backend=backend, device="cuda", verbose=0, seed=0)
            same = same_vb(ct.vb_factorize(s, **kw),
                           ct.vb_factorize(s, compact_every=50, **kw))
            print(f"  VB {backend}: compact_every=50 == uninterrupted {same} "
                  "(printed, not gated)", flush=True)

        kwm = dict(ranks=[4, 5, 6], nrun=4, Itmax=400, Tol=1e-4,
                   backend="pallas", device="cuda", verbose=0, seed=0)
        base = ct.factorize(s, **kwm)
        stopped, b, c = three_runs(ct.factorize, md, "_chunked_ml", kwm,
                                   "ml_sweeps_s0_p0.npz")
        rb, rc = same_ml(base, b), same_ml(base, c)
        print(f"  ML pallas: interrupted with its checkpoint left {stopped}; "
              f"resumed == uninterrupted {rb}; compact_every=50 == "
              f"uninterrupted {rc}", flush=True)
        ok = ok and stopped and rb and rc

        # compaction at the 10x shape: printed, not gated
        x_np = self.x10 if self.x10 is not None else planted_10x()
        kw10 = dict(ranks=[8, 12, 16], nrun=2, Itmax=300, backend="pallas",
                    device="cuda", verbose=0, seed=0)
        outs = {}
        for label, extra in (("unchunked", {}),
                             ("compact_every=50", dict(compact_every=50))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = outs[label] = ct.vb_factorize(x_np, **kw10, **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec = g.metadata["timings"][0]
            print(f"  10x VB {label}: wall {wall:.3f} s, loop "
                  f"{rec['seconds']:.3f} s, lane-sweeps executed "
                  f"{rec['lane_sweeps_executed']}, n_iter {rec['n_iter']}",
                  flush=True)
        print(f"  10x compacted == unchunked: "
              f"{same_vb(outs['unchunked'], outs['compact_every=50'])}")
        return ok

    # -- 17 -----------------------------------------------------------
    def mesh(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops import vb
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh
        from ccfindr_tpu_torch.parallel.sharded import ShardedCounts

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        k = MESH_CELLS
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        xb = np.asarray(s.counts_dense(dtype=np.float64))
        x10 = self.x10 if self.x10 is not None else planted_10x()
        ok = True

        # the kernels against the plain sharded sweep
        xb_pad = np.pad(xb, ((0, 0), (0, -xb.shape[1] % k)))
        cases = [("bundled", xb_pad, xb.shape[1],
                  [rk for rk in range(2, 9) for _ in range(3)], 8,
                  torch.int16),
                 ("10x", x10, x10.shape[1], [16] * 3, 16, torch.int8)]
        for cname, x_np, m_live, ranks, r, xdt in cases:
            for dt in (torch.float64, torch.float32):
                args = sweep_inputs(x_np, ranks, r, dt, xdt, 1.0, 7, dev)
                res = compare_mesh_sweep(args, k, m_live, dt)
                worst = max(res["err"].items(), key=lambda kv: kv[1])
                print(f"  {cname} {str(dt)[6:]} cells={k} (m_live "
                      f"{m_live} of {x_np.shape[1]}): "
                      f"{'ok' if res['ok'] else 'MISMATCH'} worst "
                      f"{worst[0]}={worst[1]:.3g} elbo="
                      f"{res['err']['elbo']:.3g} deterministic="
                      f"{res['deterministic']}", flush=True)
                if not res["ok"]:
                    print(f"    errors: {res['err']}", flush=True)
                ok = ok and res["ok"]
                if cname == "10x" and dt == torch.float32:
                    for key in MESH_KERNELS:
                        self.kernels[key]["max_abs_err"] = \
                            res["abs_err"][key]
                del args
            torch.cuda.empty_cache()

        # one shard, and whole-chunk shards at 10x: the single-device bits
        for cname, x_np, m_live, ranks, r, xdt in cases:
            args = sweep_inputs(x_np, ranks, r, torch.float32, xdt, 1.0, 8,
                                dev)
            x, lwt, lh, eh, sc, kw = args
            kw = sol_kw(kw, m_live)
            want = sol.sol_sweep(x, lwt, lh, eh, sc, **kw)
            for cells in ((1,) if cname == "bundled" else (1, 2, 4)):
                _, got = mesh_sweep(x, lwt, lh, eh, sc, cells,
                                    ssh.sharded_sweep_kernels, **kw)
                same = all(torch.equal(u, v) for u, v in zip(got, want))
                print(f"  {cname} cells={cells}: bit-identical to K1-K4 "
                      f"{same}", flush=True)
                ok = ok and same
            del args, want, got
        torch.cuda.empty_cache()

        # the 10x scan over the mesh beside the single-device scan, in
        # turns (one device, cells=4, cells=2, one device), after a short
        # warm-up scan of each route so that the first turn pays no
        # first-call cost; the cells=4 run is the path whose launches
        # are counted
        kw10 = dict(ranks=[8, 12, 16], nrun=2, Itmax=300, backend="pallas",
                    device="cuda", verbose=0, seed=0)
        for cells in (None, k):
            ct.vb_factorize(x10, **dict(kw10, Itmax=30), **(
                {} if cells is None else dict(mesh=ct.make_mesh(
                    cells=cells, devices=[dev] * cells))))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        outs = {}
        runs_ls = {}
        for cells in (None, k, 2, None):
            extra = ({} if cells is None else dict(mesh=ct.make_mesh(
                cells=cells, devices=[dev] * cells)))
            sol.reset_launches()
            ssh.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            start.record()
            g = ct.vb_factorize(x10, **kw10, **extra)
            end.record()
            end.synchronize()
            counts = dict(sol.LAUNCHES, **ssh.LAUNCHES)
            if cells == k:
                main_counts = counts
            outs.setdefault(cells, g)
            wall = start.elapsed_time(end) / 1e3
            rec = g.metadata["timings"][0]
            ls = rec["lane_sweeps_executed"]
            where = "one device" if cells is None else f"cells={cells}"
            print(f"  10x vb_factorize {where}: "
                  f"wall {wall:.3f} s, loop {rec['seconds']:.3f} s, {ls} "
                  f"lane-sweeps -> {ls / rec['seconds']:.1f} lane-sweeps/s "
                  f"of loop ({ls / wall:.1f} of wall), peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
                  f"n_iter {rec['n_iter']}", flush=True)
            runs_ls.setdefault(cells, []).append(ls / rec["seconds"])
            if cells is not None:
                same = (np.array_equal(g.measure["lml"],
                                       outs[None].measure["lml"])
                        and rec["n_iter"]
                        == outs[None].metadata["timings"][0]["n_iter"])
                nsw = counts["finish"]
                per = {kk: v / max(nsw, 1) for kk, v in counts.items()}
                print(f"    bit-identical to one device {same}; launches "
                      f"{counts}; a sweep: K1s {per['xpass_shard']:.2f}, "
                      f"K2 {per['w_post']:.2f}, K3s "
                      f"{per['h_post_shard']:.2f}, K4 {per['finish']:.2f}",
                      flush=True)
                ok = ok and same and nsw > 0 and (
                    counts["xpass_shard"] == counts["h_post_shard"]
                    == cells * nsw and counts["w_post"] == nsw
                    and counts["xpass"] == counts["h_post"] == 0)
        one = float(np.mean(runs_ls[None]))
        print(f"  10x loop lane-sweeps/s against one device (the mean of "
              f"its two turns, {one:.1f}): cells={k} "
              f"{runs_ls[k][0] / one:.3f}x, cells=2 "
              f"{runs_ls[2][0] / one:.3f}x", flush=True)
        for key, name in (("xpass_shard", "xpass_shard"),
                          ("w_post_mesh", "w_post"),
                          ("h_post_shard", "h_post_shard"),
                          ("finish_mesh", "finish")):
            self.kernels[key]["launches"] = main_counts[name]
        del outs

        # per-kernel times at the 10x mesh shape (6 lanes, rp 16, int8,
        # 4 shards of 2048 cells): one shard's K1s and K3s, K2 and K4 on
        # the gathered partials
        n, m = x10.shape
        x = torch.as_tensor(x10, device=dev)
        gen = torch.Generator().manual_seed(0)
        h1 = vb.Hyper(1.0, 1.0, 1.0, 1.0)
        rank_arr = np.repeat([8, 12, 16], 2)
        nb = len(rank_arr)
        st = vb.VBState(*(torch.stack(t) for t in zip(
            *[vb.vb_init_random(gen, n, m, 16, h1, torch.float32, dev)
              for _ in range(nb)])))
        lwt = st.lw.transpose(-1, -2).contiguous()
        sc = torch.stack([torch.ones(nb, dtype=torch.float64, device=dev)] * 4
                         + [torch.full((nb,), 1.2e-7, dtype=torch.float64,
                                       device=dev),
                            torch.as_tensor(rank_arr, dtype=torch.float64,
                                            device=dev),
                            torch.zeros(nb, dtype=torch.float64, device=dev),
                            torch.ones(nb, dtype=torch.float64, device=dev)],
                         dim=1)
        xs = ShardedCounts(x, np.array([[dev] * k], dtype=object))
        lhs, ehs = xs.shard_h(st.lh), xs.shard_h(st.eh)
        dt = torch.float32
        a = [sc[:, q].to(dt) for q in range(6)]
        parts = [ssh.xpass_shard(b, lwt, lh_, eh_, sc)
                 for b, lh_, eh_ in zip(xs.blocks[0], lhs, ehs)]
        ngc = parts[0][1].shape[1]
        swn_part = ssh.gather([p[0] for p in parts], 1, dev)
        xlog_part = ssh.gather([p[2].view(nb, ngc, -1) for p in parts], 2,
                               dev).view(nb, -1)
        ehs_part = ssh.gather([p[3] for p in parts], 1, dev)
        k2 = sol.w_post(swn_part, lwt, ehs_part, sc, 16, n)
        mp_loc = m // k
        k3 = [ssh.h_post_shard(p[1], lh_, k2[3], sc, 16, mp_loc, mp_loc)
              for p, lh_ in zip(parts, lhs)]
        rsum_part = ssh.gather([h[3] for h in k3], 1, dev)
        hscal_part = ssh.gather([h[4] for h in k3], 1, dev)
        fin = dict(n=n, m=m, dt=dt, hyper_mask=(True,) * 4,
                   newton_niter=100, newton_tol=1e-4)
        pall = [ssh.xpass_shard_plain(b, lwt, lh_, eh_, sc)
                for b, lh_, eh_ in zip(xs.blocks[0], lhs, ehs)]
        swnt = ssh.shard_sum([p[0] for p in pall])
        ehs_sum = ssh.shard_sum([p[3] for p in pall])
        xlog = ssh.shard_sum([p[2] for p in pall])
        p2 = sol.post_plain(swnt, lwt, ehs_sum, a[0], a[1], a[4], a[5], 16, n)
        p3 = [ssh.h_post_shard_plain(p[1], lh_, p2[3], sc, 16, mp_loc,
                                     mp_loc) for p, lh_ in zip(pall, lhs)]
        rsum = ssh.shard_sum([h[3] for h in p3])
        hscal = ssh.shard_sum([h[4] for h in p3])
        timed = {
            "xpass_shard": (
                lambda: ssh.xpass_shard(xs.blocks[0][0], lwt, lhs[0], ehs[0],
                                        sc),
                lambda: ssh.xpass_shard_plain(xs.blocks[0][0], lwt, lhs[0],
                                              ehs[0], sc)),
            "w_post_mesh": (
                lambda: sol.w_post(swn_part, lwt, ehs_part, sc, 16, n),
                lambda: sol.post_plain(swnt, lwt, ehs_sum, a[0], a[1], a[4],
                                       a[5], 16, n)),
            "h_post_shard": (
                lambda: ssh.h_post_shard(parts[0][1], lhs[0], k2[3], sc, 16,
                                         mp_loc, mp_loc),
                lambda: ssh.h_post_shard_plain(pall[0][1], lhs[0], p2[3], sc,
                                               16, mp_loc, mp_loc)),
            "finish_mesh": (
                lambda: sol.finish(sc, xlog_part, k2[3], k2[4], rsum_part,
                                   hscal_part, **fin),
                lambda: sol.finish_plain(sc, xlog, p2[3], p2[4], rsum, hscal,
                                         n, m, dt, (True,) * 4, 100, 1e-4)),
        }
        for key, (kern, plain) in timed.items():
            self.kernels[key]["ms"] = cuda_ms(kern, 20)
            self.kernels[key]["plain_ms"] = cuda_ms(plain, 5)
        # bounds: the bytes of the function, as in phase 4 (a shard's
        # swnt partial and shn, the reduced swnt, ehs, csum, rsum and
        # H scalars), not the kernels' per-chunk partials
        nnz0 = int((xs.blocks[0][0] != 0).sum())
        fin_out = sol.finish(sc, xlog_part, k2[3], k2[4], rsum_part,
                             hscal_part, **fin)
        self.set_bound("xpass_shard", nbytes(xs.blocks[0][0], lwt, lhs[0],
                                             ehs[0], sc, pall[0]),
                       6 * 16 * nnz0 * nb)
        self.set_bound("w_post_mesh", nbytes(swnt, lwt, ehs_sum, sc, p2),
                       POST_OPS * nb * 16 * n)
        self.set_bound("h_post_shard", nbytes(pall[0][1], lhs[0], p2[3], sc,
                                              p3[0]),
                       POST_OPS * nb * 16 * mp_loc)
        self.set_bound("finish_mesh", nbytes(sc, xlog, p2[3], p2[4], rsum,
                                             hscal, fin_out), 0)
        for key in MESH_KERNELS:
            kd = self.kernels[key]
            print(f"  {kd['name']}: kernel {kd['ms']:.4f} ms, plain "
                  f"{kd['plain_ms']:.4f} ms, bound {kd['bound_ms']:.4f} ms "
                  f"({kd['bound_by']}), launches {kd['launches']}, max abs "
                  f"err {kd['max_abs_err']:.3g}", flush=True)

        # device launches a sweep of the loop on these lanes, one device
        # beside cells=4 (torch.profiler; itmax 10 at tol 0 runs 11
        # sweeps)
        rm = torch.as_tensor((np.arange(16)[None] < rank_arr[:, None])
                             .astype(np.float32), device=dev)
        rt = torch.as_tensor(rank_arr.astype(np.float32), device=dev)
        hy = vb.Hyper(*(torch.ones(nb, device=dev),) * 4)
        loops = {
            "one device": lambda: sol.vb_run_sol(x, st, hy, itmax=10,
                                                 tol=0.0, rank_mask=rm,
                                                 r_true=rt),
            f"cells={k}": lambda: sol.vb_run_sol(
                xs, st, hy, itmax=10, tol=0.0, rank_mask=rm, r_true=rt,
                sweep_fn=ssh.make_sol_sweep_sharded(
                    ct.make_mesh(cells=k, devices=[dev] * k))),
        }
        for name, fn in loops.items():
            fn()
            print(f"  vb_run_sol {name}: {device_launches(fn) / 11:.1f} "
                  "device launches a sweep", flush=True)
        del x, xs, parts, pall, swn_part
        torch.cuda.empty_cache()

        # the bundled mesh scan: ropt 5 in float32 and in bf16
        kwb = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                   backend="pallas", device="cuda", verbose=0, seed=0,
                   mesh=ct.make_mesh(cells=k, devices=[dev] * k))
        for label, extra in (("float32", {}),
                             ("bf16, elbo_every=5",
                              dict(precision="bf16", elbo_every=5))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = ct.vb_factorize(s, **kwb, **extra)
            torch.cuda.synchronize()
            ropt = ct.optimal_rank(g)["ropt"]
            print(f"  bundled mesh scan (cells={k}) {label}: "
                  f"{time.perf_counter() - t0:.2f} s, ropt={ropt}, lml "
                  f"{np.round(g.measure['lml'].to_numpy(), 5).tolist()}",
                  flush=True)
            ok = ok and ropt == 5 and bool(np.isfinite(g.measure["lml"]).all())

        # 'dense' over the mesh in float64 against 'dense' on one device
        kwd = dict(ranks=[4, 5, 6], nrun=2, Itmax=3000, backend="dense",
                   device="cuda", verbose=0, seed=0, dtype=torch.float64)
        t0 = time.perf_counter()
        a1 = ct.vb_factorize(s, **kwd)
        a4 = ct.vb_factorize(s, mesh=ct.make_mesh(cells=k, devices=[dev] * k),
                             **kwd)
        nit1 = a1.metadata["timings"][0]["n_iter"]
        nit4 = a4.metadata["timings"][0]["n_iter"]
        lml_err = float(np.max(np.abs(a4.measure["lml"] - a1.measure["lml"])
                               / np.abs(a1.measure["lml"])))
        print(f"  float64 dense cells={k} vs one device: n_iter equal "
              f"{nit1 == nit4} ({nit4}), lml rel {lml_err:.3g} "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)
        return ok and nit1 == nit4 and lml_err <= 1e-9


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17")
    ap.add_argument("--verbose", action="store_true",
                    help="print ptxas's register/spill report")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    try:
        import ccfindr_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import ccfindr_tpu_torch ({exc}); run "
              "from the root of the repository", file=sys.stderr)
        return 1

    smoke = Smoke(args.verbose)
    phases = {"1": ("device+build", smoke.device_and_build),
              "2": ("kernel-vs-plain", smoke.kernel_vs_plain),
              "3": ("slice", smoke.slice),
              "4": ("10x-scale", smoke.scale),
              "5": ("ml-kernel-vs-plain", smoke.ml_kernel_vs_plain),
              "6": ("ml-workflow", smoke.ml_workflow),
              "7": ("ml-10x-scale", smoke.ml_scale),
              "8": ("sparse-kernel-vs-plain", smoke.sparse_kernel_vs_plain),
              "9": ("sparse-workflow", smoke.sparse_workflow),
              "10": ("sparse-scale", smoke.sparse_scale),
              "11": ("gene-major-kernels-vs-plain",
                     smoke.epi_kernel_vs_plain),
              "12": ("gene-major-slice", smoke.gene_major),
              "13": ("two-pass-kernels-vs-plain",
                     smoke.pass2_kernel_vs_plain),
              "14": ("pallas2pass-slice", smoke.pallas2pass_slice),
              "15": ("sparse-bf16", smoke.sparse_bf16),
              "16": ("checkpoint-compaction", smoke.checkpointing),
              "17": ("cell-sharded-mesh", smoke.mesh)}
    wanted = args.phases.split(",")
    if "1" not in wanted:
        wanted = ["1"] + wanted
    t0 = time.perf_counter()
    for p in wanted:
        smoke.phase(*phases[p])
    print(f"chip_smoke: phases {','.join(wanted)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if "jax" in sys.modules:
        print("chip_smoke: JAX was imported", file=sys.stderr)
        smoke.failed.append("no-jax")
    missing = sorted({k for kd in smoke.kernels.values() for k in KEYS
                      if k not in kd})
    if len(wanted) == len(phases) and missing:
        print(f"chip_smoke: kernels line lacks {missing}", file=sys.stderr)
        smoke.failed.append("kernels-line")
    if smoke.failed:
        print(f"chip_smoke: FAILED phases {smoke.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
