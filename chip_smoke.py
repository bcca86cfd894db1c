#!/usr/bin/env python3
"""Smoke run of ccfindr_tpu_torch on one NVIDIA GPU (phase 23: several).

Drives the port's paths through their public entry points, the
batched VB rank scan (``vb_factorize``, on both of its ``'pallas'``
routes and on ``'pallas2pass'``) and the ML rank scan (``factorize``),
on ``backend='pallas'`` and on ``backend='sparse'`` (also in bf16 and
on the ELL layout), and
their checkpoint, resume and lane compaction, their meshes and their
runs over several processes, after checking each CUDA kernel of those
paths against its plain PyTorch version on the card.
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
   lane-sweeps per second (CUDA events, synchronised), the loop alone
   (vb_run_sol, Itmax 100) on the kernels and on the plain version in
   turns, per-kernel times, and the peak device
   memory; the same scan with ``precision='bf16'`` beside it; K1's
   TFLOP/s of dense work at its chunks (sol.CHUNK) and its ptxas
   registers and spills (float32 factors, int8 X); K2's, K3's and K4's
   partial bytes over 3.35 TB/s beside their bounds, K4 with hyper_mask
   all False (its sums alone) and the Newton steps each lane took,
   post_kernel's and finish_kernel's ptxas registers and spills in
   float and double; then post_kernel as K2 and K3 at its edge cases
   (POST_CASES: rp 1, 8, 16, 24, 128, extents not a multiple of
   POST_COLS, r_live < r, m_live < m, nsfx 1 to 32, ndenom 1 to 128) in
   float64 and float32 against post_plain at phase 2's tolerances, two
   launches and lanes alone bit-identical, and K4 under each of the 16
   hyper masks with niter 1 and 100 against finish_plain;
5. ML kernel vs plain: M1 ml_hpass (its tail adds each lane's x*log(wh)
   partials, where a separate M3 launch used to) and M2 ml_wpass, both
   walks of fused.cuh's X pass without its streamed output, on a
   ragged case (737 x 450, 12 lanes of ranks 4..6 x 4 padded to 6,
   masked rows at eps), the 10x case (4096 x 8192, 3 lanes of r = 16,
   X int8 and float32), r = 1 (300 x 700), r = 17 on a 600 x 900 X
   with a 64-row and a 64-column band of zeros, and r = 128 (257 x
   1100, X int8 and float64); every X type in the ragged, r = 1 and
   r = 17 cases; factors float64 and float32.
   Tolerances (elementwise relative): float64 1e-10 on hn, wn and the
   x*log(wh) sum; float32 2e-4 on hn/wn and 1e-5 on the per-element
   likelihood (sum x log wh - sum wh + lgconst) / (n m); M1's tail equal
   to part.sum(-1) to 1e-14 and to the bits of a one-warp sum in M3's
   order.  Two launches must be bit-identical, and lanes 1 and 4 of a
   batch of six (1000 x 1500, r = 16) alone and as a pair must give
   the batch's bits.  Prints M1's and M2's ptxas registers and spills;
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
   the same loop on the plain version, M1/M2 against plain and their
   TFLOP/s of dense work (4 r flops an element and lane), peak device
   memory;
8. sparse kernels vs plain: S1 sp_rowpass (with its tail) and S2 sp_colpass on
   the bundled 684 x 447 CSR after QC (21 lanes of ranks 2..8 padded to
   8, the masked components at fudge) and on phase 4's matrix masked to
   10% density as bench.py:62-63 masks it (3 lanes of r = 16), values
   int16 (the counts) and in the factor type (the counts + 0.25),
   factors float64 and float32, do_elbo 1 and 0.  Tolerances as phase 2: float64 1e-10 on every output;
   float32 2e-4 on swn, a and shn and 1e-5 on the per-element data
   term; S1's tail as M1's.  Two launches must be bit-identical.  Then
   S1/S2 at r = 1, 17, 32, 33 and 128 (both sides of S1's dispatch by
   r: a thread a nonzero up to 32, the group walk above) on a 300 x
   5000 CSR with empty rows and a row of 4,999 nonzeros (at r = 1
   the data term, which the fold cancels to zero, is held to its x
   log wth summand), and lanes 1 and 4 of a batch of six (1000 x 1500,
   r 16) alone and as a pair must give the batch's bits; then S2 alone
   (16-byte row slices up to r 32, whole rows where unaligned, the
   group walk above) at r = 1, 6, 16, 17, 32, 33 and 128 on a 1000 x
   5000 CSC with empty columns and a column of 999 nonzeros, four
   lanes, against its plain version on S1's a, two launches and lanes 1
   and 3 alone and as a pair bit-identical; S1's and S2's ptxas
   registers and spills;
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
   ratio sparse/pallas of each driver; S1/S2 against plain and their
   GB/s of gathered factor rows.
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
   E2 (a thread an entry of the row-major W) also against K2 on the
   transposed layout, bit for bit in e, lwn and d (the same expressions
   an entry), and lanes 1 and B - 1 alone and as a pair with the
   batch's bits; E2's ptxas registers and spills;
   then vb_run_epi on the bundled lanes: layout 'cm' in float32 (the
   run E1 'cm' is counted and timed on), and both layouts in float64,
   which must equal vb_run_sol (n_iter of every lane, lml to 1e-9); E3
   at its edge cases as phase 4 holds K2 and K3 (nsfx 1, ndenom 1 and
   391, m_live < m);
12. the gene-major slice: planted 100,000 x 4,096 int8 (0.41 GB), for
   which the driver's layout must be 'gm'; vb_factorize(ranks [8, 12,
   16], nrun 2, Itmax 100, backend='pallas') in float32: wall, loop,
   lane-sweeps per second, peak device memory, E1's partial bytes;
   gated on a finite lml, E1 'gm', E1s, E2, E3 and K4 launched with
   equal counts and K1-K3 not at all; vb_run_sol on the same lanes
   beside it; E1/E1s/E2/E3 against their plain versions (3 lanes); E2's
   and E3's bounds from the instructions an entry of their SASS, E3's
   partial bytes beside them;
13. two-pass kernels vs plain, one pass: P1 ss_xpass (+ E1s) and P2
   elbo_xpass (with its tail) on a ragged case (737 x 450, 21 lanes of ranks 2..8
   padded to 8, the masked components at fudge) and on phase 4's 10x
   matrix (3 lanes of r = 16), X in the factor dtype, factors float64
   and float32: float64 1e-10 on sw, sh and the data term; float32 2e-4
   on sw/sh and 1e-5 on the data term; two launches bit-identical, and
   a zero-padded X read in place gives the same bits; P2's tail as M1's;
   P1's time and ptxas registers and spills; then P2 alone at r = 1, 17,
   32, 33 and 128 on a 300 x 2500 X (neither extent a multiple of its
   64 x 1024 strip; at r = 1, where S / wth - log wth is 0 in exact
   arithmetic, the term is held to its summands' scale sum x |log
   wth|), and lanes 1 and 4 of six (1000 x 1500, r 16) alone and as a
   pair with the batch's bits; P2's TFLOP/s of dense work (6 r flops an
   element and lane) and ptxas registers and spills;
14. the pallas2pass slice: the bundled vb_factorize(ranks 2..8, nrun 3,
   backend='pallas2pass') in float64 must equal backend='dense' (n_iter
   of every lane, lml to 1e-9); in float32 ropt must be 5 for seed 0
   (seeds 1 and 2 printed), with P1, P2 and E1s launched equally often
   and K1-K4, E1-E3 not at all; the 10x scan (ranks [8, 12, 16], nrun 2,
   Itmax 300) beside backend='pallas': wall, loop, lane-sweeps per
   second, device launches a sweep, peak device memory;
15. bf16 on the sparse backend: S1/S2 with mxu_bf16 against their bf16
   plain versions on phase 8's two cases, S1 on its skewed r cases and
   S2 on its (phase 8's skewed CSC) at the float32 tolerances; the
   bundled sparse scan with precision='bf16' (ropt 5 for seed 0, seeds
   1 and 2 printed); S1/S2 in both modes at phase 10's timing inputs;
   the 10x sparse VB scan in bf16 beside float32 (Itmax 100);
16. checkpoint and compaction: the bundled VB scan on backend='pallas'
   and on backend='sparse', and the bundled factorize(ranks [4, 5, 6],
   nrun 4, Itmax 400, Tol 1e-4, backend='pallas'), each interrupted
   after its second chunk of checkpoint_every=30, resumed, and run with
   compact_every=50: the resumed and the compacted runs must equal the
   uninterrupted one bit for bit (lml or likelihood, dispersion and
   cophenetic, basis, coeff, n_iter); the same for compact_every=50 on
   'pallas2pass', 'dense' and 'dense_fused' (gated); the 10x VB scan
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
   of every lane, lml to 1e-9); K2 gathered, K3s and K4 gathered: their
   partial bytes beside the bounds, K4's sums alone and Newton steps,
   K3s and K2 gathered at their edge cases and K4 on the gathered
   partials of a 600 x 2048 X over 4 shards under every hyper mask, as
   phase 4;
18. the randomized SVD and the host modules: ops.rsvd.randomized_svd
   (rank 16, float32, S2's products of X and X^T) on the card over
   phase 10's atlas CSR, two calls and each step twice bit-identical,
   its singular values against the same range finder in float64 on the
   host (scipy and numpy, the same Omega) within RSVD_S_TOL (relative),
   its time; vb_factorize(backend='sparse', initializer='svd2',
   svd_method='auto', ranks [16], Itmax 20) on the atlas, which takes
   the randomized SVD (min(n, m) > 4096; it raised before) and must
   call it once and end finite; write_10x -> read_10x of phase 8's
   10%-density matrix through the native parser, exact;
19. the mesh backends of parallel/sharded.py, each on one card against
   the same call on one device (float32: factors to 2e-4 of their
   largest entry, per-element lml or likelihood to 1e-5 relative, the
   same ropt for VB; Tol 0, so that both run Itmax = 100 sweeps, 300 on
   the bundled data: cut from 150 and 500 to pay for phase 21), its
   launches counted on the mesh run (every count
   set to 0 just before it): sparse VB at the 10x-10% shape over
   cells=4 (S1/S2 a shard) in float32 and in bf16 with elbo_every=5,
   sparse_layout='coo' over cells=2 (the CSR shards of 'tile'; the
   COO API's make_sparse_fused_sharded is held against one device's
   fused_coo on its own), 'pallas' at 10x over genes=2,
   cells=2 (E1 'cm' + E1s a block; K1 not launched), the gene-major
   100,000 x 4,096 X over cells=2 (E1 'gm' a shard; Itmax 30, where
   phase 12 runs 100, for time), factorize 'pallas' (M1/M2 a shard)
   and 'sparse' (S1/S2) at 10x over cells=4 (their consensus on a
   1,000-cell subsample, for time), and 'pallas2pass' on the
   bundled data over cells=2 (P1 + E1s and P2 a block).  Each site's
   kernel against its plain version on a shard's own inputs at phase 2's
   float32 tolerances, a second launch and lanes alone bit-identical,
   every output of E1 (the streamed factor numerator, the other one and
   x log wth summed by E1s) against the plain X pass at each E1 site,
   its time a launch (a CUDA graph of launches, the call by CUDA events
   beside) beside the same kernel on the one-device inputs, its bound
   from the shard's bytes and operations;
20. several processes: python -m ccfindr_tpu_torch.parallel._mh_worker
   started once a process, all sharing cuda:0 and joined in a gloo
   group on a free localhost port, each running its round-robin share
   of the (rank, run) grid (killed at MP_TIMEOUT): vb_factorize
   (backend='pallas', float32) on phase 4's 10x matrix, ranks [8, 12,
   16], nrun 2, Itmax 300, over 2 processes (the one-process run first,
   then the group, so that both walls are the card's alone);
   factorize(backend='pallas') at phase 7's 10x shape over 2 processes
   (beside the one process); the bundled data's vb_factorize(ranks [4,
   5], nrun 1) over 3 processes, one of them idle.  Gates: every
   process's measure table, factors and its lanes' sweep counts equal
   the one-process run (the same worker with --nproc 1) bit for bit;
   the processes' lanes add up to the grid; each working process
   launched K1-K4 (VB) or M1/M2 (ML) once a sweep of its own batch (its
   counts exceed its lanes' most sweeps by what the one process's
   exceed its own), the idle one none; a worker that fails, hangs or
   imports JAX fails the phase.  Then the bundled VB scan over
   make_mesh(runs=2, cells=1, devices=["cuda:0"] * 2), its two rows one
   after the other, must equal runs=1 bit for bit, and each row must
   launch K1s, K2, K3s and K4 once a sweep of its own lanes.
   The walls of the 2-process and 1-process runs and of runs=2 against
   runs=1 are printed beside the card's name and power limit, not
   gated;
21. sparse_layout='ell' (ops/ell.py: the JAX package's ELL layout, its
   passes S1/S2 over the CSR view EllCounts.csr): on phase 8's 10x-10%
   matrix at the 0.98 quantile and on phase 8's skewed 300 x 5000 CSR
   at 0.5 (tails by gene), the widths, tail lengths and bytes printed,
   the view equal to from_scipy_tile's arrays, and fused_ell, ell_ml_h
   and ell_ml_w (6 lanes, r 16) equal to fused_tile, tile_ml_h and
   tile_ml_w bit for bit, against their plain versions on CPU copies
   (three lanes) at phase 8's tolerances in float32 and float64, two
   launches and lanes 1 and 4 alone bit-identical; S1/S2 at the ELL
   site timed beside plain, bound and S2's library call; then the
   drivers: vb_factorize(backend='sparse', sparse_layout='ell') on the
   10x-10% matrix (ranks [8, 12, 16], nrun 2, Itmax 100, float32) equal
   to 'tile' bit for bit, S1 and S2 launched once a sweep of the batch
   (every count set to 0 just before, read just after: the ELL site's
   launches); the bundled factorize with 'ell' equal to 'tile'; the
   10x-10% scan over cells=4 on one card with 'ell' equal to the tile
   mesh run (Itmax 60), and make_ell_fused_sharded against fused_ell on
   one device; the four refusals (elbo_every, bf16, ML randomize, ML
   mesh) raise; and the dense routes' passes (fused_dense,
   suffstats_dense, elbo_data_term, ml_h_dense, ml_w_dense, likelihood;
   their products by utils.lane_matmul) at 10x, 6 lanes, r 16: lanes 1
   and 4 alone and as a pair give the batch's bits.
22. the atlas workflow's scan at full width (examples/atlas_demo_torch.py's
   simulate_atlas, 20,480 x 100,352 int8, no QC): (a) vb_factorize(ranks
   2..20, nrun 2 = 38 lanes of rp 24, Itmax 4, Tol 0, backend='pallas')
   with every count set to 0 just before: its wall, set-up, loop, ms a
   sweep and peak device memory beside the card; gated on every lane's
   lml finite (the lanes as vb_run_sol returns them), no lane's hyper
   update failed, all 19 ranks in the measure table, K1-K3 launched
   once a lane group a sweep (sol.lane_groups: 58.6 GB of K1 partials
   a sweep in groups of at most sol.LANE_GROUP_BYTES) and K4 once a
   sweep; (b) initializer='svd2' (the randomized SVD start on the dense
   X), ranks 8..20 (ATLAS_LONE_RANKS: a start a rank), nrun 1, Itmax 3:
   its last lane (rank 20, lane 12, in the second of two lane groups)
   equal to rank 20 run alone bit for bit (lml, basis, coeff, sweeps);
   (c) K1-K4 against their plain versions at phase 2's float32
   tolerances on a window of ATLAS_WINDOW cells at the full gene width
   (38 lanes, rp 24), K1 also partial by partial; K1-K3 on 19 lanes of
   the full shape in one launch, whose last lane's partials start past
   element 2**31, against that lane alone bit for bit, and that lane's
   K1 partials (392 cell and 80 gene chunks), K2 and K3 against their
   plain versions at the full shape; then each kernel timed at the full
   shape as the main path launches it (K1-K3 on a lane group, K4 on all
   38 lanes in a CUDA graph) with its bound, K2/K3/K4 beside their
   partials' bytes, and K2/K3 of that group (392 and 80 partials an
   entry) and K4 on all 38 lanes against their plain versions on the
   same partials at phase 2's float32 tolerances: the kernels line
   gains the four `*_atlas` rows (ms and bound at the full shape,
   launches from (a), plain_ms and window_ms on the window, max_abs_err
   the larger of the window's and the full shape's);
23. several cards (``--phases 1,23`` only: not in the default run, and
   it fails with fewer than two visible cards), on k = min(MC_CARDS,
   count) of them, with the cards' names, power limits, ``nvidia-smi
   topo -m`` and peer access printed: (a) every kernel's wrapper (K1-K4,
   K1s, K3s, E1 in both layouts, E1s, E2, E3, P1, P2, M1, M2, S1, S2;
   tools/check_cards.py) with its tensors on the last card and the
   current device at cuda:0, each output bit-identical to the same call
   on cuda:0; (b) the bundled vb_factorize(device='cuda:{k-1}') with
   the bits of cuda:0 and ropt 5; (c) the 10x scan over make_mesh(cells=k),
   runs=2 x cells=k/2 and runs=k (its rows one after the other) on k
   distinct cards, each bit-identical to one card, their walls in
   turns beside one card, the cells=k launch gate of phase 17, and, from
   torch.profiler, each card's launches a sweep, busy share, peer copies
   and the cell-sharded sweep's gathers (device ms and GB a sweep); (d)
   phase 19's mesh routes on distinct cards against one device at phase
   19's tolerances (Itmax MC_ITMAX; sparse over cells=k, 'coo' over 2,
   'ell' over k, 'pallas' genes=2 x cells=k/2, factorize 'pallas' and
   'sparse' over k, 'pallas2pass' over 2, the gene-major X over 2 at
   Itmax 10) and 'dense'/'dense_fused' over k in float64 to 1e-9 with
   equal sweeps, each route's kernels launched; (e) the VB 10x scan over
   k processes, process I on cuda:I, bit-identical to one process, the
   lanes adding up, walls printed; (f) the atlas at full width
   (simulate_atlas and the demo's QC, ranks 2..20 x 2): Itmax
   MC_ATLAS_ITMAX at Tol 0 over make_mesh(cells=k) bit-identical to the
   same sweeps on one card (lml, basis, coeff, sweeps), traced as in
   (c); then the converged scan over the k cards: ropt, the concordance
   at the planted rank, loop and set-up seconds, sweeps and each card's
   peak device memory, gated on a finite lml for every rank;

Every kernel's entry in the kernels line has its launches on its path,
its error against plain, its time (by CUDA events; for the posterior
kernels and K4, whose launches are shorter than the host's call, a
launch's time in a CUDA graph of 20 launches, the call's time kept as
``call_ms``), its plain version's time, its bound
(the larger of bytes over 3.35 TB/s and flops over 67 TFLOP/s, P2's
split-TF32 MMA flops over 495 TFLOP/s, the posterior kernels' SASS
instructions over the issue rate of 33.5 T thread-instructions/s, from
this run's inputs and build) and the time of one PyTorch call computing
the same function where there is one.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``, printed only when
every phase passed.  Run from the root of the repository:
``python3 chip_smoke.py`` (phases 1-22; ``--phases 1,5`` runs a subset,
``--phases 1,23`` the several-card phase); it prints its total time.
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
# W rank-major, the streamed output) (the instantiations the phases
# time: K1, E1 'gm', M1 and M2 on int8 X, 'cm' on the bundled int16 X,
# P1 on float32 X)
XPASS_ENTRIES = {
    "xpass": "fused_xpass_kernelIfaLb1ELb0ELb1ELb1ELb1E",
    "fused_xpass_gm": "fused_xpass_kernelIfaLb1ELb0ELb1ELb0ELb1E",
    "fused_xpass_cm": "fused_xpass_kernelIfsLb0ELb0ELb1ELb0ELb1E",
    "ss_xpass": "fused_xpass_kernelIffLb1ELb0ELb0ELb0ELb1E",
    # M1, M2 (ml.cu): the walk without its streamed output, on int8 X
    "ml_hpass": "fused_xpass_kernelIfaLb0ELb0ELb1ELb0ELb0E",
    "ml_wpass": "fused_xpass_kernelIfaLb1ELb0ELb0ELb0ELb0E",
    # S1 (sparse.cu) at r 16, int16 values, and P2 (pass2.cu) on float X
    # with split-TF32 products: the instantiations phases 10 and 13 time
    "sp_rowpass": "sp_rowpass_kernelIfsLi16ELb0E",
    "elbo_xpass": "elbo_xpass_kernelIffLb1E",
    # S2 (sparse.cu) at r 16 and E2 (epi_w.cuh), float factors: the
    # instantiations phases 10 and 12 time
    "sp_colpass": "sp_colpass_kernelIfLi16ELi4ELb0E",
    "epi_w_post": "12epi_w_kernelIfE",
    # post_kernel (post.cuh: K2, K3, K3s, E3) and K4 in both factor types
    "post_kernel float": "11post_kernelIfE",
    "post_kernel double": "11post_kernelIdE",
    "finish_kernel float": "13finish_kernelIfE",
    "finish_kernel double": "13finish_kernelIdE"}
POST_PTXAS = ("post_kernel float", "post_kernel double",
              "finish_kernel float", "finish_kernel double")
# the kernels timed from a CUDA graph of their launches (Smoke.time_kernel)
GRAPH_TIMED = ("w_post", "h_post", "epi_h_post", "w_post_mesh",
               "h_post_shard", "finish", "finish_mesh", "finish_atlas")
# the ranks on both sides of S1's dispatch by r (a thread a nonzero up
# to 32, the group walk above) and of P2's rank slabs (32)
R_CASES = (1, 17, 32, 33, 128)
# S2's: each of its register widths (4, 8, 16, 32: r 1, 6, 16, 17 and
# 32) and the group walk (33, 128)
S2_R_CASES = (1, 6, 16, 17, 32, 33, 128)
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
E2_SOURCE = "ccfindr_tpu_torch/csrc/epi_w.cuh"  # E2's kernel (epi.cu binds it)
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
# phase 21's ELL site (ops/ell.py: S1/S2 over EllCounts.csr): key -> the
# JAX function it replaces, an XLA gather pass with no Pallas kernel
ELL_SITES = {"sp_rowpass_ell": "ccfindr_tpu/ops/ell.py:313",
             "sp_colpass_ell": "ccfindr_tpu/ops/ell.py:313"}
# phase 19's mesh sites of kernels already ported (a shard's or a
# block's launch on a path that sharded X): key -> (the launch counter,
# its name in the kernels line, source, the JAX function it replaces)
_VBK = "ccfindr_tpu/ops/pallas/vb_kernels.py"
_MLK = "ccfindr_tpu/ops/pallas/ml_kernels.py"
MESH_SITES = {
    "fused_xpass_cm_block": ("fused_xpass_cm", "fused_xpass_cm a block",
                             EPI_SOURCE, f"{_VBK}:454"),
    "fused_sum_block": ("fused_sum", "fused_sum a block", EPI_SOURCE,
                        f"{_VBK}:454"),
    "fused_xpass_gm_shard": ("fused_xpass_gm", "fused_xpass_gm a shard",
                             EPI_SOURCE, f"{_VBK}:454"),
    "ml_hpass_shard": ("ml_hpass", "ml_hpass a shard", ML_SOURCE,
                       f"{_MLK}:83"),
    "ml_wpass_shard": ("ml_wpass", "ml_wpass a shard", ML_SOURCE,
                       f"{_MLK}:122"),
    "sp_rowpass_shard": ("sp_rowpass", "sp_rowpass a shard", SP_SOURCE,
                         "ccfindr_tpu/ops/tile.py:469"),
    "sp_colpass_shard": ("sp_colpass", "sp_colpass a shard", SP_SOURCE,
                         "ccfindr_tpu/ops/tile.py:469"),
    "ss_xpass_block": ("ss_xpass", "ss_xpass a block", P2_SOURCE,
                       f"{_VBK}:127"),
    "elbo_xpass_block": ("elbo_xpass", "elbo_xpass a block", P2_SOURCE,
                         f"{_VBK}:205")}
# phase 18's randomized SVD: the singular values of the card's float32
# range finder against the float64 host one on the same Omega
RSVD_S_TOL = 1e-3
GM_SHAPE = (100_000, 4_096, 16)  # phase 12's planted X (genes, cells, rank)
# the least time of a kernel (H100 SXM data sheet: float32 outside the
# tensor cores, HBM3)
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12  # the tensor cores, dense (P2's split-TF32 products)
HBM_BYTES = 3.35e12
# the card's issue rate in thread-instructions a second: 4 warp
# instructions a clock on each of 132 SMs, the rate at which the FP32
# pipes take one FMA (2 flops) a lane (67 TFLOP/s / 2).  The posterior
# kernels' (K2/K3, E2/E3, K3s) operations are the instructions their
# entries need on this run's data (Smoke.post_need, from E2's SASS)
INSTR_RATE = FP32_FLOPS / 2
KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
ATLAS = (20480, 100352, 20, 0.02)   # bench.py:696 shape, bench.py:330 density
# phase 22: the atlas workflow's scan at full width (the port's
# simulate_atlas, 20,480 x 100,352 int8, ranks 2..20 x 2 restarts = 38
# lanes of rp 24), the last lane against itself alone, K1-K4 at the shape
ATLAS_DEMO = "examples/atlas_demo_torch.py"
ATLAS_RANKS = tuple(range(2, 21))
ATLAS_ITMAX = 4          # (a)'s sweeps at Tol 0 (the demo runs up to 300)
ATLAS_LONE_ITMAX = 3     # (b)'s
# (b)'s ranks: each takes its own randomized SVD start over the dense X
# (~1.2 s a rank on the card, PR 16), so (b) scans 8..20, whose last
# lane (index 12) still sits in the second of two lane groups
ATLAS_LONE_RANKS = tuple(range(8, 21))
ATLAS_WINDOW = 2048      # (c)'s cells, where the plain sweep fits the card
MC_CARDS = 4             # phase 23's cards: min(MC_CARDS, the visible count)
MC_ITMAX = 100           # (d)'s sweeps at Tol 0, as phase 19's
MC_ATLAS = dict(base_cells=2048)   # (f)'s simulate_atlas: the full width
MC_ATLAS_ITMAX = 20      # (f)'s sweeps held to one card's bits
CHECK_CARDS = "tools/check_cards.py"
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
        build.launch("div_rn_check", x, w, n, out)
        fast += int((out > 0).sum())
        differ += int((out == 2).sum())
    return fast, differ, n * rounds


def sass_entry_instructions(prefix):
    """Instructions one thread issues for one entry of E2's gamma
    posterior, the float kernel whose mangled name holds ``prefix``, as
    ``(fixed, step)``: an entry issues ``fixed`` of them, plus ``step``
    for each step of the digamma shift chain it takes (specials.cuh: in
    float a step while its argument is below 6, at most 6; each step's
    division sits behind a branch that skips it).  Both come from the
    static SASS of this run's build (``cuobjdump -sass``): its entry loop
    (the loop with the longest body), less what only a division's slow
    path runs (the shortest forward branch over each CALL) and the
    bodies of nested loops; the shift steps are the other forward
    branches over exactly one CALL.  The entries an iteration takes are
    its global stores over three (e, ln and d)."""
    import os
    import re
    import shutil

    from ccfindr_tpu_torch.ops.kernels import build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", text)[1:]
             if prefix in f.split("\n", 1)[0]]
    if not funcs:
        raise RuntimeError(f"no SASS function matches {prefix}")
    ins, labels, pending = [], {}, []
    for line in funcs[0].splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            for lb in pending:
                labels[lb] = int(m.group(1), 16)
            pending = []
            ins.append((int(m.group(1), 16), m.group(2)))
    at = {a: i for i, (a, _) in enumerate(ins)}

    def target(t):
        b = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", t)
        if b is None:
            return None
        v = b.group(1)
        return at.get(labels.get(v) if v.startswith(".L") else int(v, 16))

    branches = [(i, target(t)) for i, (_, t) in enumerate(ins)
                if target(t) is not None]
    loops = [(j, i) for i, j in branches if j <= i]
    if not loops:
        raise RuntimeError(f"no loop in the SASS of {prefix}")
    lo, hi = max(loops, key=lambda p: p[1] - p[0])
    skip = set()
    for j, i in loops:                      # nested loops
        if lo <= j and i <= hi and (j, i) != (lo, hi):
            skip.update(range(j, i + 1))
    fwd = [(i, j) for i, j in branches if lo <= i <= hi and j > i]
    calls = [c for c in range(lo, hi + 1) if "CALL" in ins[c][1]]
    slow = set()
    for c in calls:                         # division slow paths
        over = [(j - i, i, j) for i, j in fwd if i < c < j]
        if over:
            _, i, j = min(over)
            slow.add((i, j))
            skip.update(range(i + 1, j))
    guards = [(i, j) for i, j in fwd if (i, j) not in slow and j <= hi
              and sum(i < c < j for c in calls) == 1]
    body = [q for q in range(lo, hi + 1) if q not in skip]
    stepped = {q for i, j in guards for q in range(i + 1, j)} - skip
    stores = sum(1 for q in body if re.search(r"\bSTG\b", ins[q][1]))
    if stores == 0 or stores % 3:
        raise RuntimeError(f"{stores} stores in the entry loop of {prefix}")
    entries = stores // 3
    if len(guards) != 6 * entries:
        raise RuntimeError(f"{len(guards)} shift steps in the entry loop of "
                           f"{prefix}, for {entries} entries")
    return ((len(body) - len(stepped)) / entries,
            len(stepped) / len(guards))


def ptxas_resources(key):
    """Registers and spill bytes of one kernel instantiation, from this
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


def post_case(rp, r, lanes, ext, nsfx, ndenom, dt, dev, seed=0):
    """Inputs of one posterior launch: sfx partials (B, nsfx, rp, ext),
    the factor (B, rp, ext) (rank rows >= r pad 0), denominator partials
    (B, ndenom, rp) and sc; lane b live up to rank lanes[b]."""
    import torch

    rng = np.random.default_rng(seed)
    nb = len(lanes)
    sfx = rng.gamma(1.0, 1.0 / nsfx, (nb, nsfx, rp, ext))
    lf = np.zeros((nb, rp, ext))
    lf[:, :r] = rng.gamma(1.0, 1.0, (nb, r, ext))
    denom = rng.gamma(2.0, 1.0, (nb, ndenom, rp))
    sc = np.zeros((nb, 8))
    sc[:, :4] = rng.uniform(0.5, 1.5, (nb, 4))
    sc[:, 4] = float(torch.finfo(dt).eps)
    sc[:, 5] = lanes
    sc[:, 7] = 1.0
    t = lambda a, d=dt: torch.as_tensor(a, dtype=d, device=dev)  # noqa
    return t(sfx), t(lf), t(denom, torch.float64), t(sc, torch.float64)


# post_kernel's edge cases at each launch site: (rp, r, the lanes' live
# ranks, ext, n_live, n_pin, nsfx, ndenom): every rp class (1, 8, 16,
# 24, 128), extents that are not a multiple of POST_COLS, r_live < r,
# n_live < n_pin (mesh cell padding, H only), nsfx 1 (E3), 16 (K3), 32
# (K2), ndenom 1 to 391 (E3 on E2's partials)
POST_CASES = {
    "w_post": [(1, 1, [1, 1, 1], 77, 77, 77, 1, 1),
               (8, 8, [8, 5, 3], 4096, 4096, 4096, 32, 32),
               (24, 20, [20, 17], 1000, 1000, 1000, 16, 1),
               (128, 128, [128, 100], 300, 300, 300, 3, 5)],
    "h_post": [(16, 16, [16, 12, 8], 8192, 8192, 8192, 16, 128),
               (16, 13, [13, 9], 2050, 2000, 2050, 16, 128),
               (128, 120, [120, 64], 129, 100, 129, 2, 3)],
    "epi_h_post": [(16, 16, [16, 12, 8], 4093, 4093, 4093, 1, 391),
                   (24, 20, [20, 17], 1000, 990, 1000, 1, 391),
                   (8, 8, [8, 5, 3], 447, 440, 447, 1, 1),
                   (128, 128, [128, 100], 300, 300, 300, 1, 3)],
    "h_post_shard": [(16, 16, [16, 12, 8], 2048, 2000, 2048, 16, 128),
                     (8, 8, [8, 5, 3], 112, 111, 112, 3, 2)],
    "w_post_mesh": [(16, 16, [16, 12, 8], 4096, 4096, 4096, 32, 32)],
}


def compare_post_cases(site):
    """post_kernel at ``site`` (K2 ``w_post``/``w_post_mesh``, K3
    ``h_post``, K3s ``h_post_shard``, E3 ``epi_h_post``) on POST_CASES
    against post_plain in float64 and float32: e, ln, d and the rank
    sums at phase 2's tolerances, one partial a POST_COLS block, two
    launches bit-identical, and lanes 1 and (0, B - 1) alone giving the
    batch's bits.  Prints a line a case; returns whether all held."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import epilogue as epi
    from ccfindr_tpu_torch.ops.kernels import sol
    from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh

    dev = torch.device("cuda")
    ok_all = True
    for rp, r, lanes, ext, n_live, n_pin, nsfx, nden in POST_CASES[site]:
        for dt in (torch.float64, torch.float32):
            sfx, lf, den, sc = post_case(rp, r, lanes, ext, nsfx, nden, dt,
                                         dev)
            ab = 0 if site.startswith("w_post") else 2
            if ab == 0:
                def launch(s_, l_, d_, c_):
                    return sol.w_post(s_, l_, d_, c_, r, n_live)
            elif site == "epi_h_post":
                def launch(s_, l_, d_, c_):
                    return epi.epi_h_post(s_[:, 0], l_, d_, c_, r, n_live,
                                          n_pin)
            elif site == "h_post_shard":
                def launch(s_, l_, d_, c_):
                    return ssh.h_post_shard(s_, l_, d_, c_, r, n_live, n_pin)
            else:
                def launch(s_, l_, d_, c_):
                    return sol.h_post(s_, l_, d_, c_, r, n_live, n_pin)
            got = launch(sfx, lf, den, sc)
            again = launch(sfx, lf, den, sc)
            torch.cuda.synchronize()
            a = [sc[:, q].to(dt) for q in range(6)]
            want = sol.post_plain(sfx.sum(1, dtype=torch.float64).to(dt), lf,
                                  den.sum(1), a[ab], a[ab + 1], a[4], a[5],
                                  r, n_live, npin=n_pin)
            tol = F64_TOL if dt == torch.float64 else F32_FACTOR_TOL
            err = max(rel_err(g, w) for g, w in zip(got[:3], want[:3]))
            rs = rel_err(got[3].sum(1), want[3])
            nblk = -(-ext // sol.POST_COLS)
            shapes = (got[3].shape == (len(lanes), nblk, rp)
                      and got[4].shape == (len(lanes), nblk, 4))
            det = all(torch.equal(u, v) for u, v in zip(got, again))
            alone = True
            for sub in ([1], [0, len(lanes) - 1]):
                idx = torch.tensor(sub, device=dev)
                one = launch(*(t[idx].contiguous() for t in (sfx, lf, den,
                                                             sc)))
                alone = alone and all(torch.equal(u[idx], v)
                                      for u, v in zip(got, one))
            ok = err <= tol and rs <= tol and shapes and det and alone
            print(f"  {site} rp {rp} r {r} lanes {lanes} ext {ext} live "
                  f"{n_live} pin {n_pin} nsfx {nsfx} ndenom {nden} "
                  f"{str(dt)[6:]}: {'ok' if ok else 'MISMATCH'} e/ln/d "
                  f"{err:.3g} rank sums {rs:.3g} partials {nblk} a lane "
                  f"{shapes} deterministic {det} lanes alone {alone}",
                  flush=True)
            ok_all = ok_all and ok
    return ok_all


def compare_finish_masks(parts_of, n, m, label):
    """K4 under each of the 16 hyper masks with niter 1 and 100, on the
    partials ``parts_of(dt)`` gives (xlog, csum, wscal, rsum, hscal and
    sc), in float64 and float32, against finish_plain: the hypers at
    phase 2's tolerances, the per-element ELBO, the failure flags; two
    launches and lane 1 alone bit-identical.  Returns whether all held."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sol

    ok_all = True
    for dt in (torch.float64, torch.float32):
        sc, *parts = parts_of(dt)
        tol = F64_TOL if dt == torch.float64 else F32_FACTOR_TOL
        etol = F64_TOL if dt == torch.float64 else F32_ELBO_TOL
        worst, fails = 0.0, []
        for mask in range(16):
            hm = tuple(bool(mask >> i & 1) for i in range(4))
            for niter in (1, 100):
                kw = dict(n=n, m=m, dt=dt, hyper_mask=hm,
                          newton_niter=niter, newton_tol=1e-4)
                got = sol.finish(sc, *parts, **kw)
                again = sol.finish(sc, *parts, **kw)
                one = sol.finish(sc[1:2], *(p[1:2].contiguous()
                                            for p in parts), **kw)
                torch.cuda.synchronize()
                want = sol.finish_plain(sc, *(p.sum(1) for p in parts), n,
                                        m, dt, hm, niter, 1e-4)
                hyp = [sol.AW, sol.BW, sol.AH, sol.BH]
                err = rel_err(got[:, hyp], want[:, hyp])
                elbo = rel_err((got[:, sol.PEND] + got[:, sol.DTERM])
                               / (n * m), (want[:, sol.PEND]
                                           + want[:, sol.DTERM]) / (n * m))
                ok = (err <= tol and elbo <= etol
                      and torch.equal(got[:, sol.HFAIL], want[:, sol.HFAIL])
                      and torch.equal(got, again)
                      and torch.equal(one, got[1:2]))
                worst = max(worst, err)
                if not ok:
                    fails.append((mask, niter, err, elbo))
        print(f"  K4 {label} {str(dt)[6:]}: 16 hyper masks x niter 1, 100 "
              f"{'ok' if not fails else f'MISMATCH {fails}'}; worst hyper "
              f"error {worst:.3g}; two launches and lane 1 alone "
              "bit-identical", flush=True)
        ok_all = ok_all and not fails
    return ok_all


def newton_iterations(sc, parts, **kw):
    """The Newton steps each lane of K4 took: the least niter - 1 at
    which its failure flag clears (99 + where it never does)."""
    from ccfindr_tpu_torch.ops.kernels import sol

    full = sol.finish(sc, *parts, **kw)
    iters = []
    for b in range(sc.shape[0]):
        if full[b, sol.HFAIL] > 0:
            iters.append(kw["newton_niter"] - 1)
            continue
        for niter in range(1, kw["newton_niter"] + 1):
            if sol.finish(sc, *parts, **dict(kw, newton_niter=niter))[
                    b, sol.HFAIL] == 0:
                iters.append(niter - 1)
                break
    return iters


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


def hold_k1(got, x, lwt, lh, eh, sc):
    """K1's partials ``got`` (one lane or a few) against
    ``sol.xpass_partials_plain`` on the same inputs, partial by partial,
    as :func:`compare_k1` holds them: (ok, swn/shn relative error, the
    per-element x*log(wth) error, the ehs error, the largest absolute
    error of the swn/shn partials)."""
    from ccfindr_tpu_torch.ops.kernels import sol

    want = sol.xpass_partials_plain(x, lwt, lh, eh, sc)
    part = max(rel_err(g, w) for g, w in zip(got[:2], want[:2]))
    xlog = float((got[2] - want[2]).abs().max()) / (x.shape[0] * x.shape[1])
    ehs = rel_err(got[3], want[3])
    ab = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    ok = (part <= F32_FACTOR_TOL and xlog <= F32_ELBO_TOL and ehs <= 1e-12
          and all(g.shape == w.shape for g, w in zip(got, want)))
    return ok, part, xlog, ehs, ab


def hold_post(got, sfx_part, lf, denom_part, sc, ab, r, ncol, nm):
    """K2 (``ab`` 0) or K3 (``ab`` 2) outputs ``got`` against post_plain
    on the same partials, which it adds in float64 as the kernel does (a
    lane at a time, so that no float64 copy of all lanes' partials is
    formed): e, ln, d and the rank sums at phase 2's factor tolerance,
    the four scalar sums per element of X (``nm``) at its ELBO
    tolerance.  Returns (ok, factor error, rank-sum error, scalar error,
    largest absolute error of e, ln, d)."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sol

    dt = lf.dtype
    sfx = torch.stack([p.sum(0, dtype=torch.float64)
                       for p in sfx_part]).to(dt)
    a = [sc[:, q].to(dt) for q in range(6)]
    want = sol.post_plain(sfx, lf, denom_part.sum(1), a[ab], a[ab + 1],
                          a[4], a[5], r, ncol)
    fac = max(rel_err(g, w) for g, w in zip(got[:3], want[:3]))
    rs = rel_err(got[3].sum(1), want[3])
    scal = float((got[4].sum(1) - want[4]).abs().max()) / nm
    absd = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    ok = (fac <= F32_FACTOR_TOL and rs <= F32_FACTOR_TOL
          and scal <= F32_ELBO_TOL
          and all(bool(torch.isfinite(t).all()) for t in got))
    return ok, fac, rs, scal, absd


def hold_finish(k4, sc, parts, n, m, dt):
    """K4's ``k4`` against finish_plain on the summed partials, as
    :func:`compare_finish_masks` holds it (every hyper updated, niter
    100): (ok, hyper error, per-element ELBO error, largest absolute
    error of the hypers and the per-element ELBO)."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sol

    want = sol.finish_plain(sc, *(p.sum(1) for p in parts), n, m, dt,
                            (True,) * 4, 100, 1e-4)
    hyp = [sol.AW, sol.BW, sol.AH, sol.BH]
    err = rel_err(k4[:, hyp], want[:, hyp])
    ge = (k4[:, sol.PEND] + k4[:, sol.DTERM]) / (n * m)
    we = (want[:, sol.PEND] + want[:, sol.DTERM]) / (n * m)
    elbo = rel_err(ge, we)
    ab = max(float((k4[:, hyp] - want[:, hyp]).abs().max()),
             float((ge - we).abs().max()))
    ok = (err <= F32_FACTOR_TOL and elbo <= F32_ELBO_TOL
          and torch.equal(k4[:, sol.HFAIL], want[:, sol.HFAIL]))
    return ok, err, elbo, ab


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
    """E2 + E3 vs their plain version on the plain X pass's outputs, a
    second launch for bit-identity, E2's e, lwn and d against K2's on
    the transposed layout (the same expressions an entry: the same
    bits), and lanes 1 and B - 1 of E2 alone and as a pair against the
    batch's bits."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import epilogue as epi
    from ccfindr_tpu_torch.ops.kernels import sol

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
    k2 = sol.w_post(swn.transpose(-1, -2).contiguous()[:, None],
                    lw.transpose(-1, -2).contiguous(), ehs[:, None], sc, r,
                    n)
    k2_bits = all(torch.equal(g, v.transpose(-1, -2))
                  for g, v in zip(w[:3], k2[:3]))
    alone = lanes_alone(
        lambda s_, l_, e_, c_: epi.epi_w_post(s_, l_, e_, c_, r, n),
        (swn, lw, ehs[:, None].contiguous(), sc),
        lanes=(1, lw.shape[0] - 1))
    abs_err = {"epi_w_post": max(float((g - v).abs().max())
                                 for g, v in zip(got[:3], want[:3])),
               "epi_h_post": max(float((g - v).abs().max())
                                 for g, v in zip(got[4:7], want[5:8]))}
    return dict(ok=all(v <= tol for v in err.values()) and det and k2_bits
                and alone, err=err, abs_err=abs_err, deterministic=det,
                k2_bits=k2_bits, lanes_alone=alone)


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


def compare_lanes(x, w, h):
    """M1's hn, xlog and partials and M2's wn of one launch each."""
    from ccfindr_tpu_torch.ops.kernels import ml as mlk

    hn, xlw, part = mlk.ml_hpass(x, w, h)
    return hn, xlw, part, mlk.ml_wpass(x, w, h)


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
    d = fold_dterm(swn, shn, lw, lh, xlog) / nm
    d_p = fold_dterm(swn_p, shn_p, lw, lh, xlog_p) / nm
    err = dict(swn=rel_err(swn, swn_p), a=rel_err(a, a_p),
               shn=rel_err(shn, shn_p), dterm=rel_err(d, d_p))
    if lw.shape[-1] == 1:
        # at r = 1 the fold cancels to zero (swn lw log lw + shn lh log lh
        # = sum x log(lw lh)): the term is held to its x log wth summand
        scale = torch.maximum(d_p.double().abs(), xlog_p.abs() / nm)
        err["dterm"] = float(((d.double() - d_p.double()).abs()
                              / scale).max())
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


def skewed_csr(n, m, seed):
    """A 10%-density Poisson CSR with empty rows (3 and n - 2), an empty
    column (5) and one row full but for that column (7, m - 1
    nonzeros): S1's skew case."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < 0.1) * rng.poisson(3.0, (n, m))
    x[7] = rng.poisson(3.0, m) + 1
    x[[3, n - 2]] = 0
    x[:, 5] = 0
    return sps.csr_matrix(x.astype(np.float64))


def skewed_csc(n, m, seed):
    """:func:`skewed_csr` transposed, n genes x m cells: empty columns
    (3 and m - 2), an empty row (5) and one column full but for that row
    (7, n - 1 nonzeros): S2's skew case."""
    return skewed_csr(m, n, seed).T.tocsr()


def compare_colpass(tc, lw, lh, dt, bf16=False):
    """S2 alone against colpass_plain on the same a (S1's), a second
    launch for bit-identity, and lanes 1 and B - 1 alone and as a pair
    against the batch's bits."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sparse as spk

    lht = lh.transpose(-1, -2).contiguous()
    a = spk.sp_rowpass(tc, lw, lht, mxu_bf16=bf16)[1]
    shn = spk.sp_colpass(tc, a, lw, mxu_bf16=bf16)
    again = spk.sp_colpass(tc, a, lw, mxu_bf16=bf16)
    torch.cuda.synchronize()
    want = spk.colpass_plain(tc, a, lw, mxu_bf16=bf16)
    err = rel_err(shn, want)
    det = torch.equal(shn, again)
    alone = lanes_alone(
        lambda a_, w_: (spk.sp_colpass(tc, a_, w_, mxu_bf16=bf16),),
        (a, lw), lanes=(1, lw.shape[0] - 1))
    tol = F64_TOL if dt == torch.float64 and not bf16 else F32_FACTOR_TOL
    return dict(ok=err <= tol and det and alone
                and bool(torch.isfinite(shn).all()), err=err,
                deterministic=det, lanes_alone=alone)


def lanes_alone(launch, args, lanes=(1, 4)):
    """Whether lanes 1 and 4 of a batch, launched alone and as a pair
    (``launch(*args)`` on the lane-sliced factor tensors ``args``),
    give the batch's bits in every output."""
    import torch

    full = launch(*args)
    same = True
    for sub in ([lanes[0]], [lanes[1]], list(lanes)):
        idx = torch.tensor(sub, device=args[0].device)
        part = launch(*(a[idx].contiguous() for a in args))
        same = same and all(torch.equal(f[idx], q)
                            for f, q in zip(full, part))
    return same


def compare_p2(x, lw, lh, dt):
    """P2 alone (with its tail) against elbo_data_plain: the data term's
    error relative to the term, or at r = 1 (where S / wth - log wth is
    0 in exact arithmetic and the term is rounding noise) relative to
    its summands' scale sum x |log wth|; the tail as M1's; two launches
    and X zero-padded and read in place give the same bits."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

    lwl, lhl = vbk.xlogx(lw), vbk.xlogx(lh)
    out, part = vbk.elbo_xpass(x, lw, lwl, lh, lhl)
    again = vbk.elbo_xpass(x, lw, lwl, lh, lhl)
    padded = vbk.elbo_xpass(vbk.pad_matrix(x, 64, 1024), lw, lwl, lh, lhl)
    torch.cuda.synchronize()
    d_p = vbk.elbo_data_plain(x, lw, lh)
    n, m = x.shape
    scale = d_p.abs()
    if lw.shape[-1] == 1:
        wth = lw.double() @ lh.double()
        scale = (x[:n, :m].double() * wth.log().abs()).sum((-2, -1))
    err = float(((out - d_p).abs() / scale).max())
    tail_ok, tail_err, _ = tail_check(out, part)
    tol = F64_TOL if dt == torch.float64 else F32_ELBO_TOL
    det = torch.equal(out, again[0]) and torch.equal(part, again[1])
    pad_same = torch.equal(out, padded[0]) and torch.equal(part, padded[1])
    ok = err <= tol and tail_ok and det and pad_same and bool(
        torch.isfinite(out).all())
    return dict(ok=ok, err=err, tail=tail_err, deterministic=det,
                padded_same=pad_same, parts=tuple(part.shape))


def s2_library(tc, a, lw):
    """One PyTorch call computing S2's function on the same inputs, as
    phase 10 times it: a block-diagonal CSR (lane b's block the pattern
    of X^T holding its a) times the lanes' lw rows, torch.sparse.mm.
    Returns the call."""
    import torch

    nbl, nnz = a.shape
    n, m, r = tc.n, tc.m, lw.shape[-1]
    rows = tc.csr_rows()
    off = torch.arange(nbl, device=a.device)[:, None]
    blk = torch.sparse_coo_tensor(
        torch.stack([(tc.col.long()[None] + off * m).reshape(-1),
                     (rows[None] + off * n).reshape(-1)]),
        a.reshape(-1), (nbl * m, nbl * n)).coalesce().to_sparse_csr()
    lw_flat = lw.reshape(nbl * n, r)
    return lambda: torch.sparse.mm(blk, lw_flat)


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

    tiles = dict(n=n, m=m, r=r, bn=vbk.DEFAULT_BN, bm=vbk.DEFAULT_BM)

    def launch(xx):
        swn, shn = vbk.suffstats_pallas_padded(xx, lw, lh, chunk=chunk,
                                               **tiles)
        return swn, shn, vbk.elbo_data_pallas_padded(xx, lw, lh, **tiles)

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


def kernel_ms(fn, reps=20):
    """Device milliseconds a launch of ``fn`` (one kernel launch a call):
    ``reps`` calls captured in a CUDA graph and replayed, timed by CUDA
    events, the median of three replays.  The replay issues the launches
    back to back from the device, so a kernel shorter than the host's
    call is timed by its own length, where :func:`cuda_ms` can time the
    host's issue of the call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(3):
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / reps)
    del g
    return float(np.median(ms))


def sync_cards():
    """Wait for the work queued on every card."""
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def card_trace(fn):
    """``fn()`` under torch.profiler, the cell-sharded sweep's gathers
    marked: (its result, the reading), the reading None where the
    profiler saw no device event.  The reading gives for each card the
    kernels it ran, the union of its device events within the window
    from the first to the last of the port's kernels on any card (the
    loop: the set-up's copies and casts fall outside it) and its share
    of the window, its peer copies and its five longest kernels by total
    time (count, ms); and the gathers' device time
    (``sol_sharded.gather``'s copies, summed over the cards) and the
    bytes they took from other cards."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh

    orig = ssh.gather
    moved = [0]

    def gather(parts, dim, dev):
        moved[0] += sum(p.numel() * p.element_size() for p in parts
                        if p.device != torch.device(dev))
        with record_function("sol_sharded.gather"):
            return orig(parts, dim, dev)

    ssh.gather = gather
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            sync_cards()
    finally:
        ssh.gather = orig
    # the marked range shows on the cards too, as a span around its
    # copies: it is neither busy time nor a kernel, and its device time
    # is taken once, from the host-side range's kernels
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name != "sol_sharded.gather"]
    if not evs:
        return out, None
    ours = [e for e in evs if "ccfindr::" in e.name] or evs
    w0 = min(e.time_range.start for e in ours)
    w1 = max(e.time_range.end for e in ours)
    span = w1 - w0
    cards = {}
    for d in sorted({e.device_index for e in evs}):
        mine = [e for e in evs if e.device_index == d]
        busy, end = 0, w0
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in mine):
            b = min(b, w1)
            busy += max(0, b - max(a, end))
            end = max(end, b)
        copies = [e for e in mine if "PtoP" in e.name]
        kern = [e for e in mine
                if not e.name.startswith(("Memcpy", "Memset"))]
        by = {}
        for e in kern:
            n, t = by.get(e.name, (0, 0.0))
            by[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
        cards[d] = dict(
            launches=len(kern), busy_ms=busy / 1e3, share=busy / span,
            p2p=len(copies),
            p2p_ms=sum(e.time_range.elapsed_us() for e in copies) / 1e3,
            top=sorted(by.items(), key=lambda kv: -kv[1][1])[:5])
    gms = sum(e.device_time_total for e in prof.events()
              if e.name == "sol_sharded.gather"
              and e.device_type != DeviceType.CUDA)
    return out, dict(span_ms=span / 1e3, cards=cards, gather_ms=gms / 1e3,
                     gather_gb=moved[0] / 1e9)


def peer_rate(src, dst, gib=1):
    """The copy rate of ``gib`` GiB from card ``src`` to card ``dst`` (a
    contiguous copy, the median of five, CUDA events on the source), as
    a line: it tells NVLink (hundreds of GB/s) from PCIe (tens)."""
    import torch

    a = torch.empty(gib << 28, dtype=torch.float32, device=f"cuda:{src}")
    b = torch.empty_like(a, device=f"cuda:{dst}")
    b.copy_(a)
    sync_cards()
    ms = []
    with torch.cuda.device(src):
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            b.copy_(a)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    sync_cards()
    rate = gib * 2 ** 30 / (np.median(ms) / 1e3) / 1e9
    return (f"cuda:{src} -> cuda:{dst} {gib} GiB in {np.median(ms):.3f} ms "
            f"= {rate:.1f} GB/s")


def drive_mesh(mods, fn, x, **kw):
    """The call on one device, then on the mesh with the launch counts
    of ``mods`` set to 0 just before it and read just after: (one
    device's result, the mesh's, the mesh call's seconds, its nonzero
    counts)."""
    one = fn(x, **{k: v for k, v in kw.items() if k != "mesh"})
    for mod in mods:
        mod.reset_launches()
    sync_cards()
    t0 = time.perf_counter()
    got = fn(x, **kw)
    sync_cards()
    secs = time.perf_counter() - t0
    counts = {}
    for mod in mods:
        counts.update({k: v for k, v in mod.LAUNCHES.items() if v})
    return one, got, secs, counts


def close_to_one(one, got, label, secs, counts, ropt=True,
                 tol=(F32_ELBO_TOL, F32_FACTOR_TOL)):
    """A mesh run's result against one device's (phase 19's gate): lml
    or likelihood within ``tol[0]`` relative, the factors within
    ``tol[1]`` of their largest entry, and (``ropt``) the same optimal
    rank; prints both with whether the bits are the same."""
    import ccfindr_tpu_torch as ct

    col = "lml" if "lml" in one.measure else "likelihood"
    lerr = float(np.max(np.abs(got.measure[col] - one.measure[col])
                        / np.abs(one.measure[col])))
    ferr = max(float(np.abs(u - v).max() / np.abs(v).max())
               for f in ("basis", "coeff")
               for u, v in zip(getattr(got, f), getattr(one, f)))
    same = None
    if ropt:
        same = (ct.optimal_rank(got)["ropt"]
                == ct.optimal_rank(one)["ropt"])
    bits = (np.array_equal(got.measure[col], one.measure[col])
            and all(np.array_equal(u, v) for u, v in
                    zip(got.basis, one.basis)))
    nit = (batch_record(got) if col == "likelihood"
           else got.metadata["timings"][0])["n_iter"]
    print(f"  {label}: {secs:.2f} s on the mesh; against one "
          f"device: {col} rel {lerr:.3g}, factors rel {ferr:.3g}, "
          f"same ropt {same}, bit-identical {bits}; n_iter {nit}; "
          f"launches {counts}", flush=True)
    return lerr <= tol[0] and ferr <= tol[1] and same is not False


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
        self.kernels["epi_w_post"]["source"] = E2_SOURCE
        self.kernels.update({k: dict(name=k, route="cuda", source=P2_SOURCE,
                                     replaces=rep)
                             for k, rep in P2_KERNELS.items()})
        self.kernels.update({k: dict(name=name, route="cuda", source=SOURCE,
                                     replaces=rep)
                             for k, (name, rep) in MESH_KERNELS.items()})
        self.kernels.update({k: dict(name=name, route="cuda", source=src,
                                     replaces=rep)
                             for k, (_, name, src, rep)
                             in MESH_SITES.items()})
        self.kernels.update({k: dict(name=f"{k[:-4]} at the ELL site",
                                     route="cuda", source=SP_SOURCE,
                                     replaces=rep)
                             for k, rep in ELL_SITES.items()})
        self.kernels.update({f"{k}_atlas": dict(
            name=f"sol_{k} at the atlas shape", route="cuda", source=SOURCE,
            replaces=REPLACES) for k in KERNELS})
        for k, what in TAILS.items():
            self.kernels[k]["tail"] = (f"its last block of a lane adds "
                                       f"{what} (M3 folded in)")
        self.failed = []
        self.filtered = None     # the bundled data after QC (phase 3)
        self.vb_result = None    # phase 3's VB scan, for phase 6's GSEA
        self.x10 = None          # the planted 10x matrix (phase 4)
        self.x10m = None         # it masked to 10% density (phase 8)
        self.xgm = None          # phase 12's gene-major X (phase 11)
        self.atlas = None        # phase 10's atlas CSR (phase 18)
        self.sass = {}           # post_need's SASS counts

    def post_need(self, sfx, lf, a, r_live, n_live, rank_axis):
        """Instructions the gamma posterior needs on these float inputs
        (``sfx``, ``lf`` (B, ., .) with the rank along ``rank_axis``,
        ``a`` and ``r_live`` (B,), ``n_live`` the live extent of the
        other axis): for each live entry E2's ``fixed`` of them, plus
        ``step`` for each shift step its ``al = a + lf sfx`` takes
        (sass_entry_instructions, one count for every posterior kernel,
        cached).  Pinned and padding entries need only their stores,
        which the bytes bound holds."""
        import torch

        if lf.dtype != torch.float32:
            raise ValueError("the SASS count is of the float kernel")
        if not self.sass:
            f, s = sass_entry_instructions(XPASS_ENTRIES["epi_w_post"])
            self.sass.update(fixed=f, step=s)
            print(f"  SASS epi_w_post: {f:g} instructions an entry and "
                  f"{s:g} a shift step it takes (the entry loop of "
                  f"{XPASS_ENTRIES['epi_w_post']}, float)", flush=True)
        shape, cshape = [1, 1, 1], [1, 1, 1]
        shape[rank_axis] = cshape[3 - rank_axis] = -1
        rank = torch.arange(lf.shape[rank_axis], device=lf.device)
        col = torch.arange(lf.shape[3 - rank_axis], device=lf.device)
        live = ((rank.view(shape) < r_live.to(lf.dtype).view(-1, 1, 1))
                & (col.view(cshape) < n_live))
        xs = a.to(lf.dtype).view(-1, 1, 1) + lf * sfx
        steps = torch.zeros(xs.shape, dtype=torch.int32, device=xs.device)
        for _ in range(6):                  # specials.cuh, float
            lt = xs < 6
            steps += lt
            xs = torch.where(lt, xs + 1, xs)
        nlive, nstep = int(live.sum()), int(steps[live].sum())
        return self.sass["fixed"] * nlive + self.sass["step"] * nstep

    def set_bound(self, k, moved, flops, library_ms=None, peak=FP32_FLOPS):
        """The kernel's least time on the card, the larger of ``moved``
        bytes over the HBM rate and ``flops`` over the peak rate of
        their type (FP32 unless ``peak`` says otherwise), and the time
        of one PyTorch call computing the same function."""
        tb = moved / HBM_BYTES * 1e3
        tf = flops / peak * 1e3
        self.kernels[k].update(bound_ms=max(tb, tf),
                               bound_by="bytes" if tb >= tf else "operations",
                               library_ms=library_ms)

    def time_kernel(self, k, fn, reps):
        """The kernel's ``ms``: for the posterior kernels and K4, whose
        launches are shorter than the host's call, a launch's device time
        from a CUDA graph (:func:`kernel_ms`), with the call's time by
        CUDA events kept as ``call_ms``; for the others the time by CUDA
        events."""
        kd = self.kernels[k]
        kd["ms"] = cuda_ms(fn, reps)
        if k in GRAPH_TIMED:
            kd["call_ms"] = kd["ms"]
            kd["ms"] = kernel_ms(fn, reps)

    def post_floor(self, k, *ts):
        """The bytes ``ts`` (the partials a posterior kernel or K4 reads
        and writes, its factors and outputs) over the HBM rate, kept
        beside the bound as ``floor_ms`` and printed."""
        kd = self.kernels[k]
        kd["floor_ms"] = nbytes(*ts) / HBM_BYTES * 1e3
        print(f"  {kd['name']}: {kd['ms']:.4f} ms; bound {kd['bound_ms']:.4f}"
              f" ms ({kd['bound_by']}); its partials' bytes "
              f"{nbytes(*ts) / 1e6:.2f} MB -> floor {kd['floor_ms']:.4f} ms",
              flush=True)

    def post_ptxas(self, post_keys, fin_key=None):
        """ptxas's registers and spills of post_kernel (and K4) in float
        and double, printed and kept on the kernels' entries."""
        res = {k: ptxas_resources(k) for k in POST_PTXAS}
        for k, v in res.items():
            print(f"  ptxas {k}: {v}", flush=True)
        for k in post_keys:
            self.kernels[k]["ptxas"] = {t: res[f"post_kernel {t}"]
                                        for t in ("float", "double")}
        if fin_key is not None:
            self.kernels[fin_key]["ptxas"] = {
                t: res[f"finish_kernel {t}"] for t in ("float", "double")}

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
            out = sol.vb_run_sol(x, st, hy, itmax=100, rank_mask=rmask,
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
            self.time_kernel(k, kern, 20)
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
                       self.post_need(p1[0], lwt, a[0], a[5], n, 1),
                       peak=INSTR_RATE)
        self.set_bound("h_post", nbytes(p1[1], lh, p2[3], sc, p3),
                       self.post_need(p1[1], lh, a[2], a[5], m, 1),
                       peak=INSTR_RATE)
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

        # K2/K3 (post_kernel, POST_COLS columns a block) and K4: the bytes
        # of the partials they read and write beside the bound, ptxas,
        # K4's sums alone (hyper_mask all False) and the Newton steps
        fin_parts = (k1[2], k2[3], k2[4], k3[3], k3[4])
        self.post_floor("w_post", k1[0], lwt, k1[3], sc, k2)
        self.post_floor("h_post", k1[1], lh, k2[3], sc, k3)
        self.post_floor("finish", sc, *fin_parts, fin_out)
        kf = self.kernels["finish"]
        kf["sums_ms"] = kernel_ms(lambda: sol.finish(
            sc, *fin_parts, **dict(fin, hyper_mask=(False,) * 4)))
        kf["newton_steps"] = newton_iterations(sc, fin_parts, **fin)
        print(f"  K4: {kf['ms']:.4f} ms, with hyper_mask all False (the "
              f"sums alone) {kf['sums_ms']:.4f} ms; Newton steps a lane "
              f"{kf['newton_steps']}", flush=True)
        self.post_ptxas(("w_post", "h_post"), "finish")
        ok = compare_post_cases("w_post")
        ok = compare_post_cases("h_post") and ok

        def parts_of(dt):
            x_np = planted(1030, 2100, 8, seed=9)
            xx, lwt_, lh_, eh_, sc_, _ = sweep_inputs(
                x_np, [16, 12, 8], 16, dt, torch.int8, 1.0, 9, dev)
            p1 = sol.xpass(xx, lwt_, lh_, eh_, sc_)
            p2 = sol.w_post(p1[0], lwt_, p1[3], sc_, 16, 1030)
            p3 = sol.h_post(p1[1], lh_, p2[3], sc_, 16, 2100)
            return sc_, p1[2], p2[3], p2[4], p3[3], p3[4]

        return compare_finish_masks(parts_of, 1030, 2100,
                                    "(1030 x 2100, 3 lanes rp 16)") and ok


    # -- 5 ------------------------------------------------------------
    def ml_kernel_vs_plain(self):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        allx = (torch.int8, torch.int16, torch.float32, torch.float64)
        banded = planted(600, 900, 5, seed=3)
        banded[64:128] = 0            # a 64-row and a 64-column band of
        banded[:, 128:192] = 0        # zeros: whole tiles of x = 0
        cases = [("ragged", planted(737, 450, 5, seed=1),
                  [rk for rk in range(4, 7) for _ in range(4)], 6, allx),
                 ("10x", planted(4096, 8192, 16, seed=2), [16] * 3, 16,
                  (torch.int8, torch.float32)),
                 ("r1", planted(300, 700, 1, seed=4), [1] * 3, 1, allx),
                 ("r17 zero bands", banded, [17, 12, 5], 17, allx),
                 ("r128", planted(257, 1100, 8, seed=5), [128, 100], 128,
                  (torch.int8, torch.float64))]
        ok_all = True
        for cname, x_np, ranks, r, xdts in cases:
            for dt in (torch.float64, torch.float32):
                for xdt in xdts:
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
        # a lane's bits do not depend on its batch (the chunks are
        # constants): lanes 1 and 4 of six, alone and as a pair
        x, w, h = ml_inputs(planted(1000, 1500, 16, seed=6),
                            [16, 12, 8, 16, 12, 8], 16, torch.float32,
                            torch.int8, 6, dev)
        full = compare_lanes(x, w, h)
        indep = True
        for sub in ([1], [4], [1, 4]):
            idx = torch.tensor(sub, device=dev)
            part = compare_lanes(x, w[idx].contiguous(), h[idx].contiguous())
            indep = indep and all(torch.equal(f[idx], q)
                                  for f, q in zip(full, part))
        print(f"  lanes 1, 4 of six alone and as a pair: the bits of the "
              f"batch {indep}", flush=True)
        for k in ML_KERNELS:
            res = ptxas_resources(k)
            print(f"  ptxas {k} (float32, int8 X): {res}", flush=True)
            self.kernels[k]["ptxas"] = res
        return ok_all and indep

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
        dense = 4 * 16 * n * m * nb
        for k in ML_KERNELS:
            print(f"  {k}: bound {self.kernels[k]['bound_ms']:.4f} ms "
                  f"({self.kernels[k]['bound_by']}), library "
                  f"{self.kernels[k]['library_ms']}, "
                  f"{dense / self.kernels[k]['ms'] / 1e9:.2f} TFLOP/s of "
                  f"dense work ({dense / 1e9:.1f} GFLOP)")
        print(f"  lane-sweeps/s kernel {runs['kernel']} plain "
              f"{runs['plain']}")
        return bool(np.isfinite(f.measure.drop(columns="rank").values).all())


    # -- 8 ------------------------------------------------------------
    def sparse_kernel_vs_plain(self):
        import torch

        from ccfindr_tpu_torch.ops.kernels import sparse as spk

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
        # S1 on both sides of its dispatch by r (a thread a nonzero up to
        # r 32, the group walk above), on a CSR with empty rows and a
        # row of 4,999 nonzeros; S2 beside it
        skew = skewed_csr(300, 5000, 12)
        for r in R_CASES:
            for dt in (torch.float64, torch.float32):
                tc, lw, lh = sparse_inputs(skew, [r, max(1, r - 5), r], r,
                                           dt, torch.int16, 13, dev)
                res = compare_sparse(tc, lw, lh, 1, dt)
                print(f"  skewed r={r} {str(dt)[6:]}: "
                      f"{'ok' if res['ok'] else 'MISMATCH'} "
                      + " ".join(f"{k}={v:.3g}"
                                 for k, v in res["err"].items())
                      + f" deterministic={res['deterministic']}",
                      flush=True)
                ok_all = ok_all and res["ok"]
                del tc, lw, lh
        # a lane's bits do not depend on its batch: lanes 1 and 4 of six
        # alone and as a pair
        tc, lw, lh = sparse_inputs(skewed_csr(1000, 1500, 14),
                                   [16, 12, 8, 16, 12, 8], 16, torch.float32,
                                   torch.int16, 15, dev)
        indep = lanes_alone(lambda w, h: spk.sp_rowpass(tc, w, h),
                            (lw, lh.transpose(-1, -2).contiguous()))
        print(f"  S1: lanes 1, 4 of six alone and as a pair: the bits of the "
              f"batch {indep}", flush=True)
        # S2 at each of its register widths and on the group walk, on a
        # CSC with empty columns and a column of 999 nonzeros
        ok_s2 = self.colpass_cases(False)
        for key in SP_KERNELS:
            res = ptxas_resources(key)
            print(f"  ptxas {key} (float32, int16 values, r 16): {res}",
                  flush=True)
            self.kernels[key]["ptxas"] = res
        print(f"  tolerances: f64 {F64_TOL:g}; f32 swn/a/shn "
              f"{F32_FACTOR_TOL:g}, data term per element {F32_ELBO_TOL:g}")
        return ok_all and indep and ok_s2

    def colpass_cases(self, bf16):
        """S2 alone (compare_colpass) at S2_R_CASES on the skewed CSC
        (1000 genes x 5000 cells), four lanes, factors float64 and
        float32; ``bf16`` in its mxu_bf16 mode."""
        import torch

        skew = skewed_csc(1000, 5000, 16)
        ok = True
        for r in S2_R_CASES:
            for dt in (torch.float64, torch.float32):
                tc, lw, lh = sparse_inputs(
                    skew, [r, max(1, r - 5), r, max(1, r - 2)], r, dt,
                    torch.int16, 17, torch.device("cuda"))
                res = compare_colpass(tc, lw, lh, dt, bf16)
                print(f"  S2 skewed columns r={r} {str(dt)[6:]}"
                      f"{' bf16' if bf16 else ''}: "
                      f"{'ok' if res['ok'] else 'MISMATCH'} shn="
                      f"{res['err']:.3g} deterministic={res['deterministic']}"
                      f" lanes alone={res['lanes_alone']}", flush=True)
                ok = ok and res["ok"]
                del tc, lw, lh
        return ok

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
        # the rows each gathers: a factor row of r values a nonzero and lane
        gathered = a.numel() * 16 * lw.element_size()
        for k in timed_k:
            self.kernels[k]["gathered_gb_s"] = (
                gathered / self.kernels[k]["ms"] / 1e6)
            print(f"  {k}: {self.kernels[k]['gathered_gb_s']:.1f} GB/s of "
                  f"gathered factor rows ({gathered / 1e9:.3f} GB)",
                  flush=True)
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
        big = self.atlas = atlas_csr(an, am_, ar, dens)
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
                              + f" deterministic={res['deterministic']}"
                              f" E2==K2 bits={res['k2_bits']} lanes "
                              f"alone={res['lanes_alone']}", flush=True)
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
        for key in ("fused_xpass_gm", "fused_xpass_cm", "epi_w_post"):
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
        # E3 (post_kernel on E2's partials) at its edge cases
        ok_e3 = compare_post_cases("epi_h_post")
        return ok_all and ok_cm and ok64 and div_ok and ok_e3

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
            self.time_kernel(k, kern, reps)
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
        # E2's and E3's operations are the instructions their live
        # entries need on these inputs (post_need), at INSTR_RATE; their
        # bytes are the function's (the reduced csum and scalars, not
        # the per-block partials)
        self.set_bound("epi_w_post", nbytes(swn, lw, ehs, sc, e2[:3],
                                            e2[3].sum(1), e2[4].sum(1)),
                       self.post_need(swn, lw, a[0], a[5], n, 2),
                       peak=INSTR_RATE)
        self.set_bound("epi_h_post", nbytes(shn, lh, e2[3].sum(1), sc,
                                            e3[:3], e3[3].sum(1),
                                            e3[4].sum(1)),
                       self.post_need(shn, lh, a[2], a[5], m, 1),
                       peak=INSTR_RATE)
        for k in timed:
            kk = self.kernels[k]
            print(f"  {k}: kernel {kk['ms']:.4f} ms, plain "
                  f"{kk['plain_ms']:.4f} ms, bound {kk['bound_ms']:.4f} ms "
                  f"({kk['bound_by']}), library {kk['library_ms']}",
                  flush=True)
        self.post_floor("epi_h_post", shn, lh, e2[3], sc, e3)
        self.post_ptxas(("epi_h_post",))
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
        # P2 on both sides of its rank slabs (32) and at r 1, on a 300 x
        # 2500 X: neither extent a multiple of the strip (64 genes x 1024
        # cells) nor of its 64-cell steps
        x_np = planted(300, 2500, 5, seed=12)
        for r in R_CASES:
            for dt in (torch.float64, torch.float32):
                x, lw, lh = pass2_inputs(x_np, [r, max(1, r - 5), r], r, dt,
                                         13, dev)
                res = compare_p2(x, lw, lh, dt)
                print(f"  P2 300 x 2500 r={r} {str(dt)[6:]}: "
                      f"{'ok' if res['ok'] else 'MISMATCH'} dterm="
                      f"{res['err']:.3g} tail={res['tail']:.3g} "
                      f"deterministic={res['deterministic']} padded_same="
                      f"{res['padded_same']} partials {res['parts']}",
                      flush=True)
                ok_all = ok_all and res["ok"]
                del x, lw, lh
        # a lane's bits do not depend on its batch: lanes 1 and 4 of six
        # alone and as a pair
        x, lw, lh = pass2_inputs(planted(1000, 1500, 16, seed=6),
                                 [16, 12, 8, 16, 12, 8], 16, torch.float32,
                                 14, dev)
        indep = lanes_alone(
            lambda w, h: vbk.elbo_xpass(x, w, vbk.xlogx(w), h, vbk.xlogx(h)),
            (lw, lh))
        print(f"  P2: lanes 1, 4 of six alone and as a pair: the bits of the "
              f"batch {indep}", flush=True)
        del x, lw, lh
        print(f"  tolerances: f64 {F64_TOL:g}; f32 sw/sh {F32_FACTOR_TOL:g}, "
              f"data term {F32_ELBO_TOL:g}")
        return ok_all and indep

    def pass2_times(self, x, lw, lh):
        """P1's and P2's times at the 10x shape (3 lanes of r = 16,
        float32), their plain versions' and their bounds: the products
        are needed at the nonzeros of X only, 6 r flops a nonzero and
        lane each (P1: wth, swn, shn on the FP32 pipes; P2: wth and the
        two halves of S, three split-TF32 MMAs each on the tensor
        cores)."""
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
        # P2's float products are split-TF32 on the tensor cores: three
        # MMAs for each of the three products, at TF32's rate
        self.set_bound("elbo_xpass", nbytes(x, lw, lwl, lh, lhl, p2),
                       3 * 6 * r * nnz * nb, peak=TF32_FLOPS)
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
        # P2: dense work 6 r flops an element and lane (wth and S's two
        # products), at its time
        kk = self.kernels["elbo_xpass"]
        kk["tflops_dense"] = 6 * r * n * lh.shape[-1] * nb / kk["ms"] / 1e9
        kk["ptxas"] = ptxas_resources("elbo_xpass")
        print(f"  P2 strips {vbk.P2_BAND} genes x {vbk.P2_CHUNK} cells: "
              f"{nb * vbk.elbo_part_width(n, lh.shape[-1])} blocks, "
              f"{kk['tflops_dense']:.2f} TFLOP/s of dense work (6 r flops an "
              f"element and lane); ptxas (float32 X and factors, split-TF32) "
              f"{kk['ptxas']}", flush=True)

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
        # S1 in bf16 on both sides of its dispatch by r, on phase 8's
        # skewed CSR (empty rows, a row of 4,999 nonzeros)
        skew = skewed_csr(300, 5000, 12)
        for r in R_CASES:
            for dt in (torch.float64, torch.float32):
                tc, lw, lh = sparse_inputs(skew, [r, max(1, r - 5), r], r,
                                           dt, torch.int16, 13, dev)
                res = compare_sparse(tc, lw, lh, 1, dt, bf16=True)
                print(f"  skewed r={r} {str(dt)[6:]} bf16: "
                      f"{'ok' if res['ok'] else 'MISMATCH'} "
                      + " ".join(f"{k}={v:.3g}" for k, v in res["err"].items())
                      + f" deterministic={res['deterministic']}", flush=True)
                ok_all = ok_all and res["ok"]
                del tc, lw, lh
        # S2 in bf16 at each of its register widths and on the group
        # walk, on phase 8's skewed CSC
        ok_all = self.colpass_cases(True) and ok_all
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
        kw10 = dict(ranks=[8, 12, 16], nrun=2, Itmax=100, device="cuda",
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

        # compaction on the other routes: the two-pass loop (kernels
        # P1/P2 and the lane_sum glue) and the dense parity routes
        # (batched products on the card), each gated
        for backend in ("pallas2pass", "dense", "dense_fused"):
            kw = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                      backend=backend, device="cuda", verbose=0, seed=0)
            t0 = time.perf_counter()
            same = same_vb(ct.vb_factorize(s, **kw),
                           ct.vb_factorize(s, compact_every=50, **kw))
            print(f"  VB {backend}: compact_every=50 == uninterrupted {same} "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
            ok = ok and same

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
            self.time_kernel(key, kern, 20)
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
                       self.post_need(swnt, lwt, a[0], a[5], n, 1),
                       peak=INSTR_RATE)
        self.set_bound("h_post_shard", nbytes(pall[0][1], lhs[0], p2[3], sc,
                                              p3[0]),
                       self.post_need(pall[0][1], lhs[0], a[2], a[5],
                                      mp_loc, 1),
                       peak=INSTR_RATE)
        self.set_bound("finish_mesh", nbytes(sc, xlog, p2[3], p2[4], rsum,
                                             hscal, fin_out), 0)
        for key in MESH_KERNELS:
            kd = self.kernels[key]
            print(f"  {kd['name']}: kernel {kd['ms']:.4f} ms, plain "
                  f"{kd['plain_ms']:.4f} ms, bound {kd['bound_ms']:.4f} ms "
                  f"({kd['bound_by']}), launches {kd['launches']}, max abs "
                  f"err {kd['max_abs_err']:.3g}", flush=True)
        self.post_floor("w_post_mesh", swn_part, lwt, ehs_part, sc, k2)
        self.post_floor("h_post_shard", parts[0][1], lhs[0], k2[3], sc, k3[0])
        fin_parts = (xlog_part, k2[3], k2[4], rsum_part, hscal_part)
        self.post_floor("finish_mesh", sc, *fin_parts, fin_out)
        kf = self.kernels["finish_mesh"]
        kf["sums_ms"] = kernel_ms(lambda: sol.finish(
            sc, *fin_parts, **dict(fin, hyper_mask=(False,) * 4)))
        kf["newton_steps"] = newton_iterations(sc, fin_parts, **fin)
        print(f"  K4 gathered: with hyper_mask all False (the sums alone) "
              f"{kf['sums_ms']:.4f} ms; Newton steps a lane "
              f"{kf['newton_steps']}", flush=True)
        self.post_ptxas(("w_post_mesh", "h_post_shard"), "finish_mesh")
        # post_kernel at the mesh's edge cases, and K4 on gathered
        # partials (a 600 x 2048 X over 4 shards) under every hyper mask
        ok = compare_post_cases("h_post_shard") and ok
        ok = compare_post_cases("w_post_mesh") and ok

        def gathered_parts(dt):
            x_np = planted(600, 2048, 8, seed=10)
            xx, lwt_, lh_, eh_, sc_, _ = sweep_inputs(
                x_np, [16, 12, 8], 16, dt, torch.int8, 1.0, 10, dev)
            xsh = ShardedCounts(xx, np.array([[dev] * k], dtype=object))
            lhk, ehk = xsh.shard_h(lh_), xsh.shard_h(eh_)
            ps = [ssh.xpass_shard(b, lwt_, l_, e_, sc_)
                  for b, l_, e_ in zip(xsh.blocks[0], lhk, ehk)]
            ngc_ = ps[0][1].shape[1]
            xlog_ = ssh.gather([p[2].view(3, ngc_, -1) for p in ps], 2,
                               dev).view(3, -1)
            w_ = sol.w_post(ssh.gather([p[0] for p in ps], 1, dev), lwt_,
                            ssh.gather([p[3] for p in ps], 1, dev), sc_, 16,
                            600)
            hs_ = [ssh.h_post_shard(p[1], l_, w_[3], sc_, 16, 512, 512)
                   for p, l_ in zip(ps, lhk)]
            return (sc_, xlog_, w_[3], w_[4],
                    ssh.gather([h_[3] for h_ in hs_], 1, dev),
                    ssh.gather([h_[4] for h_ in hs_], 1, dev))

        ok = compare_finish_masks(gathered_parts, 600, 2048,
                                  f"gathered (600 x 2048 over {k} shards)"
                                  ) and ok

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

    # -- 18 -----------------------------------------------------------
    def rsvd_host(self):
        import os
        import shutil
        import tempfile

        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch import native
        from ccfindr_tpu_torch.ops import rsvd
        from ccfindr_tpu_torch.ops import sparse as tsk
        from ccfindr_tpu_torch.ops.kernels import sparse as spk

        ok = True
        big = self.atlas
        if big is None:
            t0 = time.perf_counter()
            big = self.atlas = atlas_csr(*ATLAS)
            print(f"  atlas X {big.shape[0]} x {big.shape[1]}, nnz "
                  f"{big.nnz}, built on the host in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        # the randomized SVD on the card (float32 range finder, CSR
        # products) against the float64 host one on the same Omega
        sc = tsk.from_scipy(big, dtype=torch.float32, device="cuda")
        outs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(rsvd.randomized_svd(sc, 16, seed=0))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        same = all(torch.equal(u, v) for u, v in zip(*outs))
        # each step twice on the same input: which one keeps its bits
        om = rsvd._draw_omega(big.shape[1], 26, torch.float32, 0, "cuda")
        y = rsvd.coo_matmul(sc, om)
        q = torch.linalg.qr(y)[0]
        z = rsvd.coo_rmatmul(sc, q)
        steps = {"X @ Omega": torch.equal(y, rsvd.coo_matmul(sc, om)),
                 "X^T @ Q": torch.equal(z, rsvd.coo_rmatmul(sc, q)),
                 "qr": torch.equal(q, torch.linalg.qr(y)[0]),
                 "svd": all(torch.equal(u, v) for u, v in zip(
                     torch.linalg.svd(z.T, full_matrices=False),
                     torch.linalg.svd(z.T, full_matrices=False)))}
        print(f"  each step twice, bit-identical: {steps}", flush=True)
        del om, y, q, z
        # the reference: the same range finder in float64 on the host,
        # by scipy's sparse products and numpy's QR and SVD
        t0 = time.perf_counter()
        om = rsvd._draw_omega(big.shape[1], 26, torch.float64, 0,
                              "cpu").numpy()
        big64 = big.astype(np.float64)
        q = np.linalg.qr(big64 @ om)[0]
        for _ in range(4):
            q = np.linalg.qr(big64 @ np.linalg.qr(big64.T @ q)[0])[0]
        host_sv = np.linalg.svd((big64.T @ q).T, compute_uv=False)[:16]
        host_s = time.perf_counter() - t0
        s_err = float(np.max(np.abs(outs[0][1].double().cpu().numpy()
                                    - host_sv) / host_sv))
        u_orth = float((outs[0][0].double().T @ outs[0][0].double()
                        - torch.eye(16, dtype=torch.float64,
                                    device="cuda")).abs().max())
        print(f"  randomized_svd atlas (rank 16, k 26, 4 power iterations, "
              f"float32 on the card): {secs * 1e3:.1f} ms (second call); "
              f"two calls bit-identical {same}; singular values against "
              f"the float64 host run on the same Omega (scipy/numpy, "
              f"{host_s:.1f} s): max rel {s_err:.3g} (gate "
              f"{RSVD_S_TOL:g}); |U^T U - I| {u_orth:.3g}; s[:4] "
              f"{outs[0][1][:4].tolist()}", flush=True)
        self.rsvd_ms = secs * 1e3
        ok = ok and same and s_err <= RSVD_S_TOL
        del sc, outs
        torch.cuda.empty_cache()

        # the SVD start through the driver: 'auto' above 4096 picks the
        # randomized SVD (it raised before)
        calls = []
        real = rsvd.randomized_svd

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)

        rsvd.randomized_svd = counted
        try:
            spk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = ct.vb_factorize(big, ranks=[16], Itmax=20, backend="sparse",
                                initializer="svd2", svd_method="auto",
                                device="cuda", verbose=0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            rsvd.randomized_svd = real
        counts = dict(spk.LAUNCHES)
        print(f"  atlas vb_factorize(sparse, svd2, svd_method='auto', ranks "
              f"[16], Itmax 20): {secs:.2f} s, randomized_svd calls "
              f"{len(calls)}, launches {counts}, lml "
              f"{f.measure['lml'].tolist()}", flush=True)
        ok = (ok and len(calls) == 1 and min(counts.values()) > 0
              and bool(np.isfinite(f.measure["lml"]).all()))

        # write_10x -> read_10x through the native parser, exact
        if self.x10m is None:
            self.x10m = masked_10x(self.x10 if self.x10 is not None
                                   else planted_10x())
        _, csr = self.x10m
        n, m = csr.shape
        s10 = ct.SCSet(count=csr, row_data=[f"gene{i}" for i in range(n)],
                       col_data=[f"cell{j}" for j in range(m)],
                       remove_zeros=False)
        d = tempfile.mkdtemp(prefix="ccfindr_smoke_")
        try:
            t0 = time.perf_counter()
            ct.write_10x(s10, d)
            t1 = time.perf_counter()
            back = ct.read_10x(d, remove_zeros=False)
            t2 = time.perf_counter()
            size = os.path.getsize(os.path.join(d, "matrix.mtx"))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        import scipy.sparse as sp

        diff = sp.csr_matrix(back.counts) - csr
        exact = (back.counts.shape == csr.shape and diff.nnz == 0
                 and list(back.row_data.iloc[:, 0])
                 == list(s10.row_data.iloc[:, 0]))
        print(f"  write_10x / read_10x of the 10x-10% matrix ({csr.nnz} "
              f"nonzeros, {size / 1e6:.1f} MB): write {t1 - t0:.2f} s, read "
              f"{t2 - t1:.2f} s, native parser "
              f"{native.get_lib() is not None}, exact {exact}", flush=True)
        return ok and exact and native.get_lib() is not None

    # -- 19 -----------------------------------------------------------
    def site(self, key, kern, plain, outs_tol, reps, alone, full=None,
             launch=None):
        """A mesh site's kernel on a shard's (or block's) own inputs:
        ``kern()`` and ``plain()`` give the outputs compared (their
        tolerances ``outs_tol``: 'f' the float32 factor tolerance, 's' the
        per-element one), a second launch bit-identical, ``alone()`` the
        lanes-alone bits; the time of ``launch()`` (default ``kern``; one
        kernel launch a call) from a CUDA graph of its launches
        (:func:`kernel_ms`; these launches are as short as the host's
        call), the call's time by CUDA events kept as ``call_ms``, the
        plain version's, and the same kernel on the one-device inputs
        (``full``) timed the same way beside it."""
        import torch

        got = kern()
        want = plain()
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        ok = all(e <= (F32_FACTOR_TOL if t == "f" else F32_ELBO_TOL)
                 for e, t in zip(errs, outs_tol))
        again = kern()
        det = all(torch.equal(u, v) for u, v in zip(got, again))
        lanes = alone()
        kd = self.kernels[key]
        kd["max_abs_err"] = max(float((g.double() - w.double()).abs().max())
                                for g, w in zip(got, want))
        launch = kern if launch is None else launch
        kd["call_ms"] = cuda_ms(launch, reps)
        kd["ms"] = kernel_ms(launch, reps)
        kd["plain_ms"] = cuda_ms(lambda: plain(), 3)
        one = ""
        if full is not None:
            kd["one_device_ms"] = kernel_ms(full, reps)
            one = (f", one device {kd['one_device_ms']:.4f} ms (events "
                   f"{cuda_ms(full, reps):.4f})")
        print(f"  {kd['name']}: vs plain rel {[f'{e:.3g}' for e in errs]}, "
              f"deterministic {det}, lanes alone {lanes}; kernel "
              f"{kd['ms']:.4f} ms a launch (events {kd['call_ms']:.4f})"
              f"{one}, plain {kd['plain_ms']:.4f} ms", flush=True)
        return ok and det and lanes

    def mesh_backends(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops import sparse as tsk
        from ccfindr_tpu_torch.ops import tile
        from ccfindr_tpu_torch.ops.kernels import epilogue as epi
        from ccfindr_tpu_torch.ops.kernels import ml as mlk
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh
        from ccfindr_tpu_torch.ops.kernels import sparse as spk
        from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk
        from ccfindr_tpu_torch.parallel import sharded as tsh

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        mods = (vbk, mlk, spk, sol, ssh, epi)
        x10 = self.x10 if self.x10 is not None else planted_10x()
        if self.x10m is None:
            self.x10m = masked_10x(x10)
        _, csr10 = self.x10m
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        ok = True

        def mesh(cells, genes=1):
            return ct.make_mesh(cells=cells, genes=genes,
                                devices=[dev] * (cells * genes))

        def drive(fn, x, **kw):
            return drive_mesh(mods, fn, x, **kw)

        close = close_to_one

        # Tol 0: every lane runs Itmax sweeps on both sides, so that the
        # comparison sees the shards' rounding and not a stopping test
        # near Tol that the rounding flips (a lane stopped one sweep
        # apart differs by that sweep's update, ~1e-3 at 10x)
        kw10 = dict(ranks=[8, 12, 16], nrun=2, Itmax=100, Tol=0.0,
                    device="cuda", verbose=0, seed=0)

        # sparse VB at the 10x-10% shape over cells=4 (float32; bf16 with
        # elbo_every=5), and sparse_layout='coo' over cells=2 (which the
        # driver runs on the CSR shards of 'tile')
        # bf16: ROADMAP C's tolerances for a bf16 loop (five sweeps,
        # 1e-2 on the factors, 1e-4 on lml: a one-ulp change of wth
        # moves a rounded a by 2^-8 of itself, and the shards' sums round
        # swn otherwise than one device), then the scan to convergence
        # (Itmax 300 at the driver's default Tol) for the same ropt
        bf16 = dict(precision="bf16", elbo_every=5)
        for label, extra, cells, tol in (
                ("sparse VB cells=4 float32", {}, 4, None),
                ("sparse VB cells=4 bf16 elbo_every=5, 5 sweeps",
                 dict(bf16, Itmax=5), 4, (1e-4, 1e-2)),
                ("sparse VB cells=4 bf16 elbo_every=5, to convergence",
                 dict(bf16, Tol=1e-5, Itmax=300), 4, (np.inf, np.inf)),
                ("sparse VB coo cells=2", dict(sparse_layout="coo"), 2,
                 None)):
            one, got, secs, counts = drive(
                ct.vb_factorize, csr10, backend="sparse", mesh=mesh(cells),
                **dict(kw10, **extra))
            ok = close(one, got, label, secs, counts,
                       **({} if tol is None else dict(tol=tol))) and ok
            if not extra:
                for k in ("sp_rowpass", "sp_colpass"):
                    self.kernels[f"{k}_shard"]["launches"] = counts.get(k, 0)
                ok = ok and counts.get("sp_rowpass", 0) > 0 and \
                    counts.get("sp_colpass", 0) > 0
        # S1/S2 a shard of the cells=4 layout (6 lanes, r 16)
        shards = tile.from_scipy_tile_sharded(csr10, 4, dtype=torch.float32,
                                              device="cuda")
        tcf = tile.from_scipy_tile(csr10, dtype=torch.float32, device="cuda")
        n, m = csr10.shape
        ranks6 = [8, 8, 12, 12, 16, 16]
        tc, lw, lh = sparse_inputs(csr10, ranks6, 16, torch.float32,
                                   torch.int16, 9, dev)
        t0_ = shards[0]
        lht = lh.transpose(-1, -2).contiguous()
        lht0 = lht[:, :shards.m].contiguous()
        a0 = spk.sp_rowpass(t0_, lw, lht0)[1]

        def s1(lw_, lht_):
            return spk.sp_rowpass(t0_, lw_, lht_)[:3]

        def s2(a_, lw_):
            return (spk.sp_colpass(t0_, a_, lw_),)

        ones = torch.ones(len(ranks6), dtype=torch.float64, device=dev)
        ok = self.site(
            "sp_rowpass_shard", lambda: s1(lw, lht0),
            lambda: spk.rowpass_plain(t0_, lw, lht0), "ffs", 20,
            lambda: lanes_alone(s1, (lw, lht0)),
            full=lambda: spk.sp_rowpass(tcf, lw, lht, do_elbo=ones),
            launch=lambda: spk.sp_rowpass(t0_, lw, lht0, do_elbo=ones)
        ) and ok
        a_full = spk.sp_rowpass(tcf, lw, lht)[1]
        ok = self.site(
            "sp_colpass_shard", lambda: s2(a0, lw),
            lambda: (spk.colpass_plain(t0_, a0, lw),), "f", 20,
            lambda: lanes_alone(s2, (a0, lw)),
            full=lambda: spk.sp_colpass(tcf, a_full, lw)) and ok
        # the COO API's mesh builder (the JAX driver's 'coo' route; the
        # port's driver runs 'coo' on the CSR shards above): fused_coo a
        # shard of from_scipy_sharded against fused_coo on one device
        coo_one = tsk.fused_coo(tsk.from_scipy(csr10, device="cuda"), lw, lh)
        coo_mesh = tsh.make_sparse_fused_sharded(mesh(2))(
            tsk.from_scipy_sharded(csr10, 2, device="cuda"), lw, lh)
        errs = [rel_err(g, w) for g, w in zip(coo_mesh, coo_one)]
        coo_ok = (max(errs[:2]) <= F32_FACTOR_TOL
                  and errs[2] <= F32_ELBO_TOL)
        print(f"  make_sparse_fused_sharded cells=2 vs fused_coo on one "
              f"device: rel (swn, shn, dterm) {[f'{e:.3g}' for e in errs]}",
              flush=True)
        ok = ok and coo_ok
        del coo_one, coo_mesh
        nnz0 = t0_.nnz
        self.set_bound("sp_rowpass_shard", nbytes(
            t0_.indptr, t0_.col, t0_.val, lw, lht0, s1(lw, lht0)),
            4 * 16 * nnz0 * len(ranks6))
        self.set_bound("sp_colpass_shard", nbytes(
            t0_.colptr, t0_.row, t0_.perm, a0, lw, s2(a0, lw)),
            2 * 16 * nnz0 * len(ranks6),
            library_ms=cuda_ms(s2_library(t0_, a0, lw), 20))
        del shards, tcf, tc, lw, lh, lht, lht0, a0, a_full, ones
        torch.cuda.empty_cache()

        # 'pallas' at 10x over genes=2, cells=2: E1 + E1s a block
        one, got, secs, counts = drive(ct.vb_factorize, x10,
                                       backend="pallas", mesh=mesh(2, 2),
                                       **kw10)
        ok = close(one, got, "pallas 10x genes=2 cells=2", secs,
                   counts) and ok
        self.kernels["fused_xpass_cm_block"]["launches"] = counts.get(
            "fused_xpass_cm", 0)
        self.kernels["fused_sum_block"]["launches"] = counts.get(
            "fused_sum", 0)
        ok = (ok and counts.get("fused_xpass_cm", 0) > 0
              and counts.get("fused_sum", 0) == counts["fused_xpass_cm"]
              and counts.get("xpass", 0) == 0)
        x = torch.as_tensor(x10, device=dev)
        n, m = x.shape
        xs = tsh.place_counts(x, mesh(2, 2))[0]
        xb = xs.packed()[0][0]
        g1, c1 = xs.rows[0][1], xs.cols[0][1]
        nb, rp = 6, 16
        gen = torch.Generator().manual_seed(3)
        lw = torch.rand(nb, n, rp, generator=gen).to(dev) + 0.1
        lh = torch.rand(nb, rp, m, generator=gen).to(dev) + 0.1
        lwb = lw[:, :g1].contiguous()
        lhb = lh[..., :c1].contiguous()
        chunk = vbk.fused_chunk(xb, "cm", 1, rp, 4)

        def e1(lw_, lh_):
            full, part, xp = vbk.fused_xpass(xb, lw_, lh_, layout="cm",
                                             chunk=chunk)
            return full, part, xp

        e1o = e1(lwb, lhb)

        def e1s(part, xp):
            return vbk.fused_sum(part, xp)

        def e1_outs(outs, order):
            """All three of E1's results on a block, in the plain
            function's order (swn, shn, xlog): the streamed output, and
            the partials and x log wth summed by E1s; ``order`` (0, 1)
            for 'gm', whose streamed output is swn, (1, 0) for 'cm'."""
            full, part, xp = outs
            summed, xlog = e1s(part, xp)
            pair = (full, summed)
            return pair[order[0]], pair[order[1]], xlog

        ok = self.site(
            "fused_xpass_cm_block",
            lambda: e1_outs(e1(lwb, lhb), (1, 0)),
            lambda: vbk.fused_xpass_plain(xb, lwb, lhb), "ffs", 10,
            lambda: lanes_alone(e1, (lwb, lhb)),
            full=lambda: vbk.fused_xpass(x, lw, lh, layout="cm"),
            launch=lambda: e1(lwb, lhb)) and ok
        # E1s's function: the partials summed in float64
        ok = self.site(
            "fused_sum_block", lambda: e1s(e1o[1], e1o[2]),
            lambda: (e1o[1].sum(1, dtype=torch.float64).to(e1o[1].dtype),
                     e1o[2].sum(1)), "fs", 20,
            lambda: lanes_alone(e1s, (e1o[1], e1o[2]))) and ok
        nnzb = int((xb != 0).sum())
        self.set_bound("fused_xpass_cm_block", nbytes(xb, lwb, lhb, e1o),
                       6 * rp * nnzb * nb)
        summed = e1s(e1o[1], e1o[2])
        self.set_bound("fused_sum_block", nbytes(e1o[1], e1o[2], summed), 0,
                       library_ms=kernel_ms(lambda: e1o[1].sum(1), 20))
        del x, xs, xb, lw, lh, lwb, lhb, e1o, summed
        torch.cuda.empty_cache()

        # the gene-major shape over cells=2 (Itmax cut to 30 from phase
        # 12's 100): E1 'gm' a shard
        if self.xgm is None:
            self.xgm = planted_gm()
        kwg = dict(kw10, Itmax=30)
        one, got, secs, counts = drive(ct.vb_factorize, self.xgm,
                                       backend="pallas", mesh=mesh(2),
                                       **kwg)
        ok = close(one, got, "pallas gene-major 100,000 x 4,096 cells=2 "
                   "(Itmax 30)", secs, counts) and ok
        self.kernels["fused_xpass_gm_shard"]["launches"] = counts.get(
            "fused_xpass_gm", 0)
        ok = (ok and counts.get("fused_xpass_gm", 0) > 0
              and counts.get("epi_w_post", 0) == 0)
        x = torch.as_tensor(self.xgm, device=dev)
        n, m = x.shape
        xs = tsh.place_counts(x, mesh(2))[0]
        xb = xs.packed()[0][0]
        c1 = xs.cols[0][1]
        nb = 3
        lw = torch.rand(nb, n, rp, generator=gen).to(dev) + 0.1
        lh = torch.rand(nb, rp, m, generator=gen).to(dev) + 0.1
        lhb = lh[..., :c1].contiguous()
        chunk = vbk.fused_chunk(xb, "gm", 1, rp, 4)

        def e1g(lw_, lh_):
            return vbk.fused_xpass(xb, lw_, lh_, layout="gm", chunk=chunk)

        ok = self.site(
            "fused_xpass_gm_shard",
            lambda: e1_outs(e1g(lw, lhb), (0, 1)),
            lambda: vbk.fused_xpass_plain(xb, lw, lhb), "ffs", 3,
            lambda: lanes_alone(e1g, (lw, lhb), lanes=(0, 2)),
            full=lambda: vbk.fused_xpass(x, lw, lh, layout="gm"),
            launch=lambda: e1g(lw, lhb)) and ok
        nnzb = int((xb != 0).sum())
        self.set_bound("fused_xpass_gm_shard",
                       nbytes(xb, lw, lhb, e1g(lw, lhb)),
                       6 * rp * nnzb * nb)
        del x, xs, xb, lw, lh, lhb
        torch.cuda.empty_cache()

        # the ML mesh at 10x over cells=4: M1/M2 ('pallas') and S1/S2
        # ('sparse') a shard
        # (the consensus, host work that compares nothing here, on a
        # 1,000-cell subsample: ~15 s a run at the 10x shape otherwise)
        kwm = dict(ranks=[8, 12, 16], nrun=2, Itmax=100, Tol=0.0,
                   device="cuda", verbose=0, seed=0,
                   cophenetic_max_cells=1000, cophenetic_nsub=1)
        for backend, xin in (("pallas", x10), ("sparse", csr10)):
            one, got, secs, counts = drive(ct.factorize, xin,
                                           backend=backend, mesh=mesh(4),
                                           **kwm)
            ok = close(one, got, f"ML {backend} 10x cells=4", secs, counts,
                       ropt=False) and ok
            if backend == "pallas":
                for k in ("ml_hpass", "ml_wpass"):
                    self.kernels[f"{k}_shard"]["launches"] = counts.get(k, 0)
                ok = ok and min(counts.get("ml_hpass", 0),
                                counts.get("ml_wpass", 0)) > 0
            else:
                ok = ok and counts.get("sp_rowpass", 0) > 0
        x = torch.as_tensor(x10, device=dev)
        n, m = x.shape
        xs = tsh.place_counts(x, mesh(4))[0]
        xb = xs.packed()[0][0]
        c1 = xs.cols[0][1]
        w = torch.rand(6, n, 16, generator=gen).to(dev) + 0.1
        h = torch.rand(6, 16, m, generator=gen).to(dev) + 0.1
        hb = h[..., :c1].contiguous()

        def m1(w_, h_):
            return mlk.ml_hpass(xb, w_, h_)[:2]

        def m2(w_, h_):
            return (mlk.ml_wpass(xb, w_, h_),)

        ok = self.site("ml_hpass_shard", lambda: m1(w, hb),
                       lambda: mlk.ml_h_plain(xb, w, hb), "fs", 20,
                       lambda: lanes_alone(m1, (w, hb)),
                       full=lambda: mlk.ml_hpass(x, w, h)) and ok
        ok = self.site("ml_wpass_shard", lambda: m2(w, hb),
                       lambda: (mlk.ml_w_plain(xb, w, hb),), "f", 20,
                       lambda: lanes_alone(m2, (w, hb)),
                       full=lambda: mlk.ml_wpass(x, w, h)) and ok
        nnzb = int((xb != 0).sum())
        self.set_bound("ml_hpass_shard", nbytes(xb, w, hb, m1(w, hb)),
                       4 * 16 * nnzb * 6)
        self.set_bound("ml_wpass_shard", nbytes(xb, w, hb, m2(w, hb)),
                       4 * 16 * nnzb * 6)
        del x, xs, xb, w, h, hb
        torch.cuda.empty_cache()

        # 'pallas2pass' on the bundled data over cells=2
        kwp = dict(ranks=[4, 5, 6], nrun=2, Itmax=300, Tol=0.0,
                   device="cuda", verbose=0, seed=0)
        one, got, secs, counts = drive(ct.vb_factorize, s,
                                       backend="pallas2pass",
                                       mesh=mesh(2), **kwp)
        ok = close(one, got, "pallas2pass bundled cells=2", secs,
                   counts) and ok
        for k in ("ss_xpass", "elbo_xpass"):
            self.kernels[f"{k}_block"]["launches"] = counts.get(k, 0)
        ok = ok and min(counts.get("ss_xpass", 0),
                        counts.get("elbo_xpass", 0)) > 0
        xb_np = np.asarray(s.counts_dense(dtype=np.float32))
        xb_np = np.pad(xb_np, ((0, 0), (0, xb_np.shape[1] % 2)))
        x = torch.as_tensor(xb_np, device=dev)
        n, m = x.shape
        xs = tsh.place_counts(x, mesh(2))[0]
        xb = xs.packed()[0][0]
        c1 = xs.cols[0][1]
        lw = torch.rand(6, n, 6, generator=gen).to(dev) + 0.1
        lh = torch.rand(6, 6, m, generator=gen).to(dev) + 0.1
        lhb = lh[..., :c1].contiguous()
        chunk = vbk.pass2_chunk(xb, n, c1, 1, 6, 4)

        def p1(lw_, lh_):
            return vbk.suffstats_pallas_padded(
                xb, lw_, lh_, n=n, m=c1, r=6, bn=vbk.DEFAULT_BN,
                bm=vbk.DEFAULT_BM, chunk=chunk)

        def p2(lw_, lh_):
            return (vbk.elbo_xpass(xb, lw_, vbk.xlogx(lw_), lh_,
                                   vbk.xlogx(lh_))[0],)

        lwl, lhl, lhlb = vbk.xlogx(lw), vbk.xlogx(lh), vbk.xlogx(lhb)
        ok = self.site("ss_xpass_block", lambda: p1(lw, lhb),
                       lambda: vbk.suffstats_plain(xb, lw, lhb), "ff", 10,
                       lambda: lanes_alone(p1, (lw, lhb)),
                       full=lambda: vbk.ss_xpass(x, lw, lh),
                       launch=lambda: vbk.ss_xpass(xb, lw, lhb,
                                                   chunk=chunk)) and ok
        ok = self.site("elbo_xpass_block", lambda: p2(lw, lhb),
                       lambda: (vbk.elbo_data_plain(xb, lw, lhb),), "s", 10,
                       lambda: lanes_alone(p2, (lw, lhb)),
                       full=lambda: vbk.elbo_xpass(x, lw, lwl, lh, lhl),
                       launch=lambda: vbk.elbo_xpass(xb, lw, lwl, lhb,
                                                     lhlb)) and ok
        nnzb = int((xb != 0).sum())
        self.set_bound("ss_xpass_block", nbytes(xb, lw, lhb, p1(lw, lhb)),
                       6 * 6 * nnzb * 6)
        self.set_bound("elbo_xpass_block", nbytes(xb, lw, lhb, p2(lw, lhb)),
                       3 * 6 * 6 * nnzb * 6, peak=TF32_FLOPS)
        for key in MESH_SITES:
            kd = self.kernels[key]
            print(f"  {kd['name']}: bound {kd['bound_ms']:.4f} ms "
                  f"({kd['bound_by']}), launches {kd['launches']}",
                  flush=True)
        return ok

    # -- 20 -----------------------------------------------------------
    def multi_process(self):
        import os
        import tempfile

        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh

        x10 = self.x10 if self.x10 is not None else planted_10x()
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        print(f"  {self.smi}", flush=True)
        torch.cuda.empty_cache()     # the workers share the card
        ok = True
        vb_k = ("sol_xpass", "sol_w_post", "sol_h_post", "sol_finish")
        ml_k = ("ml_ml_hpass", "ml_ml_wpass")
        with tempfile.TemporaryDirectory() as tmp:
            x10f = os.path.join(tmp, "x10.npz")
            np.savez(x10f, x=x10)
            bundf = os.path.join(tmp, "bundled.npz")
            np.savez(bundf, x=s.counts_dense(dtype=np.float64))
            cases = [
                # (label, processes, worker arguments, the kernels it runs,
                #  one process first, then the group: walls comparable)
                ("VB 10x", 2, dict(mode="vb", x=x10f, ranks="8,12,16",
                                   nrun=2, itmax=300, backend="pallas",
                                   dtype="float32"), vb_k, True),
                ("ML 10x", 2, dict(mode="ml", x=x10f, ranks="8,12,16",
                                   nrun=2, itmax=300, backend="pallas",
                                   dtype="float32"), ml_k, False),
                ("VB bundled, 2 lanes over 3 processes", 3,
                 dict(mode="vb", x=bundf, ranks="4,5", nrun=1, itmax=3000,
                      backend="pallas", dtype="float32"), vb_k, False),
            ]
            for label, nproc, kw, kern, apart in cases:
                tag = label.split(",")[0].replace(" ", "_")
                one_g = start_workers(tmp, f"{tag}_one", 1, **kw)
                if apart:
                    (one,), = finish_workers(one_g)
                    (got,) = finish_workers(
                        start_workers(tmp, f"{tag}_p", nproc, **kw))
                else:
                    (one,), got = finish_workers(
                        one_g, start_workers(tmp, f"{tag}_p", nproc, **kw))
                lanes = sorted(int(t) for g in got for t in g["lanes"])
                good = lanes == list(range(len(one["n_iter"])))
                # one launch of each kernel a sweep of its own batch: a
                # process's counts exceed its lanes' most sweeps by what
                # the single process's exceed its own
                off = {k: int(one[f"launches_{k}"]) - int(one["n_iter"].max())
                       for k in kern}
                for pid, g in enumerate(got):
                    bad = same_worker(one, g)
                    cnt = {k: int(g[f"launches_{k}"]) for k in kern}
                    if len(g["lanes"]):
                        want = {k: int(g["n_iter"].max()) + off[k]
                                for k in kern}
                        good &= min(cnt.values()) > 0 and cnt == want
                    else:
                        good &= set(cnt.values()) == {0}
                    good &= not bad
                    print(f"  {label}: process {pid}/{nproc} lanes "
                          f"{g['lanes'].tolist()}, wall {float(g['wall']):.3f}"
                          f" s, launches {cnt}"
                          + (f", differs from one process in {bad}"
                             if bad else ", bit-identical to one process"),
                          flush=True)
                print(f"  {label}: one process wall "
                      f"{float(one['wall']):.3f} s, launches "
                      f"{ {k: int(one[f'launches_{k}']) for k in kern} }; "
                      f"{nproc} processes' wall "
                      f"{max(float(g['wall']) for g in got):.3f} s"
                      + ("" if apart else " (run beside the one process)")
                      + f"; lanes add up: {lanes == list(range(len(one['n_iter'])))}"
                      f"; {'PASS' if good else 'FAIL'}", flush=True)
                ok &= bool(good)

        # the runs rows of a mesh on one card: runs=2 over cuda:0 twice
        mods = (sol, ssh)

        def scan(runs):
            for mod in mods:
                mod.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ct.vb_factorize(
                s, ranks=list(range(2, 9)), nrun=3, verbose=0, Itmax=3000,
                seed=0, backend="pallas", device="cuda",
                mesh=ct.make_mesh(runs=runs, cells=1,
                                  devices=["cuda:0"] * runs))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
            return out, secs, counts

        # in turns (runs=1, runs=2, runs=2, runs=1), the walls of each
        # kind printed in the order taken
        a, sa, ca = scan(1)
        b, sb, cb = scan(2)
        walls = {"runs=1": [sa, None], "runs=2": [sb, scan(2)[1]]}
        walls["runs=1"][1] = scan(1)[1]
        used = ("xpass_shard", "w_post", "h_post_shard", "finish")
        # each row launches each kernel once a sweep of its own batch
        na = np.asarray(a.metadata["timings"][0]["n_iter"])
        want = {k: sum(int(r.max()) + ca[k] - int(na.max())
                       for r in np.array_split(na, 2)) for k in used}
        good = (same_vb(a, b) and all(cb[k] == want[k] > 0 for k in used))
        print(f"  bundled mesh scan, launches runs=1 "
              f"{ {k: ca[k] for k in used} }, runs=2 (two rows of cuda:0) "
              f"{ {k: cb[k] for k in used} }, each row's most sweeps plus "
              f"runs=1's offset { {k: want[k] for k in used} }; "
              f"bit-identical to runs=1: {same_vb(a, b)}; "
              f"{'PASS' if good else 'FAIL'}", flush=True)
        print(f"  bundled mesh scan walls (s, in turns; {self.smi}): "
              + "; ".join(f"{k} " + ", ".join(f"{w:.3f}" for w in v)
                          for k, v in walls.items()), flush=True)
        return ok and bool(good)


    # -- 21 -----------------------------------------------------------
    def ell(self):
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops import ell, tile
        from ccfindr_tpu_torch.ops import ml as ml_ops
        from ccfindr_tpu_torch.ops import vb as vb_ops
        from ccfindr_tpu_torch.ops.kernels import sparse as spk
        from ccfindr_tpu_torch.parallel import sharded as tsh

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        x10 = self.x10 if self.x10 is not None else planted_10x()
        if self.x10m is None:
            self.x10m = masked_10x(x10)
        _, csr10 = self.x10m
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        ok = True
        passes = {"fused_ell": (ell.fused_ell, tile.fused_tile),
                  "ell_ml_h": (ell.ell_ml_h, tile.tile_ml_h),
                  "ell_ml_w": (ell.ell_ml_w, tile.tile_ml_w)}

        def outs(t):
            return t if isinstance(t, tuple) else (t,)

        def plain_ok(got, want, dt, nm):
            """Each output against its plain version on CPU copies:
            float64 1e-10; float32 2e-4 on the numerators and 1e-5 on
            the per-element scalar term (phases 8 and 10)."""
            errs = []
            for g, w in zip(got, want):
                w = w.to(g.device)
                errs.append(rel_err(g / nm, w / nm) if g.dim() == 1
                            else rel_err(g, w))
            tol = [F64_TOL if dt == torch.float64 else
                   (F32_ELBO_TOL if g.dim() == 1 else F32_FACTOR_TOL)
                   for g in got]
            return all(e <= t for e, t in zip(errs, tol)), errs

        # the layout and its passes: the 10x-10% matrix at the default
        # quantile and the skewed CSR of phase 8 at a quantile that
        # leaves tails
        ranks6 = [8, 8, 12, 12, 16, 16]
        for label, csr, q in (("10x-10%", csr10, 0.98),
                              ("skewed 300 x 5000", skewed_csr(300, 5000, 1),
                               0.5)):
            n, m = csr.shape
            t0 = time.perf_counter()
            ec = ell.from_scipy_ell(csr, dtype=torch.float32, quantile=q,
                                    device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            tc = tile.from_scipy_tile(csr, dtype=torch.float32,
                                      device="cuda")
            same = all(getattr(ec.csr, f).dtype == getattr(tc, f).dtype
                       and torch.equal(getattr(ec.csr, f), getattr(tc, f))
                       for f in ("indptr", "col", "val", "colptr", "row",
                                 "perm"))
            print(f"  {label} (nnz {csr.nnz}, quantile {q}): widths Kg "
                  f"{ec.gcol.shape[1]}, Kc {ec.crow.shape[1]}; tails "
                  f"{ec.gtval.numel()} by gene, {ec.ctval.numel()} by "
                  f"cell; slots and tails "
                  f"{nbytes(*(getattr(ec, f) for f in ell._FIELDS)) / 1e6:.1f}"
                  f" MB, CSR view {nbytes(ec.csr.indptr, ec.csr.col, ec.csr.val, ec.csr.colptr, ec.csr.row, ec.csr.perm) / 1e6:.1f} MB;"  # noqa: E501
                  f" built in {secs:.2f} s; view == from_scipy_tile {same}",
                  flush=True)
            ok = ok and same
            for dt in (torch.float32, torch.float64):
                tcd, lw, lh = sparse_inputs(csr, ranks6, 16, dt,
                                            torch.int16, 9, dev)
                ecd = ell.from_scipy_ell(csr, dtype=dt, quantile=q,
                                         device="cuda")
                host = ecd.to("cpu")
                for name, (fe, ft) in passes.items():
                    got = outs(fe(ecd, lw, lh))
                    bits = all(torch.equal(u, v) for u, v in
                               zip(got, outs(ft(tcd, lw, lh))))
                    det = all(torch.equal(u, v) for u, v in
                              zip(got, outs(fe(ecd, lw, lh))))
                    alone = lanes_alone(lambda w, h: outs(fe(ecd, w, h)),
                                        (lw, lh))
                    # the plain versions on the CPU, three lanes
                    sub = slice(0, 6, 2)
                    plain = outs(fe(host, lw[sub].cpu(), lh[sub].cpu()))
                    good, errs = plain_ok([g[sub] for g in got], plain, dt,
                                          n * m)
                    print(f"  {label} {str(dt)[6:]} {name}: == tile "
                          f"{bits}, vs plain (CPU) rel "
                          f"{[f'{e:.3g}' for e in errs]}, deterministic "
                          f"{det}, lanes alone {alone}", flush=True)
                    ok = ok and bits and det and alone and good
                    if (dt == torch.float32 and label == "10x-10%"
                            and name == "fused_ell"):
                        # S1's output swn, S2's shn
                        for k, g, p in zip(ELL_SITES, got, plain):
                            self.kernels[k]["max_abs_err"] = float(
                                (g[sub] - p.to(dev)).abs().max())
                del tcd, lw, lh, ecd, host
            if label == "10x-10%":
                # S1/S2 at the ELL site: their times on the view, beside
                # their plain versions, bounds and S2's library call
                _, lw, lh = sparse_inputs(csr, ranks6, 16, torch.float32,
                                          torch.int16, 9, dev)
                v = ec.csr
                lht = lh.transpose(-1, -2).contiguous()
                s1 = spk.sp_rowpass(v, lw, lht)
                a = s1[1]
                s2 = spk.sp_colpass(v, a, lw)
                for k, kern, plain in (
                        ("sp_rowpass_ell", lambda: spk.sp_rowpass(v, lw, lht),
                         lambda: spk.rowpass_plain(v, lw, lht)),
                        ("sp_colpass_ell", lambda: spk.sp_colpass(v, a, lw),
                         lambda: spk.colpass_plain(v, a, lw))):
                    self.kernels[k]["ms"] = cuda_ms(kern, 20)
                    self.kernels[k]["plain_ms"] = cuda_ms(plain, 5)
                nnz = v.nnz
                self.set_bound("sp_rowpass_ell", nbytes(
                    v.indptr, v.col, v.val, lw, lht, s1[:3]),
                    4 * 16 * nnz * len(ranks6))
                self.set_bound("sp_colpass_ell", nbytes(
                    v.colptr, v.row, v.perm, a, lw, s2),
                    2 * 16 * nnz * len(ranks6),
                    library_ms=cuda_ms(s2_library(v, a, lw), 20))
                for k in ("sp_rowpass_ell", "sp_colpass_ell"):
                    kd = self.kernels[k]
                    print(f"  {kd['name']}: {kd['ms']:.4f} ms, plain "
                          f"{kd['plain_ms']:.4f} ms, bound "
                          f"{kd['bound_ms']:.4f} ms ({kd['bound_by']}), "
                          f"library {kd['library_ms']}", flush=True)
                del lw, lh, lht, s1, a, s2, v
            del ec, tc
            torch.cuda.empty_cache()

        def same_scan(a, b):
            return (a.measure.equals(b.measure)
                    and all(np.array_equal(u, v) for u, v in
                            zip(a.basis + a.coeff, b.basis + b.coeff)))

        def counted(fn, *args, **kw):
            spk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, dict(spk.LAUNCHES)

        # the drivers: 'ell' runs the CSR layout of 'tile', bit for bit
        kw = dict(ranks=[8, 12, 16], nrun=2, Itmax=100, device="cuda",
                  verbose=0, seed=0, backend="sparse")
        got, secs, counts = counted(ct.vb_factorize, csr10,
                                    sparse_layout="ell", **kw)
        rec = got.metadata["timings"][0]
        sweeps = rec["lane_sweeps_executed"] // len(rec["n_iter"])
        for k in SP_KERNELS:
            self.kernels[f"{k}_ell"]["launches"] = counts[k]
        ref, secs_t, _ = counted(ct.vb_factorize, csr10,
                                 sparse_layout="tile", **kw)
        bits = same_scan(got, ref)
        launches_ok = counts["sp_rowpass"] == counts["sp_colpass"] == sweeps
        print(f"  vb_factorize 10x-10% 'ell' (ranks [8, 12, 16], nrun 2, "
              f"Itmax 100, float32): {secs:.2f} s ('tile' {secs_t:.2f} s), "
              f"== 'tile' {bits}; launches {counts}, the batch's sweeps "
              f"{sweeps} (lane-sweeps {rec['lane_sweeps_executed']})",
              flush=True)
        ok = ok and bits and launches_ok
        kwm = dict(ranks=[4, 5, 6], nrun=4, Itmax=400, Tol=1e-4,
                   device="cuda", verbose=0, seed=0, backend="sparse")
        got, secs, counts = counted(ct.factorize, s, sparse_layout="ell",
                                    **kwm)
        ref = ct.factorize(s, sparse_layout="tile", **kwm)
        bits = same_scan(got, ref)
        print(f"  factorize bundled 'ell' (ranks [4, 5, 6], nrun 4): "
              f"{secs:.2f} s, == 'tile' {bits}; launches {counts}",
              flush=True)
        ok = ok and bits and min(counts.values()) > 0
        mesh4 = ct.make_mesh(cells=4, devices=[dev] * 4)
        kwc = dict(kw, Itmax=60, mesh=mesh4)
        got, secs, counts = counted(ct.vb_factorize, csr10,
                                    sparse_layout="ell", **kwc)
        ref = ct.vb_factorize(csr10, sparse_layout="tile", **kwc)
        bits = same_scan(got, ref)
        print(f"  vb_factorize 10x-10% 'ell' over cells=4 (Itmax 60): "
              f"{secs:.2f} s, == the tile mesh run {bits}; launches "
              f"{counts}", flush=True)
        ok = ok and bits and min(counts.values()) > 0
        # the JAX package's ELL mesh builder: fused_ell a shard against
        # fused_ell on one device
        _, lw, lh = sparse_inputs(csr10, ranks6, 16, torch.float32,
                                  torch.int16, 9, dev)
        one = ell.fused_ell(ell.from_scipy_ell(csr10, device="cuda"), lw, lh)
        msh = tsh.make_ell_fused_sharded(mesh4)(
            ell.from_scipy_ell_sharded(csr10, 4, device="cuda"), lw, lh)
        errs = [rel_err(g, w) for g, w in zip(msh, one)]
        mesh_ok = max(errs[:2]) <= F32_FACTOR_TOL and errs[2] <= F32_ELBO_TOL
        print(f"  make_ell_fused_sharded cells=4 vs fused_ell on one "
              f"device: rel (swn, shn, dterm) {[f'{e:.3g}' for e in errs]}",
              flush=True)
        ok = ok and mesh_ok
        del lw, lh, one, msh
        # the JAX drivers' refusals
        refused = []
        for fn, extra in ((ct.vb_factorize, dict(elbo_every=2)),
                          (ct.vb_factorize, dict(precision="bf16")),
                          (ct.factorize, dict(randomize=True)),
                          (ct.factorize, dict(mesh=ct.make_mesh(
                              cells=2, devices=[dev] * 2)))):
            try:
                fn(s, ranks=[2], verbose=0, backend="sparse",
                   sparse_layout="ell", device="cuda", Itmax=5, **extra)
                refused.append(False)
            except ValueError:
                refused.append(True)
        print(f"  refusals (elbo_every, bf16, randomize, ML mesh): "
              f"{refused}", flush=True)
        ok = ok and all(refused)

        # the dense routes' products (utils.lane_matmul): each lane's
        # bits whatever the lane count, at 10x (6 lanes, r 16, float32)
        x = torch.as_tensor(x10, device=dev)
        gen = torch.Generator().manual_seed(5)
        lw = (torch.rand(6, *x.shape[:1], 16, generator=gen) + 0.1).to(dev)
        lh = (torch.rand(6, 16, x.shape[1], generator=gen) + 0.1).to(dev)
        dense = {"fused_dense": vb_ops.fused_dense,
                 "suffstats_dense": vb_ops.suffstats_dense,
                 "elbo_data_term": vb_ops.elbo_data_term,
                 "ml_h_dense": ml_ops.ml_h_dense,
                 "ml_w_dense": ml_ops.ml_w_dense,
                 "likelihood": lambda *a: ml_ops.likelihood(*a, 0.0)}
        alone = {k: lanes_alone(lambda w, h, f=f: outs(f(x, w, h)),
                                (lw, lh)) for k, f in dense.items()}
        print(f"  dense passes at 10x, lanes 1 and 4 of six alone: {alone}",
              flush=True)
        ok = ok and all(alone.values())
        return ok


    # -- 22 -----------------------------------------------------------
    def atlas_workflow(self):
        import importlib.util
        import os

        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import sol

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        torch.cuda.empty_cache()
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            ATLAS_DEMO)
        spec = importlib.util.spec_from_file_location("atlas_demo_torch",
                                                      path)
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        t0 = time.perf_counter()
        x_np, _ = demo.simulate_atlas(base_cells=2048)
        n, m = x_np.shape
        print(f"  atlas X {n} x {m} int8 ({x_np.nbytes / 1e9:.3f} GB), "
              f"built on the host in {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        s = ct.SCSet(count=x_np, remove_zeros=False)   # once, for (a), (b)
        print(f"  SCSet: {s.counts.nnz} nonzeros ({s.counts.nnz / (n * m):.4f}"
              f" of X) in {time.perf_counter() - t0:.1f} s", flush=True)
        ranks = list(ATLAS_RANKS)
        lane_ranks = [r for r in ranks for _ in range(2)]
        nb, r = len(lane_ranks), max(ranks)
        rp = sol.round_up(r, 8)
        gch, cch = sol.CHUNK
        ncc, ngc = -(-m // cch), -(-n // gch)
        part_gb = nb * rp * (ncc * n + ngc * m) * 4 / 1e9
        ngroups = len(sol.lane_groups(nb, sol.lane_part_bytes(n, m, rp, 4)))
        print(f"  {nb} lanes of rp {rp}: K1's partials {ncc} cell chunks x "
              f"{ngc} gene chunks, {part_gb:.1f} GB a sweep, launched in "
              f"{ngroups} lane groups of at most "
              f"{sol.LANE_GROUP_BYTES / 2 ** 30:g} GiB", flush=True)

        # (a) the full batch through vb_factorize, its lanes observed as
        # vb_run_sol returns them (every count set to 0 just before)
        lanes = []
        orig = sol.vb_run_sol

        def observed(*a, **k):
            out = orig(*a, **k)
            lanes.append((out.lml.cpu(), out.hyper_failed.cpu()))
            return out

        kw = dict(Tol=0, backend="pallas", device="cuda", verbose=0, seed=0)
        sol.vb_run_sol = observed
        try:
            torch.cuda.reset_peak_memory_stats()
            sol.reset_launches()
            t0 = time.perf_counter()
            f = ct.vb_factorize(s, ranks=ranks, nrun=2, Itmax=ATLAS_ITMAX,
                                **kw)
            wall = time.perf_counter() - t0
            launches = dict(sol.LAUNCHES)
        finally:
            sol.vb_run_sol = orig
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rec = f.metadata["timings"][0]
        sweeps = rec["lane_sweeps_executed"] // nb
        lml, hfail = lanes[0]
        print(f"  (a) vb_factorize ranks 2..{r} x 2 = {nb} lanes, Itmax "
              f"{ATLAS_ITMAX}, Tol 0: wall {wall:.3f} s, set-up and "
              f"selection {wall - rec['seconds']:.3f} s, loop "
              f"{rec['seconds']:.3f} s, {sweeps} sweeps -> "
              f"{rec['seconds'] / sweeps * 1e3:.1f} ms a sweep, "
              f"{rec['lane_sweeps_executed'] / rec['seconds']:.2f} "
              f"lane-sweeps/s; peak device memory {peak:.2f} GiB; launches "
              f"{launches}; lanes' lml finite "
              f"{bool(torch.isfinite(lml).all())}, hyper failed "
              f"{int(hfail.sum())}; {self.smi}", flush=True)
        ok_a = (len(lanes) == 1 and lml.numel() == nb
                and bool(torch.isfinite(lml).all()) and not bool(hfail.any())
                and list(f.measure["rank"]) == ranks
                and bool(np.isfinite(f.measure["lml"]).all())
                and launches["finish"] == sweeps > 0
                and all(launches[k] == ngroups * sweeps
                        for k in ("xpass", "w_post", "h_post")))
        del f
        torch.cuda.empty_cache()

        # (b) the last lane of an svd2 scan (seeded by rank), launched in
        # a lane group, against its rank alone, bit for bit
        kb = dict(kw, nrun=1, initializer="svd2", Itmax=ATLAS_LONE_ITMAX)
        lone = list(ATLAS_LONE_RANKS)
        t0 = time.perf_counter()
        fb = ct.vb_factorize(s, ranks=lone, **kb)
        tb = time.perf_counter() - t0
        t0 = time.perf_counter()
        fl = ct.vb_factorize(s, ranks=[r], **kb)
        tl = time.perf_counter() - t0
        k = fb.ranks.index(r) if r in fb.ranks else None
        same = k is not None and (
            fb.measure["lml"].iloc[k] == fl.measure["lml"].iloc[0]
            and np.array_equal(fb.basis[k], fl.basis[0])
            and np.array_equal(fb.coeff[k], fl.coeff[0])
            and fb.metadata["timings"][0]["n_iter"][k]
            == fl.metadata["timings"][0]["n_iter"][0])
        print(f"  (b) svd2 scan ranks {lone[0]}..{r} ({len(lone)} lanes, "
              f"lane groups "
              f"{sol.lane_groups(len(lone), sol.lane_part_bytes(n, m, rp, 4))}"
              f") {tb:.1f} s (loop {fb.metadata['timings'][0]['seconds']:.3f}"
              f" s), rank {r} alone {tl:.1f} s (loop "
              f"{fl.metadata['timings'][0]['seconds']:.3f} s): lane "
              f"{len(lone) - 1} equal to the lone lane bit for bit: "
              f"{same}; lml {fb.measure['lml'].iloc[-1]!r} vs "
              f"{fl.measure['lml'].iloc[0]!r}", flush=True)
        ok_b = same
        del fb, fl
        torch.cuda.empty_cache()

        # (c) K1-K4 against their plain versions on a window of cells at
        # the full gene width (38 lanes, rp 24), then each kernel timed at
        # the full shape with its bound
        tc = time.perf_counter()
        args = sweep_inputs(np.ascontiguousarray(x_np[:, :ATLAS_WINDOW]),
                            lane_ranks, r, torch.float32, torch.int8, 1.0, 22,
                            dev)
        res = compare_sweep(args, torch.float32)
        k1c = compare_k1(args, torch.float32, False)
        worst = max(res["err"].items(), key=lambda kv: kv[1])
        print(f"  (c) K1-K4 vs plain on {n} x {ATLAS_WINDOW} ({nb} lanes, rp "
              f"{rp}, float32): {'ok' if res['ok'] else 'MISMATCH'} worst "
              f"{worst[0]}={worst[1]:.3g} elbo={res['err']['elbo']:.3g}; K1 "
              f"partial by partial {'ok' if k1c['ok'] else 'MISMATCH'} "
              f"({k1c['part']:.3g}, xlog {k1c['xlog']:.3g}, ehs "
              f"{k1c['ehs']:.3g}) [{time.perf_counter() - tc:.1f} s]",
              flush=True)
        if not res["ok"]:
            print(f"    errors: {res['err']}", flush=True)
        ok_c = res["ok"] and k1c["ok"]
        xw, lwt, lh, eh, sc, wkw = args
        dt = torch.float32
        a = [sc[:, q].to(dt) for q in range(6)]
        fin = dict(n=n, m=ATLAS_WINDOW, dt=dt, hyper_mask=(True,) * 4,
                   newton_niter=100, newton_tol=1e-4)
        w1 = sol.xpass(xw, lwt, lh, eh, sc)
        w2 = sol.w_post(w1[0], lwt, w1[3], sc, r, n)
        w3 = sol.h_post(w1[1], lh, w2[3], sc, r, ATLAS_WINDOW)
        p1 = sol.xpass_plain(xw, lwt, lh, eh, sc)
        p2 = sol.post_plain(p1[0], lwt, p1[3], a[0], a[1], a[4], a[5], r, n)
        p3 = sol.post_plain(p1[1], lh, p2[3], a[2], a[3], a[4], a[5], r,
                            ATLAS_WINDOW)
        window = {
            "xpass": (lambda: sol.xpass(xw, lwt, lh, eh, sc),
                      lambda: sol.xpass_plain(xw, lwt, lh, eh, sc)),
            "w_post": (lambda: sol.w_post(w1[0], lwt, w1[3], sc, r, n),
                       lambda: sol.post_plain(p1[0], lwt, p1[3], a[0], a[1],
                                              a[4], a[5], r, n)),
            "h_post": (lambda: sol.h_post(w1[1], lh, w2[3], sc, r,
                                          ATLAS_WINDOW),
                       lambda: sol.post_plain(p1[1], lh, p2[3], a[2], a[3],
                                              a[4], a[5], r, ATLAS_WINDOW)),
            "finish": (lambda: sol.finish(sc, w1[2], w2[3], w2[4], w3[3],
                                          w3[4], **fin),
                       lambda: sol.finish_plain(sc, p1[2], p2[3], p2[4],
                                                p3[3], p3[4], n, ATLAS_WINDOW,
                                                dt, (True,) * 4, 100, 1e-4)),
        }
        for key, (kern, plain) in window.items():
            kd = self.kernels[f"{key}_atlas"]
            kd.update(launches=launches[key],
                      max_abs_err=res["abs_err"][key],
                      plain_ms=cuda_ms(plain, 2),
                      window_ms=(kernel_ms(kern) if key == "finish"
                                 else cuda_ms(kern, 3)),
                      plain_shape=f"{n} x {ATLAS_WINDOW}, {nb} lanes")
        del args, xw, lwt, lh, eh, sc, w1, w2, w3, p1, p2, p3, window
        torch.cuda.empty_cache()

        # the full shape: X on the card, factors drawn there
        x = torch.as_tensor(x_np, device=dev)
        nnz = int(torch.count_nonzero(x))
        gen = torch.Generator(device=dev).manual_seed(22)
        fudge = float(torch.finfo(dt).eps)
        rows = torch.arange(rp, device=dev)[None, :, None]
        live = rows < torch.as_tensor(lane_ranks, device=dev)[:, None, None]

        def factor(cols):
            v = torch.rand(nb, rp, cols, generator=gen, device=dev) + 0.5
            return torch.where(live, v, torch.where(rows < r, fudge, 0.0))

        lwt, lh = factor(n), factor(m)
        eh = lh * (0.8 + 0.4 * torch.rand(lh.shape, generator=gen,
                                          device=dev))
        sc = torch.zeros(nb, 8, dtype=torch.float64, device=dev)
        sc[:, :4] = 0.5 + torch.rand(nb, 4, generator=gen, device=dev,
                                     dtype=torch.float64)
        sc[:, 4] = fudge
        sc[:, 5] = torch.as_tensor(lane_ranks, dtype=torch.float64)
        sc[:, 7] = 1.0

        # offsets past 2**31 elements: K1-K3 on the last len(ranks) lanes
        # in one launch (beyond the group budget, so called directly):
        # the last lane, whose partials start past element 2**31, against
        # that lane launched alone, bit for bit
        tail, last = slice(nb - len(ranks), nb), slice(nb - 1, nb)
        got, alone = [], []
        for sl, keep in ((tail, got), (last, alone)):
            p = sol.xpass(x, lwt[sl], lh[sl], eh[sl], sc[sl])
            pw = sol.w_post(p[0], lwt[sl], p[3], sc[sl], r, n)
            ph = sol.h_post(p[1], lh[sl], pw[3], sc[sl], r, m)
            keep.extend(t[-1:].clone() for t in (*p, *pw, *ph))
            del p, pw, ph
            torch.cuda.empty_cache()
        start = (len(ranks) - 1) * ncc * rp * n
        same = all(torch.equal(u, v) for u, v in zip(got, alone))
        del alone
        torch.cuda.empty_cache()
        tl = time.perf_counter() - tc
        # that lane's K1 partials, K2 and K3 against their plain versions
        # at the full shape (its 392 swn and 80 shn partials)
        held = {}
        gl = (x, lwt[last], lh[last], eh[last], sc[last])
        ok1, part, xlog, ehs, held["xpass"] = hold_k1(got[:4], *gl)
        ok2, f2, rs2, s2, held["w_post"] = hold_post(
            got[4:9], got[0], gl[1], got[3], gl[4], 0, r, n, n * m)
        ok3, f3, rs3, s3, held["h_post"] = hold_post(
            got[9:], got[1], gl[2], got[7], gl[4], 2, r, m, n * m)
        print(f"  K1-K3 on {len(ranks)} lanes in one launch "
              f"({part_gb * len(ranks) / nb:.1f} GB of partials): the last "
              f"lane (its swn partials from element {start}, its shn from "
              f"{(len(ranks) - 1) * ngc * rp * m}; 2**31 = {2 ** 31}) equal "
              f"to the lane alone bit for bit: {same}; against plain at "
              f"{n} x {m}: K1 partial by partial {'ok' if ok1 else 'MISMATCH'}"
              f" ({part:.3g}, xlog {xlog:.3g}, ehs {ehs:.3g}), K2 "
              f"{'ok' if ok2 else 'MISMATCH'} (e/ln/d {f2:.3g}, rank sums "
              f"{rs2:.3g}, scalars {s2:.3g}), K3 {'ok' if ok3 else 'MISMATCH'}"
              f" (e/ln/d {f3:.3g}, rank sums {rs3:.3g}, scalars {s3:.3g}) "
              f"[the launches {tl:.1f} s, the plain versions "
              f"{time.perf_counter() - tc - tl:.1f} s]", flush=True)
        ok_c = ok_c and same and start > 2 ** 31 and ok1 and ok2 and ok3
        del got, gl
        torch.cuda.empty_cache()

        # each kernel timed as the main path launches it: K1-K3 a lane
        # group (sol.lane_groups, the first), K4 once on all 38 lanes
        tc = time.perf_counter()
        groups = sol.lane_groups(nb, sol.lane_part_bytes(n, m, rp, 4))
        outs = [sol.xpass_post(x, lwt[g], lh[g], eh[g], sc[g], n=n,
                               m_live=m, m=m, r=r)[6:] for g in groups]
        k4in = [torch.cat(t) for t in zip(*outs)]
        del outs
        torch.cuda.empty_cache()
        fkw = dict(fin, m=m)
        k4 = sol.finish(sc, *k4in, **fkw)
        self.time_kernel("finish_atlas", lambda: sol.finish(sc, *k4in, **fkw),
                         20)
        g0 = groups[0]
        nb0 = g0.stop - g0.start
        gx = (x, lwt[g0], lh[g0], eh[g0], sc[g0])
        kx = self.kernels["xpass_atlas"]
        kx["ms"] = cuda_ms(lambda: sol.xpass(*gx), 2)
        k1 = sol.xpass(*gx)
        k2 = sol.w_post(k1[0], gx[1], k1[3], gx[4], r, n)
        k3 = sol.h_post(k1[1], gx[2], k2[3], gx[4], r, m)
        self.kernels["w_post_atlas"]["ms"] = cuda_ms(
            lambda: sol.w_post(k1[0], gx[1], k1[3], gx[4], r, n), 3)
        self.kernels["h_post_atlas"]["ms"] = cuda_ms(
            lambda: sol.h_post(k1[1], gx[2], k2[3], gx[4], r, m), 3)
        # bounds: the function's bytes (each input read once, the reduced
        # outputs written once) and the operations this run's data needs:
        # K1's products at X's nonzeros, 6 flops a live rank a lane
        f4, f8 = 4, 8
        swnt_b, shn_b = nb0 * rp * n * f4, nb0 * rp * m * f4
        self.set_bound("xpass_atlas",
                       nbytes(*gx) + swnt_b + shn_b + nb0 * f8
                       + nb0 * rp * f8,
                       6 * nnz * sum(lane_ranks[g0]))
        a0 = [gx[4][:, q].to(dt) for q in range(6)]
        sfx = k1[0].sum(1)
        self.set_bound("w_post_atlas",
                       swnt_b + nbytes(gx[1], gx[4]) + nb0 * rp * f8
                       + 3 * swnt_b + nb0 * (rp + 4) * f8,
                       self.post_need(sfx, gx[1], a0[0], a0[5], n, 1),
                       peak=INSTR_RATE)
        sfx = k1[1].sum(1)
        self.set_bound("h_post_atlas",
                       shn_b + nbytes(gx[2], gx[4]) + nb0 * rp * f8
                       + 3 * shn_b + nb0 * (rp + 4) * f8,
                       self.post_need(sfx, gx[2], a0[2], a0[5], m, 1),
                       peak=INSTR_RATE)
        del sfx
        self.set_bound("finish_atlas", nbytes(sc, k4) + nb * (1 + 2 * rp + 8)
                       * f8, 0)
        self.post_floor("w_post_atlas", k1[0], gx[1], k1[3], gx[4], k2)
        self.post_floor("h_post_atlas", k1[1], gx[2], k2[3], gx[4], k3)
        self.post_floor("finish_atlas", sc, *k4in, k4)
        # K2 and K3 of the first group (392 and 80 partials an entry) and
        # K4 on all lanes (the 4 groups' partials) against their plain
        # versions on the same partials at the full shape
        tl = time.perf_counter() - tc
        ok2, f2, rs2, s2, ab2 = hold_post(k2, k1[0], gx[1], k1[3], gx[4], 0,
                                          r, n, n * m)
        ok3, f3, rs3, s3, ab3 = hold_post(k3, k1[1], gx[2], k2[3], gx[4], 2,
                                          r, m, n * m)
        ok4, e4, el4, ab4 = hold_finish(k4, sc, k4in, n, m, dt)
        held["w_post"] = max(held["w_post"], ab2)
        held["h_post"] = max(held["h_post"], ab3)
        held["finish"] = ab4
        print(f"  against plain at {n} x {m} on the same partials: K2 on "
              f"{nb0} lanes {'ok' if ok2 else 'MISMATCH'} (e/ln/d {f2:.3g}, "
              f"rank sums {rs2:.3g}, scalars {s2:.3g}), K3 on {nb0} lanes "
              f"{'ok' if ok3 else 'MISMATCH'} (e/ln/d {f3:.3g}, rank sums "
              f"{rs3:.3g}, scalars {s3:.3g}), K4 on {nb} lanes "
              f"{'ok' if ok4 else 'MISMATCH'} (hypers {e4:.3g}, elbo "
              f"{el4:.3g}) [the timing {tl:.1f} s, the plain versions "
              f"{time.perf_counter() - tc - tl:.1f} s]", flush=True)
        ok_c = ok_c and ok2 and ok3 and ok4
        dense = 6 * rp * n * m * nb0
        for key in KERNELS:
            kd = self.kernels[f"{key}_atlas"]
            kd["shape"] = (f"{n} x {m} int8, rp {rp}, "
                           f"{nb if key == 'finish' else nb0} lanes a launch "
                           f"({len(groups)} groups of {nb})")
            kd["full_max_abs_err"] = held[key]
            kd["max_abs_err"] = max(kd["max_abs_err"], held[key])
            print(f"  {kd['name']}: {kd['ms']:.4f} ms a launch ({kd['shape']}"
                  f"; {kd['launches']} launches in (a)'s {sweeps} sweeps); "
                  f"bound {kd['bound_ms']:.4f} ms ({kd['bound_by']}); on the "
                  f"{ATLAS_WINDOW}-cell window (all {nb} lanes) "
                  f"{kd['window_ms']:.4f} ms, plain {kd['plain_ms']:.4f} ms; "
                  f"max abs err {kd['max_abs_err']:.3g} (at the full shape "
                  f"{held[key]:.3g})", flush=True)
        print(f"  K1 at the atlas shape: {dense / kx['ms'] / 1e9:.2f} TFLOP/s"
              f" of dense work ({dense / 1e12:.2f} TFLOP a launch of {nb0} "
              f"lanes, X {nnz} nonzeros); {self.smi}", flush=True)
        del x, lwt, lh, eh, sc, k1, k2, k3, k4, k4in, gx
        torch.cuda.empty_cache()
        print(f"  gates: (a) {ok_a}, (b) {ok_b}, (c) {ok_c}", flush=True)
        return ok_a and ok_b and ok_c

    # -- 23 -----------------------------------------------------------
    def multi_card(self):
        import torch

        count = torch.cuda.device_count()
        if count < 2:
            print(f"  phase 23 needs two CUDA devices or more; this machine "
                  f"shows {count}", flush=True)
            return False
        k = min(MC_CARDS, count)
        self.cards = [torch.device("cuda", i) for i in range(k)]
        for args in (["nvidia-smi", "--query-gpu=index,name,power.limit",
                      "--format=csv,noheader"], ["nvidia-smi", "topo", "-m"],
                     ["nvidia-smi", "nvlink", "--status", "-i", "0"]):
            try:
                out = subprocess.run(args, capture_output=True, text=True,
                                     timeout=60).stdout
            except (OSError, subprocess.TimeoutExpired) as exc:
                out = f"{' '.join(args)}: {exc}"
            print("\n".join(f"  {ln}" for ln in out.strip().splitlines()),
                  flush=True)
        peer = [[torch.cuda.can_device_access_peer(i, j) if i != j else None
                 for j in range(k)] for i in range(k)]
        print(f"  {k} cards of {count}; peer access {peer}; "
              f"{peer_rate(1, 0)}", flush=True)
        ok = {}
        for part, fn in (("a", self.mc_kernels), ("b", self.mc_device),
                         ("c", self.mc_10x), ("d", self.mc_routes),
                         ("e", self.mc_processes), ("f", self.mc_atlas)):
            t0 = time.perf_counter()
            try:
                ok[part] = bool(fn())
            except Exception:
                traceback.print_exc()
                ok[part] = False
            torch.cuda.empty_cache()
            print(f"  ({part}) {'PASS' if ok[part] else 'FAIL'} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        print(f"  gates: {ok}", flush=True)
        return all(ok.values())

    def mc_kernels(self):
        """(a) every wrapper with its tensors on the last card against
        cuda:0, the current device held at 0 (tools/check_cards.py)."""
        import importlib.util
        import os

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            CHECK_CARDS)
        spec = importlib.util.spec_from_file_location("check_cards", path)
        cc = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cc)
        last = self.cards[-1]
        res = cc.compare(str(last))
        print(f"  (a) each wrapper on {last} (current device cuda:0) "
              f"against cuda:0: "
              + ", ".join(f"{n} {'same bits' if v else 'DIFFERS'}"
                          for n, v in res.items()), flush=True)
        return len(res) == 17 and all(res.values())

    def mc_device(self):
        """(b) the bundled scan with device='cuda:{k-1}' against cuda:0."""
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import sol

        s = self.filtered if self.filtered is not None \
            else bundled_filtered()
        kw = dict(ranks=list(range(2, 9)), nrun=3, Itmax=3000,
                  backend="pallas", verbose=0, seed=0)
        last = self.cards[-1]
        out = {}
        for dev in (self.cards[0], last):
            sol.reset_launches()
            torch.cuda.reset_peak_memory_stats(dev)
            sync_cards()
            t0 = time.perf_counter()
            out[dev] = ct.vb_factorize(s, device=str(dev), **kw)
            sync_cards()
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
            print(f"  (b) bundled vb_factorize(device='{dev}'): "
                  f"{time.perf_counter() - t0:.2f} s, ropt "
                  f"{ct.optimal_rank(out[dev])['ropt']}, launches "
                  f"{dict(sol.LAUNCHES)}, peak on {dev} {peak:.1f} MiB",
                  flush=True)
        same = same_vb(out[self.cards[0]], out[last])
        ropt = ct.optimal_rank(out[last])["ropt"]
        print(f"  (b) {last} bit-identical to cuda:0: {same}", flush=True)
        return same and ropt == 5 and peak > 0

    def mc_10x(self):
        """(c) the 10x scan over make_mesh(cells=k), runs=2 x cells=k/2
        and runs=k on k cards, each bit-identical to one card; their walls
        in turns beside one card; launches a sweep, busy share and
        cross-card gathers by card from torch.profiler."""
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh

        torch.backends.cuda.matmul.allow_tf32 = False
        k, cards = len(self.cards), self.cards
        if self.x10 is None:
            self.x10 = planted_10x()
        kw = dict(ranks=[8, 12, 16], nrun=2, Itmax=300, backend="pallas",
                  device="cuda:0", verbose=0, seed=0)
        configs = {"one card": None, f"cells={k}": dict(cells=k),
                   f"runs={k}": dict(runs=k, cells=1)}
        if k % 2 == 0 and k > 2:
            configs[f"runs=2, cells={k // 2}"] = dict(runs=2, cells=k // 2)
        mods = (sol, ssh)

        def scan(name, itmax=None):
            m = configs[name]
            extra = {} if m is None else dict(
                mesh=ct.make_mesh(devices=cards, **m))
            for mod in mods:
                mod.reset_launches()
            sync_cards()
            t0 = time.perf_counter()
            f = ct.vb_factorize(self.x10, **dict(
                kw, **({} if itmax is None else dict(Itmax=itmax))), **extra)
            sync_cards()
            wall = time.perf_counter() - t0
            counts = {kk: v for mod in mods for kk, v in mod.LAUNCHES.items()}
            return f, wall, counts

        for name in configs:          # first calls, not timed
            scan(name, itmax=30)
        walls = {name: [] for name in configs}
        loops = {name: [] for name in configs}
        res, cnt = {}, {}
        order = list(configs)
        for name in order + order[::-1]:
            f, wall, counts = scan(name)
            walls[name].append(wall)
            loops[name].append(f.metadata["timings"][0]["seconds"])
            res.setdefault(name, f)
            cnt.setdefault(name, counts)
        one = res["one card"]
        ok = True
        most = max(one.metadata["timings"][0]["n_iter"])
        for name in order:
            same = same_vb(one, res[name]) if name != "one card" else True
            ok = ok and same
            print(f"  (c) 10x {name}: walls {walls[name][0]:.3f}, "
                  f"{walls[name][1]:.3f} s (loops {loops[name][0]:.3f}, "
                  f"{loops[name][1]:.3f}); launches {cnt[name]}; "
                  f"bit-identical to one card {same}; {self.smi}",
                  flush=True)
        c = cnt[f"cells={k}"]
        ok = ok and c["finish"] > 0 and (
            c["xpass_shard"] == c["h_post_shard"] == k * c["finish"]
            and c["w_post"] == c["finish"] and c["xpass"] == 0)
        mean = {n: float(np.mean(w)) for n, w in walls.items()}
        print(f"  (c) mean walls (s): "
              + ", ".join(f"{n} {w:.3f}" for n, w in mean.items())
              + f"; cells={k} / one card "
              f"{mean[order[1]] / mean[order[0]]:.3f} (most sweeps of a "
              f"lane {most})", flush=True)
        # launches, busy share and gathers by card, traced
        for name in (f"cells={k}", f"runs={k}"):
            (f, _, counts), tr = card_trace(lambda: scan(name))
            sweeps = counts["finish"] / (1 if name.startswith("cells")
                                         else k)
            self.print_trace(f"(c) 10x {name}", tr, sweeps)
        return ok

    def print_trace(self, label, tr, sweeps):
        """A :func:`card_trace` reading, a line a card."""
        if tr is None:
            print(f"  {label}: the profiler saw no device event", flush=True)
            return
        print(f"  {label}: the port's kernels span {tr['span_ms']:.1f} ms "
              f"(the loop), {sweeps:g} sweeps; gathers {tr['gather_ms']:.3f}"
              f" ms device time summed over the cards "
              f"({tr['gather_ms'] / max(sweeps, 1):.4f} a sweep), "
              f"{tr['gather_gb'] / max(sweeps, 1):.4f} GB a sweep from "
              f"other cards", flush=True)
        for d, c in tr["cards"].items():
            top = ", ".join(f"{n[:40]} {v[0]}x{v[1] / max(v[0], 1):.3f} ms"
                            for n, v in c["top"])
            print(f"    cuda:{d}: {c['launches'] / max(sweeps, 1):.1f} "
                  f"kernel launches a sweep, busy {c['busy_ms']:.1f} ms = "
                  f"{c['share']:.3f} of the loop; peer copies {c['p2p']} "
                  f"({c['p2p_ms']:.3f} ms); top: {top}", flush=True)

    def mc_routes(self):
        """(d) phase 19's mesh routes, the dense routes and 'ell' over
        distinct cards against one device (phase 19's tolerances; the
        dense routes in float64 to 1e-9 as phase 17's)."""
        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import epilogue as epi
        from ccfindr_tpu_torch.ops.kernels import ml as mlk
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh
        from ccfindr_tpu_torch.ops.kernels import sparse as spk
        from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

        torch.backends.cuda.matmul.allow_tf32 = False
        k, cards = len(self.cards), self.cards
        mods = (vbk, mlk, spk, sol, ssh, epi)
        if self.x10 is None:
            self.x10 = planted_10x()
        if self.x10m is None:
            self.x10m = masked_10x(self.x10)
        _, csr10 = self.x10m
        s = self.filtered if self.filtered is not None \
            else bundled_filtered()

        def mesh(cells, genes=1):
            return ct.make_mesh(cells=cells, genes=genes,
                                devices=cards[:cells * genes])

        def drive(fn, x, **kw):
            return drive_mesh(mods, fn, x, **kw)

        kw10 = dict(ranks=[8, 12, 16], nrun=2, Itmax=MC_ITMAX, Tol=0.0,
                    device="cuda:0", verbose=0, seed=0)
        kwm = dict(kw10, cophenetic_max_cells=1000, cophenetic_nsub=1)
        g2 = k // 2 if k >= 4 else 1
        runs = [
            ("sparse VB 10x-10%", ct.vb_factorize, csr10,
             dict(backend="sparse", **kw10), k, 1, ("sp_rowpass",), True),
            ("sparse VB coo", ct.vb_factorize, csr10,
             dict(backend="sparse", sparse_layout="coo", **kw10), 2, 1,
             ("sp_rowpass",), True),
            ("sparse VB ell", ct.vb_factorize, csr10,
             dict(backend="sparse", sparse_layout="ell", **kw10), k, 1,
             ("sp_rowpass",), True),
            ("pallas 10x", ct.vb_factorize, self.x10,
             dict(backend="pallas", **kw10), k // g2, g2,
             ("fused_xpass_cm", "fused_sum") if g2 > 1
             else ("xpass_shard",), True),
            ("ML pallas 10x", ct.factorize, self.x10,
             dict(backend="pallas", **kwm), k, 1, ("ml_hpass", "ml_wpass"),
             False),
            ("ML sparse 10x-10%", ct.factorize, csr10,
             dict(backend="sparse", **kwm), k, 1, ("sp_rowpass",), False),
            ("pallas2pass bundled", ct.vb_factorize, s,
             dict(kw10, backend="pallas2pass", ranks=[4, 5, 6], Itmax=300),
             2, 1, ("ss_xpass", "elbo_xpass"), True),
        ]
        ok = True
        for label, fn, x, kw, cells, genes, kern, ropt in runs:
            one, got, secs, counts = drive(fn, x, mesh=mesh(cells, genes),
                                           **kw)
            good = close_to_one(one, got, f"(d) {label} cells={cells}"
                                + (f" genes={genes}" if genes > 1 else "")
                                + " on distinct cards", secs, counts,
                                ropt=ropt)
            ok = ok and good and all(counts.get(n, 0) > 0 for n in kern)
            del one, got
        # the gene-major route over two cards (Itmax cut to 10: its set-up
        # is what takes the time)
        if self.xgm is None:
            self.xgm = planted_gm()
        one, got, secs, counts = drive(ct.vb_factorize, self.xgm,
                                       backend="pallas", mesh=mesh(2),
                                       **dict(kw10, Itmax=10))
        ok = close_to_one(one, got, "(d) pallas gene-major 100,000 x 4,096 "
                          "cells=2 on distinct cards (Itmax 10)", secs,
                          counts) and ok
        ok = ok and counts.get("fused_xpass_gm", 0) > 0
        del one, got
        # 'dense' and 'dense_fused' (parallel/sharded.py::_xpass) in
        # float64 against one device
        kwd = dict(ranks=[4, 5, 6], nrun=2, Itmax=3000, device="cuda:0",
                   verbose=0, seed=0, dtype=torch.float64)
        for backend in ("dense", "dense_fused"):
            t0 = time.perf_counter()
            a1 = ct.vb_factorize(s, backend=backend, **kwd)
            ak = ct.vb_factorize(s, backend=backend, mesh=mesh(k), **kwd)
            nit1 = a1.metadata["timings"][0]["n_iter"]
            nitk = ak.metadata["timings"][0]["n_iter"]
            err = float(np.max(np.abs(ak.measure["lml"] - a1.measure["lml"])
                               / np.abs(a1.measure["lml"])))
            print(f"  (d) float64 {backend} cells={k} on distinct cards vs "
                  f"one device: n_iter equal {nit1 == nitk}, lml rel "
                  f"{err:.3g} [{time.perf_counter() - t0:.1f} s]",
                  flush=True)
            ok = ok and nit1 == nitk and err <= 1e-9
        return ok

    def mc_processes(self):
        """(e) the VB 10x scan over k processes, process I on cuda:I,
        against one process: bits, lanes and walls."""
        import os
        import tempfile

        import torch

        k = len(self.cards)
        if self.x10 is None:
            self.x10 = planted_10x()
        ok = True
        with tempfile.TemporaryDirectory() as tmp:
            xf = os.path.join(tmp, "x10.npz")
            np.savez(xf, x=self.x10)
            sync_cards()
            torch.cuda.empty_cache()     # the workers take the cards
            kw = dict(mode="vb", x=xf, ranks="8,12,16", nrun=2, itmax=300,
                      backend="pallas", dtype="float32")
            (one,), = finish_workers(start_workers(tmp, "one", 1, **kw))
            (got,) = finish_workers(start_workers(tmp, "p", k, cards=True,
                                                  **kw))
        lanes = sorted(int(t) for g in got for t in g["lanes"])
        whole = lanes == list(range(len(one["n_iter"])))
        ok = whole
        for pid, g in enumerate(got):
            bad = same_worker(one, g)
            ok = ok and not bad
            print(f"  (e) process {pid}/{k} on cuda:{pid}: lanes "
                  f"{g['lanes'].tolist()}, wall {float(g['wall']):.3f} s, "
                  f"launches K1 {int(g['launches_sol_xpass'])}"
                  + (f", differs from one process in {bad}" if bad
                     else ", bit-identical to one process"), flush=True)
        print(f"  (e) one process on cuda:0 {float(one['wall']):.3f} s; {k} "
              f"processes {max(float(g['wall']) for g in got):.3f} s (the "
              f"slowest); lanes add up {whole}; {self.smi}", flush=True)
        return ok

    def mc_atlas(self):
        """(f) the atlas at full width after QC over make_mesh(cells=k):
        Itmax 20 at Tol 0 against the same sweeps on one card, bit for
        bit, traced; then the converged scan on the k cards."""
        import importlib.util
        import os

        import torch

        import ccfindr_tpu_torch as ct
        from ccfindr_tpu_torch.ops.kernels import sol
        from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh

        k, cards = len(self.cards), self.cards
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            ATLAS_DEMO)
        spec = importlib.util.spec_from_file_location("atlas_demo_torch",
                                                      path)
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        t0 = time.perf_counter()
        x_np, types = demo.simulate_atlas(**MC_ATLAS)
        t1 = time.perf_counter()
        s, types = demo.qc(x_np, types)
        del x_np
        print(f"  (f) atlas simulated in {t1 - t0:.1f} s, QC {s.n_genes} x "
              f"{s.n_cells} in {time.perf_counter() - t1:.1f} s", flush=True)
        ranks = list(ATLAS_RANKS)
        kw = dict(ranks=ranks, nrun=2, backend="pallas", device="cuda:0",
                  verbose=0, seed=0)
        mesh = ct.make_mesh(cells=k, devices=cards)

        def scan(label, **extra):
            for d in range(k):
                torch.cuda.reset_peak_memory_stats(d)
            sol.reset_launches()
            ssh.reset_launches()
            sync_cards()
            t0 = time.perf_counter()
            f = ct.vb_factorize(s, **kw, **extra)
            sync_cards()
            wall = time.perf_counter() - t0
            rec = f.metadata["timings"][0]
            peaks = [torch.cuda.max_memory_allocated(d) / 2 ** 30
                     for d in range(k)]
            print(f"  (f) {label}: wall {wall:.3f} s, set-up and selection "
                  f"{wall - rec['seconds']:.3f} s, loop {rec['seconds']:.3f}"
                  f" s, most sweeps {max(rec['n_iter'])}, lane-sweeps "
                  f"{rec['lane_sweeps_executed']}; peak GiB by card "
                  f"{[round(p, 2) for p in peaks]}; launches "
                  f"{dict(sol.LAUNCHES, **ssh.LAUNCHES)}", flush=True)
            torch.cuda.empty_cache()
            return f

        short = dict(Itmax=MC_ATLAS_ITMAX, Tol=0.0)
        f1 = scan(f"one card, Itmax {MC_ATLAS_ITMAX}, Tol 0", **short)
        fk, tr = card_trace(lambda: scan(
            f"cells={k} on {k} cards, Itmax {MC_ATLAS_ITMAX}, Tol 0",
            mesh=mesh, **short))
        same = same_vb(f1, fk)
        print(f"  (f) cells={k} bit-identical to one card (lml, basis, "
              f"coeff, n_iter): {same}", flush=True)
        self.print_trace(f"(f) atlas cells={k}", tr, sol.LAUNCHES["finish"])
        del f1, fk
        f = scan(f"converged scan, cells={k} on {k} cards (Itmax 300, "
                 "Tol 1e-5)", Itmax=300, mesh=mesh)
        ropt = ct.optimal_rank(f)["ropt"]
        cid = ct.cluster_id(f, rank=demo.PLANT_RANK).to_numpy() - 1
        conc = demo.concordance(types, cid)
        print(f"  (f) converged on {k} cards: ropt {ropt}, concordance at "
              f"r = {demo.PLANT_RANK} {conc:.4f}, sweeps "
              f"{f.metadata['timings'][0]['n_iter']}; {self.smi}",
              flush=True)
        c = dict(sol.LAUNCHES, **ssh.LAUNCHES)
        return (same and bool(np.isfinite(f.measure["lml"]).all())
                and list(f.measure["rank"]) == ranks and c["finish"] > 0
                and c["xpass_shard"] == c["h_post_shard"] == k * c["finish"]
                and c["w_post"] == c["finish"] and c["xpass"] == 0)


DEFAULT_PHASES = tuple(str(p) for p in range(1, 23))   # phase 23 when asked
MP_TIMEOUT = 300             # seconds a group of phase 20's workers may take
MP_RESULT = ("lml", "likelihood", "dispersion", "cophenetic", "aw", "bw",
             "ah", "bh", "nunif", "ranks")


def free_port():
    import socket

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def start_workers(tmp, tag, nproc, cards=False, **kw):
    """Start the ``nproc`` processes of one group of
    ``ccfindr_tpu_torch.parallel._mh_worker`` (gloo on a free localhost
    port), all on the current card, or with ``cards`` process I on
    ``cuda:I``; returns (processes, their .npz outputs)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    args = [a for k, v in kw.items() for a in (f"--{k}", str(v))]
    port = free_port()
    procs, outs = [], []
    for pid in range(nproc):
        out = os.path.join(tmp, f"{tag}{pid}.npz")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ccfindr_tpu_torch.parallel._mh_worker",
             "--pid", str(pid), "--nproc", str(nproc), "--port", str(port),
             "--out", out, "--device", f"cuda:{pid}" if cards else "cuda"]
            + args, env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, outs


def finish_workers(*groups):
    """Wait for every worker of ``groups`` (killed at MP_TIMEOUT); a
    worker that fails or hangs raises.  Returns each group's outputs."""
    procs = [p for ps, _ in groups for p in ps]
    logs = {}
    try:
        for p in procs:
            logs[p] = p.communicate(timeout=MP_TIMEOUT)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [p for p in procs if p.returncode != 0]
    if bad:
        raise RuntimeError("worker failed:\n" + "\n".join(
            f"--- rc {p.returncode}\n{logs[p][-4000:]}" for p in bad))
    return [[dict(np.load(o)) for o in outs] for _, outs in groups]


def same_worker(one, got):
    """Every result array of a worker equals the single process's bit
    for bit, its lanes' sweep counts too; returns the keys that differ."""
    bad = [k for k in one if (k in MP_RESULT or k.startswith(("basis_",
                                                              "coeff_")))
           and not (np.array_equal(one[k], got[k])
                    and one[k].dtype == got[k].dtype)]
    if not np.array_equal(got["n_iter"], one["n_iter"][got["lanes"]]):
        bad.append("n_iter")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="phases to run, comma-separated (default 1-22; "
                         "phase 23, on two cards or more, only when asked)")
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
              "17": ("cell-sharded-mesh", smoke.mesh),
              "18": ("randomized-svd+host", smoke.rsvd_host),
              "19": ("mesh-backends", smoke.mesh_backends),
              "20": ("multi-process", smoke.multi_process),
              "21": ("ell", smoke.ell),
              "22": ("atlas", smoke.atlas_workflow),
              "23": ("multi-card", smoke.multi_card)}
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
    if set(DEFAULT_PHASES) <= set(wanted) and missing:
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
