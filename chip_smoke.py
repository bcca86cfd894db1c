#!/usr/bin/env python3
"""Smoke run of ccfindr_tpu_torch on one NVIDIA GPU.

Drives the port's two main paths through their public entry points,
the batched VB rank scan (``vb_factorize``) and the ML rank scan
(``factorize``), both on ``backend='pallas'``, after checking each CUDA
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
   (pend + dterm) / (n m).  TF32 is off for the plain side;
3. the VB slice: read_10x(pbmc_sim_dir()) -> filter_cells ->
   filter_genes -> vb_factorize(ranks 2..8, nrun 3, backend='pallas',
   device='cuda') in float32 -> optimal_rank (must be 5) -> cluster_id
   (5 clusters) -> build_tree/newick (tips 5.1..5.5); every kernel's
   launch count must be > 0 and the four counts equal.  ropt for seeds
   1 and 2 is printed, not gated;
4. VB at 10x scale: vb_factorize on the 4096 x 8192 planted matrix
   (int8), ranks [8, 12, 16], nrun 2, Itmax 300: wall time and
   lane-sweeps per second (CUDA events, synchronised), the same loop on
   the plain version beside it, per-kernel times, and the peak device
   memory;
5. ML kernel vs plain: M1 ml_hpass (+ M3 ml_xlog_sum) and M2 ml_wpass
   on a ragged case (737 x 450, 12 lanes of ranks 4..6 x 4 padded to
   6, masked rows at eps) and the 10x case (4096 x 8192, 3 lanes of
   r = 16), X int8 and float32, factors float64 and float32.
   Tolerances (elementwise relative): float64 1e-10 on hn, wn and the
   x*log(wh) sum; float32 2e-4 on hn/wn and 1e-5 on the per-element
   likelihood (sum x log wh - sum wh + lgconst) / (n m).  Two launches
   must be bit-identical;
6. the ML workflow on the bundled data after phase 3's QC:
   factorize(ranks [4, 5, 6], nrun 4, Itmax 400, Tol 1e-4,
   backend='pallas', device='cuda').  In float64 it must equal the same
   call on backend='dense_fused' (n_iter of every lane, likelihood to
   1e-9, dispersion and cophenetic to 1e-12).  In float32, for seeds 0,
   1 and 2: a finite measure table; rank 5's dispersion >= 0.99 and the
   largest of the three for at least two of the seeds (one restart of
   four stuck in another optimum gives ~0.93, for some seeds of either
   package); seed 0's rank-5 clusters are 5 with concordance >= 0.95
   against the planted labels; M1-M3 launched.  Then the workflow's
   last steps on phase 3's VB result: meta_genes/meta_gene_cv at rank
   5 and assign_celltype with the PBMC markers: all five types found;
7. ML at 10x scale: factorize on phase 4's planted matrix, ranks
   [8, 12, 16], nrun 2, Itmax 300: wall time, lane-sweeps per second,
   the same loop on the plain version, M1-M3 against plain, peak device
   memory.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``, printed only when
every phase passed.  Run from the root of the repository:
``python3 chip_smoke.py`` (``--phases 1,5`` runs a subset).
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
              "ml_wpass": "ccfindr_tpu/ops/pallas/ml_kernels.py:64",
              "ml_xlog_sum": "ccfindr_tpu/ops/pallas/ml_kernels.py:39"}
ML_SOURCE = "ccfindr_tpu_torch/csrc/ml.cu"
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


def compare_sweep(args, dt):
    """Kernel sweep vs plain sweep on the same inputs; returns a dict of
    errors and whether they are within the stated tolerances."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import sol

    x, lwt, lh, eh, sc, kw = args
    got = sol.sol_sweep(x, lwt, lh, eh, sc, **kw)
    torch.cuda.synchronize()
    want = sol.sol_sweep_plain(x, lwt, lh, eh, sc, **kw)
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
    """M1 + M3 and M2 vs their plain versions on the same inputs, and a
    second launch of each for bit-identity."""
    import torch

    from ccfindr_tpu_torch.ops.kernels import ml as mlk
    from ccfindr_tpu_torch.ops.ml import likelihood_const

    def launch():
        hn, part = mlk.ml_hpass(x, w, h)
        return hn, part, mlk.ml_xlog_sum(part), mlk.ml_wpass(x, w, h)

    hn, part, xlw, wn = launch()
    torch.cuda.synchronize()
    hn_p, xlw_p = mlk.ml_h_plain(x, w, h)
    wn_p = mlk.ml_w_plain(x, w, h)
    n, m = x.shape
    rest = likelihood_const(x, torch.float64) - (
        w.double().sum(-2) * h.double().sum(-1)).sum(-1)
    err = dict(hn=rel_err(hn, hn_p), wn=rel_err(wn, wn_p),
               lik=rel_err((xlw + rest) / (n * m), (xlw_p + rest) / (n * m)),
               xlog_sum=rel_err(xlw, mlk.xlog_sum_plain(part)))
    if dt == torch.float64:
        err["xlog"] = rel_err(xlw, xlw_p)
        ok = all(v <= F64_TOL for v in err.values())
    else:
        ok = (err["hn"] <= F32_FACTOR_TOL and err["wn"] <= F32_FACTOR_TOL
              and err["lik"] <= F32_LIK_TOL and err["xlog_sum"] <= F64_TOL)
    again = launch()
    det = all(torch.equal(a, b) for a, b in zip((hn, part, xlw, wn), again))
    finite = all(bool(torch.isfinite(t).all()) for t in (hn, xlw, wn))
    abs_err = {"ml_hpass": float((hn - hn_p).abs().max()),
               "ml_wpass": float((wn - wn_p).abs().max()),
               "ml_xlog_sum": float((xlw - mlk.xlog_sum_plain(part))
                                    .abs().max())}
    return dict(ok=ok and det and finite, err=err, abs_err=abs_err,
                deterministic=det, finite=finite)


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


class Smoke:
    def __init__(self, verbose):
        self.verbose = verbose
        self.kernels = {k: dict(name=f"sol_{k}", route="cuda",
                                source=SOURCE, replaces=REPLACES)
                        for k in KERNELS}
        self.kernels.update({k: dict(name=k, route="cuda", source=ML_SOURCE,
                                     replaces=rep)
                             for k, rep in ML_KERNELS.items()})
        self.failed = []
        self.filtered = None     # the bundled data after QC (phase 3)
        self.vb_result = None    # phase 3's VB scan, for phase 6's GSEA
        self.x10 = None          # the planted 10x matrix (phase 4)

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
        _, part = mlk.ml_hpass(x, w0, h0)
        timed = {
            "ml_hpass": (lambda: mlk.ml_hpass(x, w0, h0),
                         lambda: mlk.ml_h_plain(x, w0, h0)),
            "ml_wpass": (lambda: mlk.ml_wpass(x, w0, h0),
                         lambda: mlk.ml_w_plain(x, w0, h0)),
            "ml_xlog_sum": (lambda: mlk.ml_xlog_sum(part),
                            lambda: mlk.xlog_sum_plain(part)),
        }
        for k, (kern, plain) in timed.items():
            self.kernels[k]["ms"] = cuda_ms(kern, 20)
            self.kernels[k]["plain_ms"] = cuda_ms(plain, 5)
            print(f"  {k}: kernel {self.kernels[k]['ms']:.4f} ms, plain "
                  f"{self.kernels[k]['plain_ms']:.4f} ms", flush=True)
        print(f"  lane-sweeps/s kernel {runs['kernel']} plain "
              f"{runs['plain']}")
        return bool(np.isfinite(f.measure.drop(columns="rank").values).all())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7")
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
              "7": ("ml-10x-scale", smoke.ml_scale)}
    wanted = args.phases.split(",")
    if "1" not in wanted:
        wanted = ["1"] + wanted
    for p in wanted:
        smoke.phase(*phases[p])
    if "jax" in sys.modules:
        print("chip_smoke: JAX was imported", file=sys.stderr)
        smoke.failed.append("no-jax")
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
