"""Traced runs of the port's VB convergence loop on one NVIDIA GPU.

For the cells of PERF.md -- the bundled pbmc_sim scan (684 x 447 after
QC, 21 lanes, rank <= 8, int16 X), the 10x-scale planted matrix (4096 x
8192, 6 lanes, rank <= 16, int8 X), both on the cell-major loop
``vb_run_sol``, and the gene-major cell (planted 100,000 x 4,096, 6
lanes, rank <= 16, int8 X) on ``vb_run_epi(layout='gm')``, the loop
``vb_factorize(backend='pallas')`` takes there, and the two-pass cell
(the 10x matrix in float32, zero-padded, on ``ops.vb.vb_run`` with
``make_pallas_backend()``: ``backend='pallas2pass'``) -- prints each
kernel's time per launch (CUDA events), then runs the loop with
``tol=0`` (a fixed number of sweeps) untraced and under
``torch.profiler``: wall time, device-busy time (union of kernel
intervals), the idle share, device launches a sweep, and device time
by kernel.  Run from the repository root: ``python3
tools/trace_vb_loop.py`` (``--cells gm`` runs one cell).
"""
import argparse
import functools
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from chip_smoke import cuda_ms, planted  # noqa: E402

import ccfindr_tpu_torch as ct  # noqa: E402
from ccfindr_tpu_torch.data import pbmc_sim_dir  # noqa: E402
from ccfindr_tpu_torch.ops import vb  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import epilogue as epi  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import sol  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk  # noqa: E402

dev = torch.device("cuda")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def setup(x_np, ranks, nrun, rmax):
    n, m = x_np.shape
    x = torch.as_tensor(x_np, device=dev)
    gen = torch.Generator().manual_seed(0)
    h1 = vb.Hyper(1.0, 1.0, 1.0, 1.0)
    nb = len(ranks) * nrun
    ra = np.repeat(ranks, nrun)
    sts = [vb.vb_init_random(gen, n, m, rmax, h1, torch.float32, dev)
           for _ in range(nb)]
    st = vb.VBState(*(torch.stack(f) for f in zip(*sts)))
    hy = vb.Hyper(*(torch.ones(nb, device=dev),) * 4)
    rm = torch.as_tensor((np.arange(rmax)[None] < ra[:, None])
                         .astype(np.float32), device=dev)
    rt = torch.as_tensor(ra.astype(np.float32), device=dev)
    return x, st, hy, rm, rt


def busy(events):
    """Device-busy microseconds (union of kernel intervals) and the
    number of device events."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CUDA)
    tot, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                tot += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        tot += cur_e - cur_s
    return tot, len(iv)


def traced(name, args, sweeps, run=sol.vb_run_sol):
    x, st, hy, rm, rt = args
    kw = dict(rank_mask=rm, r_true=rt, tol=0.0)
    run(x, st, hy, itmax=5, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(x, st, hy, itmax=sweeps, **kw)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as p:
        t0 = time.perf_counter()
        run(x, st, hy, itmax=sweeps, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = p.events()
    b, nk = busy(ev)
    ka = p.key_averages()
    rows = sorted(ka, key=lambda e: -getattr(e, "self_device_time_total",
                                             0))
    dev_sum = sum(getattr(e, "self_device_time_total", 0) for e in ka)
    print(f"== {name}: {sweeps + 1} loop iterations; untraced wall "
          f"{untraced:.4f} s ({untraced / (sweeps + 1) * 1e3:.4f} ms/sweep);"
          f" traced wall {wall:.4f} s; device busy (union) {b / 1e6:.4f} s;"
          f" device kernel-time sum {dev_sum / 1e6:.4f} s; "
          f"idle share of traced wall {1 - b / 1e6 / wall:.4f}; "
          f"device events {nk} ({nk / (sweeps + 1):.1f} a sweep)")
    for e in rows[:14]:
        d = getattr(e, "self_device_time_total", 0)
        if d <= 0:
            continue
        print(f"   {e.key[:60]:60s} calls {e.count:6d} device "
              f"{d / 1e3:10.3f} ms  share {d / dev_sum:.4f}")
    cpu = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:8]
    print("   top host self time:")
    for e in cpu:
        print(f"   {e.key[:60]:60s} calls {e.count:6d} host "
              f"{e.self_cpu_time_total / 1e3:10.3f} ms")


def kernel_times(name, args):
    x, st, hy, rm, rt = args
    nb, n, r = st.lw.shape
    m = st.lh.shape[-1]
    rp = sol.round_up(max(r, 8), 8)
    lwt = torch.zeros(nb, rp, n, device=dev)
    lwt[:, :r] = st.lw.transpose(-1, -2)
    lh = torch.zeros(nb, rp, m, device=dev)
    lh[:, :r] = st.lh
    eh = lh.clone()
    sc = torch.ones(nb, 8, dtype=torch.float64, device=dev)
    sc[:, 4] = 1.2e-7
    sc[:, 5] = rt.double()
    k1 = sol.xpass(x, lwt, lh, eh, sc)
    k2 = sol.w_post(k1[0], lwt, k1[3], sc, r, n)
    k3 = sol.h_post(k1[1], lh, k2[3], sc, r, m)
    fin = dict(n=n, m=m, dt=torch.float32, hyper_mask=(True,) * 4,
               newton_niter=100, newton_tol=1e-4)
    t = {"xpass": cuda_ms(lambda: sol.xpass(x, lwt, lh, eh, sc), 50),
         "w_post": cuda_ms(lambda: sol.w_post(k1[0], lwt, k1[3], sc, r, n),
                           50),
         "h_post": cuda_ms(lambda: sol.h_post(k1[1], lh, k2[3], sc, r, m),
                           50),
         "finish": cuda_ms(lambda: sol.finish(sc, k1[2], k2[3], k2[4], k3[3],
                                              k3[4], **fin), 50),
         "sweep": cuda_ms(lambda: sol.sol_sweep(x, lwt, lh, eh, sc, n=n,
                                                m_arr=m, m_live=m, r=r), 50),
         "plain_sweep": cuda_ms(lambda: sol.sol_sweep_plain(
             x, lwt, lh, eh, sc, n=n, m_arr=m, m_live=m, r=r), 10)}
    print(f"== {name} per-call ms (CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))


def epi_kernel_times(name, args):
    """Per-launch ms of the gene-major sweep's kernels (E1 'gm', E1s,
    E2, E3, K4) and of the whole sweep."""
    x, st, hy, rm, rt = args
    nb, n, r = st.lw.shape
    m = st.lh.shape[-1]
    lw = st.lw.contiguous()
    lh = st.lh.contiguous()
    eh = lh.clone()
    sc = torch.ones(nb, 8, dtype=torch.float64, device=dev)
    sc[:, 4] = 1.2e-7
    sc[:, 5] = rt.double()
    e1 = vbk.fused_xpass(x, lw, lh, layout="gm")
    swn, shn, xlog = vbk.fused_pallas_raw(x, lw, lh, layout="gm")
    ehs = eh.sum(-1, dtype=torch.float64)[:, None]
    e2 = epi.epi_w_post(swn, lw, ehs, sc, r, n)
    e3 = epi.epi_h_post(shn, lh, e2[3], sc, r, m, m)
    fin = dict(n=n, m=m, dt=torch.float32, hyper_mask=(True,) * 4,
               newton_niter=100, newton_tol=1e-4)
    t = {"fused_xpass_gm": cuda_ms(
            lambda: vbk.fused_xpass(x, lw, lh, layout="gm"), 10),
         "fused_sum": cuda_ms(lambda: vbk.fused_sum(e1[1], e1[2]), 20),
         "epi_w_post": cuda_ms(
             lambda: epi.epi_w_post(swn, lw, ehs, sc, r, n), 20),
         "epi_h_post": cuda_ms(
             lambda: epi.epi_h_post(shn, lh, e2[3], sc, r, m, m), 20),
         "finish": cuda_ms(lambda: sol.finish(sc, xlog[:, None], e2[3],
                                              e2[4], e3[3], e3[4], **fin),
                           20),
         "sweep": cuda_ms(lambda: epi.epi_sweep(x, lw, lh, eh, sc, n=n,
                                                m=m, r=r, layout="gm"), 10)}
    print(f"== {name} per-call ms (CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="bundled,10x,gm,p2")
    cells = ap.parse_args().cells.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi())
    from ccfindr_tpu_torch.ops.kernels import build
    build.library()
    if "bundled" in cells:
        s = ct.read_10x(pbmc_sim_dir())
        s = ct.filter_cells(s, umi_min=700, umi_max=8000, plot=False)
        s = ct.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                            plot=False, verbose=False)
        xb = s.counts_dense(dtype=np.float32).astype(np.int16)
        bundled = setup(xb, list(range(2, 9)), 3, 8)
        kernel_times("bundled 684x447 B=21 rp=8 int16", bundled)
        traced("bundled 684x447 B=21 rp=8 int16", bundled, 200)
        del bundled
    if "10x" in cells:
        big = setup(planted(4096, 8192, 16, seed=0), [8, 12, 16], 2, 16)
        kernel_times("10x 4096x8192 B=6 rp=16 int8", big)
        traced("10x 4096x8192 B=6 rp=16 int8", big, 100)
        del big
    if "gm" in cells:
        xg = planted(100_000, 4096, 16, seed=0)
        xg = xg[xg.sum(axis=1) > 0][:, xg.sum(axis=0) > 0]
        gm = setup(np.ascontiguousarray(xg), [8, 12, 16], 2, 16)
        name = f"gene-major {xg.shape[0]}x{xg.shape[1]} B=6 rp=16 int8"
        epi_kernel_times(name, gm)
        traced(name, gm, 20,
               run=functools.partial(epi.vb_run_epi, layout="gm"))
    if "p2" in cells:
        x, st, hy, rm, rt = setup(planted(4096, 8192, 16, seed=0),
                                  [8, 12, 16], 2, 16)
        ss, dt = vbk.make_pallas_backend()
        traced("two-pass 10x 4096x8192 B=6 r=16 float32 X",
               (vbk.pad_matrix(x.float()), st, hy, rm, rt), 50,
               run=functools.partial(vb.vb_run, suffstats=ss, data_term=dt))
    print(smi())


if __name__ == "__main__":
    main()
