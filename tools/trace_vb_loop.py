"""Traced runs of the port's VB convergence loop on one NVIDIA GPU.

For the two cells of PERF.md -- the bundled pbmc_sim scan (684 x 447
after QC, 21 lanes, rank <= 8, int16 X) and the 10x-scale planted
matrix (4096 x 8192, 6 lanes, rank <= 16, int8 X) -- prints each
kernel's time per launch (CUDA events), then runs ``vb_run_sol`` with
``tol=0`` (a fixed number of sweeps) untraced and under
``torch.profiler``: wall time, device-busy time (union of kernel
intervals), the idle share, and device time by kernel.  Run from the
repository root: ``python3 tools/trace_vb_loop.py``.
"""
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
from ccfindr_tpu_torch.ops.kernels import sol  # noqa: E402

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


def traced(name, args, sweeps):
    x, st, hy, rm, rt = args
    kw = dict(rank_mask=rm, r_true=rt, tol=0.0)
    sol.vb_run_sol(x, st, hy, itmax=5, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol.vb_run_sol(x, st, hy, itmax=sweeps, **kw)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as p:
        t0 = time.perf_counter()
        sol.vb_run_sol(x, st, hy, itmax=sweeps, **kw)
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
          f"device events {nk}")
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
                                                m=m, r=r), 50),
         "plain_sweep": cuda_ms(lambda: sol.sol_sweep_plain(
             x, lwt, lh, eh, sc, n=n, m=m, r=r), 10)}
    print(f"== {name} per-call ms (CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi())
    from ccfindr_tpu_torch.ops.kernels import build
    build.library()
    s = ct.read_10x(pbmc_sim_dir())
    s = ct.filter_cells(s, umi_min=700, umi_max=8000, plot=False)
    s = ct.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                        plot=False, verbose=False)
    xb = s.counts_dense(dtype=np.float32).astype(np.int16)
    bundled = setup(xb, list(range(2, 9)), 3, 8)
    big = setup(planted(4096, 8192, 16, seed=0), [8, 12, 16], 2, 16)
    kernel_times("bundled 684x447 B=21 rp=8 int16", bundled)
    kernel_times("10x 4096x8192 B=6 rp=16 int8", big)
    traced("bundled 684x447 B=21 rp=8 int16", bundled, 200)
    traced("10x 4096x8192 B=6 rp=16 int8", big, 100)
    print(smi())


if __name__ == "__main__":
    main()
