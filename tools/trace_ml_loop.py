"""Traced runs of the port's ML convergence loop on one NVIDIA GPU.

For the two ML cells of PERF.md -- the bundled pbmc_sim scan (684 x 447
after QC, ranks 4..6 x 4 restarts = 12 lanes padded to rank 6, int16
X) and the 10x-scale planted matrix (4096 x 8192, ranks 8/12/16 x 2 =
6 lanes padded to 16, int8 X) -- prints each kernel's time per launch
and its plain version's (CUDA events), then runs ``ml_run`` on the CUDA
backend with ``tol=0`` (a fixed number of sweeps) untraced and under
``torch.profiler``: wall time, device-busy time (union of kernel
intervals), the idle share, and device time by kernel.  Run from the
repository root: ``python3 tools/trace_ml_loop.py``.
"""
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from chip_smoke import bundled_filtered, cuda_ms, planted  # noqa: E402
from tools.trace_vb_loop import busy, smi  # noqa: E402

from ccfindr_tpu_torch.drivers.ml_driver import initial_factors  # noqa: E402
from ccfindr_tpu_torch.ops import ml as ml_ops  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import ml as mlk  # noqa: E402

dev = torch.device("cuda")


def setup(x_np, ranks, nrun, rmax):
    n, m = x_np.shape
    x = torch.as_tensor(x_np, device=dev)
    pairs = [(k, i) for k in range(len(ranks)) for i in range(nrun)]
    w0, h0 = initial_factors(0, 0, pairs, len(ranks), nrun, n, m, rmax,
                             torch.float32, dev)
    ra = np.repeat(ranks, nrun)
    rm = torch.as_tensor((np.arange(rmax)[None] < ra[:, None])
                         .astype(np.float32), device=dev)
    return x, w0, h0, rm


def traced(name, args, sweeps):
    x, w0, h0, rm = args
    fh, fw = mlk.make_ml_backend()
    kw = dict(rank_mask=rm, tol=0.0, fused_h=fh, fused_w=fw)
    ml_ops.ml_run(x, w0, h0, itmax=5, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ml_ops.ml_run(x, w0, h0, itmax=sweeps, **kw)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as p:
        t0 = time.perf_counter()
        ml_ops.ml_run(x, w0, h0, itmax=sweeps, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    b, nk = busy(p.events())
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
    for e in rows[:12]:
        d = getattr(e, "self_device_time_total", 0)
        if d > 0:
            print(f"   {e.key[:60]:60s} calls {e.count:6d} device "
                  f"{d / 1e3:10.3f} ms  share {d / dev_sum:.4f}")


def kernel_times(name, args):
    x, w, h, _ = args
    t = {"ml_hpass": cuda_ms(lambda: mlk.ml_hpass(x, w, h), 50),
         "ml_wpass": cuda_ms(lambda: mlk.ml_wpass(x, w, h), 50),
         "ml_h_plain": cuda_ms(lambda: mlk.ml_h_plain(x, w, h), 10),
         "ml_w_plain": cuda_ms(lambda: mlk.ml_w_plain(x, w, h), 10)}
    print(f"== {name} per-call ms (CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi())
    from ccfindr_tpu_torch.ops.kernels import build
    build.library()
    s = bundled_filtered()
    xb = s.counts_dense(dtype=np.float32).astype(np.int16)
    bundled = setup(xb, [4, 5, 6], 4, 6)
    big = setup(planted(4096, 8192, 16, seed=0), [8, 12, 16], 2, 16)
    kernel_times("bundled 684x447 B=12 r=6 int16", bundled)
    kernel_times("10x 4096x8192 B=6 r=16 int8", big)
    traced("bundled 684x447 B=12 r=6 int16", bundled, 200)
    traced("10x 4096x8192 B=6 r=16 int8", big, 100)
    print(smi())


if __name__ == "__main__":
    main()
