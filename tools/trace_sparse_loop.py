"""Traced runs of the port's sparse convergence loops on one NVIDIA GPU.

For the sparse cells of PERF.md -- the planted 10x matrix masked to 10%
density (chip_smoke.py phase 10: 6 lanes, rank <= 16, int16 values) and
the atlas leg (20480 x 100352 at 2%, 2 lanes of rank 16) -- runs the VB
loop (``vb_run`` over ``tile.make_tile_fused``) and, at 10x, the ML
loop (``ml_run`` over ``tile.make_tile_ml_backend``) with ``tol=0`` for
a fixed number of sweeps, untraced and under ``torch.profiler``: wall
time, device-busy time (union of kernel intervals), the idle share,
device time by kernel and the host's largest self times.  Run from the
repository root: ``python3 tools/trace_sparse_loop.py``.
"""
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
sys.path.insert(0, "tools")
from chip_smoke import ATLAS, atlas_csr, masked_10x, planted_10x  # noqa
from trace_vb_loop import busy, smi  # noqa: E402

from ccfindr_tpu_torch.drivers.ml_driver import initial_factors  # noqa
from ccfindr_tpu_torch.ops import ml as ml_ops  # noqa: E402
from ccfindr_tpu_torch.ops import tile  # noqa: E402
from ccfindr_tpu_torch.ops import vb  # noqa: E402

dev = torch.device("cuda")


def masks(ranks, nrun, rmax):
    ra = np.repeat(ranks, nrun)
    rm = torch.as_tensor((np.arange(rmax)[None] < ra[:, None])
                         .astype(np.float32), device=dev)
    return rm, torch.as_tensor(ra.astype(np.float32), device=dev)


def vb_loop(tc, ranks, nrun, rmax):
    gen = torch.Generator().manual_seed(0)
    h1 = vb.Hyper(1.0, 1.0, 1.0, 1.0)
    nb = len(ranks) * nrun
    sts = [vb.vb_init_random(gen, tc.n, tc.m, rmax, h1, torch.float32, dev)
           for _ in range(nb)]
    st = vb.VBState(*(torch.stack(f) for f in zip(*sts)))
    hy = vb.Hyper(*(torch.ones(nb, device=dev),) * 4)
    rm, rt = masks(ranks, nrun, rmax)
    fused = tile.make_tile_fused()
    return lambda itmax: vb.vb_run(tc, st, hy, itmax=itmax, tol=0.0,
                                   fused=fused, rank_mask=rm, r_true=rt)


def ml_loop(tc, ranks, nrun, rmax):
    pairs = [(k, i) for k in range(len(ranks)) for i in range(nrun)]
    w0, h0 = initial_factors(0, 0, pairs, len(ranks), nrun, tc.n, tc.m,
                             rmax, torch.float32, dev)
    rm, _ = masks(ranks, nrun, rmax)
    fh, fw = tile.make_tile_ml_backend()
    return lambda itmax: ml_ops.ml_run(tc, w0, h0, itmax=itmax, tol=0.0,
                                       rank_mask=rm, fused_h=fh,
                                       fused_w=fw)


def traced(name, run, sweeps):
    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(sweeps)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as p:
        t0 = time.perf_counter()
        run(sweeps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    b, nk = busy(p.events())
    ka = p.key_averages()
    rows = sorted(ka, key=lambda e: -getattr(e, "self_device_time_total",
                                             0))
    dev_sum = sum(getattr(e, "self_device_time_total", 0) for e in ka)
    print(f"== {name}: {sweeps} sweeps; untraced wall {untraced:.4f} s "
          f"({untraced / sweeps * 1e3:.4f} ms/sweep); traced wall "
          f"{wall:.4f} s; device busy (union) {b / 1e6:.4f} s; device "
          f"kernel-time sum {dev_sum / 1e6:.4f} s; idle share of traced "
          f"wall {1 - b / 1e6 / wall:.4f}; device events {nk} "
          f"({nk / sweeps:.1f} a sweep)", flush=True)
    for e in rows[:12]:
        d = getattr(e, "self_device_time_total", 0)
        if d > 0:
            print(f"   {e.key[:60]:60s} calls {e.count:6d} device "
                  f"{d / 1e3:10.3f} ms  share {d / dev_sum:.4f}")
    print("   top host self time:")
    for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"   {e.key[:60]:60s} calls {e.count:6d} host "
              f"{e.self_cpu_time_total / 1e3:10.3f} ms")


def main():
    print(smi())
    from ccfindr_tpu_torch.ops.kernels import build
    build.library()
    _, csr = masked_10x(planted_10x())
    tc = tile.from_scipy_tile(csr, dtype=torch.float32, device=dev)
    name = f"10x masked {tc.n}x{tc.m} nnz {tc.nnz} B=6 r<=16"
    traced(f"VB {name}", vb_loop(tc, [8, 12, 16], 2, 16), 100)
    traced(f"ML {name}", ml_loop(tc, [8, 12, 16], 2, 16), 100)
    del tc
    big = atlas_csr(*ATLAS)
    tc = tile.from_scipy_tile(big, dtype=torch.float32, device=dev)
    traced(f"VB atlas {tc.n}x{tc.m} nnz {tc.nnz} B=2 r=16",
           vb_loop(tc, [16], 2, 16), 20)
    print(smi())


if __name__ == "__main__":
    main()
