"""Host time of the ML passes on one NVIDIA GPU, at the bundled shape
(684 x 447 int16 after QC, 12 lanes of ranks 4..6 x 4, r 6, float32),
where the ML loop is host-bound.

Prints, for the tree whose root is the current directory: the host
microseconds of one M1 ``ml_hpass`` and one M2 ``ml_wpass`` call
(2,000 calls: the enqueue alone, then with the final synchronise), and
three readings of ``ml_run``'s wall a sweep (200 sweeps, ``tol=0``,
the kernels' backend, after 5 warm-up sweeps).  Two trees are compared
by running it from each in turns, one process a reading, e.g. from a
tree unpacked by ``git archive`` into ``.archive/``:
``python3 tools/bench_ml_host.py TAG`` (TAG labels the output line).
"""
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from chip_smoke import bundled_filtered, ml_inputs  # noqa: E402

from ccfindr_tpu_torch.drivers.ml_driver import initial_factors  # noqa: E402
from ccfindr_tpu_torch.ops import ml as ml_ops  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import build  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import ml as mlk  # noqa: E402


def main(tag):
    dev = torch.device("cuda")
    build.library()
    xb = np.asarray(bundled_filtered().counts_dense(dtype=np.float64))
    x, w, h = ml_inputs(xb, [rk for rk in range(4, 7) for _ in range(4)],
                        6, torch.float32, torch.int16, 5, dev)
    for _ in range(20):
        mlk.ml_hpass(x, w, h)
        mlk.ml_wpass(x, w, h)
    torch.cuda.synchronize()
    host = {}
    for name, fn in (("hpass", lambda: mlk.ml_hpass(x, w, h)),
                     ("wpass", lambda: mlk.ml_wpass(x, w, h))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host[name] = ((t1 - t0) / 2000 * 1e6, (t2 - t0) / 2000 * 1e6)

    n, m = xb.shape
    ranks, nrun = [4, 5, 6], 4
    pairs = [(k, i) for k in range(len(ranks)) for i in range(nrun)]
    w0, h0 = initial_factors(0, 0, pairs, len(ranks), nrun, n, m, 6,
                             torch.float32, dev)
    ra = np.repeat(ranks, nrun)
    rm = torch.as_tensor((np.arange(6)[None] < ra[:, None])
                         .astype(np.float32), device=dev)
    xt = torch.as_tensor(xb.astype(np.int16), device=dev)
    fh, fw = mlk.make_ml_backend()
    kw = dict(rank_mask=rm, tol=0.0, fused_h=fh, fused_w=fw)
    ml_ops.ml_run(xt, w0, h0, itmax=5, **kw)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ml_ops.ml_run(xt, w0, h0, itmax=200, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 201 * 1e3)
    print(f"{tag}: host us a launch (enqueue, with sync) hpass "
          f"{host['hpass'][0]:.2f}, {host['hpass'][1]:.2f}; wpass "
          f"{host['wpass'][0]:.2f}, {host['wpass'][1]:.2f}; bundled ml_run "
          f"ms a sweep {', '.join(f'{v:.4f}' for v in walls)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
