"""Whether a process's share of a grid, one lane or more, gives the bits
its lanes had in the one-process batch, on one NVIDIA GPU, backend by
backend.

Each case runs ``python -m ccfindr_tpu_torch.parallel._mh_worker`` alone
(``--nproc 1``) and as a group whose processes share ``cuda:0``, one of
them owning a single lane of a larger grid: ranks 8, 12, 16 with nrun 1
over 2 processes at phase 4's 10x shape (process 1 runs a batch of one
lane where the single process ran three), for every VB and ML backend;
and the bundled data's ranks 4, 5 over 3 processes (two lanes of one,
one process idle).  Prints, a case a line, whether every process's
measure table, factors and sweep counts equal the one process's bit for
bit, and which process and arrays differ where one does, beside the
card's name and power limit.  Exit code 1 if any case differs or a
worker fails.

Run from the repository's root: ``python3 tools/check_lone_lane.py``.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, ".")
from chip_smoke import (bundled_filtered, finish_workers, planted_10x,  # noqa: E402
                        same_worker, start_workers)

GRID = dict(ranks="8,12,16", nrun=1, itmax=300)
CASES = ([("vb", b, "float32") for b in ("pallas", "pallas2pass", "sparse",
                                         "dense", "dense_fused")]
         + [("vb", "pallas", "float64")]
         + [("ml", b, "float32") for b in ("pallas", "sparse", "dense",
                                           "dense_fused")])


def main():
    import torch

    if not torch.cuda.is_available():
        print("check_lone_lane: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from ccfindr_tpu_torch.ops.kernels import build

    build.build()           # once here, not in every worker at once
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        x10f = os.path.join(tmp, "x10.npz")
        np.savez(x10f, x=planted_10x())
        bundf = os.path.join(tmp, "bundled.npz")
        np.savez(bundf, x=bundled_filtered().counts_dense(dtype=np.float64))
        runs = [(f"{mode} {be} {dt} 10x, 3 lanes over 2 processes", 2,
                 dict(mode=mode, x=x10f, backend=be, dtype=dt, **GRID))
                for mode, be, dt in CASES]
        runs.append(("vb pallas float32 bundled, 2 lanes over 3 processes",
                     3, dict(mode="vb", x=bundf, ranks="4,5", nrun=1,
                             itmax=3000, backend="pallas",
                             dtype="float32")))
        for i, (label, nproc, kw) in enumerate(runs):
            (one,), got = finish_workers(
                start_workers(tmp, f"c{i}_one", 1, **kw),
                start_workers(tmp, f"c{i}_p", nproc, **kw))
            shares = [len(g["lanes"]) for g in got]
            bad = {pid: same_worker(one, g) for pid, g in enumerate(got)}
            good = not any(bad.values())
            ok &= good
            print(f"{label}: lanes a process {shares}; "
                  + ("every process bit-identical to one process"
                     if good else f"differs from one process: {bad}"),
                  flush=True)
    print(f"check_lone_lane: {'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
