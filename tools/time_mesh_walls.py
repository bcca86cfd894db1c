"""The VB driver's walls over a gene-sharded mesh on one NVIDIA GPU.

Times ``vb_factorize`` over ``make_mesh(genes=2, cells=2)`` with every
device ``cuda:0`` on each route that shards the genes (``'pallas'``: E1
+ E1s a block; ``'dense'``, ``'dense_fused'``, ``'pallas2pass'``) at 10x
(``chip_smoke.planted_10x``: 4,096 x 8,192 int8; ranks [8, 12, 16] x 2
restarts, ``--itmax`` sweeps at Tol 0), the gene-major X on
``'pallas'`` (``chip_smoke.planted_gm``: 100,000 x 4,096, ``--gm-itmax``
sweeps), and the 10x ``'dense'`` scan over ``cells=2`` as a control that
shards no genes.  For each: the call's wall, its loop
(``metadata['timings']``), the sweeps and a digest of the lml's bits.
A small call first builds and loads the kernels, so that no timed call
compiles.

The ``ccfindr_tpu_torch`` it times is the first one on ``sys.path``:
``PYTHONPATH=<another checkout> python3 tools/time_mesh_walls.py``
times that checkout's driver on the same X.  Run two checkouts in turns
in one call (parent, change, change, parent) to compare them on one
card.  Prints the card's name and power limit first and one JSON object
last.

Run from the repository's root: ``python3 tools/time_mesh_walls.py
[--label L] [--itmax 30] [--gm-itmax 10] [--skip-gm]``.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# after PYTHONPATH's entries: another checkout given there comes first
sys.path.append(ROOT)

import ccfindr_tpu_torch as ct  # noqa: E402

SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(label, x, mesh, **kw):
    """One vb_factorize call on ``mesh``: a line and a record."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ct.vb_factorize(x, mesh=mesh, device="cuda", verbose=0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = res.metadata["timings"][0]
    lml = np.ascontiguousarray(np.asarray(res.measure["lml"], np.float64))
    out = dict(label=label, wall_s=wall, loop_s=rec["seconds"],
               sweeps=int(rec["total_sweeps"]),
               lml_digest=hashlib.sha1(lml.tobytes()).hexdigest()[:12])
    print(f"  {label}: wall {wall:.3f} s, loop {rec['seconds']:.3f} s, "
          f"{out['sweeps']} lane-sweeps, lml digest {out['lml_digest']}",
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.dirname(ct.__file__))
    ap.add_argument("--itmax", type=int, default=30)
    ap.add_argument("--gm-itmax", type=int, default=10)
    ap.add_argument("--skip-gm", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_mesh_walls.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"ccfindr_tpu_torch from {os.path.dirname(ct.__file__)} "
          f"({args.label})", flush=True)
    smoke = _smoke()
    dev = torch.device("cuda", 0)

    def mesh(cells, genes=1):
        return ct.make_mesh(cells=cells, genes=genes,
                            devices=[dev] * (cells * genes))

    small = smoke.planted(512, 1024, 4, seed=1)
    for backend in ("pallas", "pallas2pass"):
        ct.vb_factorize(small, ranks=[4], Itmax=2, backend=backend,
                        mesh=mesh(2, 2), device="cuda", verbose=0)
    x10 = smoke.planted_10x()
    kw = dict(ranks=[8, 12, 16], nrun=2, Itmax=args.itmax, Tol=0.0, seed=0)
    recs = []
    for backend in ("pallas", "dense", "dense_fused", "pallas2pass"):
        recs.append(timed(f"{backend} 10x genes=2 cells=2", x10,
                          mesh(2, 2), backend=backend, **kw))
    recs.append(timed("dense 10x cells=2 (no gene shards)", x10, mesh(2),
                      backend="dense", **kw))
    if not args.skip_gm:
        s = ct.SCSet(count=smoke.planted_gm(), remove_zeros=False)
        recs.append(timed("pallas gene-major 100,000 x 4,096 genes=2 "
                          "cells=2", s, mesh(2, 2), backend="pallas",
                          **dict(kw, Itmax=args.gm_itmax)))
    print(json.dumps(dict(label=args.label, runs=recs)), flush=True)


if __name__ == "__main__":
    main()
