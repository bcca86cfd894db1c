"""One process of a rank scan over several processes.

Counterpart of ``ccfindr_tpu/parallel/_mh_worker.py``.  Started as
``python -m ccfindr_tpu_torch.parallel._mh_worker --pid I --nproc N
--port P --out FILE ...`` once for each process (tests/
test_torch_multihost.py, and ``chip_smoke.py``'s multi-process phase on
the card): it joins a gloo group on ``127.0.0.1:P``
(``init_distributed``), runs the same ``vb_factorize`` or ``factorize``
call as its peers, whose (rank, run) grid is split across the processes
(``parallel/schedule.py``), and writes what it returned to ``FILE``
(``.npz``): the measure table's columns, each rank's factors, the
sweep counts and grid indices of the lanes it ran, and the kernels'
launch counts.  ``--nproc 1`` is the single-process run the others are
held against.  The reference's Rmpi restart farm (R/bayesian.R:260-263)
across real process boundaries.

Without ``--x`` the problem is :func:`build_problem`'s toy matrix; with
it, the ``x`` array of an ``.npz`` the caller wrote.  ``--device`` is
``cpu``, ``cuda`` or a card ``cuda:N``: processes may share one card
(``--device cuda``; the exchanges are host arrays) or each take its
own (``--device cuda:I`` for process I), and ``--cells K`` lays a mesh
of K cell shards over that device.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np


def build_problem(cf, nrow=24, ncol=36, rank=3, seed=77):
    """The shared toy factorization problem (deterministic in seed):
    the JAX package's, from the port's copy of ``simulate_whx``."""
    sim = cf.simulate_whx(nrow=nrow, ncol=ncol, rank=rank, seed=seed)
    return cf.SCSet(count=sim["x"])


def _kernel_modules():
    from ..ops.kernels import (epilogue, ml, sol, sol_sharded, sparse,
                               vb_kernels)

    return dict(sol=sol, ml=ml, sparse=sparse, epilogue=epilogue,
                vb_kernels=vb_kernels, sol_sharded=sol_sharded)


def _device(s):
    """``--device``: ``cpu``, ``cuda`` or ``cuda:N``."""
    if re.fullmatch(r"cpu|cuda(:\d+)?", s) is None:
        raise argparse.ArgumentTypeError(
            f"--device takes cpu, cuda or cuda:N, not {s!r}")
    return s


def parse(argv=None):
    """The worker's arguments."""
    p = argparse.ArgumentParser()
    p.add_argument("--pid", type=int, required=True)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--port", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--x64", action="store_true",
                   help="factors in float64 (the default on the CPU)")
    p.add_argument("--itmax", type=int, default=300)
    p.add_argument("--ranks", default="2,3,4")
    p.add_argument("--nrun", type=int, default=3)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--mode", default="vb", choices=("vb", "ml"))
    p.add_argument("--device", default="cuda", type=_device,
                   help="cpu, cuda or a card cuda:N")
    p.add_argument("--backend", default="dense")
    p.add_argument("--sparse-layout", default="auto",
                   help="backend='sparse''s layout: auto, tile, coo or ell")
    p.add_argument("--dtype", choices=("float32", "float64"))
    p.add_argument("--x", help="an .npz whose 'x' is the count matrix")
    p.add_argument("--initializer", default="random")
    p.add_argument("--cells", type=int, default=0,
                   help="run over a mesh of this many cell shards on "
                        "--device")
    p.add_argument("--cophenetic-max-cells", type=int, default=10000,
                   help="--mode ml: factorize's cophenetic_max_cells")
    p.add_argument("--cophenetic-nsub", type=int, default=3,
                   help="--mode ml: factorize's cophenetic_nsub")
    p.add_argument("--checkpoint-every", type=int)
    p.add_argument("--checkpoint-dir")
    return p.parse_args(argv)


def worker_mesh(a):
    """The mesh of ``--cells`` cell shards, all on ``--device`` (None
    without ``--cells``)."""
    if not a.cells:
        return None
    from .mesh import make_mesh

    return make_mesh(cells=a.cells, devices=[a.device] * a.cells)


def main(argv=None):
    a = parse(argv)

    import torch

    import ccfindr_tpu_torch as ct

    ct.init_distributed(f"127.0.0.1:{a.port}", a.nproc, a.pid)
    dist = torch.distributed
    assert a.nproc == 1 or dist.get_world_size() == a.nproc

    dtype = {"float32": torch.float32, "float64": torch.float64,
             None: torch.float64 if a.x64 else None}[a.dtype]
    if a.x is None:
        s = build_problem(ct)
    else:
        with np.load(a.x) as z:
            s = ct.SCSet(count=z["x"])
    ranks = [int(r) for r in a.ranks.split(",")]
    kw = dict(ranks=ranks, nrun=a.nrun, verbose=0, Itmax=a.itmax,
              seed=a.seed, backend=a.backend, dtype=dtype, device=a.device,
              sparse_layout=a.sparse_layout,
              checkpoint_every=a.checkpoint_every,
              checkpoint_dir=a.checkpoint_dir)
    if a.cells:
        kw["mesh"] = worker_mesh(a)
    mods = _kernel_modules()
    for mod in mods.values():
        mod.reset_launches()
    if a.device != "cpu":
        torch.cuda.synchronize(a.device)
    t0 = time.perf_counter()
    if a.mode == "ml":
        out = ct.factorize(s, cophenetic_max_cells=a.cophenetic_max_cells,
                           cophenetic_nsub=a.cophenetic_nsub, **kw)
        arrays = {c: out.measure[c].to_numpy()
                  for c in ("likelihood", "dispersion", "cophenetic")}
        arrays["lml"] = arrays["likelihood"]
        runs = ("ml_rank_batch", "ml_rank")
    else:
        out = ct.vb_factorize(s, initializer=a.initializer, **kw)
        arrays = {c: out.measure[c].to_numpy()
                  for c in ("lml", "aw", "bw", "ah", "bh", "nunif")}
        runs = ("vb_rank_batch", "vb_rank")
    wall = time.perf_counter() - t0
    for k, r in enumerate(out.ranks):
        arrays[f"basis_{r}"] = np.asarray(out.basis[k])
        arrays[f"coeff_{r}"] = np.asarray(out.coeff[k])
    # the lanes this process ran: their grid indices and sweep counts
    n_iter = [v for rec in out.metadata["timings"] if rec["name"] in runs
              for v in rec["n_iter"]]
    n_all = len(ranks) * (1 if a.initializer in ("svd", "svd2")
                          and a.mode == "vb" else a.nrun)
    from .schedule import partition_items

    launches = {f"launches_{m}_{k}": np.int64(v) for m, mod in mods.items()
                for k, v in mod.LAUNCHES.items()}
    np.savez(a.out, ranks=np.asarray(out.ranks), n_iter=np.asarray(n_iter),
             lanes=partition_items(n_all, a.nproc, a.pid), wall=wall,
             **arrays, **launches)
    if a.nproc > 1:
        dist.barrier()
        dist.destroy_process_group()
    assert "jax" not in sys.modules, "the port imported JAX"
    print(f"mh_worker {a.pid}/{a.nproc} done in {wall:.2f} s", flush=True)


if __name__ == "__main__":
    main()
