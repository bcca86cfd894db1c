"""The dense routes' sweep time and lane bits for each form of their
products, on one NVIDIA GPU.

``utils.lane_matmul`` runs the products of ``'dense'`` and
``'dense_fused'`` (``ops/vb.py``, ``ops/ml.py``, the mesh blocks of
``parallel/sharded.py``) so that a lane's bits do not depend on the lane
count.  This script times the bundled rank scans (VB: ranks 2..8, nrun
3, 21 lanes padded to rank 8; ML: ranks 4..6, nrun 4, 12 lanes) and the
10x ones (4096 x 8192, ranks 8, 12, 16, nrun 2: 6 lanes of rank 16) on
both routes, float32, ``Tol`` 0 so that every lane runs ``Itmax``
sweeps, for each form of the products:

* ``batched``: one batched ``torch.matmul`` (the products before
  ``lane_matmul``; cuBLAS picks its algorithm by the batch count);
* ``cK``: ``lane_matmul`` with windows of exactly K lanes
  (``LANE_MATMUL_CHUNK = K``; K = 1 is a product a lane), every window
  on a 256-byte boundary (``_LANE_ALIGN``); ``cKa16`` the same on a
  16-byte boundary, which copies fewer windows where a lane's extent is
  not a multiple of 256 bytes (the bundled shape).

Each scan's loop time (``metadata['timings']``) over its sweeps is its
sweep time; the forms run in turns, twice.  Then, for each form, whether
lanes 1 and 4 of the batch, alone and as a pair, give the batch's bits
in fused_dense, suffstats_dense, elbo_data_term, ml_h_dense, ml_w_dense
and likelihood at both shapes.  Prints the card's name and power limit
first.

Run from the repository's root: ``python3 tools/bench_lane_matmul.py
[--itmax 100]``.
"""
import argparse
import subprocess
import sys

import numpy as np

sys.path.insert(0, ".")
from chip_smoke import bundled_filtered, planted_10x  # noqa: E402

# form -> (lanes a product, the windows' boundary in bytes)
FORMS = {"batched": None, "c1": (1, 256), "c2": (2, 256), "c3": (3, 256),
         "c4": (4, 256), "c1a16": (1, 16), "c3a16": (3, 16)}


def set_form(form):
    """Route the dense products through ``form``."""
    import torch

    from ccfindr_tpu_torch import utils
    from ccfindr_tpu_torch.ops import ml as ml_ops
    from ccfindr_tpu_torch.ops import vb as vb_ops

    spec = FORMS[form]
    fn = torch.matmul if spec is None else utils.lane_matmul
    for mod in (vb_ops, ml_ops):
        mod.lane_matmul = fn
    utils.LANE_MATMUL_CHUNK, utils._LANE_ALIGN["cuda"] = spec or (1, 256)


def scan_ms(ct, x, mode, backend, itmax, bundled):
    """Loop seconds a sweep of one scan, in ms."""
    import torch

    if mode == "vb":
        ranks, nrun = ([2, 3, 4, 5, 6, 7, 8], 3) if bundled else \
            ([8, 12, 16], 2)
        out = ct.vb_factorize(x, ranks=ranks, nrun=nrun, Itmax=itmax,
                              Tol=0.0, backend=backend, verbose=0,
                              dtype=torch.float32, device="cuda")
        rec = out.metadata["timings"][0]
    else:
        ranks, nrun = ([4, 5, 6], 4) if bundled else ([8, 12, 16], 2)
        # the consensus (host) is not timed; at 10x a subsample keeps it
        # short
        out = ct.factorize(x, ranks=ranks, nrun=nrun, Itmax=itmax, Tol=0.0,
                           backend=backend, verbose=0, dtype=torch.float32,
                           device="cuda", cophenetic_max_cells=1000,
                           cophenetic_nsub=1)
        rec = [r for r in out.metadata["timings"]
               if r["name"] == "ml_rank_batch"][0]
    return 1e3 * rec["seconds"] / max(rec["n_iter"])


def lanes_alone(x, r, nb):
    """Whether lanes 1 and 4 of ``nb``, alone and as a pair, give the
    batch's bits in every dense pass: {pass: bool}."""
    import torch

    from ccfindr_tpu_torch.ops import ml as ml_ops
    from ccfindr_tpu_torch.ops import vb as vb_ops

    rng = np.random.default_rng(6)
    n, m = x.shape
    lw = torch.tensor(rng.gamma(1.0, 1.0, (nb, n, r)), dtype=torch.float32,
                      device="cuda")
    lh = torch.tensor(rng.gamma(1.0, 1.0, (nb, r, m)), dtype=torch.float32,
                      device="cuda")
    fns = {"fused_dense": vb_ops.fused_dense,
           "suffstats_dense": vb_ops.suffstats_dense,
           "elbo_data_term": vb_ops.elbo_data_term,
           "ml_h_dense": ml_ops.ml_h_dense, "ml_w_dense": ml_ops.ml_w_dense,
           "likelihood": lambda *a: ml_ops.likelihood(*a, 0.0)}
    res = {}
    for k, fn in fns.items():
        full = fn(x, lw, lh)
        full = full if isinstance(full, tuple) else (full,)
        ok = True
        for lanes in ([1], [4], [1, 4]):
            sel = torch.tensor(lanes, device="cuda")
            part = fn(x, lw[sel], lh[sel])
            part = part if isinstance(part, tuple) else (part,)
            ok &= all(torch.equal(u, v[sel]) for u, v in zip(part, full))
        res[k] = ok
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--itmax", type=int, default=100)
    args = ap.parse_args()
    import torch

    import ccfindr_tpu_torch as ct

    if not torch.cuda.is_available():
        print("bench_lane_matmul: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    bundled = bundled_filtered()
    x10 = planted_10x()
    cells = [(f"{mode} {be} {shape}", mode, be, x, shape == "bundled")
             for shape, x in (("bundled", bundled), ("10x", x10))
             for mode in ("vb", "ml") for be in ("dense", "dense_fused")]
    times = {(c[0], f): [] for c in cells for f in FORMS}
    for f in FORMS:                       # warm-up: allocator and cuBLAS
        set_form(f)
        scan_ms(ct, bundled, "vb", "dense", 5, True)
    for rnd in range(2):
        for label, mode, be, x, bnd in cells:
            for f in (FORMS if rnd == 0 else list(FORMS)[::-1]):
                set_form(f)
                times[(label, f)].append(scan_ms(ct, x, mode, be,
                                                 args.itmax, bnd))
    for label, *_ in cells:
        print(f"{label}: ms a sweep " + ", ".join(
            f"{f} {' '.join(f'{t:.4f}' for t in times[(label, f)])}"
            for f in FORMS), flush=True)
    xb = torch.tensor(bundled.counts_dense(dtype=np.float32), device="cuda")
    xt = torch.tensor(x10, dtype=torch.float32, device="cuda")
    for f in FORMS:
        set_form(f)
        for name, x, r, nb in (("bundled", xb, 8, 21), ("10x", xt, 16, 6)):
            print(f"lanes alone, {f}, {name} ({nb} lanes, r {r}): "
                  f"{lanes_alone(x, r, nb)}", flush=True)
    set_form("c4")
    return 0


if __name__ == "__main__":
    sys.exit(main())
