"""The JAX package's sparse capacity configuration on ccfindr_tpu_torch,
the PyTorch/CUDA port: a count matrix whose dense image would not fit
the card, factorized from its nonzeros alone (the port's counterpart of
bench.py's oversize problem, ``bench_sparse_oversize``).

The matrix: 16,384 genes x 1,114,112 cells at 2% density, a planted
rank-16 Poisson block of 8,704 cells tiled 128 times, ~279 M nonzeros
(int16 counts capped at 127): bench.py's ``_oversize_matrix``, the same
CSR from the same ``default_rng(0)`` draws, built here without a disk
cache and with the 128-fold tiling by index arithmetic.  Its dense int8
image would be 18.3 GB, its CSR layout on the card (col, row and perm
int32, the values int16, the pointers) ~3.9 GB.

* :func:`oversize_matrix` builds it, printing its seconds and the
  process's peak RSS;
* :func:`initial_state` and :func:`sweeps` are bench.py's own sweep body
  (``bench.py:383-393``: a layout's fused pass, then ``posterior_update``
  and ``hyper_update``) on one lane, from bench.py's draws;
* :func:`run` is the rank scan through ``ccfindr_tpu_torch.vb_factorize(
  backend='sparse')``, and returns its summary.

Usage: python examples/oversize_sparse_torch.py [--quick] [--device
  cuda|cpu] [--layout tile|ell|coo] [--ranks 8,12,16] [--nrun 2]
  [--itmax 10] [--tol 0] [--precision f32|bf16] [--elbo-every 1]
  --quick shrinks the matrix to 1,024 genes x 8,192 cells (tile 16);
  --device cpu runs the kernels' plain PyTorch versions on the CPU.
The last line is one JSON object: layout, lanes, sweeps, loop and
set-up seconds, peak device memory, ropt and whether every lml is
finite, beside the matrix's shape and nonzeros, the peak host RSS and
the card's name and power limit.
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPE = dict(n=16384, m=1114112, r=16, density=0.02, tile=128)
QUICK = dict(n=1024, m=8192, r=16, density=0.02, tile=16)


def peak_rss_gib():
    """The process's peak resident set so far, GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def oversize_matrix(n=16384, m=1114112, r=16, density=0.02, tile=128,
                    verbose=True):
    """bench.py's ``_oversize_matrix(n, m, r, density, tile)``: the same
    ``data``, ``indices`` and ``indptr``.  A planted rank-``r`` Poisson
    block of ``m // tile`` cells masked to ``density`` (the draws of
    bench.py in their order), then the block repeated ``tile`` times
    along the cells: each gene's nonzeros of the block, once a copy,
    shifted by the block's width, as ``scipy.sparse.hstack`` lays them
    out."""
    import scipy.sparse as sps

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    mb = m // tile
    wf = rng.gamma(0.5, 1.0, (n, r)).astype(np.float32)
    hf = rng.gamma(0.5, 1.0, (r, mb)).astype(np.float32)
    scale = 2.0 * n * mb / float(wf.sum(axis=0) @ hf.sum(axis=1))
    chunks = []
    for i0 in range(0, n, 2048):
        mu = (wf[i0:i0 + 2048] @ hf) * scale
        blk = np.minimum(rng.poisson(mu), 127).astype(np.int16)
        blk *= rng.random(mu.shape) < density
        chunks.append(sps.csr_matrix(blk))
    base = sps.vstack(chunks).tocsr()
    del chunks
    nnz = base.nnz * tile
    lens = np.diff(base.indptr).astype(np.int64)
    idx_t = np.int32 if max(nnz, mb * tile) < 2 ** 31 else np.int64
    indptr = (base.indptr.astype(np.int64) * tile).astype(idx_t)
    # copy t of gene g's nonzeros sits at indptr[g] + t len(g) + offset
    first = np.repeat(base.indptr[:-1].astype(np.int64) * tile, lens)
    first += (np.arange(base.nnz, dtype=np.int64)
              - np.repeat(base.indptr[:-1].astype(np.int64), lens))
    step = np.repeat(lens, lens)
    indices = np.empty(nnz, idx_t)
    data = np.empty(nnz, base.data.dtype)
    for t in range(tile):
        indices[first] = base.indices + t * mb
        data[first] = base.data
        first += step
    full = sps.csr_matrix((data, indices, indptr), shape=(n, mb * tile))
    if verbose:
        print(f"oversize X {n} x {mb * tile} ({tile} copies of {mb} cells),"
              f" nnz {nnz} ({nnz / (n * mb * tile):.4f} of the entries) in "
              f"{time.perf_counter() - t0:.1f} s, peak host RSS "
              f"{peak_rss_gib():.2f} GiB", flush=True)
    return full


def initial_state(n, m, r, dtype, device, seed=0):
    """bench.py's start for its sweep body (``bench_sparse_oversize``):
    W and H from ``default_rng(seed)``'s gamma(1, 1) draws, the means
    and geometric means equal, variances 0, every hyperparameter 1, as a
    port state of one lane."""
    import torch

    from ccfindr_tpu_torch.ops.vb import Hyper, VBState

    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.gamma(1.0, 1.0, (n, r)), dtype=dtype)[None]
    h = torch.as_tensor(rng.gamma(1.0, 1.0, (r, m)), dtype=dtype)[None]
    w, h = w.to(device), h.to(device)
    state = VBState(ew=w, eh=h, lw=w, lh=h, dw=torch.zeros_like(w),
                    dh=torch.zeros_like(h),
                    lkh=torch.full((1,), -np.inf, dtype=dtype,
                                   device=device))
    hyper = Hyper(*(torch.ones(1, dtype=dtype, device=device),) * 4)
    return state, hyper


def lgamma_sum(csr):
    """sum lgamma(x + 1) over the nonzeros, as bench.py forms it (the
    counts' histogram against the table of lgamma)."""
    from scipy.special import gammaln

    cnt = np.bincount(csr.data.astype(np.int64), minlength=2)
    return float(cnt @ gammaln(np.arange(len(cnt)) + 1.0))


def sweeps(fused, x, state, hyper, lgx, k, n, m):
    """``k`` sweeps of bench.py's body over the layout ``x``: the fused
    pass, ``posterior_update`` and ``hyper_update`` (every hyper on),
    ``lkh`` from the new state's pending terms and the old factors' data
    term.  Returns the last (state, hyper) and each sweep's lkh (host
    floats)."""
    import torch

    from ccfindr_tpu_torch.ops import vb as vb_ops

    fudge = torch.tensor(np.finfo(np.float32).eps, dtype=state.lw.dtype,
                         device=state.lw.device)
    lkh = []
    for _ in range(k):
        swn, shn, dterm = fused(x, state.lw, state.lh)
        new, pending = vb_ops.posterior_update(
            state.lw * swn, state.lh * shn, state, hyper, fudge, lgx)
        hyper, _ = vb_ops.hyper_update((True,) * 4, new, hyper)
        state = new._replace(lkh=(pending + dterm) / (float(n) * float(m)))
        lkh.append(float(state.lkh[0]))
    return state, hyper, lkh


def layout_bytes(x):
    """Bytes the layout keeps on its device (every tensor field, the
    CSR view of an ELL layout included), as bench.py's dev_bytes."""
    import torch

    seen, total = set(), 0
    stack = [x]
    while stack:
        obj = stack.pop()
        for v in vars(obj).values():
            if isinstance(v, torch.Tensor) and v.data_ptr() not in seen:
                seen.add(v.data_ptr())
                total += v.numel() * v.element_size()
            elif hasattr(v, "__dict__") and type(v).__module__.startswith(
                    "ccfindr_tpu_torch"):
                stack.append(v)
    return total


def run(x, ranks=(8, 12, 16), nrun=2, itmax=10, tol=0.0, layout="tile",
        precision="f32", elbo_every=1, device="cuda", seed=0, mesh=None,
        dtype=None):
    """The rank scan ``vb_factorize(x, backend='sparse', ...)`` (``dtype``
    the driver's default where None: float32 on the card): returns
    ``(result, summary)``, the summary's keys those of the script's last
    line (set-up is the call's wall less the loop record's seconds)."""
    import torch

    import ccfindr_tpu_torch as ct

    cuda = str(device).startswith("cuda")
    cards = (sorted({d.index or 0 for row in mesh.devices for d in row.ravel()
                     if d.type == "cuda"}) if mesh is not None and cuda
             else [torch.device(device).index or 0] if cuda else [])
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    f = ct.vb_factorize(x, ranks=list(ranks), nrun=nrun, Itmax=itmax,
                        Tol=tol, backend="sparse", sparse_layout=layout,
                        precision=precision, elbo_every=elbo_every,
                        device=device, verbose=0, seed=seed, mesh=mesh,
                        dtype=dtype)
    for d in cards:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    rec = f.metadata["timings"][0]
    lml = np.asarray(f.measure["lml"], np.float64)
    summary = {
        "layout": layout, "precision": precision, "elbo_every": elbo_every,
        "lanes": len(ranks) * nrun,
        "sweeps": int(max(np.atleast_1d(rec["n_iter"]))),
        "lane_sweeps": int(rec.get("lane_sweeps_executed",
                                   rec.get("total_sweeps", 0))),
        "loop_s": rec["seconds"], "setup_s": wall - rec["seconds"],
        "wall_s": wall,
        "peak_device_gib": [torch.cuda.max_memory_allocated(d) / 2 ** 30
                            for d in cards] or None,
        "ropt": int(ct.optimal_rank(f)["ropt"]),
        "lml_finite": bool(np.isfinite(lml).all()),
    }
    return f, summary


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="1,024 genes x 8,192 cells (tile 16)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--layout", choices=("tile", "ell", "coo"),
                    default="tile")
    ap.add_argument("--ranks", default="8,12,16")
    ap.add_argument("--nrun", type=int, default=2)
    ap.add_argument("--itmax", type=int, default=10)
    ap.add_argument("--tol", type=float, default=0.0)
    ap.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--elbo-every", type=int, default=1)
    a = ap.parse_args(argv)
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        sys.exit("oversize_sparse_torch: no CUDA device (the kernels need "
                 "one; --device cpu runs their plain versions)")
    gpu = card() if a.device == "cuda" else None
    if gpu is not None:
        print(gpu, flush=True)
    shape = QUICK if a.quick else SHAPE
    t0 = time.perf_counter()
    x = oversize_matrix(**shape)
    build_s = time.perf_counter() - t0
    ranks = [int(v) for v in a.ranks.split(",")]
    _, summary = run(x, ranks=ranks, nrun=a.nrun, itmax=a.itmax, tol=a.tol,
                     layout=a.layout, precision=a.precision,
                     elbo_every=a.elbo_every, device=a.device)
    print(json.dumps({"metric": "oversize_sparse", "shape": list(x.shape),
                      "nnz": int(x.nnz), "matrix_s": build_s, **summary,
                      "peak_host_rss_gib": peak_rss_gib(), "card": gpu}),
          flush=True)


if __name__ == "__main__":
    main()
