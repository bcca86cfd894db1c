"""K1 sol_xpass (csrc/sol.cu on fused.cuh's walk) on one NVIDIA GPU at
the three shapes the VB main path gives it, with the chunk variants
weighed for ``sol.CHUNK``, and K2/K3 on each variant's partials.

Shapes (float32 factors, do_elbo on):

* ``10x``: chip_smoke.py phase 4's planted 4,096 x 8,192 int8 X, 6
  lanes of ranks [8, 12, 16] x 2 (rp 16);
* ``shard``: one cell shard of it at ``cells=4`` (phase 17), a
  4,096 x 2,048 window read in place through X's row stride;
* ``bundled``: the bundled data after QC (684 x 447 int16), 21 lanes of
  ranks 2..8 x 3 (rp 8).

Each (shape, chunk) is timed by CUDA events (20 launches a reading) in
turns (forward, backward, forward; the median of the three); K2 and K3
are timed on that chunk's partials.  Prints the card, each variant's
blocks, the bytes of its partials against X's, K1's TFLOP/s of dense work
(6 rp flops an element and lane), and each variant's partials, added
in chunk order, against the plain X pass (``sol.xpass_plain``), which
is timed beside K1 at each shape.

``--baseline DIR`` also builds ``DIR/sol.cu`` (a csrc directory whose
``sol_xpass`` takes no chunk arguments: one chunk of 512 x 512) and
times its K1 in the same turns.  Run from the repository root:
``python3 tools/bench_sol_xpass.py [--baseline DIR]``.
"""
import argparse
import ctypes
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from chip_smoke import (bundled_filtered, cuda_ms, planted_10x,  # noqa: E402
                        sweep_inputs)

from ccfindr_tpu_torch.ops.kernels import build, sol  # noqa: E402

CHUNKS = [(256, 256), (512, 512), (256, 512), (512, 256), (128, 256)]


def k1_launch(entry, x, lwt, lh, eh, sc, chunk, takes_chunk=True):
    """K1 through the C entry ``entry`` at ``chunk`` (genes, cells): its
    four partials.  The baseline's entry (``takes_chunk`` False) has its
    chunk of 512 x 512 built in."""
    nb, rp, np_ = lwt.shape
    mp = x.shape[1]
    ncc, ngc = -(-mp // chunk[1]), -(-np_ // chunk[0])
    dev = x.device
    swn = torch.empty(nb, ncc, rp, np_, device=dev, dtype=lwt.dtype)
    shn = torch.empty(nb, ngc, rp, mp, device=dev, dtype=lwt.dtype)
    xl = torch.empty(nb, ngc * ncc, device=dev, dtype=torch.float64)
    ehs = torch.empty(nb, ncc, rp, device=dev, dtype=torch.float64)
    build.launch(entry, build.TCODE[lwt.dtype], build.XCODE[x.dtype], 0, x,
                 lwt, lh, eh, sc, nb, np_, mp, x.stride(0), rp,
                 *(chunk if takes_chunk else ()), swn, shn, xl, ehs)
    return swn, shn, xl, ehs


def baseline_entry(csrc):
    """The baseline's K1 entry, built from ``csrc`` with the package's
    flags."""
    out = build.BUILD_DIR / "bench_sol_xpass"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "baseline.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(so),
           f"{csrc}/sol.cu"]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sol_xpass.argtypes = [I, I, I, P, P, P, P, P, I, I, I, I, I,
                              P, P, P, P, P]
    lib.sol_xpass.restype = I
    return lib.sol_xpass


def shapes(dev):
    x10 = planted_10x()
    out = {}
    a = sweep_inputs(x10, [8, 8, 12, 12, 16, 16], 16, torch.float32,
                     torch.int8, 1.0, 3, dev)
    out["10x"] = a
    x, lwt, lh, eh, sc, kw = a
    w = x.shape[1] // 4
    out["shard"] = (x[:, :w], lwt, lh[..., :w].contiguous(),
                    eh[..., :w].contiguous(), sc, dict(kw, m=w))
    xb = np.asarray(bundled_filtered().counts_dense(dtype=np.float64))
    out["bundled"] = sweep_inputs(xb, [rk for rk in range(2, 9)
                                       for _ in range(3)], 8, torch.float32,
                                  torch.int16, 1.0, 3, dev)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="a csrc directory whose K1 takes no chunks")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    base = baseline_entry(args.baseline) if args.baseline else None
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (x, lwt, lh, eh, sc, kw) in shapes(dev).items():
        nb, rp, np_ = lwt.shape
        mp = x.shape[1]
        print(f"{name}: X {np_} x {mp} {str(x.dtype)[6:]} (row stride "
              f"{x.stride(0)}), {nb} lanes of rp {rp}", flush=True)
        want = sol.xpass_plain(x, lwt, lh, eh, sc)
        cases = {}
        for ch in CHUNKS:
            def k1(ch=ch):
                return k1_launch(build.library().sol_xpass, x, lwt, lh, eh,
                                 sc, ch)
            parts = k1()
            err = max(float(((g.sum(1, dtype=torch.float64) - w).abs()
                             / w.double().abs().clamp_min(1e-30)).max())
                      for g, w in zip(parts[:2], want[:2]))
            same = all(torch.equal(u, v) for u, v in zip(parts, k1()))
            k2 = sol.w_post(parts[0], lwt, parts[3], sc, kw["r"], kw["n"])
            cases[f"K1 {ch[0]}x{ch[1]}"] = k1
            cases[f"K2 {ch[0]}x{ch[1]}"] = (
                lambda p=parts: sol.w_post(p[0], lwt, p[3], sc, kw["r"],
                                           kw["n"]))
            cases[f"K3 {ch[0]}x{ch[1]}"] = (
                lambda p=parts, k=k2: sol.h_post(p[1], lh, k[3], sc,
                                                 kw["r"], kw["m"]))
            blocks = -(-np_ // ch[0]) * -(-mp // ch[1]) * nb
            pbytes = sum(t.numel() * t.element_size() for t in parts[:2])
            print(f"  chunk {ch}: {blocks} blocks, partials "
                  f"{pbytes / 1e6:.1f} MB against X "
                  f"{np_ * mp * x.element_size() / 1e6:.1f} MB; max rel err "
                  f"vs plain {err:.3g}; two launches bit-identical {same}",
                  flush=True)
        if base is not None:
            cases["K1 baseline 512x512"] = (
                lambda: k1_launch(base, x, lwt, lh, eh, sc, (512, 512),
                                  takes_chunk=False))
        cases["plain xpass"] = lambda: sol.xpass_plain(x, lwt, lh, eh, sc)
        del want
        times = {c: [] for c in cases}
        order = list(cases)
        for seq in (order, order[::-1], order):
            for c in seq:
                times[c].append(cuda_ms(cases[c], 20 if "plain" not in c
                                        else 3))
        dense = 6 * rp * np_ * mp * nb
        for c, v in times.items():
            med = sorted(v)[1]
            extra = (f", {dense / med / 1e9:.2f} TFLOP/s of dense work"
                     if c.startswith("K1") else "")
            print(f"  {c:22s}: median {med:.4f} ms (readings "
                  f"{', '.join(f'{t:.4f}' for t in v)}){extra}", flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
