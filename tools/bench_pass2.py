"""P2 elbo_xpass (csrc/pass2.cu) on one NVIDIA GPU at the shapes the
two-pass main path gives it: split-TF32 products against FP32 FMAs and
the strip's length, and, with ``--baseline DIR``, another tree's P2
timed beside it in the same call.

Shapes (float32 factors and X, as ``backend='pallas2pass'`` keeps X,
but for one diagnostic):

* ``10x``: chip_smoke.py phase 13's, the planted 4,096 x 8,192 matrix,
  3 lanes of r 16;
* ``10x6``: the 10x two-pass scan's lanes, ranks [8, 8, 12, 12, 16, 16]
  (components past a lane's rank at fudge);
* ``10x_int8``: the ``10x`` inputs with X as int8 (a quarter of its
  bytes): not a main-path input, a diagnostic of what moving X costs;
* ``bundled``: the bundled data after QC (684 x 447), 21 lanes of ranks
  2..8 x 3 (r 8).

Variants, each the package's pass2.cu with one change, compiled into
``ccfindr_tpu_torch/_build/bench_pass2/`` (one nvcc a variant, all
started together) with an entry file that calls its launcher with the
product path and the strip's length as arguments:

* ``repo``: the kernel as the package builds it, ``tf32`` (split-TF32 on
  the tensor cores, what the package ships) and ``fma`` (FP32 FMAs, the
  double path's walk), each at chunks of 512, 1,024 (``kP2Chunk``) and
  2,048 cells;
* ``products_only``: the epilogue's division and log left out (each
  element adds S + wth + x): what the products, the staging and the
  tail take alone (its data term is not P2's);
* ``stages3``: three staging buffers (two steps in flight) where the
  package has two;
* ``blocks2``: ``__launch_bounds__(256, 2)`` for the split-TF32 kernel
  (a 128-register cap) where the package has 3 (85);
* ``cvt_split``: the TF32 rounding of the split by ``cvt.rna.tf32.f32``
  (the same bits) in place of two integer operations;
* ``float_step_sum``: a thread's 16 terms of a step summed in float,
  then added to its double once a step (a diagnostic of the
  conversions' cost: not P2's rounding);
* ``staging_only``: the products and the epilogue left out: the
  staging pipeline and the tail alone;
* ``lane_slowest``: the lane as the grid's slowest axis (the tile
  design's order), so each lane reads X from device memory.

With ``--baseline DIR`` the ``elbo_xpass`` of another csrc directory
(its C entry, built the same way) is timed beside them.

Each case is timed by CUDA events (10 launches a reading) in turns
(forward, backward, forward; the median of the three), beside the plain
version (``elbo_data_plain``).  Prints the card, ptxas's registers and
spills, every reading, the TFLOP/s of dense work (6 r flops an element
and lane) and each case's data term against the plain version
(relative, the error of split-TF32 among them).  Run from the
repository root: ``python3 tools/bench_pass2.py [--baseline DIR]``.
"""
import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from chip_smoke import (bundled_filtered, cuda_ms, pass2_inputs,  # noqa
                        planted_10x, rel_err)

from ccfindr_tpu_torch.ops.kernels import build  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk  # noqa: E402

OUT = build.BUILD_DIR / "bench_pass2"
CHUNKS = (512, 1024, 2048)
ENTRY = r"""
#include "pass2.cu"
template <typename XT>
int bench_x(int mma, const void* x, int64_t ldx, const void* lw,
            const void* lwl, const void* lh, const void* lhl, int B, int n,
            int m, int r, int chunk, double* part, unsigned* tickets,
            double* out, cudaStream_t s) {
  if (mma)
    return launch_elbo<float, XT, true>(x, (size_t)ldx, lw, lwl, lh, lhl, B,
                                        n, m, r, chunk, part, tickets, out,
                                        s);
  return launch_elbo<float, XT, false>(x, (size_t)ldx, lw, lwl, lh, lhl, B,
                                       n, m, r, chunk, part, tickets, out, s);
}
extern "C" int bench_elbo(int mma, int xcode, const void* x, int64_t ldx,
                          const void* lw, const void* lwl, const void* lh,
                          const void* lhl, int B, int n, int m, int r,
                          int chunk, double* part, unsigned* tickets,
                          double* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xcode == 0)
    return bench_x<int8_t>(mma, x, ldx, lw, lwl, lh, lhl, B, n, m, r, chunk,
                           part, tickets, out, s);
  return bench_x<float>(mma, x, ldx, lw, lwl, lh, lhl, B, n, m, r, chunk,
                        part, tickets, out, s);
}
"""


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


EPI = "  unsigned slow = 0;\n#pragma unroll\n  for (int i = 0; i < 4; ++i)"
EDITS = {
    "repo": [],
    "products_only": [(EPI, "#pragma unroll\n  for (int i = 0; i < 16; ++i) "
                            "acc += static_cast<double>(sv[i / 4][i % 4] + "
                            "wth[i / 4][i % 4] + xat(i / 4, i % 4));\n"
                            "  if (acc == acc) return;\n" + EPI)],
    "stages3": [("constexpr int kP2Stages = 2;",
                 "constexpr int kP2Stages = 3;")],
    "blocks2": [("__launch_bounds__(kP2Threads, kMma ? 3 : sizeof(T) == 4 "
                 "? 2 : 1)", "__launch_bounds__(kP2Threads, sizeof(T) == 4 "
                 "? 2 : 1)")],
    "float_step_sum": [
        ("      const T xv = xat(i, e);\n      if (xv != T(0))\n"
         "        acc -= static_cast<double>(xv * (sv[i][e] - log(wth[i][e])))"
         ";\n    }\n}",
         "      const T xv = xat(i, e);\n      if (xv != T(0))\n"
         "        st += xv * (sv[i][e] - log(wth[i][e]));\n    }\n"
         "  acc -= static_cast<double>(st);\n}"),
        ("  unsigned slow = 0;\n", "  T st = T(0);\n  unsigned slow = 0;\n")],
    "cvt_split": [("  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
                   "  unsigned u;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : "
                   "\"=r\"(u) : \"f\"(v));\n  return u;")],
    "staging_only": [(EPI, "#pragma unroll\n  for (int i = 0; i < 16; ++i) "
                           "acc += static_cast<double>(sv[i / 4][i % 4] + "
                           "wth[i / 4][i % 4] + xat(i / 4, i % 4));\n"
                           "  if (acc == acc) return;\n" + EPI),
                     ("      for (int kk = 0; kk < kn8; kk += 8) {",
                      "      for (int kk = 0; kk < kn8 && r < 0; kk += 8) {"),
                     ("      for (int k = 0; k < kn8; k += 4) {",
                      "      for (int k = 0; k < kn8 && r < 0; k += 4) {")],
    "lane_slowest": [
        ("  const int b = blockIdx.x;\n  const int c_begin = blockIdx.y * "
         "chunk, g0 = blockIdx.z * kP2Band;",
         "  const int b = blockIdx.z;\n  const int c_begin = blockIdx.x * "
         "chunk, g0 = blockIdx.y * kP2Band;"),
        ("  const int nblk = gridDim.y * gridDim.z;\n  if (tid == 0)\n"
         "    part[(size_t)b * nblk + (size_t)blockIdx.z * gridDim.y + "
         "blockIdx.y] = bs;",
         "  const int nblk = gridDim.x * gridDim.y;\n  if (tid == 0)\n"
         "    part[(size_t)b * nblk + (size_t)blockIdx.y * gridDim.x + "
         "blockIdx.x] = bs;"),
        ("const dim3 grid(B, ceil_div(m, chunk), ceil_div(n, kP2Band));",
         "const dim3 grid(ceil_div(m, chunk), ceil_div(n, kP2Band), B);")]}
# the (product path, chunk) cases of each variant
CASES = {"repo": [(mma, ch) for mma in (1, 0) for ch in CHUNKS],
         "products_only": [(1, 1024), (0, 1024)],
         "stages3": [(1, 1024), (0, 1024)],
         "blocks2": [(1, 1024)],
         "float_step_sum": [(1, 1024)],
         "cvt_split": [(1, 1024)],
         "staging_only": [(1, 1024)],
         "lane_slowest": [(1, 1024)]}


def build_libs(baseline):
    """The entry over every variant's pass2.cu (and the baseline's
    pass2.cu), compiled at once; returns {name: ctypes library}."""
    procs = {}
    for name, edits in EDITS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(build.CSRC, d)
        text = (d / "pass2.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (d / "pass2.cu").write_text(text)
        (d / "entry.cu").write_text(ENTRY)
        procs[name] = (d, "entry.cu")
    if baseline:
        d = OUT / "baseline"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(baseline, d)
        procs["baseline"] = (d, "pass2.cu")
    running = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
         str(d / "lib.so"), str(d / src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, (d, src) in procs.items()}
    libs = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, p in running.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        for blk in err.split("Compiling entry function")[1:]:
            kname = blk.split("'")[1]
            regs = re.search(r"Used (\d+) registers", blk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", blk)
            if "elbo" in kname and "Iff" in kname:
                print(f"  ptxas {name} {kname[:60]}: "
                      f"{regs.group(1) if regs else '?'} registers, spills "
                      f"{spill.groups() if spill else '?'}", flush=True)
        lib = ctypes.CDLL(str(procs[name][0] / "lib.so"))
        if name == "baseline":
            lib.elbo_xpass.argtypes = build._SIGNATURES["elbo_xpass"]
            lib.elbo_xpass.restype = I
        else:
            lib.bench_elbo.argtypes = [I, I, P, L, P, P, P, P, I, I, I, I, I,
                                       P, P, P, P]
            lib.bench_elbo.restype = I
        libs[name] = lib
    return libs


def shapes(dev):
    x10 = planted_10x()
    out = {"10x": pass2_inputs(x10, [16] * 3, 16, torch.float32, 11, dev),
           "10x6": pass2_inputs(x10, [8, 8, 12, 12, 16, 16], 16,
                                torch.float32, 11, dev)}
    x, lw, lh = out["10x"]
    out["10x_int8"] = (x.to(torch.int8), lw, lh)
    xb = np.asarray(bundled_filtered().counts_dense(dtype=np.float64))
    out["bundled"] = pass2_inputs(xb, [rk for rk in range(2, 9)
                                       for _ in range(3)], 8, torch.float32,
                                  11, dev)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="a csrc directory whose pass2.cu is timed beside")
    args = ap.parse_args()
    print(smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build_libs(args.baseline)
    print(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    for sname, (x, lw, lh) in shapes(dev).items():
        nb, n, r = lw.shape
        m = x.shape[1]
        lwl, lhl = vbk.xlogx(lw), vbk.xlogx(lh)
        tick = build.tickets(nb, dev)
        print(f"{sname}: X {n} x {m} {str(x.dtype)[6:]}, {nb} lanes of r "
              f"{r}", flush=True)

        def p2(lib, mma, chunk):
            part = torch.empty(nb, -(-n // vbk.P2_BAND) * -(-m // chunk),
                               dtype=torch.float64, device=dev)
            out = torch.empty(nb, dtype=torch.float64, device=dev)
            build.launch(
                lib.bench_elbo, mma, build.XCODE[x.dtype], x, m, lw, lwl, lh,
                lhl, nb, n, m, r, chunk, part, tick, out)
            return out

        def base():
            part = torch.empty(nb, -(-m // 64) * -(-n // 64),
                               dtype=torch.float64, device=dev)
            out = torch.empty(nb, dtype=torch.float64, device=dev)
            build.launch(
                libs["baseline"].elbo_xpass, build.TCODE[lw.dtype],
                build.XCODE[x.dtype], x, m, lw, lwl, lh, lhl, nb, n, m, r,
                part, tick, out)
            return out

        d_p = vbk.elbo_data_plain(x, lw, lh)
        cases = {}
        for vname, vcases in CASES.items():
            lib = libs[vname]
            for mma, ch in vcases:
                pname = f"{vname} {'tf32' if mma else 'fma'} {ch}"
                got = p2(lib, mma, ch)
                err = (got - d_p).abs() / d_p.abs()
                print(f"  {pname}: {nb * -(-n // vbk.P2_BAND) * -(-m // ch)}"
                      f" blocks; data term {rel_err(got, d_p):.3g} against "
                      f"plain (per lane "
                      f"{', '.join(f'{v:.3g}' for v in err.tolist())})",
                      flush=True)
                cases[f"P2 {pname}"] = (lambda lib=lib, mma=mma, ch=ch:
                                        p2(lib, mma, ch))
        if "baseline" in libs:
            print(f"  baseline: data term {rel_err(base(), d_p):.3g} "
                  f"against plain", flush=True)
            cases["P2 baseline"] = base
        cases["P2 plain"] = lambda: vbk.elbo_data_plain(x, lw, lh)
        times = {c: [] for c in cases}
        order = list(cases)
        for seq in (order, order[::-1], order):
            for c in seq:
                times[c].append(cuda_ms(cases[c], 10 if "plain" not in c
                                        else 3))
        dense = 6 * r * n * m * nb
        for c, v in times.items():
            med = sorted(v)[1]
            print(f"  {c:30s}: median {med:.4f} ms (readings "
                  f"{', '.join(f'{t:.4f}' for t in v)}), "
                  f"{dense / med / 1e9:.2f} TFLOP/s of dense work",
                  flush=True)
        del x, lw, lh, lwl, lhl, d_p
        torch.cuda.empty_cache()
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
