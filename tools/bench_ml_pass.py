"""M1 ml_hpass and M2 ml_wpass (csrc/ml.cu, two walks of fused.cuh's X
pass without its streamed output) on one NVIDIA GPU, at the two shapes
the ML main path gives them, with the chunk variants weighed for
``ml.H_CHUNK`` / ``ml.W_CHUNK``.

Shapes (float32 factors):

* ``10x``: chip_smoke.py phase 7's planted 4,096 x 8,192 int8 X, 6
  lanes of ranks [8, 12, 16] x 2 (r 16);
* ``bundled``: the bundled data after QC (684 x 447 int16), 12 lanes of
  ranks 4..6 x 4 (r 6: the rank is not a multiple of 4, so the factor
  tiles are staged element by element).

Variants, each the package's own sources with one change, built with
nvcc into ``ccfindr_tpu_torch/_build/bench_ml_pass/`` and called with
the chunk as an argument:

* ``repo``: the walk as the package builds it (``__launch_bounds__(256,
  3)`` for the float instantiations without the streamed output);
* ``two_blocks``: ``__launch_bounds__(256, 2)`` for them, as E1 and K1;
* ``log_nonzero``: the log of the x*log(wh) sum taken only where x is
  not 0 (the same sum: elsewhere it adds a zero);
* ``xlog_step``: a thread's 16 x*log(wh) products of a step summed in
  the factor type, then added to its double sum once a step.

Each (variant, kernel, chunk) is timed by CUDA events (20 launches a
reading) in turns (forward, backward, forward; the median of the
three), beside the plain versions (``ml_h_plain``, ``ml_w_plain``) and,
with ``--baseline DIR``, the ``ml.cu`` of another csrc directory (a
``git archive`` of an older tree, built the same way; its C entries
take no chunk).  Prints the card, ptxas's registers and spills of each
variant, every reading, the TFLOP/s of dense work (4 r flops an element
and lane) and each variant's results against the plain versions.  Run
from the repository root:
``python3 tools/bench_ml_pass.py [--baseline DIR]``.
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
from chip_smoke import (bundled_filtered, cuda_ms, ml_inputs,  # noqa: E402
                        planted_10x, rel_err)

from ccfindr_tpu_torch.ops.kernels import build  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import ml as mlk  # noqa: E402

OUT = build.BUILD_DIR / "bench_ml_pass"
CHUNKS = (64, 128, 256)
ENTRY = r"""
#include "ml.cu"
extern "C" int bench_h(int xcode, const void* x, const void* w,
                       const void* h, int B, int n, int m, int r, int chunk,
                       void* hn, double* part, unsigned* tickets,
                       double* xlog, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xcode == 0)
    return launch_hpass<float, int8_t>(x, w, h, B, n, m, r, chunk, hn, part,
                                       tickets, xlog, s);
  return launch_hpass<float, int16_t>(x, w, h, B, n, m, r, chunk, hn, part,
                                      tickets, xlog, s);
}
extern "C" int bench_w(int xcode, const void* x, const void* w,
                       const void* h, int B, int n, int m, int r, int chunk,
                       void* wn, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xcode == 0)
    return launch_wpass<float, int8_t>(x, w, h, B, n, m, r, chunk, wn, s);
  return launch_wpass<float, int16_t>(x, w, h, B, n, m, r, chunk, wn, s);
}
"""
BOUNDS = "sizeof(T) == 4 ? (kStr ? 2 : 3) : 1)"
XLOG = "if (xl_step) xl += static_cast<double>(xv[q] * log(w[p][q]));"
EDITS = {"repo": [],
         "two_blocks": [(BOUNDS, "sizeof(T) == 4 ? 2 : 1)")],
         "log_nonzero": [(XLOG, XLOG.replace("(xl_step)",
                                             "(xl_step && xv[q] != T(0))"))],
         "xlog_step": [("double xl = 0.0;", "T xl = T(0);"),
                       (XLOG, "if (xl_step) xl += xv[q] * log(w[p][q]);"),
                       ("xl_s[tid] += xl;",
                        "xl_s[tid] += static_cast<double>(xl);")]}


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build_variants(baseline):
    """Compile every variant (and the baseline's ml.cu) at once; returns
    {name: ctypes library}."""
    procs = {}
    for name, edits in EDITS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(build.CSRC, d)
        text = (d / "fused.cuh").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (d / "fused.cuh").write_text(text)
        (d / "entry.cu").write_text(ENTRY)
        procs[name] = (d, "entry.cu")
    if baseline:
        d = OUT / "baseline"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(baseline, d)
        procs["baseline"] = (d, "ml.cu")
    running = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
         str(d / "lib.so"), str(d / src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, (d, src) in procs.items()}
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, p in running.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        for blk in err.split("Compiling entry function")[1:]:
            kname = blk.split("'")[1]
            regs = re.search(r"Used (\d+) registers", blk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", blk)
            if "IfaLb" in kname or "IfsLb" in kname or "ml_" in kname:
                print(f"  ptxas {name} {kname[:64]}: "
                      f"{regs.group(1) if regs else '?'} registers, spills "
                      f"{spill.groups() if spill else '?'}", flush=True)
        lib = ctypes.CDLL(str(procs[name][0] / "lib.so"))
        if name == "baseline":
            for fn, args in (("ml_hpass", build._SIGNATURES["ml_hpass"]),
                             ("ml_wpass", build._SIGNATURES["ml_wpass"])):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = I
        else:
            lib.bench_h.argtypes = [I, P, P, P, I, I, I, I, I, P, P, P, P, P]
            lib.bench_w.argtypes = [I, P, P, P, I, I, I, I, I, P, P]
            lib.bench_h.restype = lib.bench_w.restype = I
        libs[name] = lib
    return libs


def shapes(dev):
    x10 = planted_10x()
    out = {"10x": ml_inputs(x10, [8, 8, 12, 12, 16, 16], 16, torch.float32,
                            torch.int8, 5, dev)}
    xb = np.asarray(bundled_filtered().counts_dense(dtype=np.float64))
    out["bundled"] = ml_inputs(xb, [rk for rk in range(4, 7)
                                    for _ in range(4)], 6, torch.float32,
                               torch.int16, 5, dev)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="a csrc directory whose ml.cu is timed beside")
    args = ap.parse_args()
    print(smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build_variants(args.baseline)
    print(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    for sname, (x, w, h) in shapes(dev).items():
        nb, n, r = w.shape
        m = x.shape[1]
        xc = build.XCODE[x.dtype]
        tick = build.tickets(nb, dev)
        print(f"{sname}: X {n} x {m} {str(x.dtype)[6:]}, {nb} lanes of r "
              f"{r}", flush=True)

        def m1(lib, chunk):
            hn = torch.empty(nb, r, m, device=dev)
            part = torch.empty(nb, -(-m // chunk), device=dev,
                               dtype=torch.float64)
            xl = torch.empty(nb, device=dev, dtype=torch.float64)
            build.check_launch("m1", lib.bench_h(
                xc, x.data_ptr(), w.data_ptr(), h.data_ptr(), nb, n, m, r,
                chunk, hn.data_ptr(), part.data_ptr(), tick.data_ptr(),
                xl.data_ptr(), build.stream()))
            return hn, xl

        def m2(lib, chunk):
            wn = torch.empty_like(w)
            build.check_launch("m2", lib.bench_w(
                xc, x.data_ptr(), w.data_ptr(), h.data_ptr(), nb, n, m, r,
                chunk, wn.data_ptr(), build.stream()))
            return wn

        def base_m1(lib):
            hn = torch.empty(nb, r, m, device=dev)
            part = torch.empty(nb, -(-m // 64), device=dev,
                               dtype=torch.float64)
            xl = torch.empty(nb, device=dev, dtype=torch.float64)
            build.check_launch("baseline m1", lib.ml_hpass(
                0, xc, x.data_ptr(), w.data_ptr(), h.data_ptr(), nb, n, m,
                r, hn.data_ptr(), part.data_ptr(), tick.data_ptr(),
                xl.data_ptr(), build.stream()))
            return hn, xl

        def base_m2(lib):
            wn = torch.empty_like(w)
            build.check_launch("baseline m2", lib.ml_wpass(
                0, xc, x.data_ptr(), w.data_ptr(), h.data_ptr(), nb, n, m,
                r, wn.data_ptr(), build.stream()))
            return wn

        hn_p, xl_p = mlk.ml_h_plain(x, w, h)
        wn_p = mlk.ml_w_plain(x, w, h)
        cases = {}
        ref_hn = ref_wn = None
        for name, lib in libs.items():
            if name == "baseline":
                cases["M1 baseline"] = lambda lib=lib: base_m1(lib)
                cases["M2 baseline"] = lambda lib=lib: base_m2(lib)
                hn, xl = base_m1(lib)
                wn = base_m2(lib)
                print(f"  baseline: hn {rel_err(hn, hn_p):.3g} xlog "
                      f"{rel_err(xl, xl_p):.3g} wn {rel_err(wn, wn_p):.3g} "
                      f"against plain", flush=True)
                continue
            for ch in CHUNKS:
                cases[f"M1 {name} {ch}"] = lambda lib=lib, ch=ch: m1(lib, ch)
                cases[f"M2 {name} {ch}"] = lambda lib=lib, ch=ch: m2(lib, ch)
                hn, xl = m1(lib, ch)
                wn = m2(lib, ch)
                if ref_hn is None:
                    ref_hn, ref_wn = hn, wn
                same = torch.equal(hn, ref_hn) and torch.equal(wn, ref_wn)
                print(f"  {name} chunk {ch}: M1 {-(-m // ch) * nb} blocks, "
                      f"M2 {-(-n // ch) * nb}; hn {rel_err(hn, hn_p):.3g} "
                      f"xlog {rel_err(xl, xl_p):.3g} wn "
                      f"{rel_err(wn, wn_p):.3g} against plain; hn and wn "
                      f"the bits of repo {CHUNKS[0]}: {same}", flush=True)
        cases["M1 plain"] = lambda: mlk.ml_h_plain(x, w, h)
        cases["M2 plain"] = lambda: mlk.ml_w_plain(x, w, h)
        del hn_p, xl_p, wn_p
        times = {c: [] for c in cases}
        order = list(cases)
        for seq in (order, order[::-1], order):
            for c in seq:
                times[c].append(cuda_ms(cases[c], 20 if "plain" not in c
                                        else 5))
        dense = 4 * r * n * m * nb
        for c, v in times.items():
            med = sorted(v)[1]
            print(f"  {c:20s}: median {med:.4f} ms (readings "
                  f"{', '.join(f'{t:.4f}' for t in v)}), "
                  f"{dense / med / 1e9:.2f} TFLOP/s of dense work",
                  flush=True)
        torch.cuda.empty_cache()
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
