"""E1's X pass (csrc/fused.cuh) against variants of itself on one NVIDIA
GPU, at chip_smoke.py phase 12's timing shape (planted 100,000 x 4,096
int8, 3 lanes of rank 16, float32, layout 'gm').

Each variant is the package's own fused.cuh with one change, built with
nvcc into ``ccfindr_tpu_torch/_build/bench_xpass/``:

* ``repo``: the kernel as the package builds it;
* ``division``: u = x / wth by the compiler's IEEE division (its fast
  path, a check, and a call to its slow path in the hot loop) in place
  of ``div_rn``;
* ``one_block``: ``__launch_bounds__(256, 1)``, no register cap: one
  block an SM instead of two.

Each is timed by CUDA events (5 launches a reading) in turns (forward,
backward, forward; the median of the three), at the chunk the wrapper
picks (256 genes) and, for ``repo``, at 128 and 512 genes and without
the x*log(wth) sum (P1's instantiation).  Prints the card, ptxas's
registers and spills of each variant, every reading, and the TFLOP/s of
the dense work (6 r flops an element and lane).  Run from the
repository root: ``python3 tools/bench_xpass.py``.
"""
import ctypes
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
from chip_smoke import GM_SHAPE, epi_inputs, planted_gm  # noqa: E402

from ccfindr_tpu_torch.ops.kernels import build  # noqa: E402

OUT = build.BUILD_DIR / "bench_xpass"
ENTRY = r"""
#include "fused.cuh"
using namespace ccfindr;
extern "C" int e1(const void* x, const void* lw, const void* lh, int B,
                  int np, int mp, int rp, int chunk, void* full, void* part,
                  double* xp, int xlog, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xlog)
    return launch_fused_xpass<float, int8_t, true, false, true>(
        x, (size_t)mp, lw, lh, B, np, mp, rp, chunk, full, part, xp, s);
  return launch_fused_xpass<float, int8_t, true, false, false>(
      x, (size_t)mp, lw, lh, B, np, mp, rp, chunk, full, part, xp, s);
}
"""
EDITS = {
    "repo": [],
    "division": [("uu = div_rn(xv[q], w[p][q], fast);",
                  "uu = xv[q] / w[p][q];\n            fast = true;")],
    "one_block": [("sizeof(T) == 4 ? (kStr ? 2 : 3) : 1)", "1)")],
}


def build_variants():
    src = (build.CSRC / "fused.cuh").read_text()
    procs = {}
    for name, edits in EDITS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (d / "fused.cuh").write_text(text)
        for h in ("bf16.cuh", "reduce.cuh"):
            (d / h).write_text((build.CSRC / h).read_text())
        (d / "entry.cu").write_text(ENTRY)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               "-o", str(d / "lib.so"), str(d / "entry.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        for blk in err.split("Compiling entry function")[1:]:
            name = blk.split("'")[1]
            kind = "xlog" if "Lb1ELb0ELb1EEEv" in name else "no xlog"
            regs = re.search(r"Used (\d+) registers", blk)
            spill = re.search(r"(\d+) bytes spill stores", blk)
            print(f"  ptxas {name} ({kind}): {regs.group(1)} registers, "
                  f"{spill.group(1)} bytes spill stores", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.e1.argtypes = [P, P, P, I, I, I, I, I, P, P, P, I, P]
        lib.e1.restype = I
        libs[name] = lib
    return libs


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libs = build_variants()
    print(f"  built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda")
    x, lw, lh, _, _, _ = epi_inputs(planted_gm(), [16] * 3, GM_SHAPE[2],
                                    torch.float32, torch.int8, 3, dev)
    n, m = x.shape
    nb, _, r = lw.shape

    def launch(lib, chunk, xlog):
        nc = -(-n // chunk)
        full = torch.empty(nb, n, r, device=dev)
        part = torch.empty(nb, nc, r, m, device=dev)
        xp = torch.empty(nb, nc, dtype=torch.float64, device=dev)
        build.launch(lib.e1, x, lw, lh, nb, n, m, r, chunk, full, part, xp,
                     xlog)
        return full, part, xp

    def ms(lib, chunk, xlog, reps=5):
        launch(lib, chunk, xlog)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch(lib, chunk, xlog)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    ref = launch(libs["repo"], 256, 1)
    for name, lib in libs.items():
        same = all(torch.equal(a, b)
                   for a, b in zip(launch(lib, 256, 1), ref))
        print(f"  {name}: the same bits as repo {same}", flush=True)
    cases = [(k, 256, 1) for k in libs] + [("repo", 128, 1),
                                           ("repo", 512, 1), ("repo", 256, 0)]
    times = {c: [] for c in cases}
    for order in (cases, cases[::-1], cases):
        for c in order:
            times[c].append(ms(libs[c[0]], c[1], c[2]))
    dense = 6 * r * n * m * nb
    for (name, chunk, xlog), v in times.items():
        med = sorted(v)[1]
        print(f"  {name:9s} chunk {chunk:3d} xlog {xlog}: median {med:.3f} ms "
              f"(readings {', '.join(f'{t:.3f}' for t in v)}), "
              f"{dense / med / 1e9:.2f} TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
