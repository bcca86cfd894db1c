"""S1 sp_rowpass and S2 sp_colpass (csrc/sparse.cu) on one NVIDIA GPU at
the shapes the sparse main paths give them, with their design choices
weighed and, with ``--baseline DIR``, another tree's S1 and S2 timed
beside them in the same call.

Shapes (float32 factors, int16 values):

* ``10x``: chip_smoke.py phase 10's timing inputs, the planted 4,096 x
  8,192 matrix masked to 10% (2.57 M nonzeros), 6 lanes of ranks [8, 8,
  12, 12, 16, 16] (r 16: rows of 16-byte vectors);
* ``bundled``: the bundled data after QC (684 x 447), 12 lanes of ranks
  4..6 x 4 (r 6: rows loaded element by element), the bundled sparse ML
  scan's shape;
* ``atlas``: chip_smoke.py phase 10's atlas leg, 20,480 x 100,352 at 2%
  (32.1 M nonzeros), 2 lanes of r 16: a (256 MB) no longer fits L2, so
  S2's gather of a through perm comes from device memory.

Each shape is timed in the three modes the sweeps launch: ``vb`` (swn,
a and the x*log(wth) sum: the VB sweep), ``ml_h`` (a and the sum: the
ML H phase) and ``ml_w`` (swn: the ML W phase).  Variants, each the
package's sources with one change, built with nvcc into
``ccfindr_tpu_torch/_build/bench_sparse_pass/`` (one nvcc a variant,
all started together):

* ``repo``: S1 as the package builds it (a thread a nonzero up to r 32);
* ``unroll2``: the thread loop unrolled by two (two nonzeros in flight a
  thread);
* ``compiler_div``: the compiler's division in place of div_ieee;
* ``four_blocks``: ``__launch_bounds__(256, 4)`` at r 16 in float (a
  64-register cap) where the package takes 3 blocks an SM;
* ``group``: the r > 32 group walk (a warp a nonzero) at every rank;
* ``s2_csc_a`` (timing only, its shn is wrong): S2 reading a in CSC
  order, a[q] in place of a[perm[q]], which measures what the gather of
  a through perm costs;
* ``s2_group``: S2's r > 32 group walk (G = 32, a warp a nonzero) at
  every rank;
* ``s2_row``: S2 with a thread a nonzero and its whole lw row (V = RK:
  S1's design on the column side, the partial sums of a column added
  by a butterfly over the warp).

The S1 variants are timed in S1's three modes, the S2 variants (and the
package's S2, and the baseline's) in S2's float and bf16 modes; each
(variant, mode) by CUDA events (20 launches a reading) in turns
(forward, backward, forward; the median of the three), beside the plain
versions (``rowpass_plain``, ``colpass_plain``).  Prints the card,
ptxas's registers and spills of S1's and S2's float instantiations,
every reading, the GB/s of gathered factor rows (nonzeros x lanes x r x
4 bytes) and each variant's results against the plain version.  Run
from the repository root: ``python3 tools/bench_sparse_pass.py
[--baseline DIR [--baseline-without-tail]]`` (DIR: a csrc
directory, e.g. a ``git archive`` of an older tree under ``.archive/``;
the flag for a tree whose S1/S2 take no tail pointer).
"""
import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
from chip_smoke import (ATLAS, atlas_csr, bundled_filtered,  # noqa: E402
                        cuda_ms, masked_10x, planted_10x, rel_err,
                        sparse_inputs)

from ccfindr_tpu_torch.ops.kernels import build  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import sparse as spk  # noqa: E402

OUT = build.BUILD_DIR / "bench_sparse_pass"
LOOP = "    for (int64_t p = p_beg + lane; p - lane < p_end; p += 32) {"
EDITS = {"repo": [],
         "unroll2": [(LOOP, "#pragma unroll 2\n" + LOOP)],
         "compiler_div": [("operand<kBf16>(div_ieee(xv, wth));\n#pragma "
                           "unroll\n        for (int k = 0; k < RK;",
                           "operand<kBf16>(xv / wth);\n#pragma unroll\n"
                           "        for (int k = 0; k < RK;")],
         "four_blocks": [("sizeof(T) * RK <= 32    ? 4",
                          "sizeof(T) * RK <= 64    ? 4")],
         "group": [("  if (r <= 4) S1R(4);\n  if (r <= 8) S1R(8);\n"
                    "  if (r <= 16) S1R(16);\n  if (r <= 32) S1R(32);\n",
                    "")],
         "s2_csc_a": [("const T a = a_b[perm[q]];", "const T a = a_b[q];")],
         "s2_group": [("  if (r <= 4) S2R(4);\n  if (r <= 8) S2R(8);\n"
                       "  if (r <= 16) S2R(16);\n  if (r <= 32) S2R(32);\n",
                       "")],
         "s2_row": [("sp_colpass_kernel<T, RK, kVec, kBf16>",
                     "sp_colpass_kernel<T, RK, RK, kBf16>")]}
MODES = {"vb": (True, True, True), "ml_h": (False, True, True),
         "ml_w": (True, False, False)}


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build_variants(baseline, baseline_tail=True):
    """Compile sparse.cu of every variant (and of the baseline) at once;
    returns {name: ctypes library}.  ``baseline_tail`` False: the
    baseline's C interface takes no tail pointer."""
    dirs = {}
    for name, edits in EDITS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(build.CSRC, d)
        text = (d / "sparse.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (d / "sparse.cu").write_text(text)
        dirs[name] = d
    if baseline:
        d = OUT / "baseline"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(baseline, d)
        dirs["baseline"] = d
    running = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
         str(d / "lib.so"), str(d / "sparse.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, d in dirs.items()}
    libs = {}
    for name, p in running.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        for blk in err.split("Compiling entry function")[1:]:
            kname = blk.split("'")[1]
            regs = re.search(r"Used (\d+) registers", blk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", blk)
            if ("rowpass" in kname and "Ifs" in kname  # float, int16 values
                    or "colpass" in kname and "If" in kname):
                print(f"  ptxas {name} {kname[:60]}: "
                      f"{regs.group(1) if regs else '?'} registers, spills "
                      f"{spill.groups() if spill else '?'}", flush=True)
        lib = ctypes.CDLL(str(dirs[name] / "lib.so"))
        # the tail pointer follows the values (S1) or perm (S2)
        lib.has_tail = name != "baseline" or baseline_tail
        for fn, at in (("sp_rowpass", 6), ("sp_colpass", 5)):
            sig = list(build._SIGNATURES[fn])
            if not lib.has_tail:
                del sig[at]
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def shapes(dev):
    csr10 = masked_10x(planted_10x())[1]
    out = {"10x": sparse_inputs(csr10, [8, 8, 12, 12, 16, 16], 16,
                                torch.float32, torch.int16, 9, dev)}
    out["bundled"] = sparse_inputs(bundled_filtered().counts,
                                   [rk for rk in range(4, 7)
                                    for _ in range(4)], 6, torch.float32,
                                   torch.int16, 9, dev)
    out["atlas"] = sparse_inputs(atlas_csr(*ATLAS), [16, 16], 16,
                                 torch.float32, torch.int16, 9, dev)
    return out


def rowpass(lib, tc, lw, lht, mode):
    """One S1 launch of ``lib`` in ``mode``: (swn, a, xlog), None where
    the mode does not ask."""
    want_swn, want_a, want_xlog = MODES[mode]
    nb, n, r = lw.shape
    dev = lw.device
    swn = torch.empty_like(lw) if want_swn else None
    a = torch.empty(nb, tc.nnz, device=dev) if want_a else None
    part = (torch.empty(nb, -(-n // spk.ROWS), dtype=torch.float64,
                        device=dev) if want_xlog else None)
    xlog = (torch.empty(nb, dtype=torch.float64, device=dev) if want_xlog
            else None)
    flags = torch.ones(nb, dtype=torch.float64, device=dev)

    tail = (None,) if lib.has_tail else ()
    build.launch(
        lib.sp_rowpass, build.TCODE[lw.dtype], build.XCODE[tc.val.dtype], 0,
        tc.indptr, tc.col, tc.val, *tail, lw, lht, flags, nb, n, tc.m, r,
        tc.nnz, swn, a, part, build.tickets(nb, dev) if want_xlog else None,
        xlog)
    return swn, a, xlog


def colpass(lib, tc, a, lw, bf16):
    """One S2 launch of ``lib``: shn (B, r, m)."""
    nb, n, r = lw.shape
    shn = torch.empty(nb, r, tc.m, dtype=lw.dtype, device=lw.device)
    tail = (None,) if lib.has_tail else ()
    build.launch(
        lib.sp_colpass, build.TCODE[lw.dtype], int(bf16), tc.colptr, tc.row,
        tc.perm, *tail, a, lw, nb, n, tc.m, r, tc.nnz, shn)
    return shn


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="a csrc directory whose sparse.cu (S1 and S2) is "
                    "timed beside")
    ap.add_argument("--baseline-without-tail", action="store_true",
                    help="the baseline's sp_rowpass/sp_colpass take no "
                    "tail pointer (a sparse.cu from before the bf16 "
                    "overflow tail)")
    args = ap.parse_args()
    print(smi(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build_variants(args.baseline, not args.baseline_without_tail)
    print(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    for sname, (tc, lw, lh) in shapes(dev).items():
        nb, n, r = lw.shape
        lht = lh.transpose(-1, -2).contiguous()
        print(f"{sname}: X {n} x {tc.m}, nnz {tc.nnz}, {nb} lanes of r {r}",
              flush=True)
        swn_p, a_p, xlog_p = spk.rowpass_plain(tc, lw, lht)
        a = a_p.contiguous()
        a16 = spk.rowpass_plain(tc, lw, lht, mxu_bf16=True)[1].contiguous()
        shn_p = spk.colpass_plain(tc, a, lw)
        cases = {}
        for name, lib in libs.items():
            if not name.startswith("s2_"):
                swn, a_k, xlog = rowpass(lib, tc, lw, lht, "vb")
                print(f"  {name}: swn {rel_err(swn, swn_p):.3g} a "
                      f"{rel_err(a_k, a_p):.3g} xlog "
                      f"{rel_err(xlog, xlog_p):.3g} against plain",
                      flush=True)
                for mode in MODES:
                    cases[f"S1 {mode} {name}"] = (
                        lambda lib=lib, mode=mode: rowpass(lib, tc, lw, lht,
                                                           mode))
            if name in ("repo", "baseline") or name.startswith("s2_"):
                shn = colpass(lib, tc, a, lw, False)
                print(f"  {name}: S2 shn {rel_err(shn, shn_p):.3g} against "
                      f"plain", flush=True)
                for bf16 in (False, True):
                    aa = a16 if bf16 else a
                    cases[f"S2 {'bf16 ' if bf16 else ''}{name}"] = (
                        lambda lib=lib, aa=aa, bf16=bf16: colpass(
                            lib, tc, aa, lw, bf16))
        cases["S1 plain"] = lambda: spk.rowpass_plain(tc, lw, lht)
        cases["S2 plain"] = lambda: spk.colpass_plain(tc, a, lw)
        times = {c: [] for c in cases}
        order = list(cases)
        for seq in (order, order[::-1], order):
            for c in seq:
                times[c].append(cuda_ms(cases[c], 20 if "plain" not in c
                                        else 3))
        gathered = tc.nnz * nb * r * lw.element_size()
        for c, v in times.items():
            med = sorted(v)[1]
            print(f"  {c:24s}: median {med:.4f} ms (readings "
                  f"{', '.join(f'{t:.4f}' for t in v)}), "
                  f"{gathered / med / 1e6:.1f} GB/s of gathered factor rows",
                  flush=True)
        del swn_p, a_p, xlog_p, a, a16, shn_p, lht
        torch.cuda.empty_cache()
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
