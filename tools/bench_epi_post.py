"""E2 epi_w_post (csrc/epi_w.cuh) on one NVIDIA GPU at the shapes the
gene-major sweep gives it, beside a second design and, with
``--baseline DIR``, another tree's E2 and E3 in the same call.

Shapes (W row-major (B, np, rp), swn and lw drawn from a gamma law, a
seed; E2's work does not depend on the values):

* ``gm``: chip_smoke.py phase 12's timing shape, 100,000 genes, 3 lanes
  of r 16 (rp 16), float32 and float64;
* ``bundled``: vb_run_epi on the bundled lanes, 684 genes, 21 lanes of
  ranks 2..8 (rp 8), float32.

Variants, each compiled from a small entry file with nvcc into
``ccfindr_tpu_torch/_build/bench_epi_post/`` (one nvcc a variant, all
started together):

* ``repo``: E2 as the package builds it (design (a): a thread an entry,
  the rank sums in shared memory);
* ``lb5``, ``lb6``: design (a) with ``__launch_bounds__(256, 5)`` and
  ``(256, 6)`` (at most 51 and 42 registers: 5 and 6 blocks an SM);
* ``cols128``: design (a) with 128 genes a block (twice the blocks and
  the partials E3 reads; E3 is timed on them);
* ``unroll1``: design (a) with its entry loop taken one entry at a time
  (the package unrolls it by two);
* ``staged``: design (b), kept here only: a thread a gene as before,
  the block's swn and lw staged into shared memory by coalesced loads in
  slabs of 8 ranks, the three outputs written back through shared
  memory, the rank sums a warp a rank (float, rp a multiple of 8);
* ``baseline`` (``--baseline DIR``, a csrc directory, e.g. a ``git
  archive`` of an older tree under ``.archive/``): that tree's E2, the
  rank-minor post_kernel of its post.cuh.

Each variant's E2 is timed by CUDA events (20 launches a reading) in
turns (forward, backward, forward; the median of three), beside the
plain version (``sol.post_plain``).  Its e, lwn and d are held bit for
bit against the repo's (and the repo's against K2 on the transposed
layout, which computes each entry with the same expressions), its
partials against the plain rank sums and scalars; E3 of the repo and of
the baseline tree are held bit for bit on the same inputs (post.cuh's
kernel, which K2, K3 and K3s share).  Prints the card, ptxas's
registers and spills of each E2, every reading and the GB/s of the
function's bytes.  Run from the repository root:
``python3 tools/bench_epi_post.py [--baseline DIR]``.
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
from chip_smoke import cuda_ms, nbytes, rel_err  # noqa: E402

from ccfindr_tpu_torch.ops.kernels import build  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import epilogue as epi  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import sol  # noqa: E402

OUT = build.BUILD_DIR / "bench_epi_post"
SIG = ("(int tcode, const void* swn, const void* lw, const double* ehs, "
       "int nehs, const double* sc, int B, int np, int rp, int r, int n, "
       "void* ew, void* lwn, void* dw, double* cs, double* ws, void* st)")
E3 = ('extern "C" int e3(int tcode, const void* shn, const void* lh, '
      "const double* cs, int nbw, const double* sc, int B, int mp, int rp, "
      "int r, int m_live, int m, void* eh, void* lhn, void* dh, double* rs,"
      " double* hs, void* st) { return ccfindr::post_entry%s(tcode, shn, 1,"
      " lh, cs, nbw, sc, 2, B, mp, rp, r, m_live, m, eh, lhn, dh, rs, hs, "
      "st); }\n")
ENTRIES = {
    "repo": ('#include "epi_w.cuh"\n'
             f'extern "C" int e2{SIG} {{ return ccfindr::epi_w_entry(tcode, '
             "swn, lw, ehs, nehs, sc, B, np, rp, r, n, ew, lwn, dw, cs, ws, "
             "st); }\n" + E3 % ""),
    "baseline": ('#include "post.cuh"\n'
                 f'extern "C" int e2{SIG} {{ return ccfindr::post_entry<true>('
                 "tcode, swn, 1, lw, ehs, nehs, sc, 0, B, np, rp, r, n, n, ew,"
                 " lwn, dw, cs, ws, st); }\n" + E3 % "<false>"),
}
# design (b): a thread a gene, tiles staged through shared memory
STAGED = r'''
#include "post.cuh"
namespace ccfindr {
constexpr int kSl = 8, kSp = kSl + 1, kG = 256;
template <typename T>
__global__ void __launch_bounds__(kG) staged_kernel(
    const T* __restrict__ swn, const T* __restrict__ lw,
    const double* __restrict__ ehs, int nehs, const double* __restrict__ sc,
    int np, int rp, int r, int n, T* __restrict__ ew, T* __restrict__ lwn,
    T* __restrict__ dw, double* __restrict__ cs, double* __restrict__ ws) {
  __shared__ T be_s[kMaxRp], logbe_s[kMaxRp];
  __shared__ T ts[kG * kSp], tl[kG * kSp], te[kG * kSp], tn[kG * kSp],
      td[kG * kSp];
  __shared__ double red[kG / 32];
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const double* scb = sc + b * 8;
  const T a = static_cast<T>(scb[0]), bb = static_cast<T>(scb[1]);
  const T fudge = static_cast<T>(scb[4]), r_live = static_cast<T>(scb[5]);
  const T a_over_b = a / bb, log_fudge = log(fudge);
  if (tid < rp) {
    double s = 0.0;
    for (int p = 0; p < nehs; ++p) s += ehs[((size_t)b * nehs + p) * rp + tid];
    const T be = T(1) / (a_over_b + static_cast<T>(s));
    be_s[tid] = be;
    logbe_s[tid] = log(be);
  }
  const int g0 = blk * kG, g = g0 + tid;
  const int ng = min(kG, np - g0);
  double su = 0.0, se = 0.0, sl = 0.0, sd = 0.0;
  for (int k0 = 0; k0 < rp; k0 += kSl) {
    __syncthreads();
    for (int e = tid; e < ng * kSl; e += kG) {
      const size_t off = ((size_t)b * np + g0 + e / kSl) * rp + k0 + e % kSl;
      ts[(e / kSl) * kSp + e % kSl] = swn[off];
      tl[(e / kSl) * kSp + e % kSl] = lw[off];
    }
    __syncthreads();
    if (tid < ng) {
      for (int q = 0; q < kSl; ++q) {
        const int k = k0 + q;
        const T sfx = ts[tid * kSp + q], lfv = tl[tid * kSp + q];
        const bool live = static_cast<T>(k) < r_live && g < n;
        const T be = be_s[k], log_be = logbe_s[k];
        const T al = a + lfv * sfx;
        T psi, lgam;
        digamma_gammaln_both<T>(al, psi, lgam);
        const T ln_raw = exp(psi) * be;
        T e = T(0), ln, d = T(0), u = T(0), logl = T(0), dt = T(0);
        if (live) {
          e = al * be;
          ln = (ln_raw >= fudge || is_nan(ln_raw)) ? ln_raw : fudge;
          d = al * (be * be);
          u = -a_over_b * e + al * (T(1) + log_be) + lgam;
          logl = ln_raw > fudge ? psi + log_be : log_fudge;
          dt = sfx * lfv * log(lfv);
        } else {
          ln = (k < r && g < n) ? fudge : (k < r ? T(1) : T(0));
        }
        te[tid * kSp + q] = e;
        tn[tid * kSp + q] = ln;
        td[tid * kSp + q] = d;
        su += static_cast<double>(u);
        se += static_cast<double>(e);
        sl += static_cast<double>(logl);
        sd += static_cast<double>(dt);
      }
    }
    __syncthreads();
    for (int e = tid; e < ng * kSl; e += kG) {
      const size_t off = ((size_t)b * np + g0 + e / kSl) * rp + k0 + e % kSl;
      ew[off] = te[(e / kSl) * kSp + e % kSl];
      lwn[off] = tn[(e / kSl) * kSp + e % kSl];
      dw[off] = td[(e / kSl) * kSp + e % kSl];
    }
    // rank k0 + w's sum over the block's genes: a warp a rank
    double c = 0.0;
    for (int i = lane; i < ng; i += 32)
      c += static_cast<double>(te[i * kSp + w]);
    c = warp_sum(c);
    if (lane == 0) cs[((size_t)b * nblk + blk) * rp + k0 + w] = c;
  }
  double* out = ws + ((size_t)b * nblk + blk) * 4;
  double v = block_sum(su, red);
  if (tid == 0) out[0] = v;
  v = block_sum(se, red);
  if (tid == 0) out[1] = v;
  v = block_sum(sl, red);
  if (tid == 0) out[2] = v;
  v = block_sum(sd, red);
  if (tid == 0) out[3] = v;
}
}  // namespace ccfindr
// float only: five double tiles would pass the 48 KB of static shared
// memory
extern "C" int e2SIG {
  if (rp % ccfindr::kSl || tcode != 0) return 1;
  const dim3 grid((np + ccfindr::kG - 1) / ccfindr::kG, B);
  const cudaStream_t s = static_cast<cudaStream_t>(st);
  ccfindr::staged_kernel<float><<<grid, ccfindr::kG, 0, s>>>(
      (const float*)swn, (const float*)lw, ehs, nehs, sc, np, rp, r, n,
      (float*)ew, (float*)lwn, (float*)dw, cs, ws);
  return static_cast<int>(cudaGetLastError());
}
'''.replace("SIG", SIG)


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


LB = "__global__ void __launch_bounds__(kE2Threads)\nepi_w_kernel"
LOOP = "#pragma unroll 2\n    for (int g = blk"
EDITS = {"repo": [],
         "lb5": [(LB, LB.replace("(kE2Threads)", "(kE2Threads, 5)"))],
         "lb6": [(LB, LB.replace("(kE2Threads)", "(kE2Threads, 6)"))],
         "cols128": [("kE2Cols = 256;", "kE2Cols = 128;")],
         "unroll1": [(LOOP, LOOP.replace("unroll 2", "unroll 1"))]}
# E2's genes a block (others: E2_COLS); the baseline tree's E2 is its
# post_kernel, a column a thread, 256 a block
COLS = {"cols128": 128, "baseline": 256}


def build_variants(baseline):
    """Compile each variant's entry file against its csrc copy at once;
    returns {name: ctypes library}."""
    srcs = {name: (build.CSRC, ENTRIES["repo"], edits)
            for name, edits in EDITS.items()}
    srcs["staged"] = (build.CSRC, STAGED, [])
    if baseline:
        srcs["baseline"] = (baseline, ENTRIES["baseline"], [])
    running = {}
    for name, (csrc, text, edits) in srcs.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        if edits:
            src = (d / "epi_w.cuh").read_text()
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"variant {name}: {old!r} not found")
                src = src.replace(old, new)
            (d / "epi_w.cuh").write_text(src)
        (d / "bench_entry.cu").write_text(text)
        running[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(d / "lib.so"), str(d / "bench_entry.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
            print(f"  ptxas {name} {kname[:48]}: "
                  f"{regs.group(1) if regs else '?'} registers, spills "
                  f"{spill.groups() if spill else '?'}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.e2.argtypes = build._SIGNATURES["epi_w_post"]
        lib.e2.restype = ctypes.c_int
        if hasattr(lib, "e3"):
            lib.e3.argtypes = build._SIGNATURES["epi_h_post"]
            lib.e3.restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(nb, np_, rp, r_lanes, dt, dev, seed=0):
    """swn, lw (B, np, rp), ehs_part (B, 1, rp), sc (B, 8): lane b live
    up to rank r_lanes[b], its ranks up to rp at fudge."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lw = torch.empty(nb, np_, rp, device=dev, dtype=torch.float64)
    lw.exponential_(generator=g)
    swn = torch.empty_like(lw).exponential_(generator=g).mul_(40.0)
    fudge = float(torch.finfo(dt).eps)
    for b, rk in enumerate(r_lanes):
        lw[b, :, rk:] = fudge
    ehs = torch.rand(nb, 1, rp, device=dev, dtype=torch.float64,
                     generator=g) * 4000.0
    sc = torch.zeros(nb, 8, dtype=torch.float64, device=dev)
    sc[:, :4] = torch.tensor([0.7, 1.3, 1.1, 0.9], dtype=torch.float64)
    sc[:, 4] = fudge
    sc[:, 5] = torch.tensor(r_lanes, dtype=torch.float64)
    sc[:, 7] = 1.0
    return swn.to(dt), lw.to(dt), ehs, sc


def e2(lib, swn, lw, ehs, sc, r, n, cols=epi.E2_COLS):
    nb, np_, rp = lw.shape
    ew, lwn, dw = (torch.empty_like(lw) for _ in range(3))
    nblk = -(-np_ // cols)
    cs = torch.empty(nb, nblk, rp, dtype=torch.float64, device=lw.device)
    ws = torch.empty(nb, nblk, 4, dtype=torch.float64, device=lw.device)
    build.check_launch("e2", lib.e2(
        build.TCODE[lw.dtype], swn.data_ptr(), lw.data_ptr(), ehs.data_ptr(),
        ehs.shape[1], sc.data_ptr(), nb, np_, rp, r, n, ew.data_ptr(),
        lwn.data_ptr(), dw.data_ptr(), cs.data_ptr(), ws.data_ptr(),
        build.stream()))
    return ew, lwn, dw, cs, ws


def h_inputs(nb, rp, m, dt, dev, seed=1):
    """Random shn, lh (B, rp, m) for E3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lh = torch.rand(nb, rp, m, device=dev, generator=g,
                    dtype=torch.float64).to(dt) + 0.05
    shn = (torch.rand(nb, rp, m, device=dev, generator=g,
                      dtype=torch.float64) * 40.0).to(dt)
    return shn, lh


def e3(lib, csum_part, sc, r, shn, lh, cols=sol.POST_COLS):
    """E3 on ``shn``/``lh (B, rp, m)`` and the given E2 partials, one
    partial a block of ``cols`` cells."""
    nb, nbw, rp = csum_part.shape
    m, dt = lh.shape[-1], lh.dtype
    out = [torch.empty_like(lh) for _ in range(3)]
    nblk = -(-m // cols)
    rs = torch.empty(nb, nblk, rp, dtype=torch.float64, device=lh.device)
    hs = torch.empty(nb, nblk, 4, dtype=torch.float64, device=lh.device)
    build.check_launch("e3", lib.e3(
        build.TCODE[dt], shn.data_ptr(), lh.data_ptr(), csum_part.data_ptr(),
        nbw, sc.data_ptr(), nb, m, rp, r, m, m, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), rs.data_ptr(), hs.data_ptr(),
        build.stream()))
    return (*out, rs, hs)


SHAPES = {"gm float32": (3, 100_000, 16, [16, 12, 8], torch.float32),
          "gm float64": (3, 100_000, 16, [16, 12, 8], torch.float64),
          "bundled float32": (21, 684, 8,
                              [rk for rk in range(2, 9) for _ in range(3)],
                              torch.float32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="a csrc directory whose E2 and E3 are run beside")
    args = ap.parse_args()
    print(smi(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = build_variants(args.baseline)
    print(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    for sname, (nb, np_, rp, lanes, dt) in SHAPES.items():
        r = rp
        n = np_ - 3                     # three padding genes
        swn, lw, ehs, sc = inputs(nb, np_, rp, lanes, dt, dev)
        print(f"{sname}: {nb} lanes, np {np_} (n {n}), rp {rp}", flush=True)
        a = [sc[:, q].to(dt) for q in range(6)]
        want = sol.post_plain(swn.transpose(-1, -2), lw.transpose(-1, -2),
                              ehs[:, 0], *a[:2], *a[4:], r, n)
        k2 = sol.w_post(swn.transpose(-1, -2).contiguous()[:, None],
                        lw.transpose(-1, -2).contiguous(), ehs, sc, r, n)
        ref = e2(libs["repo"], swn, lw, ehs, sc, r, n)
        torch.cuda.synchronize()
        k2_bits = all(torch.equal(g, v.transpose(-1, -2))
                      for g, v in zip(ref[:3], k2[:3]))
        print(f"  repo e, lwn, d == K2's on the transposed layout: "
              f"{k2_bits}", flush=True)
        shn, lh = h_inputs(nb, rp, 4096, dt, dev)
        cases = {}
        for name, lib in libs.items():
            if name == "staged" and dt != torch.float32:
                continue
            cols = COLS.get(name, epi.E2_COLS)
            got = e2(lib, swn, lw, ehs, sc, r, n, cols)
            torch.cuda.synchronize()
            errs = [rel_err(g, v.transpose(-1, -2))
                    for g, v in zip(got[:3], want[:3])]
            errs += [rel_err(got[3].sum(1), want[3]),
                     rel_err(got[4].sum(1), want[4])]
            same = [torch.equal(g, v) for g, v in zip(got[:3], ref[:3])]
            print(f"  {name}: against plain ew {errs[0]:.3g} lwn "
                  f"{errs[1]:.3g} dw {errs[2]:.3g} csum {errs[3]:.3g} "
                  f"scalars {errs[4]:.3g}; e, lwn, d bits == repo {same}",
                  flush=True)
            cases[f"E2 {name}"] = (lambda lib=lib, cols=cols: e2(
                lib, swn, lw, ehs, sc, r, n, cols))
            if name in ("repo", "cols128"):
                part = got[3]
                cases[f"E3 on {name}'s partials"] = (
                    lambda part=part: e3(libs["repo"], part, sc, r, shn, lh))
        if "baseline" in libs:
            got = [e3(libs[k], ref[3], sc, r, shn, lh, COLS.get(k,
                                                                sol.POST_COLS))
                   for k in ("repo", "baseline")]
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in zip(got[0][:3],
                                                          got[1][:3]))
            tot = max(rel_err(got[0][q].sum(1), got[1][q].sum(1))
                      for q in (3, 4))
            print(f"  E3 (post.cuh) repo == baseline on the same inputs: "
                  f"eh, lhn, dh bit for bit {same}, rank-sum and scalar "
                  f"totals rel {tot:.3g}", flush=True)
        cases["E2 plain"] = lambda: sol.post_plain(
            swn.transpose(-1, -2), lw.transpose(-1, -2), ehs[:, 0], *a[:2],
            *a[4:], r, n)
        times = {c: [] for c in cases}
        order = list(cases)
        for seq in (order, order[::-1], order):
            for c in seq:
                times[c].append(cuda_ms(cases[c], 20 if "plain" not in c
                                        else 3))
        moved = nbytes(swn, lw, ehs, sc, ref[:3], want[3], want[4])
        for c, v in times.items():
            med = sorted(v)[1]
            rate = (f", {moved / med / 1e6:.1f} GB/s of the function's "
                    f"{moved / 1e6:.1f} MB" if c.startswith("E2") else "")
            print(f"  {c:24s}: median {med:.4f} ms (readings "
                  f"{', '.join(f'{t:.4f}' for t in v)}){rate}", flush=True)
        del swn, lw, ehs, sc, want, k2, ref, shn, lh
        torch.cuda.empty_cache()
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
