"""The gamma-posterior kernel (csrc/post.cuh: K2, K3, K3s, E3) and K4
sol_finish (csrc/sol.cu) on one NVIDIA GPU at each launch site's shape,
beside edits of them and, with ``--baseline DIR``, another tree's in the
same call.

Sites (float32 factors; the inputs are the port's own X-pass outputs on
chip_smoke.py's matrices, random gamma starts from a seed):

* ``K2 10x``, ``K3 10x``, ``K4 10x``: phase 4's planted 4,096 x 8,192
  int8 X, 6 lanes of ranks 8, 8, 12, 12, 16, 16 (rp 16): K2 on K1's 32
  swn partials a gene, K3 on its 16 shn partials a cell, K4 on the
  three kernels' partials;
* ``K2 gathered``, ``K3s shard``: the same X over 4 cell shards of
  2,048 (phase 17): K2 on the shards' swn partials gathered in shard
  order, K3 on shard 0's shn partials and lh;
* ``E3 gm``: phase 12's planted 100,000 x 4,096 X, 3 lanes of r 16: E3
  on E1s's summed shn and E2's 391 csum partials a lane;
* ``K2 bundled``, ``K3 bundled``: the bundled data after QC (684 x 447
  int16), 21 lanes of ranks 2..8 (rp 8).

Versions, each compiled from a small entry file (post.cuh, and K4's
section of sol.cu cut out by its markers) with nvcc into
``ccfindr_tpu_torch/_build/bench_post/``, one nvcc a version, all
started together:

* ``repo``: the package's kernels (post_kernel a thread an entry,
  ``kPostCols`` columns a block; finish_kernel a block a lane);
* ``cols64``, ``cols128``: ``kPostCols`` 64 and 128;
* ``loads8``: 8 partial loads in flight a thread, not 16;
* ``lb5``: ``__launch_bounds__(256, 5)`` on post_kernel (at most 51
  registers: 5 blocks an SM);
* ``dthread``, ``dthread64``: the denominator as first redesigned, a
  thread a rank loading its own partials (16 in flight), not staged
  through shared memory (at 32 and 64 columns a block);
* ``fin256``: finish_kernel on 256 threads, not 512;
* ``unroll2``: post_kernel's entry loop unrolled by two (two entries'
  chains in flight a thread, as E2 takes them);
* ``baseline`` (``--baseline DIR``, a csrc directory, e.g. a ``git
  archive`` of an older tree under ``.archive/``): that tree's kernels
  (its columns a block read from its post.cuh).

Each version runs the sweep's chain on its own partials (its K2's
partials feed its K3, both feed its K4), so a time is that of the path
it would run.  On the same inputs each version's e, ln and d are held
bit for bit against the baseline's (the repo's without one), its
rank-sum and scalar totals to 1e-12 relative, and K4's sixteen slots
bit for bit.  A reading is 20 launches: a launch's device time in a
CUDA graph of them (chip_smoke.kernel_ms), and a call's time by CUDA
events (which, for a kernel this short, can be the host's time to issue
the call); the
readings in turns (baseline, repo, repo, baseline, then the edits) three
times, the median of each version's readings.  K4 is also timed with
hyper_mask all False (the sums alone), and the Newton iterations each
lane took are found by launching it with niter 1, 2, ... until its
failure flag clears.  Prints the card, ptxas's registers and spills of
both kernels in float and double, every reading, and the partials'
bytes over 3.35 TB/s beside each time.  Run from the repository root:
``python3 tools/bench_post.py [--baseline DIR]``.
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
from chip_smoke import (bundled_filtered, cuda_ms, kernel_ms,  # noqa: E402
                        nbytes, planted_10x, planted_gm, rel_err)

from ccfindr_tpu_torch.ops import vb  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import build  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import epilogue as epi  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import sol  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk  # noqa: E402
from ccfindr_tpu_torch.parallel.sharded import ShardedCounts  # noqa: E402

OUT = build.BUILD_DIR / "bench_post"
HBM = 3.35e12
POST = ('extern "C" int post(int tcode, const void* sfx, int nsfx, '
        "const void* lf, const double* den, int nden, const double* sc, "
        "int ab, int B, int ext, int rp, int r, int n_live, int n_pin, "
        "void* e, void* l, void* d, double* rs, double* ss, void* st) {\n"
        "  return post_entry(tcode, sfx, nsfx, lf, den, nden, sc, ab, B, "
        "ext, rp, r, n_live, n_pin, e, l, d, rs, ss, st);\n}\n")
# the first redesign's denominator: a thread a rank loads its own
# partials, 16 in flight (DTHREAD in place of the staging loop DSTAGE)
DSTAGE = """  for (int base = 0; base < dtotal; base += dchunk) {
    const int cnt = min(dchunk, dtotal - base);
#pragma unroll 8
    for (int i = tid; i < cnt; i += kPostThreads) den_s[i] = dp[base + i];
    __syncthreads();
    if (tid < rp)
      dsum = ordered_sum<kPostLoads>(den_s + tid, cnt / rp, rp, dsum);
    __syncthreads();
  }"""
DTHREAD = """  if (tid < rp)
    dsum = ordered_sum<16>(dp + tid, ndenom, rp);"""
LB = "__global__ void __launch_bounds__(kPostThreads)\npost_kernel"
LOOP = "  for (int i = tid; i < rp * kPostCols; i += kPostThreads) {"
EDITS = {"repo": [],
         "cols64": [("post.cuh", "kPostCols = 32;", "kPostCols = 64;")],
         "cols128": [("post.cuh", "kPostCols = 32;", "kPostCols = 128;")],
         "loads8": [("post.cuh", "kPostLoads = 16;", "kPostLoads = 8;")],
         "lb5": [("post.cuh", LB, LB.replace("(kPostThreads)",
                                             "(kPostThreads, 5)"))],
         "dthread": [("post.cuh", DSTAGE, DTHREAD)],
         "dthread64": [("post.cuh", DSTAGE, DTHREAD),
                       ("post.cuh", "kPostCols = 32;", "kPostCols = 64;")],
         "fin256": [("sol.cu", "kFinThreads = 512;", "kFinThreads = 256;")],
         "unroll2": [("post.cuh", LOOP, "#pragma unroll 2\n" + LOOP)]}
_I, _P = ctypes.c_int, ctypes.c_void_p
POST_ARGS = [_I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P]
FIN_ARGS = [_I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
            _I, ctypes.c_double, _P, _P]


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def entry_file(csrc):
    """The bench entry of a csrc directory: post.cuh's entry and K4's
    section of sol.cu (the scal slots to the launchers, and sol_finish)."""
    text = (csrc / "sol.cu").read_text()
    body = text[text.index("// scal slots"):text.index("// Launchers")]
    fin = text[text.index("int sol_finish("):]
    fin = fin[:fin.index("\n}\n") + 3]
    return ('#include "post.cuh"\n#include "specials.cuh"\n'
            "namespace ccfindr {\n" + body + "}  // namespace ccfindr\n"
            'using namespace ccfindr;\nextern "C" {\n' + POST + fin + "}\n")


def build_versions(baseline):
    """Compile each version at once; {name: (ctypes library, columns a
    post block)}."""
    srcs = {name: (build.CSRC, edits) for name, edits in EDITS.items()}
    if baseline:
        srcs["baseline"] = (baseline, [])
    running = {}
    for name, (csrc, edits) in srcs.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        for fname, old, new in edits:
            src = (d / fname).read_text()
            if old not in src:
                raise RuntimeError(f"version {name}: {old!r} not found")
            (d / fname).write_text(src.replace(old, new))
        (d / "bench_entry.cu").write_text(entry_file(d))
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
            if "post_kernel" not in kname and "finish_kernel" not in kname:
                continue
            regs = re.search(r"Used (\d+) registers", blk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", blk)
            print(f"  ptxas {name} {kname[:40]}: "
                  f"{regs.group(1) if regs else '?'} registers, spill "
                  f"stores/loads {spill.groups() if spill else '?'}",
                  flush=True)
        src = (OUT / name / "post.cuh").read_text()
        cols = re.search(r"constexpr int kPostCols = (\d+);", src) or \
            re.search(r"constexpr int kPostThreads = (\d+);", src)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.post.argtypes, lib.post.restype = POST_ARGS, _I
        lib.sol_finish.argtypes, lib.sol_finish.restype = FIN_ARGS, _I
        libs[name] = (lib, int(cols.group(1)))
    return libs


def post(ver, sfx_part, lf, denom_part, sc, ab, r, n_live, n_pin):
    """One post_kernel launch of a version: (e, ln, d, rsum_part,
    scal_part)."""
    lib, cols = ver
    nb, rp, ext = lf.shape
    nblk = -(-ext // cols)
    e, ln, d = (torch.empty_like(lf) for _ in range(3))
    rs = torch.empty(nb, nblk, rp, dtype=torch.float64, device=lf.device)
    ss = torch.empty(nb, nblk, 4, dtype=torch.float64, device=lf.device)
    build.check_launch("post", lib.post(
        build.TCODE[lf.dtype], sfx_part.data_ptr(), sfx_part.shape[1],
        lf.data_ptr(), denom_part.data_ptr(), denom_part.shape[1],
        sc.data_ptr(), ab, nb, ext, rp, r, n_live, n_pin, e.data_ptr(),
        ln.data_ptr(), d.data_ptr(), rs.data_ptr(), ss.data_ptr(),
        build.stream()))
    return e, ln, d, rs, ss


def finish(ver, sc, xlog_part, w, h, n, m, mask=15, niter=100):
    """One finish_kernel launch of a version on K2's (w) and K3's (h)
    partials: scal (B, 16)."""
    lib = ver[0]
    nb = sc.shape[0]
    rp = w[3].shape[2]
    out = torch.empty(nb, sol.NSCAL, dtype=torch.float64, device=sc.device)
    build.check_launch("finish", lib.sol_finish(
        0, sc.data_ptr(), xlog_part.data_ptr(), xlog_part.shape[1],
        w[3].data_ptr(), w[4].data_ptr(), w[3].shape[1], h[3].data_ptr(),
        h[4].data_ptr(), h[3].shape[1], nb, rp, n, m, mask, niter, 1e-4,
        out.data_ptr(), build.stream()))
    return out


def lanes_state(n, m, ranks, rp, dev, seed=0):
    """Random gamma starts of vb_init_random, rank-masked as a scan
    masks them: lwt (B, rp, n), lh, eh (B, rp, m), sc (B, 8)."""
    gen = torch.Generator().manual_seed(seed)
    h1 = vb.Hyper(1.0, 1.0, 1.0, 1.0)
    nb = len(ranks)
    st = [vb.vb_init_random(gen, n, m, rp, h1, torch.float32, dev)
          for _ in range(nb)]
    fudge = float(torch.finfo(torch.float32).eps)
    lwt = torch.stack([s.lw.t() for s in st]).contiguous()
    lh = torch.stack([s.lh for s in st]).contiguous()
    eh = torch.stack([s.eh for s in st]).contiguous()
    for b, rk in enumerate(ranks):
        lwt[b, rk:] = fudge
        lh[b, rk:] = fudge
        eh[b, rk:] = 0.0
    sc = torch.zeros(nb, 8, dtype=torch.float64, device=dev)
    sc[:, :4] = 1.0
    sc[:, 4] = fudge
    sc[:, 5] = torch.tensor(ranks, dtype=torch.float64)
    sc[:, 7] = 1.0
    return lwt, lh, eh, sc


def compare(name, got, ref, same_inputs=True):
    """e, ln, d bit for bit and the partial totals to 1e-12 against the
    reference version's outputs on the same inputs."""
    bits = all(torch.equal(g, v) for g, v in zip(got[:3], ref[:3]))
    tot = max(rel_err(got[3].sum(1), ref[3].sum(1)),
              rel_err(got[4].sum(1), ref[4].sum(1)))
    ok = bits and tot <= 1e-12
    print(f"    {name}: e, ln, d bits {bits}; rank-sum/scalar totals rel "
          f"{tot:.3g}{'' if ok else '  MISMATCH'}", flush=True)
    return ok


def timed(cases, order):
    """Each case timed in turns (the order forward, backward, forward):
    {case: (readings of a call by CUDA events, readings of a launch in
    a CUDA graph)}."""
    times = {c: ([], []) for c in cases}
    for seq in (order, order[::-1], order):
        for c in seq:
            times[c][0].append(cuda_ms(cases[c], 20))
            times[c][1].append(kernel_ms(cases[c], 20))
    return times


def report(site, times, floor_bytes):
    for c, (ev, dv) in times.items():
        print(f"  {site} {c:9s}: graph median {np.median(dv):.4f} ms "
              f"(readings {', '.join(f'{t:.4f}' for t in dv)}); a call by "
              f"events {np.median(ev):.4f} (readings "
              f"{', '.join(f'{t:.4f}' for t in ev)})", flush=True)
    if floor_bytes:
        print(f"  {site} partial-bytes floor: {floor_bytes / 1e6:.1f} MB -> "
              f"{floor_bytes / HBM * 1e3:.4f} ms at 3.35 TB/s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="a csrc directory whose post.cuh and K4 run beside")
    args = ap.parse_args()
    print(smi(), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    vers = build_versions(args.baseline)
    print(f"  built {len(vers)} versions in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ref = "baseline" if "baseline" in vers else "repo"
    order = ([ref, "repo", "repo", ref] if ref != "repo" else ["repo"]) + [
        v for v in vers if v not in ("repo", "baseline")]
    names = list(dict.fromkeys(order))
    ok = True

    # 10x: K1's partials, then each version's K2 -> K3 -> K4
    x_np = planted_10x()
    n, m = x_np.shape
    x = torch.as_tensor(x_np, device=dev)
    ranks = [8, 8, 12, 12, 16, 16]
    lwt, lh, eh, sc = lanes_state(n, m, ranks, 16, dev)
    swn_p, shn_p, xlog_p, ehs_p = sol.xpass(x, lwt, lh, eh, sc)
    w = {v: post(vers[v], swn_p, lwt, ehs_p, sc, 0, 16, n, n) for v in names}
    h = {v: post(vers[v], shn_p, lh, w[v][3], sc, 2, 16, m, m)
         for v in names}
    torch.cuda.synchronize()
    print(f"10x: X {n} x {m} int8, 6 lanes rp 16; K1 partials swn "
          f"{tuple(swn_p.shape)}, shn {tuple(shn_p.shape)}", flush=True)
    for v in names:
        print(f"  {v}: K2 partials {tuple(w[v][3].shape)}, K3 "
              f"{tuple(h[v][3].shape)}", flush=True)
        if v != ref:
            ok &= compare(f"K2 {v} vs {ref}", w[v], w[ref])
            same_h = post(vers[v], shn_p, lh, w[ref][3], sc, 2, 16, m, m)
            ok &= compare(f"K3 {v} vs {ref} (on {ref}'s csum)", same_h,
                          h[ref])
            f_same = finish(vers[v], sc, xlog_p, w[ref], h[ref], n, m)
            f_ref = finish(vers[ref], sc, xlog_p, w[ref], h[ref], n, m)
            fb = torch.equal(f_same, f_ref)
            print(f"    K4 {v} vs {ref} on {ref}'s partials: 16 slots bit "
                  f"for bit {fb}", flush=True)
            ok &= fb
    k2 = timed({v: (lambda v=v: post(vers[v], swn_p, lwt, ehs_p, sc, 0, 16,
                                     n, n)) for v in names}, order)
    report("K2 10x", k2, nbytes(swn_p, lwt, ehs_p, w["repo"]))
    k3 = timed({v: (lambda v=v: post(vers[v], shn_p, lh, w[v][3], sc, 2, 16,
                                     m, m)) for v in names}, order)
    report("K3 10x", k3, nbytes(shn_p, lh, w["repo"][3], h["repo"]))
    k4 = timed({v: (lambda v=v: finish(vers[v], sc, xlog_p, w[v], h[v], n,
                                       m)) for v in names}, order)
    report("K4 10x", k4, 0)
    k4s = timed({v: (lambda v=v: finish(vers[v], sc, xlog_p, w[v], h[v], n,
                                        m, mask=0)) for v in names}, order)
    report("K4 10x hyper_mask all False (the sums)", k4s, 0)
    full = finish(vers["repo"], sc, xlog_p, w["repo"], h["repo"], n, m)
    iters = []
    for b in range(len(ranks)):
        if full[b, sol.HFAIL] > 0:
            iters.append("failed (99)")
            continue
        for niter in range(1, 101):
            f = finish(vers["repo"], sc, xlog_p, w["repo"], h["repo"], n, m,
                       niter=niter)
            if f[b, sol.HFAIL] == 0:
                iters.append(niter - 1)
                break
    print(f"  K4 10x Newton iterations a lane (repo's partials): {iters}",
          flush=True)

    # the mesh: 4 shards of 2,048 cells, K2 on the gathered swn partials,
    # K3s on shard 0
    xs = ShardedCounts(x, np.array([[dev] * 4], dtype=object))
    lhs, ehs = xs.shard_h(lh), xs.shard_h(eh)
    parts = [sol.launch_xpass(blk, lwt, lh_, eh_, sc)
             for blk, lh_, eh_ in zip(xs.blocks[0], lhs, ehs)]
    swn_g = torch.cat([p[0] for p in parts], 1)
    ehs_g = torch.cat([p[3] for p in parts], 1)
    mp = m // 4
    wg = {v: post(vers[v], swn_g, lwt, ehs_g, sc, 0, 16, n, n)
          for v in names}
    for v in names:
        if v != ref:
            ok &= compare(f"K2 gathered {v} vs {ref}", wg[v], wg[ref])
            ok &= compare(f"K3s {v} vs {ref} (on {ref}'s csum)",
                          post(vers[v], parts[0][1], lhs[0], wg[ref][3], sc,
                               2, 16, mp, mp),
                          post(vers[ref], parts[0][1], lhs[0], wg[ref][3],
                               sc, 2, 16, mp, mp))
    t = timed({v: (lambda v=v: post(vers[v], swn_g, lwt, ehs_g, sc, 0, 16,
                                    n, n)) for v in names}, order)
    report("K2 gathered", t, nbytes(swn_g, lwt, ehs_g, wg["repo"]))
    t = timed({v: (lambda v=v: post(vers[v], parts[0][1], lhs[0], wg[v][3],
                                    sc, 2, 16, mp, mp)) for v in names},
              order)
    report("K3s shard", t, nbytes(parts[0][1], lhs[0], wg["repo"][3],
                                  post(vers["repo"], parts[0][1], lhs[0],
                                       wg["repo"][3], sc, 2, 16, mp, mp)))
    del x, xs, parts, swn_g, swn_p, shn_p, w, h, wg, lhs, ehs
    torch.cuda.empty_cache()

    # the gene-major shape: E3 on E1s's shn and E2's 391 partials a lane
    xg_np = planted_gm()
    ng, mg = xg_np.shape
    xg = torch.as_tensor(xg_np, device=dev)
    lwt3, lh3, eh3, sc3 = lanes_state(ng, mg, [16, 12, 8], 16, dev, seed=1)
    lw3 = lwt3.transpose(-1, -2).contiguous()
    swn, shn, _ = vbk.fused_pallas_raw(xg, lw3, lh3, layout="gm")
    e2 = epi.epi_w_post(swn, lw3, eh3.sum(-1, dtype=torch.float64)[:, None],
                        sc3, 16, ng)
    shn1 = shn[:, None]
    e3 = {v: post(vers[v], shn1, lh3, e2[3], sc3, 2, 16, mg, mg)
          for v in names}
    for v in names:
        if v != ref:
            ok &= compare(f"E3 {v} vs {ref}", e3[v], e3[ref])
    t = timed({v: (lambda v=v: post(vers[v], shn1, lh3, e2[3], sc3, 2, 16,
                                    mg, mg)) for v in names}, order)
    report(f"E3 gm ({ng} x {mg}, 3 lanes, {e2[3].shape[1]} E2 partials)", t,
           nbytes(shn1, lh3, e2[3], e3["repo"]))
    del xg, swn, shn, shn1, e2, e3, lw3, lwt3, lh3, eh3
    torch.cuda.empty_cache()

    # the bundled lanes: 21 lanes of ranks 2..8, rp 8
    s = bundled_filtered()
    xb = torch.as_tensor(s.counts_dense(dtype=np.float32).astype(np.int16),
                         device=dev)
    nb_, mb_ = xb.shape
    ranks = [rk for rk in range(2, 9) for _ in range(3)]
    lwtb, lhb, ehb, scb = lanes_state(nb_, mb_, ranks, 8, dev, seed=2)
    sp, hp, _, ep = sol.xpass(xb, lwtb, lhb, ehb, scb)
    wb = {v: post(vers[v], sp, lwtb, ep, scb, 0, 8, nb_, nb_)
          for v in names}
    for v in names:
        if v != ref:
            ok &= compare(f"K2 bundled {v} vs {ref}", wb[v], wb[ref])
    t = timed({v: (lambda v=v: post(vers[v], sp, lwtb, ep, scb, 0, 8, nb_,
                                    nb_)) for v in names}, order)
    report(f"K2 bundled ({nb_} x {mb_}, 21 lanes rp 8)", t,
           nbytes(sp, lwtb, ep, wb["repo"]))
    t = timed({v: (lambda v=v: post(vers[v], hp, lhb, wb[v][3], scb, 2, 8,
                                    mb_, mb_)) for v in names}, order)
    report("K3 bundled", t, nbytes(hp, lhb, wb["repo"][3],
                                   post(vers["repo"], hp, lhb, wb["repo"][3],
                                        scb, 2, 8, mb_, mb_)))
    print(smi(), flush=True)
    print(f"bench_post: {'all checks passed' if ok else 'CHECKS FAILED'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
