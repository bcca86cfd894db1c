"""E1s fused_sum (csrc/sum.cuh) against variants of itself and against
``Tensor.sum`` on one NVIDIA GPU, at the two shapes its paths give it:
phase 12's gene-major shape (E1's partials at 100,000 x 4,096, 3 lanes
of rp 16: 391 chunks of 256 genes x 16 x 4,096 floats) and P1's at the
10x shape (4,096 x 8,192, 3 lanes of rp 16, ``vb_kernels.pass2_chunk``'s
chunk).

The variants are instantiations of the package's own template
``launch_fused_sum<float, threads, unroll, vec>`` built in one nvcc call
into ``ccfindr_tpu_torch/_build/bench_fused_sum/``: ``repo`` (the
package's defaults), the one-element-a-thread design (256 threads, no
unroll, 4-byte loads) and other block sizes, unroll depths and vector
widths.  Every variant must give the repo's bits (each element summed
in double in chunk order).  Each is timed by CUDA events (20 launches a
reading, outputs preallocated) in turns (forward, backward, forward;
the median of the three) beside ``torch.sum(part, 1, out=...)``.
Prints the card, each variant's registers, readings and the share of
the byte bound (the partials read once, the sums written once, over
3.35 TB/s).  Run from the repository root: ``python3
tools/bench_fused_sum.py``.
"""
import ctypes
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
from chip_smoke import cuda_ms  # noqa: E402

from ccfindr_tpu_torch.ops.kernels import build  # noqa: E402
from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk  # noqa: E402

OUT = build.BUILD_DIR / "bench_fused_sum"
# name -> (threads, unroll, elements a load); None: the package's defaults
VARIANTS = {
    "repo": None,
    "one_element": (256, 1, 1),
    "scalar_u8": (256, 8, 1),
    "t64_u16": (64, 16, 4),
    "t64_u32": (64, 32, 4),
    "t128_u8": (128, 8, 4),
    "t128_u16": (128, 16, 4),
    "t256_u8": (256, 8, 4),
    "t32_u16": (32, 16, 4),
    "t64_u8_v4": (64, 8, 4),
    "t128_u16_v2": (128, 16, 2),
}
HBM_BYTES = 3.35e12


def repo_config():
    """(threads, unroll, floats a load) of the package's defaults,
    read from csrc/sum.cuh."""
    text = (build.CSRC / "sum.cuh").read_text()
    get = (lambda name: int(re.search(rf"{name} = (\d+);", text).group(1)))
    return get("kSumThreads"), get("kSumUnroll"), get("kSumBytes") // 4


def build_variants():
    OUT.mkdir(parents=True, exist_ok=True)
    lines = ['#include "sum.cuh"', "using namespace ccfindr;"]
    for name, v in VARIANTS.items():
        targs = "float" if v is None else f"float, {v[0]}, {v[1]}, {v[2]}"
        lines.append(
            f'extern "C" int {name}(const float* p, int P, int L, '
            f"const double* xp, int Q, int B, float* out, double* xl, "
            f"void* s) {{ return launch_fused_sum<{targs}>(p, P, L, xp, Q, "
            f"B, out, xl, static_cast<cudaStream_t>(s)); }}")
    (OUT / "entry.cu").write_text("\n".join(lines) + "\n")
    so = OUT / "lib.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-I", str(build.CSRC), "-shared", "-o", str(so),
                        str(OUT / "entry.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stderr}")
    regs = {}
    for blk in r.stderr.split("Compiling entry function")[1:]:
        m = re.search(r"fused_sum_kernelIfLi(\d+)ELi(\d+)ELi(\d+)E", blk)
        u = re.search(r"Used (\d+) registers", blk)
        if m and u:
            regs[tuple(int(g) for g in m.groups())] = int(u.group(1))
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    for name in VARIANTS:
        fn = getattr(lib, name)
        fn.argtypes = [P_, I_, I_, P_, I_, I_, P_, P_, P_]
        fn.restype = I_
    return lib, regs


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    lib, regs = build_variants()
    print(f"  built {len(VARIANTS)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    x10 = torch.zeros(4096, 8192, device=dev)
    p1 = vbk.pass2_chunk(x10, 4096, 8192, 3, 16, 4)
    shapes = {"gene-major (E1 'gm')": (3, -(-100_000 // 256), 16, 4096),
              f"10x (P1, chunk {p1})": (3, -(-4096 // p1), 16, 8192)}
    gen = torch.Generator(device=dev).manual_seed(0)
    for sname, shape in shapes.items():
        nb, P = shape[:2]
        L = shape[2] * shape[3]
        part = torch.randn(shape, generator=gen, device=dev)
        xpart = torch.rand(nb, P, generator=gen, device=dev,
                           dtype=torch.float64)
        outs = {k: (torch.empty(nb, L, device=dev),
                    torch.empty(nb, dtype=torch.float64, device=dev))
                for k in VARIANTS}
        lib_out = torch.empty(nb, *shape[2:], device=dev)

        def launch(name):
            o, xl = outs[name]
            build.launch(getattr(lib, name), part, P, L, xpart, P, nb, o,
                         xl)

        for k in VARIANTS:
            launch(k)
        torch.cuda.synchronize()
        same = {k: torch.equal(outs[k][0], outs["repo"][0])
                for k in VARIANTS}
        cases = {k: (lambda k=k: launch(k)) for k in VARIANTS}
        cases["Tensor.sum"] = lambda: torch.sum(part, 1, out=lib_out)
        times = {c: [] for c in cases}
        order = list(cases)
        for seq in (order, order[::-1], order):
            for c in seq:
                times[c].append(cuda_ms(cases[c], 20))
        bound = (part.numel() + nb * L) * 4 / HBM_BYTES * 1e3
        print(f"{sname}: partials {tuple(shape)} float32, "
              f"{part.numel() * 4 / 1e9:.3f} GB; bound {bound:.4f} ms "
              f"(bytes)", flush=True)
        for c, v in times.items():
            med = sorted(v)[1]
            cfg = repo_config() if c == "repo" else VARIANTS.get(c, "")
            key = cfg or None
            extra = (f", {regs.get(key, '?')} registers, the repo's bits "
                     f"{same[c]}" if c in VARIANTS else "")
            print(f"  {c:12s} {str(cfg or ''):14s}: median {med:.4f} ms "
                  f"({bound / med:.1%} of the bound; readings "
                  f"{', '.join(f'{t:.4f}' for t in v)}){extra}", flush=True)
        del part, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
