"""The VB driver's host set-up on the atlas X, on one NVIDIA GPU.

Before its loop, ``vb_factorize`` turns the SCSet's CSR into the dense
layouts' X, guards it (no empty row or column; ``storage_dtype='auto'``
reads its integrality and range) and copies it to the card as int8.
This script builds the atlas of ``examples/atlas_demo_torch.py``
(``simulate_atlas``: 20,480 x 100,352 int8, no QC) and its SCSet, then
times one call (ranks [2], nrun 1, Itmax 1, Tol 0, ``backend='pallas'``;
a call on a small X first builds the kernels): the wall, the loop
(``metadata['timings']``) and their difference, the set-up and
selection, and the process's peak host RSS.

The ``ccfindr_tpu_torch`` it times is the first one on ``sys.path``:
``PYTHONPATH=<another checkout> python3 tools/time_atlas_setup.py``
times that checkout's driver on the same X.  Prints the card's name and
power limit first and one JSON object last.

Run from the repository's root: ``python3 tools/time_atlas_setup.py``.
"""
import importlib.util
import json
import os
import resource
import subprocess
import time

import torch

import ccfindr_tpu_torch as ct

DEMO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "examples", "atlas_demo_torch.py")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_atlas_setup.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    spec = importlib.util.spec_from_file_location("atlas_demo_torch", DEMO)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    # a small call first builds and loads the kernels, so that the timed
    # call compiles nothing
    ct.vb_factorize(demo.simulate_atlas(256, 512, base_cells=512)[0],
                    ranks=[2], Itmax=1, backend="pallas", device="cuda",
                    verbose=0)
    t0 = time.perf_counter()
    x, _ = demo.simulate_atlas()
    t_sim = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = ct.SCSet(count=x, remove_zeros=False)
    t_set = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = ct.vb_factorize(s, ranks=[2], nrun=1, Itmax=1, Tol=0, seed=0,
                        backend="pallas", device="cuda", verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop = f.metadata["timings"][0]["seconds"]
    print(json.dumps({
        "package": os.path.dirname(ct.__file__),
        "shape": list(x.shape), "simulate_s": t_sim, "scset_s": t_set,
        "vb_factorize_wall_s": wall, "loop_s": loop,
        "setup_and_selection_s": wall - loop,
        "peak_host_rss_gib": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}))


if __name__ == "__main__":
    main()
