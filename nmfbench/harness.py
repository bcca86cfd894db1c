"""One run of one cell: set-up, the measured window, the trace, the
comparison with the reference, and the result line.

The window is a closed loop of one analyst: the traffic's entry is
called on one ``SCSet`` over and over, each call starting when the last
returns, until the first call that ends at or after ``seconds``.  Every
call's seed comes from the run's seed and the call's index.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "ccfindr_tpu_torch"
# top-level module names the run may not load: JAX and the JAX package
# (compared whole: the port's name begins with the JAX package's)
BARRED = ("jax", "jaxlib", "flax", "ccfindr_tpu")
WARM_SCAN = 1 << 20            # the warm-up scan's index
DATA = 1 << 21                 # the counts' index
TRACED_SCANS = 2               # scans a --trace 1 run traces
MARK_CYCLES = 1000             # the trace's marker, ~1 us
SETTLE_S = 0.05                # the host's pause around a traced scan


def load_json(path):
    return json.loads(Path(path).read_text())


def cell(workload):
    """The cell's entries by the names ``BENCHMARK.json`` gives them:
    (spec, workload, configuration, traffic, limits)."""
    spec = load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    cfg = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return spec, wl, cfg, traffic, limits


def scan_seed(seed, i):
    """The seed of call ``i`` of a run seeded ``seed`` (63 bits)."""
    s = np.random.SeedSequence([int(seed), int(i)]).generate_state(
        2, np.uint32)
    return (int(s[0]) << 31) ^ int(s[1])


def barred_modules():
    """Loaded modules whose top-level name is barred, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BARRED))


def metric_reader(name):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"nmfbench.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What the metric readers read."""
    traffic: dict
    device_kind: str
    n: int = 0
    m: int = 0
    nnz: int = 0
    setup: dict = field(default_factory=dict)
    setup_s: float = 0.0
    scans: list = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0
    trace: dict | None = None


def power_limit(index):
    """The card's name and power limit as ``nvidia-smi`` reads them,
    beside every number a run keeps (None where it cannot read them)."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "-i", str(index),
                            "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip() or None


def _import_port():
    port = importlib.import_module(PORT)
    where = Path(port.__file__).resolve()
    if ROOT not in where.parents:
        raise SystemExit(f"{PORT} was loaded from {where}, outside the "
                         f"checkout {ROOT}")
    return port


def drop_empty(x):
    """X without its empty genes and cells, as the ``SCSet`` an analyst
    builds keeps it (none are empty at the configurations' sizes)."""
    rows = (x != 0).any(1)
    cols = (x != 0).any(0)
    if bool(rows.all()) and bool(cols.all()):
        return x
    return x[rows][:, cols].contiguous()


def _to_scset(port, x):
    """The host ``SCSet`` of a dense count tensor, built from its
    nonzeros (int64 counts in CSR, as a 10x matrix is read)."""
    import scipy.sparse as sp
    import torch

    n, m = x.shape
    rows, cols = torch.nonzero(x, as_tuple=True)
    vals = x[rows, cols].to(torch.int64).cpu().numpy()
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.bincount(rows, minlength=n).cpu().numpy(),
              out=indptr[1:])
    mat = sp.csr_matrix((vals, cols.to(torch.int32).cpu().numpy(), indptr),
                        shape=(n, m))
    return port.SCSet(mat)


def _profiler(cuda, host):
    """A ``torch.profiler`` of the device's activity, and of the host's
    operators where ``host``."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _traced_call(entry, port, scset, traffic, seed, device, dev, host):
    """One scan under the profiler: inside the ``trace.SPAN`` span where
    ``host``; otherwise after a ``trace.MARKER`` launch on an idle card
    ``dev`` (None on the CPU), which opens ``trace.read``'s window.
    Returns the answer and the window's length: the host's time from the
    marker's end to the call's return with the card synchronised."""
    import torch
    from torch.profiler import record_function

    from . import trace as trace_reader

    def settle():
        # the profiler keeps no device record it dates outside its own
        # start and stop, so neither may fall next to the window's ends
        if dev is not None:
            torch.cuda.synchronize(dev)
            time.sleep(SETTLE_S)

    settle()
    if dev is not None and not host:
        with torch.cuda.device(dev):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    with record_function(trace_reader.SPAN) if host else nullcontext():
        ans = entry.call(port, scset, traffic, seed, device)
    if dev is not None:
        torch.cuda.synchronize(dev)
    span_s = time.perf_counter() - t
    settle()
    return ans, span_s


def run(workload, seed, seconds, trace, device="cuda", t_start=None,
        cell_override=None, log=print):
    """One run of ``workload``; returns the result line's dict.
    ``cell_override`` (spec, wl, cfg, traffic, limits) stands in for the
    files (the CPU tests' small sizes)."""
    t0 = time.perf_counter() if t_start is None else t_start
    import torch

    spec, wl, cfg, traffic, limits = (cell_override if cell_override
                                      is not None else cell(workload))
    entry = importlib.import_module(f"nmfbench.entries.{traffic['entry']}")
    dataset = importlib.import_module(
        f"nmfbench.datasets.{cfg['data']['kind']}")
    port = _import_port()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    rn = Run(traffic=traffic, device_kind=kind)
    rn.setup["imports_s"] = time.perf_counter() - t0

    t = time.perf_counter()
    if cuda:
        from ccfindr_tpu_torch.ops.kernels import build
        build.library()
    rn.setup["build_or_load_s"] = time.perf_counter() - t

    t = time.perf_counter()
    x = drop_empty(dataset.generate(cfg["data"], scan_seed(seed, DATA),
                                    dev))
    rn.n, rn.m = x.shape
    rn.nnz = int(torch.count_nonzero(x))
    scset = _to_scset(port, x)
    x_host = x.cpu()
    del x
    if cuda:
        torch.cuda.synchronize(dev)
    rn.setup["data_s"] = time.perf_counter() - t

    t = time.perf_counter()
    entry.call(port, scset, traffic, scan_seed(seed, WARM_SCAN), device,
               itmax=2)
    if cuda:
        torch.cuda.synchronize(dev)
    rn.setup["warm_scan_s"] = time.perf_counter() - t
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    rn.setup_s = time.perf_counter() - t0
    log("setup " + json.dumps({k: round(v, 4) for k, v in
                               rn.setup.items()}
                              | {"setup_s": round(rn.setup_s, 4)}))
    if cuda:
        log(f"card {power_limit(dev.index or 0)}")

    # the measured window; with --trace 1 its first scan is traced for
    # the device alone and its second with the host's operators too
    lanes = entry.lane_count(traffic, rn.m)
    itmax = int(traffic["Itmax"])
    answers, profs, spans = [], [], []
    w_start = time.perf_counter()
    while True:
        i = len(answers)
        s = scan_seed(seed, i)
        traced = bool(trace) and i < TRACED_SCANS
        ts = time.perf_counter()
        if traced:
            with _profiler(cuda, host=i == 1) as prof:
                ans, span_s = _traced_call(entry, port, scset, traffic, s,
                                           device, dev if cuda else None,
                                           host=i == 1)
            profs.append(prof)
            spans.append(span_s)
        else:
            ans = entry.call(port, scset, traffic, s, device)
        te = time.perf_counter()
        answers.append(ans)
        rn.scans.append(dict(index=i, seed=s, wall_s=te - ts,
                             loop_s=ans["loop_s"], traced=traced,
                             lane_sweeps=lanes * itmax))
        log(f"scan {i} seed {s} wall_s {te - ts:.4f} loop_s "
            f"{ans['loop_s']} traced {traced}")
        # a --trace 1 run ends on an untraced scan, for the readers of
        # the driver's span
        if te - w_start >= seconds and (not trace or i >= TRACED_SCANS):
            break
    rn.window_s = te - w_start
    rn.peak_bytes = (int(torch.cuda.max_memory_allocated(dev)) if cuda
                     else 0)
    del scset
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    if profs:
        from . import trace as trace_reader
        t = time.perf_counter()
        rn.trace = trace_reader.read(profs[0], spans[0])
        if rn.trace is not None:
            rn.trace["idle_gaps"] = trace_reader.idle_gaps(profs[1]) or []
        elif cuda:
            log("trace not read: " + trace_reader.describe(profs[0]))
        del profs
        log(f"traces read in {time.perf_counter() - t:.2f} s")

    # the comparison with the reference, on a sample drawn from the seed
    t = time.perf_counter()
    from . import reference as ref
    bad = [a for a in answers if not entry.complete(a, traffic, rn.m)]
    at, ranks_at = entry.check_sample(traffic, len(answers), seed)
    cx = ref.counts(x_host.to(dev))
    lanes_by_rank = entry.reference(cx, traffic, answers[at]["seed"],
                                    ranks_at)
    numbers = entry.gaps(answers[at], lanes_by_rank)
    del cx
    numbers["incomplete_scans"] = float(len(bad))
    log("gaps " + json.dumps(numbers))
    limits = dict(limits["limits"], incomplete_scans=0.0)
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    log(f"reference checked scan {at} ranks "
        f"{[traffic['ranks'][k] for k in ranks_at]} in "
        f"{time.perf_counter() - t:.2f} s")

    sample_ok = all(v["value"] <= v["limit"] for k, v in checks.items()
                    if k != "incomplete_scans")
    failed = len(bad) + (0 if sample_ok else 1)
    names = [m for m in spec["end_to_end" if not trace else "per_layer"]
             if "workloads" not in m or wl["name"] in m["workloads"]]
    metrics = {}
    for m in names:
        v = metric_reader(m["name"])(rn)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    devinfo = dict(platform="gpu" if cuda else "cpu", kind=kind, count=1,
                   memory_peak_bytes=rn.peak_bytes)
    result = dict(correct=bool(correct), attempted=len(answers),
                  failed=failed, metrics=metrics, device=devinfo)
    if trace and rn.trace is not None:
        devinfo.update(busy_s=rn.trace["busy_s"],
                       window_s=rn.trace["window_s"])
        result["breakdown"] = dict(device_ops=rn.trace["device_ops"],
                                   idle_gaps=rn.trace["idle_gaps"])
    result["checks"] = checks
    return result
