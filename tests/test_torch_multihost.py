"""Rank scans of the port over several real processes.

The twin of tests/test_multihost.py: ``python -m
ccfindr_tpu_torch.parallel._mh_worker --device cpu --x64`` is started
once for each process; they form a gloo group on a free localhost port
(``init_distributed``), each runs its round-robin share of the (rank,
run) grid, the evidences, sweep counts and cluster ids cross the process
boundary through ``torch.distributed``, and the winners are replicated.
Every process must return the port's single-process run (the same
worker with ``--nproc 1``, started beside them, so that both sides run
with the same threads) bit for bit at float64: the measure table, every
rank's factors, and the sweep counts of the lanes it ran.  The 2-process
VB and ML runs are also held against the JAX package's single-process
run in this process, at tests/test_torch_driver.py::_assert_same_result's
tolerances (measures 1e-8 relative, factors 1e-6 of their largest
entry); there VB takes the deterministic svd2 start and ML JAX's draws,
which a worker reads through a small prelude, since the random streams
of the packages differ.

Each group of workers is killed at 300 s.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import ccfindr_tpu as cf
from ccfindr_tpu.parallel._mh_worker import build_problem as jax_problem
from ccfindr_tpu_torch.drivers import vb_driver as vd
from ccfindr_tpu_torch.ops.kernels import vb_kernels as tvbk
from ccfindr_tpu_torch.parallel import _mh_worker
from ccfindr_tpu_torch.parallel import schedule as tsched
from test_torch_ml_driver import jax_draws
from test_torch_schedule import threads_as_processes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# the arrays a worker writes that are not the result
NOT_RESULT = ("wall", "n_iter", "lanes")

# the worker, with the ML start hooked to draws the test wrote
JAX_DRAWS_PRELUDE = """
import sys
import numpy as np
import torch
from ccfindr_tpu_torch.drivers import ml_driver
from ccfindr_tpu_torch.parallel import _mh_worker
z = np.load(sys.argv.pop(1))

def draws(seed, ismpl, pairs, nrank, nrun, n, m, rank, dtype, device):
    sel = [(ismpl * nrank + k) * nrun + i for k, i in pairs]
    return (torch.as_tensor(z["w"][sel][:, :, :rank]).to(device, dtype),
            torch.as_tensor(z["h"][sel][:, :rank]).to(device, dtype))

ml_driver.initial_factors = draws
_mh_worker.main(sys.argv[1:])
"""

# the worker, stopped by SystemExit(3) in its third chunk, as a crash
CRASH_PRELUDE = """
import sys
from ccfindr_tpu_torch.drivers import ml_driver, vb_driver
from ccfindr_tpu_torch.parallel import _mh_worker

def crashing(module, name, after=2):
    orig = getattr(module, name)
    calls = [0]

    def patched(call, *args, **kwargs):
        def wrapped(*a, **k):
            calls[0] += 1
            if calls[0] > after:
                raise SystemExit(3)
            return call(*a, **k)
        return orig(wrapped, *args, **kwargs)

    setattr(module, name, patched)

crashing(vb_driver, "_chunked_vb")
crashing(ml_driver, "_chunked_ml")
_mh_worker.main(sys.argv[1:])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp_path, tag, nproc, prelude=None, pre_args=(), **kw):
    """Start the ``nproc`` workers of one group; returns (procs, outs)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    head = ([sys.executable, "-m", "ccfindr_tpu_torch.parallel._mh_worker"]
            if prelude is None else
            [sys.executable, "-c", prelude, *pre_args])
    args = []
    for k, v in kw.items():
        args += [f"--{k.replace('_', '-')}", str(v)]
    port = _free_port()
    procs, outs = [], []
    for pid in range(nproc):
        out = str(tmp_path / f"{tag}{pid}.npz")
        outs.append(out)
        procs.append(subprocess.Popen(
            head + ["--pid", str(pid), "--nproc", str(nproc), "--port",
                    str(port), "--out", out, "--device", "cpu", "--x64"]
            + args, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=REPO))
    return procs, outs


def _finish(started, expect_rc=0):
    """Wait for every started worker (all groups together, killed at
    TIMEOUT); each must exit with ``expect_rc``.  Returns the outputs,
    one list a group."""
    procs = [p for ps, _ in started for p in ps]
    logs = {}
    try:
        for p in procs:
            logs[p] = p.communicate(timeout=TIMEOUT)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        assert p.returncode == expect_rc, \
            f"worker exited {p.returncode}:\n{logs[p]}"
    if expect_rc != 0:
        return None
    return [[dict(np.load(o)) for o in outs] for _, outs in started]


# each case: (processes, prelude, the worker's arguments); the
# JAX-draws prelude reads the file the fixture writes
CASES = {
    "vb": (2, None, dict(ranks="2,3,4", nrun=3, itmax=300, seed=5)),
    "vb_jax": (2, None, dict(ranks="2,3,4", itmax=300, initializer="svd2",
                             backend="dense")),
    "vb_idle": (3, None, dict(ranks="2,3", nrun=1, itmax=150, seed=5)),
    "ml_idle": (3, None, dict(mode="ml", ranks="2", nrun=2, itmax=100,
                              seed=5)),
    "ml_split": (2, None, dict(mode="ml", ranks="3", nrun=8, itmax=120,
                               seed=7)),
    "ml_jax": (2, JAX_DRAWS_PRELUDE, dict(mode="ml", ranks="2,3,4", nrun=3,
                                          itmax=120, seed=5,
                                          backend="pallas")),
    "lone": (2, None, dict(ranks="2,3,4", nrun=1, itmax=300, seed=3,
                           backend="pallas")),
    "pallas2pass": (2, None, dict(ranks="2,3,4", nrun=3, itmax=200, seed=5,
                                  backend="pallas2pass")),
    "mesh": (2, None, dict(ranks="2,3", nrun=2, itmax=150, seed=2,
                           backend="pallas", cells=2)),
}
ML_JAX = dict(ranks=[2, 3, 4], nrun=3, seed=5)
WAVE = 3        # cases whose workers run at once


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's group and its single-process run, a few cases at a
    time: ``{case: (single, [process 0, ...])}``, or the AssertionError
    of a worker that failed."""
    tmp = tmp_path_factory.mktemp("mh")
    s = jax_problem(cf)
    n, m = s.counts_dense().shape
    nrank, nrun = len(ML_JAX["ranks"]), ML_JAX["nrun"]
    pairs = [(k, i) for k in range(nrank) for i in range(nrun)]
    w0, h0 = jax_draws(ML_JAX["seed"], 0, pairs, nrank, nrun, n, m,
                       max(ML_JAX["ranks"]), torch.float64, "cpu")
    draws = str(tmp / "draws.npz")
    np.savez(draws, w=w0.numpy(), h=h0.numpy())
    names, out = list(CASES), {}
    for w in range(0, len(names), WAVE):
        started = {}
        for name in names[w:w + WAVE]:
            nproc, prelude, kw = CASES[name]
            pre = (draws,) if prelude is not None else ()
            started[name] = [
                _start(tmp, f"{name}_one", 1, prelude, pre, **kw),
                _start(tmp, f"{name}_p", nproc, prelude, pre, **kw)]
        for name, groups in started.items():
            try:
                (single,), got = _finish(groups)
                out[name] = (single, got)
            except AssertionError as exc:
                out[name] = exc
    return out


def _case(runs, name):
    got = runs[name]
    if isinstance(got, AssertionError):
        raise got
    return got


def _assert_bit_identical(single, got):
    for g in got:
        assert set(g) == set(single)
        for key in single:
            if key in NOT_RESULT or key.startswith("launches_"):
                continue
            np.testing.assert_array_equal(g[key], single[key], err_msg=key)
            assert g[key].dtype == single[key].dtype, key
        np.testing.assert_array_equal(g["n_iter"],
                                      single["n_iter"][g["lanes"]])
    lanes = np.sort(np.concatenate([g["lanes"] for g in got]))
    np.testing.assert_array_equal(lanes, np.arange(len(single["n_iter"])))


def _assert_near_jax(ref, got, measures):
    """_assert_same_result's tolerances against a JAX run."""
    for g in got:
        assert [int(r) for r in g["ranks"]] == ref.ranks
        for col, want in measures.items():
            np.testing.assert_allclose(g[col], ref.measure[want], rtol=1e-8,
                                       err_msg=col)
        for k, r in enumerate(ref.ranks):
            for f, fs in (("basis", ref.basis), ("coeff", ref.coeff)):
                want = np.asarray(fs[k])
                np.testing.assert_allclose(
                    g[f"{f}_{r}"], want, rtol=0,
                    atol=1e-6 * np.abs(want).max(), err_msg=f)


def test_toy_problem_is_the_jax_one():
    import ccfindr_tpu_torch as ct

    np.testing.assert_array_equal(
        _mh_worker.build_problem(ct).counts_dense(),
        jax_problem(cf).counts_dense())


def test_two_process_vb_matches_single_process(runs):
    single, got = _case(runs, "vb")
    _assert_bit_identical(single, got)
    assert [len(g["lanes"]) for g in got] == [5, 4]


def test_two_process_vb_matches_jax(runs):
    """svd2 starts (computed for the owned ranks only): 3 lanes over 2
    processes, so process 1 runs a lone lane."""
    single, got = _case(runs, "vb_jax")
    _assert_bit_identical(single, got)
    ref = cf.vb_factorize(jax_problem(cf), ranks=[2, 3, 4], verbose=0,
                          Itmax=300, initializer="svd2", backend="dense")
    _assert_near_jax(ref, got, {c: c for c in ("lml", "aw", "bw", "ah",
                                               "bh")})


def test_three_process_idle_host(runs):
    """Two lanes over three processes: the idle one joins every
    exchange and returns the single-process result."""
    single, got = _case(runs, "vb_idle")
    _assert_bit_identical(single, got)
    assert len(got[2]["lanes"]) == 0


def test_three_process_ml_idle_host(runs):
    single, got = _case(runs, "ml_idle")
    _assert_bit_identical(single, got)
    assert len(got[2]["lanes"]) == 0


def test_two_process_ml_restart_split(runs):
    """One rank's 8 restarts split 4/4: the cluster ids all-gather and
    both processes build the single process's consensus."""
    single, got = _case(runs, "ml_split")
    _assert_bit_identical(single, got)
    assert [len(g["lanes"]) for g in got] == [4, 4]


def test_two_process_ml_matches_jax(runs):
    """ranks 2, 3, 4 over 2 processes, every lane started from JAX's
    draws, against the port's one process and JAX's."""
    single, got = _case(runs, "ml_jax")
    _assert_bit_identical(single, got)
    ref = cf.factorize(jax_problem(cf), verbose=0, Itmax=120,
                       backend="pallas", **ML_JAX)
    _assert_near_jax(ref, got, {c: c for c in ("likelihood", "dispersion",
                                               "cophenetic")})


def test_lone_lane(runs):
    """Three lanes over two processes: process 1's share is one lane of
    a grid of three, run as a batch of one."""
    single, got = _case(runs, "lone")
    _assert_bit_identical(single, got)
    assert [len(g["lanes"]) for g in got] == [2, 1]


def test_pallas2pass(runs):
    _assert_bit_identical(*_case(runs, "pallas2pass"))


def test_mesh_per_process(runs):
    """Each process lays its share over its own cells=2 mesh."""
    _assert_bit_identical(*_case(runs, "mesh"))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """VB and ML over 2 processes, chunked by 5 sweeps with files: both
    processes crash in their third chunk, leaving their own chunk files,
    and a rerun resumes them; beside them the uninterrupted single
    process.  ``{mode: (files left by the crash, single, [processes],
    files left after the resume)}``."""
    tmp = tmp_path_factory.mktemp("ck")
    kws = {mode: dict(mode=mode, ranks="2,3", nrun=2, itmax=200, seed=4,
                      backend="pallas", checkpoint_every=5,
                      checkpoint_dir=tmp / mode) for mode in ("vb", "ml")}
    ones = {mode: _start(tmp, f"{mode}_one", 1,
                         **dict(kw, checkpoint_dir=tmp / f"{mode}_one"))
            for mode, kw in kws.items()}
    _finish([_start(tmp, f"{mode}_crash", 2, CRASH_PRELUDE, **kw)
             for mode, kw in kws.items()], expect_rc=3)
    left = {mode: sorted(os.listdir(tmp / mode)) for mode in kws}
    groups = {mode: _start(tmp, f"{mode}_p", 2, **kw)
              for mode, kw in kws.items()}
    out = {}
    for mode in kws:
        (single,), got = _finish([ones[mode], groups[mode]])
        out[mode] = (left[mode], single, got, os.listdir(tmp / mode))
    return out


@pytest.mark.parametrize("mode", ["vb", "ml"])
def test_checkpoint_resume(resumed, mode):
    """The crash leaves one chunk file a process (``_p{pid}``); the
    resumed processes return the uninterrupted single-process run bit
    for bit and remove their files."""
    left, single, got, after = resumed[mode]
    name = "vb_sweeps_batch" if mode == "vb" else "ml_sweeps_s0"
    assert left == [f"{name}_p0.npz", f"{name}_p1.npz"]
    _assert_bit_identical(single, got)
    assert after == []


def test_share_pins_the_whole_grid(monkeypatch):
    """A process pins the chunks its kernels would take for the whole
    grid, not its share: P1's on 'pallas2pass', E1's on the gene-major
    route (two threads standing for the processes)."""
    x = cf.simulate_whx(nrow=24, ncol=36, rank=3, seed=77)["x"]
    seen = []
    # the lane count's position in each one's arguments
    for name, pos in (("pass2_chunk", 3), ("fused_chunk", 2)):
        real = getattr(tvbk, name)

        def spy(*a, real=real, pos=pos, **k):
            seen.append(a[pos])
            return real(*a, **k)

        monkeypatch.setattr(tvbk, name, spy)
    import ccfindr_tpu_torch as ct

    kw = dict(ranks=[2, 3, 4], nrun=3, Itmax=30, seed=5, verbose=0,
              device="cpu", _process_count=2)
    threads_as_processes(2, lambda p: ct.vb_factorize(
        x, backend="pallas2pass", _process_id=p, **kw), tsched)
    assert len(seen) >= 2 and set(seen) == {9}
    seen.clear()
    monkeypatch.setattr(vd, "_fused_layout", lambda *a, **k: "gm")
    threads_as_processes(2, lambda p: ct.vb_factorize(
        x, backend="pallas", _process_id=p, **kw), tsched)
    assert len(seen) >= 2 and set(seen) == {9}
