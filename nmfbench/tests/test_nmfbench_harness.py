"""The harness end to end on the CPU at a small size: a sound run is
correct, each fault the cells can have under the timed path makes it
not correct, it loads neither JAX nor the JAX package, and without a
card it prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, WORKLOADS, small
from nmfbench import faults

SEED = 2 ** 31 + 12345


def _run(workload, trace=0):
    from nmfbench import harness

    return harness.run(workload, SEED, 0.0, trace, device="cpu",
                       cell_override=small(workload), log=lambda s: None)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"lane_sweeps_per_s", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_under_the_timed_path_is_not_correct(monkeypatch, fault,
                                                    workload):
    from nmfbench import harness

    faults.FAULTS[fault](monkeypatch.setattr,
                         harness.cell(workload)[3]["backend"])
    r = _run(workload)
    assert r["correct"] is False, r["checks"]
    assert r["failed"] >= 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_the_programs_place_is_not_correct(monkeypatch,
                                                      workload):
    faults.control(monkeypatch.setattr, small(workload), SEED, "cpu")
    r = _run(workload)
    assert r["correct"] is False, r["checks"]
    assert r["failed"] == 1


def test_fault_runner_undoes_its_patches(monkeypatch, capsys):
    from ccfindr_tpu_torch.ops.kernels import sol
    from nmfbench import harness

    real = sol.sol_sweep
    cut = small("pbmc68k.vb_pallas")
    monkeypatch.setattr(harness, "cell", lambda w: cut)
    run = harness.run
    monkeypatch.setattr(harness, "run", lambda *a, **kw: run(
        *a, **kw, cell_override=cut))
    rc = faults.main(["--workload", "pbmc68k.vb_pallas", "--seeds", "5",
                      "--faults", "control", "unchanged", "--device",
                      "cpu"])
    lines = [json.loads(v) for v in
             capsys.readouterr().out.strip().splitlines()]
    assert rc == 0 and sol.sol_sweep is real
    assert [(v["fault"], v["correct"]) for v in lines[:2]] == [
        ("control", False), ("unchanged", False)]
    assert lines[-1]["every_run_not_correct"] is True


def test_traced_run_reports_what_it_can_read():
    r = _run("pbmc68k.vb_pallas", trace=1)
    assert r["correct"] is True
    # two traced scans, then an untraced one for the driver's span
    assert r["attempted"] == 3
    # no device events and no peaks on the CPU: only the readers of the
    # driver's span report
    assert set(r["metrics"]) == {"driver_setup_share",
                                 "loop_lane_sweeps_per_s"}


def _py(args, cwd, env_extra=None, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    p = _py(["-m", "nmfbench.run", "--workload", "pbmc68k.vb_pallas",
             "--seed", str(SEED), "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode == 2, p.stderr
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "nmfbench", tmp_path / "nmfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _py(["-m", "nmfbench.run", "--workload", "pbmc68k.vb_pallas",
             "--seed", "1", "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'nmfbench/tests')\n"
        "from conftest import small\n"
        "from nmfbench import harness\n"
        "r = harness.run('pbmc68k.vb_pallas', 3, 0.0, 1, device='cpu',"
        " cell_override=small('pbmc68k.vb_pallas'), log=lambda s: None)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(dict(correct=r['correct'], tops=tops,"
        " barred=harness.barred_modules())))\n")
    p = _py(["-c", code], ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert "ccfindr_tpu_torch" in out["tops"]
    assert not set(out["tops"]) & {"jax", "jaxlib", "flax", "ccfindr_tpu"}
    assert out["barred"] == []


def test_barred_names_are_compared_whole(monkeypatch):
    from nmfbench import harness

    monkeypatch.setitem(sys.modules, "ccfindr_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.barred_modules() == []
    monkeypatch.setitem(sys.modules, "ccfindr_tpu.ops", sys)
    assert harness.barred_modules() == ["ccfindr_tpu"]


def test_scan_seeds_differ_and_repeat():
    from nmfbench import harness

    big = 2 ** 33 + 5
    s = [harness.scan_seed(big, i) for i in range(4)]
    assert len(set(s)) == 4 and all(0 <= v < 2 ** 63 for v in s)
    assert s == [harness.scan_seed(big, i) for i in range(4)]


@pytest.mark.cuda
def test_small_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from nmfbench import harness

    result = harness.run("pbmc68k.vb_pallas", SEED, 0.0, 1, device="cuda",
                         cell_override=small("pbmc68k.vb_pallas", n=512,
                                             m=2048),
                         log=lambda s: None)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["busy_s"] > 0
    for name in ("kernel_roofline", "step_mfu", "device_idle_share"):
        assert 0 < result["metrics"][name]["value"] < 100, name
