"""examples/atlas_demo_torch.py, the 100k-cell atlas workflow on the
port, at a tiny size on the CPU: its ``simulate_atlas`` against the
frozen examples/atlas_demo.py's bit for bit, its ``run`` (QC, the
batched VB scan on ``backend='pallas'``, optimal_rank, tree, metagenes)
against the same steps on ``ccfindr_tpu`` in float64 (measure tables
1e-8 relative, basis/coeff 1e-6 of their largest entry, as
tests/test_torch_driver.py holds the drivers; the same ropt, cluster
ids, Newick string and metagene lists), and the script's run importing
no JAX."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ccfindr_tpu as cf
from test_torch_driver import _assert_same_result

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "atlas_demo_torch.py")
JAX_SCRIPT = os.path.join(REPO, "examples", "atlas_demo.py")
# the tiny planted atlas: genes, cells, planted rank, scanned ranks
TINY = dict(n_genes=512, n_cells=1024, rank=4, base_cells=1024, seed=0)
RANKS = [2, 3, 4, 5, 6]
ITMAX = 300


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def demo():
    return _load(SCRIPT, "atlas_demo_torch")


@pytest.mark.parametrize("kw", [
    TINY,
    dict(n_genes=2050, n_cells=3000, base_cells=1000, seed=3),
    dict(n_genes=300, n_cells=4096, rank=7, base_cells=1024, seed=1),
], ids=["tiny", "ragged", "tiled"])
def test_simulate_atlas_is_jax_s(demo, kw):
    jdemo = _load(JAX_SCRIPT, "atlas_demo")    # imports jax only in main
    x, types = demo.simulate_atlas(**kw)
    xj, tj = jdemo.simulate_atlas(**kw)
    assert x.dtype == xj.dtype == np.int8
    assert np.array_equal(x, xj)
    assert types.dtype == tj.dtype and np.array_equal(types, tj)
    assert demo.PLANT_RANK == jdemo.PLANT_RANK


@pytest.fixture(scope="module")
def both(demo):
    x, types = demo.simulate_atlas(**TINY)
    got = demo.run(x, types, RANKS, 1, ITMAX, "cpu", initializer="svd2")
    s = cf.SCSet(count=x)
    s = cf.filter_cells(s, umi_min=1, plot=False)
    s = cf.filter_genes(s, vmr_min=1.05, min_cells_expressed=50,
                        plot=False, verbose=False)
    res = cf.vb_factorize(s, ranks=RANKS, nrun=1, verbose=0, Itmax=ITMAX,
                          seed=0, backend="pallas", initializer="svd2")
    opt = cf.optimal_rank(res)
    want = dict(res=res, opt=opt,
                newick=cf.newick(cf.build_tree(res, rmax=opt["ropt"])),
                meta=cf.meta_genes(res, rank=opt["ropt"],
                                   max_per_cluster=10))
    return got, want


def test_run_matches_jax_scan(both):
    got, want = both
    assert got["res"].basis[0].dtype == np.float64
    assert got["n_cells"] == want["res"].n_cells
    _assert_same_result(want["res"], got["res"])


def test_run_matches_jax_selection_tree_and_metagenes(both):
    got, want = both
    assert got["opt"]["ropt"] == want["opt"]["ropt"]
    assert got["opt"]["type"] == want["opt"]["type"]
    assert got["newick"] == want["newick"]
    assert len(got["meta"]) == len(want["meta"])
    for a, b in zip(got["meta"], want["meta"]):
        assert list(a) == list(b)
    import ccfindr_tpu_torch as ct
    for rank in RANKS:
        np.testing.assert_array_equal(
            ct.cluster_id(got["res"], rank=rank).to_numpy(),
            cf.cluster_id(want["res"], rank=rank).to_numpy())
    assert set(got["phases"]) >= {"qc", "rank_scan", "optimal_rank",
                                  "tree", "metagenes"}


def test_run_imports_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('d', {SCRIPT!r})\n"
        "d = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(d)\n"
        f"x, types = d.simulate_atlas(**{TINY!r})\n"
        "out = d.run(x, types, [2, 3, 4], 1, 20, 'cpu',\n"
        "            initializer='svd2')\n"
        "assert out['res'].ranks == [2, 3, 4], out['res'].ranks\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'ccfindr_tpu' not in sys.modules\n"
        "print('clean')\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("clean")
