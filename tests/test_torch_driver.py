"""The port's slice end to end: vb_factorize against the JAX package,
the bundled pbmc_sim workflow on the CPU, the copied host modules
against their JAX twins, and the rule that the port never imports JAX.

Tolerances: measure tables 1e-8 relative, basis/coeff 1e-6 (float64,
deterministic svd2 init, so no random stream is shared).  The bundled
workflow runs in float32, the card's working type, which halves its CPU
time against float64.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu_torch.ops import rsvd as trsvd
from ccfindr_tpu_torch.data import pbmc_sim_dir
from ccfindr_tpu.parallel import schedule as jsched
from ccfindr_tpu_torch.parallel import schedule as tsched
from test_torch_schedule import threads_as_processes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small():
    return cf.simulate_whx(nrow=40, ncol=60, rank=3, seed=31)["x"]


def _assert_same_result(a, b, mrtol=1e-8, frtol=1e-6):
    assert list(a.measure["rank"]) == list(b.measure["rank"])
    for col in ("lml", "aw", "bw", "ah", "bh"):
        np.testing.assert_allclose(b.measure[col], a.measure[col],
                                   rtol=mrtol, err_msg=col)
    np.testing.assert_array_equal(b.measure["nunif"], a.measure["nunif"])
    for k in range(len(a.ranks)):
        for f in ("basis", "coeff"):
            want = getattr(a, f)[k]
            got = getattr(b, f)[k]
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=frtol * np.abs(want).max(),
                                       err_msg=f)


@pytest.mark.parametrize("backend", ["pallas", "dense_fused", "dense"])
def test_vb_factorize_matches_jax(small, backend):
    kw = dict(ranks=[2, 3, 4], initializer="svd2", backend=backend,
              Itmax=300, verbose=0)
    a = cf.vb_factorize(cf.SCSet(count=small), **kw)
    b = ct.vb_factorize(ct.SCSet(count=small), device="cpu", **kw)
    _assert_same_result(a, b)
    assert b.basis[0].dtype == np.float64


def test_sequential_rank_loop_matches_jax(small):
    kw = dict(ranks=[2, 3], initializer="svd", backend="dense",
              Itmax=200, verbose=0, batch_ranks=False)
    a = cf.vb_factorize(cf.SCSet(count=small), **kw)
    b = ct.vb_factorize(ct.SCSet(count=small), device="cpu", **kw)
    _assert_same_result(a, b)


def test_storage_dtype_auto_is_exact(small):
    kw = dict(ranks=[3], nrun=2, Itmax=100, seed=3, backend="pallas",
              verbose=0, device="cpu")
    a = ct.vb_factorize(small, storage_dtype=None, **kw)
    b = ct.vb_factorize(small, **kw)         # int8 X
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    np.testing.assert_array_equal(a.basis[0], b.basis[0])


def test_random_init_is_seeded(small):
    kw = dict(ranks=[2, 3], nrun=2, Itmax=60, backend="pallas",
              verbose=0, device="cpu")
    a = ct.vb_factorize(small, seed=5, **kw)
    b = ct.vb_factorize(small, seed=5, **kw)
    c = ct.vb_factorize(small, seed=6, **kw)
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    assert not np.array_equal(a.measure["lml"], c.measure["lml"])


@pytest.fixture(scope="module")
def pbmc():
    s = ct.read_10x(pbmc_sim_dir())
    s = ct.filter_cells(s, umi_min=700, umi_max=8000, plot=False)
    s = ct.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                        plot=False, verbose=False)
    return ct.vb_factorize(s, ranks=list(range(2, 9)), nrun=3,
                           verbose=0, Itmax=3000, seed=0,
                           backend="pallas", device="cpu",
                           dtype=torch.float32)


def test_pbmc_optimal_rank_is_5(pbmc):
    assert ct.optimal_rank(pbmc)["ropt"] == 5


def test_pbmc_clusters_and_tree(pbmc):
    cid = ct.cluster_id(pbmc, rank=5)
    assert set(cid.unique()) == {1, 2, 3, 4, 5}
    nwk = ct.newick(ct.build_tree(pbmc, rmax=5))
    for tip in ("5.1", "5.2", "5.3", "5.4", "5.5"):
        assert tip in nwk


def test_pbmc_evidence_profile(pbmc):
    me = pbmc.measure
    ranks = list(me["rank"])
    assert ranks[0] == 2 and 6 in ranks
    assert np.isfinite(me["lml"]).all()
    lml = me.set_index("rank")["lml"]
    assert lml[5] > lml[2]
    rec = pbmc.metadata["timings"][0]
    assert rec["name"] == "vb_rank_batch" and rec["total_sweeps"] > 0


def test_pbmc_sim_dir_is_the_reference_data():
    from ccfindr_tpu.data import pbmc_sim_dir as jdir

    assert os.path.samefile(pbmc_sim_dir(), jdir())


@pytest.fixture(scope="module")
def both_read():
    return cf.read_10x(pbmc_sim_dir()), ct.read_10x(pbmc_sim_dir())


def _assert_same_set(a, b):
    assert (a.counts != b.counts).nnz == 0
    assert a.counts.dtype == b.counts.dtype
    assert a.row_data.equals(b.row_data)
    assert a.col_data.equals(b.col_data)


def test_read_10x_matches_jax(both_read):
    _assert_same_set(*both_read)
    a = cf.read_mtx(os.path.join(pbmc_sim_dir(), "matrix.mtx"))
    b = ct.read_mtx(os.path.join(pbmc_sim_dir(), "matrix.mtx"))
    assert (a != b).nnz == 0


def test_filters_match_jax(both_read):
    a, b = both_read
    fa = cf.filter_cells(a, umi_min=700, umi_max=8000, plot=False)
    fb = ct.filter_cells(b, umi_min=700, umi_max=8000, plot=False)
    _assert_same_set(fa, fb)
    ga = cf.filter_genes(fa, vmr_min=1.2, min_cells_expressed=50,
                         plot=False, verbose=False)
    gb = ct.filter_genes(fb, vmr_min=1.2, min_cells_expressed=50,
                         plot=False, verbose=False)
    _assert_same_set(ga, gb)


def test_selection_and_tree_match_jax(pbmc):
    """optimal_rank on one measure table, cluster_id and newick on one
    set of factors, through both packages' copies."""
    a = cf.SCSet(count=pbmc.counts, row_data=pbmc.row_data,
                 col_data=pbmc.col_data, remove_zeros=False)
    for f in ("ranks", "basis", "coeff", "dbasis", "dcoeff", "measure"):
        setattr(a, f, getattr(pbmc, f))
    assert cf.optimal_rank(a) == ct.optimal_rank(pbmc)
    xr = pbmc.measure["rank"].to_numpy(float)
    yr = pbmc.measure["lml"].to_numpy(float)
    for u, v in zip(cf.smooth_spline_df(xr, yr, 4),
                    ct.smooth_spline_df(xr, yr, 4)):
        np.testing.assert_array_equal(u, v)
    for rank in pbmc.ranks:
        assert cf.cluster_id(a, rank=rank).equals(
            ct.cluster_id(pbmc, rank=rank))
    assert cf.newick(cf.build_tree(a, rmax=5)) == ct.newick(
        ct.build_tree(pbmc, rmax=5))


def test_port_never_imports_jax():
    code = ("import sys, numpy as np, ccfindr_tpu_torch as ct\n"
            "from ccfindr_tpu_torch.data import pbmc_sim_dir\n"
            "x = np.random.default_rng(0).poisson(3.0, (12, 15))\n"
            "s = ct.vb_factorize(x, ranks=[2, 3], Itmax=20, verbose=0,\n"
            "                    backend='pallas', device='cpu')\n"
            "f = ct.factorize(x, ranks=[2, 3], nrun=2, Itmax=20, verbose=0,\n"
            "                 backend='pallas', device='cpu')\n"
            "t = ct.vb_factorize(x, ranks=[2], Itmax=20, verbose=0,\n"
            "                    backend='sparse', device='cpu')\n"
            "g = ct.factorize(x, ranks=[2], nrun=2, Itmax=20, verbose=0,\n"
            "                 backend='sparse', device='cpu')\n"
            "ct.meta_gene_cv(f, rank=2)\n"
            "from ccfindr_tpu_torch.ops.kernels import sol_sharded\n"
            "from ccfindr_tpu_torch.parallel import mesh, sharded\n"
            "u = ct.vb_factorize(x, ranks=[2], Itmax=20, verbose=0,\n"
            "                    backend='pallas', device='cpu',\n"
            "                    mesh=ct.make_mesh(runs=2, cells=2,\n"
            "                                      devices=['cpu'] * 4))\n"
            "from ccfindr_tpu_torch.ops.kernels import epilogue, vb_kernels\n"
            "import torch\n"
            "st = epilogue.vb_run_epi(torch.tensor(x, dtype=torch.int16),\n"
            "    ct.ops.vb.VBState(\n"
            "    *(torch.stack([f]) for f in ct.ops.vb.vb_init_random(\n"
            "        torch.Generator(), 12, 15, 2,\n"
            "        ct.ops.vb.Hyper(1.0, 1.0, 1.0, 1.0), torch.float64,\n"
            "        device='cpu'))),\n"
            "    ct.ops.vb.Hyper(*(torch.ones(1).double(),) * 4),\n"
            "    itmax=5, layout='gm')\n"
            "ct.read_10x(pbmc_sim_dir())\n"
            "from ccfindr_tpu_torch.parallel import schedule, _mh_worker\n"
            "_mh_worker.build_problem(ct)\n"
            "assert len(s.measure) >= 1 and len(f.measure) == 2\n"
            "assert len(t.measure) == 1 and len(g.measure) == 1\n"
            "assert len(u.measure) == 1\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("clean")


def test_cuda_device_without_card_raises(small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct.vb_factorize(small, ranks=[2], verbose=0)


def test_dtype_follows_device(small):
    s = ct.vb_factorize(small, ranks=[2], Itmax=5, verbose=0,
                        device="cpu", backend="pallas")
    assert s.basis[0].dtype == np.float64


@pytest.mark.parametrize("kw,item", [
    (dict(distributed=dict(num_processes=2)), "A7c"),
    (dict(_process_count=2), "A7c"),
    (dict(backend="sparse", sparse_layout="ell"), "A6"),
])
def test_options_not_ported_raise(small, kw, item):
    """``sparse_layout='ell'`` (ROADMAP A6) raises.  The A7c cases raised
    until several processes were ported: a ``distributed`` dict whose
    group cannot form (no coordinator address) raises and never runs as
    one process, and ``_process_count=2`` splits the (rank, run) grid
    over two processes (threads standing for them, both packages'
    all-gather seams patched alike): each process returns the JAX
    driver's two-process result at _assert_same_result's tolerances,
    and the port's one-process run bit for bit."""
    if item == "A6":
        with pytest.raises(NotImplementedError, match=item):
            ct.vb_factorize(small, ranks=[2], verbose=0, device="cpu", **kw)
        return
    if "distributed" in kw:
        with pytest.raises(ValueError, match="coordinator_address"):
            ct.vb_factorize(small, ranks=[2], verbose=0, device="cpu", **kw)
        return
    run = dict(ranks=[2, 3, 4], initializer="svd2", backend="pallas",
               Itmax=300, verbose=0, **kw)
    want = threads_as_processes(2, lambda p: cf.vb_factorize(
        cf.SCSet(count=small), _process_id=p, **run), jsched)
    got = threads_as_processes(2, lambda p: ct.vb_factorize(
        ct.SCSet(count=small), device="cpu", _process_id=p, **run), tsched)
    one = ct.vb_factorize(ct.SCSet(count=small), device="cpu",
                          **dict(run, _process_count=1))
    for a, b in zip(want, got):
        _assert_same_result(a, b)
        _assert_same_result(one, b, mrtol=0, frtol=0)


def _jax_omega(m, k, dtype, seed, device):
    """JAX's randomized-SVD test matrix, handed to the port."""
    om = jax.random.normal(jax.random.PRNGKey(seed), (m, k), jnp.float64)
    return torch.as_tensor(np.array(om), dtype=dtype, device=device)


@pytest.mark.parametrize("option", ["gene_sharded_pallas", "randomized_svd"])
def test_options_once_raising_match_jax(small, monkeypatch, option):
    """Two options that raised before their port: 'pallas' over a
    gene-sharded mesh (E1 a block, ROADMAP A7b) and
    svd_method='randomized' (A8, with JAX's test matrix), each against
    the JAX driver's run at _assert_same_result's tolerances."""
    if option == "gene_sharded_pallas":
        kw = dict(backend="pallas", initializer="svd2")
        jkw = dict(mesh=cf.make_mesh(genes=2, cells=1,
                                     devices=jax.devices()[:2]))
        tkw = dict(mesh=ct.make_mesh(genes=2, cells=1, devices=["cpu"] * 2))
    else:
        monkeypatch.setattr(trsvd, "_draw_omega", _jax_omega)
        kw = dict(backend="dense", initializer="svd2",
                  svd_method="randomized")
        jkw = tkw = {}
    kw.update(ranks=[2, 3], Itmax=200, verbose=0)
    # an even gene count: the JAX driver pads an svd2 start to a ragged
    # mesh twice (ROADMAP C), so the mesh case takes extents it divides
    x = small[:small.shape[0] // 2 * 2]
    assert (x.sum(axis=0) > 0).all()
    a = cf.vb_factorize(cf.SCSet(count=x), **kw, **jkw)
    b = ct.vb_factorize(ct.SCSet(count=x), device="cpu", **kw, **tkw)
    _assert_same_result(a, b)


def test_elbo_every_needs_pallas(small):
    with pytest.raises(ValueError, match="elbo_every"):
        ct.vb_factorize(small, ranks=[2], verbose=0, device="cpu",
                        backend="dense", elbo_every=3)
