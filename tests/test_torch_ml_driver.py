"""The port's ML path end to end: factorize against the JAX package, the
bundled workflow (QC -> factorize -> clusters -> metagenes -> GSEA) on
the CPU, and the copied interpret/gsea modules against their twins.

The JAX package draws its initial factors with jax.random; the parity
tests hand the same draws to the port through its init hook
(drivers.ml_driver.initial_factors), so both packages start every lane
from the same factors.  Tolerances (float64): measure-table likelihood
1e-9 relative, dispersion and cophenetic 1e-12, basis/coeff 1e-8.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.ops import ml as jml
from ccfindr_tpu_torch.data import pbmc_sim_dir
from ccfindr_tpu_torch.drivers import ml_driver
from ccfindr_tpu_torch.ops.ml import ml_state_from_numpy
from ccfindr_tpu.parallel import schedule as jsched
from ccfindr_tpu_torch.parallel import schedule as tsched
from test_torch_schedule import threads_as_processes

torch.set_num_threads(2)

MARKERS = {
    "B cell": ["CD74", "IG", "HLA", "MS4A1", "CD79A"],
    "CD8+ T": ["CD8A", "CD8B", "GZMK", "CCR7", "LTB"],
    "CD4+ T": ["CD3D", "CD3E", "IL7R", "LEF1"],
    "NK": ["GNLY", "NKG7", "GZMA", "GZMH"],
    "Macrophage": ["S100A8", "S100A9", "CD14", "LYZ", "CFD"],
}


def jax_draws(seed, ismpl, pairs, nrank, nrun, n, m, rank, dtype, device):
    """The JAX driver's initial factors for these lanes
    (ccfindr_tpu/drivers/ml_driver.py: fold_in(key, ismpl*nrank + k),
    split nrun, ml_init at the batch's rank)."""
    key0 = jax.random.PRNGKey(seed)
    keys = jnp.stack([
        jax.random.split(jax.random.fold_in(key0, ismpl * nrank + k),
                         nrun)[i] for k, i in pairs])
    w0, h0 = jax.vmap(lambda kk: jml.ml_init(kk, n, m, rank,
                                             jnp.float64))(keys)
    return ml_state_from_numpy((np.asarray(w0), np.asarray(h0)),
                               device=device, dtype=dtype)


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(ml_driver, "initial_factors", jax_draws)


@pytest.fixture(scope="module")
def small():
    return cf.simulate_whx(nrow=40, ncol=60, rank=3, seed=31)["x"]


def _assert_same_result(a, b):
    pd.testing.assert_index_equal(b.measure.columns, a.measure.columns)
    np.testing.assert_array_equal(b.measure["rank"], a.measure["rank"])
    np.testing.assert_allclose(b.measure["likelihood"],
                               a.measure["likelihood"], rtol=1e-9)
    for col in a.measure.columns.drop(["rank", "likelihood"]):
        np.testing.assert_allclose(b.measure[col], a.measure[col],
                                   rtol=0, atol=1e-12, err_msg=col)
    for k in range(len(a.ranks)):
        for f in ("basis", "coeff"):
            want = getattr(a, f)[k]
            np.testing.assert_allclose(getattr(b, f)[k], want, rtol=0,
                                       atol=1e-8 * np.abs(want).max(),
                                       err_msg=f)


@pytest.mark.parametrize("backend,batch_ranks", [
    ("dense", True), ("dense", False), ("dense_fused", True),
    ("dense_fused", False), ("pallas", True), ("pallas", False),
])
def test_factorize_matches_jax(small, jax_init, backend, batch_ranks):
    kw = dict(ranks=[2, 3, 4], nrun=3, Itmax=200, Tol=1e-6, seed=4,
              backend=backend, batch_ranks=batch_ranks, verbose=0)
    a = cf.factorize(cf.SCSet(count=small), **kw)
    b = ct.factorize(ct.SCSet(count=small), device="cpu", **kw)
    _assert_same_result(a, b)
    assert b.basis[0].dtype == np.float64
    recs = b.metadata["timings"]
    runs = [r for r in recs if r["name"].startswith("ml_rank")]
    assert [len(r["n_iter"]) for r in runs] == ([9] if batch_ranks
                                                else [3, 3, 3])
    assert [r["name"] for r in recs].count("ml_consensus") == 3


@pytest.mark.parametrize("kw", [
    dict(randomize=True, nsmpl=2, backend="dense_fused"),
    dict(prior=True, gamma_a=1.5, gamma_b=2.0, backend="pallas"),
    dict(criterion="connectivity", ncnn_step=15, backend="pallas"),
    dict(cophenetic_max_cells=40, cophenetic_nsub=2, backend="dense"),
])
def test_factorize_options_match_jax(small, jax_init, kw):
    kw = dict(ranks=[2, 3], nrun=2, Itmax=150, seed=2, verbose=0, **kw)
    a = cf.factorize(cf.SCSet(count=small), **kw)
    b = ct.factorize(ct.SCSet(count=small), device="cpu", **kw)
    _assert_same_result(a, b)
    if "cophenetic_nsub" in kw:
        np.testing.assert_allclose(b.metadata["cophenetic_se"],
                                   a.metadata["cophenetic_se"], atol=1e-12)


def test_randomized_table_and_connectivity(small):
    """Randomized replicates add standard-error columns; the last
    sample's mean connectivity is kept on request."""
    kw = dict(ranks=[2], nrun=1, Itmax=5, randomize=True, nsmpl=2, seed=9,
              verbose=0, store_connectivity=True)
    b = ct.factorize(small, device="cpu", **kw)
    assert list(b.measure.columns) == ["rank", "likelihood", "r_se",
                                       "dispersion", "d_se", "cophenetic",
                                       "c_se"]
    m = small.shape[1]
    assert b.metadata["nrun"] == 1
    assert len(b.metadata["connectivity"]) == m * (m - 1) // 2


def test_storage_dtype_auto_is_exact(small):
    kw = dict(ranks=[3], nrun=2, Itmax=100, seed=3, backend="pallas",
              verbose=0, device="cpu")
    a = ct.factorize(small, storage_dtype=None, **kw)
    b = ct.factorize(small, **kw)         # int8 X
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])
    np.testing.assert_array_equal(a.basis[0], b.basis[0])


def test_random_init_is_seeded(small):
    kw = dict(ranks=[2, 3], nrun=2, Itmax=60, backend="pallas",
              verbose=0, device="cpu")
    a = ct.factorize(small, seed=5, **kw)
    b = ct.factorize(small, seed=5, **kw)
    c = ct.factorize(small, seed=6, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])
    assert not np.array_equal(a.measure["likelihood"],
                              c.measure["likelihood"])


@pytest.fixture(scope="module")
def pbmc_filtered():
    s = ct.read_10x(pbmc_sim_dir())
    s = ct.filter_cells(s, umi_min=700, umi_max=8000, plot=False)
    return ct.filter_genes(s, vmr_min=1.2, min_cells_expressed=50,
                           plot=False, verbose=False)


def bundled_ml(s, seed):
    """docs/workflow.md step 3 on the pallas backend."""
    return ct.factorize(s, ranks=[4, 5, 6], nrun=4, Itmax=400, Tol=1e-4,
                        seed=seed, backend="pallas", device="cpu",
                        verbose=0)


@pytest.fixture(scope="module")
def pbmc_ml(pbmc_filtered):
    return bundled_ml(pbmc_filtered, 0)


def concordance(s, cid):
    """Best one-to-one agreement of cluster ids with the planted labels
    of the bundled data (tests/test_integration_workflow.py)."""
    from scipy.optimize import linear_sum_assignment

    d = pbmc_sim_dir()
    labels = np.loadtxt(os.path.join(d, "labels.tsv"), dtype=int)
    all_bc = open(os.path.join(d, "barcodes.tsv")).read().split()
    lab = labels[[all_bc.index(b) for b in s.col_data.index]]
    cm = np.zeros((5, 5))
    for c, lb in zip(np.asarray(cid) - 1, lab):
        cm[c, lb] += 1
    r, c = linear_sum_assignment(-cm)
    return cm[r, c].sum() / len(lab)


def test_bundled_ml_workflow(pbmc_filtered, pbmc_ml):
    """The card's float32 gates (chip_smoke.py phase 6), at float64.

    Rank 5's dispersion over nrun=4 restarts depends on the draws: one
    restart stuck in another optimum gives ~0.93 (the JAX package's
    seeds 3 and 4, this package's seed 0).  So it must be >= 0.99 and
    the largest of ranks 4-6 for two of the seeds 0, 1, 2; the best
    restart's clusters are gated on the documented seed 0."""
    assert pbmc_ml.n_genes == 684 and pbmc_ml.n_cells == 447
    passed = 0
    for seed in (0, 1, 2):
        f = pbmc_ml if seed == 0 else bundled_ml(pbmc_filtered, seed)
        assert np.isfinite(f.measure.drop(columns="rank").to_numpy()).all()
        disp = f.measure.set_index("rank")["dispersion"]
        passed += bool(disp[5] >= 0.99 and disp[5] == disp.max())
    assert passed >= 2
    cid = ct.cluster_id(pbmc_ml, rank=5)
    assert cid.nunique() == 5
    assert concordance(pbmc_ml, cid) >= 0.95


def test_bundled_ml_celltypes(pbmc_ml):
    genes = pbmc_ml.row_data.iloc[:, 1].to_numpy()
    es = ct.assign_celltype(pbmc_ml, rank=5, gset=MARKERS,
                            gene_names=genes, grp_prefix=("IG", "HLA"))
    assert es.shape == (5, 5)
    assert es.idxmax(axis=0).nunique() == 5


def _as_jax_set(s):
    a = cf.SCSet(count=s.counts, row_data=s.row_data, col_data=s.col_data,
                 remove_zeros=False)
    for f in ("ranks", "basis", "coeff", "dbasis", "dcoeff", "measure"):
        setattr(a, f, getattr(s, f))
    return a


def test_interpret_and_gsea_match_jax(pbmc_ml, tmp_path):
    a = _as_jax_set(pbmc_ml)
    b = pbmc_ml
    genes = b.row_data.iloc[:, 1].to_numpy()
    mt = ct.meta_genes(b, rank=5, max_per_cluster=8)
    mj = cf.meta_genes(a, rank=5, max_per_cluster=8)
    assert len(mt) == len(mj) == 5
    for u, v in zip(mt, mj):
        np.testing.assert_array_equal(u, v)
    pd.testing.assert_frame_equal(ct.meta_gene_cv(b, rank=5),
                                  cf.meta_gene_cv(a, rank=5))
    assert ct.meta_gene is ct.meta_gene_cv
    w = b.basis_at(5)
    assert ct.gene_select(w, genes, markers=["CD74", "LYZ"]) == \
        cf.gene_select(w, genes, markers=["CD74", "LYZ"])
    ct.write_meta(mt, str(tmp_path / "t.csv"))
    cf.write_meta(mj, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv"
                                                ).read_text()
    kw = dict(rank=5, gset=MARKERS, gene_names=genes,
              grp_prefix=("IG", "HLA"), p_value=True, nperm=20, seed=1)
    pt, pj = ct.assign_celltype(b, **kw), cf.assign_celltype(a, **kw)
    for key in ("ES", "pvalue"):
        pd.testing.assert_frame_equal(pt[key], pj[key])
    assert ct.assignCelltype is ct.assign_celltype


def test_factorize_mesh_matches_jax(small, jax_init):
    """factorize(mesh=...) raised before ROADMAP A7b: over cells=2, M1/M2
    a shard (their plain versions here) against the JAX driver's mesh
    run from the same draws, at _assert_same_result's tolerances."""
    kw = dict(ranks=[2, 3], nrun=2, Itmax=150, seed=2, verbose=0,
              backend="pallas")
    a = cf.factorize(cf.SCSet(count=small), mesh=cf.make_mesh(
        cells=2, devices=jax.devices()[:2]), **kw)
    b = ct.factorize(ct.SCSet(count=small), device="cpu", mesh=ct.make_mesh(
        cells=2, devices=["cpu"] * 2), **kw)
    _assert_same_result(a, b)


@pytest.mark.parametrize("kw,item", [
    (dict(distributed=dict(num_processes=2)), "A7c"),
    (dict(_process_count=2), "A7c"),
    (dict(backend="sparse", sparse_layout="ell"), "ell"),
])
def test_options_not_ported_raise(small, jax_init, kw, item):
    """Options that raised before their port.  ``sparse_layout='ell'``
    runs the CSR layout of ``'tile'`` (S1/S2) and returns the JAX
    driver's ELL result at _assert_same_result's tolerances (JAX's draws
    handed to the port), and the port's ``'tile'`` run bit for bit.  The
    A7c cases raised until several processes were ported: a
    ``distributed`` dict whose
    group cannot form raises, and ``_process_count=2`` splits the
    restarts over two processes (threads standing for them, both
    packages' seams patched alike, JAX's draws handed to the port): each
    process returns the JAX driver's two-process result at
    _assert_same_result's tolerances, and the port's one-process run
    bit for bit."""
    if item == "ell":
        run = dict(ranks=[2, 3], nrun=3, Itmax=150, seed=2, verbose=0, **kw)
        got = ct.factorize(small, device="cpu", **run)
        _assert_same_result(cf.factorize(small, **run), got)
        tile = ct.factorize(small, device="cpu",
                            **dict(run, sparse_layout="tile"))
        pd.testing.assert_frame_equal(got.measure, tile.measure,
                                      check_exact=True)
        for u, v in zip(got.basis + got.coeff, tile.basis + tile.coeff):
            np.testing.assert_array_equal(u, v)
        return
    if "distributed" in kw:
        with pytest.raises(ValueError, match="coordinator_address"):
            ct.factorize(small, ranks=[2], verbose=0, device="cpu", **kw)
        return
    run = dict(ranks=[2, 3], nrun=3, Itmax=150, seed=2, verbose=0,
               backend="pallas", **kw)
    want = threads_as_processes(2, lambda p: cf.factorize(
        cf.SCSet(count=small), _process_id=p, **run), jsched)
    got = threads_as_processes(2, lambda p: ct.factorize(
        ct.SCSet(count=small), device="cpu", _process_id=p, **run), tsched)
    one = ct.factorize(ct.SCSet(count=small), device="cpu",
                       **dict(run, _process_count=1))
    for a, b in zip(want, got):
        _assert_same_result(a, b)
        pd.testing.assert_frame_equal(b.measure, one.measure,
                                      check_exact=True)
        for u, v in zip(b.basis + b.coeff, one.basis + one.coeff):
            np.testing.assert_array_equal(u, v)


def test_bad_options_raise(small):
    with pytest.raises(ValueError, match="unknown backend"):
        ct.factorize(small, ranks=[2], device="cpu", backend="tpu")
    with pytest.raises(ValueError, match="criterion"):
        ct.factorize(small, ranks=[2], device="cpu", criterion="x")


def test_cuda_device_without_card_raises(small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct.factorize(small, ranks=[2], verbose=0)
