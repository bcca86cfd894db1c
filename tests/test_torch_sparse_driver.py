"""The port's sparse backend end to end: vb_factorize and factorize on
``backend='sparse'`` against the JAX package's same calls and against
the port's own dense_fused runs, at float64 on the CPU (where the tile
layout runs the plain version of the CUDA kernels S1/S2).

The JAX side runs its Pallas tile kernel in interpret mode.  Its ML
initial draws reach the port through drivers.ml_driver.initial_factors,
as in tests/test_torch_ml_driver.py.  Tolerances: vb_factorize lml
1e-9 relative and factors 1e-7 against JAX, with equal sweep counts;
lml 1e-10 and equal n_iter against the port's dense_fused run;
factorize likelihood 1e-9, dispersion and cophenetic 1e-12, factors
1e-8.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.drivers import ml_driver as jml_driver
from ccfindr_tpu_torch.drivers import ml_driver
from ccfindr_tpu_torch.ops import tile as ttk

from test_torch_ml_driver import _assert_same_result as _same_ml
from test_torch_ml_driver import jax_draws

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small():
    return sp.csr_matrix(
        cf.simulate_whx(nrow=40, ncol=60, rank=3, seed=31)["x"])


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(ml_driver, "initial_factors", jax_draws)


def _sweeps(s):
    return [r["total_sweeps"] for r in s.metadata["timings"]
            if "total_sweeps" in r]


@pytest.mark.parametrize("sparse_layout", ["auto", "coo"])
def test_vb_factorize_sparse_matches_jax(small, sparse_layout):
    kw = dict(ranks=[2, 3, 4], initializer="svd2", backend="sparse",
              sparse_layout=sparse_layout, Itmax=300, verbose=0)
    a = cf.vb_factorize(cf.SCSet(count=small), **kw)
    b = ct.vb_factorize(ct.SCSet(count=small), device="cpu", **kw)
    assert _sweeps(a) == _sweeps(b) and _sweeps(b)[0] > 0
    assert list(a.measure["rank"]) == list(b.measure["rank"])
    np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                               rtol=1e-9)
    for col in ("aw", "bw", "ah", "bh"):
        np.testing.assert_allclose(b.measure[col], a.measure[col],
                                   rtol=1e-8, err_msg=col)
    np.testing.assert_array_equal(b.measure["nunif"], a.measure["nunif"])
    for k in range(len(a.ranks)):
        for f in ("basis", "coeff", "dbasis", "dcoeff"):
            np.testing.assert_allclose(getattr(b, f)[k], getattr(a, f)[k],
                                       rtol=1e-7, err_msg=f)
    assert b.basis[0].dtype == np.float64


@pytest.mark.parametrize("elbo_every", [1, 4])
def test_vb_factorize_sparse_equals_dense_fused(small, elbo_every):
    """With a random init from one seed, the sparse sweep is the dense
    fused sweep over the nonzeros; with elbo_every=4 it is the dense
    sol loop's cadence."""
    kw = dict(ranks=[2, 3], nrun=2, Itmax=300, seed=5, verbose=0,
              device="cpu", elbo_every=elbo_every)
    a = ct.vb_factorize(small, backend="sparse", **kw)
    b = ct.vb_factorize(small.toarray(), backend=(
        "dense_fused" if elbo_every == 1 else "pallas"), **kw)
    rec_a, rec_b = a.metadata["timings"][0], b.metadata["timings"][0]
    assert rec_a["n_iter"] == rec_b["n_iter"]
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-10)
    for k in range(len(a.ranks)):
        np.testing.assert_allclose(a.basis[k], b.basis[k], rtol=1e-8)


def test_vb_factorize_sparse_svd_init_takes_the_csr(small):
    kw = dict(ranks=[3], initializer="svd", Itmax=100, verbose=0,
              device="cpu")
    a = ct.vb_factorize(small, backend="sparse", **kw)
    b = ct.vb_factorize(small.toarray(), backend="dense_fused", **kw)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-10)


@pytest.mark.parametrize("batch_ranks", [True, False])
def test_factorize_sparse_matches_jax(small, jax_init, batch_ranks):
    kw = dict(ranks=[2, 3, 4], nrun=3, Itmax=200, Tol=1e-6, seed=4,
              backend="sparse", batch_ranks=batch_ranks, verbose=0)
    a = cf.factorize(cf.SCSet(count=small), **kw)
    b = ct.factorize(ct.SCSet(count=small), device="cpu", **kw)
    _same_ml(a, b)
    runs = [r for r in b.metadata["timings"]
            if r["name"].startswith("ml_rank")]
    assert [len(r["n_iter"]) for r in runs] == ([9] if batch_ranks
                                                else [3, 3, 3])


def test_factorize_sparse_equals_dense_fused(small):
    kw = dict(ranks=[2, 3], nrun=2, Itmax=150, Tol=1e-6, seed=8,
              verbose=0, device="cpu")
    a = ct.factorize(small, backend="sparse", **kw)
    b = ct.factorize(small.toarray(), backend="dense_fused", **kw)
    na = [r["n_iter"] for r in a.metadata["timings"] if "n_iter" in r]
    nb = [r["n_iter"] for r in b.metadata["timings"] if "n_iter" in r]
    assert na == nb
    np.testing.assert_allclose(a.measure["likelihood"],
                               b.measure["likelihood"], rtol=1e-10)
    for col in ("dispersion", "cophenetic"):
        np.testing.assert_allclose(a.measure[col], b.measure[col],
                                   rtol=0, atol=1e-12)


def test_shuffle_sparse_columns_matches_jax(small):
    for seed in (0, 3):
        rng_a = np.random.default_rng(np.random.SeedSequence([seed, 7]))
        rng_b = np.random.default_rng(np.random.SeedSequence([seed, 7]))
        a = jml_driver._shuffle_sparse_columns(small, rng_a)
        b = ml_driver._shuffle_sparse_columns(small, rng_b)
        assert (a != b).nnz == 0 and b.nnz == small.nnz
        # each column keeps its values; rows move
        np.testing.assert_array_equal(np.sort(b.tocsc()[:, 5].data),
                                      np.sort(small.tocsc()[:, 5].data))


def test_factorize_sparse_randomize_matches_jax(small, jax_init):
    """randomize=True shuffles the nonzeros of each column; the same
    stream gives the same matrices, which may hold empty gene rows
    (S1 writes zero wn rows there), and the same measures."""
    kw = dict(ranks=[2, 3], nrun=2, Itmax=150, seed=2, randomize=True,
              nsmpl=2, backend="sparse", verbose=0)
    a = cf.factorize(cf.SCSet(count=small), **kw)
    b = ct.factorize(ct.SCSet(count=small), device="cpu", **kw)
    _same_ml(a, b)
    assert "r_se" in b.measure.columns


def test_empty_rows_of_a_shuffled_matrix_give_zero_rows():
    x = np.zeros((5, 4))
    x[0], x[2, 1], x[4, 3] = 3.0, 1.0, 2.0
    tc = ttk.from_dense_tile(x, dtype=torch.float64, device="cpu")
    w = torch.rand(2, 5, 3, dtype=torch.float64) + 0.1
    h = torch.rand(2, 3, 4, dtype=torch.float64) + 0.1
    wn = ttk.tile_ml_w(tc, w, h)
    assert torch.equal(wn[:, [1, 3]], torch.zeros(2, 2, 3,
                                                  dtype=torch.float64))
    assert bool((wn[:, [0, 2, 4]] > 0).all())


def test_sparse_drivers_never_densify(monkeypatch):
    """backend='sparse' forms no dense X anywhere in either driver (the
    JAX package's tests/test_sparse.py rule)."""
    sim = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=21)
    s = ct.SCSet(count=sp.csr_matrix(sim["x"]))

    def boom(*a, **k):
        raise AssertionError("dense materialization in sparse path")

    monkeypatch.setattr(ct.SCSet, "counts_dense", boom)
    monkeypatch.setattr(sp.csr_matrix, "toarray", boom)
    monkeypatch.setattr(sp.csr_matrix, "todense", boom)
    for layout in ("auto", "coo"):
        out = ct.vb_factorize(s, ranks=[2, 3], nrun=2, verbose=0,
                              Itmax=300, seed=3, backend="sparse",
                              sparse_layout=layout, device="cpu")
        assert out.ranks == [2, 3]
        assert np.isfinite(out.measure["lml"]).all()
    f = ct.factorize(s, ranks=[2, 3], nrun=2, Itmax=100, seed=3,
                     backend="sparse", randomize=True, nsmpl=2, verbose=0,
                     device="cpu")
    assert np.isfinite(f.measure.drop(columns="rank").to_numpy()).all()


@pytest.mark.parametrize("driver", ["vb", "ml"])
def test_sparse_mesh_matches_jax(small, jax_init, driver):
    """backend='sparse' over a cell-sharded mesh raised before ROADMAP
    A7b: S1/S2 a shard (their plain versions here) against the JAX
    driver's mesh run (its tile kernel a shard, interpret mode), at the
    tolerances of the one-device tests above."""
    jmesh = cf.make_mesh(cells=2, devices=jax.devices()[:2])
    tmesh = ct.make_mesh(cells=2, devices=["cpu"] * 2)
    if driver == "vb":
        kw = dict(ranks=[2, 3], initializer="svd2", backend="sparse",
                  Itmax=300, verbose=0)
        a = cf.vb_factorize(cf.SCSet(count=small), mesh=jmesh, **kw)
        b = ct.vb_factorize(ct.SCSet(count=small), mesh=tmesh, device="cpu",
                            **kw)
        assert _sweeps(a) == _sweeps(b)
        np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                                   rtol=1e-9)
        for k in range(len(a.ranks)):
            np.testing.assert_allclose(b.basis[k], a.basis[k], rtol=1e-7)
    else:
        kw = dict(ranks=[2, 3], nrun=2, Itmax=150, seed=2, verbose=0,
                  backend="sparse")
        a = cf.factorize(cf.SCSet(count=small), mesh=jmesh, **kw)
        b = ct.factorize(ct.SCSet(count=small), mesh=tmesh, device="cpu",
                         **kw)
        _same_ml(a, b)


@pytest.mark.parametrize("driver", ["vb", "ml"])
@pytest.mark.parametrize("kw,exc,match", [
    (dict(sparse_layout="ell", storage_dtype="int16"), ValueError,
     "storage_dtype"),
    (dict(sparse_layout="csr5"), ValueError, "unknown sparse_layout"),
    (dict(storage_dtype="int8"), ValueError, "storage_dtype"),
])
def test_sparse_option_errors(small, driver, kw, exc, match):
    """Each option raises the JAX driver's error in both packages (the
    ELL layout, ported, refuses a storage type as the others do)."""
    for pkg, extra in ((ct, dict(device="cpu")), (cf, {})):
        fn = pkg.vb_factorize if driver == "vb" else pkg.factorize
        with pytest.raises(exc, match=match):
            fn(small, ranks=[2], verbose=0, backend="sparse", **kw,
               **extra)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(precision="fp16"), ValueError, "precision"),
    (dict(elbo_every=0), ValueError, "elbo_every"),
])
def test_vb_sparse_option_errors(small, kw, exc, match):
    with pytest.raises(exc, match=match):
        ct.vb_factorize(small, ranks=[2], verbose=0, device="cpu",
                        backend="sparse", **kw)


def test_sparse_empty_rows_and_columns_raise():
    x = sp.csr_matrix(np.array([[1.0, 0.0, 2.0], [0.0, 0.0, 0.0],
                                [3.0, 0.0, 1.0]]))
    for fn in (ct.vb_factorize, ct.factorize):
        with pytest.raises(ValueError, match="empty rows"):
            fn(x, ranks=[1], verbose=0, device="cpu", backend="sparse")
    y = sp.csr_matrix(np.array([[1.0, 0.0], [2.0, 0.0]]))
    with pytest.raises(ValueError, match="empty columns"):
        ct.vb_factorize(y, ranks=[1], verbose=0, device="cpu",
                        backend="sparse")
