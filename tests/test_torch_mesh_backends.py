"""The mesh backends ported with ROADMAP A7b against the JAX package's.

``parallel/sharded.py``'s make_*_sharded functions (make_fused_sharded,
make_sparse_fused_sharded, make_ell_fused_sharded, make_tile_fused_sharded,
make_tile_ml_sharded, make_ml_sharded, and the port's
make_pass2_sharded) run a kernel wrapper on every shard and add the
partials in shard order; JAX runs the same passes under ``shard_map`` on
the 8 virtual CPU devices of tests/conftest.py, its Pallas kernels in
interpret mode.  The port's shards all sit on ``"cpu"``, where every
wrapper takes its plain version (the card tests and chip_smoke.py phase
19 hold the kernels against those).  Then the drivers: vb_factorize's
COO and gene-major mesh routes and factorize(mesh=...) on all four
backends against JAX; lane compaction and the runs axis bit-identical.

Everything is float64.  Tolerances: one pass 1e-10 relative to each
output's largest entry (1e-9 for the data term, a sum of cancelling
terms, relative to its summands); drivers as tests/test_torch_mesh.py
(equal sweep counts, lml 1e-9, basis 1e-7) and
tests/test_torch_ml_driver.py (likelihood 1e-9, dispersion and
cophenetic 1e-12, factors 1e-8).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.ops import ell as jek
from ccfindr_tpu.ops import sparse as jsk
from ccfindr_tpu.ops import tile as jtile
from ccfindr_tpu.ops.pallas import vb_kernels as jvbk
from ccfindr_tpu.parallel import sharded as jsh
from ccfindr_tpu_torch.drivers import ml_driver, vb_driver
from ccfindr_tpu_torch.ops import ell as tek
from ccfindr_tpu_torch.ops import sparse as tsk
from ccfindr_tpu_torch.ops import tile as ttile
from ccfindr_tpu_torch.ops.kernels import vb_kernels as tvbk
from ccfindr_tpu_torch.parallel import sharded as tsh

from test_torch_ml_driver import _assert_same_result as _same_ml
from test_torch_ml_driver import jax_draws

torch.set_num_threads(2)

F64 = torch.float64


def _cpu_mesh(cells, runs=1, genes=1):
    return ct.make_mesh(runs=runs, cells=cells, genes=genes,
                        devices=["cpu"] * (runs * cells * genes))


def _jax_mesh(cells, runs=1, genes=1):
    return cf.make_mesh(runs=runs, cells=cells, genes=genes,
                        devices=jax.devices()[:runs * cells * genes])


def _counts(n, m, seed, density=0.35):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(3.0, (n, m))
    x[:, 0] += 1
    x[0, :] += 1
    return x.astype(np.float64)


def _factors(n, m, r, seed):
    rng = np.random.default_rng(seed)
    return rng.gamma(1.0, 1.0, (n, r)), rng.gamma(1.0, 1.0, (r, m))


def _close(got, want, what, tol=1e-10, scale=None):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _one(t):
    return torch.as_tensor(np.asarray(t))[None]


# ---------------------------------------------------------------------
# the make_*_sharded functions, one pass against JAX's
# ---------------------------------------------------------------------

@pytest.mark.parametrize("genes,cells", [(1, 2), (2, 2), (2, 1)])
def test_make_fused_sharded_matches_jax(genes, cells):
    n, m, r = 16, 256, 3
    x = _counts(n, m, 1)
    lw, lh = _factors(n, m, r, 2)
    j = jsh.make_fused_sharded(_jax_mesh(cells, genes=genes), bn=8,
                               bm=128)(jnp.asarray(x), jnp.asarray(lw),
                                       jnp.asarray(lh))
    mesh = _cpu_mesh(cells, genes=genes)
    xs = tsh.place_counts(torch.tensor(x), mesh)[0]
    t = tsh.make_fused_sharded(mesh, bn=8, bm=128)(xs, _one(lw), _one(lh))
    scale = float(x.sum()) * 10
    for got, want, what, sc in zip(t, j, ("swn", "shn", "dterm"),
                                   (None, None, scale)):
        _close(got[0], want, what, scale=sc)


@pytest.mark.parametrize("layout", ["cm", "gm"])
def test_fused_pallas_padded_matches_jax(layout):
    """The X pass a block runs (E1 + E1s, here its plain version) with
    JAX's fold, in both loop orders, against JAX's kernel in interpret
    mode; a lane batch equals its lanes alone."""
    n, m, r = 20, 200, 5
    x = _counts(n, m, 3)
    xp = np.pad(x, ((0, 4), (0, 56)))
    lws, lhs = zip(*(_factors(n, m, r, s) for s in (4, 5)))
    t = tvbk.fused_pallas_padded(torch.tensor(xp), torch.tensor(np.stack(
        lws)), torch.tensor(np.stack(lhs)), n=n, m=m, r=r, bn=8, bm=128,
        layout=layout)
    for b in range(2):
        j = jvbk.fused_pallas_padded(jnp.asarray(xp), jnp.asarray(lws[b]),
                                     jnp.asarray(lhs[b]), n=n, m=m, r=r,
                                     bn=8, bm=128, layout=layout)
        for got, want, what, sc in zip(t, j, ("swn", "shn", "dterm"),
                                       (None, None, float(x.sum()) * 10)):
            _close(got[b], want, what, scale=sc)
        one = tvbk.fused_pallas(torch.tensor(x), torch.tensor(lws[b]),
                                torch.tensor(lhs[b]), bn=8, bm=128,
                                layout=layout)
        _close(one[0], j[0], "fused_pallas swn")
    fb = tvbk.make_fused_backend(bn=8, bm=128)(
        torch.tensor(x), torch.tensor(lws[0])[None],
        torch.tensor(lhs[0])[None])
    assert fb[0].shape == (1, n, r) and fb[1].shape == (1, r, m)


def test_make_sparse_fused_sharded_matches_jax():
    n, m, r = 18, 40, 3
    csr = sp.csr_matrix(_counts(n, m, 6))
    lw, lh = _factors(n, m, r, 7)
    j = jsh.make_sparse_fused_sharded(_jax_mesh(4), chunk=16)(
        jsk.from_scipy_sharded(csr, 4, dtype=jnp.float64, chunk=16),
        jnp.asarray(lw), jnp.asarray(lh))
    x = tsk.from_scipy_sharded(csr, 4, dtype=F64, chunk=16, device="cpu")
    t = tsh.make_sparse_fused_sharded(_cpu_mesh(4), chunk=16)(
        x, _one(lw), _one(lh))
    for got, want, what, sc in zip(t, j, ("swn", "shn", "dterm"),
                                   (None, None, float(csr.sum()) * 10)):
        _close(got[0], want, what, scale=sc)


def test_make_ell_fused_sharded_matches_jax():
    """The ELL mesh builder (fused_ell, S1/S2 over each shard's CSR view)
    against JAX's under shard_map, with overflow tails (quantile 0.5)."""
    n, m, r = 18, 40, 3
    csr = sp.csr_matrix(_counts(n, m, 6))
    lw, lh = _factors(n, m, r, 7)
    j = jsh.make_ell_fused_sharded(_jax_mesh(4))(
        jek.from_scipy_ell_sharded(csr, 4, dtype=jnp.float64, quantile=0.5,
                                   lane=8),
        jnp.asarray(lw), jnp.asarray(lh))
    x = tek.from_scipy_ell_sharded(csr, 4, dtype=F64, quantile=0.5, lane=8,
                                   device="cpu")
    assert any(s.gtval.numel() for s in x)
    t = tsh.make_ell_fused_sharded(_cpu_mesh(4))(x, _one(lw), _one(lh))
    for got, want, what, sc in zip(t, j, ("swn", "shn", "dterm"),
                                   (None, None, float(csr.sum()) * 10)):
        _close(got[0], want, what, scale=sc)


@pytest.mark.parametrize("do_elbo", [None, 0.0])
def test_make_tile_fused_sharded_matches_jax(do_elbo):
    n, m, r = 16, 40, 4
    csr = sp.csr_matrix(_counts(n, m, 8))
    lw, lh = _factors(n, m, r, 9)
    fj = jsh.make_tile_fused_sharded(_jax_mesh(2))
    jx = jtile.from_scipy_tile_sharded(csr, 2, dtype=jnp.float64)
    kw = {} if do_elbo is None else dict(do_elbo=jnp.asarray(do_elbo))
    j = fj(jx, jnp.asarray(lw), jnp.asarray(lh), **kw)
    tx = ttile.from_scipy_tile_sharded(csr, 2, dtype=F64, device="cpu")
    tkw = {} if do_elbo is None else dict(do_elbo=torch.tensor([do_elbo]))
    t = tsh.make_tile_fused_sharded(_cpu_mesh(2))(tx, _one(lw), _one(lh),
                                                   **tkw)
    _close(t[0][0], j[0], "swn")
    _close(t[1][0], j[1], "shn")
    if do_elbo is None:
        _close(t[2][0], j[2], "dterm", scale=float(csr.sum()) * 10)


def test_make_ml_sharded_pairs_match_jax():
    """make_ml_sharded (M1/M2 a block) and make_tile_ml_sharded (S1/S2 a
    shard) against JAX's shard_map pairs."""
    n, m, r = 16, 256, 3
    x = _counts(n, m, 10)
    w, h = _factors(n, m, r, 11)
    jm, tm = _jax_mesh(2), _cpu_mesh(2)
    jfh, jfw = jsh.make_ml_sharded(jm, bn=8, bm=128)
    tfh, tfw = tsh.make_ml_sharded(tm, bn=8, bm=128)
    xs = tsh.place_counts(torch.tensor(x), tm)[0]
    args_j = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(h))
    hn, xl = tfh(xs, _one(w), _one(h))
    jhn, jxl = jfh(*args_j)
    _close(hn[0], jhn, "hn")
    _close(xl[0], jxl, "xlogwh")
    _close(tfw(xs, _one(w), _one(h))[0], jfw(*args_j), "wn")

    csr = sp.csr_matrix(x)
    jfh, jfw = jsh.make_tile_ml_sharded(jm)
    tfh, tfw = tsh.make_tile_ml_sharded(tm)
    jx = jtile.from_scipy_tile_sharded(csr, 2, dtype=jnp.float64)
    tx = ttile.from_scipy_tile_sharded(csr, 2, dtype=F64, device="cpu")
    hn, xl = tfh(tx, _one(w), _one(h))
    jhn, jxl = jfh(jx, jnp.asarray(w), jnp.asarray(h))
    _close(hn[0], jhn, "tile hn")
    _close(xl[0], jxl, "tile xlogwh")
    _close(tfw(tx, _one(w), _one(h))[0],
           jfw(jx, jnp.asarray(w), jnp.asarray(h)), "tile wn")


@pytest.mark.parametrize("genes,cells", [(1, 4), (2, 2)])
def test_make_pass2_sharded_matches_jax(genes, cells):
    """The two-pass backend a block (P1 + E1s and P2, here their plain
    versions) against JAX's two-pass functions on the whole X."""
    n, m, r = 16, 64, 3
    x = _counts(n, m, 12)
    lw, lh = _factors(n, m, r, 13)
    mesh = _cpu_mesh(cells, genes=genes)
    ss, dt = tsh.make_pass2_sharded(mesh)
    xs = tsh.place_counts(torch.tensor(x), mesh)[0]
    sw, sh = ss(xs, _one(lw), _one(lh))
    jsw, jsh_ = jvbk.suffstats_pallas(jnp.asarray(x), jnp.asarray(lw),
                                      jnp.asarray(lh), bn=8, bm=128)
    _close(sw[0], jsw, "sw")
    _close(sh[0], jsh_, "sh")
    _close(dt(xs, _one(lw), _one(lh))[0],
           jvbk.elbo_data_pallas(jnp.asarray(x), jnp.asarray(lw),
                                 jnp.asarray(lh), bn=8, bm=128),
           "data term", scale=float(x.sum()) * 10)


def test_sharded_passes_check_the_layout():
    x = tsh.place_counts(torch.ones(4, 8, dtype=F64), _cpu_mesh(2))[0]
    one = torch.ones(1, 4, 2, dtype=F64), torch.ones(1, 2, 8, dtype=F64)
    with pytest.raises(ValueError, match="mesh has"):
        tsh.make_fused_sharded(_cpu_mesh(4))(x, *one)
    ex = tek.from_scipy_ell_sharded(sp.csr_matrix(np.ones((4, 8))), 4,
                                    dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="mesh has"):
        tsh.make_ell_fused_sharded(_cpu_mesh(2))(ex, *one)


# ---------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------

def _divisible_counts():
    x = cf.simulate_whx(nrow=24, ncol=64, rank=3, seed=21, ah=0.5)["x"]
    x = x[:x.shape[0] // 2 * 2, :x.shape[1] // 4 * 4]
    assert (x.sum(axis=0) > 0).all() and (x.sum(axis=1) > 0).all()
    return x


def _vb_pair(cells, **kw):
    x = _divisible_counts()
    kw = dict(ranks=[2, 3], nrun=1, verbose=0, Itmax=200,
              initializer="svd2", **kw)
    j = cf.vb_factorize(x, mesh=_jax_mesh(cells), **kw)
    t = ct.vb_factorize(x, mesh=_cpu_mesh(cells), device="cpu", **kw)
    assert t.ranks == j.ranks
    assert t.metadata["timings"][0]["total_sweeps"] == \
        j.metadata["timings"][0]["total_sweeps"]
    np.testing.assert_allclose(t.measure["lml"], j.measure["lml"],
                               rtol=1e-9)
    for k in range(len(t.ranks)):
        np.testing.assert_allclose(t.basis[k], j.basis[k], rtol=1e-7,
                                   atol=1e-300)


def test_vb_factorize_coo_mesh_matches_jax():
    """sparse_layout='coo' over cells=2: JAX's from_scipy_sharded and
    make_sparse_fused_sharded against the port's CSR shards
    (make_tile_fused_sharded; the port's COO pass is fused_tile over a
    CSR view)."""
    _vb_pair(2, backend="sparse", sparse_layout="coo")


def test_vb_factorize_gene_major_mesh_matches_jax(monkeypatch):
    """The gene-major mesh route (JAX's driver takes it where
    _fused_layout answers 'gm': above 65,536 genes, too large for the
    CPU tests), forced on both sides at a small shape: the fused X pass
    a cell shard in E1's 'gm' order, in vb_run."""
    def gm(*a, **k):
        return "gm"

    monkeypatch.setattr(jvbk, "_fused_layout", gm)
    monkeypatch.setattr(tvbk, "_fused_layout", gm)
    monkeypatch.setattr(vb_driver, "_fused_layout", gm)
    seen = []
    real = tvbk.fused_pallas_raw

    def spy(*a, **k):
        seen.append(k["layout"])
        return real(*a, **k)

    monkeypatch.setattr(tvbk, "fused_pallas_raw", spy)
    _vb_pair(2, backend="pallas")
    assert seen and set(seen) == {"gm"}


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(ml_driver, "initial_factors", jax_draws)


@pytest.mark.parametrize("backend", ["dense", "dense_fused", "pallas",
                                     "sparse"])
def test_factorize_mesh_matches_jax(jax_init, backend):
    x = cf.simulate_whx(nrow=30, ncol=48, rank=3, seed=17)["x"]
    inp = sp.csr_matrix(x) if backend == "sparse" else x
    kw = dict(ranks=[2, 3], nrun=2, Itmax=150, seed=2, verbose=0,
              backend=backend)
    a = cf.factorize(cf.SCSet(count=inp), mesh=_jax_mesh(4), **kw)
    b = ct.factorize(ct.SCSet(count=inp), mesh=_cpu_mesh(4), device="cpu",
                     **kw)
    _same_ml(a, b)


def test_factorize_ragged_mesh_matches_jax(jax_init):
    """A cell count the mesh does not divide (45 on 4): the draws at the
    padded width and the likelihood over the true extents, as in JAX."""
    x = cf.simulate_whx(nrow=20, ncol=45, rank=3, seed=19)["x"]
    assert x.shape[1] % 4
    kw = dict(ranks=[2, 3], nrun=2, Itmax=120, seed=5, verbose=0,
              backend="pallas")
    a = cf.factorize(cf.SCSet(count=x), mesh=_jax_mesh(4), **kw)
    b = ct.factorize(ct.SCSet(count=x), mesh=_cpu_mesh(4), device="cpu",
                     **kw)
    _same_ml(a, b)
    assert b.coeff[0].shape == (2, x.shape[1])


def test_sparse_mesh_compaction_is_bit_identical():
    """compact_every on the sparse mesh equals the uninterrupted run, bit
    for bit (VB and ML)."""
    x = sp.csr_matrix(_divisible_counts())
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=200, seed=4,
              backend="sparse", device="cpu", mesh=_cpu_mesh(4))
    a = ct.vb_factorize(x, **kw)
    b = ct.vb_factorize(x, compact_every=15, **kw)
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    for u, v in zip(a.basis + a.coeff, b.basis + b.coeff):
        np.testing.assert_array_equal(u, v)
    kw.update(Itmax=120)
    a = ct.factorize(x, **kw)
    b = ct.factorize(x, compact_every=15, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])
    for u, v in zip(a.basis + a.coeff, b.basis + b.coeff):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("backend", ["sparse", "pallas2pass"])
def test_runs_axis_is_bit_identical(backend):
    """runs=2 (two lane groups) equals runs=1, bit for bit, on the new
    VB mesh backends and on factorize's mesh."""
    x = _divisible_counts()
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=150, seed=2,
              backend=backend, device="cpu")
    a = ct.vb_factorize(x, mesh=_cpu_mesh(2), **kw)
    b = ct.vb_factorize(x, mesh=_cpu_mesh(2, runs=2), **kw)
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    for u, v in zip(a.basis + a.coeff, b.basis + b.coeff):
        np.testing.assert_array_equal(u, v)
    kw["backend"] = "sparse" if backend == "sparse" else "pallas"
    a = ct.factorize(x, mesh=_cpu_mesh(2), **kw)
    b = ct.factorize(x, mesh=_cpu_mesh(2, runs=2), **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  b.measure["likelihood"])
    for u, v in zip(a.basis + a.coeff, b.basis + b.coeff):
        np.testing.assert_array_equal(u, v)
