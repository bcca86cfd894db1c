"""The port's ELL API (ops/ell.py: EllCounts, from_scipy_ell,
from_dense_ell, from_scipy_ell_sharded, fused_ell, make_ell_fused,
ell_ml_h, ell_ml_w, make_ell_ml_backend; parallel/sharded.py::
make_ell_fused_sharded; both drivers' sparse_layout='ell') against the
JAX package's, at float64 on the CPU, and the dense routes' lane-count
independent products (utils.lane_matmul).

JAX's tests/test_ell.py problems, with quantile 1.0 and 0.5 (tails) and
lane=8.  The port's passes are ops.tile's over the CSR view
EllCounts.csr: here the plain versions of S1/S2, on the card the kernels
(tests/test_torch_kernels.py, chip_smoke.py phase 21).  Tolerances:
layouts exact; passes 1e-10 relative (JAX's tests/test_ell.py); VB
against JAX's ELL driver lml 1e-8, basis 1e-6 (its test against dense);
the mesh lml 1e-9, coeff 1e-7; ML as tests/test_torch_ml_driver.py.
Against the port's own 'tile' runs: bit for bit.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.ops import ell as jek
from ccfindr_tpu.parallel import schedule as jsched
from ccfindr_tpu.parallel import sharded as jsh
from ccfindr_tpu_torch import utils
from ccfindr_tpu_torch.drivers import ml_driver
from ccfindr_tpu_torch.ops import ell as tek
from ccfindr_tpu_torch.ops import ml as tml
from ccfindr_tpu_torch.ops import tile as ttile
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.parallel import schedule as tsched
from ccfindr_tpu_torch.parallel import sharded as tsh

from test_torch_ml_driver import _assert_same_result as _same_ml
from test_torch_ml_driver import jax_draws
from test_torch_schedule import threads_as_processes

torch.set_num_threads(2)

F64 = torch.float64


def _problem(n=80, m=120, r=5, density=0.15, seed=0, hot_rows=3):
    """JAX's tests/test_ell.py problem: a sparse X with a few dense
    'housekeeping' rows, which leave tails at a low quantile."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(3.0, (n, m))
    x = x.astype(np.float64)
    x[:hot_rows] = rng.poisson(2.0, (hot_rows, m))
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    lw = rng.gamma(1.0, 1.0, size=(n, r))
    lh = rng.gamma(1.0, 1.0, size=(r, m))
    return x, lw, lh


def _driver_x(seed=11, n=30, m=45, density=0.3):
    """JAX's driver problem (tests/test_ell.py)."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(4.0, (n, m))
    x = x.astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    return x


def _same_fields(t, j, shard=None):
    for f in tek._FIELDS:
        want = np.asarray(getattr(j, f))
        if shard is not None:
            want = want[shard]
        got = getattr(t, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, f)


def _close(got, want, what, scale=None):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10,
                               atol=1e-10 * scale, err_msg=what)


def _same_vb(a, b):
    """Two vb_factorize results equal bit for bit."""
    assert a.measure.equals(b.measure)
    for f in ("basis", "coeff", "dbasis", "dcoeff"):
        for u, v in zip(getattr(a, f), getattr(b, f)):
            np.testing.assert_array_equal(u, v, f)


# ---------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------

@pytest.mark.parametrize("quantile", [1.0, 0.5])
def test_layout_matches_jax(quantile):
    x, _, _ = _problem()
    j = jek.from_scipy_ell(sp.csr_matrix(x), dtype=jnp.float64,
                           quantile=quantile, lane=8)
    t = tek.from_scipy_ell(sp.csr_matrix(x), dtype=F64, quantile=quantile,
                           lane=8, device="cpu")
    _same_fields(t, j)
    assert (t.n, t.m, t.bn, t.bm) == (j.n, j.m, j.bn, j.bm)
    if quantile < 1.0:
        assert t.gtval.shape[0] > 0 and t.ctval.shape[0] > 0
    # every nonzero once, as JAX's val (which also holds the zero padding)
    assert float(t.val.sum()) == float(np.asarray(j.val).sum()) == x.sum()
    d = tek.from_dense_ell(x, dtype=F64, quantile=quantile, device="cpu")
    _same_fields(d, jek.from_dense_ell(x, dtype=jnp.float64,
                                       quantile=quantile))


@pytest.mark.parametrize("quantile", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_csr_view_is_the_tile_layout(quantile, dtype):
    """EllCounts.csr holds from_scipy_tile's arrays exactly, its values
    stored by tile's rule (int16 counts; the counts + 0.25 in the factor
    type), so that an ELL pass runs tile's kernel instances."""
    x, _, _ = _problem(seed=3)
    for xx in (x, np.where(x > 0, x + 0.25, 0.0)):
        csr = sp.csr_matrix(xx)
        t = tek.from_scipy_ell(csr, dtype=dtype, quantile=quantile, lane=8,
                               device="cpu")
        ref = ttile.from_scipy_tile(csr, dtype=dtype, device="cpu")
        for f in ("indptr", "col", "val", "colptr", "row", "perm"):
            got, want = getattr(t.csr, f), getattr(ref, f)
            assert got.dtype == want.dtype and torch.equal(got, want), f
        assert torch.equal(t.val, ref.val)


@pytest.mark.parametrize("n_shards,m_pad,quantile", [
    (4, None, 1.0), (4, None, 0.5), (3, 123, 0.5), (2, 124, 0.98)])
def test_sharded_layout_matches_jax(n_shards, m_pad, quantile):
    x, _, _ = _problem(seed=5)
    csr = sp.csr_matrix(x)
    j = jek.from_scipy_ell_sharded(csr, n_shards, m_pad=m_pad,
                                   dtype=jnp.float64, quantile=quantile,
                                   lane=8)
    t = tek.from_scipy_ell_sharded(csr, n_shards, m_pad=m_pad, dtype=F64,
                                   quantile=quantile, lane=8, device="cpu")
    assert len(t) == n_shards and (t.n, t.m) == (j.n, j.m)
    for s, shard in enumerate(t):
        _same_fields(shard, j, shard=s)
        assert (shard.n, shard.m, shard.bn, shard.bm) == (j.n, j.m, j.bn,
                                                          j.bm)
        assert shard.csr.val.dtype == t.val.dtype
    # the one-device layout's val, for the loops' sum lgamma(x + 1)
    one = tek.from_scipy_ell(csr, dtype=F64, quantile=quantile, lane=8,
                             device="cpu")
    assert torch.equal(t.val, one.val)
    with pytest.raises(ValueError, match="not divisible"):
        tek.from_scipy_ell_sharded(csr, 2, m_pad=125, device="cpu")


def test_negative_entry_is_skipped_as_jax_skips_it():
    """JAX's passes mask ``gv > 0``: a negative entry adds nothing to the
    numerators or x log wth.  The view drops it; ``val`` keeps it."""
    x, lw, lh = _problem(seed=7)
    x[5, 7], x[2, 11] = -2.0, -0.5          # a slot and a hot row
    csr = sp.csr_matrix(x)
    j = jek.from_scipy_ell(csr, dtype=jnp.float64, quantile=0.5, lane=8)
    t = tek.from_scipy_ell(csr, dtype=F64, quantile=0.5, lane=8,
                           device="cpu")
    _same_fields(t, j)
    assert t.csr.nnz == int((x > 0).sum())
    assert float(t.val.sum()) == pytest.approx(x.sum())
    got = tek.fused_ell(t, torch.tensor(lw), torch.tensor(lh))
    want = jek.fused_ell(j, jnp.asarray(lw), jnp.asarray(lh))
    for g, w, what in zip(got, want, ("swn", "shn", "dterm")):
        _close(g, w, what)


# ---------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------

@pytest.mark.parametrize("quantile", [1.0, 0.5])
def test_passes_match_jax(quantile):
    x, lw, lh = _problem()
    csr = sp.csr_matrix(x)
    j = jek.from_scipy_ell(csr, dtype=jnp.float64, quantile=quantile,
                           lane=8)
    t = tek.from_scipy_ell(csr, dtype=F64, quantile=quantile, lane=8,
                           device="cpu")
    jw, jh = jnp.asarray(lw), jnp.asarray(lh)
    tw, th = torch.tensor(lw), torch.tensor(lh)
    for got, want, what in zip(tek.fused_ell(t, tw, th),
                               jek.fused_ell(j, jw, jh),
                               ("swn", "shn", "dterm")):
        _close(got, want, what)
    for got, want, what in zip(tek.ell_ml_h(t, tw, th),
                               jek.ell_ml_h(j, jw, jh), ("hn", "xlogwh")):
        _close(got, want, what)
    _close(tek.ell_ml_w(t, tw, th), jek.ell_ml_w(j, jw, jh), "wn")
    # the make_* functions and a lane batch: each lane its own pass
    fused = tek.make_ell_fused()
    fh, fw = tek.make_ell_ml_backend()
    lw2, lh2 = torch.stack([tw, tw * 2.0]), torch.stack([th, th + 0.5])
    sw2, sh2, dt2 = fused(t, lw2, lh2)
    hn2, xl2 = fh(t, lw2, lh2)
    wn2 = fw(t, lw2, lh2)
    for b in range(2):
        swn, shn, dt = tek.fused_ell(t, lw2[b], lh2[b])
        assert torch.equal(sw2[b], swn) and torch.equal(sh2[b], shn)
        assert torch.equal(dt2[b], dt)
        hn, xl = tek.ell_ml_h(t, lw2[b], lh2[b])
        assert torch.equal(hn2[b], hn) and torch.equal(xl2[b], xl)
        assert torch.equal(wn2[b], tek.ell_ml_w(t, lw2[b], lh2[b]))
    # over the view, the tile passes' bits
    tc = ttile.from_scipy_tile(csr, dtype=F64, device="cpu")
    for u, v in zip(fused(t, lw2, lh2), ttile.fused_tile(tc, lw2, lh2)):
        assert torch.equal(u, v)


def test_make_ell_fused_sharded_matches_jax_and_one_device():
    """make_ell_fused_sharded over a CPU mesh of 4 against JAX's under
    shard_map and against fused_ell on one device (JAX's
    test_fused_ell_sharded_matches_single_device)."""
    x, lw, lh = _problem(n=24, m=64, r=3, seed=5)
    csr = sp.csr_matrix(x)
    jmesh = cf.make_mesh(cells=4, devices=jax.devices()[:4])
    j = jax.jit(jsh.make_ell_fused_sharded(jmesh))(
        jek.from_scipy_ell_sharded(csr, 4, dtype=jnp.float64, lane=8),
        jnp.asarray(lw), jnp.asarray(lh))
    tmesh = ct.make_mesh(cells=4, devices=["cpu"] * 4)
    t = tsh.make_ell_fused_sharded(tmesh)(
        tek.from_scipy_ell_sharded(csr, 4, dtype=F64, lane=8, device="cpu"),
        torch.tensor(lw)[None], torch.tensor(lh)[None])
    one = tek.fused_ell(tek.from_scipy_ell(csr, dtype=F64, lane=8,
                                           device="cpu"),
                        torch.tensor(lw), torch.tensor(lh))
    for got, want, o, what in zip(t, j, one, ("swn", "shn", "dterm")):
        _close(got[0], want, what)
        _close(got[0], o, what)
    with pytest.raises(ValueError, match="mesh has"):
        tsh.make_ell_fused_sharded(ct.make_mesh(cells=2, devices=["cpu"] * 2))(
            tek.from_scipy_ell_sharded(csr, 4, dtype=F64, device="cpu"),
            torch.tensor(lw)[None], torch.tensor(lh)[None])


# ---------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------

# JAX's driver test (tests/test_ell.py), from the deterministic start
# both packages draw alike
VB_KW = dict(ranks=[2, 3], initializer="svd2", Itmax=60, verbose=0, seed=7)


@pytest.mark.parametrize("initializer", ["svd2", "random"])
def test_vb_factorize_ell_matches_jax_and_tile(initializer):
    """From the SVD start against JAX's ELL driver; from a random start
    (torch's stream, not JAX's) against the port's 'tile' only."""
    x = _driver_x()
    kw = dict(VB_KW, initializer=initializer, nrun=2)
    b = ct.vb_factorize(sp.csr_matrix(x), backend="sparse",
                        sparse_layout="ell", device="cpu", **kw)
    c = ct.vb_factorize(sp.csr_matrix(x), backend="sparse",
                        sparse_layout="tile", device="cpu", **kw)
    _same_vb(b, c)
    if initializer == "random":
        return
    a = cf.vb_factorize(sp.csr_matrix(x), backend="sparse",
                        sparse_layout="ell", dtype=jnp.float64, **kw)
    np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                               rtol=1e-8)
    for k in range(len(a.ranks)):
        np.testing.assert_allclose(b.basis[k], np.asarray(a.basis[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("m,initializer", [(30, "random"), (32, "svd2")])
def test_vb_factorize_ell_mesh_matches_one_device(m, initializer):
    """JAX's test_vb_factorize_ell_mesh_matches_single_device on the
    port (cells=4 on the CPU, the CSR shards of 'tile', which the mesh
    run equals bit for bit); from the SVD start, on extents the mesh
    divides, also against JAX's ELL mesh run."""
    rng = np.random.default_rng(3)
    x = (rng.random((20, m)) < 0.4) * rng.poisson(3.0, (20, m))
    x = x.astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    kw = dict(ranks=[3], nrun=2, Itmax=50, verbose=0, seed=4,
              backend="sparse", sparse_layout="ell", initializer=initializer)
    mesh4 = ct.make_mesh(cells=4, devices=["cpu"] * 4)
    res_m = ct.vb_factorize(sp.csr_matrix(x), device="cpu", mesh=mesh4, **kw)
    res_1 = ct.vb_factorize(sp.csr_matrix(x), device="cpu", **kw)
    np.testing.assert_allclose(res_m.measure["lml"], res_1.measure["lml"],
                               rtol=1e-9)
    np.testing.assert_allclose(res_m.coeff[0], res_1.coeff[0], rtol=1e-7)
    tile_m = ct.vb_factorize(sp.csr_matrix(x), device="cpu", mesh=mesh4,
                             **dict(kw, sparse_layout="tile"))
    _same_vb(res_m, tile_m)
    if initializer == "random":
        return
    j = cf.vb_factorize(sp.csr_matrix(x), dtype=jnp.float64,
                        mesh=cf.make_mesh(cells=4,
                                          devices=jax.devices()[:4]), **kw)
    np.testing.assert_allclose(res_m.measure["lml"], j.measure["lml"],
                               rtol=1e-8)
    np.testing.assert_allclose(res_m.coeff[0], np.asarray(j.coeff[0]),
                               rtol=1e-6)


def test_factorize_ell_matches_jax_and_tile(monkeypatch):
    monkeypatch.setattr(ml_driver, "initial_factors", jax_draws)
    x = sp.csr_matrix(cf.simulate_whx(nrow=30, ncol=50, rank=3,
                                      seed=31)["x"])
    kw = dict(ranks=[2, 3], nrun=2, Itmax=150, seed=2, verbose=0,
              backend="sparse", sparse_layout="ell")
    a = cf.factorize(cf.SCSet(count=x), **kw)
    b = ct.factorize(ct.SCSet(count=x), device="cpu", **kw)
    _same_ml(a, b)
    c = ct.factorize(ct.SCSet(count=x), device="cpu",
                     **dict(kw, sparse_layout="tile"))
    assert b.measure.equals(c.measure)
    for u, v in zip(b.basis + b.coeff, c.basis + c.coeff):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("driver,kw,match", [
    ("vb", dict(elbo_every=2), "elbo_every"),
    ("vb", dict(precision="bf16"), "bf16"),
    ("ml", dict(randomize=True), "randomize"),
    ("ml", dict(mesh=True), "single-device"),
])
def test_ell_refusals_match_jax(driver, kw, match):
    """The four options JAX's ELL scans refuse raise the same
    ValueError in both packages."""
    x = sp.csr_matrix(_driver_x())
    for pkg, mesh in ((cf, lambda: cf.make_mesh(
            cells=2, devices=jax.devices()[:2])),
            (ct, lambda: ct.make_mesh(cells=2, devices=["cpu"] * 2))):
        args = dict(kw, mesh=mesh()) if "mesh" in kw else dict(kw)
        if pkg is ct:
            args["device"] = "cpu"
        fn = pkg.vb_factorize if driver == "vb" else pkg.factorize
        with pytest.raises(ValueError, match=match):
            fn(pkg.SCSet(count=x), ranks=[2], verbose=0, backend="sparse",
               sparse_layout="ell", Itmax=5, **args)


def test_ell_compaction_and_resume_are_bit_exact(tmp_path):
    x = sp.csr_matrix(cf.simulate_whx(nrow=30, ncol=50, rank=3,
                                      seed=2)["x"])
    kw = dict(ranks=[2, 3, 4], nrun=2, verbose=0, Itmax=400, seed=4,
              device="cpu", backend="sparse", sparse_layout="ell")
    a = ct.vb_factorize(x, **kw)
    b = ct.vb_factorize(x, compact_every=40, **kw)
    c = ct.vb_factorize(x, checkpoint_every=30,
                        checkpoint_dir=str(tmp_path), **kw)
    for other in (b, c):
        _same_vb(a, other)
        assert (a.metadata["timings"][0]["n_iter"]
                == other.metadata["timings"][0]["n_iter"])
    assert os.listdir(tmp_path) == []


def test_ell_two_processes_equal_one():
    """Two processes (threads standing for them, both packages' seams
    patched alike) each return the one-process run bit for bit, and
    JAX's two-process ELL run at the driver tolerances."""
    x = sp.csr_matrix(_driver_x(seed=12))
    run = dict(ranks=[2, 3, 4], initializer="svd2", Itmax=80, verbose=0,
               backend="sparse", sparse_layout="ell")
    got = threads_as_processes(2, lambda p: ct.vb_factorize(
        ct.SCSet(count=x), device="cpu", _process_count=2, _process_id=p,
        **run), tsched)
    want = threads_as_processes(2, lambda p: cf.vb_factorize(
        cf.SCSet(count=x), dtype=jnp.float64, _process_count=2,
        _process_id=p, **run), jsched)
    one = ct.vb_factorize(ct.SCSet(count=x), device="cpu", **run)
    for b, a in zip(got, want):
        _same_vb(one, b)
        np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                                   rtol=1e-8)


# ---------------------------------------------------------------------
# the dense routes' products: each lane's bits whatever the lane count
# ---------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lane_matmul_lanes_alone(chunk, dtype, monkeypatch):
    """A lane subset of lane_matmul's products, and of the dense passes
    built on them, has the full batch's bits, on a shape whose lane
    slices are not aligned (37 x 53), at one lane a product and at 4
    (7 lanes: two windows that share a lane; fewer lanes: padded)."""
    monkeypatch.setattr(utils, "LANE_MATMUL_CHUNK", chunk)
    rng = np.random.default_rng(8)
    n, m, r, nb = 37, 53, 5, 7
    x = torch.tensor(rng.poisson(2.0, (n, m)) + 1.0, dtype=dtype)
    lw = torch.tensor(rng.gamma(1.0, 1.0, (nb, n, r)), dtype=dtype)
    lh = torch.tensor(rng.gamma(1.0, 1.0, (nb, r, m)), dtype=dtype)
    full = utils.lane_matmul(lw, lh)
    np.testing.assert_allclose(full.numpy(), (lw @ lh).numpy(), rtol=1e-6)
    fns = {"fused_dense": tvb.fused_dense,
           "suffstats_dense": tvb.suffstats_dense,
           "elbo_data_term": tvb.elbo_data_term,
           "ml_h_dense": tml.ml_h_dense, "ml_w_dense": tml.ml_w_dense,
           "likelihood": lambda x_, w, h: tml.likelihood(x_, w, h, 0.0)}
    wants = {k: f(x, lw, lh) for k, f in fns.items()}
    for lanes in ([1], [4], [1, 4], [6, 0, 3]):
        sel = torch.tensor(lanes)
        assert torch.equal(utils.lane_matmul(lw[sel], lh[sel]), full[sel])
        for k, f in fns.items():
            got, want = f(x, lw[sel], lh[sel]), wants[k]
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(g, w[sel]), (k, lanes)
    # a lone 2-D pair is one product
    assert torch.equal(utils.lane_matmul(lw[2], lh[2]), lw[2] @ lh[2])
