"""The JAX package's sparse capacity configuration on the port
(examples/oversize_sparse_torch.py), at small shapes on the CPU in
float64: the matrix equals bench.py's, bench.py's sweep body on the
'tile' and 'ell' layouts equals JAX's (1e-9 relative on the factors,
1e-10 on lkh, five sweeps), the sparse rank scan equals JAX's in every
layout (the same sweeps, lml to 1e-9), S1/S2's lane groups keep each
lane's bits, and the script imports no JAX.  The full shape runs on the
card (chip_smoke.py phase 24)."""

import importlib.util
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
from ccfindr_tpu.ops import ell as jek
from ccfindr_tpu.ops import tile as jtk
from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu_torch.drivers import vb_driver
from ccfindr_tpu_torch.ops import ell as tek
from ccfindr_tpu_torch.ops import tile as ttk
from ccfindr_tpu_torch.ops.kernels import sol
from ccfindr_tpu_torch.ops.kernels import sparse as spk

torch.set_num_threads(2)
F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "oversize_sparse_torch.py")
SMALL = dict(n=256, m=2048, r=16, density=0.08, tile=4)   # no empty row


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def demo():
    return _load("oversize_sparse_torch", SCRIPT)


@pytest.fixture(scope="module")
def small(demo):
    return demo.oversize_matrix(**SMALL, verbose=False)


@pytest.mark.parametrize("shape", [
    dict(n=256, m=2048, r=4, density=0.05, tile=16),
    dict(n=2100, m=650, r=3, density=0.1, tile=5),
    dict(n=64, m=96, r=16, density=0.02, tile=3)])
def test_oversize_matrix_is_benchs(demo, monkeypatch, tmp_path, shape):
    """The same CSR as bench.py's (its disk cache sent to a temporary
    directory): data, indices and indptr equal, of the same types."""
    bench = _load("bench_for_oversize", os.path.join(ROOT, "bench.py"))
    monkeypatch.setattr(bench, "_BENCH_CACHE", str(tmp_path))
    want = bench._oversize_matrix(shape["n"], shape["m"], shape["r"],
                                  shape["density"], shape["tile"])
    got = demo.oversize_matrix(**shape, verbose=False)
    assert got.shape == want.shape and got.nnz == want.nnz > 0
    for f in ("data", "indices", "indptr"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _jax_sweeps(fused, x, csr, lgx, k):
    """bench.py:383-393's body on JAX's layout, from bench.py's draws,
    jitted as bench.py's sweep loop runs it."""
    n, m = csr.shape
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.gamma(1.0, 1.0, (n, 4)), jnp.float64)
    h = jnp.asarray(rng.gamma(1.0, 1.0, (4, m)), jnp.float64)
    st = jvb.VBState(ew=w, eh=h, lw=w, lh=h, dw=jnp.zeros_like(w),
                     dh=jnp.zeros_like(h),
                     lkh=jnp.asarray(-jnp.inf, jnp.float64))
    hy = jvb.Hyper(*(jnp.asarray(1.0, jnp.float64),) * 4)
    fudge = jnp.asarray(np.finfo(np.float32).eps, jnp.float64)
    @jax.jit
    def body(xx, st, hy):
        swn, shn, dterm = fused(xx, st.lw, st.lh)
        new, pending = jvb.posterior_update(st.lw * swn, st.lh * shn, st,
                                            hy, fudge, lgx)
        hy2, _ = jvb.hyper_update((True,) * 4, new, hy)
        return new._replace(lkh=(pending + dterm)
                            / (float(n) * float(m))), hy2

    lkh = []
    for _ in range(k):
        st, hy = body(x, st, hy)
        lkh.append(float(st.lkh))
    return st, lkh


@pytest.mark.parametrize("layout", ["tile", "ell"])
def test_sweep_body_matches_jax(demo, small, layout):
    """Five sweeps of bench.py's body (fused pass, posterior_update,
    hyper_update) on the port's layout against JAX's."""
    n, m = small.shape
    lgx = demo.lgamma_sum(small)
    if layout == "tile":
        jx, jf = jtk.from_scipy_tile(small, dtype=jnp.float64), \
            jtk.make_tile_fused()
        tx, tf = ttk.from_scipy_tile(small, dtype=F64, device="cpu"), \
            ttk.make_tile_fused()
    else:
        jx, jf = jek.from_scipy_ell(small, dtype=jnp.float64), \
            jek.make_ell_fused()
        tx, tf = tek.from_scipy_ell(small, dtype=F64, device="cpu"), \
            tek.make_ell_fused()
    jst, jl = _jax_sweeps(jf, jx, small, lgx, 5)
    st, hy = demo.initial_state(n, m, 4, F64, "cpu")
    tst, _, tl = demo.sweeps(tf, tx, st, hy, lgx, 5, n, m)
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        assert _rel(getattr(tst, f)[0], getattr(jst, f)) <= 1e-9, f
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    assert np.isfinite(tl).all() and tl[-1] > tl[0]
    assert demo.layout_bytes(tx) > 0


def _jax_vb_draws(n, m, rank_max, nb, seed=0):
    """The JAX batched driver's random starts (its key stream), lane by
    lane, as port states."""
    key = jax.random.PRNGKey(seed)
    _, sub = jax.random.split(key)
    keys = jax.random.split(sub, nb)
    h1 = jvb.Hyper(aw=1.0, bw=1.0, ah=1.0, bh=1.0)
    return [jvb.vb_init_random(k, n, m, rank_max, h1, jnp.float64)
            for k in keys]


SCAN = dict(ranks=[2, 3, 4], nrun=2, Itmax=40, Tol=1e-5, backend="sparse",
            verbose=0, seed=0)


@pytest.fixture(scope="module")
def jax_scans(small):
    """JAX's rank scan on the tiled matrix in each sparse layout."""
    return {layout: cf.vb_factorize(small, dtype=jnp.float64,
                                    sparse_layout=layout, **SCAN)
            for layout in ("tile", "ell", "coo")}


def _same_scan(got, want):
    """The same lane-sweeps and lml to 1e-9."""
    for k in ("total_sweeps", "lane_sweeps_executed"):
        assert got.metadata["timings"][0][k] == \
            want.metadata["timings"][0][k], k
    np.testing.assert_allclose(got.measure["lml"], want.measure["lml"],
                               rtol=1e-9)


@pytest.mark.parametrize("layout", ["tile", "ell", "coo"])
def test_rank_scan_matches_jax(demo, small, jax_scans, monkeypatch, layout):
    """vb_factorize(backend='sparse', ranks [2, 3, 4], nrun 2) through
    run() on the tiled matrix from JAX's random starts: every layout
    (one CSR layout on the port) gives JAX's tile scan, the same
    lane-sweeps and lml to 1e-9, and the same layout's scan of JAX.
    JAX's ELL scan stops its first lane (rank 2) after one sweep with
    lml 0 on this matrix, where its ELL pass agrees with the tile pass
    (test_sweep_body_matches_jax): a fault of the JAX package's ELL
    scan, so its rank 2 and its sweep counts are not held."""
    n, m = small.shape
    draws = iter(_jax_vb_draws(n, m, 4, 6))

    def jax_draw(gen, n_, m_, rank, hyper, dtype, device):
        return ct.ops.vb.VBState(*(torch.as_tensor(np.array(f),
                                                   dtype=dtype)
                                   for f in next(draws)))

    monkeypatch.setattr(vb_driver.vb_ops, "vb_init_random", jax_draw)
    b, summary = demo.run(small, ranks=SCAN["ranks"], nrun=SCAN["nrun"],
                          itmax=SCAN["Itmax"], tol=SCAN["Tol"],
                          layout=layout, device="cpu")
    assert summary["lanes"] == 6 and summary["lml_finite"]
    assert summary["lane_sweeps"] == \
        b.metadata["timings"][0]["lane_sweeps_executed"]
    assert summary["ropt"] == ct.optimal_rank(b)["ropt"] == \
        cf.optimal_rank(jax_scans["tile"])["ropt"]
    _same_scan(b, jax_scans["tile"])
    if layout == "ell":
        np.testing.assert_allclose(
            np.asarray(b.measure["lml"])[1:],
            np.asarray(jax_scans["ell"].measure["lml"])[1:], rtol=1e-9)
    else:
        _same_scan(b, jax_scans[layout])


@pytest.mark.parametrize("which", ["tiled", "empty rows and columns"])
def test_csc_order_is_scipys_conversion(small, which):
    """The CSC order that a layout builds by a stable sort of its
    columns on its device (ops.tile._csc_order) is scipy's CSC
    conversion of the CSR positions, array for array."""
    import scipy.sparse as sp

    csr = small
    if which != "tiled":
        rng = np.random.default_rng(3)
        x = (rng.random((60, 90)) < 0.2) * rng.integers(1, 9, (60, 90))
        x[[0, 17, 59]] = 0
        x[:, [0, 44, 89]] = 0
        csr = sp.csr_matrix(x)
    tc = ttk.from_scipy_tile(csr, dtype=F64, device="cpu")
    pos = sp.csr_matrix((np.arange(tc.nnz, dtype=np.int64),
                         tc.col.numpy(), tc.indptr.numpy()),
                        shape=(tc.n, tc.m)).tocsc()
    for got, want, dt in ((tc.colptr, pos.indptr, torch.int64),
                          (tc.row, pos.indices, torch.int32),
                          (tc.perm, pos.data, torch.int32)):
        assert got.dtype == dt
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt", [F64, torch.float32])
def test_ell_layout_of_the_tiled_matrix_is_jaxs(small, dt):
    """The ELL slots and tails that the port fills on the layout's
    device (ops.ell._ell_fields) are JAX's from_scipy_ell arrays, field
    for field, with overflow tails on both sides."""
    jdt = jnp.float64 if dt == F64 else jnp.float32
    j = jek.from_scipy_ell(small, dtype=jdt, quantile=0.5, lane=8)
    t = tek.from_scipy_ell(small, dtype=dt, quantile=0.5, lane=8,
                           device="cpu")
    assert t.gtrow.numel() > 0 and t.ctrow.numel() > 0
    for f in tek._FIELDS:
        want, got = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, f)


def test_whole_selection_is_the_fancy_index(small):
    """SCSet[every row, every column], which the drivers take for their
    result, gives the arrays of scipy's fancy indexing (a plain copy, not
    a view); a partial selection still goes through it."""
    import scipy.sparse as sp

    s = ct.SCSet(count=small, remove_zeros=False)
    n, m = small.shape
    for i, j in ((np.arange(n), np.arange(m)), (slice(None), slice(None)),
                 (np.arange(n), np.arange(m)[::-1]),
                 (np.arange(n - 1), np.arange(m))):
        got = s[i, j].counts
        ii = np.arange(n)[i] if isinstance(i, slice) else i
        jj = np.arange(m)[j] if isinstance(j, slice) else j
        want = small[ii][:, jj]
        assert isinstance(got, sp.csr_matrix) and got.shape == want.shape
        for f in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    whole = s[np.arange(n), np.arange(m)].counts
    assert whole is not s.counts and not np.shares_memory(whole.data,
                                                          s.counts.data)


def test_lane_groups_keep_each_lanes_bits(small, monkeypatch):
    """With a group cap of two lanes' a, five lanes run S1/S2 in groups
    of 1, 2 and 2 (consecutive, sizes differing by one at most) and give
    the bits of the ungrouped batch, on the plain versions; a pass runs
    once a group."""
    tc = ttk.from_scipy_tile(small, dtype=F64, device="cpu")
    rng = np.random.default_rng(7)
    lw = torch.as_tensor(rng.gamma(1.0, 1.0, (5, small.shape[0], 4)))
    lh = torch.as_tensor(rng.gamma(1.0, 1.0, (5, 4, small.shape[1])))
    do = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0], dtype=F64)
    whole = ttk.fused_tile(tc, lw, lh, do_elbo=do)
    lane_bytes = tc.nnz * 8
    monkeypatch.setattr(sol, "LANE_GROUP_BYTES", 2 * lane_bytes)
    groups = spk.lane_groups(5, tc.nnz, 8)
    assert groups == [slice(0, 1), slice(1, 3), slice(3, 5)]
    calls = []
    orig = spk.rowpass

    def counted(tc_, lw_, *a, **k):
        calls.append(lw_.shape[0])
        return orig(tc_, lw_, *a, **k)

    monkeypatch.setattr(spk, "rowpass", counted)
    grouped = ttk.fused_tile(tc, lw, lh, do_elbo=do)
    assert calls == [g.stop - g.start for g in groups]
    live = do > 0
    for w, g in zip(whole[:2], grouped[:2]):
        assert torch.equal(w, g)
    # the data term is read only where do_elbo is set
    assert torch.equal(whole[2][live], grouped[2][live])


def test_script_imports_no_jax():
    """examples/oversize_sparse_torch.py and the port import no JAX: the
    script's functions run in a process where JAX cannot be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith(('jax.', 'jaxlib',\n"
        "                                            'ccfindr_tpu.')) \\\n"
        "                or name == 'ccfindr_tpu':\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('d', {SCRIPT!r})\n"
        "d = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(d)\n"
        "x = d.oversize_matrix(n=64, m=96, r=16, density=0.3, tile=3,\n"
        "                      verbose=False)\n"
        "f, s = d.run(x, ranks=[2, 3], nrun=1, itmax=3, device='cpu')\n"
        "assert s['lml_finite'], s\n"
        "assert not any(k == 'jax' or k.startswith('jax.')\n"
        "               for k in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
