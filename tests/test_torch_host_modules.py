"""The host modules the port copies from the JAX package: the writers
``write_mtx``/``write_10x`` and the native MatrixMarket parser
(``ccfindr_tpu_torch/native``), the interop bridges, ``profile_trace``
and the NumPy oracle ``ops/reference_impl.py``, against their JAX twins
on the CPU.

Files written by the two packages are compared byte for byte; matrices
read back exactly.  The port's plain sweeps are held against the port's
own oracle at the tolerances tests/test_vb_kernel.py uses for JAX
(one sweep 1e-10, hypers 1e-7, ten sweeps 1e-8 / 1e-9).
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.special import gammaln

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.ops import reference_impl as jref
from ccfindr_tpu_torch import native
from ccfindr_tpu_torch.ops import ml as tml
from ccfindr_tpu_torch.ops import reference_impl as tref
from ccfindr_tpu_torch.ops import vb as tvb

torch.set_num_threads(2)


def _counts(n, m, seed, real=False):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < 0.3) * rng.poisson(4.0, (n, m))
    x[0, :] += 1
    x[:, 0] += 1
    x = x.astype(np.float64)
    if real:
        x = x * 0.37
    return sp.csr_matrix(x)


def _set(mat, seed=0):
    n, m = mat.shape
    return ct.SCSet(count=mat, row_data=[f"g{i}" for i in range(n)],
                    col_data=[f"c{j}" for j in range(m)],
                    remove_zeros=False)


@pytest.mark.parametrize("real", [False, True])
def test_write_mtx_matches_jax_and_round_trips(tmp_path, real):
    mat = _counts(23, 31, 1, real)
    ct.write_mtx(str(tmp_path / "t.mtx"), mat)
    cf.write_mtx(str(tmp_path / "j.mtx"), mat)
    assert filecmp.cmp(tmp_path / "t.mtx", tmp_path / "j.mtx",
                       shallow=False)
    back = ct.read_mtx(str(tmp_path / "t.mtx"))
    if real:
        np.testing.assert_allclose(back.toarray(), mat.toarray(),
                                   rtol=1e-9)
    else:
        np.testing.assert_array_equal(back.toarray(), mat.toarray())
    field = open(tmp_path / "t.mtx").readline().split()[3]
    assert field == ("real" if real else "integer")


def test_native_parser_builds_into_the_port_and_matches_python(
        tmp_path, monkeypatch):
    """g++ builds mmio.cpp into ccfindr_tpu_torch/_build (never next to
    the sources or into the JAX package), and its parse equals the NumPy
    route's, for integer and real files."""
    assert shutil.which("g++") is not None
    lib = native.get_lib()
    assert lib is not None
    so = native._lib_path()
    assert so.parent.name == "_build" and so.parent.parent.name == \
        "ccfindr_tpu_torch" and so.exists()
    for real in (False, True):
        mat = _counts(40, 55, 2, real)
        path = str(tmp_path / f"x{int(real)}.mtx")
        cf.write_mtx(path, mat)
        fast = ct.read_mtx(path)
        monkeypatch.setattr(native, "get_lib", lambda: None)
        slow = ct.read_mtx(path)
        monkeypatch.undo()
        assert fast.dtype == slow.dtype
        np.testing.assert_array_equal(fast.toarray(), slow.toarray())
        np.testing.assert_array_equal(
            fast.toarray(), cf.read_mtx(path).toarray())


@pytest.mark.parametrize("version", [2, 3])
def test_write_10x_matches_jax_and_round_trips(tmp_path, version):
    mat = _counts(18, 26, 3)
    s = _set(mat)
    ct.write_10x(s, str(tmp_path / "t"), version=version)
    cf.write_10x(cf.SCSet(count=mat, row_data=s.row_data,
                          col_data=s.col_data, remove_zeros=False),
                 str(tmp_path / "j"), version=version)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    for name in names:
        a, b = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith(".gz"):
            import gzip
            assert gzip.open(a).read() == gzip.open(b).read(), name
        else:
            assert filecmp.cmp(a, b, shallow=False), name
    back = ct.read_10x(str(tmp_path / "t"), remove_zeros=False)
    np.testing.assert_array_equal(back.counts_dense(), mat.toarray())
    assert list(back.row_data.iloc[:, 0]) == list(s.row_data.iloc[:, 0])
    assert list(back.col_data.iloc[:, 0]) == list(s.col_data.iloc[:, 0])


def test_package_exports_match_jax():
    for name in ("write_mtx", "write_10x", "to_anndata", "from_anndata",
                 "read_h5ad", "write_h5ad", "read_10x_h5"):
        assert callable(getattr(ct, name)) and name in ct.__all__
        assert name in cf.__all__


def test_interop_without_anndata_raises_import_error(tmp_path):
    try:
        import anndata  # noqa: F401
        pytest.skip("anndata is installed")
    except ImportError:
        pass
    s = _set(_counts(4, 5, 0))
    with pytest.raises(ImportError, match="anndata"):
        ct.to_anndata(s)
    with pytest.raises(ImportError, match="anndata"):
        ct.write_h5ad(s, str(tmp_path / "a.h5ad"))
    with pytest.raises(ImportError, match="anndata"):
        ct.read_h5ad(str(tmp_path / "a.h5ad"))


@pytest.mark.parametrize("layout", ["v3", "v2"])
def test_read_10x_h5_matches_jax(tmp_path, layout):
    h5py = pytest.importorskip("h5py")
    mat = _counts(12, 9, 4)
    csc = sp.csc_matrix(mat)
    path = str(tmp_path / "m.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("matrix" if layout == "v3" else "GRCh38")
        for k, v in (("data", csc.data.astype(np.int32)),
                     ("indices", csc.indices), ("indptr", csc.indptr),
                     ("shape", np.asarray(csc.shape)),
                     ("barcodes", np.array([f"bc{j}".encode()
                                            for j in range(9)]))):
            g.create_dataset(k, data=v)
        ids = np.array([f"ENSG{i}".encode() for i in range(12)])
        names = np.array([f"G{i}".encode() for i in range(12)])
        if layout == "v3":
            feat = g.create_group("features")
            feat.create_dataset("id", data=ids)
            feat.create_dataset("name", data=names)
            feat.create_dataset("feature_type",
                                data=np.array([b"Gene Expression"] * 12))
        else:
            g.create_dataset("genes", data=ids)
            g.create_dataset("gene_names", data=names)
    t, j = ct.read_10x_h5(path), cf.read_10x_h5(path)
    assert isinstance(t, ct.SCSet)
    np.testing.assert_array_equal(t.counts_dense(), j.counts_dense())
    np.testing.assert_array_equal(t.counts_dense(), mat.toarray())
    assert t.row_data.equals(j.row_data) and t.col_data.equals(j.col_data)


def test_profile_trace_writes_a_trace(tmp_path):
    from ccfindr_tpu_torch.utils import Timings, profile_trace

    assert Timings is ct.utils.Timings
    with profile_trace(str(tmp_path / "trace")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert "aten::mm" in {e.key for e in prof.key_averages()}


def _problem(n, m, r, seed):
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, (n, m)).astype(np.float64)
    return x, rng.gamma(1.0, 1.0, (n, r)), rng.gamma(1.0, 1.0, (r, m))


def test_reference_impl_is_jax_oracle():
    """The port's copy of the oracle computes what JAX's does, bit for
    bit, on each of its four functions."""
    x, w, h = _problem(13, 11, 3, 0)
    a = tref.vb_sweep_np(x, w, h, w * 1.1, h * 0.9, 1.1, 0.9, 1.2, 0.8)
    b = jref.vb_sweep_np(x, w, h, w * 1.1, h * 0.9, 1.1, 0.9, 1.2, 0.8)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for mask in ((True,) * 4, (False, True, False, True)):
        np.testing.assert_array_equal(
            tref.hyper_update_np(mask, a["lw"], a["lh"], a["ew"], a["eh"],
                                 1.0, 1.0, 1.0, 1.0),
            jref.hyper_update_np(mask, a["lw"], a["lh"], a["ew"], a["eh"],
                                 1.0, 1.0, 1.0, 1.0))
    for u, v in zip(tref.ml_sweep_np(x, w, h), jref.ml_sweep_np(x, w, h)):
        np.testing.assert_array_equal(u, v)
    assert tref.likelihood_np(x, w, h) == jref.likelihood_np(x, w, h)


def _tstate(w, h):
    t = torch.as_tensor
    return tvb.VBState(ew=t(w), eh=t(h), lw=t(w), lh=t(h),
                       dw=t(np.zeros_like(w)), dh=t(np.zeros_like(h)),
                       lkh=t(-np.inf))


def test_port_vb_sweep_matches_its_oracle():
    """tests/test_vb_kernel.py's oracle checks on the port: one sweep
    (1e-10), ten sweeps (1e-8 on ew, 1e-9 on the ELBO) and the hyper
    update (1e-7)."""
    x, lw, lh = _problem(23, 17, 4, 0)
    eps = torch.tensor(np.finfo(np.float64).eps, dtype=torch.float64)
    lgx = float(gammaln(x + 1.0).sum())
    ones = tvb.Hyper(*(torch.tensor(1.0, dtype=torch.float64),) * 4)
    out = tvb.vb_sweep(torch.as_tensor(x), _tstate(lw, lh), ones, eps, lgx)
    exp = tref.vb_sweep_np(x, lw.copy(), lh.copy(), lw.copy(), lh.copy(),
                           1.0, 1.0, 1.0, 1.0)
    for name in ("ew", "eh", "lw", "lh", "dw", "dh"):
        np.testing.assert_allclose(getattr(out, name).numpy(), exp[name],
                                   rtol=1e-10, err_msg=name)
    np.testing.assert_allclose(float(out.lkh), exp["lkh"], rtol=1e-10)

    x, lw, lh = _problem(31, 29, 3, 1)
    lgx = float(gammaln(x + 1.0).sum())
    hy = tvb.Hyper(*(torch.tensor(v, dtype=torch.float64)
                     for v in (0.7, 1.3, 0.9, 0.8)))
    st = _tstate(lw, lh)
    np_st = dict(lw=lw.copy(), lh=lh.copy(), ew=lw.copy(), eh=lh.copy())
    for _ in range(10):
        st = tvb.vb_sweep(torch.as_tensor(x), st, hy, eps, lgx)
        np_out = tref.vb_sweep_np(x, np_st["lw"], np_st["lh"], np_st["ew"],
                                  np_st["eh"], 0.7, 1.3, 0.9, 0.8)
        np_st = {k: np_out[k] for k in ("lw", "lh", "ew", "eh")}
    np.testing.assert_allclose(st.ew.numpy(), np_st["ew"], rtol=1e-8)
    np.testing.assert_allclose(float(st.lkh), np_out["lkh"], rtol=1e-9)

    new, failed = tvb.hyper_update((True,) * 4, st, hy)
    want = tref.hyper_update_np((True,) * 4, st.lw.numpy(), st.lh.numpy(),
                                st.ew.numpy(), st.eh.numpy(), 0.7, 1.3, 0.9,
                                0.8)
    assert not bool(failed)
    np.testing.assert_allclose([float(v) for v in new], want, rtol=1e-7)


def test_port_ml_sweep_matches_its_oracle():
    x, w, h = _problem(19, 23, 3, 2)
    eps = torch.tensor(np.finfo(np.float64).eps, dtype=torch.float64)
    tw, th = tml.ml_sweep(torch.as_tensor(x), torch.as_tensor(w),
                          torch.as_tensor(h), eps)
    ew, eh = tref.ml_sweep_np(x, w, h)
    np.testing.assert_allclose(tw.numpy(), ew, rtol=1e-12)
    np.testing.assert_allclose(th.numpy(), eh, rtol=1e-12)
    pos = x > 0
    const = float((-x[pos] * np.log(x[pos]) + x[pos]).sum())
    np.testing.assert_allclose(
        float(tml.likelihood(torch.as_tensor(x), tw, th, const)),
        tref.likelihood_np(x, ew, eh), rtol=1e-12)
