"""The port's COO API (ops/sparse.py: SparseCounts, from_scipy,
from_dense, from_scipy_sharded, lgamma_term, suffstats_coo,
elbo_data_coo, fused_coo, make_sparse_fused, make_sparse_backend)
against the JAX package's, at float64 on the CPU.  The passes are
ops.tile.fused_tile's over the CSR view SparseCounts.csr: here the plain
versions of S1/S2, on the card the kernels (held against the CPU by
tests/test_torch_kernels.py).

JAX's functions take one lane (vmapped in its loops); the port's take a
lane batch and JAX's unbatched factors alike.  Tolerances: layouts
exact; the passes 1e-12 relative (the port's plain pass scatters in
another order than JAX's scan).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.ops import sparse as jsk
from ccfindr_tpu_torch.ops import sparse as tsk
from ccfindr_tpu_torch.ops import tile as ttile

torch.set_num_threads(2)

F64 = torch.float64


def _csr(n, m, seed, density=0.25):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(3.0, (n, m))
    return sp.csr_matrix(x.astype(np.float64))


def _factors(nb, n, m, r, seed):
    rng = np.random.default_rng(seed)
    return rng.gamma(1.0, 1.0, (nb, n, r)), rng.gamma(1.0, 1.0, (nb, r, m))


def _close(got, want, what="", scale=None):
    """1e-12 relative to ``want``'s largest entry, or to ``scale`` for a
    sum whose terms cancel (the data term at rank 1 is 0 up to
    rounding: S/wth = log wth there)."""
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12 * scale, err_msg=what)


@pytest.mark.parametrize("chunk", [8, 1 << 16])
def test_layouts_match_jax(chunk):
    csr = _csr(17, 23, 1)
    for jl, tl in ((jsk.from_scipy(csr, dtype=jnp.float64, chunk=chunk),
                    tsk.from_scipy(csr, dtype=F64, chunk=chunk,
                                   device="cpu")),
                   (jsk.from_dense(csr.toarray(), dtype=jnp.float64,
                                   chunk=chunk),
                    tsk.from_dense(csr.toarray(), dtype=F64, chunk=chunk,
                                   device="cpu"))):
        for f in ("row", "col", "val"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)), f)
        assert (tl.n, tl.m) == (jl.n, jl.m)
    assert tl.row.shape[0] % chunk == 0 and tl.val.dtype == F64


@pytest.mark.parametrize("n_shards,m_pad", [(2, None), (3, 27), (4, 24)])
def test_from_scipy_sharded_matches_jax(n_shards, m_pad):
    csr = _csr(11, 23, 2)
    j = jsk.from_scipy_sharded(csr, n_shards, m_pad=m_pad,
                               dtype=jnp.float64, chunk=8)
    t = tsk.from_scipy_sharded(csr, n_shards, m_pad=m_pad, dtype=F64,
                               chunk=8, device="cpu")
    assert len(t) == n_shards and t.n == j.n and t.m == j.m
    for s, shard in enumerate(t):
        assert (shard.n, shard.m) == (j.n, j.m)
        for f in ("row", "col", "val"):
            np.testing.assert_array_equal(getattr(shard, f).numpy(),
                                          np.asarray(getattr(j, f))[s], f)
    # the whole X's nonzeros in the one-device order, for the loops' sums
    np.testing.assert_array_equal(t.val.numpy(), csr.tocoo().data)
    with pytest.raises(ValueError, match="not divisible"):
        tsk.from_scipy_sharded(csr, 2, m_pad=25, device="cpu")


def test_csr_view_is_the_tile_layout():
    """SparseCounts.csr holds the same CSR and CSC permutation as
    from_scipy_tile (dummies and explicit zeros dropped), whatever the
    order of the COO entries."""
    csr = _csr(19, 31, 3)
    coo = csr.tocoo()
    perm = np.random.default_rng(0).permutation(coo.nnz)
    row = np.r_[coo.row[perm], [19, 19, 4]].astype(np.int32)
    col = np.r_[coo.col[perm], [31, 31, 5]].astype(np.int32)
    val = np.r_[coo.data[perm], [0.0, 0.0, 0.0]]
    sc = tsk.SparseCounts(torch.tensor(row), torch.tensor(col),
                          torch.tensor(val), 19, 31)
    view = sc.csr
    ref = ttile.from_scipy_tile(csr, dtype=F64, device="cpu")
    for f in ("indptr", "col", "colptr", "row", "perm"):
        assert torch.equal(getattr(view, f), getattr(ref, f).to(
            getattr(view, f).dtype)), f
    assert torch.equal(view.val, ref.val.to(F64))
    assert sc.csr is view


@pytest.mark.parametrize("nb,r", [(1, 1), (3, 4)])
def test_passes_match_jax(nb, r):
    csr = _csr(21, 34, 4)
    n, m = csr.shape
    lw, lh = _factors(nb, n, m, r, seed=nb + r)
    jx = jsk.from_scipy(csr, dtype=jnp.float64, chunk=16)
    tx = tsk.from_scipy(csr, dtype=F64, chunk=16, device="cpu")
    tlw, tlh = torch.tensor(lw), torch.tensor(lh)
    # the data term's scale: its summands x (S/wth - log wth)
    big = 10.0 * float(csr.sum())
    sw, sh = tsk.suffstats_coo(tx, tlw, tlh, chunk=16)
    dt = tsk.elbo_data_coo(tx, tlw, tlh, chunk=16)
    swn, shn, dterm = tsk.fused_coo(tx, tlw, tlh, chunk=16)
    fswn, fshn, fdterm = tsk.make_sparse_fused(chunk=16)(tx, tlw, tlh)
    ss, de = tsk.make_sparse_backend(chunk=16)
    bsw, bsh = ss(tx, tlw, tlh)
    for b in range(nb):
        a = (jnp.asarray(lw[b]), jnp.asarray(lh[b]))
        jsw, jsh = jsk.suffstats_coo(jx, *a, chunk=16)
        jswn, jshn, jdterm = jsk.fused_coo(jx, *a, chunk=16)
        jdt = jsk.elbo_data_coo(jx, *a, chunk=16)
        _close(sw[b], jsw, "sw")
        _close(sh[b], jsh, "sh")
        _close(bsw[b], jsw, "backend sw")
        _close(bsh[b], jsh, "backend sh")
        _close(dt[b], jdt, "elbo_data", big)
        _close(de(tx, tlw, tlh)[b], jdt, "backend elbo_data", big)
        _close(swn[b], jswn, "swn")
        _close(shn[b], jshn, "shn")
        _close(dterm[b], jdterm, "dterm", big)
        for got, want in ((fswn, swn), (fshn, shn), (fdterm, dterm)):
            assert torch.equal(got, want)
        # and the unbatched call of JAX's signature
        one = tsk.fused_coo(tx, tlw[b], tlh[b], chunk=16)
        _close(one[2], jdterm, "unbatched dterm", big)
        assert one[0].shape == (n, r)
    _close(tsk.lgamma_term(tx), jsk.lgamma_term(jx), "lgamma")


def test_fused_coo_is_fused_tile():
    """fused_coo's plain pass is the CSR backend's on the same nonzeros:
    with the COO in row-major order, bit for bit."""
    csr = _csr(25, 40, 6)
    lw, lh = (torch.tensor(a) for a in _factors(2, 25, 40, 3, seed=6))
    a = tsk.fused_coo(tsk.from_scipy(csr, dtype=F64, device="cpu"), lw, lh)
    b = ttile.fused_tile(ttile.from_scipy_tile(csr, dtype=F64,
                                               device="cpu"), lw, lh)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_vb_factorize_coo_is_the_tile_run():
    """sparse_layout='coo' runs the CSR layout of 'tile' (fused_coo is
    fused_tile over a CSR view of the same nonzeros): the same run bit
    for bit, elbo_every included, which JAX's COO scan refuses; bf16,
    which JAX's COO scan refuses too, raises as there (the tile run's
    bf16 layout flags JAX's tile overflow tail, which COO has not)."""
    x = cf.simulate_whx(nrow=20, ncol=30, rank=2, seed=3)["x"]
    with pytest.raises(ValueError, match="bf16"):
        ct.vb_factorize(x, ranks=[2, 3], verbose=0, Itmax=20,
                        backend="sparse", sparse_layout="coo", device="cpu",
                        precision="bf16")
    for kw in ({}, dict(elbo_every=2)):
        a, b = (ct.vb_factorize(x, ranks=[2, 3], verbose=0, Itmax=20,
                                backend="sparse", sparse_layout=layout,
                                device="cpu", **kw)
                for layout in ("coo", "tile"))
        assert np.isfinite(a.measure["lml"]).all()
        np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
        for u, v in zip(a.basis + a.coeff, b.basis + b.coeff):
            np.testing.assert_array_equal(u, v)
