"""The port's sparse layout and passes (ccfindr_tpu_torch.ops.tile and
the plain versions of S1/S2 in ops.kernels.sparse, over ops.sparse's
chunked COO pass) against the JAX package's (ccfindr_tpu.ops.sparse,
ops.tile), at float64 on the CPU.

The JAX tile kernel runs in Pallas interpret mode, as tests/test_tile.py
runs it, with ``quantile=0.5`` so that its COO overflow tail takes part;
the JAX side is single-lane and is looped over the port's lanes.
Tolerance: 1e-10 relative (the same sums in another order).  Converged
loops as tests/test_torch_vb.py holds them: lml 1e-9, factors 1e-7 and
equal sweep counts.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.special import gammaln

import jax
import jax.numpy as jnp

from ccfindr_tpu.ops import ml as jml
from ccfindr_tpu.ops import sparse as jsk
from ccfindr_tpu.ops import tile as jtk
from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu_torch.ops import ml as tml
from ccfindr_tpu_torch.ops import sparse as tsk
from ccfindr_tpu_torch.ops import tile as ttk
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.ops.kernels import sparse as spk

torch.set_num_threads(2)

RTOL = 1e-10


def _problem(n=40, m=60, nb=3, r=4, density=0.15, seed=0, hot_rows=3):
    """A ragged sparse X (a few dense rows, so that the JAX layout's
    overflow tail fills at quantile 0.5) and ``nb`` lanes of gamma
    factors ``lw (nb, n, r)``, ``lh (nb, r, m)``."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(3.0, (n, m))
    x = x.astype(np.float64)
    x[:hot_rows] = rng.poisson(2.0, (hot_rows, m))
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    lw = rng.gamma(1.0, 1.0, (nb, n, r))
    lh = rng.gamma(1.0, 1.0, (nb, r, m))
    return sp.csr_matrix(x), lw, lh


def _values(csr, integer):
    """``csr`` itself (integer counts: the layout stores int16), or a
    copy with 0.25 added to every nonzero (the factor dtype)."""
    if integer:
        return csr
    out = csr.copy()
    out.data = out.data + 0.25
    return out


def _close(got, want, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0, err_msg=what)


@pytest.mark.parametrize("integer", [True, False])
def test_tile_layout_round_trips_to_scipy(integer):
    csr = _values(_problem(seed=3)[0], integer)
    csr.data[5] = 0.0                      # an explicit zero is dropped
    tc = ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
    assert tc.val.dtype == (torch.int16 if integer else torch.float64)
    ref = sp.csr_matrix(csr)
    ref.eliminate_zeros()
    assert tc.nnz == ref.nnz and (tc.n, tc.m) == ref.shape
    assert (tc.to_scipy() != ref).nnz == 0
    # the CSC view: column pointers, row indices and the permutation
    csc = ref.tocsc()
    np.testing.assert_array_equal(tc.colptr.numpy(), csc.indptr)
    np.testing.assert_array_equal(tc.row.numpy(), csc.indices)
    np.testing.assert_array_equal(tc.val.double().numpy()[tc.perm.numpy()],
                                  csc.data)
    np.testing.assert_array_equal(tc.col.numpy()[tc.perm.numpy()],
                                  np.repeat(np.arange(ref.shape[1]),
                                            np.diff(csc.indptr)))
    # .val holds each nonzero once, as the JAX layout's .val does
    jt = jtk.from_scipy_tile(ref, dtype=jnp.float64, quantile=0.5)
    assert jt.trow.shape[0] > 0
    lg_j = float(jnp.sum(gammaln(jt.val + 1.0)))
    _close(float(torch.lgamma(tc.val.double() + 1.0).sum()), lg_j)


def test_tile_layout_keeps_empty_rows_and_wide_values():
    x = np.zeros((6, 5))
    x[0, 1], x[3, 4], x[5, 0] = 2.0, 40000.0, 1.5
    tc = ttk.from_dense_tile(x, dtype=torch.float64, device="cpu")
    assert tc.val.dtype == torch.float64   # not integers below 2**15
    np.testing.assert_array_equal(tc.indptr.numpy(), [0, 1, 1, 1, 2, 2, 3])
    assert (tc.to_scipy() != sp.csr_matrix(x)).nnz == 0
    tc16 = ttk.from_dense_tile(np.minimum(x, 7).round(), dtype=torch.float32,
                               device="cpu")
    assert tc16.val.dtype == torch.int16


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("integer", [True, False])
def test_fused_tile_matches_jax(nb, integer):
    csr, lw, lh = _problem(nb=nb, seed=nb)
    csr = _values(csr, integer)
    tc = ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
    swn, shn, dterm = ttk.fused_tile(tc, torch.as_tensor(lw),
                                     torch.as_tensor(lh))
    jt = jtk.from_scipy_tile(csr, dtype=jnp.float64, quantile=0.5)
    js = jsk.from_scipy(csr, dtype=jnp.float64)
    assert swn.shape == lw.shape and shn.shape == lh.shape
    assert dterm.shape == (nb,)
    for b in range(nb):
        for name, fn, x in (("tile", jtk.fused_tile, jt),
                            ("coo", jsk.fused_coo, js)):
            sw_j, sh_j, d_j = fn(x, jnp.asarray(lw[b]), jnp.asarray(lh[b]))
            _close(swn[b], sw_j, what=f"swn {name} lane {b}")
            _close(shn[b], sh_j, what=f"shn {name} lane {b}")
            _close(float(dterm[b]), float(d_j), what=f"dterm {name} {b}")


def test_plain_passes_match_jax_over_chunks(monkeypatch):
    """The chunked COO passes behind the plain S1/S2, with chunks much
    smaller than nnz, against the JAX package's COO scan; the column
    pass over the row pass's ``a`` gives the row pass's own ``shn``."""
    monkeypatch.setattr(tsk, "CHUNK", 97)
    csr, lw, lh = _problem(nb=2, seed=5)
    tc = ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
    assert tc.nnz > 3 * tsk.CHUNK
    lw_t, lh_t = torch.as_tensor(lw), torch.as_tensor(lh)
    lht = lh_t.transpose(-1, -2).contiguous()
    rows = tc.csr_rows()
    swn, shn_t, a, xlog = tsk.coo_pass(rows, tc.col, tc.val, lw_t, lht,
                                       m=tc.m, want_a=True)
    shn = shn_t.transpose(-1, -2)
    assert torch.equal(tsk.coo_colpass(rows, tc.col, a, lw_t, tc.m), shn_t)
    dterm = tsk.fold_dterm(swn, shn, lw_t, lh_t, xlog)
    js = jsk.from_scipy(csr, dtype=jnp.float64)
    for b in range(2):
        sw_j, sh_j, d_j = jsk.fused_coo(js, jnp.asarray(lw[b]),
                                        jnp.asarray(lh[b]))
        _close(swn[b], sw_j, what="swn")
        _close(shn[b], sh_j, what="shn")
        _close(float(dterm[b]), float(d_j), what="dterm")


@pytest.mark.parametrize("nb", [1, 3])
def test_tile_ml_phases_match_jax(nb):
    csr, w, h = _problem(nb=nb, seed=7 + nb)
    tc = ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
    jt = jtk.from_scipy_tile(csr, dtype=jnp.float64, quantile=0.5)
    fh, fw = ttk.make_tile_ml_backend()
    hn, xlog = fh(tc, torch.as_tensor(w), torch.as_tensor(h))
    wn = fw(tc, torch.as_tensor(w), torch.as_tensor(h))
    assert hn.shape == h.shape and wn.shape == w.shape
    assert xlog.dtype == torch.float64 and xlog.shape == (nb,)
    for b in range(nb):
        hn_j, xlog_j = jtk.tile_ml_h(jt, jnp.asarray(w[b]),
                                     jnp.asarray(h[b]))
        wn_j = jtk.tile_ml_w(jt, jnp.asarray(w[b]), jnp.asarray(h[b]))
        _close(hn[b], hn_j, what="hn")
        _close(float(xlog[b]), float(xlog_j), what="xlog")
        _close(wn[b], wn_j, what="wn")


def test_row_pass_skips_xlog_only_where_asked():
    """do_elbo = 0 zeroes a lane's x log wth and leaves swn, a and shn
    as they were; the ML subsets of the row pass agree with the full
    pass."""
    csr, lw, lh = _problem(nb=3, seed=11)
    tc = ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
    lw_t = torch.as_tensor(lw)
    lht = torch.as_tensor(lh).transpose(-1, -2).contiguous()
    swn, a, xlog = spk.rowpass(tc, lw_t, lht)
    flags = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float64)
    swn0, a0, xlog0 = spk.rowpass(tc, lw_t, lht, do_elbo=flags)
    assert torch.equal(swn0, swn) and torch.equal(a0, a)
    assert float(xlog0[1]) == 0.0 and float(xlog[1]) != 0.0
    assert torch.equal(xlog0[[0, 2]], xlog[[0, 2]])
    assert torch.equal(spk.colpass(tc, a0, lw_t), spk.colpass(tc, a, lw_t))
    f_on = ttk.fused_tile(tc, lw_t, torch.as_tensor(lh))
    f_off = ttk.fused_tile(tc, lw_t, torch.as_tensor(lh), do_elbo=flags)
    assert torch.equal(f_on[0], f_off[0]) and torch.equal(f_on[1], f_off[1])
    wn, a2, x2 = spk.rowpass(tc, lw_t, lht, want_a=False, want_xlog=False)
    assert a2 is None and x2 is None and torch.equal(wn, swn)
    s3, a3, x3 = spk.rowpass(tc, lw_t, lht, want_swn=False)
    assert s3 is None and torch.equal(a3, a) and torch.equal(x3, xlog)


def test_sparse_wrappers_refuse_what_the_kernels_do_not_take():
    csr, lw, lh = _problem(nb=2, seed=12)
    tc = ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
    lw_t = torch.as_tensor(lw)
    lht = torch.as_tensor(lh).transpose(-1, -2).contiguous()
    with pytest.raises(ValueError, match="do not match"):
        spk.rowpass(tc, lw_t, lht.float())
    with pytest.raises(ValueError, match="rank"):
        spk.rowpass(tc, lw_t.new_ones(2, tc.n, 129),
                    lht.new_ones(2, tc.m, 129))
    with pytest.raises(ValueError, match="contiguous"):
        spk.rowpass(tc, lw_t, torch.as_tensor(lh).transpose(-1, -2))
    with pytest.raises(ValueError, match="a must be"):
        spk.colpass(tc, torch.ones(2, tc.nnz - 1, dtype=torch.float64),
                    lw_t)
    with pytest.raises(TypeError, match="float32 or float64"):
        spk.rowpass(tc, lw_t.half(), lht.half())
    # the launchers take CUDA tensors only; nothing falls back
    with pytest.raises(ValueError, match="CUDA tensors"):
        spk.sp_rowpass(tc, lw_t, lht)
    with pytest.raises(ValueError, match="CUDA tensors"):
        spk.sp_colpass(tc, torch.zeros(2, tc.nnz, dtype=torch.float64),
                       lw_t)
    tc.val = tc.val.to(torch.int8)
    with pytest.raises(TypeError, match="values"):
        spk.rowpass(tc, lw_t, lht)


def _state0(n, m, r, nb, seed):
    rng = np.random.default_rng(seed)
    w = rng.gamma(1.0, 1.0, (nb, n, r))
    h = rng.gamma(1.0, 1.0, (nb, r, m))
    return jvb.VBState(ew=w, eh=h * 1.1, lw=w * 0.9, lh=h,
                       dw=np.zeros_like(w), dh=np.zeros_like(h),
                       lkh=np.full(nb, -np.inf))


def test_loop_scalars_take_lgamma_over_val():
    """The hoisted sum lgamma(x+1) from a sparse layout's .val equals the
    dense sum (the repair of ops.vb._loop_scalars)."""
    st = tvb.state_from_numpy(_state0(40, 60, 3, 2, 1), device="cpu")
    for integer in (True, False):       # int16 and float64 values
        csr = _values(_problem(seed=13)[0], integer)
        dense = tvb._loop_scalars(torch.as_tensor(csr.toarray()), st, None,
                                  1e-5, None, 1)[2]
        want = gammaln(csr.toarray() + 1.0).sum()
        layout = ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
        lgx = tvb._loop_scalars(layout, st, None, 1e-5, None, 1)[2]
        assert lgx.dtype == torch.float64
        _close(float(lgx), float(dense))
        _close(float(lgx), want)


def test_likelihood_const_takes_val():
    """The ML constant sum_{x>0}(-x log x + x) from a sparse layout's
    .val equals the dense sum and the JAX package's over its .val."""
    for integer in (True, False):       # int16 and float64 values
        csr = _values(_problem(seed=14)[0], integer)
        dense = tml.likelihood_const(torch.as_tensor(csr.toarray()))
        jt = jtk.from_scipy_tile(csr, dtype=jnp.float64, quantile=0.5)
        want = float(jml.likelihood_const(jt.val))
        layout = ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
        got = tml.likelihood_const(layout, torch.float64)
        _close(float(got), float(dense))
        _close(float(got), want)


@pytest.mark.parametrize("elbo_every", [1, 5])
def test_vb_run_over_tile_matches_jax(elbo_every):
    """The deferred-ELBO loop over the tile layout, ``elbo_every`` 1 and
    5, lane-batched in the port against one JAX vb_run per lane over
    the JAX tile layout; the states are carried by state_from_numpy."""
    n, m, r = 18, 26, 3
    ranks = [2, 3]
    rng = np.random.default_rng(21)
    wf, hf = rng.gamma(0.8, 1.0, (n, r)), rng.gamma(0.8, 1.0, (r, m))
    x = rng.poisson(wf @ hf * 0.6 / (wf @ hf).mean()).astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    csr = sp.csr_matrix(x)
    st = _state0(n, m, r, len(ranks), 22)
    rmask = np.stack([(np.arange(r) < k).astype(np.float64) for k in ranks])
    kw = dict(itmax=120, tol=1e-6, elbo_every=elbo_every)
    out_t = tvb.vb_run(
        ttk.from_scipy_tile(csr, dtype=torch.float64, device="cpu"),
        tvb.state_from_numpy(st, device="cpu"),
        tvb.Hyper(*(torch.ones(len(ranks), dtype=torch.float64),) * 4),
        fused=ttk.make_tile_fused(), rank_mask=torch.as_tensor(rmask),
        r_true=torch.tensor(ranks, dtype=torch.float64), **kw)
    o = tvb.state_to_numpy(out_t)
    jt = jtk.from_scipy_tile(csr, dtype=jnp.float64, quantile=0.5)
    for b, rk in enumerate(ranks):
        st_b = jax.tree.map(lambda a: jnp.asarray(a[b]), st)
        oj = jvb.vb_run(jt, st_b, jvb.Hyper(*(jnp.asarray(1.0),) * 4),
                        fused=jtk.make_tile_fused(),
                        rank_mask=jnp.asarray(rmask[b]), r_true=float(rk),
                        **kw)
        assert int(o.n_iter[b]) == int(oj.n_iter), b
        assert bool(o.done[b]) == bool(oj.done)
        np.testing.assert_allclose(o.lml[b], float(oj.lml), rtol=1e-9)
        for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
            np.testing.assert_allclose(getattr(o.state, f)[b],
                                       np.asarray(getattr(oj.state, f)),
                                       rtol=1e-7, err_msg=f)
    if elbo_every > 1:
        assert all(int(k) % elbo_every == 0 or not d
                   for k, d in zip(o.n_iter, o.done))


def test_vb_run_over_tile_matches_dense():
    """The fused loop over the tile layout with non-integer values (kept
    in the factor dtype) equals the dense two-pass and fused loops."""
    n, m = 16, 22
    rng = np.random.default_rng(31)
    x = rng.poisson(1.0, (n, m)).astype(np.float64)
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    x[x > 0] += 0.5
    st = tvb.state_from_numpy(_state0(n, m, 2, 2, 32), device="cpu")
    hy = tvb.Hyper(*(torch.ones(2, dtype=torch.float64),) * 4)
    tc = ttk.from_dense_tile(x, dtype=torch.float64, device="cpu")
    assert tc.val.dtype == torch.float64
    kw = dict(itmax=80, tol=1e-6)
    dense = tvb.vb_run(torch.as_tensor(x), st, hy, **kw)
    fused = tvb.vb_run(torch.as_tensor(x), st, hy, fused=tvb.fused_dense,
                       **kw)
    tile = tvb.vb_run(tc, st, hy, fused=ttk.make_tile_fused(), **kw)
    for got in (fused, tile):
        assert torch.equal(got.n_iter, dense.n_iter)
        _close(got.lml, dense.lml, rtol=1e-9)
        _close(got.state.ew, dense.state.ew, rtol=1e-7)
