"""The port's public names and defaults against the JAX package's, by
``inspect.signature``, and what the JAX keywords the port accepts do
(nothing that changes a result) on the CPU at float64."""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import jax

from ccfindr_tpu.data import generate as jgen
from ccfindr_tpu.ops import ell as jek
from ccfindr_tpu.ops import rsvd as jrsvd
from ccfindr_tpu.ops import sparse as jsk
from ccfindr_tpu.ops import tile as jtile
from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu.ops.pallas import epilogue as jep
from ccfindr_tpu.ops.pallas import ml_kernels as jmlk
from ccfindr_tpu.ops.pallas import sol as jsol
from ccfindr_tpu.ops.pallas import vb_kernels as jvbk
from ccfindr_tpu.parallel import mesh as jmesh
from ccfindr_tpu.parallel import schedule as jsched
from ccfindr_tpu.parallel import sharded as jsh
from ccfindr_tpu_torch.data import generate as tgen
from ccfindr_tpu_torch.ops import ell as tek
from ccfindr_tpu_torch.ops import rsvd as trsvd
from ccfindr_tpu_torch.ops import sparse as tsk
from ccfindr_tpu_torch.ops import tile as ttile
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.ops.kernels import epilogue as tep
from ccfindr_tpu_torch.ops.kernels import ml as tmlk
from ccfindr_tpu_torch.ops.kernels import sol as tsol
from ccfindr_tpu_torch.ops.kernels import vb_kernels as tvbk
from ccfindr_tpu_torch.parallel import mesh as tmesh
from ccfindr_tpu_torch.parallel import schedule as tsched
from ccfindr_tpu_torch.parallel import sharded as tsh

# the port's own additions to a JAX signature: the device it places on,
# and the chunk that pins a kernel's order of partial sums
PORT_ONLY = {"device", "chunk"}
# dtype defaults are each framework's float32
FRAMEWORK_DEFAULTS = {"dtype"}


@pytest.mark.parametrize("jfn,tfn", [
    (jvb.vb_init_svd, tvb.vb_init_svd),
    (jmlk.ml_h_pallas, tmlk.ml_h_pallas),
    (jmlk.ml_w_pallas, tmlk.ml_w_pallas),
    (jmlk.make_ml_backend, tmlk.make_ml_backend),
    (jtile.from_scipy_tile, ttile.from_scipy_tile),
    (jtile.from_dense_tile, ttile.from_dense_tile),
    (jsol.sol_sweep, tsol.sol_sweep),
    (jsol.sol_sweep, tsol.sol_sweep_plain),
    (jsol.vb_run_sol, tsol.vb_run_sol),
    (jep.vb_run_epi, tep.vb_run_epi),
    (jep.posterior_update_pallas, tep.posterior_update_pallas),
    (jvbk.fused_pallas_raw, tvbk.fused_pallas_raw),
    (jvbk.suffstats_pallas, tvbk.suffstats_pallas),
    (jvbk.suffstats_pallas_padded, tvbk.suffstats_pallas_padded),
    (jvbk.make_pallas_backend, tvbk.make_pallas_backend),
    (jvbk.elbo_data_pallas, tvbk.elbo_data_pallas),
    (jvbk.elbo_data_pallas_padded, tvbk.elbo_data_pallas_padded),
    (jvbk.pad_matrix, tvbk.pad_matrix),
    (jvbk.fold_dterm, tvbk.fold_dterm),
    (jvbk.fused_pallas, tvbk.fused_pallas),
    (jvbk.fused_pallas_padded, tvbk.fused_pallas_padded),
    (jvbk.make_fused_backend, tvbk.make_fused_backend),
    (jrsvd.randomized_svd, trsvd.randomized_svd),
    (jrsvd.coo_matmul, trsvd.coo_matmul),
    (jrsvd.coo_rmatmul, trsvd.coo_rmatmul),
    (jsk.SparseCounts, tsk.SparseCounts),
    (jsk.from_scipy, tsk.from_scipy),
    (jsk.from_dense, tsk.from_dense),
    (jsk.from_scipy_sharded, tsk.from_scipy_sharded),
    (jsk.lgamma_term, tsk.lgamma_term),
    (jsk.suffstats_coo, tsk.suffstats_coo),
    (jsk.elbo_data_coo, tsk.elbo_data_coo),
    (jsk.fused_coo, tsk.fused_coo),
    (jsk.make_sparse_fused, tsk.make_sparse_fused),
    (jsk.make_sparse_backend, tsk.make_sparse_backend),
    (jtile.from_scipy_tile_sharded, ttile.from_scipy_tile_sharded),
    (jsh.make_fused_sharded, tsh.make_fused_sharded),
    (jsh.make_sparse_fused_sharded, tsh.make_sparse_fused_sharded),
    (jsh.make_ell_fused_sharded, tsh.make_ell_fused_sharded),
    (jsh.make_tile_fused_sharded, tsh.make_tile_fused_sharded),
    (jsh.make_tile_ml_sharded, tsh.make_tile_ml_sharded),
    (jsh.make_ml_sharded, tsh.make_ml_sharded),
    (jsched.partition_items, tsched.partition_items),
    (jsched.rank_run_grid, tsched.rank_run_grid),
    (jsched.gather_results, tsched.gather_results),
    (jsched.gather_rows, tsched.gather_rows),
    (jsched.exchange_winner, tsched.exchange_winner),
    (jsched._allgather, tsched._allgather),
    (jmesh.init_distributed, tmesh.init_distributed),
    (jek.EllCounts, tek.EllCounts),
    (jek.from_scipy_ell, tek.from_scipy_ell),
    (jek.from_dense_ell, tek.from_dense_ell),
    (jek.from_scipy_ell_sharded, tek.from_scipy_ell_sharded),
    (jek.fused_ell, tek.fused_ell),
    (jek.make_ell_fused, tek.make_ell_fused),
    (jek.ell_ml_h, tek.ell_ml_h),
    (jek.ell_ml_w, tek.ell_ml_w),
    (jek.make_ell_ml_backend, tek.make_ell_ml_backend),
    (jgen.build, tgen.build),
    (jgen.write, tgen.write),
], ids=lambda f: f.__module__.split(".")[0] + "." + f.__name__)
def test_signature_matches_jax(jfn, tfn):
    """Every JAX parameter is the port's, of the same kind, in the same
    order and with the same default; the port adds only ``device`` and
    ``chunk`` (``chunk`` keyword-only where JAX has none: the COO API and
    ``make_sparse_fused_sharded`` take JAX's own ``chunk``)."""
    jp = inspect.signature(jfn).parameters
    tp = inspect.signature(tfn).parameters
    assert [k for k in tp if k not in PORT_ONLY or k in jp] == list(jp)
    if "chunk" in tp and "chunk" not in jp:
        assert tp["chunk"].kind == inspect.Parameter.KEYWORD_ONLY
    for name, p in jp.items():
        assert tp[name].kind == p.kind, name
        if name not in FRAMEWORK_DEFAULTS:
            assert tp[name].default == p.default, name


def test_dtype_defaults_are_float32():
    for fn in (tvb.vb_init_svd, ttile.from_scipy_tile, ttile.from_dense_tile):
        assert inspect.signature(fn).parameters["dtype"].default \
            == torch.float32
    for fn in (jvb.vb_init_svd, jtile.from_scipy_tile, jtile.from_dense_tile):
        assert inspect.signature(fn).parameters["dtype"].default \
            == jnp.float32


@pytest.mark.parametrize("variant", ["svd", "svd2"])
def test_vb_init_svd_auto_is_exact_below_4096(variant):
    rng = np.random.default_rng(3)
    x = rng.poisson(2.0, (40, 60)).astype(np.float64)
    hy = tvb.Hyper(1.0, 1.0, 1.0, 1.0)
    a = tvb.vb_init_svd(x, 3, hy, variant=variant, dtype=torch.float64,
                        device="cpu")
    b = tvb.vb_init_svd(x, 3, hy, variant=variant, dtype=torch.float64,
                        method="exact", device="cpu")
    assert torch.equal(a.lw, b.lw) and torch.equal(a.lh, b.lh)
    j = jvb.vb_init_svd(x, 3, jvb.Hyper(1.0, 1.0, 1.0, 1.0), variant=variant,
                        dtype=jnp.float64)
    np.testing.assert_allclose(a.lw.numpy(), np.asarray(j.lw), rtol=1e-8,
                               atol=1e-12)


def _jax_omega(m, k, dtype, seed, device):
    om = jax.random.normal(jax.random.PRNGKey(seed), (m, k), jnp.float64)
    return torch.as_tensor(np.array(om), dtype=dtype, device=device)


@pytest.mark.parametrize("shape", [(4097, 4100), (5000, 4097)])
def test_vb_init_svd_auto_takes_randomized_above_4096(shape, monkeypatch):
    """Above 4096 on the short axis 'auto' picks the randomized SVD (it
    raised before ROADMAP A8): the port's 'auto' is its 'randomized', bit
    for bit, and with JAX's test matrix it is JAX's 'auto' start
    (1e-8 relative at float64)."""
    x = sp.random(*shape, density=1e-3, random_state=0, format="csr")
    hy = tvb.Hyper(1.0, 1.0, 1.0, 1.0)
    a = tvb.vb_init_svd(x, 3, hy, dtype=torch.float64, device="cpu")
    b = tvb.vb_init_svd(x, 3, hy, dtype=torch.float64, method="randomized",
                        device="cpu")
    assert torch.equal(a.lw, b.lw) and torch.equal(a.lh, b.lh)
    monkeypatch.setattr(trsvd, "_draw_omega", _jax_omega)
    c = tvb.vb_init_svd(x, 3, hy, dtype=torch.float64, device="cpu")
    j = jvb.vb_init_svd(x, 3, jvb.Hyper(1.0, 1.0, 1.0, 1.0),
                        dtype=jnp.float64)
    for f in ("lw", "lh"):
        want = np.asarray(getattr(j, f))
        np.testing.assert_allclose(getattr(c, f).numpy(), want, rtol=0,
                                   atol=1e-8 * np.abs(want).max(),
                                   err_msg=f)


def test_ml_pallas_names_take_padded_x():
    """ml_h_pallas/ml_w_pallas (and make_ml_backend(bn, bm)) equal
    ml_h/ml_w on X and on X zero-padded by pad_matrix."""
    rng = np.random.default_rng(5)
    n, m, r = 37, 150, 4
    x = torch.tensor(rng.poisson(2.0, (n, m)).astype(np.float64))
    w = torch.tensor(rng.gamma(1.0, 1.0, (2, n, r)))
    h = torch.tensor(rng.gamma(1.0, 1.0, (2, r, m)))
    hn, xl = tmlk.ml_h(x, w, h)
    wn = tmlk.ml_w(x, w, h)
    xp = tmlk.pad_matrix(x, 8, 128)
    assert xp.shape == (40, 256)
    for xx in (x, xp):
        hn2, xl2 = tmlk.ml_h_pallas(xx, w, h, bn=8, bm=128)
        assert torch.equal(hn2, hn) and torch.equal(xl2, xl)
        assert torch.equal(tmlk.ml_w_pallas(xx, w, h), wn)
    fh, fw = tmlk.make_ml_backend(bn=8, bm=128)
    assert torch.equal(fh(x, w, h)[0], hn) and torch.equal(fw(x, w, h), wn)
    with pytest.raises(ValueError, match="shape mismatch"):
        tmlk.ml_h_pallas(x[:30], w, h)


def test_tile_layout_keywords_change_nothing():
    rng = np.random.default_rng(6)
    x = (rng.random((30, 50)) < 0.2) * rng.poisson(3.0, (30, 50))
    csr = sp.csr_matrix(x.astype(np.float64))
    a = ttile.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
    b = ttile.from_scipy_tile(csr, dtype=torch.float64, bn=8, bm=128,
                              quantile=0.5, kt_cap=8, pack=False,
                              device="cpu")
    c = ttile.from_dense_tile(x, dtype=torch.float64, device="cpu", bn=8,
                              quantile=0.5)
    for t in (b, c):
        for f in ("indptr", "col", "val", "colptr", "row", "perm"):
            assert torch.equal(getattr(t, f), getattr(a, f)), f
        assert (t.n, t.m) == (a.n, a.m)


@pytest.mark.parametrize("nb,n,r,m", [(1, 5, 5, 5), (3, 7, 4, 9)])
def test_fold_dterm_takes_jax_order(nb, n, r, m):
    """vb_kernels.fold_dterm(swn, shn, lw, lh, xlog) is JAX's fold, lane
    by lane, at float64.  The square case (B 1, n = r = m) is one where
    an order with xlog third would broadcast and return a wrong number
    without raising."""
    rng = np.random.default_rng(n + m)
    swn, lw = rng.gamma(1.0, 1.0, (2, nb, n, r))
    shn, lh = rng.gamma(1.0, 1.0, (2, nb, r, m))
    xlog = rng.normal(size=nb)
    got = tvbk.fold_dterm(*(torch.tensor(a) for a in (swn, shn, lw, lh,
                                                      xlog)))
    assert got.shape == (nb,) and got.dtype == torch.float64
    for b in range(nb):
        want = float(jvbk.fold_dterm(jnp.asarray(swn[b]), jnp.asarray(shn[b]),
                                     jnp.asarray(lw[b]), jnp.asarray(lh[b]),
                                     jnp.asarray(xlog[b])))
        np.testing.assert_allclose(float(got[b]), want, rtol=1e-12)


def test_vb_run_sol_takes_jax_tiles():
    """A JAX-style call, vb_run_sol(x_pad, st, hy, bn=1024, bm=512), runs
    on CPU tensors and equals the call without tiles, bit for bit; so
    does vb_run_epi's."""
    rng = np.random.default_rng(8)
    n, m, r = 24, 31, 3
    x = torch.tensor(rng.poisson(2.0, (n, m)).astype(np.float64))
    gen = torch.Generator().manual_seed(1)
    hy1 = tvb.Hyper(1.0, 1.0, 1.0, 1.0)
    sts = [tvb.vb_init_random(gen, n, m, r, hy1, torch.float64, "cpu")
           for _ in range(2)]
    st = tvb.VBState(*(torch.stack(f) for f in zip(*sts)))
    hy = tvb.Hyper(*(torch.ones(2, dtype=torch.float64),) * 4)
    for run in (tsol.vb_run_sol, tep.vb_run_epi):
        a = run(x, st, hy, itmax=15)
        b = run(x, st, hy, bn=1024, bm=512, itmax=15)
        assert torch.equal(a.n_iter, b.n_iter) and torch.equal(a.lml, b.lml)
        for f in ("lw", "lh", "ew", "eh"):
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
