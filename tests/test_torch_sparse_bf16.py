"""``precision='bf16'`` on the sparse backend: the plain versions of
S1/S2 in their mxu_bf16 mode (ccfindr_tpu_torch.ops.tile.fused_tile)
and vb_factorize against the JAX package's tile kernel, which runs here
in Pallas interpret mode, at float32 (bf16 rounds a float32 operand).

Tolerances, relative: one pass 2e-3 on swn/shn and 1e-5 on the data
term, with or without the JAX layout's overflow tail: the JAX kernel
leaves the tail's operands unrounded (``ccfindr_tpu/ops/tile.py:
611-621``), and so does the port at the nonzeros its bf16 layout flags
(``ops.tile.TileCounts.tail``, the same set as JAX's ``trow``/``tcol``,
held exactly below); vb_factorize lml 1e-4 after five sweeps (the bf16
loop tolerance of tests/test_torch_epilogue.py).
The CUDA kernels are held against these plain versions on the card at
the float32 tolerances (tests/test_torch_kernels.py, chip_smoke.py
phase 15).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.ops import tile as jtk
from ccfindr_tpu_torch.ops import sparse as tsk
from ccfindr_tpu_torch.ops import tile as ttk
from ccfindr_tpu_torch.ops.kernels import sol as tsol
from ccfindr_tpu_torch.ops.kernels import sparse as spk

torch.set_num_threads(2)
F32 = torch.float32


def _problem(n=40, m=60, nb=3, r=5, seed=0):
    """A ragged sparse X with three dense rows (at quantile 0.5 the JAX
    layout's overflow tail fills) and ``nb`` lanes of gamma factors."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < 0.15) * rng.poisson(3.0, (n, m))
    x = x.astype(np.float64)
    x[:3] = rng.poisson(2.0, (3, m))
    x[x.sum(axis=1) == 0, 0] += 1
    x[0, x.sum(axis=0) == 0] += 1
    lw = rng.gamma(1.0, 1.0, (nb, n, r))
    lh = rng.gamma(1.0, 1.0, (nb, r, m))
    return sp.csr_matrix(x), lw, lh


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _skewed(n=300, m=400, heavy=3, seed=5):
    """Light rows of at most 8 nonzeros and ``heavy`` dense rows: at the
    default quantile (0.99) the JAX layout's slot width is 8 and the
    dense rows overflow into its tail."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, m))
    for i in range(n):
        k = m if i < heavy else int(rng.integers(1, 9))
        cols = rng.choice(m, k, replace=False)
        x[i, cols] = rng.integers(1, 6, k)
    x[0, x.sum(axis=0) == 0] += 1
    return sp.csr_matrix(x)


def _tail_set(rows, cols):
    return set(zip(np.asarray(rows).tolist(), np.asarray(cols).tolist()))


def _port_tail(tc, col0=0):
    """(gene, cell) of the nonzeros a port layout flags."""
    if tc.tail is None:
        return set()
    keep = tc.tail.bool()
    return _tail_set(tc.csr_rows()[keep], tc.col[keep].long() + col0)


@pytest.mark.parametrize("quantile,kt_cap,bm", [
    (0.99, 64, None), (0.5, 64, None), (0.9, 64, None), (0.5, 8, None),
    (0.75, 16, 16), (1.0, 64, None)])
def test_tail_membership_matches_jax(quantile, kt_cap, bm):
    """The nonzeros a bf16 layout flags are JAX's overflow tail exactly,
    over the width's quantile and cap and the cell block; quantile 1
    under a cap above the widest group (128 cells a block) and the
    float32 layout have none."""
    for csr in (_problem()[0], _skewed()):
        tc = ttk._flag_bf16_tail(ttk.from_scipy_tile(
            csr, dtype=F32, bm=bm, quantile=quantile, kt_cap=kt_cap,
            device="cpu"))
        jt = jtk.from_scipy_tile(csr, dtype=jnp.float32, bm=bm,
                                 quantile=quantile, kt_cap=kt_cap)
        want = _tail_set(jt.trow, jt.tcol)
        assert _port_tail(tc) == want
        assert (tc.tail is None) == (not want)
        if tc.tail is not None:
            assert tc.tail.dtype == torch.uint8
            assert int(tc.tail.sum()) == len(want)
        # the float32 layout has no tail, and the flags change nothing else
        plain = ttk.from_scipy_tile(csr, dtype=F32, bm=bm,
                                    quantile=quantile, device="cpu")
        assert plain.tail is None
        for f in ("indptr", "col", "val", "colptr", "row", "perm"):
            assert torch.equal(getattr(plain, f), getattr(tc, f))
    assert ttk._flag_bf16_tail(ttk.from_scipy_tile(
        _skewed(), dtype=F32, quantile=1.0, kt_cap=128,
        device="cpu")).tail is None


@pytest.mark.parametrize("n_shards,quantile", [(2, 0.99), (3, 0.5),
                                               (2, 1.0)])
def test_sharded_tail_membership_matches_jax(n_shards, quantile):
    """Each shard flags the nonzeros of JAX's stacked tail of that shard
    (one width from all shards' groups, blocks from the local cells)."""
    csr = _skewed(m=401)
    shards = ttk._flag_bf16_tail(ttk.from_scipy_tile_sharded(
        csr, n_shards, dtype=F32, quantile=quantile, device="cpu"))
    jt = jtk.from_scipy_tile_sharded(csr, n_shards, dtype=jnp.float32,
                                     quantile=quantile)
    m_loc = shards.m
    total = 0
    for s, tc in enumerate(shards):
        tr, tcl = np.asarray(jt.trow[s]), np.asarray(jt.tcol[s])
        real = tr < csr.shape[0]
        want = _tail_set(tr[real], tcl[real] + s * m_loc)
        assert _port_tail(tc, s * m_loc) == want
        total += len(want)
    assert total > 0


@pytest.mark.parametrize("quantile,tol,dtol", [(1.0, 2e-3, 1e-5),
                                               (0.5, 2e-3, 1e-5)])
def test_bf16_pass_matches_jax(quantile, tol, dtol):
    csr, lw, lh = _problem()
    tc = ttk._flag_bf16_tail(ttk.from_scipy_tile(
        csr, dtype=F32, quantile=quantile, device="cpu"))
    swn, shn, dterm = ttk.fused_tile(tc, torch.tensor(lw, dtype=F32),
                                     torch.tensor(lh, dtype=F32),
                                     mxu_bf16=True)
    jt = jtk.from_scipy_tile(csr, dtype=jnp.float32, quantile=quantile)
    assert (jt.trow.shape[0] > 0) == (quantile < 1.0)
    for b in range(lw.shape[0]):
        js, jh, jd = jtk.fused_tile(jt, jnp.asarray(lw[b], jnp.float32),
                                    jnp.asarray(lh[b], jnp.float32),
                                    mxu_bf16=True)
        assert _rel(swn[b], js) <= tol
        assert _rel(shn[b], jh) <= tol
        assert _rel(float(dterm[b]), float(jd)) <= dtol


def test_bf16_mode_rounds_a_and_the_gathered_rows():
    csr, lw, lh = _problem(nb=2, r=4, seed=3)
    tc = ttk.from_scipy_tile(csr, dtype=F32, device="cpu")
    lw_t = torch.tensor(lw, dtype=F32)
    lht = torch.tensor(lh, dtype=F32).transpose(-1, -2).contiguous()
    swn, a, xlog = spk.rowpass(tc, lw_t, lht, mxu_bf16=True)
    assert torch.equal(a, tsol.bf16_round(a))           # a is rounded
    swn32, a32, _ = spk.rowpass(tc, lw_t, lht)
    assert not torch.equal(a, a32)
    # the same pass on operands rounded beforehand: S1 rounds the rows
    # it gathers, and in bf16 mode it forms wth in its own order
    r_swn, r_a, r_xlog = spk.rowpass(tc, tsol.bf16_round(lw_t),
                                     tsol.bf16_round(lht), mxu_bf16=True)
    assert torch.equal(r_a, a) and torch.equal(r_xlog, xlog)
    # S2 sums the rounded a against the rounded lw rows
    shn = spk.colpass(tc, a, lw_t, mxu_bf16=True)
    torch.testing.assert_close(
        shn, spk.colpass(tc, a, tsol.bf16_round(lw_t)), rtol=0, atol=0)


def test_s1_dot_is_the_kernels_order():
    """_s1_dot gives sum(u v) as a butterfly over the group: exact
    integer sums agree with torch.sum, and for r above 32 each lane's
    four products are added first."""
    for r in (1, 3, 8, 13, 32, 40, 128):
        u = torch.arange(1, r + 1, dtype=torch.float64)[None].expand(2, r)
        v = torch.ones(2, r, dtype=torch.float64)
        assert torch.equal(tsk._s1_dot(u, v), u.sum(-1))


def test_vb_factorize_sparse_bf16_matches_jax():
    """Five sweeps from the same svd2 start: further on, a bf16 a on a
    rounding boundary that the two packages round apart grows into
    percent-level differences (and neither reaches Tol in bf16 on this
    small matrix), as on the cell-major route."""
    x = cf.simulate_whx(nrow=40, ncol=60, rank=3, seed=11)["x"]
    kw = dict(ranks=[2, 3, 4], initializer="svd2", backend="sparse",
              precision="bf16", Itmax=5, verbose=0)
    a = cf.vb_factorize(cf.SCSet(count=sp.csr_matrix(x)),
                        dtype=jnp.float32, **kw)
    b = ct.vb_factorize(ct.SCSet(count=sp.csr_matrix(x)), dtype=F32,
                        device="cpu", **kw)
    np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                               rtol=1e-4)
    # the mode took effect: float32 gives other numbers
    c = ct.vb_factorize(ct.SCSet(count=sp.csr_matrix(x)), dtype=F32,
                        device="cpu", **dict(kw, precision="f32"))
    assert not np.array_equal(b.measure["lml"], c.measure["lml"])


def test_vb_factorize_sparse_bf16_with_a_tail_matches_jax():
    """At the default quantile the skewed matrix's dense rows overflow
    the JAX layout's slots: five bf16 sweeps from the same svd2 start
    agree with JAX at the bf16 loop tolerance, on one device and over
    two cell shards (each shard's tail is JAX's sharded layout's, which
    is not the one-device layout's)."""
    csr = _skewed(n=120, m=150, heavy=4, seed=2)
    assert jtk.from_scipy_tile(csr, dtype=jnp.float32).trow.shape[0] > 0
    kw = dict(ranks=[2, 3, 4], initializer="svd2", backend="sparse",
              precision="bf16", Itmax=5, verbose=0)
    a = cf.vb_factorize(cf.SCSet(count=csr), dtype=jnp.float32, **kw)
    b = ct.vb_factorize(ct.SCSet(count=csr), dtype=F32, device="cpu", **kw)
    np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                               rtol=1e-4)
    import jax

    am = cf.vb_factorize(cf.SCSet(count=csr), dtype=jnp.float32,
                         mesh=cf.make_mesh(cells=2,
                                           devices=jax.devices()[:2]), **kw)
    c = ct.vb_factorize(ct.SCSet(count=csr), dtype=F32, device="cpu",
                        mesh=ct.make_mesh(cells=2, devices=["cpu"] * 2),
                        **kw)
    np.testing.assert_allclose(c.measure["lml"], am.measure["lml"],
                               rtol=1e-4)


def test_coo_and_ell_refuse_bf16():
    """As the JAX driver's COO and ELL scans do (ELL refuses elbo_every
    too: tests/test_torch_ell.py)."""
    x = sp.csr_matrix(_problem()[0])
    for layout in ("coo", "ell"):
        for extra in (dict(precision="bf16"),):
            with pytest.raises(ValueError):
                ct.vb_factorize(x, ranks=[2], backend="sparse",
                                sparse_layout=layout, device="cpu",
                                verbose=0, Itmax=2, **extra)
            with pytest.raises(ValueError):
                cf.vb_factorize(x, ranks=[2], backend="sparse",
                                sparse_layout=layout, verbose=0, Itmax=2,
                                **extra)


def test_bf16_keeps_the_optimal_rank():
    """A planted rank-5 problem: bf16 on the sparse backend selects the
    rank float32 selects (the bundled scan's ropt 5 is gated on the
    card, chip_smoke.py phase 15: its plain sparse run takes minutes
    here).  Shapes 0.5 and a W mean of 2 plant rank 5 clearly: its
    evidence leads rank 6 by ~0.02 a matrix element in both precisions
    for seeds 0-2, where the prior-default draw (shapes 0.1) led by
    ~0.003 and a rank-5 restart stuck in another optimum under some
    hosts' float32 matmul rounding turned the choice to 6."""
    x = ct.simulate_whx(nrow=120, ncol=90, rank=5, aw=0.5, bw=2.0, ah=0.5,
                        seed=3)["x"]
    kw = dict(ranks=list(range(2, 9)), nrun=2, Itmax=1500, seed=0,
              backend="sparse", verbose=0, device="cpu", dtype=F32)
    a = ct.vb_factorize(sp.csr_matrix(x), precision="bf16", **kw)
    b = ct.vb_factorize(sp.csr_matrix(x), **kw)
    assert ct.optimal_rank(a)["ropt"] == ct.optimal_rank(b)["ropt"] == 5
