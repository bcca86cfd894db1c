"""The port's gene-major sweep (ccfindr_tpu_torch.ops.kernels.vb_kernels
and .epilogue) and the routing of vb_factorize(backend='pallas') against
the JAX package, whose Pallas kernels run here in interpret mode with
small tiles, as tests/test_pallas.py runs them.

Everything is float64 unless stated; tolerances: the X pass and the
posterior update 1e-10; loops n_iter equal, lml 1e-9, factors 1e-7,
hypers 1e-9.  bf16 (``mxu_bf16``) is compared at float32, relative 2e-3
on swn/shn: the two packages sum wth in different orders, and where u
lies on a bf16 rounding boundary one u moves by 2^-8 of itself.

On the CPU the wrappers take the plain PyTorch versions; the CUDA
kernels are compared with them on the card (tests/test_torch_kernels.py
and chip_smoke.py).
"""

import inspect
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.ops.pallas import epilogue as jep
from ccfindr_tpu.ops.pallas import sol as jsol
from ccfindr_tpu.ops.pallas import vb_kernels as pk
from ccfindr_tpu.ops.vb import Hyper as JHyper, VBState as JVBState
from ccfindr_tpu_torch.ops import ml as tml
from ccfindr_tpu_torch.ops import tile as ttk
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.ops.kernels import build as tbuild
from ccfindr_tpu_torch.ops.kernels import epilogue as tep
from ccfindr_tpu_torch.ops.kernels import sol as tsol
from ccfindr_tpu_torch.ops.kernels import vb_kernels as tvk

torch.set_num_threads(2)

BN, BM = 8, 8


def _planted(n, m, r, seed=0):
    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.8, 1.0, (n, r))
    hf = rng.gamma(0.8, 1.0, (r, m))
    return np.minimum(rng.poisson(wf @ hf * (2.0 * n * m / (wf @ hf).sum())),
                      127).astype(np.float64)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _factors(n, m, r, rp, seed):
    """Random lw (n, r), lh (r, m) and the port's rank-padded (1, n, rp),
    (1, rp, m) copies."""
    rng = np.random.default_rng(seed)
    lw = rng.gamma(1.0, 1.0, (n, r))
    lh = rng.gamma(1.0, 1.0, (r, m))
    tlw = np.zeros((1, n, rp))
    tlw[0, :, :r] = lw
    tlh = np.zeros((1, rp, m))
    tlh[0, :r] = lh
    return lw, lh, tlw, tlh


# ---------------------------------------------------------------------
# The X pass (E1 + E1s's function)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["cm", "gm"])
@pytest.mark.parametrize("r", [3, 5, 16])
def test_fused_pallas_raw_matches_jax(layout, r):
    n, m = 37, 53
    rp = tsol.round_up(max(r, 8), 8)
    x = _planted(n, m, 3, seed=r)
    lw, lh, tlw, tlh = _factors(n, m, r, rp, seed=r + 1)
    xp = pk.pad_matrix(jnp.asarray(x), BN, BM)
    lw_p, lh_p = pk._pad_factors(jnp.asarray(lw), jnp.asarray(lh),
                                 xp.shape[0], xp.shape[1], rp)
    swn, shn, xlog = pk.fused_pallas_raw(xp, lw_p, lh_p, bn=BN, bm=BM,
                                         layout=layout)
    tvk.reset_launches()
    got = tvk.fused_pallas_raw(_t(x, torch.int16), _t(tlw), _t(tlh),
                               layout=layout)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(swn)[:n],
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(shn)[:, :m],
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(float(got[2][0]), float(xlog), rtol=1e-10)
    # the JAX module's fold of the ELBO data term, from the port's outputs
    want = pk.fold_dterm(swn[:n, :r], shn[:r, :m], jnp.asarray(lw),
                         jnp.asarray(lh), xlog)
    fold = tvk.fold_dterm(got[0][..., :r], got[1][:, :r], _t(lw)[None],
                          _t(lh)[None], got[2])
    np.testing.assert_allclose(float(fold[0]), float(want), rtol=1e-10)
    # CPU tensors take the plain version: no kernel was launched
    assert all(v == 0 for v in tvk.LAUNCHES.values())


def test_fused_pallas_raw_padded_equals_unpadded():
    """On the JAX package's padded arrays the port gives the padded
    outputs: zero swn rows and shn columns in the padding."""
    n, m, r = 21, 30, 4
    x = _planted(n, m, 2, seed=6)
    lw, lh, tlw, tlh = _factors(n, m, r, 8, seed=7)
    a = tvk.fused_pallas_raw(_t(x), _t(tlw), _t(tlh), layout="gm")
    xp = np.zeros((24, 40))
    xp[:n, :m] = x
    tlwp = np.zeros((1, 24, 8))
    tlwp[0, :, :r] = 1.0
    tlwp[0, :n] = tlw[0]
    tlhp = np.zeros((1, 8, 40))
    tlhp[0, :r] = 1.0
    tlhp[0, :, :m] = tlh[0]
    b = tvk.fused_pallas_raw(_t(xp, torch.int8), _t(tlwp), _t(tlhp),
                             layout="cm")
    torch.testing.assert_close(b[0][:, :n], a[0], rtol=1e-12, atol=0)
    torch.testing.assert_close(b[1][..., :m], a[1], rtol=1e-12, atol=0)
    assert float(b[0][:, n:].abs().max()) == 0.0
    assert float(b[1][..., m:].abs().max()) == 0.0
    torch.testing.assert_close(b[2], a[2], rtol=1e-12, atol=0)


@pytest.mark.parametrize("layout", ["cm", "gm"])
def test_fused_pallas_raw_bf16_matches_jax(layout):
    n, m, r = 37, 53, 5
    x = _planted(n, m, 3, seed=11)
    lw, lh, tlw, tlh = _factors(n, m, r, 8, seed=12)
    f32 = jnp.float32
    xp = pk.pad_matrix(jnp.asarray(x, f32), BN, BM)
    lw_p, lh_p = pk._pad_factors(jnp.asarray(lw, f32), jnp.asarray(lh, f32),
                                 xp.shape[0], xp.shape[1], 8)
    swn, shn, xlog = pk.fused_pallas_raw(xp, lw_p, lh_p, bn=BN, bm=BM,
                                         layout=layout, mxu_bf16=True)
    got = tvk.fused_pallas_raw(_t(x, torch.int8), _t(tlw, torch.float32),
                               _t(tlh, torch.float32), layout=layout,
                               mxu_bf16=True)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(swn)[:n],
                               rtol=2e-3, atol=0)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(shn)[:, :m],
                               rtol=2e-3, atol=0)
    np.testing.assert_allclose(float(got[2][0]), float(xlog), rtol=1e-5)
    # the rounding moved the products: bf16 is not the float32 pass
    plain = tvk.fused_pallas_raw(_t(x, torch.int8), _t(tlw, torch.float32),
                                 _t(tlh, torch.float32), layout=layout)
    assert not torch.equal(plain[0], got[0])


def test_bf16_round_is_nearest_even():
    v = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -2.5,
                      1.0 + 2.0 ** -9], dtype=torch.float64)
    torch.testing.assert_close(
        tsol.bf16_round(v),
        torch.tensor([1.0, 1.0 + 2 ** -6, -2.5, 1.0], dtype=torch.float64),
        rtol=0, atol=0)


def test_e2_block_is_a_constant_of_epi_w_cuh():
    """E2's block (E2_COLS genes of one lane, a thread an entry) is
    csrc/epi_w.cuh's kE2Cols, used by the launch as it stands (never
    derived from the lane count): the wrapper sizes E2's partials, which
    E3 and K4 read, from it; E3's partials stay one a POST_COLS cells
    (post.cuh's block, kPostCols)."""
    src = (tbuild.CSRC / "epi_w.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (kE2\w+) = (\d+);", src))
    assert int(consts["kE2Cols"]) == tep.E2_COLS
    assert re.search(r"grid\(ceil_div\(np, kE2Cols\), B\)", src)
    post = (tbuild.CSRC / "post.cuh").read_text()
    assert int(re.search(r"constexpr int kPostCols = (\d+);",
                         post).group(1)) == tsol.POST_COLS
    for ext, rp in ((1, 8), (255, 16), (256, 24), (100_000, 16)):
        c, s_ = tep._partials(3, ext, rp, "cpu", tep.E2_COLS)
        assert c.shape == (3, -(-ext // tep.E2_COLS), rp)
        assert s_.shape == (3, -(-ext // tep.E2_COLS), 4)
        c, s_ = tep._partials(3, ext, rp, "cpu", tsol.POST_COLS)
        assert c.shape == (3, -(-ext // tsol.POST_COLS), rp)
        assert s_.shape == (3, -(-ext // tsol.POST_COLS), 4)
    assert "E2_COLS" in inspect.getsource(tep.epi_w_post)
    assert "sol.POST_COLS" in inspect.getsource(tep.epi_h_post)


# ---------------------------------------------------------------------
# The posterior update (E2 + E3's function)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("r_live,m_live", [(None, None), (3, 25)])
def test_posterior_update_pallas_matches_jax(r_live, m_live):
    n, m, r = 20, 27, 5
    x = _planted(n, m, 3, seed=3)
    lw, lh, _, _ = _factors(n, m, r, 8, seed=4)
    eh = lh * np.random.default_rng(5).uniform(0.5, 1.5, lh.shape)
    xp = pk.pad_matrix(jnp.asarray(x), BN, BM)
    np_, mp_ = xp.shape
    lw_p, lh_p = pk._pad_factors(jnp.asarray(lw), jnp.asarray(lh), np_, mp_,
                                 8)
    swn_p, shn_p, _ = pk.fused_pallas_raw(xp, lw_p, lh_p, bn=BN, bm=BM)
    ehs = jnp.zeros((8, 8)).at[0, :r].set(jnp.sum(jnp.asarray(eh), axis=1))
    hyper = jnp.asarray([0.7, 1.3, 1.1, 0.9])
    fudge = np.finfo(np.float64).eps
    want = jep.posterior_update_pallas(
        swn_p, shn_p, lw_p, lh_p, ehs, hyper, jnp.asarray(fudge), n=n, m=m,
        r=r, bn=BN, bm=BM,
        r_live=None if r_live is None else jnp.asarray(float(r_live)),
        m_live=m_live)
    got = tep.posterior_update_pallas(
        _t(swn_p)[None], _t(shn_p)[None], _t(lw_p)[None], _t(lh_p)[None],
        _t(ehs)[:1], _t(hyper)[None], fudge, n=n, m=m, r=r,
        r_live=None if r_live is None else _t([float(r_live)]),
        m_live=m_live)
    for f in ("ew", "lw", "dw", "eh", "lh", "dh"):
        np.testing.assert_allclose(got[f][0].numpy(), np.asarray(want[f]),
                                   rtol=1e-10, atol=0, err_msg=f)
    np.testing.assert_allclose(got["csum"][0].numpy(),
                               np.asarray(want["csum"])[0], rtol=1e-10)
    np.testing.assert_allclose(got["rsum"][0].numpy(),
                               np.asarray(want["rsum"])[0], rtol=1e-10)
    for f in ("u2", "u3", "sum_ew", "sum_log_lw", "sum_eh", "sum_log_lh",
              "dterm_w", "dterm_h"):
        np.testing.assert_allclose(float(got[f][0]), float(want[f]),
                                   rtol=1e-10, err_msg=f)


# ---------------------------------------------------------------------
# The convergence loop
# ---------------------------------------------------------------------

def _assert_runs_close(jout, tout):
    np.testing.assert_array_equal(tout.n_iter, jout.n_iter)
    np.testing.assert_array_equal(tout.done, jout.done)
    np.testing.assert_array_equal(tout.hyper_failed, jout.hyper_failed)
    np.testing.assert_allclose(tout.lml, jout.lml, rtol=1e-9)
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        np.testing.assert_allclose(getattr(tout.state, f),
                                   getattr(jout.state, f), rtol=1e-7,
                                   atol=1e-300, err_msg=f)
    for f in ("aw", "bw", "ah", "bh"):
        np.testing.assert_allclose(getattr(tout.hyper, f),
                                   getattr(jout.hyper, f), rtol=1e-9,
                                   err_msg=f)


def _epi_pair(ranks, layout, itmax, it0=1, lk0_init=None, seed=7):
    """JAX vb_run_epi (vmapped with prefix rank masks when there are
    several lanes, as the JAX driver builds it) against the port's
    lane-batched vb_run_epi on the same initial states."""
    sim = cf.simulate_whx(nrow=24, ncol=36, rank=3, seed=seed)
    x = np.asarray(sim["x"], np.float64)
    n, m = x.shape
    rmax = max(ranks)
    nb = len(ranks)
    rng = np.random.default_rng(0)
    w = rng.gamma(1.0, 1.0, (nb, n, rmax))
    h = rng.gamma(1.0, 1.0, (nb, rmax, m))
    st = JVBState(ew=w, eh=h, lw=w, lh=h, dw=np.zeros_like(w),
                  dh=np.zeros_like(h), lkh=np.full(nb, -np.inf))
    kw = dict(itmax=itmax, tol=1e-5, it0=it0, lk0_init=lk0_init)
    xp = pk.pad_matrix(jnp.asarray(x), BN, BM)
    hy = JHyper(*(jnp.ones(nb),) * 4)
    masked = len(ranks) > 1
    if masked:
        rmask = (np.arange(rmax)[None] < np.asarray(ranks)[:, None]
                 ).astype(np.float64)
        rtrue = np.asarray(ranks, np.float64)
        jout = jax.vmap(lambda s, hh, rm, rt: jep.vb_run_epi(
            xp, s, hh, bn=BN, bm=BM, layout=layout, m_true=m, rank_mask=rm,
            r_true=rt, **kw))(jax.tree.map(jnp.asarray, st), hy,
                              jnp.asarray(rmask), jnp.asarray(rtrue))
    else:
        jout = jax.vmap(lambda s, hh: jep.vb_run_epi(
            xp, s, hh, bn=BN, bm=BM, layout=layout, m_true=m, **kw))(
                jax.tree.map(jnp.asarray, st), hy)
    tep.reset_launches()
    tout = tep.vb_run_epi(
        _t(x, torch.int16), tvb.state_from_numpy(st, device="cpu"),
        tvb.Hyper(*(torch.ones(nb, dtype=torch.float64),) * 4),
        layout=layout, rank_mask=_t(rmask) if masked else None,
        r_true=_t(rtrue) if masked else None, **kw)
    assert all(v == 0 for v in tep.LAUNCHES.values())
    return jax.tree.map(np.asarray, jout), tvb.state_to_numpy(tout)


@pytest.mark.parametrize("layout", ["cm", "gm"])
def test_vb_run_epi_single_lane_matches_jax(layout):
    jout, tout = _epi_pair([4], layout, 200)
    _assert_runs_close(jout, tout)
    assert tout.done.all()


@pytest.mark.parametrize("layout", ["cm", "gm"])
def test_vb_run_epi_rank_masked_batch_matches_jax(layout):
    jout, tout = _epi_pair([3, 4, 5], layout, 150)
    _assert_runs_close(jout, tout)
    assert len(set(tout.n_iter.tolist())) > 1


def test_vb_run_epi_itmax_and_resume_match_jax():
    jout, tout = _epi_pair([3, 5], "gm", 6)
    _assert_runs_close(jout, tout)
    assert not tout.done.any()
    jout, tout = _epi_pair([3, 5], "gm", 60, it0=4, lk0_init=-2.5)
    _assert_runs_close(jout, tout)


def test_vb_run_epi_equals_vb_run_sol():
    """The two single-device sweeps run the same loop: the gene-major
    one gives the cell-major one's result."""
    x = torch.tensor(_planted(30, 45, 3, seed=2), dtype=torch.int8)
    gen = torch.Generator().manual_seed(4)
    hy1 = tvb.Hyper(1.0, 1.0, 1.0, 1.0)
    sts = [tvb.vb_init_random(gen, 30, 45, 4, hy1, torch.float64,
                              device="cpu") for _ in range(3)]
    st = tvb.VBState(*(torch.stack(f) for f in zip(*sts)))
    hy = tvb.Hyper(*(torch.ones(3, dtype=torch.float64),) * 4)
    rm = _t((np.arange(4)[None] < np.array([[2], [3], [4]])).astype(float))
    kw = dict(itmax=300, tol=1e-6, rank_mask=rm, r_true=_t([2., 3., 4.]))
    a = tsol.vb_run_sol(x, st, hy, **kw)
    b = tep.vb_run_epi(x, st, hy, layout="gm", **kw)
    assert torch.equal(a.n_iter, b.n_iter) and bool(a.done.all())
    torch.testing.assert_close(a.lml, b.lml, rtol=1e-10, atol=0)
    for u, v in zip(a.state, b.state):
        torch.testing.assert_close(u, v, rtol=1e-7, atol=1e-300)


def test_vb_run_epi_cell_mask_raises():
    """``cell_mask`` raised (ROADMAP A7) until the mesh was ported; it
    now pins the padded cells, so both layouts equal vb_run_sol with the
    same mask (JAX parity: tests/test_torch_mesh.py)."""
    x = _t(np.pad(_planted(12, 40, 2, seed=3), ((0, 0), (0, 4))),
           torch.int16)
    st = tvb.vb_init_random(torch.Generator().manual_seed(0), 12, 44, 2,
                            tvb.Hyper(1.0, 1.0, 1.0, 1.0), torch.float64,
                            device="cpu")
    st = tvb.VBState(*(f[None] for f in st))
    hy = tvb.Hyper(*(torch.ones(1, dtype=torch.float64),) * 4)
    kw = dict(itmax=100, tol=1e-6, m_true=40,
              cell_mask=(torch.arange(44) < 40).double())
    a = tsol.vb_run_sol(x, st, hy, **kw)
    for layout in ("cm", "gm"):
        b = tep.vb_run_epi(x, st, hy, layout=layout, **kw)
        assert torch.equal(a.n_iter, b.n_iter)
        torch.testing.assert_close(a.lml, b.lml, rtol=1e-10, atol=0)
        assert bool((b.state.eh[..., 40:] == 0).all())
        assert bool((b.state.lh[..., 40:] == torch.finfo(
            torch.float64).eps).all())


def test_bf16_sol_loop_matches_jax():
    """precision='bf16' on the cell-major sweep: the port's vb_run_sol
    (mxu_bf16) against JAX's for a few sweeps at float32.  Tolerance
    1e-4 relative on lml and 1e-2 on the factors: the bf16 rounding of u
    may land on either side in the two packages (see the module note);
    a flipped u moves one summand of a 24-gene sum by 2^-8 of itself,
    and five sweeps carry it forward."""
    n, m, rmax = 24, 150, 4
    x = _planted(n, m, 3, seed=9)
    rng = np.random.default_rng(10)
    w = rng.gamma(1.0, 1.0, (2, n, rmax)).astype(np.float32)
    h = rng.gamma(1.0, 1.0, (2, rmax, m)).astype(np.float32)
    st = JVBState(ew=w, eh=h, lw=w, lh=h, dw=np.zeros_like(w),
                  dh=np.zeros_like(h), lkh=np.full(2, -np.inf, np.float32))
    rmask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.float32)
    rtrue = np.array([3.0, 4.0], np.float32)
    kw = dict(itmax=5, tol=1e-6, mxu_bf16=True)
    xp = pk.pad_matrix(jnp.asarray(x, jnp.float32), 8, 128)
    jout = jax.vmap(lambda s, hh, rm, rt: jsol.vb_run_sol(
        xp, s, hh, rank_mask=rm, r_true=rt, bn=8, bm=128, **kw))(
            jax.tree.map(jnp.asarray, st),
            JHyper(*(jnp.ones(2, jnp.float32),) * 4), jnp.asarray(rmask),
            jnp.asarray(rtrue))
    tout = tsol.vb_run_sol(
        _t(x, torch.int8), tvb.state_from_numpy(st, device="cpu"),
        tvb.Hyper(*(torch.ones(2),) * 4), rank_mask=_t(rmask, torch.float32),
        r_true=_t(rtrue, torch.float32), **kw)
    jout = jax.tree.map(np.asarray, jout)
    tout = tvb.state_to_numpy(tout)
    np.testing.assert_array_equal(tout.n_iter, jout.n_iter)
    np.testing.assert_allclose(tout.lml, jout.lml, rtol=1e-4)
    for f in ("ew", "eh"):
        np.testing.assert_allclose(getattr(tout.state, f),
                                   getattr(jout.state, f), rtol=1e-2,
                                   atol=1e-6, err_msg=f)
    f32 = tsol.vb_run_sol(
        _t(x, torch.int8), tvb.state_from_numpy(st, device="cpu"),
        tvb.Hyper(*(torch.ones(2),) * 4), rank_mask=_t(rmask, torch.float32),
        r_true=_t(rtrue, torch.float32), itmax=5, tol=1e-6)
    assert not np.array_equal(tvb.state_to_numpy(f32).lml, tout.lml)


# ---------------------------------------------------------------------
# The driver's routing
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n,m,r,want", [
    (65536, 16, 2, "cm"), (65537, 16, 2, "gm"), (65536, 4096, 16, "cm"),
    (65537, 4096, 16, "gm"), (100000, 4096, 16, "gm"),
    (100000, 4096, 8, "gm"), (70000, 100000, 16, "gm"),
    (70000, 600000, 16, "cm"), (2000, 5000, 8, "cm")])
def test_fused_layout_matches_jax(n, m, r, want):
    """On the JAX driver's padded extents: gene-major from 65,537 genes
    while the cells' shn residency is the smaller one."""
    args = (tsol.round_up(n, 1024), tsol.round_up(m, 512),
            tsol.round_up(max(r, 8), 8))
    assert tvk._fused_layout(*args) == pk._fused_layout(*args) == want


@pytest.fixture(scope="module")
def planted_small():
    return _planted(30, 40, 3, seed=21)


def test_vb_factorize_gene_major_matches_jax(planted_small, monkeypatch):
    """The layout forced to 'gm' in both packages (the JAX driver
    imports _fused_layout at call time): the measure table and the
    sweeps equal JAX's.  svd2 is deterministic, so both packages run one
    restart of the nrun asked for."""
    monkeypatch.setattr(pk, "_fused_layout", lambda *a, **k: "gm")
    monkeypatch.setattr("ccfindr_tpu_torch.drivers.vb_driver._fused_layout",
                        lambda *a, **k: "gm")
    kw = dict(ranks=[2, 3, 4], nrun=2, initializer="svd2", Itmax=300,
              backend="pallas", verbose=0)
    a = cf.vb_factorize(cf.SCSet(count=planted_small), **kw)
    tep.reset_launches()
    b = ct.vb_factorize(ct.SCSet(count=planted_small), device="cpu", **kw)
    assert list(a.measure["rank"]) == list(b.measure["rank"])
    for col in ("lml", "aw", "bw", "ah", "bh"):
        np.testing.assert_allclose(b.measure[col], a.measure[col],
                                   rtol=1e-8, err_msg=col)
    np.testing.assert_array_equal(b.measure["nunif"], a.measure["nunif"])
    assert (b.metadata["timings"][0]["total_sweeps"]
            == a.metadata["timings"][0]["total_sweeps"])
    for k in range(len(a.ranks)):
        np.testing.assert_allclose(b.basis[k], a.basis[k], rtol=0,
                                   atol=1e-6 * np.abs(a.basis[k]).max())


@pytest.mark.parametrize("n,epi", [(65537, True), (65536, False)])
def test_vb_factorize_takes_the_gene_major_loop_above_65536(n, epi,
                                                            monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.poisson(1.0, (n, 16)) + (np.arange(n)[:, None] % 16
                                     == np.arange(16)[None])
    calls = []
    real = tep.vb_run_epi

    def spy(*a, **k):
        calls.append(k["layout"])
        return real(*a, **k)

    monkeypatch.setattr(tep, "vb_run_epi", spy)
    s = ct.vb_factorize(x, ranks=[2], Itmax=3, backend="pallas",
                        device="cpu", verbose=0)
    assert calls == (["gm"] if epi else [])
    assert np.isfinite(s.measure["lml"]).all()


@pytest.mark.parametrize("kw,match", [
    (dict(precision="bf16"), "bf16"),
    (dict(elbo_every=3), "elbo_every"),
])
def test_gene_major_route_refuses_what_jax_refuses(planted_small, kw, match,
                                                   monkeypatch):
    monkeypatch.setattr("ccfindr_tpu_torch.drivers.vb_driver._fused_layout",
                        lambda *a, **k: "gm")
    with pytest.raises(ValueError, match=match):
        ct.vb_factorize(planted_small, ranks=[2], backend="pallas",
                        device="cpu", verbose=0, **kw)


def test_bf16_scan_on_the_cell_major_route(planted_small):
    kw = dict(ranks=[2, 3], nrun=2, Itmax=50, backend="pallas", seed=1,
              device="cpu", dtype=torch.float32, verbose=0)
    a = ct.vb_factorize(planted_small, precision="bf16", **kw)
    b = ct.vb_factorize(planted_small, **kw)
    assert np.isfinite(a.measure["lml"]).all()
    assert not np.array_equal(a.measure["lml"], b.measure["lml"])
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-2)


# ---------------------------------------------------------------------
# The public constructors default to the card
# ---------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: ttk.from_scipy_tile(np.eye(3)),
    lambda: ttk.from_dense_tile(np.eye(3)),
    lambda: tvb.vb_init_random(torch.Generator(), 4, 5, 2,
                               tvb.Hyper(1.0, 1.0, 1.0, 1.0)),
    lambda: tvb.vb_init_svd(np.ones((4, 5)), 2,
                            tvb.Hyper(1.0, 1.0, 1.0, 1.0)),
    lambda: tml.ml_init(torch.Generator(), 4, 5, 2),
    lambda: tvb.state_from_numpy(np.ones(3)),
    lambda: tml.ml_state_from_numpy(np.ones(3)),
], ids=["from_scipy_tile", "from_dense_tile", "vb_init_random",
        "vb_init_svd", "ml_init", "state_from_numpy",
        "ml_state_from_numpy"])
def test_constructors_default_to_the_card(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
