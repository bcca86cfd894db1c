"""The port's cell-sharded mesh against the JAX package's.

JAX runs its mesh on the 8 virtual CPU devices of tests/conftest.py,
with Pallas in interpret mode as its own tests run it
(tests/test_sol_sharded.py, tests/test_sharding.py).  The port runs its
shards in one process, each on ``"cpu"``; on the CPU every wrapper takes
its plain PyTorch version (the CUDA kernels K1s, K2, K3s and K4 are held
against it on the card by tests/test_torch_kernels.py and
chip_smoke.py).  Everything is float64.  Tolerances: one sweep 1e-10
on every output, as tests/test_torch_sol.py; loops and drivers equal
sweep counts and lml within 1e-9; the elbo_every and bf16 runs those of
tests/test_sol_sharded.py:123-139.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu.ops.pallas import sol as jsol
from ccfindr_tpu.ops.pallas import sol_sharded as jss
from ccfindr_tpu.ops.pallas import vb_kernels as pk
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.ops.kernels import epilogue as tepi
from ccfindr_tpu_torch.ops.kernels import sol as tsol
from ccfindr_tpu_torch.ops.kernels import sol_sharded as tss
from ccfindr_tpu_torch.parallel import mesh as tmesh
from ccfindr_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(2)

BN, BM = 8, 128
F64 = torch.float64


def _planted(n, m, r, seed=0):
    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.8, 1.0, (n, r))
    hf = rng.gamma(0.8, 1.0, (r, m))
    return np.minimum(rng.poisson(wf @ hf * (2.0 * n * m / (wf @ hf).sum())),
                      127).astype(np.float64)


def _cpu_mesh(cells, runs=1, genes=1):
    return ct.make_mesh(runs=runs, cells=cells, genes=genes,
                        devices=["cpu"] * (runs * cells * genes))


def _jax_mesh(cells, runs=1, genes=1):
    return cf.make_mesh(runs=runs, cells=cells, genes=genes,
                        devices=jax.devices()[:runs * cells * genes])


# ---------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(runs=2, cells=4), dict(runs=2),
                                dict(runs=1, genes=2, cells=4),
                                dict(runs=2, genes=2, cells=2)])
def test_make_mesh_matches_jax(kw):
    j = cf.make_mesh(**kw)
    t = ct.make_mesh(devices=["cpu"] * 8, **kw)
    assert t.axis_names == j.axis_names == ("runs", "genes", "cells")
    assert t.devices.shape == j.devices.shape
    assert t.shape == dict(j.shape)
    assert all(d == torch.device("cpu") for d in t.devices.flat)
    for kind in ("x", "w", "h", "bw", "bh", "scalar", "bscalar"):
        assert tmesh.cell_sharding(t, kind) == tuple(
            cf.parallel.cell_sharding(j, kind).spec)


@pytest.mark.parametrize("kw", [dict(runs=3), dict(runs=2, cells=3),
                                dict(genes=3)])
def test_make_mesh_errors_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        cf.make_mesh(**kw)
    with pytest.raises(ValueError) as et:
        ct.make_mesh(devices=["cpu"] * 8, **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("devices", [["cpu", "cuda:0"], ["cuda:0", "cpu"]])
def test_make_mesh_rejects_mixed_device_types(devices):
    """A shard takes its kernels or its plain version by its device's
    type, so a mesh that mixes types is refused, in either order."""
    with pytest.raises(ValueError, match="one type"):
        ct.make_mesh(cells=2, devices=devices)
    with pytest.raises(ValueError, match="one type"):
        tmesh.Mesh(np.array(devices, dtype=object).reshape(1, 1, 2))


def test_sharded_sweep_rejects_mixed_device_types():
    """An X laid out over devices of two types (here the host and the
    'meta' device) is refused by the sweep before any shard runs."""
    n, m, nb, rp = 8, 8, 1, 8
    x = torch.ones(n, m, dtype=F64)
    xs = tsh.ShardedCounts(x, np.array([["cpu", "meta"]], dtype=object))
    lwt = torch.ones(nb, rp, n, dtype=F64)
    lh = xs.shard_h(torch.ones(nb, rp, m, dtype=F64))
    sweep = tss.make_sol_sweep_sharded(_cpu_mesh(2))
    with pytest.raises(ValueError, match="one type"):
        sweep(xs, lwt, lh, lh, torch.zeros(nb, 8, dtype=F64), n=n,
              m_arr=m, m_live=m, r=rp)


def test_init_distributed():
    assert ct.init_distributed() is False
    assert ct.init_distributed(num_processes=1) is False
    with pytest.raises(NotImplementedError, match="A7c"):
        ct.init_distributed("localhost:1234", 2, 0)


# ---------------------------------------------------------------------
# parallel/sharded.py
# ---------------------------------------------------------------------

def _lw_lh(n, m, r, nb, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.gamma(1.0, 1.0, (nb, n, r))),
            torch.tensor(rng.gamma(1.0, 1.0, (nb, r, m))))


@pytest.mark.parametrize("genes,cells", [(1, 1), (1, 4), (2, 2)])
def test_dense_block_passes(genes, cells):
    """The block passes add their partials in shard order: one block
    gives the single-device bits, several the same values."""
    n, m, r = 12, 40, 3
    x = torch.tensor(_planted(n, m, r, seed=3))
    lw, lh = _lw_lh(n, m, r, 2, 4)
    xs = tsh.place_counts(x, _cpu_mesh(cells, genes=genes))[0]
    assert xs.shape == x.shape and torch.equal(xs.val, x[x != 0])
    got = (tsh.fused_sharded(xs, lw, lh)
           + tsh.suffstats_sharded(xs, lw, lh)
           + (tsh.data_term_sharded(xs, lw, lh),))
    want = (tvb.fused_dense(x, lw, lh) + tvb.suffstats_dense(x, lw, lh)
            + (tvb.elbo_data_term(x, lw, lh),))
    for g, w in zip(got, want):
        if genes * cells == 1:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0)


def test_sharded_counts_layout():
    x = torch.arange(24.0).view(4, 6)
    xs = tsh.ShardedCounts(x, np.array([["cpu"] * 3] * 2, dtype=object))
    assert xs.rows == [(0, 2), (2, 4)] and xs.cols == [(0, 2), (2, 4),
                                                       (4, 6)]
    assert torch.equal(xs.blocks[1][2], x[2:, 4:])
    # a block on X's own device is a view, not a copy; X is not kept
    # whole, only what the loops take from it, with one device's bits
    assert xs.blocks[1][2].data_ptr() == x[2:, 4:].data_ptr()
    assert not hasattr(xs, "full")
    assert torch.equal(xs.lgx, tsol.lgamma_sum(x))
    assert torch.equal(xs.val, x[x != 0])
    h = torch.arange(12.0).view(2, 6)
    parts = xs.shard_h(h)
    assert [p.shape[-1] for p in parts] == [2, 2, 2]
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(xs.gather_h(parts), h)
    with pytest.raises(ValueError, match="does not split"):
        tsh.ShardedCounts(torch.zeros(5, 6), np.array([["cpu"]] * 2))


# ---------------------------------------------------------------------
# ops/vb.py: the mesh masks
# ---------------------------------------------------------------------

def _state_np(n, m, r, seed):
    rng = np.random.default_rng(seed)
    ew = rng.gamma(1.0, 1.0, (n, r))
    eh = rng.gamma(1.0, 1.0, (r, m))
    return jvb.VBState(ew=ew, eh=eh, lw=ew * 0.9, lh=eh * 0.9,
                       dw=ew * 0.1, dh=eh * 0.1, lkh=np.float64(-np.inf))


def _masks(n, m, r, n_true, m_true, r_true):
    """JAX's and the port's keyword sets for the masks of a padded
    state (a None count: that mask is absent)."""
    j, t = {}, {}
    for name, count, ext, mask in (("cell", m_true, m, "cell_mask"),
                                   ("gene", n_true, n, "gene_mask"),
                                   ("rank", r_true, r, "rank_mask")):
        if count is None:
            continue
        v = (np.arange(ext) < count).astype(np.float64)
        key = {"cell": "m_true", "gene": "n_true", "rank": "r_true"}[name]
        j.update({mask: jnp.asarray(v), key: count})
        t.update({mask: torch.tensor(v), key: count})
    return j, t


MASK_CASES = [(None, 30, None), (14, None, None), (14, 30, 2),
              (None, 31, 3)]


@pytest.mark.parametrize("n_true,m_true,r_true", MASK_CASES)
def test_posterior_update_masks(n_true, m_true, r_true):
    n, m, r = 16, 32, 3
    st = _state_np(n, m, r, seed=1)
    rng = np.random.default_rng(2)
    sw = rng.gamma(2.0, 1.0, (n, r))
    sh = rng.gamma(2.0, 1.0, (r, m))
    hy = jvb.Hyper(1.1, 0.9, 1.2, 0.8)
    kj, kt = _masks(n, m, r, n_true, m_true, r_true)
    fudge, lgx = np.finfo(np.float64).eps, 41.0
    new_j, pend_j = jvb.posterior_update(
        jnp.asarray(sw), jnp.asarray(sh), jax.tree.map(jnp.asarray, st),
        jax.tree.map(jnp.asarray, hy), fudge, lgx, **kj)
    new_t, pend_t = tvb.posterior_update(
        torch.tensor(sw), torch.tensor(sh),
        tvb.state_from_numpy(st, device="cpu"),
        tvb.state_from_numpy(hy, device="cpu"), torch.tensor(fudge), lgx,
        **kt)
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        np.testing.assert_allclose(getattr(new_t, f).numpy(),
                                   np.asarray(getattr(new_j, f)),
                                   rtol=1e-12, atol=1e-300, err_msg=f)
    np.testing.assert_allclose(float(pend_t), float(pend_j), rtol=1e-12)


HYPER_MASKS = [(True,) * 4, (False, True, False, True),
               (True, False, True, False), (True, True, True, False)]


@pytest.mark.parametrize("hmask", HYPER_MASKS)
@pytest.mark.parametrize("n_true,m_true,r_true", MASK_CASES)
def test_hyper_update_masks(hmask, n_true, m_true, r_true):
    """The masked means, and bh kept where mask[3] is off (ROADMAP C,
    hyper mask)."""
    n, m, r = 16, 32, 3
    st = _state_np(n, m, r, seed=5)
    kj, kt = _masks(n, m, r, n_true, m_true, r_true)
    # the padded entries as the posterior update leaves them
    st = st._replace(lh=np.where(np.arange(m) < (m_true or m), st.lh,
                                 np.finfo(np.float64).eps),
                     eh=st.eh * (np.arange(m) < (m_true or m)))
    hy = jvb.Hyper(1.1, 0.9, 1.2, 0.8)
    hj, fj = jvb.hyper_update(hmask, jax.tree.map(jnp.asarray, st),
                              jax.tree.map(jnp.asarray, hy), **kj)
    ht, ft = tvb.hyper_update(hmask, tvb.state_from_numpy(st, device="cpu"),
                              tvb.state_from_numpy(hy, device="cpu"), **kt)
    for f in tvb.Hyper._fields:
        np.testing.assert_allclose(float(getattr(ht, f)),
                                   float(getattr(hj, f)), rtol=1e-12,
                                   err_msg=f)
    assert bool(ft) == bool(fj)
    if not hmask[3]:
        assert float(ht.bh) == hy.bh


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n_true,m_true", [(14, 30), (None, 31)])
def test_vb_run_masks_match_jax(fused, n_true, m_true):
    """vb_run on a padded X with the cell and gene masks, against
    JAX's, from the same state."""
    n, m, r = 16, 32, 3
    x = _planted(n, m, r, seed=6)
    x[n_true or n:] = 0
    x[:, m_true or m:] = 0
    st = _state_np(n, m, r, seed=7)
    kj, kt = _masks(n, m, r, n_true, m_true, None)
    kw = dict(itmax=60, tol=1e-7)
    jkw = dict(kw, fused=jvb.fused_dense) if fused else kw
    tkw = dict(kw, fused=tvb.fused_dense) if fused else kw
    jo = jvb.vb_run(jnp.asarray(x), jax.tree.map(jnp.asarray, st),
                    jvb.Hyper(*(jnp.asarray(1.0),) * 4), **jkw, **kj)
    tst = tvb.state_from_numpy(jax.tree.map(lambda a: np.asarray(a)[None],
                                            st), device="cpu")
    to = tvb.vb_run(torch.tensor(x), tst,
                    tvb.Hyper(*(torch.ones(1, dtype=F64),) * 4), **tkw, **kt)
    assert int(to.n_iter[0]) == int(jo.n_iter)
    np.testing.assert_allclose(float(to.lml[0]), float(jo.lml), rtol=1e-9)
    for f in ("ew", "eh"):
        np.testing.assert_allclose(getattr(to.state, f)[0].numpy(),
                                   np.asarray(getattr(jo.state, f)),
                                   rtol=1e-7, atol=1e-300, err_msg=f)


# ---------------------------------------------------------------------
# ops/kernels/sol_sharded.py: one sweep
# ---------------------------------------------------------------------

def _sweep_case(n, m_arr, r, rp, nb, seed):
    rng = np.random.default_rng(seed)
    x = _planted(n, m_arr, r, seed=seed)
    lwt = np.zeros((nb, rp, n))
    lh = np.zeros((nb, rp, m_arr))
    lwt[:, :r] = rng.gamma(1.0, 1.0, (nb, r, n))
    lh[:, :r] = rng.gamma(1.0, 1.0, (nb, r, m_arr))
    eh = lh * rng.uniform(0.5, 1.5, lh.shape)
    sc = np.zeros((nb, 8))
    sc[:, :4] = rng.uniform(0.7, 1.3, (nb, 4))
    sc[:, 4] = np.finfo(np.float64).eps
    sc[:, 5] = [r - b % 2 for b in range(nb)]
    sc[:, 6] = 77.0
    sc[:, 7] = 1.0
    return x, lwt, lh, eh, sc


@pytest.mark.parametrize("cells", [1, 2, 4])
def test_sharded_sweep_matches_jax(cells):
    """One sweep of two lanes (r_live 5 and 4), with the live cells
    ending inside the last shard, against JAX's make_sol_sweep_sharded
    lane by lane: all seven outputs within 1e-10."""
    n, m_arr, m_live, r, rp, nb = 16, 512, 487, 5, 8, 2
    x, lwt, lh, eh, sc = _sweep_case(n, m_arr, r, rp, nb, seed=11)
    x[:, m_live:] = 0
    jsweep = jss.make_sol_sweep_sharded(_jax_mesh(cells))
    xs = tsh.place_counts(torch.tensor(x), _cpu_mesh(cells))[0]
    tsweep = tss.make_sol_sweep_sharded(_cpu_mesh(cells))
    tss.reset_launches()
    got = tsweep(xs, torch.tensor(lwt), xs.shard_h(torch.tensor(lh)),
                 xs.shard_h(torch.tensor(eh)), torch.tensor(sc), n=n,
                 m_arr=m_arr, m_live=m_live, r=r)
    assert all(v == 0 for v in tss.LAUNCHES.values())
    got = got[:3] + tuple(xs.gather_h(p) for p in got[3:6]) + got[6:]
    for b in range(nb):
        want = jsweep(jnp.asarray(x), jnp.asarray(lwt[b]),
                      jnp.asarray(lh[b]), jnp.asarray(eh[b]),
                      jnp.asarray(sc[b:b + 1]), n=n, m_arr=m_arr,
                      m_live=m_live, r=r, bn=BN, bm=BM)
        for g, w, name in zip(got[:6], want[:6], ("ewt", "lwtn", "dwt",
                                                  "eh", "lhn", "dh")):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w),
                                       rtol=1e-10, atol=1e-300,
                                       err_msg=f"{name} lane {b}")
        ws = np.asarray(want[6])[0]
        gs = got[6][b].numpy()
        for js, ts in ((jsol._PEND, tsol.PEND), (jsol._DTERM, tsol.DTERM),
                       (jsol._AW, tsol.AW), (jsol._BW, tsol.BW),
                       (jsol._AH, tsol.AH), (jsol._BH, tsol.BH),
                       (jsol._HFAIL, tsol.HFAIL)):
            np.testing.assert_allclose(gs[ts], ws[js], rtol=1e-10,
                                       err_msg=f"slot {ts} lane {b}")


def test_plain_sharded_sweep_one_shard_is_sol_sweep_plain():
    """With one shard the plain sharded sweep is sol_sweep_plain, bit
    for bit (ragged live cells and r_live included)."""
    n, m_arr, r, rp, nb = 13, 90, 5, 8, 3
    x, lwt, lh, eh, sc = _sweep_case(n, m_arr, r, rp, nb, seed=12)
    xt = torch.tensor(x, dtype=torch.int8)
    xs = tsh.place_counts(xt, _cpu_mesh(1))[0]
    args = (torch.tensor(lwt), torch.tensor(lh), torch.tensor(eh),
            torch.tensor(sc))
    for bf16 in (False, True):
        want = tsol.sol_sweep_plain(xt, *args, n=n, m_arr=m_arr, m_live=80,
                                    r=r, mxu_bf16=bf16)
        got = tss.make_sol_sweep_sharded(_cpu_mesh(1))(
            xs, args[0], xs.shard_h(args[1]), xs.shard_h(args[2]), args[3],
            n=n, m_arr=m_arr, m_live=80, r=r, mxu_bf16=bf16)
        for g, w in zip(got, want):
            assert torch.equal(g[0] if isinstance(g, tuple) else g, w)


def test_sharded_sweep_rejects_bad_layouts():
    n, m, r, rp, nb = 8, 40, 3, 8, 1
    x, lwt, lh, eh, sc = _sweep_case(n, m, r, rp, nb, seed=1)
    sweep = tss.make_sol_sweep_sharded(_cpu_mesh(2))
    xs = tsh.place_counts(torch.tensor(x), _cpu_mesh(2))[0]
    a = (torch.tensor(lwt), xs.shard_h(torch.tensor(lh)),
         xs.shard_h(torch.tensor(eh)), torch.tensor(sc))
    with pytest.raises(TypeError, match="cell shards"):
        sweep(torch.tensor(x), *a, n=n, m_arr=m, m_live=m, r=r)
    with pytest.raises(ValueError, match="cell shards"):
        sweep(xs, a[0], a[1][:1], a[2], a[3], n=n, m_arr=m, m_live=m, r=r)
    with pytest.raises(NotImplementedError, match="make_fused_sharded"):
        tss.make_sol_sweep_sharded(_cpu_mesh(2, genes=2))
    with pytest.raises(ValueError, match="CUDA"):
        tss.xpass_shard(xs.blocks[0][0], *a[:1], a[1][0], a[2][0], a[3])
    assert tss.LAUNCHES["xpass_shard"] == 0


@pytest.mark.parametrize("m,m_arr,m_live,base,mp_loc,want", [
    (None, 512, 487, 384, 128, (103, 128)),
    (None, 512, 487, 0, 128, (128, 128)),
    (None, 252, 250, 189, 63, (61, 63)),
    (None, 100, 90, 100, 50, (0, 0)),
])
def test_shard_extents_are_jax_ax_live_ax_true(m, m_arr, m_live, base,
                                               mp_loc, want):
    assert tss.shard_extents(m_live, m_arr, base, mp_loc) == want
    k = base // mp_loc
    jl = int(np.clip(m_live - k * mp_loc, 0, mp_loc))
    jt = int(np.clip(m_arr - k * mp_loc, 0, mp_loc))
    assert (jl, jt) == want


# ---------------------------------------------------------------------
# vb_run_sol(sweep_fn=...) over the mesh
# ---------------------------------------------------------------------

def _loop_case(cells, rmax=3, nb=1, seed=0, m=250):
    """A planted (20, m) problem padded to the mesh: JAX's x (padded to
    its blocks as tests/test_sol_sharded.py pads it), the port's x
    (padded to the mesh only), the padded initial states and masks."""
    n = 20
    x = _planted(n, m, 3, seed=seed)
    m_pad = -(-m // cells) * cells
    rng = np.random.default_rng(seed + 1)
    w = rng.gamma(1.0, 1.0, (nb, n, rmax))
    h = np.ones((nb, rmax, m_pad))
    h[:, :, :m] = rng.gamma(1.0, 1.0, (nb, rmax, m))
    st = jvb.VBState(ew=w, eh=h * (np.arange(m_pad) < m), lw=w, lh=h,
                     dw=np.zeros_like(w), dh=np.zeros_like(h),
                     lkh=np.full(nb, -np.inf))
    mask = (np.arange(m_pad) < m).astype(np.float64)
    xt = np.pad(x, ((0, 0), (0, m_pad - m)))
    np_ = -(-n // BN) * BN
    mp_ = cells * (-(-(m_pad // cells) // BM) * BM)
    xj = np.pad(x, ((0, np_ - n), (0, mp_ - m)))
    return xj, xt, st, mask, m


def _jax_lane(xj, st, b, cells, mask, m, **kw):
    stb = jax.tree.map(lambda a: jnp.asarray(a[b]), st)
    return jsol.vb_run_sol(jnp.asarray(xj), stb,
                           jvb.Hyper(*(jnp.asarray(1.0),) * 4), bn=BN,
                           bm=BM, cell_mask=jnp.asarray(mask), m_true=m,
                           sweep_fn=jss.make_sol_sweep_sharded(
                               _jax_mesh(cells)), **kw)


@pytest.mark.parametrize("cells", [1, 2, 4])
def test_vb_run_sol_sharded_matches_jax(cells):
    """25 sweeps of the mesh loop (250 cells: shards of 250, 125 and 63
    with the last shard ragged): equal n_iter, lml within 1e-9."""
    xj, xt, st, mask, m = _loop_case(cells)
    kw = dict(itmax=25, tol=1e-6)
    jo = _jax_lane(xj, st, 0, cells, mask, m, **kw)
    xs = tsh.place_counts(torch.tensor(xt, dtype=torch.int16),
                          _cpu_mesh(cells))[0]
    to = tsol.vb_run_sol(xs, tvb.state_from_numpy(st, device="cpu"),
                         tvb.Hyper(*(torch.ones(1, dtype=F64),) * 4),
                         cell_mask=torch.tensor(mask), m_true=m,
                         sweep_fn=tss.make_sol_sweep_sharded(
                             _cpu_mesh(cells)), **kw)
    assert int(to.n_iter[0]) == int(jo.n_iter)
    np.testing.assert_allclose(float(to.lml[0]), float(jo.lml), rtol=1e-9)
    for f in ("ew", "eh", "lh"):
        np.testing.assert_allclose(getattr(to.state, f)[0].numpy(),
                                   np.asarray(getattr(jo.state, f)),
                                   rtol=1e-7, atol=1e-300, err_msg=f)


def test_vb_run_sol_one_shard_is_single_device():
    """cells=1 runs every reduction of the single-device loop: the
    same bits (tests/test_sol_sharded.py:46-64 for JAX)."""
    _, xt, st, mask, m = _loop_case(1, nb=3, seed=2, m=120)
    x = torch.tensor(xt, dtype=torch.int16)
    args = (tvb.state_from_numpy(st, device="cpu"),
            tvb.Hyper(*(torch.ones(3, dtype=F64),) * 4))
    kw = dict(itmax=40, tol=1e-6, cell_mask=torch.tensor(mask), m_true=m)
    a = tsol.vb_run_sol(x, *args, **kw)
    b = tsol.vb_run_sol(tsh.place_counts(x, _cpu_mesh(1))[0], *args,
                        sweep_fn=tss.make_sol_sweep_sharded(_cpu_mesh(1)),
                        **kw)
    assert torch.equal(a.n_iter, b.n_iter) and torch.equal(a.lml, b.lml)
    for u, v in zip(a.state + a.hyper, b.state + b.hyper):
        assert torch.equal(u, v)


def test_rank_masked_lanes_match_their_unbatched_runs():
    """tests/test_sol_sharded.py:91-120 on the port: a batch of two
    lanes with prefix rank masks (3 and 4 of 4) over a 4-shard mesh;
    each lane equals its run beside a copy of itself (a lone lane takes
    other CPU matmul paths, see vb_driver.chunk_lanes)."""
    _, xt, st, mask, m = _loop_case(4, rmax=4, nb=1, seed=3)
    xs = tsh.place_counts(torch.tensor(xt), _cpu_mesh(4))[0]
    sweep = tss.make_sol_sweep_sharded(_cpu_mesh(4))
    st2 = tvb.state_from_numpy(jax.tree.map(
        lambda a: np.concatenate([a, a]), st), device="cpu")
    hy = tvb.Hyper(*(torch.ones(2, dtype=F64),) * 4)
    rmask = torch.tensor([[1., 1., 1., 0.], [1., 1., 1., 1.]], dtype=F64)
    rtrue = torch.tensor([3., 4.], dtype=F64)
    kw = dict(itmax=20, tol=1e-6, cell_mask=torch.tensor(mask), m_true=m,
              sweep_fn=sweep)
    both = tsol.vb_run_sol(xs, st2, hy, rank_mask=rmask, r_true=rtrue,
                           **kw)
    for lane in range(2):
        one = tsol.vb_run_sol(xs, st2, hy, rank_mask=rmask[[lane, lane]],
                              r_true=rtrue[[lane, lane]], **kw)
        assert torch.equal(one.lml[0], both.lml[lane])
        assert torch.equal(one.state.ew[0], both.state.ew[lane])


def test_vb_run_epi_cell_mask_matches_jax():
    """vb_run_epi takes the mesh's cell mask: cells past m_true pinned,
    as JAX's loop pins them."""
    n, m, m_pad, r = 16, 120, 128, 3
    x = _planted(n, m, r, seed=9)
    xp = np.pad(x, ((0, 0), (0, m_pad - m)))
    st = _state_np(n, m_pad, r, seed=10)
    mask = (np.arange(m_pad) < m).astype(np.float64)
    kw = dict(itmax=30, tol=1e-6, m_true=m)
    jo = jvb.VBRunResult(*jax.tree.map(np.asarray, tuple(
        __import__("ccfindr_tpu.ops.pallas.epilogue", fromlist=["x"]
                   ).vb_run_epi(pk.pad_matrix(jnp.asarray(xp), BN, BM),
                                jax.tree.map(jnp.asarray, st),
                                jvb.Hyper(*(jnp.asarray(1.0),) * 4),
                                bn=BN, bm=BM, cell_mask=jnp.asarray(mask),
                                **kw))))
    tst = tvb.state_from_numpy(jax.tree.map(lambda a: np.asarray(a)[None],
                                            st), device="cpu")
    to = tepi.vb_run_epi(torch.tensor(xp, dtype=torch.int16), tst,
                         tvb.Hyper(*(torch.ones(1, dtype=F64),) * 4),
                         cell_mask=torch.tensor(mask), **kw)
    assert int(to.n_iter[0]) == int(jo.n_iter)
    np.testing.assert_allclose(float(to.lml[0]), float(jo.lml), rtol=1e-9)
    np.testing.assert_allclose(to.state.eh[0].numpy(), jo.state.eh,
                               rtol=1e-7, atol=1e-300)


# ---------------------------------------------------------------------
# vb_factorize(mesh=...)
# ---------------------------------------------------------------------

def _divisible_counts():
    """A planted problem whose extents divide by every mesh below (genes
    by 2, cells by 4): the JAX driver pads an svd2 start to a ragged
    mesh twice (its _pad_state_mesh after an init on the padded X), so
    only unpadded meshes compare with it."""
    x = cf.simulate_whx(nrow=24, ncol=64, rank=3, seed=21, ah=0.5)["x"]
    x = x[:x.shape[0] // 2 * 2, :x.shape[1] // 4 * 4]
    assert (x.sum(axis=0) > 0).all() and (x.sum(axis=1) > 0).all()
    return x


def _driver_pair(backend, cells, genes=1, **extra):
    """The port's and JAX's mesh scans of one problem at float64 from
    svd2 starts (deterministic in both packages)."""
    x = _divisible_counts()
    kw = dict(ranks=[2, 3], nrun=1, verbose=0, Itmax=200,
              initializer="svd2", backend=backend, **extra)
    j = cf.vb_factorize(x, mesh=_jax_mesh(cells, genes=genes), **kw)
    t = ct.vb_factorize(x, mesh=_cpu_mesh(cells, genes=genes),
                        device="cpu", **kw)
    return j, t


def _sweeps(s):
    return s.metadata["timings"][0]["total_sweeps"]


@pytest.mark.parametrize("backend,cells,genes", [
    ("pallas", 1, 1), ("pallas", 2, 1), ("pallas", 4, 1),
    ("dense", 2, 1), ("dense", 4, 1), ("dense_fused", 4, 1),
    ("dense", 2, 2)])
def test_vb_factorize_mesh_matches_jax(backend, cells, genes):
    j, t = _driver_pair(backend, cells, genes)
    assert t.ranks == j.ranks
    assert _sweeps(t) == _sweeps(j)
    np.testing.assert_allclose(t.measure["lml"], j.measure["lml"],
                               rtol=1e-9)
    for k in range(len(t.ranks)):
        np.testing.assert_allclose(t.basis[k], j.basis[k], rtol=1e-7,
                                   atol=1e-300)
        assert t.coeff[k].shape == j.coeff[k].shape


def test_vb_factorize_ragged_mesh_matches_one_device():
    """A cell count that does not divide by the shards (41 cells on 4:
    one padded, masked cell) and a gene count that does not divide by
    2: every backend equals its run on one device."""
    x = ct.simulate_whx(nrow=27, ncol=41, rank=3, seed=44)["x"]
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=150, seed=9,
              device="cpu")
    for backend, mesh in (("pallas", _cpu_mesh(4)), ("dense", _cpu_mesh(4)),
                          ("dense_fused", _cpu_mesh(2, genes=2))):
        ref = ct.vb_factorize(x, backend=backend, **kw)
        got = ct.vb_factorize(x, backend=backend, mesh=mesh, **kw)
        assert got.metadata["timings"][0]["n_iter"] == \
            ref.metadata["timings"][0]["n_iter"]
        np.testing.assert_allclose(got.measure["lml"], ref.measure["lml"],
                                   rtol=1e-9)
        for a, b in zip(got.basis, ref.basis):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-300)


def test_runs_axis_is_bit_identical():
    """runs=2 (two lane groups) equals runs=1, bit for bit."""
    x = ct.simulate_whx(nrow=24, ncol=50, rank=3, seed=31)["x"]
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=150, seed=2,
              backend="pallas", device="cpu")
    a = ct.vb_factorize(x, mesh=_cpu_mesh(2), **kw)
    b = ct.vb_factorize(x, mesh=_cpu_mesh(2, runs=2), **kw)
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    assert a.metadata["timings"][0]["n_iter"] == \
        b.metadata["timings"][0]["n_iter"]
    for u, v in zip(a.basis + a.coeff, b.basis + b.coeff):
        np.testing.assert_array_equal(u, v)


def test_mesh_elbo_every_and_bf16():
    """tests/test_sol_sharded.py:123-139 on the port: elbo_every and
    precision='bf16' reach the mesh path; conservative stopping,
    evidences tracking the per-sweep run."""
    x = ct.simulate_whx(nrow=20, ncol=33, rank=3, seed=44)["x"]
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=300, seed=9,
              backend="pallas", mesh=_cpu_mesh(4), device="cpu")
    a = ct.vb_factorize(x, **kw)
    b = ct.vb_factorize(x, elbo_every=5, **kw)
    np.testing.assert_allclose(a.measure["lml"], b.measure["lml"],
                               rtol=1e-3)
    c = ct.vb_factorize(x, precision="bf16", elbo_every=5, **kw)
    assert np.isfinite(c.measure["lml"]).all()
    np.testing.assert_allclose(c.measure["lml"], a.measure["lml"],
                               rtol=0.05)


@pytest.mark.parametrize("backend,cells,genes,override", [
    ("pallas", 2, 2, False), ("sparse", 4, 1, False),
    ("pallas2pass", 2, 1, False), ("dense", 2, 1, True)])
def test_mesh_options_match_jax(backend, cells, genes, override):
    """The mesh options that raised before they were ported: the
    gene-sharded 'pallas' sweep (E1 a block), 'sparse' (S1/S2 a cell
    shard), 'pallas2pass' (P1/P2 a block) and a user's suffstats/
    data_term (the whole padded X), each against the JAX driver's mesh
    run, at the tolerances of test_vb_factorize_mesh_matches_jax."""
    extra = {}
    if override:
        extra = dict(suffstats=jvb.suffstats_dense,
                     data_term=jvb.elbo_data_term)
    x = _divisible_counts()
    kw = dict(ranks=[2, 3], nrun=1, verbose=0, Itmax=200,
              initializer="svd2", backend=backend)
    j = cf.vb_factorize(x, mesh=_jax_mesh(cells, genes=genes), **kw,
                        **extra)
    if override:
        extra = dict(suffstats=tvb.suffstats_dense,
                     data_term=tvb.elbo_data_term)
    t = ct.vb_factorize(x, mesh=_cpu_mesh(cells, genes=genes), device="cpu",
                        **kw, **extra)
    assert t.ranks == j.ranks
    assert _sweeps(t) == _sweeps(j)
    np.testing.assert_allclose(t.measure["lml"], j.measure["lml"],
                               rtol=1e-9)
    for k in range(len(t.ranks)):
        np.testing.assert_allclose(t.basis[k], j.basis[k], rtol=1e-7,
                                   atol=1e-300)


@pytest.mark.parametrize("kw,match", [
    (dict(_process_count=2), "A7c"),
])
def test_mesh_options_still_to_port(kw, match):
    x = ct.simulate_whx(nrow=12, ncol=20, rank=2, seed=1)["x"]
    with pytest.raises(NotImplementedError, match=match):
        ct.vb_factorize(x, ranks=[2], verbose=0, device="cpu", **kw)
