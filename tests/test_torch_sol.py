"""The port's sweep (ccfindr_tpu_torch.ops.kernels.sol) against the JAX
package's single-launch Pallas sweep (ccfindr_tpu.ops.pallas.sol), which
runs here in interpret mode with BN, BM = 8, 128 as tests/test_sol.py
runs it.  Everything is float64; tolerances are those of
tests/test_sol.py (one sweep 1e-10 on factors and 1e-9 on scalar sums;
loops: equal n_iter, lml 1e-9, factors 1e-7, hypers 1e-8).

On the CPU the wrapper takes the plain PyTorch version; the CUDA kernels
are compared with it on the card (tests/test_torch_kernels.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccfindr_tpu.ops.pallas import sol as jsol
from ccfindr_tpu.ops.pallas import vb_kernels as pk
from ccfindr_tpu.ops.vb import Hyper as JHyper, VBState as JVBState
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.ops.kernels import sol as tsol

torch.set_num_threads(2)

BN, BM = 8, 128
SLOTS = [(jsol._XLOG, tsol.XLOG), (jsol._U2, tsol.U2),
         (jsol._U3, tsol.U3), (jsol._SEW, tsol.SEW),
         (jsol._SLW, tsol.SLW), (jsol._SEH, tsol.SEH),
         (jsol._SLH, tsol.SLH), (jsol._DTW, tsol.DTW),
         (jsol._DTH, tsol.DTH), (jsol._PEND, tsol.PEND),
         (jsol._DTERM, tsol.DTERM), (jsol._AW, tsol.AW),
         (jsol._BW, tsol.BW), (jsol._AH, tsol.AH), (jsol._BH, tsol.BH),
         (jsol._HFAIL, tsol.HFAIL)]


def _planted(n, m, r, seed=0):
    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.8, 1.0, (n, r))
    hf = rng.gamma(0.8, 1.0, (r, m))
    return np.minimum(rng.poisson(wf @ hf * (2.0 * n * m / (wf @ hf).sum())),
                      127).astype(np.float64)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("xdt,r_live,do_elbo", [
    (torch.float64, 5, 1.0), (torch.int8, 3, 1.0),
    (torch.int16, 3, 0.0), (torch.float64, 4, 0.0)])
def test_sweep_plain_matches_jax(xdt, r_live, do_elbo):
    n, m, r, rp = 21, 200, 5, 8
    rng = np.random.default_rng(7)
    x = _planted(n, m, r)
    lw = rng.gamma(1.0, 1.0, (n, r))
    lh = rng.gamma(1.0, 1.0, (r, m))
    eh = lh * rng.uniform(0.5, 1.5, (r, m))
    xp = pk.pad_matrix(jnp.asarray(x), BN, BM)
    np_, mp_ = xp.shape
    lwt_p, lh_p = jsol._pad_factors_t(jnp.asarray(lw), jnp.asarray(lh),
                                      np_, mp_, rp)
    eh_p = jnp.pad(jnp.asarray(eh), ((0, rp - r), (0, mp_ - m)))
    sc = jnp.asarray([[1.1, 0.9, 1.2, 0.8, np.finfo(np.float64).eps,
                       float(r_live), 123.0, do_elbo]])
    want = jsol.sol_sweep(xp, lwt_p, lh_p, eh_p, sc, n=n, m_arr=m,
                          m_live=m, r=r, bn=BN, bm=BM)
    tsol.reset_launches()
    got = tsol.sol_sweep(_t(xp, xdt), _t(lwt_p)[None], _t(lh_p)[None],
                         _t(eh_p)[None], _t(sc), n=n, m_arr=m, m_live=m,
                         r=r)
    names = ("ewt", "lwtn", "dwt", "eh", "lhn", "dh")
    for g, w, name in zip(got[:6], want[:6], names):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w),
                                   rtol=1e-10, atol=0, err_msg=name)
    gs, ws = got[6][0].numpy(), np.asarray(want[6])[0]
    for js, ts in SLOTS:
        np.testing.assert_allclose(gs[ts], ws[js], rtol=1e-9, atol=1e-300,
                                   err_msg=str(ts))
    # CPU tensors take the plain version: no kernel was launched
    assert all(v == 0 for v in tsol.LAUNCHES.values())


def test_sweep_plain_unpadded_equals_padded():
    """The port's own layout (X unpadded) gives the padded sweep's
    values on the live extent."""
    n, m, r, rp = 13, 70, 3, 8
    rng = np.random.default_rng(2)
    x = _planted(n, m, r, seed=4)
    lw = rng.gamma(1.0, 1.0, (n, r))
    lh = rng.gamma(1.0, 1.0, (r, m))
    sc = torch.tensor([[1.0, 1.0, 1.0, 1.0, 2.2e-16, 3.0, 0.0, 1.0]],
                      dtype=torch.float64)

    def layout(np_, mp_):
        lwt = torch.zeros(1, rp, np_, dtype=torch.float64)
        lwt[0, :r] = 1.0
        lwt[0, :r, :n] = _t(lw.T)
        lhp = torch.zeros(1, rp, mp_, dtype=torch.float64)
        lhp[0, :r] = 1.0
        lhp[0, :r, :m] = _t(lh)
        ehp = torch.zeros_like(lhp)
        ehp[0, :r, :m] = _t(lh)
        xp = torch.zeros(np_, mp_, dtype=torch.int8)
        xp[:n, :m] = _t(x, torch.int8)
        return tsol.sol_sweep(xp, lwt, lhp, ehp, sc, n=n, m_arr=m,
                              m_live=m, r=r)

    a = layout(n, m)
    b = layout(16, 128)
    for u, v in zip(a[:3], b[:3]):
        torch.testing.assert_close(u, v[..., :n], rtol=1e-12, atol=0)
    for u, v in zip(a[3:6], b[3:6]):
        torch.testing.assert_close(u, v[..., :m], rtol=1e-12, atol=0)
    torch.testing.assert_close(a[6], b[6], rtol=1e-12, atol=0)


def _batched_pair(ranks, itmax, elbo_every=1, seed=0):
    """JAX vmap(vb_run_sol) with prefix rank masks, as
    ccfindr_tpu/drivers/vb_driver.py:993-1005 builds it, vs the port's
    lane-batched vb_run_sol on the same initial states."""
    n, m = 24, 150
    rmax = max(ranks)
    nb = len(ranks)
    x = _planted(n, m, 3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    w = rng.gamma(1.0, 1.0, (nb, n, rmax))
    h = rng.gamma(1.0, 1.0, (nb, rmax, m))
    st = JVBState(ew=w, eh=h, lw=w, lh=h, dw=np.zeros_like(w),
                  dh=np.zeros_like(h), lkh=np.full(nb, -np.inf))
    rmask = (np.arange(rmax)[None] < np.asarray(ranks)[:, None]
             ).astype(np.float64)
    rtrue = np.asarray(ranks, np.float64)
    kw = dict(itmax=itmax, tol=1e-6, elbo_every=elbo_every)
    xp = pk.pad_matrix(jnp.asarray(x), BN, BM)
    jout = jax.vmap(lambda s, hy, rm, rt: jsol.vb_run_sol(
        xp, s, hy, rank_mask=rm, r_true=rt, bn=BN, bm=BM, **kw))(
            jax.tree.map(jnp.asarray, st),
            JHyper(*(jnp.ones(nb),) * 4), jnp.asarray(rmask),
            jnp.asarray(rtrue))
    tout = tsol.vb_run_sol(
        _t(x, torch.int16), tvb.state_from_numpy(st, device="cpu"),
        tvb.Hyper(*(torch.ones(nb, dtype=torch.float64),) * 4),
        rank_mask=_t(rmask), r_true=_t(rtrue), **kw)
    return jax.tree.map(np.asarray, jout), tvb.state_to_numpy(tout)


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
                                   getattr(jout.hyper, f), rtol=1e-8,
                                   err_msg=f)


@pytest.mark.parametrize("itmax", [4, 300])
def test_batched_vb_run_sol_matches_vmapped_jax(itmax):
    jout, tout = _batched_pair([2, 3, 4, 5], itmax)
    _assert_runs_close(jout, tout)
    if itmax == 300:
        assert tout.done.all() and len(set(tout.n_iter.tolist())) > 1


def test_batched_vb_run_sol_elbo_every_matches_jax():
    jout, tout = _batched_pair([2, 4], 200, elbo_every=3, seed=5)
    _assert_runs_close(jout, tout)


def test_vb_run_sol_sparse_host_checks_are_exact(monkeypatch):
    """Testing ``done`` only every few sweeps changes nothing: stopped
    lanes are frozen."""
    n, m, r, nb = 20, 90, 3, 3
    x = torch.tensor(_planted(n, m, r, seed=8), dtype=torch.int8)
    gen = torch.Generator().manual_seed(1)
    hy1 = tvb.Hyper(1.0, 1.0, 1.0, 1.0)
    sts = [tvb.vb_init_random(gen, n, m, r, hy1, torch.float64, device="cpu")
           for _ in range(nb)]
    st = tvb.VBState(*(torch.stack(f) for f in zip(*sts)))
    hy = tvb.Hyper(*(torch.ones(nb, dtype=torch.float64),) * 4)
    a = tsol.vb_run_sol(x, st, hy, itmax=250, tol=1e-6)
    monkeypatch.setattr(tsol, "HOST_CHECK_EVERY", 7)
    b = tsol.vb_run_sol(x, st, hy, itmax=250, tol=1e-6)
    assert torch.equal(a.n_iter, b.n_iter) and bool(a.done.all())
    for u, v in zip(a.state, b.state):
        assert torch.equal(u, v)
    assert torch.equal(a.lml, b.lml)


def _sweep_args(**over):
    nb, rp, n, m = 2, 8, 10, 20
    args = dict(x=torch.zeros(n, m, dtype=torch.int8),
                lwt=torch.ones(nb, rp, n, dtype=torch.float64),
                lh=torch.ones(nb, rp, m, dtype=torch.float64),
                eh=torch.ones(nb, rp, m, dtype=torch.float64),
                sc=torch.ones(nb, 8, dtype=torch.float64))
    args.update(over)
    return args


@pytest.mark.parametrize("over,exc", [
    (dict(x=torch.zeros(10, 20, dtype=torch.uint8)), TypeError),
    (dict(lwt=torch.ones(2, 8, 10, dtype=torch.float16)), TypeError),
    (dict(sc=torch.ones(2, 8, dtype=torch.float32)), TypeError),
    (dict(sc=torch.ones(3, 8, dtype=torch.float64)), ValueError),
    (dict(lh=torch.ones(2, 8, 21, dtype=torch.float64)), ValueError),
    (dict(lwt=torch.ones(2, 12, 10, dtype=torch.float64)), ValueError),
    (dict(x=torch.zeros(20, 10, dtype=torch.int8).t()), ValueError),
])
def test_sweep_rejects_bad_inputs(over, exc):
    a = _sweep_args(**over)
    with pytest.raises(exc):
        tsol.sol_sweep(a["x"], a["lwt"], a["lh"], a["eh"], a["sc"], n=10,
                       m_arr=20, m_live=20, r=5)


def test_kernel_wrappers_refuse_cpu_tensors():
    a = _sweep_args()
    with pytest.raises(ValueError, match="CUDA"):
        tsol.xpass(a["x"], a["lwt"], a["lh"], a["eh"], a["sc"])
    assert tsol.LAUNCHES["xpass"] == 0


# ---------------------------------------------------------------------
# K1's partials at its chunks (sol.CHUNK): the reference the card tests
# hold the kernel's partials against
# ---------------------------------------------------------------------

def _k1_case(n, m, r, lanes, xdt, seed=11):
    """Seeded float64 K1 inputs in the kernel layout: lane b's rank rows
    [lanes[b], r) at eps; lane 1 with do_elbo off."""
    rng = np.random.default_rng(seed)
    rp = tsol.round_up(max(r, 8), 8)
    nb = len(lanes)
    x = _planted(n, m, r, seed=seed)
    lwt = np.zeros((nb, rp, n))
    lh = np.zeros((nb, rp, m))
    eps = np.finfo(np.float64).eps
    for b, rk in enumerate(lanes):
        lwt[b, :rk] = rng.gamma(1.0, 1.0, (rk, n))
        lh[b, :rk] = rng.gamma(1.0, 1.0, (rk, m))
        lwt[b, rk:r] = eps
        lh[b, rk:r] = eps
    sc = np.zeros((nb, 8))
    sc[:, :4] = rng.uniform(0.5, 1.5, (nb, 4))
    sc[:, 4] = eps
    sc[:, 5] = lanes
    sc[:, 7] = [float(b != 1) for b in range(nb)]
    return (_t(x, xdt), _t(lwt), _t(lh), _t(lh * 0.9), _t(sc))


def _chunk_sums(parts):
    """The partials added in chunk order in float64, as K2, K3 and K4
    add them, then rounded to the factor type."""
    swn, shn, xlog, ehs = parts
    return (swn.sum(1, dtype=torch.float64).to(swn.dtype),
            shn.sum(1, dtype=torch.float64).to(shn.dtype),
            xlog.sum(1), ehs.sum(1))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,m,r,lanes,xdt", [
    (300, 700, 6, [3, 4, 5, 6], torch.int8),
    (517, 260, 16, [16, 9], torch.int16),
    (70, 513, 40, [40, 33], torch.float64),
])
def test_k1_chunked_partials_sum_to_xpass_plain(n, m, r, lanes, xdt, bf16):
    """The per-chunk partials of ``sol.xpass_partials_plain`` (swn a
    cell chunk, shn a gene chunk, x*log(wth) a block, rowSums(eh) a cell
    chunk), summed in chunk order, are ``sol.xpass_plain``'s values to
    1e-12 (float64: only the order of the sums differs)."""
    x, lwt, lh, eh, sc = _k1_case(n, m, r, lanes, xdt)
    parts = tsol.xpass_partials_plain(x, lwt, lh, eh, sc, mxu_bf16=bf16)
    gch, cch = tsol.CHUNK
    nb, rp = lwt.shape[:2]
    ngc, ncc = -(-n // gch), -(-m // cch)
    assert parts[0].shape == (nb, ncc, rp, n)
    assert parts[1].shape == (nb, ngc, rp, m)
    assert parts[2].shape == (nb, ngc * ncc)
    assert parts[3].shape == (nb, ncc, rp)
    assert ngc * ncc > 1
    want = tsol.xpass_plain(x, lwt, lh, eh, sc, mxu_bf16=bf16)
    for g, w in zip(_chunk_sums(parts), want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    # do_elbo off: every x*log(wth) partial of lane 1 is 0
    assert not bool(parts[2][1].any())


@pytest.mark.parametrize("xdt,r_live,do_elbo", [
    (torch.float64, 5, 1.0), (torch.int8, 3, 1.0), (torch.int16, 3, 0.0)])
def test_k1_chunked_partials_give_the_jax_sweep(monkeypatch, xdt, r_live,
                                               do_elbo):
    """K1's chunked partials, added in chunk order and fed to the plain
    K2-K4, give JAX's single-launch sol_sweep (interpret mode) at
    test_sweep_plain_matches_jax's tolerances, on a shape of several
    gene and cell chunks."""
    n, m, r, rp = 270, 530, 5, 8
    rng = np.random.default_rng(9)
    x = _planted(n, m, r, seed=3)
    lw = rng.gamma(1.0, 1.0, (n, r))
    lh = rng.gamma(1.0, 1.0, (r, m))
    eh = lh * rng.uniform(0.5, 1.5, (r, m))
    xp = pk.pad_matrix(jnp.asarray(x), BN, BM)
    np_, mp_ = xp.shape
    lwt_p, lh_p = jsol._pad_factors_t(jnp.asarray(lw), jnp.asarray(lh),
                                      np_, mp_, rp)
    eh_p = jnp.pad(jnp.asarray(eh), ((0, rp - r), (0, mp_ - m)))
    sc = jnp.asarray([[1.1, 0.9, 1.2, 0.8, np.finfo(np.float64).eps,
                       float(r_live), 123.0, do_elbo]])
    want = jsol.sol_sweep(xp, lwt_p, lh_p, eh_p, sc, n=n, m_arr=m,
                          m_live=m, r=r, bn=BN, bm=BM)

    def from_partials(*args, **kw):
        return _chunk_sums(tsol.xpass_partials_plain(*args, **kw))

    monkeypatch.setattr(tsol, "xpass_plain", from_partials)
    got = tsol.sol_sweep(_t(xp, xdt), _t(lwt_p)[None], _t(lh_p)[None],
                         _t(eh_p)[None], _t(sc), n=n, m_arr=m, m_live=m,
                         r=r)
    names = ("ewt", "lwtn", "dwt", "eh", "lhn", "dh")
    for g, w, name in zip(got[:6], want[:6], names):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w),
                                   rtol=1e-10, atol=0, err_msg=name)
    gs, ws = got[6][0].numpy(), np.asarray(want[6])[0]
    for js, ts in SLOTS:
        np.testing.assert_allclose(gs[ts], ws[js], rtol=1e-9, atol=1e-300,
                                   err_msg=str(ts))


@pytest.mark.parametrize("nb", [1, 3, 21])
def test_k1_chunks_do_not_depend_on_lanes(nb):
    """K1's chunks are sol.CHUNK whatever the lane count (resume and
    lane compaction stay bit-exact), and its cell chunk divides 512 and a
    2,048-cell shard (whole-chunk shards give the single-device
    partials)."""
    lanes = [4] * nb
    x, lwt, lh, eh, sc = _k1_case(600, 2100, 4, lanes, torch.int8)
    parts = tsol.xpass_partials_plain(x, lwt, lh, eh, sc)
    gch, cch = tsol.CHUNK
    assert parts[0].shape[1] == -(-2100 // cch)
    assert parts[1].shape[1] == -(-600 // gch)
    assert 512 % cch == 0 and 2048 % cch == 0
    # the lanes of a batch are the lanes alone
    one = tsol.xpass_partials_plain(x, lwt[:1], lh[:1], eh[:1], sc[:1])
    for a, b in zip(parts, one):
        torch.testing.assert_close(a[:1], b, rtol=1e-14, atol=0)


@pytest.mark.parametrize("ext,rp", [(1, 8), (257, 16), (4096, 24),
                                    (8192, 128)])
def test_post_block_is_a_constant_of_post_cuh(monkeypatch, ext, rp):
    """K2/K3's block (all rank rows of POST_COLS long-axis columns of a
    lane, csrc/post.cuh kPostCols) is a constant that divides 512 and
    K1's cell chunk, so whole-chunk cell shards give the single-device
    partials; _post sizes its rank-sum and scalar partials from (ext,
    rp) alone, one a block, whatever the lane count."""
    import re

    from ccfindr_tpu_torch.ops.kernels import build as tbuild

    src = (tbuild.CSRC / "post.cuh").read_text()
    cols = int(re.search(r"constexpr int kPostCols = (\d+);",
                         src).group(1))
    assert cols == tsol.POST_COLS
    assert 512 % cols == 0 and tsol.CHUNK[1] % cols == 0
    assert re.search(r"grid\(ceil_div\(ext, kPostCols\), B\)", src)

    launched = []

    def launch(entry, *args):
        assert entry == "sol_h_post"
        launched.append(args)

    monkeypatch.setattr(tsol, "launch", launch)
    nblk = -(-ext // tsol.POST_COLS)
    for nb in (1, 3, 6):
        lh = torch.ones(nb, rp, ext)
        shn = torch.ones(nb, 2, rp, ext)
        csum = torch.zeros(nb, 5, rp, dtype=torch.float64)
        sc = torch.zeros(nb, 8, dtype=torch.float64)
        out = tsol.launch_h_post(shn, lh, csum, sc, rp, ext, ext)
        assert out[3].shape == (nb, nblk, rp)
        assert out[4].shape == (nb, nblk, 4)
        assert all(t.shape == lh.shape for t in out[:3])
    assert len(launched) == 3


@pytest.mark.parametrize("nb,lane_bytes,budget,sizes", [
    (6, 16.8e6, None, [6]),                 # the 10x batch: one launch
    (38, 1.54e9, None, [9, 10, 9, 10]),     # the atlas: 11 lanes fit
    (38, 1.44e9, None, [9, 10, 9, 10]),     # the atlas after QC
    (5, 10, 3, [1] * 5),                    # a lane above the budget
    (7, 10, 30, [2, 2, 3]),
])
def test_lane_groups_split_by_partial_bytes(monkeypatch, nb, lane_bytes,
                                           budget, sizes):
    """K1-K3's lane groups: consecutive, covering every lane once, as
    few as keep a group's partials within the budget, their sizes
    within one of each other."""
    if budget is not None:
        monkeypatch.setattr(tsol, "LANE_GROUP_BYTES", budget)
    groups = tsol.lane_groups(nb, lane_bytes)
    assert [g.stop - g.start for g in groups] == sizes
    assert groups[0].start == 0 and groups[-1].stop == nb
    assert all(a.stop == b.start for a, b in zip(groups, groups[1:]))
    cap = tsol.LANE_GROUP_BYTES if budget is None else budget
    assert all((g.stop - g.start) * lane_bytes <= cap
               for g in groups if g.stop - g.start > 1)
    assert tsol.lane_part_bytes(20480, 100352, 24, 4) == \
        (392 * 20480 + 80 * 100352) * 24 * 4


def test_grouped_sweep_gives_each_lane_its_bits(monkeypatch):
    """sweep_kernels over lane groups (K1-K3 a group, K4 once) gives the
    bits of one group, lane by lane; run here with the four wrappers
    replaced by plain versions that treat each lane alone, counting
    their launches as the wrappers do."""
    launched = {k: 0 for k in tsol.LAUNCHES}

    def lanewise(fn):
        def run(*args):
            lanes = [fn(*(a[b:b + 1] if torch.is_tensor(a) and a.dim()
                          and a.shape[0] == args[0].shape[0] else a
                          for a in args))
                     for b in range(args[0].shape[0])]
            return tuple(torch.cat(t) for t in zip(*lanes))
        return run

    def xpass(x, lwt, lh, eh, sc, mxu_bf16=False):
        launched["xpass"] += 1
        return lanewise(lambda lwt, lh, eh, sc: tsol.xpass_partials_plain(
            x, lwt, lh, eh, sc))(lwt, lh, eh, sc)

    def post(ab):
        def run(sfx, lf, denom, sc, r, n_live, n_pin=None):
            dt = lf.dtype
            a, b, fud, rl = (sc[:, q].to(dt) for q in (ab, ab + 1, 4, 5))
            e, ln, d, rs, scal = tsol.post_plain(
                sfx.sum(1), lf, denom.sum(1), a, b, fud, rl, r, n_live,
                npin=n_pin)
            return e, ln, d, rs[:, None], scal[:, None]
        return run

    def w_post(swn, lwt, ehs, sc, r, n):
        launched["w_post"] += 1
        return lanewise(lambda *a: post(0)(*a, r, n))(swn, lwt, ehs, sc)

    def h_post(shn, lh, csum, sc, r, m_live, m=None):
        launched["h_post"] += 1
        return lanewise(lambda *a: post(2)(*a, r, m_live, m))(shn, lh, csum,
                                                              sc)

    def finish(sc, xl, cs, ws, rs, hs, *, n, m, dt, hyper_mask,
               newton_niter, newton_tol):
        launched["finish"] += 1
        return lanewise(lambda *a: (tsol.finish_plain(
            *a[:1], *(t.sum(1) for t in a[1:]), n, m, dt,
            tuple(hyper_mask), newton_niter, newton_tol),))(
                sc, xl, cs, ws, rs, hs)[0]

    for name, fn in (("xpass", xpass), ("w_post", w_post),
                     ("h_post", h_post), ("finish", finish)):
        monkeypatch.setattr(tsol, name, fn)
    lanes = [5, 3, 4, 5, 2, 4, 3]
    x, lwt, lh, eh, sc = _k1_case(300, 530, 5, lanes, torch.int8)
    kw = dict(n=300, m_live=530, m=530, r=5, hyper_mask=(True,) * 4,
              newton_niter=100, newton_tol=1e-4, mxu_bf16=False)
    one = tsol.sweep_kernels(x, lwt, lh, eh, sc, **kw)
    assert launched == {"xpass": 1, "w_post": 1, "h_post": 1, "finish": 1}
    monkeypatch.setattr(tsol, "LANE_GROUP_BYTES",
                        2.5 * tsol.lane_part_bytes(300, 530, 8, 8))
    got = tsol.sweep_kernels(x, lwt, lh, eh, sc, **kw)
    # 7 lanes, 2 a group: 4 groups, K4 once
    assert launched == {"xpass": 5, "w_post": 5, "h_post": 5, "finish": 2}
    for a, b in zip(got, one):
        assert a.shape == b.shape
        assert torch.equal(a, b)
    # and the sweep they give is the plain sweep's
    want = tsol.sol_sweep_plain(x, lwt, lh, eh, sc, n=300, m_arr=530,
                                m_live=530, r=5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-300)
