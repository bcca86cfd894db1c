"""CUDA kernels K1-K4 (csrc/sol.cu, K1 on fused.cuh's walk; K1s/K3s/K4 of
the cell-sharded sweep), M1/M2 (csrc/ml.cu), S1/S2 (csrc/sparse.cu, also
in their bf16 mode), E1, E1s, E2, E3 (csrc/epi.cu) and P1/P2
(csrc/pass2.cu) against their plain PyTorch versions, on the card; the
tails of M1, S1 and P2 (each lane's last block adds the lane's partials)
against their partials; and the lane-count independence the chunked
drivers rely on. The kernels have no CPU mode, so every test here is
marked ``cuda`` and skips without a CUDA device. The module imports no
JAX, so on a machine with a card (and without JAX) it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: elementwise relative 1e-10 in float64; in float32 2e-4 on
the factors, the hypers and the ML numerators hn/wn, and 1e-5 on the
per-element ELBO and ML likelihood (as chip_smoke.py states them).  The shapes cover ragged edges, shared
memory above the 48 KB default (rp >= 40 in float64) and the largest
padded rank, 128.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ccfindr_tpu_torch.ops import tile
from ccfindr_tpu_torch.ops.kernels import epilogue as epi
from ccfindr_tpu_torch.ops.kernels import build, ml, sol
from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh
from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk
from ccfindr_tpu_torch.ops.kernels import sparse as spk
from ccfindr_tpu_torch.ops.ml import likelihood_const
from ccfindr_tpu_torch.ops.sparse import fold_dterm
from ccfindr_tpu_torch.parallel.sharded import ShardedCounts
from ccfindr_tpu_torch.utils import lane_sum

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, m, r, lanes, dt, xdt, dev, seed=0):
    rng = np.random.default_rng(seed)
    rp = sol.round_up(max(r, 8), 8)
    nb = len(lanes)
    x = np.minimum(rng.poisson(2.0, (n, m)), 127)
    lwt = np.zeros((nb, rp, n))
    lh = np.zeros((nb, rp, m))
    fudge = float(torch.finfo(dt).eps)
    for b, rk in enumerate(lanes):
        lwt[b, :rk] = rng.gamma(1.0, 1.0, (rk, n))
        lh[b, :rk] = rng.gamma(1.0, 1.0, (rk, m))
        lwt[b, rk:r] = fudge
        lh[b, rk:r] = fudge
    sc = np.zeros((nb, 8))
    sc[:, :4] = rng.uniform(0.5, 1.5, (nb, 4))
    sc[:, 4] = fudge
    sc[:, 5] = lanes
    sc[:, 7] = 1.0
    t = lambda a, d=dt: torch.tensor(a, dtype=d, device=dev)  # noqa: E731
    return (t(x, xdt), t(lwt), t(lh), t(lh * 0.9),
            t(sc, torch.float64))


def _rel(got, want):
    tiny = torch.finfo(torch.float32).tiny
    return float(((got.double() - want.double()).abs()
                  / want.double().abs().clamp_min(tiny)).max())


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,lanes,xdt", [
    (300, 700, 6, [3, 4, 5, 6], torch.int8),
    (1030, 517, 16, [16, 9], torch.int16),
    (257, 1100, 40, [40, 33], torch.float32),
    (140, 600, 128, [128, 100], torch.float64),
])
def test_sweep_kernels_match_plain(n, m, r, lanes, xdt, dt):
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(n, m, r, lanes, dt, xdt, dev)
    sol.reset_launches()
    got = sol.sol_sweep(x, lwt, lh, eh, sc, n=n, m_arr=m, m_live=m, r=r)
    torch.cuda.synchronize()
    want = sol.sol_sweep_plain(x, lwt, lh, eh, sc, n=n, m_arr=m, m_live=m,
                               r=r)
    assert all(v == 1 for v in sol.LAUNCHES.values())
    tol = 1e-10 if dt == torch.float64 else 2e-4
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == dt and g.shape == w.shape
        assert _rel(g, w) <= tol
    gs, ws = got[6], want[6]
    for slot in (sol.AW, sol.BW, sol.AH, sol.BH):
        assert _rel(gs[:, slot], ws[:, slot]) <= tol
    elbo_tol = 1e-10 if dt == torch.float64 else 1e-5
    assert _rel(gs[:, sol.PEND] + gs[:, sol.DTERM],
                ws[:, sol.PEND] + ws[:, sol.DTERM]) <= elbo_tol
    assert torch.equal(gs[:, sol.HFAIL], ws[:, sol.HFAIL])


def test_kernel_sweep_is_deterministic():
    """Fixed-order partial sums: two sweeps are bit-identical."""
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(2000, 3000, 16, [16, 12, 8], torch.float32,
                                 torch.int8, dev, seed=3)
    kw = dict(n=2000, m_arr=3000, m_live=3000, r=16)
    a = sol.sol_sweep(x, lwt, lh, eh, sc, **kw)
    b = sol.sol_sweep(x, lwt, lh, eh, sc, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_lane_groups_give_each_lane_its_bits(monkeypatch, dt):
    """K1-K3 over lane groups (a budget of 2.5 lanes' partials: groups
    of 2 of 7 lanes) and K4 once give the bits of one launch of all
    lanes, and launch K1-K3 once a group."""
    dev = _card()
    lanes = [6, 3, 4, 6, 5, 2, 6]
    x, lwt, lh, eh, sc = _inputs(600, 1100, 6, lanes, dt, torch.int8, dev,
                                 seed=5)
    kw = dict(n=600, m_arr=1100, m_live=1100, r=6)
    one = sol.sol_sweep(x, lwt, lh, eh, sc, **kw)
    monkeypatch.setattr(sol, "LANE_GROUP_BYTES", int(
        2.5 * sol.lane_part_bytes(600, 1100, 8, lwt.element_size())))
    sol.reset_launches()
    got = sol.sol_sweep(x, lwt, lh, eh, sc, **kw)
    assert sol.LAUNCHES == {"xpass": 4, "w_post": 4, "h_post": 4,
                            "finish": 1}
    for u, v in zip(got, one):
        assert torch.equal(u, v)


def test_cuda_wrapper_rejects_mixed_devices():
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(50, 60, 4, [4], torch.float64, torch.int8,
                                 dev)
    with pytest.raises(ValueError, match="several devices"):
        sol.sol_sweep(x.cpu(), lwt, lh, eh, sc, n=50, m_arr=60, m_live=60,
                      r=4)


def _ml_inputs(n, m, r, nb, dt, xdt, dev, seed=0, band=False):
    """Lane batch of ML factors; lane 0 pins its last two rank rows at
    eps, as a batched rank scan pins a short lane's rows.  ``band``: X
    rows 64..127 and columns 128..191 all zero (whole 64 x 64 tiles of
    the walk)."""
    rng = np.random.default_rng(seed)
    x = np.minimum(rng.poisson(2.0, (n, m)), 127)
    if band:
        x[64:128] = 0
        x[:, 128:192] = 0
    w = rng.gamma(1.0, 1.0, (nb, n, r))
    h = rng.gamma(1.0, 1.0, (nb, r, m))
    if r > 2:
        eps = float(torch.finfo(dt).eps)
        w[0, :, r - 2:] = eps
        h[0, r - 2:] = eps
    t = lambda a, d=dt: torch.tensor(a, dtype=d, device=dev)  # noqa: E731
    return t(x, xdt), t(w), t(h)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,nb,xdt,band", [
    (300, 700, 6, 4, torch.int8, False),
    (1030, 517, 16, 2, torch.int16, False),
    (257, 1100, 40, 2, torch.float32, False),
    (140, 600, 128, 2, torch.float64, False),
    (65, 63, 1, 3, torch.int8, False),
    (700, 450, 17, 3, torch.int16, False),     # past one 16-wide slab
    (600, 900, 16, 3, torch.int8, True),       # tiles of x = 0
])
def test_ml_kernels_match_plain(n, m, r, nb, xdt, band, dt):
    dev = _card()
    x, w, h = _ml_inputs(n, m, r, nb, dt, xdt, dev, band=band)
    ml.reset_launches()
    hn, xlw = ml.ml_h(x, w, h)
    wn = ml.ml_w(x, w, h)
    torch.cuda.synchronize()
    assert ml.LAUNCHES == {"ml_hpass": 1, "ml_wpass": 1}
    hn_p, xlw_p = ml.ml_h_plain(x, w, h)
    wn_p = ml.ml_w_plain(x, w, h)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    assert hn.dtype == dt and hn.shape == hn_p.shape
    assert wn.dtype == dt and wn.shape == wn_p.shape
    assert _rel(hn, hn_p) <= tol and _rel(wn, wn_p) <= tol
    # the likelihood per element, as the loop forms it
    rest = likelihood_const(x, torch.float64) - (
        w.double().sum(-2) * h.double().sum(-1)).sum(-1)
    assert _rel((xlw + rest) / (n * m), (xlw_p + rest) / (n * m)) <= (
        1e-10 if dt == torch.float64 else 1e-5)


def test_ml_kernels_are_deterministic():
    dev = _card()
    x, w, h = _ml_inputs(2000, 3000, 16, 3, torch.float32, torch.int8, dev,
                         seed=3)
    a = ml.ml_h(x, w, h) + (ml.ml_w(x, w, h),)
    b = ml.ml_h(x, w, h) + (ml.ml_w(x, w, h),)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("xdt,dt", [(torch.int8, torch.float32),
                                    (torch.int16, torch.float64)])
def test_ml_lane_bits_do_not_depend_on_the_batch(xdt, dt):
    """A lane's hn, wn, x*log(wh) and partials are the same bits alone,
    in a pair and in the batch of six: M1's and M2's chunks are
    constants (ml.H_CHUNK, ml.W_CHUNK), as resume and lane compaction
    need."""
    dev = _card()
    x, w, h = _ml_inputs(900, 1300, 16, 6, dt, xdt, dev, seed=5)

    def launch(w, h):
        hn, total, part = ml.ml_hpass(x, w, h)
        return hn, total, part, ml.ml_wpass(x, w, h)

    full = launch(w, h)
    assert full[2].shape == (6, ml.xlog_part_width(1300))
    for sub in ([2], [5], [0, 3]):
        idx = torch.tensor(sub, device=dev)
        got = launch(w[idx].contiguous(), h[idx].contiguous())
        for f, g in zip(full, got):
            assert torch.equal(f[idx], g)


def _m3_order_sum(part):
    """Each lane's sum of its partials in a one-warp sum's order (lane l
    adds partials l, l + 32, ... in turn; then the butterfly over xor 16,
    8, 4, 2, 1): the bits the separate M3 launch gave."""
    nb, nblk = part.shape
    acc = torch.zeros(nb, 32, dtype=torch.float64, device=part.device)
    for i0 in range(0, nblk, 32):
        cnt = min(32, nblk - i0)
        acc[:, :cnt] = acc[:, :cnt] + part[:, i0:i0 + cnt]
    idx = torch.arange(32, device=part.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, idx ^ o]
    return acc[:, 0]


def _tail_launch(which, dt, dev):
    """One launch of the producer ``which``: (each lane's sum, its
    per-block partials)."""
    if which == "m1":
        x, w, h = _ml_inputs(700, 2500, 16, 5, dt, torch.int8, dev, seed=4)
        _, total, part = ml.ml_hpass(x, w, h)
    elif which == "s1":
        tc, lw, lht = _sparse_inputs(1500, 900, 16, 5, dt, torch.int16, dev,
                                     seed=4)
        _, _, total, part = spk.sp_rowpass(tc, lw, lht)
    else:
        x, lw, lh = _pass2_inputs(700, 900, 16, [16, 12, 9, 5, 16], dt,
                                  torch.int8, dev, seed=4)
        total, part = vbk.elbo_xpass(x, lw, vbk.xlogx(lw), lh, vbk.xlogx(lh))
    return total, part


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", ["m1", "s1", "p2"])
def test_lane_tails_sum_their_partials(which, dt):
    """M1's, S1's and P2's tails (the lane's last block adds the lane's
    partials) equal part.sum(-1) to 1e-14 and the bits of M3's order;
    two launches, and a launch of another batch size in between (the
    cached ticket counters reused), give the same bits; the counters
    are 0 after each launch."""
    dev = _card()
    total, part = _tail_launch(which, dt, dev)
    torch.cuda.synchronize()
    ref = part.sum(-1)
    assert float(((total - ref).abs() / ref.abs()).max()) <= 1e-14
    assert torch.equal(total, _m3_order_sum(part))
    again = _tail_launch(which, dt, dev)[0]
    ml.ml_hpass(*_ml_inputs(100, 200, 4, 70, dt, torch.int8, dev))
    third = _tail_launch(which, dt, dev)[0]
    torch.cuda.synchronize()
    assert torch.equal(again, total) and torch.equal(third, total)
    counters = build.tickets(70, dev)
    assert counters.numel() >= 70 and int(counters.abs().sum()) == 0


def _sparse_inputs(n, m, r, nb, dt, vdt, dev, seed=0):
    """A 10%-density Poisson X with an empty row and an empty column, as
    the layout S1/S2 take; lane 0 pins its last two rank rows at eps."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < 0.1) * rng.poisson(3.0, (n, m))
    x = x.astype(np.float64)
    x[min(5, n - 1)] = 0
    x[:, min(7, m - 1)] = 0
    if vdt != torch.int16:
        x[x > 0] += 0.25             # not integers: values in dt
    tc = tile.from_scipy_tile(sp.csr_matrix(x), dtype=dt, device=dev)
    assert tc.val.dtype == vdt
    w = rng.gamma(1.0, 1.0, (nb, n, r))
    h = rng.gamma(1.0, 1.0, (nb, r, m))
    if r > 2:
        w[0, :, r - 2:] = float(torch.finfo(dt).eps)
        h[0, r - 2:] = float(torch.finfo(dt).eps)
    t = lambda a: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    return tc, t(w), t(h).transpose(-1, -2).contiguous()


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,nb,vdt", [
    (300, 700, 6, 4, torch.int16),
    (1030, 517, 16, 2, torch.float64),
    (257, 1100, 40, 2, torch.int16),
    (140, 600, 128, 2, torch.float64),
    (65, 63, 1, 3, torch.int16),
])
def test_sparse_kernels_match_plain(n, m, r, nb, vdt, dt):
    dev = _card()
    vdt = dt if vdt == torch.float64 else vdt
    tc, lw, lht = _sparse_inputs(n, m, r, nb, dt, vdt, dev)
    flags = torch.tensor([1.0, 0.0] * nb, device=dev)[:nb]
    spk.reset_launches()
    ml.reset_launches()
    swn, a, xlog = spk.rowpass(tc, lw, lht, do_elbo=flags)
    shn = spk.colpass(tc, a, lw)
    torch.cuda.synchronize()
    assert spk.LAUNCHES == {"sp_rowpass": 1, "sp_colpass": 1}
    assert ml.LAUNCHES == {"ml_hpass": 0, "ml_wpass": 0}
    swn_p, a_p, xlog_p = spk.rowpass_plain(tc, lw, lht, do_elbo=flags)
    shn_p = spk.colpass_plain(tc, a_p, lw)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    assert swn.dtype == dt and shn.shape == (nb, r, m)
    for got, want in ((swn, swn_p), (a, a_p), (shn, shn_p)):
        assert _rel(got, want) <= tol
    assert float(xlog[1::2].abs().sum()) == 0.0
    lh = lht.transpose(-1, -2)
    d, d_p = (fold_dterm(s_, h_, lw, lh, x_).double() / (n * m)
              for s_, h_, x_ in ((swn, shn, xlog), (swn_p, shn_p, xlog_p)))
    # relative to the term; at r = 1 the fold cancels to zero (swn lw
    # log lw + shn lh log lh = sum x log(lw lh)), and a relative error
    # of the remainder is noise, so there it is held to its x log wth
    # summand instead
    scale = (torch.maximum(d_p.abs(), xlog_p.abs() / (n * m)) if r == 1
             else d_p.abs())
    assert float(((d - d_p).abs() / scale).max()) <= (
        1e-10 if dt == torch.float64 else 1e-5)
    # the ML phases' subsets of S1's outputs
    wn, a2, x2 = spk.rowpass(tc, lw, lht, want_a=False, want_xlog=False)
    assert a2 is None and x2 is None and torch.equal(wn, swn)
    s3, a3, x3 = spk.rowpass(tc, lw, lht, want_swn=False)
    assert s3 is None and torch.equal(a3, a)
    assert torch.equal(x3[0::2], xlog[0::2])


def test_sparse_kernels_are_deterministic():
    dev = _card()
    tc, lw, lht = _sparse_inputs(2000, 3000, 16, 3, torch.float32,
                                 torch.int16, dev, seed=3)
    runs = []
    for _ in range(2):
        swn, a, xlog = spk.rowpass(tc, lw, lht)
        runs.append((swn, a, xlog, spk.colpass(tc, a, lw)))
    for u, v in zip(*runs):
        assert torch.equal(u, v)


def test_sparse_wrappers_refuse_bad_input():
    dev = _card()
    tc, lw, lht = _sparse_inputs(50, 60, 4, 2, torch.float64, torch.int16,
                                 dev)
    with pytest.raises(ValueError, match="several devices"):
        spk.rowpass(tc, lw.cpu(), lht)
    with pytest.raises(ValueError, match="contiguous"):
        spk.rowpass(tc, lw.transpose(0, 1).contiguous().transpose(0, 1),
                    lht)
    with pytest.raises(ValueError, match="do not match"):
        spk.rowpass(tc, lw, lht.float())
    with pytest.raises(ValueError, match="rank"):
        spk.rowpass(tc, lw.new_ones(2, 50, 130), lht.new_ones(2, 60, 130))
    with pytest.raises(ValueError, match="a must be"):
        spk.colpass(tc, torch.ones(2, tc.nnz + 1, dtype=torch.float64,
                                   device=dev), lw)
    tc.val = tc.val.to(torch.int8)
    with pytest.raises(TypeError, match="values"):
        spk.rowpass(tc, lw, lht)


def _epi_inputs(n, m, r, lanes, dt, xdt, dev, seed=0):
    """The gene-major sweep's inputs: lw (B, n, rp) row-major, lh and
    eh (B, rp, m), sc; lane b's rank rows [lanes[b], r) at fudge."""
    x, lwt, lh, eh, sc = _inputs(n, m, r, lanes, dt, xdt, dev, seed)
    return x, lwt.transpose(-1, -2).contiguous(), lh, eh, sc


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", ["gm", "cm"])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,lanes,xdt", [
    (300, 700, 6, [3, 4, 5, 6], torch.int8),
    (1030, 517, 16, [16, 9], torch.int16),
    (257, 1100, 40, [40, 33], torch.float32),
    (140, 600, 128, [128, 100], torch.float64),
])
def test_fused_xpass_matches_plain(n, m, r, lanes, xdt, dt, layout, bf16):
    """E1 + E1s against the plain X pass (swn, shn, xlog)."""
    dev = _card()
    x, lw, lh, _, _ = _epi_inputs(n, m, r, lanes, dt, xdt, dev)
    vbk.reset_launches()
    got = vbk.fused_pallas_raw(x, lw, lh, layout=layout, mxu_bf16=bf16)
    torch.cuda.synchronize()
    assert vbk.LAUNCHES == {"fused_xpass_cm": int(layout == "cm"),
                            "fused_xpass_gm": int(layout == "gm"),
                            "fused_sum": 1, "ss_xpass": 0, "elbo_xpass": 0}
    want = vbk.fused_xpass_plain(x, lw, lh, mxu_bf16=bf16)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == dt and g.shape == w.shape
        assert _rel(g, w) <= tol
    # xlog per element, as the ELBO reads it
    assert _rel(got[2] / (n * m), want[2] / (n * m)) <= (
        1e-10 if dt == torch.float64 else 1e-5)


@pytest.mark.parametrize("layout,bf16", [("gm", False), ("gm", True),
                                         ("cm", False), ("cm", True),
                                         ("p1", False)])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,lanes,xdt", [
    (300, 700, 6, [3, 4, 5, 6], torch.int8),
    (1030, 517, 16, [16, 9], torch.int16),
    (257, 1100, 40, [40, 33], torch.float32),
    (140, 600, 128, [128, 100], torch.float64),
    (2100, 1024, 16, [16, 12, 8], torch.int8),
])
def test_x_pass_launches_are_bit_identical(n, m, r, lanes, xdt, dt, layout,
                                           bf16):
    """E1 (both layouts, bf16 off and on) and P1, whose template stages
    X with cp.async and sums in fixed orders: two launches give the same
    bits of every output, partials included.  The shapes reach every
    shared-memory plan (two buffers; one buffer; the resident output in
    device memory; several sub-chunks a chunk) and, at 1024 cells of
    int8, X's 16-byte rows."""
    dev = _card()
    if layout == "p1":
        x, lw, lh = _pass2_inputs(n, m, r, lanes, dt, xdt, dev)

        def launch():
            return vbk.ss_xpass(x, lw, lh)
    else:
        x, lw, lh, _, _ = _epi_inputs(n, m, r, lanes, dt, xdt, dev)

        def launch():
            return vbk.fused_xpass(x, lw, lh, layout=layout, mxu_bf16=bf16)
    a, b = launch(), launch()
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    if layout == "p1":
        swn_p, shn_p = vbk.suffstats_plain(x, lw, lh)
        tol = 1e-10 if dt == torch.float64 else 2e-4
        assert _rel(lw * a[0], lw * swn_p) <= tol
        assert _rel(lh * a[1].sum(1), lh * shn_p) <= tol


def test_x_pass_division_is_the_division():
    """E1's inlined division (div_rn) gives the bits of x / w wherever
    its fast path applies, on random w and x over its range and past
    both ends."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 24

    def floats():
        mant = torch.randint(0, 1 << 23, (n,), device=dev, generator=gen,
                             dtype=torch.int32)
        ex = torch.randint(65, 189, (n,), device=dev, generator=gen,
                           dtype=torch.int32)
        return ((ex << 23) | mant).view(torch.float32)

    for x in (torch.randint(0, 128, (n,), device=dev, generator=gen).float(),
              -floats(), floats()):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        build.launch("div_rn_check", x, floats(), n, out)
        assert int((out == 2).sum()) == 0 and int((out == 1).sum()) > n // 2


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 391, 16, 64), (2, 13, 5, 333),
                                   (1, 8, 1, 4098)])
def test_fused_sum_is_the_ordered_double_sum(shape, dt):
    """E1s adds the partials in float64 in chunk order and rounds once:
    its bits are those of part[:, 0] + part[:, 1] + ... taken on the
    card in float64, whatever its loads (16-byte vectors where the rows
    allow, elements elsewhere)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    part = torch.randn(shape, generator=gen, device=dev, dtype=dt)
    xpart = torch.rand(shape[0], 5, generator=gen, device=dev,
                       dtype=torch.float64)
    out, _ = vbk.fused_sum(part, xpart)
    acc = torch.zeros_like(part[:, 0], dtype=torch.float64)
    for p in range(shape[1]):
        acc = acc + part[:, p].double()
    assert torch.equal(out, acc.to(dt))


def test_fused_sum_matches_plain():
    dev = _card()
    part = torch.rand(3, 7, 5, 333, dtype=torch.float64, device=dev)
    xpart = torch.rand(3, 7, dtype=torch.float64, device=dev)
    out, xlog = vbk.fused_sum(part, xpart)
    assert torch.allclose(out, part.sum(1), rtol=1e-14)
    assert torch.allclose(xlog, xpart.sum(1), rtol=1e-14)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,lanes,xdt,m_live", [
    (300, 700, 6, [3, 4, 5, 6], torch.int8, 700),
    (1030, 517, 16, [16, 9], torch.int16, 500),
    (140, 600, 128, [128, 100], torch.float64, 600),
])
def test_epilogue_kernels_match_plain(n, m, r, lanes, xdt, m_live, dt):
    """E2 + E3 against their plain version on the same X-pass outputs,
    and the whole gene-major sweep (E1, E1s, E2, E3, K4)."""
    dev = _card()
    x, lw, lh, eh, sc = _epi_inputs(n, m, r, lanes, dt, xdt, dev)
    swn, shn, _ = vbk.fused_xpass_plain(x, lw, lh)
    ehs = eh.sum(-1, dtype=torch.float64)
    epi.reset_launches()
    ew, lwn, dw, csum_p, wscal_p = epi.epi_w_post(swn, lw, ehs[:, None],
                                                  sc, r, n)
    ehn, lhn, dh, rsum_p, hscal_p = epi.epi_h_post(shn, lh, csum_p, sc, r,
                                                   m_live, m)
    torch.cuda.synchronize()
    assert epi.LAUNCHES == {"epi_w_post": 1, "epi_h_post": 1}
    want = epi._post_plain(swn, shn, lw, lh, ehs, sc, r, n, m_live, m)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    # the factors and the rank sums; the four scalar sums (U, sum e,
    # sum log l, dterm) reach the hypers and the ELBO, checked below
    for g, w in zip((ew, lwn, dw, csum_p.sum(1), ehn, lhn, dh,
                     rsum_p.sum(1)), want[:4] + want[5:9]):
        assert g.shape == w.shape and _rel(g, w) <= tol

    got = epi.epi_sweep(x, lw, lh, eh, sc, n=n, m=m, r=r, layout="gm",
                        m_live=m_live)
    want = epi.epi_sweep_plain(x, lw, lh, eh, sc, n=n, m=m, r=r,
                               m_live=m_live)
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == dt and _rel(g, w) <= tol
    gs, ws = got[6], want[6]
    for slot in (sol.AW, sol.BW, sol.AH, sol.BH):
        assert _rel(gs[:, slot], ws[:, slot]) <= tol
    assert _rel(gs[:, sol.PEND] + gs[:, sol.DTERM],
                ws[:, sol.PEND] + ws[:, sol.DTERM]) <= (
        1e-10 if dt == torch.float64 else 1e-5)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,np_,r,lanes", [
    (300, 300, 8, [8, 5, 3]),
    (517, 530, 24, [24, 17]),
    (140, 150, 128, [128, 100]),
])
def test_e2_matches_plain_and_k2_bits(n, np_, r, lanes, dt):
    """E2 (a thread an entry of the row-major W) against its plain
    version at rp 8, 24 (which does not divide the block) and 128, with
    r_live < r and ragged genes (rows past n are padding); its e, lwn
    and d are K2's bits on the transposed layout (the same expressions
    an entry); two launches and lanes run alone give the batch's bits."""
    dev = _card()
    x, lw, lh, eh, sc = _epi_inputs(np_, 600, r, lanes, dt, torch.int16,
                                    dev)
    swn, _, _ = vbk.fused_xpass_plain(x, lw, lh)
    ehs = eh.sum(-1, dtype=torch.float64)[:, None].contiguous()
    epi.reset_launches()
    got = epi.epi_w_post(swn, lw, ehs, sc, r, n)
    again = epi.epi_w_post(swn, lw, ehs, sc, r, n)
    torch.cuda.synchronize()
    assert epi.LAUNCHES == {"epi_w_post": 2, "epi_h_post": 0}
    nblk = -(-np_ // epi.E2_COLS)
    assert got[3].shape == (len(lanes), nblk, r)
    assert got[4].shape == (len(lanes), nblk, 4)
    a = [sc[:, q].to(dt) for q in range(6)]
    want = sol.post_plain(swn.transpose(-1, -2), lw.transpose(-1, -2),
                          ehs[:, 0], *a[:2], *a[4:], r, n)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w.transpose(-1, -2)) <= tol
    assert _rel(got[3].sum(1), want[3]) <= tol
    assert _rel(got[4].sum(1), want[4]) <= tol
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    k2 = sol.w_post(swn.transpose(-1, -2).contiguous()[:, None],
                    lw.transpose(-1, -2).contiguous(), ehs, sc, r, n)
    for g, w in zip(got[:3], k2[:3]):
        assert torch.equal(g, w.transpose(-1, -2))
    for b in range(1, len(lanes)):
        one = epi.epi_w_post(swn[b:b + 1], lw[b:b + 1], ehs[b:b + 1],
                             sc[b:b + 1], r, n)
        assert all(torch.equal(u, v[b:b + 1]) for u, v in zip(one, got))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dt,r", [(torch.float32, 1), (torch.float32, 6),
                                  (torch.float32, 16), (torch.float64, 16),
                                  (torch.float32, 17), (torch.float32, 33),
                                  (torch.float64, 128)])
def test_s2_matches_plain(dt, r, bf16):
    """S2 (16-byte row slices up to r 32, whole rows a thread where rows
    are unaligned, as at r 1, 6 and 17, the group walk above) against
    its plain version on S1's a, with an empty column; two launches and
    lanes run alone, and lw at a storage offset that is not 16-byte
    aligned, give the batch's bits."""
    dev = _card()
    tc, lw, lht = _sparse_inputs(411, 1300, r, 3, dt, torch.int16, dev,
                                 seed=r)
    a = spk.rowpass_plain(tc, lw, lht, mxu_bf16=bf16)[1].contiguous()
    spk.reset_launches()
    shn = spk.colpass(tc, a, lw, mxu_bf16=bf16)
    again = spk.colpass(tc, a, lw, mxu_bf16=bf16)
    torch.cuda.synchronize()
    assert spk.LAUNCHES == {"sp_rowpass": 0, "sp_colpass": 2}
    want = spk.colpass_plain(tc, a, lw, mxu_bf16=bf16)
    assert shn.shape == (3, r, 1300)
    assert _rel(shn, want) <= (1e-10 if dt == torch.float64 else 2e-4)
    assert float(shn[:, :, 7].abs().sum()) == 0.0     # the empty column
    assert torch.equal(shn, again)
    for b in (1, 2):
        one = spk.colpass(tc, a[b:b + 1].contiguous(),
                          lw[b:b + 1].contiguous(), mxu_bf16=bf16)
        assert torch.equal(one, shn[b:b + 1])
    off = torch.empty(lw.numel() + 1, dtype=dt, device=dev)[1:]
    off = off.view(lw.shape).copy_(lw)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(spk.colpass(tc, a, off, mxu_bf16=bf16), shn)


@pytest.mark.parametrize("layout", ["gm", "cm"])
def test_gene_major_sweep_is_deterministic(layout):
    dev = _card()
    x, lw, lh, eh, sc = _epi_inputs(2000, 3000, 16, [16, 12, 8],
                                    torch.float32, torch.int8, dev, seed=3)
    a = epi.epi_sweep(x, lw, lh, eh, sc, n=2000, m=3000, r=16,
                      layout=layout)
    b = epi.epi_sweep(x, lw, lh, eh, sc, n=2000, m=3000, r=16,
                      layout=layout)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _window(x, wide):
    """``x`` as a column window of a matrix ``wide`` columns wider (read
    in place through its row stride), or ``x`` itself."""
    if not wide:
        return x
    n, m = x.shape
    xw = torch.zeros(n, m + wide, dtype=x.dtype, device=x.device)
    xw[:, wide // 2:wide // 2 + m] = x
    return xw[:, wide // 2:wide // 2 + m]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,lanes,xdt,wide", [
    (300, 700, 6, [3, 4, 5, 6], torch.int8, 0),
    (1030, 517, 16, [16, 9], torch.int16, 37),
    (257, 1100, 16, [16, 12], torch.float32, 0),
    (140, 600, 128, [128, 100], torch.float64, 64),
    (600, 1024, 8, [8, 5, 3], torch.int8, 1024),
])
def test_k1_partials_match_chunked_plain(n, m, r, lanes, xdt, wide, dt,
                                         bf16):
    """K1 on fused.cuh's register-tile walk against the plain chunked
    reference (``sol.xpass_partials_plain``) partial by partial, and,
    added in chunk order, against ``sol.xpass_plain``: rp 8, 16 and 128,
    every X type, bf16 off and on, ragged edges, and X as a window of a
    wider matrix read through its row stride."""
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(n, m, r, lanes, dt, xdt, dev)
    sc[1::2, 7] = 0.0                   # do_elbo off in odd lanes
    x = _window(x, wide)
    sol.reset_launches()
    got = sol.xpass(x, lwt, lh, eh, sc, mxu_bf16=bf16)
    torch.cuda.synchronize()
    assert sol.LAUNCHES["xpass"] == 1
    want = sol.xpass_partials_plain(x, lwt, lh, eh, sc, mxu_bf16=bf16)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g, w) <= tol
    # x*log(wth) per element, as the ELBO reads it; 0 where do_elbo is off
    assert float((got[2] - want[2]).abs().max()) / (n * m) <= (
        1e-10 if dt == torch.float64 else 1e-5)
    assert not bool(got[2][1::2].any())
    assert _rel(got[3], want[3]) <= 1e-12
    plain = sol.xpass_plain(x, lwt, lh, eh, sc, mxu_bf16=bf16)
    assert _rel(got[0].sum(1, dtype=torch.float64), plain[0]) <= tol
    assert _rel(got[1].sum(1, dtype=torch.float64), plain[1]) <= tol


@pytest.mark.parametrize("dt,xdt,r", [(torch.float32, torch.int8, 16),
                                      (torch.float64, torch.int16, 40),
                                      (torch.float32, torch.float32, 128)])
def test_k1_is_deterministic_and_lane_independent(dt, xdt, r):
    """Two K1 launches give the same bits, and a subset of the lanes
    gives those lanes' bits of the full batch (the chunks do not depend
    on the lane count: what resume and lane compaction rely on)."""
    dev = _card()
    lanes = [r, r - 2, r - 4, r, r - 1, r - 3]
    x, lwt, lh, eh, sc = _inputs(1100, 900, r, lanes, dt, xdt, dev, seed=4)
    a = sol.xpass(x, lwt, lh, eh, sc)
    b = sol.xpass(x, lwt, lh, eh, sc)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    sub = torch.tensor([1, 4], device=dev)
    c = sol.xpass(x, lwt[sub].contiguous(), lh[sub].contiguous(),
                  eh[sub].contiguous(), sc[sub].contiguous())
    for u, v in zip(a, c):
        assert torch.equal(u[sub], v)


def test_sweep_kernels_bf16_match_plain():
    """K1 with mxu_bf16 (precision='bf16' on the cell-major sweep)."""
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(1030, 517, 16, [16, 9], torch.float32,
                                 torch.int8, dev)
    got = sol.xpass(x, lwt, lh, eh, sc, mxu_bf16=True)
    want = sol.xpass_plain(x, lwt, lh, eh, sc, mxu_bf16=True)
    assert _rel(got[0].sum(1), want[0]) <= 2e-4
    assert _rel(got[1].sum(1), want[1]) <= 2e-4
    assert not torch.equal(got[0], sol.xpass(x, lwt, lh, eh, sc)[0])


def test_gene_major_wrappers_refuse_bad_input():
    dev = _card()
    x, lw, lh, eh, sc = _epi_inputs(50, 60, 4, [4, 3], torch.float64,
                                    torch.int8, dev)
    with pytest.raises(ValueError, match="several devices"):
        vbk.fused_pallas_raw(x.cpu(), lw, lh)
    with pytest.raises(ValueError, match="contiguous"):
        vbk.fused_pallas_raw(x, lw.transpose(0, 1).contiguous()
                             .transpose(0, 1), lh)
    with pytest.raises(ValueError, match="layout"):
        vbk.fused_pallas_raw(x, lw, lh, layout="rows")
    with pytest.raises(TypeError):
        vbk.fused_pallas_raw(x, lw, lh.float())
    with pytest.raises(ValueError, match="rank"):
        vbk.fused_pallas_raw(x, lw.new_ones(2, 50, 136),
                             lh.new_ones(2, 136, 60))
    with pytest.raises(ValueError, match="CUDA"):
        vbk.fused_xpass(x.cpu(), lw.cpu(), lh.cpu(), layout="gm")
    with pytest.raises(ValueError, match="shape mismatch"):
        epi.epi_sweep(x, lw, lh[..., :59].contiguous(), eh, sc, n=50, m=60,
                      r=4)


def _pass2_inputs(n, m, r, lanes, dt, xdt, dev, seed=0):
    """X and the two-pass layouts lw (B, n, r), lh (B, r, m); lane b's
    components [lanes[b], r) at fudge."""
    x, lwt, lh, _, _ = _inputs(n, m, r, lanes, dt, xdt, dev, seed)
    return x, lwt[:, :r].transpose(-1, -2).contiguous(), \
        lh[:, :r].contiguous()


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,lanes,xdt", [
    (300, 700, 6, [3, 4, 5, 6], torch.float32),
    (1030, 517, 16, [16, 9], torch.int16),
    (257, 1100, 40, [40, 33], torch.float64),
    (140, 600, 128, [128, 100], torch.int8),
])
def test_pass2_kernels_match_plain(n, m, r, lanes, xdt, dt):
    """P1 (+ E1s) and P2 (with its tail) against suffstats_plain and
    elbo_data_plain; a second launch and a zero-padded X read in place
    give the same bits."""
    dev = _card()
    x, lw, lh = _pass2_inputs(n, m, r, lanes, dt, xdt, dev)
    vbk.reset_launches()
    ml.reset_launches()
    kw = dict(n=n, m=m, r=r, bn=vbk.DEFAULT_BN, bm=vbk.DEFAULT_BM)
    swn, shn = vbk.suffstats_pallas_padded(x, lw, lh, **kw)
    d = vbk.elbo_data_pallas_padded(x, lw, lh, **kw)
    torch.cuda.synchronize()
    assert vbk.LAUNCHES["ss_xpass"] == vbk.LAUNCHES["elbo_xpass"] == 1
    assert vbk.LAUNCHES["fused_sum"] == 1
    assert ml.LAUNCHES == {"ml_hpass": 0, "ml_wpass": 0}
    swn_p, shn_p = vbk.suffstats_plain(x, lw, lh)
    d_p = vbk.elbo_data_plain(x, lw, lh)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    assert _rel(lw * swn, lw * swn_p) <= tol
    assert _rel(lh * shn, lh * shn_p) <= tol
    assert _rel(d, d_p) <= (1e-10 if dt == torch.float64 else 1e-5)
    chunk = vbk.pass2_chunk(x, n, m, len(lanes), r, lw.element_size())
    for xx in (x, vbk.pad_matrix(x, 64, 128)):
        again = vbk.suffstats_pallas_padded(xx, lw, lh, chunk=chunk, **kw)
        assert torch.equal(again[0], swn) and torch.equal(again[1], shn)
        assert torch.equal(vbk.elbo_data_pallas_padded(xx, lw, lh, **kw), d)


def test_pass2_wrappers_refuse_bad_input():
    dev = _card()
    x, lw, lh = _pass2_inputs(50, 60, 4, [4, 3], torch.float64,
                              torch.float64, dev)
    with pytest.raises(ValueError, match="several devices"):
        vbk.suffstats_pallas(x, lw.cpu(), lh)
    with pytest.raises(ValueError, match="shape mismatch"):
        vbk.elbo_data_pallas_padded(x[:40], lw, lh, n=50, m=60, r=4,
                                    bn=vbk.DEFAULT_BN, bm=vbk.DEFAULT_BM)
    with pytest.raises(TypeError, match="share"):
        vbk.suffstats_pallas(x, lw, lh.float())


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,nb", [
    (300, 700, 6, 4),
    (1030, 517, 16, 2),
    (257, 1100, 40, 2),
])
def test_sparse_kernels_bf16_match_plain(n, m, r, nb, dt):
    """S1/S2 with mxu_bf16 against their bf16 plain versions at the
    float32 tolerances (the plain row pass forms wth in S1's order, so
    the rounding of a to bf16 agrees)."""
    dev = _card()
    tc, lw, lht = _sparse_inputs(n, m, r, nb, dt, torch.int16, dev)
    swn, a, xlog = spk.rowpass(tc, lw, lht, mxu_bf16=True)
    shn = spk.colpass(tc, a, lw, mxu_bf16=True)
    again = spk.rowpass(tc, lw, lht, mxu_bf16=True)
    torch.cuda.synchronize()
    swn_p, a_p, xlog_p = spk.rowpass_plain(tc, lw, lht, mxu_bf16=True)
    shn_p = spk.colpass_plain(tc, a_p, lw, mxu_bf16=True)
    for got, want in ((swn, swn_p), (a, a_p), (shn, shn_p)):
        assert _rel(got, want) <= 2e-4
    assert _rel(xlog / (n * m), xlog_p / (n * m)) <= 1e-5
    assert all(torch.equal(u, v) for u, v in zip(again, (swn, a, xlog)))
    plain = spk.rowpass(tc, lw, lht)[0]
    assert not torch.equal(plain, swn)     # the mode took effect


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,nb", [(300, 700, 6, 4), (257, 1100, 40, 2)])
def test_sparse_kernels_bf16_tail_match_plain(n, m, r, nb, dt):
    """S1/S2 with mxu_bf16 on a layout whose JAX overflow tail is flagged
    (quantile 0.5, bm 64: a long group tail) against their plain
    versions, which leave the tail's operands unrounded as S1/S2 must;
    without the flags S1 rounds those nonzeros' a too."""
    dev = _card()
    tc, lw, lht = _sparse_inputs(n, m, r, nb, dt, torch.int16, dev)
    untailed = spk.rowpass(tc, lw, lht, mxu_bf16=True)[1]
    tc = tile._flag_bf16_tail(tile.from_scipy_tile(
        tc.to_scipy(), dtype=dt, bm=64, quantile=0.5, device=dev))
    assert tc.tail is not None and int(tc.tail.sum()) > 0
    swn, a, xlog = spk.rowpass(tc, lw, lht, mxu_bf16=True)
    shn = spk.colpass(tc, a, lw, mxu_bf16=True)
    torch.cuda.synchronize()
    swn_p, a_p, xlog_p = spk.rowpass_plain(tc, lw, lht, mxu_bf16=True)
    shn_p = spk.colpass_plain(tc, a_p, lw, mxu_bf16=True)
    for got, want in ((swn, swn_p), (a, a_p), (shn, shn_p)):
        assert _rel(got, want) <= 2e-4
    assert _rel(xlog / (n * m), xlog_p / (n * m)) <= 1e-5
    keep = tc.tail.bool()
    assert torch.equal(a[:, ~keep], untailed[:, ~keep])
    assert not torch.equal(a[:, keep], untailed[:, keep])


def test_sparse_lane_groups_keep_each_lanes_bits(monkeypatch):
    """fused_tile over lane groups (a cap of two lanes' a) gives the
    ungrouped batch's bits on the card, a pass a group."""
    dev = _card()
    tc, lw, lht = _sparse_inputs(400, 900, 16, 5, torch.float32,
                                 torch.int16, dev, seed=3)
    lh = lht.transpose(-1, -2).contiguous()
    whole = tile.fused_tile(tc, lw, lh)
    monkeypatch.setattr(sol, "LANE_GROUP_BYTES", 2 * tc.nnz * 4)
    spk.reset_launches()
    grouped = tile.fused_tile(tc, lw, lh)
    torch.cuda.synchronize()
    assert spk.LAUNCHES == {"sp_rowpass": 3, "sp_colpass": 3}
    assert all(torch.equal(u, v) for u, v in zip(whole, grouped))


@pytest.mark.parametrize("which", ["gm", "cm", "p1"])
def test_lane_subset_with_pinned_chunk_is_bit_identical(which):
    """E1 (both layouts) and P1 on three of twelve lanes, with the
    chunk the twelve-lane batch gets, give those lanes' bits of the full
    launch: what the chunked drivers' compaction relies on."""
    dev = _card()
    lanes = [16, 16, 12, 12, 8, 8] * 2
    sub = torch.tensor([1, 4, 9], device=dev)
    if which == "p1":
        x, lw, lh = _pass2_inputs(3000, 700, 16, lanes, torch.float32,
                                  torch.int8, dev, seed=2)

        def run(w, h, chunk):
            return vbk.suffstats_pallas_padded(x, w, h, n=3000, m=700,
                                               r=16, bn=vbk.DEFAULT_BN,
                                               bm=vbk.DEFAULT_BM, chunk=chunk)
        chunk = vbk.pass2_chunk(x, 3000, 700, 12, 16, 4)
        own = vbk.pass2_chunk(x, 3000, 700, 3, 16, 4)
    else:
        x, lw, lh, _, _ = _epi_inputs(3000, 700, 16, lanes, torch.float32,
                                      torch.int8, dev, seed=2)

        def run(w, h, chunk):
            return vbk.fused_pallas_raw(x, w, h, layout=which, chunk=chunk)
        chunk = vbk.fused_chunk(x, which, 12, 16, 4)
        own = vbk.fused_chunk(x, which, 3, 16, 4)
    # the pinned chunk is one the subset would not choose itself
    assert chunk != own
    full = run(lw, lh, chunk)
    part = run(lw[sub].contiguous(), lh[sub].contiguous(), chunk)
    for f, p in zip(full, part):
        assert torch.equal(f[sub], p)


def test_lane_sum_does_not_depend_on_the_lane_count():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in ((21, 5472), (21, 8, 447), (21, 65424), (21, 3)):
        for dt in (torch.float32, torch.float64):
            t = torch.rand(shape, generator=gen, device=dev, dtype=dt)
            full = lane_sum(t, len(shape) - 1)
            for nb in (1, 2, 3, 7, 16):
                assert torch.equal(
                    lane_sum(t[5:5 + nb].clone(), len(shape) - 1),
                    full[5:5 + nb])


def _mesh_sweep(x, lwt, lh, eh, sc, cells, fn, **kw):
    """A sharded sweep (``fn``) over ``cells`` shards of one device; its
    H outputs joined."""
    xs = ShardedCounts(x, np.array([[x.device] * cells], dtype=object))
    out = fn(xs, lwt, xs.shard_h(lh), xs.shard_h(eh), sc, **kw)
    return out[:3] + tuple(xs.gather_h(p) for p in out[3:6]) + out[6:]


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,m_live,r,lanes,cells,xdt", [
    (300, 704, 700, 6, [3, 4, 5, 6], 4, torch.int8),
    (1030, 1536, 1536, 16, [16, 9], 3, torch.int16),
    (140, 600, 447, 40, [40, 33], 2, torch.float32),
])
def test_sharded_sweep_kernels_match_plain(n, m, m_live, r, lanes, cells,
                                           xdt, dt):
    """K1s (per shard), K2, K3s (per shard) and K4 on the gathered
    partials against the plain sharded sweep on the same card tensors:
    k, 1, k, 1 launches; ragged live cells and shards included."""
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(n, m, r, lanes, dt, xdt, dev)
    x[:, m_live:] = 0
    sol.reset_launches()
    ssh.reset_launches()
    kw = dict(n=n, m_arr=m, m_live=m_live, r=r)
    got = _mesh_sweep(x, lwt, lh, eh, sc, cells, ssh.sharded_sweep_kernels,
                      **kw)
    torch.cuda.synchronize()
    assert ssh.LAUNCHES == {"xpass_shard": cells, "h_post_shard": cells}
    assert sol.LAUNCHES == {"xpass": 0, "w_post": 1, "h_post": 0,
                            "finish": 1}
    want = _mesh_sweep(x, lwt, lh, eh, sc, cells, ssh.sharded_sweep_plain,
                       **kw)
    tol = 1e-10 if dt == torch.float64 else 2e-4
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == dt and g.shape == w.shape
        assert _rel(g, w) <= tol
    gs, ws = got[6], want[6]
    for slot in (sol.AW, sol.BW, sol.AH, sol.BH):
        assert _rel(gs[:, slot], ws[:, slot]) <= tol
    assert _rel(gs[:, sol.PEND] + gs[:, sol.DTERM],
                ws[:, sol.PEND] + ws[:, sol.DTERM]) <= (
                    1e-10 if dt == torch.float64 else 1e-5)
    assert torch.equal(gs[:, sol.HFAIL], ws[:, sol.HFAIL])


@pytest.mark.parametrize("cells,m", [(1, 700), (2, 2048), (4, 2048),
                                    (4, 8192)])
def test_sharded_sweep_is_the_single_device_sweep(cells, m):
    """One shard, or shards of a multiple of 512 cells (whole cell
    chunks of K1 and K3), 2,048-cell shards included, give K1-K4's bits;
    two launches are bit-identical."""
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(600, m, 16, [16, 12, 8], torch.float32,
                                 torch.int8, dev, seed=5)
    kw = dict(n=600, m_arr=m, m_live=m, r=16)
    want = sol.sol_sweep(x, lwt, lh, eh, sc, **kw)
    got = _mesh_sweep(x, lwt, lh, eh, sc, cells, ssh.sharded_sweep_kernels,
                      **kw)
    again = _mesh_sweep(x, lwt, lh, eh, sc, cells,
                        ssh.sharded_sweep_kernels, **kw)
    for u, v, w in zip(got, again, want):
        assert torch.equal(u, v) and torch.equal(u, w)


# ---------------------------------------------------------------------
# post_kernel (K2, K3, K3s, E3: a thread an entry, POST_COLS columns a
# block) and finish_kernel (K4: a block a lane, the sums on many warps)
# ---------------------------------------------------------------------

def _post_case(rp, r, lanes_live, ext, nsfx, ndenom, dt, dev, seed=0):
    """Partials, factor and sc of a posterior launch: lane b's live rank
    rows lanes_live[b] (rows in [r_live, r) are masked, rows >= r pad)."""
    rng = np.random.default_rng(seed)
    nb = len(lanes_live)
    sfx = rng.gamma(1.0, 1.0 / nsfx, (nb, nsfx, rp, ext))
    lf = np.zeros((nb, rp, ext))
    lf[:, :r] = rng.gamma(1.0, 1.0, (nb, r, ext))
    denom = rng.gamma(2.0, 1.0, (nb, ndenom, rp))
    sc = np.zeros((nb, 8))
    sc[:, :4] = rng.uniform(0.5, 1.5, (nb, 4))
    sc[:, 4] = float(torch.finfo(dt).eps)
    sc[:, 5] = lanes_live
    sc[:, 7] = 1.0
    t = lambda a, d=dt: torch.tensor(a, dtype=d, device=dev)  # noqa: E731
    return t(sfx), t(lf), t(denom, torch.float64), t(sc, torch.float64)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("rp,r,lanes,ext,n_live,n_pin,nsfx,ndenom", [
    (1, 1, [1, 1, 1], 77, 77, 77, 1, 1),          # rp 1, a ragged block
    (8, 8, [8, 5, 3], 4096, 4096, 4096, 32, 32),  # K2 at 10x's partials
    (16, 16, [16, 12, 8], 8192, 8192, 8192, 16, 128),  # K3 at 10x's
    (16, 13, [13, 9], 2048, 2000, 2048, 16, 128),  # a shard: live < pin
    (24, 20, [20, 17], 1000, 1000, 1000, 1, 391),  # E3: E2's partials
    (128, 128, [128, 100], 300, 290, 300, 3, 5),  # the largest rank
])
def test_post_kernel_matches_plain(rp, r, lanes, ext, n_live, n_pin, nsfx,
                                   ndenom, dt):
    """post_kernel, as K2 (W's prior, n_live = n_pin) and as K3 (H's),
    against post_plain: e, ln, d and the rank sums at the sweep's
    tolerances, partials one a POST_COLS block; two launches are
    bit-identical, and lanes run alone give the batch's bits."""
    dev = _card()
    sfx, lf, denom, sc = _post_case(rp, r, lanes, ext, nsfx, ndenom, dt,
                                    dev)
    a = [sc[:, q].to(dt) for q in range(6)]
    tol = 1e-10 if dt == torch.float64 else 2e-4
    nblk = -(-ext // sol.POST_COLS)
    for which in ("w", "h"):
        if which == "w":
            def launch(s_, l_, d_, c_):
                return sol.w_post(s_, l_, d_, c_, r, n_live)
            live, pin, ab = n_live, n_live, 0
        else:
            def launch(s_, l_, d_, c_):
                return sol.launch_h_post(s_, l_, d_, c_, r, n_live, n_pin)
            live, pin, ab = n_live, n_pin, 2
        got = launch(sfx, lf, denom, sc)
        again = launch(sfx, lf, denom, sc)
        torch.cuda.synchronize()
        want = sol.post_plain(sfx.sum(1, dtype=torch.float64).to(dt), lf,
                              denom.sum(1), a[ab], a[ab + 1], a[4], a[5], r,
                              live, npin=pin)
        assert got[3].shape == (len(lanes), nblk, rp)
        assert got[4].shape == (len(lanes), nblk, 4)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == dt and _rel(g, w) <= tol
        assert _rel(got[3].sum(1), want[3]) <= tol
        assert all(torch.equal(u, v) for u, v in zip(got, again))
        for sub in ([1], [0, len(lanes) - 1]):
            idx = torch.tensor(sub, device=dev)
            one = launch(*(t[idx].contiguous() for t in (sfx, lf, denom,
                                                         sc)))
            assert all(torch.equal(u[idx], v) for u, v in zip(got, one))


@pytest.mark.parametrize("niter", [1, 100])
@pytest.mark.parametrize("mask", range(16))
def test_finish_matches_plain(mask, niter):
    """K4 under each hyper mask on the partials of K1-K3 (the sums on
    many warps of a block, the Newton on thread 0) against finish_plain:
    the hypers at the sweep's tolerances, the per-element ELBO, the
    Newton's failure flags; two launches and lanes alone bit-identical."""
    dev = _card()
    hm = tuple(bool(mask >> i & 1) for i in range(4))
    for dt in (torch.float64, torch.float32):
        n, m, r = 1030, 2100, 16
        x, lwt, lh, eh, sc = _inputs(n, m, r, [16, 12, 8], dt, torch.int8,
                                     dev, seed=9)
        k1 = sol.xpass(x, lwt, lh, eh, sc)
        k2 = sol.w_post(k1[0], lwt, k1[3], sc, r, n)
        k3 = sol.h_post(k1[1], lh, k2[3], sc, r, m)
        parts = (k1[2], k2[3], k2[4], k3[3], k3[4])
        kw = dict(n=n, m=m, dt=dt, hyper_mask=hm, newton_niter=niter,
                  newton_tol=1e-4)
        got = sol.finish(sc, *parts, **kw)
        again = sol.finish(sc, *parts, **kw)
        torch.cuda.synchronize()
        want = sol.finish_plain(sc, *(p.sum(1) for p in parts), n, m, dt,
                                hm, niter, 1e-4)
        tol = 1e-10 if dt == torch.float64 else 2e-4
        for slot in (sol.AW, sol.BW, sol.AH, sol.BH):
            assert _rel(got[:, slot], want[:, slot]) <= tol
        assert _rel((got[:, sol.PEND] + got[:, sol.DTERM]) / (n * m),
                    (want[:, sol.PEND] + want[:, sol.DTERM]) / (n * m)) <= (
            1e-10 if dt == torch.float64 else 1e-5)
        assert torch.equal(got[:, sol.HFAIL], want[:, sol.HFAIL])
        assert torch.equal(got, again)
        idx = torch.tensor([1], device=dev)
        one = sol.finish(sc[idx], *(p[idx].contiguous() for p in parts),
                         **kw)
        assert torch.equal(one, got[idx])


# ---------------------------------------------------------------------
# the mesh backends a shard, and the COO API on the card
# ---------------------------------------------------------------------

def _mesh(cells, genes=1):
    from ccfindr_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(cells=cells, genes=genes, devices=["cuda:0"] * (
        cells * genes))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_shards_back_to_back_match_plain(dt):
    """M1, S1 and P2 add each lane's partials through a cached ticket
    counter a lane and stream: shard launches one after the other on one
    stream (as the mesh backends issue them) each equal their plain
    version on the shard's own inputs, and each equals the same launch
    alone, bit for bit."""
    from ccfindr_tpu_torch.parallel import sharded as tsh

    dev = _card()
    n, m, r, lanes = 300, 1400, 6, [6, 5, 4]
    x, lwt, lh, _, _ = _inputs(n, m, r, lanes, dt, torch.int8, dev)
    lw = lwt[:, :r].transpose(-1, -2).contiguous()
    lh = lh[:, :r].contiguous()
    tol, tol_s = (1e-10, 1e-10) if dt == torch.float64 else (2e-4, 1e-5)
    xs = tsh.place_counts(x, _mesh(2))[0]
    blocks = xs.packed()[0]
    cols = [slice(c0, c1) for c0, c1 in xs.cols]
    # M1 then M1 again on the other shard, then each alone
    outs = [ml.ml_hpass(b, lw, lh[..., c].contiguous())
            for b, c in zip(blocks, cols)]
    for b, c, (hn, xl, _) in zip(blocks, cols, outs):
        hn_p, xl_p = ml.ml_h_plain(b, lw, lh[..., c])
        assert _rel(hn, hn_p) <= tol and _rel(xl, xl_p) <= tol_s
        alone = ml.ml_hpass(b, lw, lh[..., c].contiguous())
        assert torch.equal(alone[0], hn) and torch.equal(alone[1], xl)
    # P2 the same way
    outs = [vbk.elbo_xpass(b, lw, vbk.xlogx(lw), lh[..., c].contiguous(),
                           vbk.xlogx(lh[..., c]).contiguous())[0]
            for b, c in zip(blocks, cols)]
    for b, c, d in zip(blocks, cols, outs):
        assert _rel(d, vbk.elbo_data_plain(b, lw, lh[..., c])) <= tol_s
    # S1 on the shards of the sparse layout
    csr = sp.csr_matrix(x.cpu().numpy().astype(np.float64))
    shards = tile.from_scipy_tile_sharded(csr, 2, dtype=dt, device="cuda")
    lht = lh.transpose(-1, -2)
    outs = [spk.sp_rowpass(tc, lw, lht[:, c].contiguous())
            for tc, c in zip(shards, cols)]
    for tc, c, (swn, a, xl, _) in zip(shards, cols, outs):
        swn_p, a_p, xl_p = spk.rowpass_plain(tc, lw, lht[:, c])
        assert _rel(swn, swn_p) <= tol and _rel(xl, xl_p) <= tol_s
        again = spk.sp_rowpass(tc, lw, lht[:, c].contiguous())
        assert torch.equal(again[0], swn) and torch.equal(again[2], xl)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_mesh_factories_match_cpu(dt):
    """Each make_*_sharded function on one card (cells=2; the
    fused pass also genes=2) against the same function on the CPU (plain
    versions); one launch per shard and kernel."""
    from ccfindr_tpu_torch.parallel import sharded as tsh

    dev = _card()
    n, m, r, lanes = 256, 1024, 6, [6, 4]
    x, lwt, lh, _, _ = _inputs(n, m, r, lanes, dt, torch.int8, dev)
    lw = lwt[:, :r].transpose(-1, -2).contiguous()
    lh = lh[:, :r].contiguous()
    tol, tol_s = (1e-10, 1e-10) if dt == torch.float64 else (2e-4, 1e-5)
    cpu = tuple(t.cpu() for t in (x, lw, lh))

    def cpu_mesh(cells, genes=1):
        from ccfindr_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(cells=cells, genes=genes,
                         devices=["cpu"] * (cells * genes))

    def host(ts):
        return tuple(t.cpu() for t in ts)

    for genes in (1, 2):
        got = host(tsh.make_fused_sharded(_mesh(2, genes))(
            tsh.place_counts(x, _mesh(2, genes))[0], lw, lh))
        want = tsh.make_fused_sharded(cpu_mesh(2, genes))(
            tsh.place_counts(cpu[0], cpu_mesh(2, genes))[0], *cpu[1:])
        assert _rel(got[0], want[0]) <= tol and _rel(got[1], want[1]) <= tol
        assert _rel(got[2], want[2]) <= tol_s
    xs, xc = (tsh.place_counts(x, _mesh(2))[0],
              tsh.place_counts(cpu[0], cpu_mesh(2))[0])
    ml.reset_launches()
    got = host(tsh.make_ml_sharded(_mesh(2))[0](xs, lw, lh))
    assert ml.LAUNCHES["ml_hpass"] == 2
    want = tsh.make_ml_sharded(cpu_mesh(2))[0](xc, *cpu[1:])
    assert _rel(got[0], want[0]) <= tol and _rel(got[1], want[1]) <= tol_s
    vbk.reset_launches()
    got = host(tsh.make_pass2_sharded(_mesh(2))[0](xs, lw, lh))
    assert vbk.LAUNCHES["ss_xpass"] == 2
    want = tsh.make_pass2_sharded(cpu_mesh(2))[0](xc, *cpu[1:])
    assert _rel(got[0], want[0]) <= tol and _rel(got[1], want[1]) <= tol
    csr = sp.csr_matrix(cpu[0].numpy().astype(np.float64))
    from ccfindr_tpu_torch.ops import sparse as tsk

    for build, make in ((tile.from_scipy_tile_sharded,
                         tsh.make_tile_fused_sharded),
                        (tsk.from_scipy_sharded,
                         tsh.make_sparse_fused_sharded)):
        spk.reset_launches()
        got = host(make(_mesh(2))(build(csr, 2, dtype=dt, device="cuda"),
                                  lw, lh))
        assert spk.LAUNCHES == {"sp_rowpass": 2, "sp_colpass": 2}
        want = make(cpu_mesh(2))(build(csr, 2, dtype=dt, device="cpu"),
                                 *cpu[1:])
        assert _rel(got[0], want[0]) <= tol and _rel(got[1], want[1]) <= tol


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_coo_api_on_the_card_is_bit_stable(dt):
    """The COO passes on a CUDA tensor run S1/S2 over the CSR view (no
    index_add_), match their plain versions on the CPU, and give the same
    bits twice; so do the randomized SVD's CSR products."""
    from ccfindr_tpu_torch.ops import rsvd
    from ccfindr_tpu_torch.ops import sparse as tsk

    _card()
    rng = np.random.default_rng(3)
    x = (rng.random((400, 900)) < 0.1) * rng.poisson(3.0, (400, 900))
    csr = sp.csr_matrix(x.astype(np.float64))
    lw = torch.tensor(rng.gamma(1.0, 1.0, (3, 400, 5)), dtype=dt)
    lh = torch.tensor(rng.gamma(1.0, 1.0, (3, 5, 900)), dtype=dt)
    tol, tol_s = (1e-10, 1e-10) if dt == torch.float64 else (2e-4, 1e-5)
    gpu = tsk.from_scipy(csr, dtype=dt, device="cuda")
    host = tsk.from_scipy(csr, dtype=dt, device="cpu")
    spk.reset_launches()
    a = tsk.fused_coo(gpu, lw.cuda(), lh.cuda())
    assert spk.LAUNCHES == {"sp_rowpass": 1, "sp_colpass": 1}
    b = tsk.fused_coo(gpu, lw.cuda(), lh.cuda())
    want = tsk.fused_coo(host, lw, lh)
    for u, v, w in zip(a, b, want):
        assert torch.equal(u, v)
    assert _rel(a[0].cpu(), want[0]) <= tol and \
        _rel(a[1].cpu(), want[1]) <= tol
    assert _rel(a[2].cpu(), want[2]) <= tol_s
    s1 = rsvd.randomized_svd(gpu, 4, seed=2)
    s2 = rsvd.randomized_svd(gpu, 4, seed=2)
    assert all(torch.equal(p, q) for p, q in zip(s1, s2))
    sh = rsvd.randomized_svd(host, 4, seed=2)
    assert _rel(s1[1].cpu(), sh[1]) <= tol


@pytest.mark.parametrize("quantile", [0.98, 0.5])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_ell_passes_on_the_card_are_the_tile_passes(dt, quantile):
    """The ELL API on CUDA tensors: EllCounts.csr, built on the card from
    the slots and tails, holds from_scipy_tile's arrays exactly; fused_ell,
    ell_ml_h and ell_ml_w launch S1/S2 once each as fused_tile, tile_ml_h
    and tile_ml_w do and equal them bit for bit, and match their plain
    versions on the CPU."""
    from ccfindr_tpu_torch.ops import ell

    _card()
    rng = np.random.default_rng(4)
    x = (rng.random((500, 800)) < 0.08) * rng.poisson(3.0, (500, 800))
    x[:4] = rng.poisson(2.0, (4, 800))         # rows past the width
    x[x.sum(1) == 0, 0] += 1
    csr = sp.csr_matrix(x.astype(np.float64))
    lw = torch.tensor(rng.gamma(1.0, 1.0, (3, 500, 6)), dtype=dt)
    lh = torch.tensor(rng.gamma(1.0, 1.0, (3, 6, 800)), dtype=dt)
    tol, tol_s = (1e-10, 1e-10) if dt == torch.float64 else (2e-4, 1e-5)
    ec = ell.from_scipy_ell(csr, dtype=dt, quantile=quantile, lane=16,
                            device="cuda")
    if quantile < 0.9:
        assert ec.gtval.numel() > 0
    tc = tile.from_scipy_tile(csr, dtype=dt, device="cuda")
    for f in ("indptr", "col", "val", "colptr", "row", "perm"):
        u, v = getattr(ec.csr, f), getattr(tc, f)
        assert u.dtype == v.dtype and torch.equal(u, v), f
    host = ell.from_scipy_ell(csr, dtype=dt, quantile=quantile, lane=16,
                              device="cpu")
    w, h = lw.cuda(), lh.cuda()
    for got_fn, tile_fn, plain_fn, n_launch in (
            (ell.fused_ell, tile.fused_tile, ell.fused_ell, (1, 1)),
            (ell.ell_ml_h, tile.tile_ml_h, ell.ell_ml_h, (1, 1)),
            (ell.ell_ml_w, tile.tile_ml_w, ell.ell_ml_w, (1, 0))):
        spk.reset_launches()
        got = got_fn(ec, w, h)
        assert spk.LAUNCHES == dict(zip(("sp_rowpass", "sp_colpass"),
                                        n_launch))
        got = got if isinstance(got, tuple) else (got,)
        want = tile_fn(tc, w, h)
        want = want if isinstance(want, tuple) else (want,)
        plain = plain_fn(host, lw, lh)
        plain = plain if isinstance(plain, tuple) else (plain,)
        for u, v, p in zip(got, want, plain):
            assert torch.equal(u, v)
            assert _rel(u.cpu(), p) <= (tol if u.dim() > 1 else tol_s)


def test_dense_products_give_each_lane_its_bits():
    """The dense routes' passes (their products by utils.lane_matmul) at
    a 10x-like shape in float32: lanes 1 and 4 of six, alone and as a
    pair, give the batch's bits."""
    from ccfindr_tpu_torch.ops import ml as ml_ops
    from ccfindr_tpu_torch.ops import vb as vb_ops

    dev = _card()
    rng = np.random.default_rng(6)
    n, m, r = 1024, 2048, 16
    x = torch.tensor(rng.poisson(2.0, (n, m)), dtype=torch.float32,
                     device=dev)
    lw = torch.tensor(rng.gamma(1.0, 1.0, (6, n, r)), dtype=torch.float32,
                      device=dev)
    lh = torch.tensor(rng.gamma(1.0, 1.0, (6, r, m)), dtype=torch.float32,
                      device=dev)
    fns = (vb_ops.fused_dense, vb_ops.suffstats_dense,
           vb_ops.elbo_data_term, ml_ops.ml_h_dense, ml_ops.ml_w_dense,
           lambda *a: ml_ops.likelihood(*a, 0.0))
    for fn in fns:
        full = fn(x, lw, lh)
        full = full if isinstance(full, tuple) else (full,)
        for lanes in ([1], [4], [1, 4]):
            sel = torch.tensor(lanes, device=dev)
            part = fn(x, lw[sel], lh[sel])
            part = part if isinstance(part, tuple) else (part,)
            for u, v in zip(part, full):
                assert torch.equal(u, v[sel])


# ---------------------------------------------------------------------
# the mesh's runs rows on one card
# ---------------------------------------------------------------------

def _runs_scan(mode, runs, dt):
    """The VB or ML scan over make_mesh(runs, cells=1) on one card, its
    launch counts and its lanes' sweep counts beside it."""
    import ccfindr_tpu_torch as ct
    from ccfindr_tpu_torch.parallel.mesh import make_mesh

    x = ct.simulate_whx(nrow=300, ncol=700, rank=4, seed=3)["x"]
    mods = (sol, ssh, ml)
    for mod in mods:
        mod.reset_launches()
    fn = ct.vb_factorize if mode == "vb" else ct.factorize
    out = fn(x, ranks=[2, 3, 4], nrun=2, Itmax=120, seed=1, verbose=0,
             backend="pallas", device="cuda", dtype=dt,
             mesh=make_mesh(runs=runs, cells=1, devices=["cuda:0"] * runs))
    torch.cuda.synchronize()
    n_iter = [v for r in out.metadata["timings"] if "n_iter" in r
              for v in r["n_iter"]]
    return out, {k: v for mod in mods for k, v in mod.LAUNCHES.items()}, \
        np.asarray(n_iter)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["vb", "ml"])
def test_runs_rows_on_one_card(mode, dt):
    """runs=2 on one card (two rows of cuda:0, one after the other)
    equals runs=1 bit for bit: the measure table, every factor and the
    sweep counts.  The launch counts are exact: each row launches each
    kernel once a sweep of its own batch, so a kernel's count over the
    rows is their most sweeps plus what runs=1's count exceeds its own
    most sweeps by, once a row."""
    _card()
    a, la, na = _runs_scan(mode, 1, dt)
    b, lb, nb = _runs_scan(mode, 2, dt)
    np.testing.assert_array_equal(b.measure.values, a.measure.values)
    for u, v in zip(b.basis + b.coeff, a.basis + a.coeff):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(nb, na)
    used = ("xpass_shard", "w_post", "h_post_shard", "finish") \
        if mode == "vb" else ("ml_hpass", "ml_wpass")
    rows = np.array_split(na, 2)
    for k in used:
        off = la[k] - int(na.max())
        assert lb[k] == sum(int(r.max()) + off for r in rows) > 0, k


# every kernel's wrapper of tools/check_cards.py, by the name it keeps
CARD_KERNELS = ("K1", "K2", "K3", "K4", "K1s", "K3s", "E1 gm", "E1 cm",
                "E1s", "E2", "E3", "P1", "P2", "M1", "M2", "S1", "S2")
_ON_CARD_1 = {}


@pytest.mark.parametrize("kernel", CARD_KERNELS)
def test_wrapper_runs_on_its_tensors_card(kernel):
    """Each wrapper given tensors on cuda:1, the current device left at
    cuda:0, runs on cuda:1 (``build.launch`` enters the tensors' card and
    takes its stream): every output the same bits as the same call on
    cuda:0 (``tools/check_cards.py``, a K1-K4, E1-E3, P1-P2, M1-M2,
    S1-S2 chain at 300 x 768, 4 lanes of rp 8)."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    if not _ON_CARD_1:
        import importlib.util
        from pathlib import Path

        spec = importlib.util.spec_from_file_location(
            "check_cards",
            Path(__file__).resolve().parents[1] / "tools" / "check_cards.py")
        cc = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cc)
        _ON_CARD_1.update(cc.compare("cuda:1"))
    assert _ON_CARD_1[kernel]
