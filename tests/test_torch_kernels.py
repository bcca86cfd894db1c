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


def test_cuda_wrapper_rejects_mixed_devices():
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(50, 60, 4, [4], torch.float64, torch.int8,
                                 dev)
    with pytest.raises(ValueError, match="several devices"):
        sol.sol_sweep(x.cpu(), lwt, lh, eh, sc, n=50, m_arr=60, m_live=60,
                      r=4)


def _ml_inputs(n, m, r, nb, dt, xdt, dev, seed=0):
    """Lane batch of ML factors; lane 0 pins its last two rank rows at
    eps, as a batched rank scan pins a short lane's rows."""
    rng = np.random.default_rng(seed)
    x = np.minimum(rng.poisson(2.0, (n, m)), 127)
    w = rng.gamma(1.0, 1.0, (nb, n, r))
    h = rng.gamma(1.0, 1.0, (nb, r, m))
    if r > 2:
        eps = float(torch.finfo(dt).eps)
        w[0, :, r - 2:] = eps
        h[0, r - 2:] = eps
    t = lambda a, d=dt: torch.tensor(a, dtype=d, device=dev)  # noqa: E731
    return t(x, xdt), t(w), t(h)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,r,nb,xdt", [
    (300, 700, 6, 4, torch.int8),
    (1030, 517, 16, 2, torch.int16),
    (257, 1100, 40, 2, torch.float32),
    (140, 600, 128, 2, torch.float64),
    (65, 63, 1, 3, torch.int8),
])
def test_ml_kernels_match_plain(n, m, r, nb, xdt, dt):
    dev = _card()
    x, w, h = _ml_inputs(n, m, r, nb, dt, xdt, dev)
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
    d, d_p = (fold_dterm(s_, h_, x_, lw, lh).double() / (n * m)
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
        rc = build.library().div_rn_check(x.data_ptr(), floats().data_ptr(),
                                          n, out.data_ptr(), build.stream())
        assert rc == 0
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
    kw = dict(n=n, m=m, r=r)
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
        vbk.elbo_data_pallas_padded(x[:40], lw, lh, n=50, m=60, r=4)
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
                                               r=16, chunk=chunk)
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
