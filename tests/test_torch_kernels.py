"""CUDA kernels K1-K4 (csrc/sol.cu) and M1-M3 (csrc/ml.cu) against
their plain PyTorch versions, on the card.  The kernels have no CPU mode, so every test here is
marked ``cuda`` and skips without a CUDA device.  The module imports
no JAX, so on a machine with a card (and without JAX) it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: elementwise relative 1e-10 in float64; in float32 2e-4 on
the factors, the hypers and the ML numerators hn/wn, and 1e-5 on the
per-element ELBO and ML likelihood (as chip_smoke.py states them).  The shapes cover ragged edges, shared
memory above the 48 KB default (rp >= 40 in float64) and the largest
padded rank, 128.
"""

import numpy as np
import pytest
import torch

from ccfindr_tpu_torch.ops.kernels import ml, sol
from ccfindr_tpu_torch.ops.ml import likelihood_const

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
    got = sol.sol_sweep(x, lwt, lh, eh, sc, n=n, m=m, r=r)
    torch.cuda.synchronize()
    want = sol.sol_sweep_plain(x, lwt, lh, eh, sc, n=n, m=m, r=r)
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
    a = sol.sol_sweep(x, lwt, lh, eh, sc, n=2000, m=3000, r=16)
    b = sol.sol_sweep(x, lwt, lh, eh, sc, n=2000, m=3000, r=16)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_cuda_wrapper_rejects_mixed_devices():
    dev = _card()
    x, lwt, lh, eh, sc = _inputs(50, 60, 4, [4], torch.float64, torch.int8,
                                 dev)
    with pytest.raises(ValueError, match="several devices"):
        sol.sol_sweep(x.cpu(), lwt, lh, eh, sc, n=50, m=60, r=4)


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
    assert ml.LAUNCHES == {"ml_hpass": 1, "ml_wpass": 1, "ml_xlog_sum": 1}
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


def test_ml_xlog_sum_matches_plain():
    dev = _card()
    part = torch.rand(5, 333, dtype=torch.float64, device=dev)
    got = ml.ml_xlog_sum(part)
    assert torch.allclose(got, ml.xlog_sum_plain(part), rtol=1e-14)
