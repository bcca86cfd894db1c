"""The port's two-pass backend (``backend='pallas2pass'``: the plain
versions of P1/P2 in ccfindr_tpu_torch.ops.kernels.vb_kernels, the
injection points of ops.vb.vb_run, the driver's branch and its
``suffstats``/``data_term`` overrides) against the JAX package, whose
``_suffstats_kernel``/``_elbo_kernel`` run here in Pallas interpret mode
with small tiles (bn 8, bm 128), as tests/test_pallas.py runs them.

Everything is float64.  Tolerances: one pass rtol 1e-12 (the same sums
in another order); loops equal n_iter, lml 1e-10; drivers lml 1e-9
(against JAX, svd2 inits) and 1e-6 with basis 1e-4 (against the port's
'dense', as tests/test_drivers.py holds the JAX backends).  On the CPU
the wrappers take the plain versions; the CUDA kernels are held against
them on the card (tests/test_torch_kernels.py, chip_smoke.py).
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
from ccfindr_tpu.ops import pallas as jpk
from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.ops.kernels import build as tbuild
from ccfindr_tpu_torch.ops.kernels import sol as tsol
from ccfindr_tpu_torch.ops.kernels import vb_kernels as tvk

torch.set_num_threads(2)

BN, BM = 8, 128


def _planted(n, m, r, seed=0):
    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.8, 1.0, (n, r))
    hf = rng.gamma(0.8, 1.0, (r, m))
    return np.minimum(rng.poisson(wf @ hf * (2.0 * n * m / (wf @ hf).sum())),
                      127).astype(np.float64)


def _lanes(n, m, ranks, seed):
    """Gamma factors lw (B, n, rmax), lh (B, rmax, m); lane b's
    components past ranks[b] at float64 eps, as a batched scan pins
    them."""
    rng = np.random.default_rng(seed)
    r = max(ranks)
    lw = rng.gamma(1.0, 1.0, (len(ranks), n, r))
    lh = rng.gamma(1.0, 1.0, (len(ranks), r, m))
    eps = np.finfo(np.float64).eps
    for b, rk in enumerate(ranks):
        lw[b, :, rk:] = eps
        lh[b, rk:] = eps
    return lw, lh


@pytest.mark.parametrize("ranks", [[3], [2, 3, 5], [16, 9]])
def test_two_pass_plain_matches_jax(ranks):
    n, m = 37, 150
    x = _planted(n, m, 3, seed=len(ranks))
    lw, lh = _lanes(n, m, ranks, seed=sum(ranks))
    sw, sh = tvk.suffstats_pallas(torch.tensor(x), torch.tensor(lw),
                                  torch.tensor(lh), BN, BM)
    dt = tvk.elbo_data_pallas(torch.tensor(x), torch.tensor(lw),
                              torch.tensor(lh), BN, BM)
    assert sw.shape == lw.shape and sh.shape == lh.shape
    assert dt.shape == (len(ranks),) and dt.dtype == torch.float64
    for b in range(len(ranks)):
        jsw, jsh = jpk.suffstats_pallas(jnp.asarray(x), jnp.asarray(lw[b]),
                                        jnp.asarray(lh[b]), bn=BN, bm=BM)
        jdt = jpk.elbo_data_pallas(jnp.asarray(x), jnp.asarray(lw[b]),
                                   jnp.asarray(lh[b]), bn=BN, bm=BM)
        np.testing.assert_allclose(sw[b].numpy(), np.asarray(jsw),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(sh[b].numpy(), np.asarray(jsh),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(float(dt[b]), float(jdt), rtol=1e-12)


def test_plain_versions_are_the_dense_functions():
    """The numerators and the unfolded data term agree with the dense
    pair of ops.vb (its folded form) to roundoff."""
    n, m = 29, 41
    x = torch.tensor(_planted(n, m, 2, seed=5))
    lw, lh = (torch.tensor(a) for a in _lanes(n, m, [4, 2], seed=6))
    swn, shn = tvk.suffstats_plain(x, lw, lh)
    sw, sh = tvb.suffstats_dense(x, lw, lh)
    torch.testing.assert_close(lw * swn, sw, rtol=1e-13, atol=0)
    torch.testing.assert_close(lh * shn, sh, rtol=1e-13, atol=0)
    torch.testing.assert_close(tvk.elbo_data_plain(x, lw, lh),
                               tvb.elbo_data_term(x, lw, lh), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int16])
def test_pre_padded_x_gives_the_same_result(dtype):
    n, m = 37, 150
    x = torch.tensor(_planted(n, m, 3, seed=9)).to(dtype)
    lw, lh = (torch.tensor(a) for a in _lanes(n, m, [3, 4], seed=10))
    xp = tvk.pad_matrix(x, BN, BM)
    assert xp.shape == (40, 256) and xp.dtype == dtype
    assert torch.equal(tvk.pad_matrix(xp, BN, BM), xp)
    a = tvk.suffstats_pallas(x, lw, lh, BN, BM)
    b = tvk.suffstats_pallas(xp, lw, lh, BN, BM)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(tvk.elbo_data_pallas(x, lw, lh, BN, BM),
                       tvk.elbo_data_pallas(xp, lw, lh, BN, BM))
    # the hoisted sum lgamma(x + 1) of the loop reads the same bits
    st = tvb.VBState(lw, lh, lw, lh, lw * 0, lh * 0,
                     torch.full((2,), -np.inf, dtype=torch.float64))
    la = tvb._loop_scalars(x, st, None, 1e-5, None, 1)[2]
    lb = tvb._loop_scalars(xp, st, None, 1e-5, None, 1)[2]
    assert torch.equal(la, lb)


def test_padded_functions_check_their_extents():
    n, m = 20, 30
    x = torch.tensor(_planted(n, m, 2, seed=1))
    lw, lh = (torch.tensor(a) for a in _lanes(n, m, [3], seed=2))
    with pytest.raises(ValueError, match="extents"):
        tvk.suffstats_pallas_padded(x, lw, lh, n=n, m=m, r=4, bn=BN, bm=BM)
    with pytest.raises(ValueError, match="shape mismatch"):
        tvk.elbo_data_pallas_padded(x[:10], lw, lh, n=n, m=m, r=3, bn=BN,
                                    bm=BM)
    with pytest.raises(TypeError, match="share"):
        tvk.suffstats_pallas(x, lw, lh.float())


@pytest.mark.parametrize("ranks,itmax", [([4], 200), ([2, 3, 5], 150)])
def test_vb_run_with_the_pallas_backend_matches_jax(ranks, itmax):
    """JAX vb_run (vmapped, prefix rank masks) with its make_pallas_backend
    against the port's lane-batched vb_run with make_pallas_backend(), on
    the same initial states."""
    sim = cf.simulate_whx(nrow=24, ncol=36, rank=3, seed=7)
    x = np.asarray(sim["x"], np.float64)
    n, m = x.shape
    nb, rmax = len(ranks), max(ranks)
    rng = np.random.default_rng(0)
    w = rng.gamma(1.0, 1.0, (nb, n, rmax))
    h = rng.gamma(1.0, 1.0, (nb, rmax, m))
    st = jvb.VBState(ew=w, eh=h, lw=w, lh=h, dw=np.zeros_like(w),
                     dh=np.zeros_like(h), lkh=np.full(nb, -np.inf))
    rmask = (np.arange(rmax)[None] < np.asarray(ranks)[:, None]
             ).astype(np.float64)
    rtrue = np.asarray(ranks, np.float64)
    jss, jdt = jpk.make_pallas_backend(bn=BN, bm=BM)
    xp = jpk.pad_matrix(jnp.asarray(x), BN, BM)
    jout = jax.vmap(lambda s, hh, rm, rt: jvb.vb_run(
        xp, s, hh, itmax=itmax, suffstats=jss, data_term=jdt, rank_mask=rm,
        r_true=rt))(jax.tree.map(jnp.asarray, st),
                    jvb.Hyper(*(jnp.ones(nb),) * 4), jnp.asarray(rmask),
                    jnp.asarray(rtrue))
    jout = jax.tree.map(np.asarray, jout)
    ss, dt = tvk.make_pallas_backend(BN, BM)
    tout = tvb.state_to_numpy(tvb.vb_run(
        tvk.pad_matrix(torch.tensor(x), BN, BM),
        tvb.state_from_numpy(st, device="cpu"),
        tvb.Hyper(*(torch.ones(nb, dtype=torch.float64),) * 4),
        itmax=itmax, suffstats=ss, data_term=dt,
        rank_mask=torch.tensor(rmask), r_true=torch.tensor(rtrue)))
    np.testing.assert_array_equal(tout.n_iter, jout.n_iter)
    np.testing.assert_array_equal(tout.done, jout.done)
    np.testing.assert_allclose(tout.lml, jout.lml, rtol=1e-10)
    for f in ("ew", "eh", "lw", "lh"):
        np.testing.assert_allclose(getattr(tout.state, f),
                                   getattr(jout.state, f), rtol=1e-7,
                                   atol=1e-300, err_msg=f)


@pytest.fixture(scope="module")
def small():
    return cf.simulate_whx(nrow=30, ncol=40, rank=3, seed=21)["x"]


def test_vb_factorize_pallas2pass_matches_jax(small):
    kw = dict(ranks=[2, 3, 4], initializer="svd2", backend="pallas2pass",
              Itmax=300, verbose=0)
    a = cf.vb_factorize(cf.SCSet(count=small), **kw)
    tvk.reset_launches()
    b = ct.vb_factorize(ct.SCSet(count=small), device="cpu", **kw)
    assert list(a.measure["rank"]) == list(b.measure["rank"])
    for col in ("lml", "aw", "bw", "ah", "bh"):
        np.testing.assert_allclose(b.measure[col], a.measure[col],
                                   rtol=1e-9, err_msg=col)
    assert (b.metadata["timings"][0]["total_sweeps"]
            == a.metadata["timings"][0]["total_sweeps"])
    for k in range(len(a.ranks)):
        np.testing.assert_allclose(b.basis[k], a.basis[k], rtol=0,
                                   atol=1e-6 * np.abs(a.basis[k]).max())
    # CPU tensors take the plain versions: no kernel was launched
    assert all(v == 0 for v in tvk.LAUNCHES.values())


def test_vb_factorize_pallas2pass_agrees_with_dense():
    """As tests/test_drivers.py::test_vb_backends_agree holds the JAX
    package's backends: random inits, two restarts."""
    x = cf.simulate_whx(nrow=24, ncol=40, rank=3, seed=21)["x"]
    kw = dict(ranks=3, nrun=2, verbose=0, Itmax=300, seed=5, device="cpu")
    a = ct.vb_factorize(x, backend="dense", **kw)
    b = ct.vb_factorize(x, backend="pallas2pass", **kw)
    np.testing.assert_allclose(b.measure["lml"], a.measure["lml"],
                               rtol=1e-6)
    np.testing.assert_allclose(b.basis[0], a.basis[0], rtol=1e-4)
    assert (a.metadata["timings"][0]["n_iter"]
            == b.metadata["timings"][0]["n_iter"])


def test_dense_overrides_reproduce_dense(small):
    kw = dict(ranks=[2, 3], nrun=2, Itmax=200, verbose=0, seed=3,
              device="cpu", backend="dense")
    a = ct.vb_factorize(small, **kw)
    b = ct.vb_factorize(small, suffstats=tvb.suffstats_dense,
                        data_term=tvb.elbo_data_term, **kw)
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    np.testing.assert_array_equal(a.basis[1], b.basis[1])


def test_pallas_overrides_replace_the_kernel_loops(small, monkeypatch):
    """The two-pass pair on backend='pallas' turns vb_run_sol off (as
    the JAX driver's use_epi = False does) and reproduces pallas2pass:
    the padded int8 X and the padded float X give the same numbers."""
    kw = dict(ranks=[2, 3], nrun=2, Itmax=200, verbose=0, seed=3,
              device="cpu")
    a = ct.vb_factorize(small, backend="pallas2pass", **kw)
    calls = []
    real = tsol.vb_run_sol
    monkeypatch.setattr(tsol, "vb_run_sol",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ss, dt = tvk.make_pallas_backend()
    b = ct.vb_factorize(small, backend="pallas", suffstats=ss, data_term=dt,
                        **kw)
    assert calls == []
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    for k in range(2):
        np.testing.assert_array_equal(a.basis[k], b.basis[k])
    ct.vb_factorize(small, backend="pallas", **kw)
    assert calls == [1]


@pytest.mark.parametrize("kw,match", [
    (dict(backend="pallas2pass", precision="bf16"), "bf16"),
    (dict(backend="pallas2pass", elbo_every=2), "elbo_every"),
    (dict(backend="pallas", suffstats=tvb.suffstats_dense, elbo_every=2),
     "elbo_every"),
    (dict(backend="pallas", data_term=tvb.elbo_data_term, precision="bf16"),
     "bf16"),
    (dict(backend="pallas2pass", storage_dtype="int8"), "integer counts"),
])
def test_pallas2pass_refuses_what_jax_refuses(kw, match):
    x = cf.simulate_whx(nrow=12, ncol=15, rank=2, seed=1)["x"] + 0.5
    with pytest.raises(ValueError, match=match):
        ct.vb_factorize(x, ranks=[2], verbose=0, device="cpu", **kw)


def test_p2_strip_is_a_constant_of_pass2_cu():
    """P2's strip (a block: P2_BAND genes x P2_CHUNK cells of one lane)
    is csrc/pass2.cu's kP2Band x kP2Chunk, passed by the C entry as it
    stands (never derived from the lane count), in whole 64-cell steps;
    elbo_xpass sizes its partials from it, whose count depends on (n, m)
    only: a lane's bits do not depend on its batch.  At 10x a lane has
    512 partials (the tile design had 8,192)."""
    src = (tbuild.CSRC / "pass2.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kP2\w+) = (\d+);", src))
    assert int(consts["kP2Band"]) == tvk.P2_BAND
    assert int(consts["kP2Chunk"]) == tvk.P2_CHUNK
    assert tvk.P2_CHUNK % int(consts["kP2Tile"]) == 0
    assert re.search(r"lhl, B, n, m, r, kP2Chunk, part,", src)
    for n, m in ((1, 1), (63, 1023), (64, 1024), (65, 1025), (684, 447)):
        assert tvk.elbo_part_width(n, m) == (-(-n // tvk.P2_BAND)
                                             * -(-m // tvk.P2_CHUNK))
    assert tvk.elbo_part_width(4096, 8192) == 512
    assert list(inspect.signature(tvk.elbo_part_width).parameters) == \
        ["n", "m"]
    assert "elbo_part_width(n, m)" in inspect.getsource(tvk.elbo_xpass)


def _tf32(v):
    """float32 to TF32 as cvt.rna.tf32.f32 rounds it: to the nearest
    10-bit mantissa, ties away from zero (finite values)."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _split_tf32_products(pairs, k_total):
    """P2's float products as csrc/pass2.cu forms them on the tensor
    cores: each operand split into hi = tf32(v) and lo = tf32(v - hi),
    and for every 8 rank components the MMAs of ``pairs`` ((A, B, which)
    with which 'lh' for lo*hi, 'hl' hi*lo, 'hh' hi*hi, in issue order),
    each an exact 8-deep sum rounded into the float32 accumulator."""
    n, m = pairs[0][0].shape[0], pairs[0][1].shape[1]
    acc = np.zeros((n, m), np.float32)
    for k in range(0, k_total, 8):
        for a, b, which in pairs:
            a8 = a[:, k:k + 8].astype(np.float32)
            b8 = b[k:k + 8].astype(np.float32)
            ah, bh = _tf32(a8), _tf32(b8)
            al, bl = _tf32(a8 - ah), _tf32(b8 - bh)
            lhs, rhs = {"lh": (al, bh), "hl": (ah, bl),
                        "hh": (ah, bh)}[which]
            acc = (acc + (lhs.astype(np.float64) @ rhs.astype(np.float64)
                          ).astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_keeps_the_float32_data_term_tolerance(seed):
    """The split-TF32 products that P2 ships for float32 factors keep
    C1's tolerance: over the 10x cell's value ranges (a planted Poisson
    X at mean 2 capped at 127, gamma(1, 1) factors of rank 16, lanes of
    ranks 16, 12 and 8 with the rest at float32 eps, as chip_smoke.py
    phase 13 makes them) the data term -sum x (S/wth - log wth) formed
    from them in float32 is within 1e-5 of float64 relative to the term,
    as the float32 gate of phase 13 holds the kernel; P2's issue order
    (lo*hi, hi*lo, hi*hi; S's lwl*lh pairs before lw*lhl, the hi*hi
    products last) is the one emulated."""
    rng = np.random.default_rng(seed)
    n, m, r = 256, 512, 16
    wf = rng.gamma(0.8, 1.0, (n, r))
    hf = rng.gamma(0.8, 1.0, (r, m))
    x = np.minimum(rng.poisson(wf @ hf * (2.0 * n * m / (wf @ hf).sum())),
                   127).astype(np.float32)
    eps = float(np.finfo(np.float32).eps)
    for rk in (16, 12, 8):
        lw = rng.gamma(1.0, 1.0, (n, r)).astype(np.float32)
        lh = rng.gamma(1.0, 1.0, (r, m)).astype(np.float32)
        lw[:, rk:] = eps
        lh[rk:] = eps
        lwl = tvk.xlogx(torch.tensor(lw)).numpy()
        lhl = tvk.xlogx(torch.tensor(lh)).numpy()
        wth = _split_tf32_products([(lw, lh, "lh"), (lw, lh, "hl"),
                                    (lw, lh, "hh")], r)
        s = _split_tf32_products([(lwl, lh, "lh"), (lwl, lh, "hl"),
                                  (lw, lhl, "lh"), (lw, lhl, "hl"),
                                  (lwl, lh, "hh"), (lw, lhl, "hh")], r)
        nz = x != 0
        t = x * (s / wth - np.log(wth))
        d32 = -t[nz].astype(np.float64).sum()
        d64 = float(tvk.elbo_data_plain(
            torch.tensor(x, dtype=torch.float64),
            torch.tensor(lw, dtype=torch.float64)[None],
            torch.tensor(lh, dtype=torch.float64)[None])[0])
        assert abs(d32 - d64) <= 1e-5 * abs(d64), (rk, d32, d64)
        # without the split (one TF32 product) the term drifts further
        one = _split_tf32_products([(lw, lh, "hh")], r)
        assert np.abs(one / wth - 1).max() > 10 * np.abs(
            wth / (lw.astype(np.float64) @ lh) - 1).max()
