"""The port's ML core (ccfindr_tpu_torch.ops.ml) and the plain versions
of its CUDA kernels (ops.kernels.ml) against the JAX package, at
float64 on the CPU.

Tolerances: the per-sweep math 1e-10 relative; the plain kernel
versions against the Pallas kernels (interpret mode, bn=8, bm=128 as
tests/test_ml.py runs them) 1e-9; lane-batched ml_run against the
vmapped JAX loop: equal n_iter and cid, lkh 1e-10, factors 1e-8.
"""

import inspect
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccfindr_tpu.ops import ml as jml
from ccfindr_tpu.ops.pallas import ml_kernels as jmlk
from ccfindr_tpu_torch.ops import ml as tml
from ccfindr_tpu_torch.ops.kernels import build
from ccfindr_tpu_torch.ops.kernels import ml as tk

torch.set_num_threads(2)

RANKS = [2, 3, 4, 4, 3]          # a mixed-rank lane batch, padded to 4
RMAX = 4


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(7)
    n, m = 30, 45
    x = rng.poisson(2.0, (n, m)).astype(np.float64)
    nb = len(RANKS)
    w0 = rng.uniform(size=(nb, n, RMAX))
    h0 = rng.uniform(size=(nb, RMAX, m))
    rm = (np.arange(RMAX)[None] < np.asarray(RANKS)[:, None]).astype(float)
    return x, w0, h0, rm


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("masked,prior", [(False, False), (True, False),
                                          (True, True)])
def test_sweep_math_matches_jax(lanes, masked, prior):
    x, w0, h0, rm = lanes
    pn, pd = (0.5, 0.25) if prior else (0.0, 0.0)
    eps = np.finfo(np.float64).eps
    lg_j = jml.likelihood_const(jnp.asarray(x))
    lg_t = tml.likelihood_const(_t(x))
    np.testing.assert_allclose(float(lg_t), float(lg_j), rtol=1e-12)
    w1, h1 = tml.ml_sweep(_t(x), _t(w0), _t(h0), torch.tensor(eps), pn=pn,
                          pd=pd, rank_mask=_t(rm) if masked else None)
    lk = tml.likelihood(_t(x), w1, h1, lg_t)
    for b in range(len(RANKS)):
        wj, hj = jml.ml_sweep(jnp.asarray(x), jnp.asarray(w0[b]),
                              jnp.asarray(h0[b]), eps, pn=pn, pd=pd,
                              rank_mask=jnp.asarray(rm[b]) if masked
                              else None)
        np.testing.assert_allclose(w1[b].numpy(), np.asarray(wj),
                                   rtol=1e-10)
        np.testing.assert_allclose(h1[b].numpy(), np.asarray(hj),
                                   rtol=1e-10)
        lj = jml.likelihood(jnp.asarray(x), wj, hj, lg_j)
        np.testing.assert_allclose(float(lk[b]), float(lj), rtol=1e-10)
        hn_j, xl_j = jml.ml_h_dense(jnp.asarray(x), wj, hj)
        hn_t, xl_t = tml.ml_h_dense(_t(x), w1[b], h1[b])
        np.testing.assert_allclose(hn_t.numpy(), np.asarray(hn_j),
                                   rtol=1e-10)
        np.testing.assert_allclose(float(xl_t), float(xl_j), rtol=1e-10)
        np.testing.assert_allclose(
            tml.ml_w_dense(_t(x), w1[b], h1[b]).numpy(),
            np.asarray(jml.ml_w_dense(jnp.asarray(x), wj, hj)), rtol=1e-10)


@pytest.mark.parametrize("xdt", [np.float64, np.int8, np.int16])
def test_plain_kernels_match_pallas(xdt):
    """ml_h_plain/ml_w_plain (and the CPU wrappers, which take them)
    against ml_h_pallas/ml_w_pallas in interpret mode, lane by lane;
    ragged 37 x 150 with lanes of rank 3 and 9."""
    rng = np.random.default_rng(14)
    n, m = 37, 150
    x = np.minimum(rng.poisson(2.0, (n, m)), 127).astype(xdt)
    for r in (3, 9):
        w = rng.gamma(1.0, 1.0, (2, n, r))
        h = rng.gamma(1.0, 1.0, (2, r, m))
        hn_t, xl_t = tk.ml_h_plain(_t(x), _t(w), _t(h))
        wn_t = tk.ml_w_plain(_t(x), _t(w), _t(h))
        hn_w, xl_w = tk.ml_h(_t(x), _t(w), _t(h))
        assert torch.equal(hn_w, hn_t) and torch.equal(xl_w, xl_t)
        assert torch.equal(tk.ml_w(_t(x), _t(w), _t(h)), wn_t)
        assert xl_t.dtype == torch.float64 and hn_t.shape == (2, r, m)
        for b in range(2):
            hn_j, xl_j = jmlk.ml_h_pallas(jnp.asarray(x), jnp.asarray(w[b]),
                                          jnp.asarray(h[b]), bn=8, bm=128)
            np.testing.assert_allclose(hn_t[b].numpy(), np.asarray(hn_j),
                                       rtol=1e-9)
            np.testing.assert_allclose(float(xl_t[b]), float(xl_j),
                                       rtol=1e-9)
            wn_j = jmlk.ml_w_pallas(jnp.asarray(x), jnp.asarray(w[b]),
                                    jnp.asarray(h[b]), bn=8, bm=128)
            np.testing.assert_allclose(wn_t[b].numpy(), np.asarray(wn_j),
                                       rtol=1e-9)


# the shapes where M1/M2's walk (csrc/fused.cuh) has edges: (n, m, r,
# zero bands)
EDGES = {"r1": (70, 150, 1, False),
         "r5": (70, 150, 5, False),      # r not a multiple of 4
         "r17": (70, 150, 17, False),    # r past a 16-wide slab
         "zero_bands": (150, 200, 4, True)}


@pytest.mark.parametrize("xdt", [np.float64, np.int16])
@pytest.mark.parametrize("case", list(EDGES))
def test_plain_kernels_match_pallas_at_kernel_edges(case, xdt):
    """ml_h_plain/ml_w_plain and the CPU wrappers against ml_h_pallas/
    ml_w_pallas in interpret mode, lane by lane (1e-9), at r = 1, 5 and
    17 and on an X whose rows 64..127 and columns 64..127 are all zero
    (whole 64 x 64 tiles of the walk); lane 0 pins its last rank row at
    eps, as a batched rank scan pins a short lane's rows."""
    n, m, r, band = EDGES[case]
    rng = np.random.default_rng(21)
    x = np.minimum(rng.poisson(2.0, (n, m)), 127)
    if band:
        x[64:128] = 0
        x[:, 64:128] = 0
    x = x.astype(xdt)
    w = rng.gamma(1.0, 1.0, (2, n, r))
    h = rng.gamma(1.0, 1.0, (2, r, m))
    if r > 1:
        w[0, :, r - 1] = np.finfo(np.float64).eps
        h[0, r - 1] = np.finfo(np.float64).eps
    hn_t, xl_t = tk.ml_h_plain(_t(x), _t(w), _t(h))
    wn_t = tk.ml_w_plain(_t(x), _t(w), _t(h))
    hn_w, xl_w = tk.ml_h(_t(x), _t(w), _t(h))
    assert torch.equal(hn_w, hn_t) and torch.equal(xl_w, xl_t)
    assert torch.equal(tk.ml_w(_t(x), _t(w), _t(h)), wn_t)
    if band:
        assert not hn_t[:, :, 64:128].any() and not wn_t[:, 64:128].any()
    for b in range(2):
        hn_j, xl_j = jmlk.ml_h_pallas(jnp.asarray(x), jnp.asarray(w[b]),
                                      jnp.asarray(h[b]), bn=8, bm=128)
        np.testing.assert_allclose(hn_t[b].numpy(), np.asarray(hn_j),
                                   rtol=1e-9)
        np.testing.assert_allclose(float(xl_t[b]), float(xl_j), rtol=1e-9)
        wn_j = jmlk.ml_w_pallas(jnp.asarray(x), jnp.asarray(w[b]),
                                jnp.asarray(h[b]), bn=8, bm=128)
        np.testing.assert_allclose(wn_t[b].numpy(), np.asarray(wn_j),
                                   rtol=1e-9)


def test_kernel_chunks_do_not_depend_on_the_lane_count():
    """M1's and M2's chunks are constants of csrc/ml.cu, the same as
    ops/kernels/ml.py's H_CHUNK and W_CHUNK, passed by the C entries as
    they stand (never derived from the lane count B), and whole 64-wide
    tiles of the walk; the width of M1's partials depends on m only.
    A lane's bits then do not depend on its batch (resume, compaction;
    the card test test_ml_lane_bits_do_not_depend_on_the_batch)."""
    src = (build.CSRC / "ml.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kMl[HW]Chunk) = (\d+);", src))
    assert int(consts["kMlHChunk"]) == tk.H_CHUNK
    assert int(consts["kMlWChunk"]) == tk.W_CHUNK
    assert re.search(r"launch_hpass, x, w, h, B, n, m, r, kMlHChunk,", src)
    assert re.search(r"launch_wpass, x, w, h, B, n, m, r, kMlWChunk,", src)
    assert tk.H_CHUNK % 64 == 0 and tk.W_CHUNK % 64 == 0
    for m in (1, 63, 64, 65, 447, 8192):
        assert tk.xlog_part_width(m) == -(-m // tk.H_CHUNK)
    assert list(inspect.signature(tk.xlog_part_width).parameters) == ["m"]


def test_wrappers_reject_bad_inputs():
    x = torch.ones(5, 6, dtype=torch.float64)
    w = torch.ones(2, 5, 3, dtype=torch.float64)
    h = torch.ones(2, 3, 6, dtype=torch.float64)
    with pytest.raises(TypeError, match="share one dtype"):
        tk.ml_h(x, w, h.float())
    with pytest.raises(ValueError, match="shape mismatch"):
        tk.ml_w(x, w, h[:, :, :5])
    with pytest.raises(ValueError, match="contiguous"):
        tk.ml_w(x, w.transpose(1, 2).contiguous().transpose(1, 2), h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.ml_hpass(x, w, h)
    assert tk.LAUNCHES == {"ml_hpass": 0, "ml_wpass": 0}


def _jax_run(x, w0, h0, rm, pn, pd, fused, **kw):
    if fused == "dense":
        kw.update(fused_h=jml.ml_h_dense, fused_w=jml.ml_w_dense)
    elif fused == "pallas":
        fh, fw = jmlk.make_ml_backend(bn=8, bm=128)
        kw.update(fused_h=fh, fused_w=fw, nm_true=x.shape)
        x = jmlk.pad_matrix(jnp.asarray(x), 8, 128)
    xj = jnp.asarray(x)
    if rm is None:
        f = jax.vmap(lambda w, h: jml.ml_run(xj, w, h, pn=pn, pd=pd, **kw))
        return f(jnp.asarray(w0), jnp.asarray(h0))
    f = jax.vmap(lambda w, h, mm: jml.ml_run(xj, w, h, pn=pn, pd=pd,
                                             rank_mask=mm, **kw))
    return f(jnp.asarray(w0), jnp.asarray(h0), jnp.asarray(rm))


def _assert_same_run(a, b):
    np.testing.assert_array_equal(b.n_iter.numpy(), np.asarray(a.n_iter))
    np.testing.assert_array_equal(b.cid.numpy(), np.asarray(a.cid))
    np.testing.assert_array_equal(b.done.numpy(), np.asarray(a.done))
    np.testing.assert_array_equal(b.zstep.numpy(), np.asarray(a.zstep))
    np.testing.assert_allclose(b.lkh.numpy(), np.asarray(a.lkh), rtol=1e-10)
    np.testing.assert_allclose(b.w.numpy(), np.asarray(a.w), rtol=1e-8)
    np.testing.assert_allclose(b.h.numpy(), np.asarray(a.h), rtol=1e-8)


@pytest.mark.parametrize("loop,criterion,masked", [
    ("eager", "likelihood", True),
    ("eager", "connectivity", False),
    ("dense", "likelihood", True),
    ("dense", "connectivity", True),
    ("kernels", "likelihood", True),
    ("kernels", "connectivity", True),
    ("kernels", "likelihood", False),
])
def test_ml_run_matches_vmapped_jax(lanes, loop, criterion, masked):
    """Lane-batched ml_run against the vmapped JAX loop.  The JAX eager
    connectivity loop drops rank masks and prior terms, so that case
    runs without them (test_eager_connectivity_honours_masks)."""
    x, w0, h0, rm = lanes
    rm = rm if masked else None
    pn, pd = (0.0, 0.0) if criterion == "connectivity" \
        and loop == "eager" else (0.5, 0.25)
    kw = dict(itmax=300, tol=1e-6, criterion=criterion, ncnn_step=10)
    a = _jax_run(x, w0, h0, rm, pn, pd,
                 {"eager": None, "dense": "dense",
                  "kernels": "pallas"}[loop], **kw)
    tkw = dict(kw)
    if loop == "dense":
        tkw.update(fused_h=tml.ml_h_dense, fused_w=tml.ml_w_dense)
    elif loop == "kernels":
        fh, fw = tk.make_ml_backend()
        tkw.update(fused_h=fh, fused_w=fw)
    b = tml.ml_run(_t(x), _t(w0), _t(h0), pn=pn, pd=pd,
                   rank_mask=None if rm is None else _t(rm), **tkw)
    _assert_same_run(a, b)
    assert len(set(b.n_iter.tolist())) > 1     # lanes froze apart


def test_eager_connectivity_honours_masks(lanes):
    """The port's eager connectivity loop applies rank masks and prior
    terms, so it equals the fused loop (JAX's fused loop applies them;
    JAX's eager connectivity loop does not)."""
    x, w0, h0, rm = lanes
    kw = dict(itmax=300, criterion="connectivity", ncnn_step=10, pn=0.5,
              pd=0.25, rank_mask=_t(rm))
    a = tml.ml_run(_t(x), _t(w0), _t(h0), **kw)
    b = tml.ml_run(_t(x), _t(w0), _t(h0), fused_h=tml.ml_h_dense,
                   fused_w=tml.ml_w_dense, **kw)
    np.testing.assert_array_equal(a.n_iter.numpy(), b.n_iter.numpy())
    np.testing.assert_array_equal(a.cid.numpy(), b.cid.numpy())
    np.testing.assert_allclose(a.lkh.numpy(), b.lkh.numpy(), rtol=1e-12)
    eps = np.finfo(np.float64).eps
    assert (a.h.numpy()[np.asarray(RANKS) < RMAX, RMAX - 1] == eps).all()
    j = _jax_run(x, w0, h0, rm, 0.5, 0.25, None, itmax=300,
                 criterion="connectivity", ncnn_step=10)
    assert not np.array_equal(np.asarray(j.h), a.h.numpy())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("criterion", ["likelihood", "connectivity"])
def test_two_bounded_calls_equal_one(lanes, fused, criterion):
    x, w0, h0, rm = lanes
    kw = dict(tol=1e-6, criterion=criterion, ncnn_step=10, pn=0.5,
              pd=0.25, rank_mask=_t(rm))
    if fused:
        fh, fw = tk.make_ml_backend()
        kw.update(fused_h=fh, fused_w=fw)
    one = tml.ml_run(_t(x), _t(w0), _t(h0), itmax=300, **kw)
    # 10 sweeps: no streak can reach ncnn_step yet
    first = tml.ml_run(_t(x), _t(w0), _t(h0), itmax=10, **kw)
    assert (first.n_iter == 10).all() and not first.done.any()
    two = tml.ml_run(_t(x), first.w, first.h, itmax=300, it0=11,
                     lk0_init=first.lkh, cid0=first.cid,
                     zstep0=first.zstep, **kw)
    for f in ("w", "h", "lkh", "n_iter", "cid", "zstep", "done"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f


def test_partitions_equal_batched():
    a = torch.tensor([[0, 0, 1, 1, 2], [0, 1, 2, 0, 1]])
    relabelled = torch.tensor([[2, 2, 0, 0, 1], [1, 2, 0, 1, 2]])
    merged = torch.tensor([[0, 0, 0, 1, 2], [0, 1, 2, 0, 0]])
    assert tml.partitions_equal(a, relabelled, 3).tolist() == [True, True]
    assert tml.partitions_equal(a, merged, 3).tolist() == [False, False]
    mixed = torch.stack([relabelled[0], merged[1]])
    assert tml.partitions_equal(a, mixed, 3).tolist() == [True, False]
    for b in range(2):
        for c in (relabelled, merged):
            assert bool(tml.partitions_equal(a[b], c[b], 3)) == bool(
                jml.partitions_equal(jnp.asarray(a[b].numpy()),
                                     jnp.asarray(c[b].numpy()), 3))


def test_hard_assign_takes_the_first_maximal_index():
    h = torch.tensor([[[1.0, 3.0, 2.0], [1.0, 3.0, 5.0], [0.5, 3.0, 5.0]]],
                     dtype=torch.float64)
    assert tml.hard_assign(h).tolist() == [[0, 0, 1]]
    assert tml.hard_assign(h).dtype == torch.int32
    np.testing.assert_array_equal(
        tml.hard_assign(h)[0].numpy(),
        np.asarray(jml.hard_assign(jnp.asarray(h[0].numpy()))))


def test_ml_init_and_state_carry():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    w, h = tml.ml_init(g1, 5, 7, 3, torch.float32, device="cpu")
    w2, h2 = tml.ml_init(g2, 5, 7, 3, torch.float64, device="cpu")
    assert w.shape == (5, 3) and h.shape == (3, 7) and w.dtype == torch.float32
    assert torch.equal(w, w2.float()) and ((h2 >= 0) & (h2 < 1)).all()
    key = jax.random.PRNGKey(0)
    res = jax.vmap(lambda k: jml.ml_run(
        jnp.ones((5, 7)), *jml.ml_init(k, 5, 7, 2, jnp.float64),
        itmax=3))(jax.random.split(key, 2))
    carried = tml.ml_state_from_numpy(
        type(res)(*(np.asarray(f) for f in res)), device="cpu")
    assert isinstance(carried, tml.MLRunResult)
    assert carried.w.shape == (2, 5, 2) and carried.w.dtype == torch.float64
    back = tml.ml_state_to_numpy(carried)
    np.testing.assert_array_equal(back.h, np.asarray(res.h))
    pair = tml.ml_state_from_numpy((np.ones((2, 5, 2)), np.ones((2, 2, 7))),
                                   dtype=torch.float32, device="cpu")
    assert isinstance(pair, tuple) and pair[1].dtype == torch.float32
