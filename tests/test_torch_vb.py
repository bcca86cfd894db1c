"""The port's VB core (ccfindr_tpu_torch.ops.vb) against the JAX
package's (ccfindr_tpu.ops.vb), at float64 on the CPU.

Inputs are drawn with numpy from a seed and carried into both packages;
JAX's vmap over restarts is the port's leading lane axis.  Tolerances:
one sweep's outputs 1e-10 relative (the same formulae; only summation
order and libm ulps differ); converged loops as tests/test_sol.py holds
the JAX paths to each other (lml 1e-9, factors 1e-7, hypers 1e-8) with
equal sweep counts.
"""

import numpy as np
import pytest
import torch
from scipy.special import gammaln

import jax
import jax.numpy as jnp

from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu_torch.ops import rsvd as trsvd
from ccfindr_tpu_torch.ops import vb as tvb

torch.set_num_threads(2)


def _planted(n, m, r, seed=0):
    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.8, 1.0, (n, r))
    hf = rng.gamma(0.8, 1.0, (r, m))
    return rng.poisson(wf @ hf * (2.0 * n * m / (wf @ hf).sum())
                       ).astype(np.float64)


def _state_np(n, m, r, seed=1):
    rng = np.random.default_rng(seed)
    w = rng.gamma(1.0, 1.0, (n, r))
    h = rng.gamma(1.0, 1.0, (r, m))
    return jvb.VBState(ew=w, eh=h * 1.1, lw=w * 0.9, lh=h,
                       dw=np.zeros_like(w), dh=np.zeros_like(h),
                       lkh=np.asarray(-np.inf))


def _jstate(st):
    return jax.tree.map(jnp.asarray, st)


def _hyper_np(v=(1.1, 0.9, 1.2, 0.8)):
    return jvb.Hyper(*(np.asarray(x) for x in v))


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(tvb.state_to_numpy(got), np.asarray(want),
                               rtol=rtol, atol=0, err_msg=what)


def test_state_round_trip():
    st = _state_np(7, 9, 3)
    hy = _hyper_np()
    t_st = tvb.state_from_numpy(st, device="cpu")
    t_hy = tvb.state_from_numpy(hy, dtype=torch.float32, device="cpu")
    assert isinstance(t_st, tvb.VBState) and isinstance(t_hy, tvb.Hyper)
    assert t_st.ew.dtype == torch.float64 and t_hy.aw.dtype == torch.float32
    back = tvb.state_to_numpy(t_st)
    for f in jvb.VBState._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(st, f))
    # a JAX state passes through np.asarray field by field as well
    jback = tvb.state_to_numpy(tvb.state_from_numpy(
        jax.tree.map(np.asarray, _jstate(st)), device="cpu"))
    np.testing.assert_array_equal(jback.lh, st.lh)


@pytest.mark.parametrize("r_true", [None, 2])
def test_posterior_update(r_true):
    n, m, r = 12, 17, 4
    rng = np.random.default_rng(3)
    st = _state_np(n, m, r)
    hy = _hyper_np()
    sw = rng.gamma(2.0, 1.0, (n, r))
    sh = rng.gamma(2.0, 1.0, (r, m))
    fudge, lgx = np.finfo(np.float64).eps, 37.5
    kw_j, kw_t = {}, {}
    if r_true is not None:
        rmask = (np.arange(r) < r_true).astype(np.float64)
        kw_j = dict(rank_mask=jnp.asarray(rmask), r_true=float(r_true))
        kw_t = dict(rank_mask=torch.as_tensor(rmask),
                    r_true=torch.tensor(float(r_true), dtype=torch.float64))
    new_j, pend_j = jvb.posterior_update(
        jnp.asarray(sw), jnp.asarray(sh), _jstate(st),
        jax.tree.map(jnp.asarray, hy), fudge, lgx, **kw_j)
    new_t, pend_t = tvb.posterior_update(
        torch.as_tensor(sw), torch.as_tensor(sh),
        tvb.state_from_numpy(st, device="cpu"),
        tvb.state_from_numpy(hy, device="cpu"),
        torch.tensor(fudge, dtype=torch.float64),
        lgx, **kw_t)
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        _close(getattr(new_t, f), getattr(new_j, f), 1e-12, f)
    _close(pend_t, pend_j, 1e-12, "pending")


MASKS = [(True,) * 4, (False,) * 4, (True, False, True, False),
         (False, True, False, True), (True, True, False, False),
         (False, False, True, True)]


@pytest.mark.parametrize("mask", MASKS)
def test_hyper_update(mask):
    st = _state_np(15, 20, 3, seed=4)
    hy = _hyper_np()
    hj, fj = jvb.hyper_update(mask, _jstate(st),
                              jax.tree.map(jnp.asarray, hy))
    ht, ft = tvb.hyper_update(mask, tvb.state_from_numpy(st, device="cpu"),
                              tvb.state_from_numpy(hy, device="cpu"))
    for f in tvb.Hyper._fields:
        _close(getattr(ht, f), getattr(hj, f), 1e-12, f)
    assert bool(ft) == bool(fj)


def test_hyper_update_rank_mask_and_lanes():
    """Rank-masked means, two lanes at once (the port's lane axis)
    against two JAX calls."""
    n, m, r = 10, 14, 4
    sts = [_state_np(n, m, r, seed=s) for s in (5, 6)]
    rts = [2, 4]
    t_st = tvb.state_from_numpy(jax.tree.map(lambda *a: np.stack(a), *sts),
                                device="cpu")
    hy = _hyper_np()
    t_hy = tvb.Hyper(*(torch.full((2,), float(v), dtype=torch.float64)
                       for v in hy))
    rmask = np.stack([(np.arange(r) < k).astype(np.float64) for k in rts])
    ht, ft = tvb.hyper_update(
        (True,) * 4, t_st, t_hy, rank_mask=torch.as_tensor(rmask),
        r_true=torch.tensor(rts, dtype=torch.float64))
    for b, (st, k) in enumerate(zip(sts, rts)):
        hj, fj = jvb.hyper_update(
            (True,) * 4, _jstate(st), jax.tree.map(jnp.asarray, hy),
            rank_mask=jnp.asarray(rmask[b]), r_true=float(k))
        for f in tvb.Hyper._fields:
            _close(getattr(ht, f)[b], getattr(hj, f), 1e-12, f)
        assert bool(ft[b]) == bool(fj)


def test_fused_dense_and_vb_sweep():
    n, m, r = 11, 13, 3
    x = _planted(n, m, r)
    st = _state_np(n, m, r, seed=2)
    hy = _hyper_np()
    swn_j, shn_j, dt_j = jvb.fused_dense(jnp.asarray(x), jnp.asarray(st.lw),
                                         jnp.asarray(st.lh))
    swn_t, shn_t, dt_t = tvb.fused_dense(torch.as_tensor(x),
                                         torch.as_tensor(st.lw),
                                         torch.as_tensor(st.lh))
    _close(swn_t, swn_j, 1e-12, "swn")
    _close(shn_t, shn_j, 1e-12, "shn")
    _close(dt_t, dt_j, 1e-11, "dterm")
    fudge = np.finfo(np.float64).eps
    lgx = float(gammaln(x + 1.0).sum())
    new_j = jvb.vb_sweep(jnp.asarray(x), _jstate(st),
                         jax.tree.map(jnp.asarray, hy), fudge, lgx)
    new_t = tvb.vb_sweep(torch.as_tensor(x),
                         tvb.state_from_numpy(st, device="cpu"),
                         tvb.state_from_numpy(hy, device="cpu"),
                         torch.tensor(fudge, dtype=torch.float64), lgx)
    for f in jvb.VBState._fields:
        _close(getattr(new_t, f), getattr(new_j, f), 1e-10, f)


def _run_both(fused, itmax, ranks, r_pad, seed=0, **kw):
    """Port's lane-batched loop vs one JAX vb_run per lane."""
    n, m = 16, 24
    x = _planted(n, m, 3, seed=seed)
    sts = [_state_np(n, m, r_pad, seed=10 + b) for b in range(len(ranks))]
    hy = _hyper_np((1.0, 1.0, 1.0, 1.0))
    nb = len(ranks)
    rmask = np.stack([(np.arange(r_pad) < k).astype(np.float64)
                      for k in ranks])
    t_st = tvb.state_from_numpy(jax.tree.map(lambda *a: np.stack(a), *sts),
                                device="cpu")
    t_hy = tvb.Hyper(*(torch.ones(nb, dtype=torch.float64),) * 4)
    out_t = tvb.vb_run(
        torch.as_tensor(x), t_st, t_hy, itmax=itmax, tol=1e-6,
        fused=tvb.fused_dense if fused else None,
        rank_mask=torch.as_tensor(rmask),
        r_true=torch.tensor(ranks, dtype=torch.float64), **kw)
    outs_j = [jvb.vb_run(jnp.asarray(x), _jstate(st),
                         jax.tree.map(jnp.asarray, hy), itmax=itmax,
                         tol=1e-6, fused=jvb.fused_dense if fused else None,
                         rank_mask=jnp.asarray(rmask[b]),
                         r_true=float(ranks[b]), **kw)
              for b, st in enumerate(sts)]
    return out_t, outs_j


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("itmax", [5, 400])
def test_vb_run_matches_jax(fused, itmax):
    out_t, outs_j = _run_both(fused, itmax, ranks=[2, 3, 4], r_pad=4)
    o = tvb.state_to_numpy(out_t)
    for b, oj in enumerate(outs_j):
        assert int(o.n_iter[b]) == int(oj.n_iter), b
        assert bool(o.done[b]) == bool(oj.done)
        np.testing.assert_allclose(o.lml[b], float(oj.lml), rtol=1e-9)
        for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
            np.testing.assert_allclose(getattr(o.state, f)[b],
                                       np.asarray(getattr(oj.state, f)),
                                       rtol=1e-7, err_msg=f)
        for f in tvb.Hyper._fields:
            np.testing.assert_allclose(getattr(o.hyper, f)[b],
                                       float(getattr(oj.hyper, f)),
                                       rtol=1e-8, err_msg=f)
    if itmax == 400:
        assert o.done.all()
        # the lanes stop at different sweeps: frozen lanes kept theirs
        assert len(set(o.n_iter.tolist())) > 1


def test_vb_run_resume_exact():
    """it0/lk0_init continuation reproduces the uninterrupted run."""
    n, m, r = 14, 20, 3
    x = torch.as_tensor(_planted(n, m, r, seed=9))
    st = tvb.state_from_numpy(jax.tree.map(lambda a: np.asarray(a)[None],
                                           _state_np(n, m, r, seed=5)),
                                device="cpu")
    hy = tvb.Hyper(*(torch.ones(1, dtype=torch.float64),) * 4)
    full = tvb.vb_run(x, st, hy, itmax=30, tol=0.0, fused=tvb.fused_dense)
    part = tvb.vb_run(x, st, hy, itmax=12, tol=0.0, fused=tvb.fused_dense)
    res = tvb.vb_run(x, part.state, part.hyper, itmax=30, tol=0.0,
                     fused=tvb.fused_dense, it0=13, lk0_init=part.lml)
    assert int(full.n_iter) == 30
    for f in ("ew", "eh", "lw", "lh"):
        torch.testing.assert_close(getattr(res.state, f),
                                   getattr(full.state, f), rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["svd", "svd2"])
def test_vb_init_svd_matches_jax(variant):
    x = _planted(30, 40, 3, seed=12)
    hy = _hyper_np((1.0, 1.0, 1.0, 2.0))
    sj = jvb.vb_init_svd(x, 3, hy, variant=variant, dtype=jnp.float64,
                         method="exact", seed=0)
    st = tvb.vb_init_svd(x, 3, hy, variant=variant, dtype=torch.float64,
                         method="exact", seed=0, device="cpu")
    for f in ("ew", "eh", "lw", "lh"):
        _close(getattr(st, f), getattr(sj, f), 1e-12, f)
    # method='randomized' (ROADMAP A8) with JAX's test matrix: JAX's start
    # to 1e-10 (its QR and SVD steps take a few ulps more than 'exact')
    rj = jvb.vb_init_svd(x, 3, hy, variant=variant, dtype=jnp.float64,
                         method="randomized", seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trsvd, "_draw_omega", lambda m, k, dtype, seed, device:
                   torch.as_tensor(np.array(jax.random.normal(
                       jax.random.PRNGKey(seed), (m, k), jnp.float64)),
                       dtype=dtype, device=device))
        rt = tvb.vb_init_svd(x, 3, hy, variant=variant, dtype=torch.float64,
                             method="randomized", seed=0, device="cpu")
    for f in ("ew", "eh", "lw", "lh"):
        _close(getattr(rt, f), getattr(rj, f), 1e-10, f)


def test_vb_init_random_generator():
    hy = tvb.Hyper(0.5, 2.0, 0.7, 1.5)
    a = tvb.vb_init_random(torch.Generator().manual_seed(3), 50, 60, 4, hy,
                           torch.float64, device="cpu")
    b = tvb.vb_init_random(torch.Generator().manual_seed(3), 50, 60, 4, hy,
                           torch.float32, device="cpu")
    assert a.ew.shape == (50, 4) and a.eh.shape == (4, 60)
    torch.testing.assert_close(a.ew.float(), b.ew)
    assert (a.ew > 0).all() and torch.equal(a.ew, a.lw)
    # gamma(aw) * bw/aw has mean bw
    assert abs(float(a.ew.mean()) - 2.0) < 0.5


def test_uniform_columns():
    ew = torch.tensor([[1.0, 2.0, 3.0], [1.0, 2.5, 3.0]],
                      dtype=torch.float64)
    np.testing.assert_array_equal(
        tvb.uniform_columns(ew, 1e-5).numpy(),
        np.asarray(jvb.uniform_columns(jnp.asarray(ew.numpy()), 1e-5)))
