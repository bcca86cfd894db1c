"""The port's randomized SVD (ops/rsvd.py) and its SVD start against the
JAX package's, at float64 on the CPU.

JAX draws the test matrix Omega from ``jax.random``; the parity tests
hand the port JAX's draw by patching ``ops.rsvd._draw_omega`` (as the ML
tests hand it JAX's initial factors).  With the same Omega both run the
same Halko-Martinsson-Tropp steps on LAPACK: s agrees to 1e-10, and so
do u and vt once each singular pair takes JAX's sign (the small SVD's
sign convention differs between the two libraries; a pair flips as a
whole, which the starts do not see: svd2 takes absolute values and
NNDSVD fixes its own signs).  Tolerances: products X b and X^T a 1e-12
relative; the SVD starts 1e-10.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from ccfindr_tpu.ops import rsvd as jrsvd
from ccfindr_tpu.ops import sparse as jsk
from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu_torch.ops import rsvd as trsvd
from ccfindr_tpu_torch.ops import sparse as tsk
from ccfindr_tpu_torch.ops import tile as ttile
from ccfindr_tpu_torch.ops import vb as tvb

torch.set_num_threads(2)


def _jax_omega(m, k, dtype, seed, device):
    om = jax.random.normal(jax.random.PRNGKey(seed), (m, k), jnp.float64)
    return torch.as_tensor(np.array(om), dtype=dtype, device=device)


@pytest.fixture
def jax_omega(monkeypatch):
    monkeypatch.setattr(trsvd, "_draw_omega", _jax_omega)


def _counts(n, m, density, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, m)) < density) * rng.poisson(3.0, (n, m))
    x[:, 0] += 1                               # no empty row
    return x.astype(np.float64)


def _close(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("kind", ["dense", "coo", "tile"])
@pytest.mark.parametrize("n,m,rank", [(60, 45, 4), (33, 80, 6)])
def test_randomized_svd_matches_jax(jax_omega, kind, n, m, rank):
    x = _counts(n, m, 0.3, seed=n + m)
    if kind == "dense":
        tx, jx = torch.tensor(x), x
    else:
        jx = jsk.from_scipy(sp.csr_matrix(x), dtype=jnp.float64, chunk=64)
        tx = (tsk.from_scipy(sp.csr_matrix(x), dtype=torch.float64,
                             chunk=64, device="cpu") if kind == "coo"
              else ttile.from_scipy_tile(x, dtype=torch.float64,
                                         device="cpu"))
    u, s, vt = trsvd.randomized_svd(tx, rank, seed=3, dtype=torch.float64)
    ju, js, jvt = jrsvd.randomized_svd(jx, rank, seed=3, dtype=jnp.float64)
    assert u.shape == (n, rank) and s.shape == (rank,) and \
        vt.shape == (rank, m)
    sign = torch.sign((u * torch.tensor(np.array(ju))).sum(0))
    assert (sign != 0).all()
    for got, want, what in ((u * sign, ju, "u"), (s, js, "s"),
                            (vt * sign[:, None], jvt, "vt")):
        _close(got, want, 1e-10, what)
    # and the top singular value is X's own (4 power iterations; the
    # noise spectrum below it is flat, so the others only approach it)
    sx = np.linalg.svd(x)[1]
    np.testing.assert_allclose(s[0].numpy(), sx[0], rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), sx[:rank], rtol=1e-2)


def test_randomized_svd_is_deterministic():
    """Two calls give the same bits; the seed picks Omega."""
    x = sp.csr_matrix(_counts(50, 70, 0.2, seed=1))
    sc = tsk.from_scipy(x, dtype=torch.float64, device="cpu")
    a = trsvd.randomized_svd(sc, 5, seed=7)
    b = trsvd.randomized_svd(sc, 5, seed=7)
    c = trsvd.randomized_svd(sc, 5, seed=8)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
    om = trsvd._draw_omega(70, 15, torch.float32, 7, "cpu")
    assert om.shape == (70, 15) and om.dtype == torch.float32
    assert torch.equal(om, trsvd._draw_omega(70, 15, torch.float64, 7,
                                             "cpu").float())


@pytest.mark.parametrize("chunk", [16, 1 << 16])
def test_coo_products_match_jax(chunk):
    rng = np.random.default_rng(5)
    x = sp.csr_matrix(_counts(40, 30, 0.25, seed=5))
    b, a = rng.normal(size=(30, 7)), rng.normal(size=(40, 7))
    jx = jsk.from_scipy(x, dtype=jnp.float64, chunk=chunk)
    tx = tsk.from_scipy(x, dtype=torch.float64, chunk=chunk, device="cpu")
    _close(trsvd.coo_matmul(tx, torch.tensor(b), chunk=chunk),
           jrsvd.coo_matmul(jx, jnp.asarray(b), chunk=chunk), 1e-12, "Xb")
    _close(trsvd.coo_rmatmul(tx, torch.tensor(a), chunk=chunk),
           jrsvd.coo_rmatmul(jx, jnp.asarray(a), chunk=chunk), 1e-12,
           "X^T a")
    np.testing.assert_allclose(trsvd.coo_matmul(tx, torch.tensor(b)).numpy(),
                               x @ b, rtol=1e-12)


@pytest.mark.parametrize("variant", ["svd", "svd2"])
@pytest.mark.parametrize("method", ["randomized", "auto"])
def test_vb_init_svd_randomized_matches_jax(jax_omega, variant, method):
    """'randomized', and 'auto' on a COO input (which JAX's 'auto' always
    takes to the randomized SVD), give JAX's NNDSVD and svd2 starts."""
    x = sp.csr_matrix(_counts(50, 64, 0.3, seed=11))
    hy = (1.0, 1.0, 1.0, 2.0)
    if method == "auto":
        jx = jsk.from_scipy(x, dtype=jnp.float64)
        tx = tsk.from_scipy(x, dtype=torch.float64, device="cpu")
    else:
        jx = tx = x
    j = jvb.vb_init_svd(jx, 3, jvb.Hyper(*hy), variant=variant,
                        dtype=jnp.float64, method=method, seed=4)
    t = tvb.vb_init_svd(tx, 3, tvb.Hyper(*hy), variant=variant,
                        dtype=torch.float64, method=method, seed=4,
                        device="cpu")
    for f in ("ew", "eh", "lw", "lh", "dw", "dh"):
        _close(getattr(t, f), getattr(j, f), 1e-10, f)
    assert t.lw.dtype == torch.float64 and (t.lw > 0).all()


def test_vb_init_svd_rejects_unknown_method():
    with pytest.raises(ValueError, match="svd method"):
        tvb.vb_init_svd(_counts(10, 12, 0.5, 0), 2,
                        tvb.Hyper(1.0, 1.0, 1.0, 1.0), method="lanczos",
                        device="cpu")


@pytest.mark.parametrize("method,dtype", [("randomized", torch.float32),
                                          ("randomized", torch.float64),
                                          ("exact", torch.float32)])
def test_vb_init_svd_start_does_not_depend_on_x_dtype(method, dtype):
    """The SVD start reads X's values whatever X's type: integer counts
    as int8, float32 or float64 give the same start bit for bit (the
    randomized route converts X on the device, the exact route on the
    host in float64)."""
    rng = np.random.default_rng(4)
    x = rng.poisson(2.0, (90, 130)).astype(np.int8)
    hy = tvb.Hyper(1.0, 1.0, 1.0, 1.0)
    starts = [tvb.vb_init_svd(x.astype(xt), 5, hy, dtype=dtype,
                              device="cpu", method=method)
              for xt in (np.int8, np.float32, np.float64)]
    for st in starts[1:]:
        for a, b in zip(starts[0], st):
            assert torch.equal(a, b)
