"""The port's public names and defaults against the JAX package's, by
``inspect.signature``, and what the JAX keywords the port accepts do
(nothing that changes a result) on the CPU at float64."""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from ccfindr_tpu.ops import tile as jtile
from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu.ops.pallas import ml_kernels as jmlk
from ccfindr_tpu.ops.pallas import sol as jsol
from ccfindr_tpu_torch.ops import tile as ttile
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.ops.kernels import ml as tmlk
from ccfindr_tpu_torch.ops.kernels import sol as tsol

# the port's own addition to a JAX signature: the device it places on
PORT_ONLY = {"device"}
# dtype defaults are each framework's float32
FRAMEWORK_DEFAULTS = {"dtype"}


@pytest.mark.parametrize("jfn,tfn", [
    (jvb.vb_init_svd, tvb.vb_init_svd),
    (jmlk.ml_h_pallas, tmlk.ml_h_pallas),
    (jmlk.ml_w_pallas, tmlk.ml_w_pallas),
    (jmlk.make_ml_backend, tmlk.make_ml_backend),
    (jtile.from_scipy_tile, ttile.from_scipy_tile),
    (jtile.from_dense_tile, ttile.from_dense_tile),
    (jsol.sol_sweep, tsol.sol_sweep),
    (jsol.sol_sweep, tsol.sol_sweep_plain),
], ids=lambda f: f.__module__.split(".")[0] + "." + f.__name__)
def test_signature_matches_jax(jfn, tfn):
    """Every JAX parameter is the port's, of the same kind, in the same
    order and with the same default; the port adds only ``device``."""
    jp = inspect.signature(jfn).parameters
    tp = inspect.signature(tfn).parameters
    assert [k for k in tp if k not in PORT_ONLY] == list(jp)
    for name, p in jp.items():
        assert tp[name].kind == p.kind, name
        if name not in FRAMEWORK_DEFAULTS:
            assert tp[name].default == p.default, name


def test_dtype_defaults_are_float32():
    for fn in (tvb.vb_init_svd, ttile.from_scipy_tile, ttile.from_dense_tile):
        assert inspect.signature(fn).parameters["dtype"].default \
            == torch.float32
    for fn in (jvb.vb_init_svd, jtile.from_scipy_tile, jtile.from_dense_tile):
        assert inspect.signature(fn).parameters["dtype"].default \
            == jnp.float32


@pytest.mark.parametrize("variant", ["svd", "svd2"])
def test_vb_init_svd_auto_is_exact_below_4096(variant):
    rng = np.random.default_rng(3)
    x = rng.poisson(2.0, (40, 60)).astype(np.float64)
    hy = tvb.Hyper(1.0, 1.0, 1.0, 1.0)
    a = tvb.vb_init_svd(x, 3, hy, variant=variant, dtype=torch.float64,
                        device="cpu")
    b = tvb.vb_init_svd(x, 3, hy, variant=variant, dtype=torch.float64,
                        method="exact", device="cpu")
    assert torch.equal(a.lw, b.lw) and torch.equal(a.lh, b.lh)
    j = jvb.vb_init_svd(x, 3, jvb.Hyper(1.0, 1.0, 1.0, 1.0), variant=variant,
                        dtype=jnp.float64)
    np.testing.assert_allclose(a.lw.numpy(), np.asarray(j.lw), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("shape", [(4097, 4100), (5000, 4097)])
def test_vb_init_svd_auto_raises_where_jax_takes_randomized(shape):
    """Above 4096 on the short axis JAX's 'auto' picks the randomized
    SVD (ROADMAP A8): the port raises there, never computing another
    start silently."""
    x = sp.random(*shape, density=1e-4, random_state=0, format="csr")
    hy = tvb.Hyper(1.0, 1.0, 1.0, 1.0)
    with pytest.raises(NotImplementedError, match="A8"):
        tvb.vb_init_svd(x, 3, hy, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        tvb.vb_init_svd(x, 3, hy, method="randomized", device="cpu")


def test_ml_pallas_names_take_padded_x():
    """ml_h_pallas/ml_w_pallas (and make_ml_backend(bn, bm)) equal
    ml_h/ml_w on X and on X zero-padded by pad_matrix."""
    rng = np.random.default_rng(5)
    n, m, r = 37, 150, 4
    x = torch.tensor(rng.poisson(2.0, (n, m)).astype(np.float64))
    w = torch.tensor(rng.gamma(1.0, 1.0, (2, n, r)))
    h = torch.tensor(rng.gamma(1.0, 1.0, (2, r, m)))
    hn, xl = tmlk.ml_h(x, w, h)
    wn = tmlk.ml_w(x, w, h)
    xp = tmlk.pad_matrix(x, 8, 128)
    assert xp.shape == (40, 256)
    for xx in (x, xp):
        hn2, xl2 = tmlk.ml_h_pallas(xx, w, h, bn=8, bm=128)
        assert torch.equal(hn2, hn) and torch.equal(xl2, xl)
        assert torch.equal(tmlk.ml_w_pallas(xx, w, h), wn)
    fh, fw = tmlk.make_ml_backend(bn=8, bm=128)
    assert torch.equal(fh(x, w, h)[0], hn) and torch.equal(fw(x, w, h), wn)
    with pytest.raises(ValueError, match="shape mismatch"):
        tmlk.ml_h_pallas(x[:30], w, h)


def test_tile_layout_keywords_change_nothing():
    rng = np.random.default_rng(6)
    x = (rng.random((30, 50)) < 0.2) * rng.poisson(3.0, (30, 50))
    csr = sp.csr_matrix(x.astype(np.float64))
    a = ttile.from_scipy_tile(csr, dtype=torch.float64, device="cpu")
    b = ttile.from_scipy_tile(csr, dtype=torch.float64, bn=8, bm=128,
                              quantile=0.5, kt_cap=8, pack=False,
                              device="cpu")
    c = ttile.from_dense_tile(x, dtype=torch.float64, device="cpu", bn=8,
                              quantile=0.5)
    for t in (b, c):
        for f in ("indptr", "col", "val", "colptr", "row", "perm"):
            assert torch.equal(getattr(t, f), getattr(a, f)), f
        assert (t.n, t.m) == (a.n, a.m)
