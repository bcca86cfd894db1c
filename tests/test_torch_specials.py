"""The port's special functions against the JAX package's.

Same Bernoulli-series formulae on a grid of x in [1e-4, 1e9], in float64
(tolerance 1e-13 relative: the two differ only in FMA contraction and
libm ulps) and float32 (2e-6 relative, 1e-6 absolute near psi's zero at
1.4616: a few f32 ulps).  ``gammaln_approx`` in float32 has its own
absolute bound: below x = 10 it shifts x to xs in [10, 20) and returns
(xs - 0.5) log xs - xs + ... - log(x (x+1) ... (xs-1)), whose terms
cancel to a value near 0 (lgamma's zeros at 1 and 2).  The largest term
is below 19.5 log 20 < 60, and float32 rounds each term to half an ulp
of its size, so the two packages may differ by a few ulps of 60 there:
four ulps, 1.5e-5.  ``digamma_gammaln_both`` is checked in both branches
(float32 shift 6 / 3-term series, float64 shift 10 / 7-term).
"""

import numpy as np
import pytest
import scipy.special as sps
import torch

import jax.numpy as jnp

from ccfindr_tpu.ops import vb as jvb
from ccfindr_tpu_torch.ops import vb as tvb

torch.set_num_threads(2)

X = np.concatenate([np.logspace(-4, 9, 400), [1.4616321449683622, 6.0,
                                              10.0, 0.5, 1.0, 2.0]])
TOL = {np.float64: dict(rtol=1e-13, atol=1e-13),
       np.float32: dict(rtol=2e-6, atol=1e-6)}
# float32 gammaln_approx: four ulps of its largest Stirling term (< 60)
GAMMALN_F32_ATOL = 4 * float(np.spacing(np.float32(60.0)))


def _pair(fn_name, dtype):
    x = X.astype(dtype)
    want = getattr(jvb, fn_name)(jnp.asarray(x))
    got = getattr(tvb, fn_name)(torch.as_tensor(x))
    return got, want


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fn_name", ["trigamma", "digamma_approx",
                                     "gammaln_approx"])
def test_special_matches_jax(fn_name, dtype):
    got, want = _pair(fn_name, dtype)
    assert got.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    tol = dict(TOL[dtype])
    if fn_name == "gammaln_approx" and dtype == np.float32:
        tol["atol"] = GAMMALN_F32_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_digamma_gammaln_both_matches_jax(dtype):
    (psi, lg), (jpsi, jlg) = _pair("digamma_gammaln_both", dtype)
    np.testing.assert_allclose(psi.numpy(), np.asarray(jpsi), **TOL[dtype])
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL[dtype])


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-11),
                                        (np.float32, 5e-6)])
def test_digamma_gammaln_both_against_scipy(dtype, rtol):
    """Each branch is accurate to its own dtype (the f32 branch's short
    series would be visible at f64 precision)."""
    x = X[X > 1e-3].astype(dtype)
    psi, lg = tvb.digamma_gammaln_both(torch.as_tensor(x))
    np.testing.assert_allclose(psi.numpy(), sps.digamma(x.astype(np.float64)),
                               rtol=rtol, atol=10 * rtol)
    np.testing.assert_allclose(lg.numpy(), sps.gammaln(x.astype(np.float64)),
                               rtol=rtol, atol=10 * rtol)


def test_f32_branch_is_the_short_series():
    """float32 input takes the 6-step branch: evaluated on float32 values
    but in float64 arithmetic, the 10-step branch differs from it."""
    x = np.array([1.5, 2.5, 3.25], np.float32)
    psi32, _ = tvb.digamma_gammaln_both(torch.as_tensor(x))
    psi64, _ = tvb.digamma_gammaln_both(torch.as_tensor(x.astype(np.float64)))
    # both right to f32 precision, but not bit-equal in f64 terms
    np.testing.assert_allclose(psi32.double().numpy(), psi64.numpy(),
                               rtol=1e-6)
    jpsi32, _ = jvb.digamma_gammaln_both(jnp.asarray(x))
    np.testing.assert_allclose(psi32.numpy(), np.asarray(jpsi32),
                               rtol=2e-7)
