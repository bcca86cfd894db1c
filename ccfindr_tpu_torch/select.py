"""Rank selection and hard cluster assignment.

Equivalents of reference optimal_rank / slope (R/utils2.R:59-111) and
cluster_id (R/utils.R:903-909).

R's ``smooth.spline(x, y, df=df)`` has no scipy twin, so
:func:`smooth_spline_df` reimplements the natural cubic smoothing
spline in its Reinsch/Green–Silverman form — fitted values
``(I + lambda*K)^{-1} y`` with ``K = Q R^{-1} Q^T`` — and matches the
requested equivalent degrees of freedom ``df = tr((I + lambda*K)^{-1})``
by bisection on log(lambda) (SURVEY.md §7.3 risk item).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .container import SCSet


def _spline_matrices(x):
    """Band matrices Q (n x n-2) and R (n-2 x n-2) of the Reinsch form."""
    n = len(x)
    h = np.diff(x)
    Q = np.zeros((n, n - 2))
    R = np.zeros((n - 2, n - 2))
    for j in range(1, n - 1):
        Q[j - 1, j - 1] = 1.0 / h[j - 1]
        Q[j, j - 1] = -(1.0 / h[j - 1] + 1.0 / h[j])
        Q[j + 1, j - 1] = 1.0 / h[j]
        R[j - 1, j - 1] = (h[j - 1] + h[j]) / 3.0
        if j < n - 2:
            R[j - 1, j] = h[j] / 6.0
            R[j, j - 1] = h[j] / 6.0
    return Q, R


def _smoother(x, lam):
    """Hat matrix A(lambda)^{-1} with A = I + lambda*K."""
    n = len(x)
    Q, R = _spline_matrices(x)
    K = Q @ np.linalg.solve(R, Q.T)
    return np.linalg.inv(np.eye(n) + lam * K)


def smooth_spline_df(x, y, df):
    """Natural cubic smoothing spline with target equivalent df.

    Returns fitted values at the (sorted unique) x.  df is clamped to
    [2, n]; df == n yields interpolation (fitted == y), matching
    R smooth.spline's limiting behavior.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    order = np.argsort(x)
    x, y = x[order], y[order]
    n = len(x)
    if n < 4 or df >= n:
        return x, y.copy()
    df = max(float(df), 2.0)

    # x-scale normalization (mirrors R's internal [0,1] rescale; only
    # changes the lambda parameterization, not the df <-> fit mapping)
    xs = (x - x[0]) / (x[-1] - x[0])

    def df_of(loglam):
        return np.trace(_smoother(xs, 10.0 ** loglam))

    lo, hi = -12.0, 12.0
    # df is monotone decreasing in lambda
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if df_of(mid) > df:
            lo = mid
        else:
            hi = mid
    lam = 10.0 ** (0.5 * (lo + hi))
    fitted = _smoother(xs, lam) @ y
    return x, fitted


def slope(y, x):
    """Forward-difference slopes (reference R/utils2.R:97-111)."""
    y = np.asarray(y, dtype=float)
    x = np.asarray(x, dtype=float)
    n = len(x)
    s = np.zeros(n)
    s[0] = (y[1] - y[0]) / (x[1] - x[0])
    for i in range(1, n - 1):
        s[i] = (y[i + 1] - y[i]) / (x[i + 1] - x[i])
    s[n - 1] = s[n - 2]
    return s


def optimal_rank(object, df=10, BF_threshold=3.0, type=None, m=None):
    """Estimate the optimal rank from the rank–log-evidence profile
    (reference R/utils2.R:59-95).

    Type 1: clear interior maximum -> ropt = argmax of the spline fit.
    Type 2: evidence plateaus -> first rank where the spline slope
    drops below log(BF_threshold)/m (per-feature Bayes-factor band).
    Returns dict(type=..., ropt=...).
    """
    if isinstance(object, SCSet):
        me = object.measure.iloc[:, :2]
        m = object.n_genes
    elif isinstance(object, pd.DataFrame):
        me = object.iloc[:, :2]
        if m is None:
            raise ValueError("No. of rows unknown")
    else:
        raise TypeError("Inappropriate class of object")

    xr = me.iloc[:, 0].to_numpy(dtype=float)
    yr = me.iloc[:, 1].to_numpy(dtype=float)
    df = min(df, len(me))
    fx, fy = smooth_spline_df(xr, yr, df)
    rst = fx[int(np.argmax(fy))]
    bf = np.log(BF_threshold) / m

    if type is None:
        rmax = xr.max()
        flag = np.abs(fy - fy.max()) <= bf
        in_range = fx[flag]
        type = 2 if rmax in in_range else 1

    if type == 1:
        ropt = rst
    else:
        sl = slope(fy, fx)
        below = np.nonzero(sl < bf)[0]
        idx = below[0] if len(below) else len(me) - 1
        ropt = fx[idx]

    return {"type": int(type), "ropt": int(round(float(ropt)))}


def cluster_id(object: SCSet, rank: int = 2) -> pd.Series:
    """Hard cluster assignment: 1-based argmax over rows of H per cell
    (reference R/utils.R:903-909)."""
    h = object.coeff_at(rank)
    cid = np.argmax(h, axis=0) + 1
    return pd.Series(cid, index=object.colnames, name="cluster")
