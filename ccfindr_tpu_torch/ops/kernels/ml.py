"""The ML (Lee–Seung KL) passes as hand-written CUDA, with their plain
PyTorch versions.

Counterpart of ``ccfindr_tpu/ops/pallas/ml_kernels.py``.  The H phase
is M1 ``ml_hpass`` (``hn = w^T (x/wh)`` and each lane's sum of
``x*log(wh)``: per-block partials that the lane's last block adds in a
fixed order); the W phase is M2 ``ml_wpass`` (``wn = (x/wh) h^T``),
both in ``csrc/ml.cu``: two walks of the X pass template
``csrc/fused.cuh`` (layouts 'cm' and 'gm') without its streamed
output.  :func:`ml_h_plain` and :func:`ml_w_plain` are
the same functions in plain PyTorch; :func:`ml_h` and :func:`ml_w`
(and the JAX names :func:`ml_h_pallas`, :func:`ml_w_pallas`) take them
only for tensors on the CPU and launch the kernels for CUDA tensors,
with no fallback between them.

Layouts carry a leading lane axis B: X ``(n, m)`` (int8, int16,
float32 or float64) shared by all lanes, ``w (B, n, r)``, ``h (B, r,
m)``, factors float32 or float64, ``r <= 128``.  Nothing is padded:
the kernels mask the ragged edges themselves.
"""

from __future__ import annotations

import torch

from .build import TCODE, XCODE, launch, tickets
from .vb_kernels import DEFAULT_BM, DEFAULT_BN, pad_matrix  # noqa: F401

# cells an M1 block owns and genes an M2 block owns: csrc/ml.cu's
# kMlHChunk and kMlWChunk.  Constants, never derived from the lane
# count, so a lane's bits do not depend on its batch (resume, lane
# compaction).
H_CHUNK = 64
W_CHUNK = 64
MAX_R = 128

# launches per kernel since the last reset (bumped only where a kernel
# is launched)
LAUNCHES = {"ml_hpass": 0, "ml_wpass": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x, w, h):
    """Validate what the kernels (and the plain versions) take."""
    if w.dtype not in TCODE:
        raise TypeError(f"factors must be float32 or float64, got "
                        f"{w.dtype}")
    if h.dtype != w.dtype:
        raise TypeError("w and h must share one dtype")
    if x.dtype not in XCODE:
        raise TypeError(f"X must be int8, int16, float32 or float64, "
                        f"got {x.dtype}")
    if x.dim() != 2 or w.dim() != 3 or h.dim() != 3:
        raise ValueError("X must be (n, m), w (B, n, r) and h (B, r, m)")
    n, m = x.shape
    nb, _, r = w.shape
    if w.shape != (nb, n, r) or h.shape != (nb, r, m):
        raise ValueError(f"shape mismatch: X {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, h {tuple(h.shape)}")
    if not 0 < r <= MAX_R:
        raise ValueError(f"rank {r} must be in [1, {MAX_R}]")
    devs = {t.device for t in (x, w, h)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    for name, t in (("x", x), ("w", w), ("h", h)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------

def ml_h_plain(x, w, h):
    """M1's function: (hn (B, r, m), sum x*log(wh) (B,) float64)."""
    xf = x.to(w.dtype)
    wh = w @ h
    hn = w.transpose(-1, -2) @ (xf / wh)
    return hn, (xf * torch.log(wh)).sum((-2, -1), dtype=torch.float64)


def ml_w_plain(x, w, h):
    """M2's function: wn (B, n, r)."""
    return (x.to(w.dtype) / (w @ h)) @ h.transpose(-1, -2)


# ---------------------------------------------------------------------
# CUDA wrappers (one per kernel)
# ---------------------------------------------------------------------

def xlog_part_width(m):
    """M1's x*log(wh) partials a lane: one a block, ``ceil(m /
    H_CHUNK)``, whatever the lane count."""
    return -(-m // H_CHUNK)


def ml_hpass(x, w, h):
    """Launch M1.  Returns (hn (B, r, m), xlog (B,) float64, the
    per-block partials xlog_part (B, ceil(m / H_CHUNK)) float64 that
    xlog adds in block order)."""
    nb, n, r = w.shape
    m = x.shape[1]
    hn = torch.empty(nb, r, m, dtype=w.dtype, device=w.device)
    part = torch.empty(nb, xlog_part_width(m), dtype=torch.float64,
                       device=w.device)
    xlog = torch.empty(nb, dtype=torch.float64, device=w.device)
    launch("ml_hpass", TCODE[w.dtype], XCODE[x.dtype], x, w, h, nb, n, m, r,
           hn, part, tickets(nb, w.device), xlog)
    LAUNCHES["ml_hpass"] += 1
    return hn, xlog, part


def ml_wpass(x, w, h):
    """Launch M2: wn (B, n, r)."""
    nb, n, r = w.shape
    m = x.shape[1]
    wn = torch.empty_like(w)
    launch("ml_wpass", TCODE[w.dtype], XCODE[x.dtype], x, w, h, nb, n, m, r,
           wn)
    LAUNCHES["ml_wpass"] += 1
    return wn


def ml_h(x, w, h):
    """H phase: (hn (B, r, m), sum x*log(wh) (B,) float64) — M1 on
    CUDA tensors, :func:`ml_h_plain` on CPU tensors."""
    _check(x, w, h)
    if x.device.type == "cpu":
        return ml_h_plain(x, w, h)
    return ml_hpass(x, w, h)[:2]


def ml_w(x, w, h):
    """W phase: wn (B, n, r) — M2 on CUDA tensors, :func:`ml_w_plain`
    on CPU tensors."""
    _check(x, w, h)
    if x.device.type == "cpu":
        return ml_w_plain(x, w, h)
    return ml_wpass(x, w, h)


def _true_x(x, w, h):
    """X cut to the factors' ``(n, m)`` where it was zero-padded past
    them (:func:`pad_matrix`)."""
    n, m = w.shape[-2], h.shape[-1]
    if tuple(x.shape) == (n, m):
        return x
    if x.dim() != 2 or x.shape[0] < n or x.shape[1] < m:
        raise ValueError(f"shape mismatch: X {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, h {tuple(h.shape)}")
    return x[:n, :m].contiguous()


def ml_h_pallas(x, w, h, bn: int = DEFAULT_BN, bm: int = DEFAULT_BM):
    """The JAX package's name for :func:`ml_h`: ``(hn, xlogwh)``.  X may
    be zero-padded past the factors' ``(n, m)``; ``bn``/``bm`` (the JAX
    tiles) are accepted and not used."""
    return ml_h(_true_x(x, w, h), w, h)


def ml_w_pallas(x, w, h, bn: int = DEFAULT_BN, bm: int = DEFAULT_BM):
    """The JAX package's name for :func:`ml_w`: ``wn``; X and
    ``bn``/``bm`` as :func:`ml_h_pallas` takes them."""
    return ml_w(_true_x(x, w, h), w, h)


def make_ml_backend(bn: int = DEFAULT_BN, bm: int = DEFAULT_BM):
    """(fused_h, fused_w) pair for ``ops.ml.ml_run(fused_h=...,
    fused_w=...)``: the CUDA phases on the card, their plain versions
    on the CPU.  ``bn``/``bm`` (the JAX tiles) are accepted and not
    used: X is taken at the factors' shape."""
    return ml_h, ml_w
