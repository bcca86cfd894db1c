#!/usr/bin/env python3
"""Every kernel wrapper on each card against the same call on cuda:0.

Each wrapper of the port's kernels (K1-K4, K1s, K3s, E1 in both
layouts, E1s, E2, E3, P1, P2, M1, M2, S1 and S2) is called at a small
shape with its tensors on one card, the current device left at
cuda:0; every output must equal the same call's on cuda:0 bit for bit.
The launch path (``ccfindr_tpu_torch.ops.kernels.build.launch``)
enters the card that holds the tensors and takes that card's stream,
so a wrapper runs where its tensors are.  The inputs are drawn on the
host from a seed and copied to each card; each wrapper reads the
outputs of the one before it on the same card (K1 -> K2 -> K3 -> K4,
E1 'gm' -> E2 -> E3, P1 -> P2, S1 -> S2), as a sweep does.

``chip_smoke.py``'s multi-card phase and the card tests of
``tests/test_torch_kernels.py`` call :func:`compare`.  Run alone
(``python3 tools/check_cards.py``, on a machine with two cards or more)
it holds every card against cuda:0 and exits 1 on a mismatch.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N, M, R = 300, 768, 6          # genes, cells, rank (padded to 8)
LANES = (3, 4, 5, 6)           # each lane's live rank
WINDOW = (256, 512)            # K1s's and K3s's shard: whole K1 chunks


def inputs(seed=0):
    """The host inputs of :func:`calls`: X (int8 counts), the cell-major
    factors ``lwt (B, rp, n)``, ``lh``/``eh (B, rp, m)`` with the masked
    rank rows at fudge, the hypers ``sc (B, 8)``, float32."""
    rng = np.random.default_rng(seed)
    nb, rp = len(LANES), 8
    fudge = float(torch.finfo(torch.float32).eps)
    x = np.minimum(rng.poisson(1.5, (N, M)), 127)
    x[:, 700:] = 0                          # a ragged live cell extent
    lwt = np.zeros((nb, rp, N))
    lh = np.zeros((nb, rp, M))
    for b, rk in enumerate(LANES):
        lwt[b, :rk] = rng.gamma(1.0, 1.0, (rk, N))
        lh[b, :rk] = rng.gamma(1.0, 1.0, (rk, M))
        lwt[b, rk:R] = fudge
        lh[b, rk:R] = fudge
    sc = np.zeros((nb, 8))
    sc[:, :4] = rng.uniform(0.5, 1.5, (nb, 4))
    sc[:, 4] = fudge
    sc[:, 5] = LANES
    sc[:, 6] = float(torch.lgamma(torch.as_tensor(x, dtype=torch.float64)
                                  + 1.0).sum())
    sc[:, 7] = 1.0
    f32 = torch.float32
    return dict(x=torch.as_tensor(x, dtype=torch.int8),
                lwt=torch.as_tensor(lwt, dtype=f32),
                lh=torch.as_tensor(lh, dtype=f32),
                eh=torch.as_tensor(lh * 0.9, dtype=f32),
                sc=torch.as_tensor(sc, dtype=torch.float64))


def calls(dev, inp):
    """Every wrapper on ``dev``, in order, on ``inp`` copied there: a
    dict of each kernel's outputs (a tuple of tensors on ``dev``)."""
    import scipy.sparse as sp

    from ccfindr_tpu_torch.ops import tile
    from ccfindr_tpu_torch.ops.kernels import epilogue as epi
    from ccfindr_tpu_torch.ops.kernels import ml as mlk
    from ccfindr_tpu_torch.ops.kernels import sol
    from ccfindr_tpu_torch.ops.kernels import sol_sharded as ssh
    from ccfindr_tpu_torch.ops.kernels import sparse as spk
    from ccfindr_tpu_torch.ops.kernels import vb_kernels as vbk

    t = {k: v.to(dev) for k, v in inp.items()}
    x, lwt, lh, eh, sc = t["x"], t["lwt"], t["lh"], t["eh"], t["sc"]
    m_live = 700
    out = {}
    k1 = out["K1"] = sol.xpass(x, lwt, lh, eh, sc)
    k2 = out["K2"] = sol.w_post(k1[0], lwt, k1[3], sc, R, N)
    k3 = out["K3"] = sol.h_post(k1[1], lh, k2[3], sc, R, m_live, M)
    fin = dict(n=N, m=m_live, dt=lwt.dtype, hyper_mask=(True,) * 4,
               newton_niter=100, newton_tol=1e-4)
    out["K4"] = (sol.finish(sc, k1[2], k2[3], k2[4], k3[3], k3[4], **fin),)
    c0, c1 = WINDOW
    lhc, ehc = (a[..., c0:c1].contiguous() for a in (lh, eh))
    k1s = out["K1s"] = ssh.xpass_shard(x[:, c0:c1], lwt, lhc, ehc, sc)
    out["K3s"] = ssh.h_post_shard(k1s[1], lhc, k2[3], sc, R,
                                  *ssh.shard_extents(m_live, M, c0, c1 - c0))
    lw = lwt.transpose(-1, -2).contiguous()
    for layout in ("gm", "cm"):
        out[f"E1 {layout}"] = vbk.fused_xpass(x, lw, lh, layout=layout)
    e1 = out["E1 gm"]
    e1s = out["E1s"] = vbk.fused_sum(e1[1], e1[2])
    ehs_part = eh.sum(-1, dtype=torch.float64)[:, None, :]
    e2 = out["E2"] = epi.epi_w_post(e1[0], lw, ehs_part, sc, R, N)
    out["E3"] = epi.epi_h_post(e1s[0], lh, e2[3], sc, R, m_live, M)
    out["P1"] = vbk.ss_xpass(x, lw, lh)
    out["P2"] = vbk.elbo_xpass(x, lw, vbk.xlogx(lw), lh, vbk.xlogx(lh))
    w, h = lw[..., :R].contiguous(), lh[:, :R].contiguous()
    out["M1"] = mlk.ml_hpass(x, w, h)
    out["M2"] = (mlk.ml_wpass(x, w, h),)
    csr = sp.csr_matrix(inp["x"].numpy().astype(np.int16))
    tc = tile.from_scipy_tile(csr, dtype=torch.float32, device=dev)
    s1 = out["S1"] = spk.sp_rowpass(tc, w, h.transpose(-1, -2).contiguous())
    out["S2"] = (spk.sp_colpass(tc, s1[1], w),)
    return out


def compare(dev, ref="cuda:0", seed=0):
    """Each wrapper's outputs on ``dev`` against ``ref``'s, with the
    current device held at cuda:0 throughout: ``{kernel: True where every
    output is the same bits}``.  Raises if a call moved the current
    device."""
    inp = inputs(seed)
    torch.cuda.set_device(0)
    want = {k: tuple(a.cpu() for a in v if a is not None)
            for k, v in calls(torch.device(ref), inp).items()}
    got = {k: tuple(a.cpu() for a in v if a is not None)
           for k, v in calls(torch.device(dev), inp).items()}
    if torch.cuda.current_device() != 0:
        raise RuntimeError("a wrapper left the current device at "
                           f"cuda:{torch.cuda.current_device()}")
    return {k: len(got[k]) == len(want[k]) and all(
        torch.equal(a, b) for a, b in zip(got[k], want[k])) for k in want}


def main():
    if torch.cuda.device_count() < 2:
        print("check_cards: needs two CUDA devices or more", file=sys.stderr)
        return 1
    bad = []
    for k in range(1, torch.cuda.device_count()):
        res = compare(f"cuda:{k}")
        bad += [f"cuda:{k} {name}" for name, same in res.items() if not same]
        print(f"cuda:{k} against cuda:0: "
              + ", ".join(f"{n} {'same' if s else 'DIFFERS'}"
                          for n, s in res.items()), flush=True)
    print(f"check_cards: {'FAIL ' + str(bad) if bad else 'PASS'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
