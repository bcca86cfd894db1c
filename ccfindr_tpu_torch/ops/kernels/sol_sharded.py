"""The VB sweep over the cell shards of a mesh, as hand-written CUDA.

Counterpart of ``ccfindr_tpu/ops/pallas/sol_sharded.py``.  The JAX
package runs three Pallas kernels per shard under ``shard_map``, with
``psum``s between them: the X pass ``_xpass_kernel`` (:80), the W then H
posterior ``_epi_kernel`` (:149) and the ELBO and hyper Newton
``_fin_kernel`` (:220).  Here one process drives the shards of one runs
row of a mesh (``parallel.mesh``), and the sweep reuses the cell-major
kernels of :mod:`.sol` (``csrc/sol.cu``):

1. **K1s** (:func:`xpass_shard`): K1 on each shard's block of X (a
   window of a larger X is read in place, with its row stride), with
   the shard's ``lh``/``eh``;
2. the gather: the shards' ``swn``, ``ehs`` and ``x log wth`` partials
   are copied to the reduce device (the row's first), each into its
   place, joined in shard order;
3. **K2** once on the reduce device, on the gathered partials.  JAX
   computes the W posterior on every shard, since W is replicated
   there; here the next sweep takes ``lwt`` to each shard device where
   K1s reads it, and the shards need nothing else of W but ``csum``, so
   one launch and two copies do what ``k`` launches would;
4. **K3s** (:func:`h_post_shard`): K3 on each shard's ``shn`` partials
   and ``lh``, with the shard-relative live and pinned extents of JAX's
   ``ax_live``/``ax_true``;
5. the gather of the shards' ``rsum`` and H-scalar partials, then **K4**
   on the reduce device, fed what it reads on one device.

One code path serves equal and distinct devices: ``.to`` of a tensor to
its own device is the tensor itself.  Each kernel runs on the card that
holds its shard (``build.launch``), and the shards' launches are issued
back to back, with no host sync between them, so that distinct cards
run their K1s and K3s at once.  A copy between cards runs on its
source's stream, ordered after the work queued there (PyTorch's
``copy_``): so the lanes and ``csum`` are copied to every shard before
any kernel is queued behind them on the reduce device.

Every cross-shard sum is the shards' partials in shard order, added by
the next kernel in its fixed order, as every cross-block sum of the port
is; with shard extents that are multiples of K1's cell chunk
(``sol.CHUNK[1]``, 256) and of K3's ``sol.POST_COLS`` (32), both of
which divide 512, the gathered partials are the single-device launch's,
element for element, so the sweep gives the single-device bits: shards
of a multiple of 512 cells always do.  With one shard it always does.

The plain PyTorch version of each step (``xpass_shard_plain``,
:func:`h_post_shard_plain`, and :func:`shard_sum` feeding
``sol.finish_plain``), together :func:`sharded_sweep_plain`, serves CPU
tensors, the kernels (:func:`sharded_sweep_kernels`) CUDA tensors, with
no path between the two: a mesh holds devices of one type.  With one shard the plain sweep equals
``sol.sol_sweep_plain`` bit for bit.
"""

from __future__ import annotations

import functools
import operator

import torch

from . import sol
from ...parallel.sharded import ShardedCounts

# launches per kernel since the last reset (bumped only where a kernel
# is launched); K2 and K4 count in sol.LAUNCHES
LAUNCHES = {"xpass_shard": 0, "h_post_shard": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def shard_extents(m_live, m_arr, base, mp_loc):
    """JAX's ``ax_live``/``ax_true`` (sol_sharded.py:449-454): the live
    and the pinned cell extents of the shard whose columns start at
    ``base``, relative to it."""
    def clip(v):
        return min(max(v - base, 0), mp_loc)
    return clip(m_live), clip(m_arr)


def shard_sum(parts):
    """The shards' partials added in shard order (one shard: itself)."""
    return functools.reduce(operator.add, parts)


def gather(parts, dim, dev):
    """The shards' partials taken to ``dev`` and joined in shard order
    along ``dim``.  Partials of other cards are copied each into its
    place, so that no copy of them is held beside the joined ones."""
    dev = torch.device(dev)
    if all(p.device == dev for p in parts):
        return torch.cat(parts, dim)
    shape = list(parts[0].shape)
    shape[dim] = sum(p.shape[dim] for p in parts)
    out = torch.empty(shape, dtype=parts[0].dtype, device=dev)
    at = 0
    for p in parts:
        out.narrow(dim, at, p.shape[dim]).copy_(p)
        at += p.shape[dim]
    return out


def spread(t, devs):
    """``t`` on each of ``devs`` (itself where it lies there), every copy
    queued before the caller launches anything behind it."""
    return [t.to(d) for d in devs]


# ---------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------

# ``_xpass_kernel``'s function on one shard's block (np, mp_loc) is K1's:
# (swnt partial (B, rp, np), local shn (B, rp, mp_loc), xlog partial (B,)
# f64, ehs partial (B, rp) f64)
xpass_shard_plain = sol.xpass_plain


def h_post_shard_plain(shn, lh, csum, sc, r, ax_live, ax_true):
    """The H half of ``_epi_kernel`` on one shard: the H posterior on
    the local ``shn`` with the reduced ``csum`` (B, rp) f64, cells past
    ``ax_live`` pinned up to ``ax_true``: (eh, lh, dh, rsum partial,
    H-scalar partials (B, 4) f64)."""
    dt = lh.dtype
    ah, bh, fudge, r_live = (sc[:, q].to(dt) for q in (2, 3, 4, 5))
    return sol.post_plain(shn, lh, csum, ah, bh, fudge, r_live, r, ax_live,
                          npin=ax_true)


def _check(x, lwt, lh, eh, sc, nc):
    if not isinstance(x, ShardedCounts) or len(x.rows) != 1 \
            or len(x.cols) != nc:
        raise TypeError(f"X must be laid out on {nc} cell shards "
                        "(parallel.sharded.ShardedCounts)")
    if len(lh) != nc or len(eh) != nc:
        raise ValueError(f"lh and eh must be {nc} cell shards")
    if lwt.shape[-1] != x.shape[0] or sc.dtype != torch.float64:
        raise ValueError("lwt must be (B, rp, np) and sc float64")
    # the sweep takes the kernels or the plain versions by lwt's device
    # type: a shard of another type would get the wrong one
    if any(b.device.type != lwt.device.type for b in x.blocks[0]):
        raise ValueError("X's cell shards and lwt must lie on devices of "
                         "one type")


def _extents(x, m, m_live):
    return [shard_extents(m_live, m, c0, c1 - c0) for c0, c1 in x.cols]


def sharded_sweep_plain(x, lwt, lh, eh, sc, *, n, m_arr, m_live, r,
                        bn=sol.DEFAULT_BN, bm=sol.DEFAULT_BM,
                        hyper_mask=(True,) * 4, newton_niter=100,
                        newton_tol=1e-4, mxu_bf16=False):
    """The sweep of :func:`make_sol_sweep_sharded` in plain PyTorch, on
    tensors of any device: the function K1s, K2, K3s and K4 compute
    (``sol.sol_sweep``'s keywords; ``bn``/``bm`` unused)."""
    _check(x, lwt, lh, eh, sc, len(x.cols))
    ext = _extents(x, m_arr, m_live)
    dev, dt = lwt.device, lwt.dtype
    aw, bw, fudge, r_live = (sc[:, q].to(dt) for q in (0, 1, 4, 5))
    devs = [b.device for b in x.blocks[0]]
    xs = [xpass_shard_plain(xb, lwt.to(d), lhk, ehk, sc.to(d), mxu_bf16)
          for xb, d, lhk, ehk in zip(x.blocks[0], devs, lh, eh)]
    swnt, xlog, ehs = (shard_sum([p[q].to(dev) for p in xs])
                       for q in (0, 2, 3))
    ewt, lwtn, dwt, csum, wscal = sol.post_plain(swnt, lwt, ehs, aw, bw,
                                                 fudge, r_live, r, n)
    hs = [h_post_shard_plain(p[1], lhk, csum.to(d), sc.to(d), r, *e)
          for p, lhk, d, e in zip(xs, lh, devs, ext)]
    rsum, hscal = (shard_sum([h[q].to(dev) for h in hs]) for q in (3, 4))
    scal = sol.finish_plain(sc, xlog, csum, wscal, rsum, hscal, n, m_live,
                            dt, tuple(bool(v) for v in hyper_mask),
                            newton_niter, newton_tol)
    return (ewt, lwtn, dwt) + tuple(tuple(h[q] for h in hs)
                                    for q in range(3)) + (scal,)


# ---------------------------------------------------------------------
# CUDA wrappers (one per kernel launched on a shard)
# ---------------------------------------------------------------------

def xpass_shard(x, lwt, lh, eh, sc, mxu_bf16=False):
    """Launch K1s on one shard's window ``x`` of X (read in place) on
    its device: the partials of ``sol.launch_xpass``."""
    out = sol.launch_xpass(x, lwt, lh, eh, sc, mxu_bf16)
    LAUNCHES["xpass_shard"] += 1
    return out


def h_post_shard(shn_part, lh, csum_part, sc, r, ax_live, ax_true):
    """Launch K3s on one shard's ``shn`` partials and ``lh`` with its
    shard-relative extents: (eh, lh, dh, rsum_part, hscal_part)."""
    out = sol.launch_h_post(shn_part, lh, csum_part, sc, r, ax_live,
                            ax_true)
    LAUNCHES["h_post_shard"] += 1
    return out


def sharded_sweep_kernels(x, lwt, lh, eh, sc, *, n, m_arr, m_live, r,
                          bn=sol.DEFAULT_BN, bm=sol.DEFAULT_BM,
                          hyper_mask=(True,) * 4, newton_niter=100,
                          newton_tol=1e-4, mxu_bf16=False):
    """The sweep of :func:`make_sol_sweep_sharded` as K1s, K2, K3s and
    K4 on CUDA tensors: ``k``, 1, ``k`` and 1 launches."""
    _check(x, lwt, lh, eh, sc, len(x.cols))
    ext = _extents(x, m_arr, m_live)
    dev, dt = lwt.device, lwt.dtype
    nb = lwt.shape[0]
    devs = [b.device for b in x.blocks[0]]
    scs = spread(sc, devs)
    xs = [xpass_shard(xb, lwk, lhk, ehk, sck, mxu_bf16)
          for xb, lwk, lhk, ehk, sck in zip(x.blocks[0], spread(lwt, devs),
                                            lh, eh, scs)]
    swn_part = gather([p[0] for p in xs], 1, dev)
    # K1's x log(wth) partials run over (gene chunk, cell chunk): the
    # shards' cell chunks join inside each gene chunk
    ngc = xs[0][1].shape[1]
    xlog_part = gather([p[2].view(nb, ngc, -1) for p in xs], 2,
                       dev).view(nb, -1)
    ehs_part = gather([p[3] for p in xs], 1, dev)
    shn_parts = [p[1] for p in xs]
    del xs          # the shards' swn partials: K2 reads the gathered ones
    ewt, lwtn, dwt, csum_part, wscal_part = sol.w_post(
        swn_part, lwt, ehs_part, sc, r, n)
    del swn_part
    hs = [h_post_shard(shn, lhk, csk, sck, r, *e)
          for shn, lhk, csk, sck, e in zip(shn_parts, lh,
                                           spread(csum_part, devs), scs,
                                           ext)]
    del shn_parts
    rsum_part = gather([h[3] for h in hs], 1, dev)
    hscal_part = gather([h[4] for h in hs], 1, dev)
    scal = sol.finish(sc, xlog_part, csum_part, wscal_part, rsum_part,
                      hscal_part, n=n, m=m_live, dt=dt,
                      hyper_mask=hyper_mask, newton_niter=newton_niter,
                      newton_tol=newton_tol)
    return (ewt, lwtn, dwt) + tuple(tuple(h[q] for h in hs)
                                    for q in range(3)) + (scal,)


def make_sol_sweep_sharded(mesh):
    """A ``sol.sol_sweep``-signature sweep over the cell shards of one
    runs row of ``mesh`` (see the module docstring), for
    ``sol.vb_run_sol(sweep_fn=...)``.

    It takes X laid out on the row (``parallel.sharded.ShardedCounts``,
    one gene shard), ``lwt``/``sc`` on the reduce device, and ``lh``/
    ``eh`` as their cell shards (a tuple, each on its shard's device, as
    ``deferred_loop`` carries them); it returns ``sol_sweep``'s outputs
    with ``eh``/``lh``/``dh`` as shards and the rest on the reduce
    device."""
    nc = mesh.shape["cells"]
    if mesh.shape["genes"] != 1:
        raise NotImplementedError(
            "the cell-major sweep runs over cell shards only (as the JAX "
            "package's); a gene-sharded mesh runs the fused X pass of "
            "parallel.sharded.make_fused_sharded")

    def sweep(x, lwt, lh, eh, sc, **kw):
        _check(x, lwt, lh, eh, sc, nc)
        run = (sharded_sweep_plain if lwt.device.type == "cpu"
               else sharded_sweep_kernels)
        return run(x, lwt, lh, eh, sc, **kw)

    return sweep
