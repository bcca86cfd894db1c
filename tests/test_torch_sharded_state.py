"""The mesh's H family carried as cell shards (``parallel/hshards.py``),
as the JAX driver's ``_place_sharded`` lays it out, on the CPU.

The port's shards all lie on ``"cpu"`` (a mesh of repeated devices, as
tests/test_torch_mesh_backends.py builds it); a shard on another device
is made on ``"meta"``.  X is 64 genes x 4,000 cells zero-padded to 4,096,
so that each of the cells=4 shards spans 1,024 cells: every sum over
cells taken from the shards' partials is then the joined sum, bit for
bit.  Tolerances: the sharded loops against the joined ones exactly;
against the JAX package's mesh run at float64 (a ragged last shard),
those of tests/test_torch_mesh.py::test_vb_factorize_mesh_matches_jax
(equal sweeps, lml 1e-9, factors 1e-7).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ccfindr_tpu_torch as ct
from ccfindr_tpu_torch.drivers import ml_driver as md
from ccfindr_tpu_torch.drivers import vb_driver as vd
from ccfindr_tpu_torch.ops import ell as tek
from ccfindr_tpu_torch.ops import ml as tml
from ccfindr_tpu_torch.ops import sparse as tsk
from ccfindr_tpu_torch.ops import tile as ttile
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.parallel import hshards
from ccfindr_tpu_torch.parallel import sharded as tsh
from ccfindr_tpu_torch.parallel.hshards import HShards

torch.set_num_threads(2)

F64 = torch.float64
N, M, M_PAD, CELLS = 64, 4000, 4096, 4
RANKS = (2, 3, 3)


def _cpu_mesh(cells, runs=1, genes=1):
    return ct.make_mesh(runs=runs, cells=cells, genes=genes,
                        devices=["cpu"] * (runs * cells * genes))


def _counts(n=N, m=M, seed=0):
    rng = np.random.default_rng(seed)
    wf = rng.gamma(0.6, 1.0, (n, 3))
    hf = rng.gamma(0.6, 1.0, (3, m))
    mu = wf @ hf * (1.5 * n * m / (wf @ hf).sum())
    x = np.minimum(rng.poisson(mu), 60) * (rng.random((n, m)) < 0.3)
    x[:, 0] += 1
    x[0, :] += 1
    return x.astype(np.float64)


@pytest.fixture(scope="module")
def counts():
    return _counts()


@pytest.fixture(scope="module")
def counts_whole():
    """X without padding: the drivers' scans over cells=4 then take
    shards of 1,024 cells."""
    return _counts(m=M_PAD, seed=1)


def _padded(x):
    return np.pad(x, ((0, 0), (0, M_PAD - x.shape[1])))


def _layout(route, x, mesh):
    """X laid out for ``route`` over ``mesh`` and the loop keywords that
    run it, as the VB driver picks them."""
    csr = sp.csr_matrix(x)
    if route in ("tile", "tile_every4"):
        return (ttile.from_scipy_tile_sharded(csr, CELLS, m_pad=M_PAD,
                                              dtype=F64, device="cpu"),
                dict(fused=tsh.make_tile_fused_sharded(mesh),
                     elbo_every=4 if route == "tile_every4" else 1))
    if route == "coo":
        return (tsk.from_scipy_sharded(csr, CELLS, m_pad=M_PAD, dtype=F64,
                                       chunk=256, device="cpu"),
                dict(fused=tsh.make_sparse_fused_sharded(mesh, chunk=256)))
    if route == "ell":
        return (tek.from_scipy_ell_sharded(csr, CELLS, m_pad=M_PAD,
                                           dtype=F64, quantile=0.5, lane=8,
                                           device="cpu"),
                dict(fused=tsh.make_ell_fused_sharded(mesh)))
    xs = tsh.place_counts(torch.tensor(_padded(x)), mesh)[0]
    if route == "dense_fused":
        return xs, dict(fused=tsh.fused_sharded)
    if route == "dense":
        return xs, dict(suffstats=tsh.suffstats_sharded,
                        data_term=tsh.data_term_sharded)
    if route == "pallas2pass":
        ss, dt = tsh.make_pass2_sharded(mesh)
        return xs, dict(suffstats=ss, data_term=dt)
    assert route == "pallas_genes"
    return xs, dict(fused=tsh.make_fused_sharded(mesh, bn=8, bm=128))


def _start(seed=3, nb=len(RANKS), r=max(RANKS)):
    """A joined lane-batched start at the padded width, the masks and
    the hypers."""
    rng = np.random.default_rng(seed)
    w = torch.tensor(rng.gamma(1.0, 1.0, (nb, N, r)))
    h = torch.tensor(rng.gamma(1.0, 1.0, (nb, r, M_PAD)))
    st = tvb.VBState(ew=w, eh=h, lw=w.clone(), lh=h.clone(),
                     dw=torch.zeros_like(w), dh=torch.zeros_like(h),
                     lkh=torch.full((nb,), -np.inf, dtype=F64))
    rank_mask = torch.tensor((np.arange(r)[None] < np.asarray(RANKS)[:, None])
                             .astype(np.float64))
    kw = dict(rank_mask=rank_mask, r_true=torch.tensor(RANKS, dtype=F64),
              cell_mask=torch.tensor((np.arange(M_PAD) < M).astype(
                  np.float64)), m_true=M)
    hy = tvb.Hyper(*(torch.ones(nb, dtype=F64),) * 4)
    return st, hy, kw


def _sharded(st, kw, x):
    """The start and the cell mask laid out as ``x``'s cell shards."""
    st = st._replace(**{f: hshards.shard_h(getattr(st, f), x)
                        for f in ("eh", "lh", "dh")})
    return st, dict(kw, cell_mask=hshards.shard_h(kw["cell_mask"], x))


def _same_state(got, want):
    for f in tvb.VBState._fields:
        g = hshards.to_numpy(getattr(got.state, f))
        np.testing.assert_array_equal(g, hshards.to_numpy(
            getattr(want.state, f)), err_msg=f)
    for f in ("lml", "n_iter", "done", "hyper_failed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    for a, b in zip(got.hyper, want.hyper):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


VB_ROUTES = ["tile", "tile_every4", "coo", "ell", "dense_fused", "dense",
             "pallas2pass", "pallas_genes"]


def _mesh_of(route):
    return _cpu_mesh(2, genes=2) if route == "pallas_genes" \
        else _cpu_mesh(CELLS)


# ---------------------------------------------------------------------
# (a) the loops fed shards give the joined loops' bits
# ---------------------------------------------------------------------

@pytest.mark.parametrize("route", VB_ROUTES)
def test_vb_run_on_shards_is_the_joined_run(counts, route):
    """vb_run (two-pass) and _vb_run_fused over a mesh route, fed the H
    family as cell shards, equal the same loop fed the joined state, bit
    for bit once gathered; the H family comes back as shards, each on
    its layout shard's device."""
    mesh = _mesh_of(route)
    x, run_kw = _layout(route, counts, mesh)
    st, hy, kw = _start()
    loop = dict(itmax=30, tol=1e-7, **run_kw)
    want = tvb.vb_run(x, st, hy, **loop, **kw)
    sst, skw = _sharded(st, kw, x)
    got = tvb.vb_run(x, sst, hy, **loop, **skw)
    for f in ("eh", "lh", "dh"):
        t = getattr(got.state, f)
        assert isinstance(t, HShards)
        hshards.check(t, x)
    assert int(got.n_iter.max()) > 10
    _same_state(got, want)


@pytest.mark.parametrize("backend", ["sparse", "pallas"])
@pytest.mark.parametrize("criterion", ["likelihood", "connectivity"])
def test_ml_run_on_shards_is_the_joined_run(counts, backend, criterion):
    """ml_run's deferred loop over the mesh passes (S1/S2 a shard, M1/M2
    a block), fed h as cell shards, equals it fed the joined h, bit for
    bit; h and the cluster ids come back as shards."""
    mesh = _cpu_mesh(CELLS)
    if backend == "sparse":
        x = ttile.from_scipy_tile_sharded(sp.csr_matrix(counts), CELLS,
                                          m_pad=M_PAD, dtype=F64,
                                          device="cpu")
        fh, fw = tsh.make_tile_ml_sharded(mesh)
    else:
        x = tsh.place_counts(torch.tensor(_padded(counts)), mesh)[0]
        fh, fw = tsh.make_ml_sharded(mesh)
    rng = np.random.default_rng(5)
    w0 = torch.tensor(rng.random((3, N, 3)))
    h0 = torch.tensor(rng.random((3, 3, M_PAD)))
    kw = dict(itmax=40, tol=1e-9, criterion=criterion, ncnn_step=5,
              fused_h=fh, fused_w=fw, nm_true=(N, M),
              rank_mask=torch.tensor([[1.0, 1, 0], [1, 1, 1], [1, 1, 1]],
                                     dtype=F64))
    want = tml.ml_run(x, w0, h0, **kw)
    got = tml.ml_run(x, w0, hshards.shard_h(h0, x), **kw)
    assert isinstance(got.h, HShards) and isinstance(got.cid, HShards)
    hshards.check(got.h, x)
    for f in tml.MLRunResult._fields:
        np.testing.assert_array_equal(
            tml.ml_state_to_numpy(getattr(got, f)),
            tml.ml_state_to_numpy(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------------------
# (b) no H tensor is joined inside a loop
# ---------------------------------------------------------------------

class _Joins:
    """Counts the calls to ``torch.cat`` and ``Tensor.to`` that give a
    tensor whose last axis spans the whole padded cell axis."""

    def __init__(self, monkeypatch, width=M_PAD):
        self.joins = []
        cat, to = torch.cat, torch.Tensor.to

        def counted_cat(tensors, *a, **k):
            out = cat(tensors, *a, **k)
            if out.dim() >= 2 and out.shape[-1] == width:
                self.joins.append(("cat", tuple(out.shape)))
            return out

        def counted_to(t, *a, **k):
            if t.dim() >= 2 and t.shape[-1] == width:
                self.joins.append(("to", tuple(t.shape)))
            return to(t, *a, **k)

        monkeypatch.setattr(torch, "cat", counted_cat)
        monkeypatch.setattr(torch.Tensor, "to", counted_to)


@pytest.mark.parametrize("route", VB_ROUTES)
def test_no_h_tensor_is_joined_in_the_vb_loop(counts, route, monkeypatch):
    """Inside vb_run on shards no (B, r, m_pad) tensor is joined or
    moved whole; the joined loop, as a check of the counter, joins
    ``shn`` on every sweep of the sparse and dense-fused routes."""
    mesh = _mesh_of(route)
    x, run_kw = _layout(route, counts, mesh)
    st, hy, kw = _start()
    sst, skw = _sharded(st, kw, x)
    joins = _Joins(monkeypatch)
    tvb.vb_run(x, sst, hy, itmax=6, tol=0.0, **run_kw, **skw)
    assert joins.joins == []
    if route in ("tile", "dense_fused"):
        tvb.vb_run(x, st, hy, itmax=6, tol=0.0, **run_kw, **kw)
        assert len(joins.joins) >= 6


@pytest.mark.parametrize("backend", ["sparse", "pallas"])
def test_no_h_tensor_is_joined_in_the_ml_loop(counts, backend,
                                             monkeypatch):
    mesh = _cpu_mesh(CELLS)
    if backend == "sparse":
        x = ttile.from_scipy_tile_sharded(sp.csr_matrix(counts), CELLS,
                                          m_pad=M_PAD, dtype=F64,
                                          device="cpu")
        fh, fw = tsh.make_tile_ml_sharded(mesh)
    else:
        x = tsh.place_counts(torch.tensor(_padded(counts)), mesh)[0]
        fh, fw = tsh.make_ml_sharded(mesh)
    rng = np.random.default_rng(5)
    w0 = torch.tensor(rng.random((3, N, 3)))
    h0 = hshards.shard_h(torch.tensor(rng.random((3, 3, M_PAD))), x)
    joins = _Joins(monkeypatch)
    tml.ml_run(x, w0, h0, itmax=6, tol=0.0, fused_h=fh, fused_w=fw,
               nm_true=(N, M))
    assert joins.joins == []


@pytest.mark.parametrize("mode", ["vb", "ml"])
def test_no_h_tensor_is_joined_by_the_drivers(counts_whole, mode,
                                             monkeypatch):
    """The drivers' sparse mesh scans lay the starts out lane by lane and
    join the H family only on the host, at the end (compaction included):
    no torch.cat or Tensor.to ever holds a whole (lanes, r, m_pad) H."""
    joins = _Joins(monkeypatch)
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=12, seed=4,
              backend="sparse", device="cpu", mesh=_cpu_mesh(CELLS),
              compact_every=5)
    x = sp.csr_matrix(counts_whole)
    if mode == "vb":
        ct.vb_factorize(x, **kw)
    else:
        ct.factorize(x, cophenetic_max_cells=500, cophenetic_nsub=1, **kw)
    assert [j for j in joins.joins if len(j[1]) == 3] == []


# ---------------------------------------------------------------------
# (c) checkpoint/resume and lane compaction on a sharded mesh
# ---------------------------------------------------------------------

def _crash_after(monkeypatch, module, name, after):
    """``module.name`` (a chunk driver) raising KeyboardInterrupt at its
    chunk ``after + 1``, as a crash would."""
    orig = getattr(module, name)
    calls = {"n": 0}

    def boom(call, *args, **kwargs):
        def wrapped(*a, **k):
            calls["n"] += 1
            if calls["n"] > after:
                raise KeyboardInterrupt
            return call(*a, **k)
        return orig(wrapped, *args, **kwargs)

    monkeypatch.setattr(module, name, boom)
    return orig


def _same_scan(a, b, col):
    np.testing.assert_array_equal(a.measure[col], b.measure[col])
    for u, v in zip(a.basis + a.coeff, b.basis + b.coeff):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("backend", ["sparse", "dense_fused"])
def test_vb_compaction_and_resume_on_shards(counts_whole, backend,
                                            tmp_path, monkeypatch):
    """compact_every, and checkpoint_every with a crash after the first
    chunk resumed from its file, equal the uninterrupted sharded scan,
    bit for bit, over cells=4 and over runs=2 x cells=2."""
    x = counts_whole if backend != "sparse" \
        else sp.csr_matrix(counts_whole)
    for mesh in (_cpu_mesh(CELLS), _cpu_mesh(2, runs=2)):
        kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=60, seed=4,
                  backend=backend, device="cpu", mesh=mesh)
        a = ct.vb_factorize(x, **kw)
        _same_scan(a, ct.vb_factorize(x, compact_every=7, **kw), "lml")
        ck = str(tmp_path / f"ck{mesh.shape['runs']}")
        orig = _crash_after(monkeypatch, vd, "_chunked_vb", 1)
        with pytest.raises(KeyboardInterrupt):
            ct.vb_factorize(x, checkpoint_dir=ck, checkpoint_every=9, **kw)
        monkeypatch.setattr(vd, "_chunked_vb", orig)
        _same_scan(a, ct.vb_factorize(x, checkpoint_dir=ck,
                                      checkpoint_every=9, **kw), "lml")


@pytest.mark.parametrize("criterion", ["likelihood", "connectivity"])
def test_ml_compaction_and_resume_on_shards(counts_whole, criterion,
                                            tmp_path, monkeypatch):
    x = sp.csr_matrix(counts_whole)
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=50, seed=4,
              backend="sparse", device="cpu", mesh=_cpu_mesh(CELLS),
              criterion=criterion, ncnn_step=6, cophenetic_max_cells=500,
              cophenetic_nsub=1)
    a = ct.factorize(x, **kw)
    _same_scan(a, ct.factorize(x, compact_every=7, **kw), "likelihood")
    orig = _crash_after(monkeypatch, md, "_chunked_ml", 1)
    with pytest.raises(KeyboardInterrupt):
        ct.factorize(x, checkpoint_dir=str(tmp_path), checkpoint_every=9,
                     **kw)
    monkeypatch.setattr(md, "_chunked_ml", orig)
    _same_scan(a, ct.factorize(x, checkpoint_dir=str(tmp_path),
                               checkpoint_every=9, **kw), "likelihood")


def test_driver_scan_on_shards_is_the_joined_scan(counts_whole,
                                                  monkeypatch):
    """The sparse mesh scan with its starts laid out as shards equals the
    same scan with the start joined (the driver's placement patched to
    stack), bit for bit."""
    x = sp.csr_matrix(counts_whole)
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=40, seed=4,
              backend="sparse", device="cpu", mesh=_cpu_mesh(CELLS))
    a = ct.vb_factorize(x, **kw)
    monkeypatch.setattr(vd, "_place_sharded",
                        lambda lanes, nb, x, dev: vd._stack(list(lanes)))
    _same_scan(a, ct.vb_factorize(x, **kw), "lml")


# ---------------------------------------------------------------------
# (d) a shard on the wrong device raises
# ---------------------------------------------------------------------

def test_a_shard_on_another_device_raises(counts):
    mesh = _cpu_mesh(CELLS)
    x, run_kw = _layout("tile", counts, mesh)
    st, hy, kw = _start()
    sst, skw = _sharded(st, kw, x)
    lh = HShards(list(sst.lh[:3]) + [sst.lh[3].to("meta")])
    with pytest.raises(ValueError, match="shard 3 lies on meta"):
        run_kw["fused"](x, sst.lw, lh)
    xs = tsh.place_counts(torch.tensor(_padded(counts)), mesh)[0]
    with pytest.raises(ValueError, match="shard 3 lies on meta"):
        tsh.fused_sharded(xs, sst.lw, lh)
    with pytest.raises(ValueError, match="meet shards"):
        hshards.hmap(torch.mul, sst.lh, lh)
    with pytest.raises(ValueError, match="spans"):
        hshards.check(HShards(list(sst.lh[:3]) + [sst.lh[3][..., :8]]), x)
    with pytest.raises(ValueError, match="layout has"):
        hshards.check(HShards(sst.lh[:2]), x)


# ---------------------------------------------------------------------
# the sums over cells
# ---------------------------------------------------------------------

@pytest.mark.parametrize("widths,ndims", [
    ((1024,) * 4, (1, 2)), ((2048, 1024, 1024), (1, 2)), ((3000,), (1, 2)),
    ((40,), (1, 2)), ((1024, 1024, 1000), (1,))])
def test_hsum_is_lane_sum_on_whole_blocks(widths, ndims):
    """Each shard's level-2 partials, finished on the reduce device, are
    ``lane_sum``'s bits where every shard spans a multiple of 1,024
    cells, and a lone shard's own sum; the sums over cells alone also
    where the last shard is ragged."""
    from ccfindr_tpu_torch.utils import lane_sum

    t = torch.rand(3, 5, sum(widths), dtype=torch.float32,
                   generator=torch.Generator().manual_seed(1))
    cut = np.cumsum((0,) + widths)
    h = HShards(t[..., a:b].contiguous() for a, b in zip(cut, cut[1:]))
    for nd in ndims:
        assert torch.equal(hshards.hsum(h, nd, "cpu"), lane_sum(t, nd))
    assert torch.equal(hshards.gather(h, "cpu"), t)


# ---------------------------------------------------------------------
# (e) a ragged last shard against the JAX package's mesh
# ---------------------------------------------------------------------

@pytest.mark.parametrize("route", ["dense_fused", "tile"])
def test_ragged_shards_match_jax_mesh(route):
    """41 cells on cells=4 (shards of 11, the last with 3 padded cells):
    the port's loop on shards against JAX's vb_run over its mesh (the 8
    virtual CPU devices), H laid out by JAX's _place_sharded specs, from
    the same start, at float64."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import ccfindr_tpu as cf
    from ccfindr_tpu.ops import tile as jtile
    from ccfindr_tpu.ops import vb as jvb
    from ccfindr_tpu.parallel import sharded as jsh

    n, m, cells, r = 16, 41, 4, 3
    m_pad = 44
    x = _counts(n, m, seed=8)
    rng = np.random.default_rng(9)
    w = rng.gamma(1.0, 1.0, (n, r))
    h = np.pad(rng.gamma(1.0, 1.0, (r, m)), ((0, 0), (0, m_pad - m)),
               constant_values=1.0)
    mask = (np.arange(m_pad) < m).astype(np.float64)
    jmesh = cf.make_mesh(cells=cells, devices=jax.devices()[:cells])

    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(jmesh, spec))

    jst = jvb.VBState(ew=put(w, P()), eh=put(h, P(None, "cells")),
                      lw=put(w, P()), lh=put(h, P(None, "cells")),
                      dw=put(np.zeros_like(w), P()),
                      dh=put(np.zeros_like(h), P(None, "cells")),
                      lkh=jnp.asarray(-np.inf))
    jhy = jvb.Hyper(*(jnp.asarray(1.0),) * 4)
    tmesh = _cpu_mesh(cells)
    csr = sp.csr_matrix(x)
    if route == "tile":
        jx = jax.tree.map(lambda a: put(a, P("cells")),
                          jtile.from_scipy_tile_sharded(
                              csr, cells, m_pad=m_pad, dtype=jnp.float64))
        jfused = jsh.make_tile_fused_sharded(jmesh)
        tx = ttile.from_scipy_tile_sharded(csr, cells, m_pad=m_pad,
                                           dtype=F64, device="cpu")
        tfused = tsh.make_tile_fused_sharded(tmesh)
    else:
        jx = put(np.pad(x, ((0, 0), (0, m_pad - m))), P(None, "cells"))
        jfused = jvb.fused_dense
        tx = tsh.place_counts(torch.tensor(np.pad(x, ((0, 0),
                                                      (0, m_pad - m)))),
                              tmesh)[0]
        tfused = tsh.fused_sharded
    loop = dict(itmax=200, tol=1e-7)
    jo = jvb.vb_run(jx, jst, jhy, fused=jfused, cell_mask=put(mask, P()),
                    m_true=m, **loop)
    t = torch.tensor
    st = tvb.VBState(ew=t(w)[None], eh=t(h)[None], lw=t(w)[None],
                     lh=t(h)[None], dw=torch.zeros(1, n, r, dtype=F64),
                     dh=torch.zeros(1, r, m_pad, dtype=F64),
                     lkh=torch.full((1,), -np.inf, dtype=F64))
    st, kw = _sharded(st, dict(cell_mask=t(mask)), tx)
    assert [p.shape[-1] for p in st.eh] == [11] * 4
    to = tvb.vb_run(tx, st, tvb.Hyper(*(torch.ones(1, dtype=F64),) * 4),
                    fused=tfused, m_true=m, **kw, **loop)
    assert int(to.n_iter[0]) == int(jo.n_iter)
    np.testing.assert_allclose(float(to.lml[0]), float(jo.lml), rtol=1e-9)
    for f in ("ew", "eh"):
        np.testing.assert_allclose(
            hshards.to_numpy(getattr(to.state, f))[0],
            np.asarray(getattr(jo.state, f)), rtol=1e-7, atol=1e-300,
            err_msg=f)
