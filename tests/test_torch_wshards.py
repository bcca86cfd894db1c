"""The mesh's W family carried as gene shards (``parallel/hshards.py``
with axis -2), as the JAX driver's ``_place_sharded`` lays it out
(``P(runs, genes, None)``), on the CPU.

The port's shards all lie on ``"cpu"`` (a mesh of repeated devices); a
shard on another device is made on ``"meta"``.  X is 2,048 genes x 128
cells over ``genes=2``, so that each gene shard spans 1,024 genes: every
sum over genes taken from the shards' partials is then the joined sum,
bit for bit.  Tolerances: the sharded loops and scans against the
joined ones exactly; against the JAX package's mesh runs at float64
(ragged gene shards), those of
tests/test_torch_sharded_state.py::test_ragged_shards_match_jax_mesh
(equal sweeps, lml 1e-9, factors 1e-7).
"""

import numpy as np
import pytest
import torch

import ccfindr_tpu_torch as ct
from ccfindr_tpu_torch.drivers import vb_driver as vd
from ccfindr_tpu_torch.ops import vb as tvb
from ccfindr_tpu_torch.parallel import hshards
from ccfindr_tpu_torch.parallel import sharded as tsh
from ccfindr_tpu_torch.parallel.hshards import HShards
from ccfindr_tpu_torch.utils import lane_colsum, lane_sum

torch.set_num_threads(2)

F64 = torch.float64
N, M, GENES = 2048, 128, 2
RANKS = (2, 3, 3)
W_FIELDS = ("ew", "lw", "dw")


def _cpu_mesh(genes=GENES, cells=1, runs=1):
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


ROUTES = ["pallas", "dense", "dense_fused", "pallas2pass"]


def _route(route, mesh):
    """The loop keywords of a ``genes > 1`` route, as the VB driver picks
    them."""
    if route == "pallas":
        return dict(fused=tsh.make_fused_sharded(mesh, bn=8, bm=128))
    if route == "dense_fused":
        return dict(fused=tsh.fused_sharded)
    if route == "dense":
        return dict(suffstats=tsh.suffstats_sharded,
                    data_term=tsh.data_term_sharded)
    ss, dt = tsh.make_pass2_sharded(mesh)
    return dict(suffstats=ss, data_term=dt)


def _start(seed=3, nb=len(RANKS), r=max(RANKS)):
    """A joined lane-batched start, the masks (the last 5 genes padded)
    and the hypers."""
    rng = np.random.default_rng(seed)
    w = torch.tensor(rng.gamma(1.0, 1.0, (nb, N, r)))
    h = torch.tensor(rng.gamma(1.0, 1.0, (nb, r, M)))
    st = tvb.VBState(ew=w, eh=h, lw=w.clone(), lh=h.clone(),
                     dw=torch.zeros_like(w), dh=torch.zeros_like(h),
                     lkh=torch.full((nb,), -np.inf, dtype=F64))
    rank_mask = torch.tensor((np.arange(r)[None] < np.asarray(RANKS)[:, None])
                             .astype(np.float64))
    kw = dict(rank_mask=rank_mask, r_true=torch.tensor(RANKS, dtype=F64),
              gene_mask=torch.tensor((np.arange(N) < N - 5).astype(
                  np.float64)), n_true=N - 5)
    hy = tvb.Hyper(*(torch.ones(nb, dtype=F64),) * 4)
    return st, hy, kw


def _sharded(st, kw, x):
    """The start laid out as ``x``'s shards (W by genes, H by cells) and
    the gene mask's column as gene shards."""
    st = st._replace(**{f: hshards.shard_w(getattr(st, f), x)
                        for f in W_FIELDS},
                     **{f: hshards.shard_h(getattr(st, f), x)
                        for f in ("eh", "lh", "dh")})
    return st, dict(kw, gene_mask=hshards.shard_w(kw["gene_mask"][:, None],
                                                  x))


def _same_state(got, want):
    for f in tvb.VBState._fields:
        np.testing.assert_array_equal(
            hshards.to_numpy(getattr(got.state, f)),
            hshards.to_numpy(getattr(want.state, f)), err_msg=f)
    for f in ("lml", "n_iter", "done", "hyper_failed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    for a, b in zip(got.hyper, want.hyper):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------
# (a) the loops fed gene shards give the joined loops' bits
# ---------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_vb_run_on_gene_shards_is_the_joined_run(counts, route):
    """vb_run over a genes=2 route, fed the W family as gene shards (and
    H as its cell shard), equals the same loop fed the joined state, bit
    for bit once gathered, 6 sweeps at Tol 0; W comes back as gene
    shards, each on its gene row's first device."""
    mesh = _cpu_mesh()
    x = tsh.place_counts(torch.tensor(counts), mesh)[0]
    st, hy, kw = _start()
    loop = dict(itmax=6, tol=0.0, **_route(route, mesh))
    want = tvb.vb_run(x, st, hy, **loop, **kw)
    sst, skw = _sharded(st, kw, x)
    got = tvb.vb_run(x, sst, hy, **loop, **skw)
    for f in W_FIELDS:
        t = getattr(got.state, f)
        assert isinstance(t, HShards) and t.axis == hshards.GENES
        hshards.check(t, x)
        assert [p.shape[-2] for p in t] == [1024, 1024]
    assert int(got.n_iter.max()) == 6
    _same_state(got, want)


# ---------------------------------------------------------------------
# (b) no W tensor is joined inside a loop or by the drivers
# ---------------------------------------------------------------------

class _WJoins:
    """Counts the calls to ``torch.cat`` and ``Tensor.to`` that give a
    tensor (..., n_pad, r): a W-family tensor whole."""

    def __init__(self, monkeypatch, n=N, rs=(3,)):
        self.joins = []
        cat, to = torch.cat, torch.Tensor.to

        def whole(t):
            return t.dim() >= 2 and t.shape[-2] == n and t.shape[-1] in rs

        def counted_cat(tensors, *a, **k):
            out = cat(tensors, *a, **k)
            if whole(out):
                self.joins.append(("cat", tuple(out.shape)))
            return out

        def counted_to(t, *a, **k):
            if whole(t):
                self.joins.append(("to", tuple(t.shape)))
            return to(t, *a, **k)

        monkeypatch.setattr(torch, "cat", counted_cat)
        monkeypatch.setattr(torch.Tensor, "to", counted_to)


@pytest.mark.parametrize("route", ROUTES)
def test_no_w_tensor_is_joined_in_the_vb_loop(counts, route, monkeypatch):
    """Inside vb_run on gene shards no (B, n_pad, r) tensor is joined or
    moved whole; the joined loop, as a check of the counter, joins
    ``swn`` on every sweep."""
    mesh = _cpu_mesh()
    x = tsh.place_counts(torch.tensor(counts), mesh)[0]
    run_kw = _route(route, mesh)
    st, hy, kw = _start()
    sst, skw = _sharded(st, kw, x)
    joins = _WJoins(monkeypatch)
    tvb.vb_run(x, sst, hy, itmax=6, tol=0.0, **run_kw, **skw)
    assert joins.joins == []
    tvb.vb_run(x, st, hy, itmax=6, tol=0.0, **run_kw, **kw)
    assert len(joins.joins) >= 6


@pytest.mark.parametrize("backend", ROUTES)
def test_no_w_tensor_is_joined_by_the_drivers(counts, backend,
                                             monkeypatch):
    """The drivers' genes=2 scans lay the starts out lane by lane and
    join the W family only on the host, at the end (compaction
    included): no torch.cat or Tensor.to ever holds a whole (lanes, n_pad,
    r) W, and the loop is handed the W family as gene shards."""
    seen = []
    orig = tvb.vb_run

    def spy(x, st, *a, **k):
        seen.append(isinstance(st.lw, HShards)
                    and isinstance(k.get("gene_mask"), HShards))
        return orig(x, st, *a, **k)

    monkeypatch.setattr(vd.vb_ops, "vb_run", spy)
    joins = _WJoins(monkeypatch, n=N - 2)      # 2,045 genes padded to 2,046
    ct.vb_factorize(counts[:N - 3], ranks=[2, 3], nrun=2, verbose=0,
                    Itmax=12, seed=4, backend=backend, device="cpu",
                    mesh=_cpu_mesh(), compact_every=5)
    assert [j for j in joins.joins if len(j[1]) == 3] == []
    assert seen and all(seen)


# ---------------------------------------------------------------------
# (c) the drivers' scans, compaction and resume on gene shards
# ---------------------------------------------------------------------

def _crash_after(monkeypatch, after):
    """``_chunked_vb`` raising KeyboardInterrupt at its chunk
    ``after + 1``, as a crash would."""
    orig = vd._chunked_vb
    calls = {"n": 0}

    def boom(call, *args, **kwargs):
        def wrapped(*a, **k):
            calls["n"] += 1
            if calls["n"] > after:
                raise KeyboardInterrupt
            return call(*a, **k)
        return orig(wrapped, *args, **kwargs)

    monkeypatch.setattr(vd, "_chunked_vb", boom)
    return orig


def _same_scan(a, b):
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    assert a.metadata["timings"][0]["n_iter"] == \
        b.metadata["timings"][0]["n_iter"]
    for u, v in zip(a.basis + a.coeff + a.dbasis,
                    b.basis + b.coeff + b.dbasis):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_vb_compaction_and_resume_on_gene_shards(counts, backend, tmp_path,
                                                 monkeypatch):
    """compact_every, and checkpoint_every with a crash after the first
    chunk resumed from its file, equal the uninterrupted gene-sharded
    scan, bit for bit, over genes=2 and over runs=2 x genes=2; the two
    meshes give the same bits."""
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=60, seed=4,
              backend=backend, device="cpu")
    first = None
    for mesh in (_cpu_mesh(), _cpu_mesh(runs=2)):
        a = ct.vb_factorize(counts, mesh=mesh, **kw)
        if first is None:
            first = a
        _same_scan(first, a)
        _same_scan(a, ct.vb_factorize(counts, mesh=mesh, compact_every=7,
                                      **kw))
        ck = str(tmp_path / f"ck{mesh.shape['runs']}")
        orig = _crash_after(monkeypatch, 1)
        with pytest.raises(KeyboardInterrupt):
            ct.vb_factorize(counts, mesh=mesh, checkpoint_dir=ck,
                            checkpoint_every=9, **kw)
        monkeypatch.setattr(vd, "_chunked_vb", orig)
        _same_scan(a, ct.vb_factorize(counts, mesh=mesh, checkpoint_dir=ck,
                                      checkpoint_every=9, **kw))


@pytest.mark.parametrize("backend", ["dense_fused", "pallas2pass"])
def test_driver_scan_on_gene_shards_is_the_joined_scan(counts, backend,
                                                       monkeypatch):
    """The genes=2 scan with its starts laid out as gene shards equals the
    same scan with the W family joined (the driver's placement patched to
    lay out H alone, as before the W family was sharded), bit for
    bit."""
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=40, seed=4,
              backend=backend, device="cpu", mesh=_cpu_mesh(cells=2))
    a = ct.vb_factorize(counts, **kw)
    monkeypatch.setattr(vd.hshards, "gene_sharded", lambda x: False)
    _same_scan(a, ct.vb_factorize(counts, **kw))


# ---------------------------------------------------------------------
# (d) ragged gene shards against the JAX package's meshes
# ---------------------------------------------------------------------

def _jax_draws(n, m, rank, nb, seed):
    """The JAX driver's random starts (its key stream), lane by lane, as
    port states."""
    import jax
    import jax.numpy as jnp

    from ccfindr_tpu.ops import vb as jvb

    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    h1 = jvb.Hyper(aw=1.0, bw=1.0, ah=1.0, bh=1.0)
    return [tvb.VBState(*(torch.tensor(np.asarray(f)) for f in
                          jvb.vb_init_random(k, n, m, rank, h1,
                                             jnp.float64)))
            for k in jax.random.split(sub, nb)]


@pytest.mark.parametrize("case", ["pallas_g2c4", "dense_fused_r2g2c2"])
def test_ragged_gene_shards_match_jax_mesh(case, monkeypatch):
    """The JAX package's gene-sharded mesh cases
    (tests/test_sharding.py::test_vb_factorize_gene_sharded_matches_single,
    27 genes over genes=2 x cells=4 on 'pallas';
    test_vb_factorize_gene_and_cell_sharded_dense, runs=2 x genes=2 x
    cells=2 on 'dense_fused'), the port's W family as ragged gene shards
    (14 + 13 real genes; 10 + 10), from JAX's random starts, at
    float64."""
    import jax

    import ccfindr_tpu as cf

    if case == "pallas_g2c4":
        sim = cf.simulate_whx(nrow=27, ncol=36, rank=3, seed=21)
        kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=150, seed=4,
                  backend="pallas")
        shape, rank, nb = dict(runs=1, genes=2, cells=4), 3, 4
    else:
        sim = cf.simulate_whx(nrow=20, ncol=30, rank=2, seed=22)
        kw = dict(ranks=2, nrun=2, verbose=0, Itmax=60, Tol=0.0, seed=5,
                  hyper_update=(False,) * 4, backend="dense_fused")
        shape, rank, nb = dict(runs=2, genes=2, cells=2), 2, 2
    x = sim["x"]
    n, m = x.shape
    j = cf.vb_factorize(cf.SCSet(count=x), mesh=cf.make_mesh(
        devices=jax.devices()[:8], **shape), **kw)
    draws = iter(_jax_draws(n, m, rank, nb, kw["seed"]))
    monkeypatch.setattr(vd.vb_ops, "vb_init_random",
                        lambda *a, **k: next(draws))
    seen = []
    orig = tvb.vb_run

    def spy(x_, st, *a, **k):
        seen.append([p.shape[-2] for p in st.lw])
        return orig(x_, st, *a, **k)

    monkeypatch.setattr(vd.vb_ops, "vb_run", spy)
    t = ct.vb_factorize(ct.SCSet(count=x), device="cpu", mesh=ct.make_mesh(
        devices=["cpu"] * 8, **shape), **kw)
    assert seen and all(s == [seen[0][0]] * 2 for s in seen)
    assert t.ranks == j.ranks
    assert [r["total_sweeps"] for r in t.metadata["timings"]] == \
        [r["total_sweeps"] for r in j.metadata["timings"]]
    np.testing.assert_allclose(t.measure["lml"], j.measure["lml"],
                               rtol=1e-9)
    for k in range(len(t.ranks)):
        for f in ("basis", "coeff"):
            np.testing.assert_allclose(getattr(t, f)[k], getattr(j, f)[k],
                                       rtol=1e-7, atol=1e-300)


# ---------------------------------------------------------------------
# (e) the sums over genes
# ---------------------------------------------------------------------

@pytest.mark.parametrize("widths,r,exact", [
    ((1024, 1024), 3, "both"), ((1024,) * 3, 16, "both"),
    ((2048, 1024), 5, "both"), ((3000,), 4, "both"), ((40,), 2, "both"),
    ((2048, 1024, 1000), 5, "hsum"), ((1024, 7), 3, "hsum")])
def test_gene_sums_are_lane_sums_on_whole_blocks(widths, r, exact):
    """Each gene shard's level-2 partials, finished on the reduce device,
    are ``lane_sum(·, 2)``'s and ``lane_colsum``'s bits where every shard
    spans a multiple of 1,024 genes, and a lone shard's own sums; the sum
    over genes and ranks together also where the last shard is ragged
    (the column sums of a ragged X round otherwise: the joined X's
    transposed rows are padded, a copy, where the whole shards' are
    summed in place)."""
    t = torch.rand(3, sum(widths), r, dtype=torch.float32,
                   generator=torch.Generator().manual_seed(1))
    cut = np.cumsum((0,) + widths)
    w = HShards((t[:, a:b].contiguous() for a, b in zip(cut, cut[1:])),
                hshards.GENES)
    assert w.shape == t.shape
    assert torch.equal(hshards.hsum(w, 2, "cpu"), lane_sum(t, 2))
    col = hshards.colsum(w, "cpu")
    if exact == "both":
        assert torch.equal(col, lane_colsum(t))
    else:
        torch.testing.assert_close(col, lane_colsum(t), rtol=1e-6, atol=0)
    assert torch.equal(hshards.gather(w, "cpu"), t)
    np.testing.assert_array_equal(hshards.to_numpy(w), t.numpy())
    back = hshards.like(t.numpy(), w)
    assert back.axis == hshards.GENES
    assert [p.shape for p in back] == [p.shape for p in w]


# ---------------------------------------------------------------------
# (f) a W shard on the wrong device raises; the layout's devices
# ---------------------------------------------------------------------

def test_a_gene_shard_on_another_device_raises(counts):
    mesh = _cpu_mesh()
    x = tsh.place_counts(torch.tensor(counts), mesh)[0]
    st, hy, kw = _start()
    sst, _ = _sharded(st, kw, x)
    lw = HShards([sst.lw[0], sst.lw[1].to("meta")], hshards.GENES)
    with pytest.raises(ValueError, match="W shard 1 lies on meta"):
        tsh.fused_sharded(x, lw, sst.lh)
    with pytest.raises(ValueError, match="W shard 1 lies on meta"):
        tsh.make_fused_sharded(mesh, bn=8, bm=128)(x, lw, sst.lh)
    with pytest.raises(ValueError, match="W shard 1 lies on meta"):
        tsh.make_pass2_sharded(mesh)[1](x, lw, sst.lh)
    with pytest.raises(ValueError, match="gene shards meet cell shards"):
        hshards.hmap(torch.mul, sst.lh, sst.lw)
    with pytest.raises(ValueError, match="spans"):
        hshards.check(HShards([sst.lw[0], sst.lw[1][:, :8]],
                              hshards.GENES), x)
    with pytest.raises(ValueError, match="layout has"):
        hshards.check(HShards(sst.lw[:1], hshards.GENES), x)


def test_gene_shards_lie_on_their_gene_rows_first_device():
    """A gene shard lies on ``devices[g, 0]``, where a cell shard lies on
    ``devices[0, c]``: the driver's placement on a 2 x 2 grid whose
    off-diagonal blocks are on ``meta``."""
    x = tsh.ShardedCounts(torch.tensor(_counts(8, 6)),
                          [["cpu", "meta"], ["meta", "cpu"]])
    lanes = [tvb.vb_init_random(torch.Generator().manual_seed(k), 8, 6, 2,
                                tvb.Hyper(1.0, 1.0, 1.0, 1.0), F64, "cpu")
             for k in range(3)]
    st = vd._place_sharded(iter(lanes), 3, x, torch.device("cpu"))
    meta, cpu = torch.device("meta"), torch.device("cpu")
    for f in W_FIELDS:
        assert getattr(st, f).devices == [cpu, meta]
        assert getattr(st, f).shape == (3, 8, 2)
    for f in ("eh", "lh", "dh"):
        assert getattr(st, f).devices == [cpu, meta]
    assert st.lkh.device == cpu
    np.testing.assert_array_equal(st.lw[0].numpy(),
                                  torch.stack([s.lw[:4] for s in lanes]))
