"""Checkpoint, resume and lane compaction in the port's drivers
(``checkpoint_dir``, ``checkpoint_every``, ``compact_every``), and
``ccfindr_tpu_torch.checkpoint`` against the JAX package's.

The twins of tests/test_drivers.py:192-235, 434-460 and
tests/test_ml.py:418-540, held stricter: the port has no jitted fast
path, so a chunked, resumed or compacted run must equal the
uninterrupted one bit for bit on every single-device route (dense,
dense_fused, 'pallas' on both of its routes, 'pallas2pass', sparse),
float64 on the CPU.  The card holds the same on 'pallas', sparse and
the ML scan (chip_smoke.py phase 16).
"""

import os

import numpy as np
import pytest
import torch

import ccfindr_tpu as cf
import ccfindr_tpu_torch as ct
from ccfindr_tpu_torch.drivers import ml_driver as md
from ccfindr_tpu_torch.drivers import vb_driver as vd

torch.set_num_threads(2)

VB_ROUTES = ["dense", "dense_fused", "pallas", "pallas_gm", "pallas2pass",
             "sparse"]


def _route(route, monkeypatch):
    """vb_factorize keywords of a route; 'pallas_gm' forces the
    gene-major loop of backend='pallas' as tests/test_torch_epilogue.py
    does."""
    if route == "pallas_gm":
        monkeypatch.setattr(vd, "_fused_layout", lambda *a, **k: "gm")
        return dict(backend="pallas")
    return dict(backend=route)


def _same_vb(a, b):
    np.testing.assert_array_equal(a.measure["lml"], b.measure["lml"])
    for col in ("aw", "bw", "ah", "bh"):
        np.testing.assert_array_equal(a.measure[col], b.measure[col])
    for k in range(len(a.ranks)):
        np.testing.assert_array_equal(a.basis[k], b.basis[k])
        np.testing.assert_array_equal(a.coeff[k], b.coeff[k])
        np.testing.assert_array_equal(a.dbasis[k], b.dbasis[k])


def _crashing(monkeypatch, module, name, after):
    """Make the chunk driver ``module.name`` raise KeyboardInterrupt at
    its lane batch's chunk ``after + 1``, as a crash would."""
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


# ---------------------------------------------------------------------
# save_checkpoint / load_checkpoint
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def factorized():
    x = cf.simulate_whx(nrow=20, ncol=30, rank=3, seed=2)["x"]
    return ct.vb_factorize(x, ranks=[2, 3], nrun=2, Itmax=60, verbose=0,
                           device="cpu", seed=1)


def _same_set(a, b):
    assert list(a.ranks) == list(b.ranks)
    for f in ("basis", "dbasis", "coeff", "dcoeff"):
        for u, v in zip(getattr(a, f), getattr(b, f)):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(a.measure.values, b.measure.values)
    assert list(a.measure.columns) == list(b.measure.columns)


def test_checkpoint_round_trip(factorized, tmp_path):
    path = ct.save_checkpoint(factorized, str(tmp_path / "ck" / "run"))
    assert os.path.exists(path + ".npz") and os.path.exists(path + ".json")
    back = ct.load_checkpoint(factorized, path)
    _same_set(factorized, back)
    assert back.metadata["timings"][0]["name"] == "vb_rank_batch"
    assert back.counts.shape == factorized.counts.shape


def test_checkpoint_unserialisable_metadata_warns(factorized, tmp_path):
    s = factorized[np.arange(factorized.n_genes),
                   np.arange(factorized.n_cells)]
    s.ranks, s.basis, s.dbasis = factorized.ranks, factorized.basis, \
        factorized.dbasis
    s.coeff, s.dcoeff, s.measure = factorized.coeff, factorized.dcoeff, \
        factorized.measure
    s.metadata["opaque"] = object()
    with pytest.warns(UserWarning, match="opaque"):
        ct.save_checkpoint(s, str(tmp_path / "w"))
    back = ct.load_checkpoint(factorized, str(tmp_path / "w"))
    assert "opaque" not in back.metadata and "timings" in back.metadata


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_files_cross_packages(factorized, tmp_path, writer):
    """The files either package writes load in the other, with equal
    arrays and measure table."""
    jset = cf.SCSet(count=factorized.counts, row_data=factorized.row_data,
                    col_data=factorized.col_data, remove_zeros=False)
    for f in ("ranks", "basis", "dbasis", "coeff", "dcoeff", "measure"):
        setattr(jset, f, getattr(factorized, f))
    path = str(tmp_path / "x")
    if writer == "port":
        ct.save_checkpoint(factorized, path)
        back = cf.load_checkpoint(jset, path)
    else:
        cf.save_checkpoint(jset, path)
        back = ct.load_checkpoint(factorized, path)
    _same_set(factorized, back)


# ---------------------------------------------------------------------
# vb_factorize: checkpoint_every, compact_every, per-rank checkpoints
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def vb_small():
    return cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=31)["x"]


@pytest.mark.parametrize("route", VB_ROUTES)
def test_checkpoint_every_matches_uninterrupted(vb_small, tmp_path, route,
                                                monkeypatch):
    """Chunked execution, and a crash after the first chunk resumed from
    its file, equal one uninterrupted run bit for bit."""
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=400, seed=4,
              device="cpu", **_route(route, monkeypatch))
    a = ct.vb_factorize(vb_small, **kw)
    b = ct.vb_factorize(vb_small, checkpoint_dir=str(tmp_path / "ck1"),
                        checkpoint_every=30, **kw)
    _same_vb(a, b)
    assert (a.metadata["timings"][0]["n_iter"]
            == b.metadata["timings"][0]["n_iter"])
    assert os.listdir(tmp_path / "ck1") == []      # removed at the end

    orig = _crashing(monkeypatch, vd, "_chunked_vb", 1)
    with pytest.raises(KeyboardInterrupt):
        ct.vb_factorize(vb_small, checkpoint_dir=str(tmp_path / "ck2"),
                        checkpoint_every=30, **kw)
    monkeypatch.setattr(vd, "_chunked_vb", orig)
    assert os.listdir(tmp_path / "ck2") == ["vb_sweeps_batch.npz"]
    c = ct.vb_factorize(vb_small, checkpoint_dir=str(tmp_path / "ck2"),
                        checkpoint_every=30, **kw)
    _same_vb(a, c)


@pytest.mark.parametrize("route", VB_ROUTES)
def test_compact_every_matches_unchunked(route, monkeypatch):
    """Converged-lane compaction runs the live lanes only and equals the
    unchunked run bit for bit; its lane-sweeps are fewer."""
    x = cf.simulate_whx(nrow=40, ncol=80, rank=4, seed=2)["x"]
    kw = dict(ranks=[2, 3, 4, 5, 6], nrun=3, verbose=0, Itmax=800, seed=4,
              device="cpu", **_route(route, monkeypatch))
    a = ct.vb_factorize(x, **kw)
    b = ct.vb_factorize(x, compact_every=50, **kw)
    _same_vb(a, b)
    ra, rb = a.metadata["timings"][0], b.metadata["timings"][0]
    assert ra["n_iter"] == rb["n_iter"]
    assert rb["lane_sweeps_executed"] < ra["lane_sweeps_executed"]


def test_chunk_lanes_runs_a_lone_lane_twice():
    n_rec = np.array([5, -1, 7, -1, -1])
    lanes, nreal = vd.chunk_lanes(n_rec, 5)
    assert lanes.tolist() == [1, 3, 4] and nreal == 3
    lanes, nreal = vd.chunk_lanes(np.array([5, 6, -1]), 3)
    assert lanes.tolist() == [2, 2] and nreal == 1
    lanes, nreal = vd.chunk_lanes(np.array([-1]), 1)
    assert lanes.tolist() == [0] and nreal == 1
    assert vd.chunk_lanes(np.array([1, 2]), 2)[1] == 0


def test_gene_major_chunk_is_pinned_to_the_full_batch(vb_small,
                                                      monkeypatch):
    """The compacted chunks of the gene-major loop get the chunk E1
    would take for the whole batch."""
    monkeypatch.setattr(vd, "_fused_layout", lambda *a, **k: "gm")
    seen = []
    real = vd.epi_ops.vb_run_epi

    def spy(*a, **k):
        seen.append((a[1].lw.shape[0], k["chunk"]))
        return real(*a, **k)

    monkeypatch.setattr(vd.epi_ops, "vb_run_epi", spy)
    ct.vb_factorize(vb_small, ranks=[2, 3], nrun=3, verbose=0, Itmax=300,
                    seed=2, device="cpu", backend="pallas", compact_every=20)
    assert len({c for _, c in seen}) == 1
    assert seen[0][0] == 6 and min(b for b, _ in seen) < 6


@pytest.mark.parametrize("init", ["random", "svd2"])
def test_per_rank_checkpoints_restore(vb_small, tmp_path, init,
                                      monkeypatch):
    """checkpoint_dir alone takes the sequential scan ('auto' batching is
    off) and saves each finished rank; after a crash in the second rank
    a rerun restores the first and ends where the uninterrupted run
    does (the random stream is drawn whether or not a rank restores)."""
    kw = dict(ranks=[2, 3, 4], nrun=2, verbose=0, Itmax=300, seed=6,
              device="cpu", initializer=init)
    a = ct.vb_factorize(vb_small, batch_ranks=False, **kw)
    ck = str(tmp_path / "ranks")
    b = ct.vb_factorize(vb_small, checkpoint_dir=ck, **kw)
    assert [r["name"] for r in b.metadata["timings"]] == ["vb_rank"] * 3
    assert sorted(os.listdir(ck)) == ["vb_rank2.npz", "vb_rank3.npz",
                                      "vb_rank4.npz"]
    _same_vb(a, b)

    ck2 = str(tmp_path / "crash")
    real = vd._save_rank_ckpt

    def save_then_crash(ckpt_dir, rank, *args):
        real(ckpt_dir, rank, *args)
        if rank == 3:
            raise KeyboardInterrupt

    monkeypatch.setattr(vd, "_save_rank_ckpt", save_then_crash)
    with pytest.raises(KeyboardInterrupt):
        ct.vb_factorize(vb_small, checkpoint_dir=ck2, **kw)
    monkeypatch.setattr(vd, "_save_rank_ckpt", real)
    c = ct.vb_factorize(vb_small, checkpoint_dir=ck2, **kw)
    assert [r["name"] for r in c.metadata["timings"]] == ["vb_rank"]
    _same_vb(a, c)


def test_jax_rank_checkpoints_restore_in_the_port(vb_small, tmp_path):
    """The same file names and keys: a checkpoint directory the JAX
    driver wrote restores every rank in the port."""
    kw = dict(ranks=[2, 3], verbose=0, Itmax=200, initializer="svd2")
    ck = str(tmp_path / "jax")
    a = cf.vb_factorize(cf.SCSet(count=vb_small), checkpoint_dir=ck, **kw)
    b = ct.vb_factorize(ct.SCSet(count=vb_small), checkpoint_dir=ck,
                        device="cpu", **kw)
    assert b.metadata["timings"] == []          # nothing ran
    _same_vb(a, b)


def test_checkpoint_every_on_the_sequential_scan(vb_small, tmp_path):
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=300, seed=8,
              device="cpu", batch_ranks=False, backend="pallas")
    a = ct.vb_factorize(vb_small, **kw)
    b = ct.vb_factorize(vb_small, checkpoint_dir=str(tmp_path),
                        checkpoint_every=25, **kw)
    _same_vb(a, b)
    assert sorted(os.listdir(tmp_path)) == ["vb_rank2.npz", "vb_rank3.npz"]


# ---------------------------------------------------------------------
# factorize: the ML twins
# ---------------------------------------------------------------------

def _same_ml(a, b):
    np.testing.assert_array_equal(a.measure.values, b.measure.values)
    for k in range(len(a.ranks)):
        np.testing.assert_array_equal(a.basis[k], b.basis[k])
        np.testing.assert_array_equal(a.coeff[k], b.coeff[k])


@pytest.mark.parametrize("backend", ["dense", "dense_fused", "pallas",
                                     "sparse"])
def test_ml_checkpoint_every_matches_uninterrupted(tmp_path, backend,
                                                   monkeypatch):
    x = cf.simulate_whx(nrow=25, ncol=40, rank=3, seed=31)["x"]
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=400, seed=4,
              device="cpu", backend=backend)
    a = ct.factorize(x, **kw)
    b = ct.factorize(x, checkpoint_dir=str(tmp_path / "ck1"),
                     checkpoint_every=30, **kw)
    _same_ml(a, b)
    orig = _crashing(monkeypatch, md, "_chunked_ml", 1)
    with pytest.raises(KeyboardInterrupt):
        ct.factorize(x, checkpoint_dir=str(tmp_path / "ck2"),
                     checkpoint_every=30, **kw)
    monkeypatch.setattr(md, "_chunked_ml", orig)
    assert any("ml_sweeps" in f for f in os.listdir(tmp_path / "ck2"))
    c = ct.factorize(x, checkpoint_dir=str(tmp_path / "ck2"),
                     checkpoint_every=30, **kw)
    _same_ml(a, c)
    assert os.listdir(tmp_path / "ck2") == []


@pytest.mark.parametrize("batch_ranks", [True, False])
def test_ml_checkpoint_connectivity_criterion(tmp_path, batch_ranks):
    """The connectivity criterion's resume carry (assignments and
    streaks) survives chunking bit for bit."""
    x = cf.simulate_whx(nrow=20, ncol=30, rank=3, seed=7)["x"]
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=200, seed=5,
              criterion="connectivity", ncnn_step=10, device="cpu",
              batch_ranks=batch_ranks)
    a = ct.factorize(x, **kw)
    b = ct.factorize(x, checkpoint_dir=str(tmp_path), checkpoint_every=13,
                     **kw)
    _same_ml(a, b)


def test_ml_sample_progress_restore(tmp_path, monkeypatch):
    """checkpoint_dir keeps finished samples of a randomized scan; a
    rerun after a crash restores them and matches exactly."""
    x = cf.simulate_whx(nrow=20, ncol=30, rank=2, seed=8)["x"]
    kw = dict(ranks=[2, 3], nrun=2, verbose=0, Itmax=100, seed=9,
              randomize=True, nsmpl=2, device="cpu")
    a = ct.factorize(x, **kw)
    ck = str(tmp_path / "prog")
    b = ct.factorize(x, checkpoint_dir=ck, **kw)
    _same_ml(a, b)
    assert os.listdir(ck) == []

    calls = {"n": 0}
    real = np.savez

    def crash_after_first(file, **kwargs):
        real(file, **kwargs)
        if "ml_progress" in str(file):
            calls["n"] += 1
            if calls["n"] == 1:
                raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez", crash_after_first)
    with pytest.raises(KeyboardInterrupt):
        ct.factorize(x, checkpoint_dir=ck, **kw)
    monkeypatch.setattr(np, "savez", real)
    assert os.listdir(ck) == ["ml_progress_p0.npz"]
    c = ct.factorize(x, checkpoint_dir=ck, **kw)
    np.testing.assert_array_equal(a.measure["likelihood"],
                                  c.measure["likelihood"])
    np.testing.assert_array_equal(a.measure["r_se"], c.measure["r_se"])
    _same_ml(a, c)


@pytest.mark.parametrize("backend", ["dense", "pallas", "sparse"])
def test_ml_compact_every_bit_exact(backend):
    x = cf.simulate_whx(nrow=30, ncol=50, rank=3, seed=2)["x"]
    kw = dict(ranks=[2, 3, 4], nrun=3, verbose=0, Itmax=400, seed=4,
              device="cpu", backend=backend)
    a = ct.factorize(x, **kw)
    b = ct.factorize(x, compact_every=40, **kw)
    _same_ml(a, b)
