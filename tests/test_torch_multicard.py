"""The port on several cards, checked on the CPU: the one launch path into
the kernel library, the mesh's copies issued before its launches, and
the multi-process worker on a card of its own.

The kernels cannot run here.  What can: the wrappers' source (every call
into the library goes through ``build.launch``, which takes the device
of the tensors), each wrapper's call with the library stubbed (the
arguments its C entry's signature takes, every tensor on one device),
and the order in which a sharded pass issues its copies and launches.
"""

import ast
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ccfindr_tpu_torch.ops.kernels import build
from ccfindr_tpu_torch.parallel import _mh_worker
from ccfindr_tpu_torch.parallel import sharded as tsh

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ccfindr_tpu_torch"
WRAPPERS = ("sol", "epilogue", "vb_kernels", "ml", "sparse", "sol_sharded")


def _tree(path):
    return ast.parse(path.read_text())


def _calls(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)]


def _name(func):
    """``a.b.c`` of a call's function, or its bare name."""
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
    return ".".join(reversed(parts))


@pytest.mark.parametrize("module", WRAPPERS)
def test_wrappers_reach_the_library_only_through_launch(module):
    """No wrapper module loads the library, takes a stream or enters a
    device itself: each C entry is called through ``build.launch``, by
    the name in ``build._SIGNATURES`` (``sol._post`` passes one of its
    two names on)."""
    tree = _tree(PKG / "ops" / "kernels" / f"{module}.py")
    names = [_name(c.func) for c in _calls(tree)]
    assert not [n for n in names if n.endswith("cuda.device")
                or n.split(".")[-1] in ("library", "stream",
                                        "current_stream", "_load")], names
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "build":
            assert {a.name for a in node.names} <= {
                "TCODE", "XCODE", "launch", "tickets"}
    launches = [c for c in _calls(tree) if _name(c.func) == "launch"]
    for c in launches:
        first = c.args[0]
        if isinstance(first, ast.Constant):
            assert first.value in build._SIGNATURES
        else:
            assert module == "sol" and isinstance(first, ast.Name)
    assert launches or module == "sol_sharded"


def test_build_takes_a_stream_only_with_its_device():
    """In ``build.py`` the library is called only by ``launch`` (and
    loaded by ``library``), and every current stream is asked of a
    device; in the whole package no CUDA call that would default to the
    current device is made without one."""
    tree = _tree(PKG / "ops" / "kernels" / "build.py")
    fns = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    users = {name for name, f in fns.items()
             if any(_name(c.func) == "library" for c in _calls(f))}
    assert users == {"launch"}
    for path in PKG.rglob("*.py"):
        for c in _calls(_tree(path)):
            n = _name(c.func)
            if n in ("torch.cuda.current_stream", "torch.cuda.synchronize",
                     "torch.cuda.default_stream"):
                assert c.args, f"{path.name}:{c.lineno} {n}() names no device"


def _check_cards():
    spec = importlib.util.spec_from_file_location(
        "check_cards", ROOT / "tools" / "check_cards.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stubbed_calls(monkeypatch):
    """Every wrapper of ``tools/check_cards.py`` called on CPU tensors
    with ``launch`` replaced by a recorder (and the ticket counters by
    zeros): ``[(entry, args)]`` in call order."""
    from ccfindr_tpu_torch.ops.kernels import (epilogue, ml, sol,
                                               sol_sharded, sparse,
                                               vb_kernels)

    seen = []

    def launch(entry, *args):
        seen.append((entry, args))

    for mod in (sol, epilogue, vb_kernels, ml, sparse):
        monkeypatch.setattr(mod, "launch", launch)
    for mod in (sol, epilogue, vb_kernels, ml, sparse, sol_sharded):
        # the stubbed launches count on copies, put back after the test
        monkeypatch.setattr(mod, "LAUNCHES", dict(mod.LAUNCHES))
    for mod in (vb_kernels, ml, sparse):
        monkeypatch.setattr(mod, "tickets", lambda nb, dev: torch.zeros(
            max(nb, 64), dtype=torch.int32, device=dev))
    cc = _check_cards()
    out = cc.calls(torch.device("cpu"), cc.inputs())
    return seen, out


ENTRIES = ("sol_xpass", "sol_w_post", "sol_h_post", "sol_finish",
           "fused_xpass", "fused_sum", "epi_w_post", "epi_h_post",
           "ss_xpass", "elbo_xpass", "ml_hpass", "ml_wpass", "sp_rowpass",
           "sp_colpass")


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_wrapper_passes_its_signature(monkeypatch, entry):
    """Each wrapper hands ``launch`` what its C entry takes, the stream
    aside (``launch`` adds it): as many arguments as the signature has
    less one, a tensor or None where it takes a pointer and a number
    elsewhere, every tensor on the one device of the inputs."""
    seen, out = _stubbed_calls(monkeypatch)
    assert len(out) == 17
    got = [a for e, a in seen if e == entry]
    assert got
    sig = build._SIGNATURES[entry]
    for args in got:
        assert len(args) == len(sig) - 1
        for a, t in zip(args, sig):
            if t is build._P:
                assert a is None or isinstance(a, torch.Tensor)
            else:
                assert isinstance(a, (int, float)) and not isinstance(
                    a, bool)
        assert {a.device for a in args
                if isinstance(a, torch.Tensor)} == {torch.device("cpu")}


def test_launch_enters_the_tensors_device_and_passes_its_stream(
        monkeypatch):
    """``launch`` enters the device of its tensors, asks that device for
    its current stream and passes it last; tensors go as their pointers
    and None as NULL.  (Standing in for a card: the device check, the
    guard and the stream are patched.)"""
    dev = torch.device("cuda", 3)
    entered, asked, called = [], [], []

    class Guard:
        def __init__(self, d):
            entered.append(d)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def current_stream(d):
        asked.append(d)
        return types.SimpleNamespace(cuda_stream=1234)

    def entry(*args):
        called.append(args)
        return 0

    monkeypatch.setattr(build, "require_cuda", lambda *ts: dev)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    t = torch.zeros(3)
    build.launch(entry, 7, t, None, 2.5)
    assert entered == [dev] and asked == [dev]
    assert called == [(7, t.data_ptr(), None, 2.5, 1234)]

    def failing(*args):
        return 700

    with pytest.raises(RuntimeError, match="failing failed to launch"):
        build.launch(failing, t)


def test_require_cuda_names_the_one_device():
    """A kernel's tensors must be CUDA tensors on one device; nothing is
    copied to make them so."""
    def on(d):
        return types.SimpleNamespace(device=torch.device(d))

    assert build.require_cuda(on("cuda:2"), on("cuda:2")) == \
        torch.device("cuda:2")
    with pytest.raises(ValueError, match="one CUDA device"):
        build.require_cuda(on("cuda:0"), on("cuda:1"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        build.require_cuda(on("cuda:0"), torch.zeros(2))
    with pytest.raises(ValueError, match="one CUDA device"):
        build.require_cuda()


def test_worker_takes_a_card_of_its_own():
    """``_mh_worker --device cuda:3 --cells 2`` lays its mesh over
    cuda:3; a device it does not know is refused."""
    base = ["--pid", "1", "--nproc", "4", "--port", "1", "--out", "o.npz"]
    a = _mh_worker.parse(base + ["--device", "cuda:3", "--cells", "2"])
    assert a.device == "cuda:3"
    mesh = _mh_worker.worker_mesh(a)
    assert mesh.shape == {"runs": 1, "genes": 1, "cells": 2}
    assert list(mesh.devices.flat) == [torch.device("cuda:3")] * 2
    assert _mh_worker.worker_mesh(_mh_worker.parse(base)) is None
    assert _mh_worker.parse(base + ["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        _mh_worker.parse(base + ["--device", "gpu1"])


@pytest.mark.parametrize("given, want", [
    ([], (10000, 3)),
    (["--cophenetic-max-cells", "20", "--cophenetic-nsub", "1"], (20, 1))])
def test_worker_hands_factorize_its_consensus_options(tmp_path, monkeypatch,
                                                      given, want):
    """``--mode ml``'s consensus options reach ``factorize``, with
    factorize's own defaults when they are not given; the run still
    returns the consensus measures."""
    import ccfindr_tpu_torch as ct

    seen = {}
    real = ct.factorize

    def spy(s, **kw):
        seen.update(kw)
        return real(s, **kw)

    monkeypatch.setattr(ct, "factorize", spy)
    # the worker's own check that the port imported no JAX, which this
    # test session's JAX tests have
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    out = tmp_path / "one.npz"
    _mh_worker.main(["--pid", "0", "--nproc", "1", "--port", "1", "--out",
                     str(out), "--device", "cpu", "--mode", "ml",
                     "--ranks", "2,3", "--nrun", "2", "--itmax", "30"]
                    + given)
    assert (seen["cophenetic_max_cells"], seen["cophenetic_nsub"]) == want
    with np.load(out) as z:
        assert np.isfinite(z["cophenetic"]).all()
        assert z["likelihood"].shape == (2,)


def test_sharded_sweep_copies_before_it_launches(monkeypatch):
    """The cell-sharded sweep queues every copy from the reduce device
    (the lanes and hypers, then K2's csum) before the launches behind
    it: K1s on every shard, the gathers, K2, csum to every shard, K3s
    on every shard, the gathers, K4, with no copy between two shards'
    launches."""
    from ccfindr_tpu_torch.ops.kernels import sol, sol_sharded as ssh

    log = []
    nb, rp, n, k = 2, 8, 5, 4
    m = 4 * 8

    def spread(t, devs):
        log.append("spread")
        return [t for _ in devs]

    def gather(parts, dim, dev):
        log.append("gather")
        return torch.cat(parts, dim)

    def k1s(x, lwt, lh, eh, sc, bf16=False):
        log.append("K1s")
        return (torch.zeros(nb, 1, rp, n), torch.zeros(nb, 1, rp, x.shape[1]),
                torch.zeros(nb, 1, dtype=torch.float64),
                torch.zeros(nb, 1, rp, dtype=torch.float64))

    def k3s(shn, lh, csum, sc, r, *ext):
        log.append("K3s")
        z = torch.zeros_like(lh)
        return (z, z, z, torch.zeros(nb, 1, rp, dtype=torch.float64),
                torch.zeros(nb, 1, 4, dtype=torch.float64))

    def k2(swn, lwt, ehs, sc, r, n):
        log.append("K2")
        z = torch.zeros_like(lwt)
        return (z, z, z, torch.zeros(nb, 1, rp, dtype=torch.float64),
                torch.zeros(nb, 1, 4, dtype=torch.float64))

    def k4(*a, **kw):
        log.append("K4")
        return torch.zeros(nb, sol.NSCAL, dtype=torch.float64)

    for name, fn in (("spread", spread), ("gather", gather),
                     ("xpass_shard", k1s), ("h_post_shard", k3s)):
        monkeypatch.setattr(ssh, name, fn)
    monkeypatch.setattr(sol, "w_post", k2)
    monkeypatch.setattr(sol, "finish", k4)
    x = tsh.ShardedCounts(torch.ones(n, m), np.array([["cpu"] * k],
                                                     dtype=object))
    lwt = torch.ones(nb, rp, n)
    lh = x.shard_h(torch.ones(nb, rp, m))
    sc = torch.zeros(nb, 8, dtype=torch.float64)
    ssh.sharded_sweep_kernels(x, lwt, lh, lh, sc, n=n, m_arr=m, m_live=m,
                              r=6)
    assert log == (["spread"] * 2 + ["K1s"] * k + ["gather"] * 3 + ["K2"]
                   + ["spread"] + ["K3s"] * k + ["gather"] * 2 + ["K4"])


def test_block_passes_copy_then_launch_then_return(monkeypatch):
    """A block pass of ``parallel/sharded.py`` (``_blocks``, the mesh
    builders' and the dense routes' loop) moves every block's lanes
    first, then calls every block, then moves the outputs back: no copy
    is issued between two blocks' work."""
    log = []
    orig_to = torch.Tensor.to

    def to(self, *a, **kw):
        log.append("to")
        return orig_to(self, *a, **kw)

    x = tsh.ShardedCounts(torch.ones(6, 8), np.array([["cpu"] * 2] * 2,
                                                     dtype=object))
    lw, lh = torch.ones(3, 6, 2), torch.ones(3, 2, 8)

    def fn(xb, lw_g, lh_c):
        log.append("fn")
        return (lw_g.sum(-1), None, lh_c.sum())

    monkeypatch.setattr(torch.Tensor, "to", to)
    out = tsh._blocks(x, fn, lw, lh)
    monkeypatch.setattr(torch.Tensor, "to", orig_to)
    assert [g for g, _, _ in out] == [0, 0, 1, 1]
    first, last = log.index("fn"), len(log) - log[::-1].index("fn")
    assert log[first:last] == ["fn"] * 4
    assert log[:first] == ["to"] * 8 and set(log[last:]) == {"to"}


# ---------------------------------------------------------------------
# the H family as cell shards on several cards (needs two cards or more)
# ---------------------------------------------------------------------

def _cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the shards' cards are the "
                    "point")
    torch.backends.cuda.matmul.allow_tf32 = False
    return [torch.device("cuda", i)
            for i in range(min(4, torch.cuda.device_count()))]


def _state_run(route, devices, x_np):
    """``route``'s loop over a cells=len(devices) mesh of ``devices``
    from a start given as cell shards (1,024 cells a shard): the result
    and the layout."""
    import scipy.sparse as sp

    import ccfindr_tpu_torch as ct
    from ccfindr_tpu_torch.ops import ml as tml
    from ccfindr_tpu_torch.ops import tile as ttile
    from ccfindr_tpu_torch.ops import vb as tvb
    from ccfindr_tpu_torch.parallel import hshards

    k = len(devices)
    mesh = ct.make_mesh(cells=k, devices=devices)
    dev = devices[0]
    n, m = x_np.shape
    gen = torch.Generator().manual_seed(7)
    w = (torch.rand(4, n, 8, generator=gen) + 0.1).to(dev)
    h = (torch.rand(4, 8, m, generator=gen) + 0.1).to(dev)
    if route == "dense_fused":
        x = tsh.place_counts(torch.as_tensor(x_np), mesh)[0]
    else:
        x = ttile.from_scipy_tile_sharded(
            sp.csr_matrix(x_np), k, dtype=torch.float32,
            device=dev).to(mesh.devices[0][0])
    if route == "ml_tile":
        fh, fw = tsh.make_tile_ml_sharded(mesh)
        return tml.ml_run(x, w, hshards.shard_h(h, x), itmax=8, tol=0.0,
                          fused_h=fh, fused_w=fw), x
    fused = (tsh.fused_sharded if route == "dense_fused"
             else tsh.make_tile_fused_sharded(mesh))
    st = tvb.VBState(ew=w, eh=hshards.shard_h(h, x), lw=w,
                     lh=hshards.shard_h(h, x),
                     dw=torch.zeros_like(w),
                     dh=hshards.shard_h(torch.zeros_like(h), x),
                     lkh=torch.full((4,), -np.inf, device=dev))
    hy = tvb.Hyper(*(torch.ones(4, device=dev),) * 4)
    return tvb.vb_run(x, st, hy, itmax=8, tol=0.0, fused=fused), x


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tile", "dense_fused", "ml_tile"])
def test_sharded_state_lies_on_its_cards(route):
    """On k cards the loop keeps each shard of the H family (ML: h and
    its cluster ids) on its cell shard's card, and gives the bits of the
    same mesh laid out on cuda:0 alone."""
    from ccfindr_tpu_torch.parallel import hshards

    cards = _cards()
    k = len(cards)
    rng = np.random.default_rng(3)
    x_np = ((rng.random((256, 1024 * k)) < 0.1)
            * rng.poisson(3.0, (256, 1024 * k))).astype(np.float32)
    x_np[:, 0] += 1
    x_np[0, :] += 1
    got, x = _state_run(route, cards, x_np)
    want, _ = _state_run(route, [cards[0]] * k, x_np)
    shards = ((got.h, got.cid) if route == "ml_tile"
              else (got.state.eh, got.state.lh, got.state.dh))
    for t in shards:
        assert [p.device for p in t] == cards
    for a, b in zip(got, want):
        if isinstance(a, tuple) and not isinstance(a, hshards.HShards):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(hshards.to_numpy(u),
                                              hshards.to_numpy(v))
        else:
            np.testing.assert_array_equal(hshards.to_numpy(a),
                                          hshards.to_numpy(b))
