"""Faults planted under the timed path, and the control put in the
program's place, each of which a run has to find not correct::

    python3 -m nmfbench.faults --workload <name> --seeds 11 12 --faults control half_batch

For each fault and seed it plants the fault, runs the cell once through
``harness.run`` with a window of one scan at the cell's own size, takes
the fault out again, and prints one JSON line: the fault, the seed,
``correct``, ``failed`` and each compared number beside its limit.  The
last line says whether every run was found not correct.  Not part of a
benchmark run; the CPU tests plant the same faults at a small size.

Each planter takes ``patch(obj, name, value)`` (``pytest``'s
``monkeypatch.setattr``, or :class:`Patches` here) and the cell's
backend.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np


class Patches:
    """``setattr`` that remembers what it replaced, until :meth:`undo`."""

    def __init__(self):
        self._old = []

    def __call__(self, obj, name, value):
        self._old.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._old:
            obj, name, value = self._old.pop()
            setattr(obj, name, value)


def unchanged(patch, backend):
    """A sweep that returns its state unchanged."""
    import torch

    if backend == "pallas":
        from ccfindr_tpu_torch.ops.kernels import sol

        real = sol.sol_sweep

        def sweep(x, lwt, lh, eh, sc, **kw):
            out = real(x, lwt, lh, eh, sc, **kw)
            return (lwt, lwt, torch.zeros_like(lwt), eh, lh,
                    torch.zeros_like(eh), out[6])

        patch(sol, "sol_sweep", sweep)
    else:
        from ccfindr_tpu_torch.ops import vb

        real = vb.posterior_update

        def post(sw, sh, state, *a, **kw):
            return state, real(sw, sh, state, *a, **kw)[1]

        patch(vb, "posterior_update", post)


def half_batch(patch, backend):
    """The X pass over half of the cells, the other half's counts
    doubled in their place."""
    if backend == "pallas":
        from ccfindr_tpu_torch.ops.kernels import sol

        real = sol.sol_sweep

        def sweep(x, lwt, *a, **kw):
            xh = x.to(lwt.dtype)
            xh[:, 1::2] = 0
            xh[:, 0::2] *= 2
            return real(xh, lwt, *a, **kw)

        patch(sol, "sol_sweep", sweep)
    else:
        from ccfindr_tpu_torch.ops import tile

        real = tile.from_scipy_tile

        def layout(mat, *a, **kw):
            mat = mat.tocoo()
            keep = mat.col % 2 == 0
            mat = type(mat)((mat.data[keep] * 2, (mat.row[keep],
                                                  mat.col[keep])),
                            shape=mat.shape).tocsr()
            return real(mat, *a, **kw)

        patch(tile, "from_scipy_tile", layout)


def answer_altered(patch, backend):
    """Each lane's largest W entry 1% off where the loop's result is
    brought to the host."""
    from ccfindr_tpu_torch.ops import vb

    real = vb.state_to_numpy

    def to_numpy(obj):
        out = real(obj)
        if hasattr(out, "state"):
            ew = out.state.ew
            for b in range(ew.shape[0]):
                ew[b].flat[int(np.argmax(ew[b]))] *= 1.01
        return out

    patch(vb, "state_to_numpy", to_numpy)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


def control(patch, cell, seed, device):
    """The control in the program's place: the window's scan answers the
    ranks that a run of ``seed`` with one scan checks from the reference
    in TF32 (``reference.py``), worked out from the run's own counts,
    and its other ranks from the program."""
    from nmfbench import harness, reference as ref
    from nmfbench.entries import vb_factorize as entry

    cfg, traffic = cell[2], cell[3]
    real = entry.call
    _, at = entry.check_sample(traffic, 1, seed)

    def call(port, scset, traffic, s, device_, itmax=None):
        ans = real(port, scset, traffic, s, device_, itmax)
        if itmax is not None:
            return ans
        dataset = importlib.import_module(
            f"nmfbench.datasets.{cfg['data']['kind']}")
        x = harness.drop_empty(dataset.generate(
            cfg["data"], harness.scan_seed(seed, harness.DATA), device))
        lanes = entry.reference(ref.counts(x), traffic, s, at, "tf32")
        del x
        ctl = entry.control_answer(lanes, s)
        ans["lml"] = ans["lml"].copy()
        ans["hyper"] = {h: v.copy() for h, v in ans["hyper"].items()}
        for j, r in enumerate(ctl["ranks"]):
            k = ans["ranks"].index(r)
            ans["lml"][k] = ctl["lml"][j]
            for h in entry.HYPERS:
                ans["hyper"][h][k] = ctl["hyper"][h][j]
            for f in entry.FACTORS:
                ans[f][k] = ctl[f][j]
        return ans

    patch(entry, "call", call)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m nmfbench.faults")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", required=True,
                    choices=["control", *sorted(FAULTS)])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nmfbench import harness

    cell = harness.cell(args.workload)
    caught = True
    for fault in args.faults:
        for seed in args.seeds:
            patches = Patches()
            if fault == "control":
                control(patches, cell, seed, args.device)
            else:
                FAULTS[fault](patches, cell[3]["backend"])
            try:
                r = harness.run(args.workload, seed, 0.0, 0,
                                device=args.device, log=lambda s: None)
            finally:
                patches.undo()
            caught = caught and r["correct"] is False
            print(json.dumps(dict(fault=fault, seed=seed,
                                  correct=r["correct"], failed=r["failed"],
                                  checks=r["checks"])), flush=True)
    print(json.dumps(dict(workload=args.workload,
                          every_run_not_correct=caught)), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
