"""The entry ``vb_factorize``: one VB rank scan a call, as an analyst
runs it on a QC'd count matrix, and the comparison of its answers with
the reference.

The traffic file gives ``backend``, ``ranks``, ``nrun``, ``Itmax``,
``Tol``, further keywords under ``options``, and under ``check`` how many
ranks of one scan the reference follows.
"""

from __future__ import annotations

import math

import numpy as np

from .. import reference as ref

FACTORS = ("basis", "coeff", "dbasis", "dcoeff")
HYPERS = ("aw", "bw", "ah", "bh")


def lane_count(traffic, m):
    """The (rank, run) lanes of one scan over ``m`` cells."""
    return sum(1 for r in traffic["ranks"] if r <= m) * int(traffic["nrun"])


def live_ranks(traffic, m):
    """The live rank of every lane of one scan."""
    return [int(r) for r in traffic["ranks"] if r <= m
            for _ in range(int(traffic["nrun"]))]


def call(port, scset, traffic, seed, device, itmax=None):
    """One scan through the public entry; its answer on the host."""
    out = port.vb_factorize(
        scset, ranks=list(traffic["ranks"]), nrun=int(traffic["nrun"]),
        Itmax=int(traffic["Itmax"] if itmax is None else itmax),
        Tol=float(traffic["Tol"]), backend=traffic["backend"], seed=seed,
        verbose=0, device=device, **traffic.get("options", {}))
    ms = out.measure
    loop = [t["seconds"] for t in out.metadata.get("timings", [])
            if t["name"] == "vb_rank_batch"]
    return dict(
        seed=seed, ranks=[int(r) for r in out.ranks],
        lml=np.asarray(ms["lml"], np.float64),
        hyper={h: np.asarray(ms[h], np.float64) for h in HYPERS},
        basis=list(out.basis), coeff=list(out.coeff),
        dbasis=list(out.dbasis), dcoeff=list(out.dcoeff),
        loop_s=sum(loop) if loop else None)


def complete(answer, traffic, m):
    """Whether a scan answered every rank with finite numbers."""
    want = [int(r) for r in traffic["ranks"] if r <= m]
    if answer["ranks"] != want:
        return False
    arrays = [answer["lml"], *answer["hyper"].values()]
    arrays += [a for f in FACTORS for a in answer[f]]
    return all(np.isfinite(a).all() for a in arrays)


def control_answer(lanes_by_rank, seed):
    """The reference's own answer in the program's place: each rank's
    best run, as :func:`call` returns a scan's."""
    ans = dict(seed=seed, ranks=[], lml=[], hyper={h: [] for h in HYPERS},
               basis=[], coeff=[], dbasis=[], dcoeff=[], loop_s=None)
    for r, lanes in lanes_by_rank.items():
        i = ref.select(lanes)
        ans["ranks"].append(r)
        ans["lml"].append(lanes.lml[i])
        for h in HYPERS:
            ans["hyper"][h].append(getattr(lanes, h)[i])
        ans["basis"].append(lanes.ew[i])
        ans["coeff"].append(lanes.eh[i])
        ans["dbasis"].append(np.sqrt(lanes.dw[i]))
        ans["dcoeff"].append(np.sqrt(lanes.dh[i]))
    ans["lml"] = np.asarray(ans["lml"])
    ans["hyper"] = {h: np.asarray(v) for h, v in ans["hyper"].items()}
    return ans


def _factor_gaps(answer, k, lanes, i):
    """The gaps of the answer's rank-k factors from run i's, worst of the
    four arrays: the widest, over the largest entry of run i's array,
    and the root mean square, over the array's."""
    refs = (lanes.ew[i], lanes.eh[i], np.sqrt(lanes.dw[i]),
            np.sqrt(lanes.dh[i]))
    widest = rms = 0.0
    for f, r in zip(FACTORS, refs):
        d = np.asarray(answer[f][k], np.float64) - r
        widest = max(widest, float(np.abs(d).max() / np.abs(r).max()))
        rms = max(rms, float(np.sqrt((d ** 2).mean() / (r ** 2).mean())))
    return widest, rms


def gaps(answer, lanes_by_rank):
    """The compared numbers of one scan's answer against the reference's
    runs of the ranks it followed, each the worst over those ranks:

    * ``factor_rel``: the widest gap of the answer's factors from the
      reference run they lie closest to (the run the scan kept);
    * ``factor_rms``: their root-mean-square gap from that run's;
    * ``lml_rel``: its log evidence against that run's, or, where that
      run's evidence lies below the reference's best run of the rank,
      that shortfall (the best-of-nrun selection), over the best's;
    * ``hyper_rel``: its four hyperparameters against that run's,
      relative.
    """
    out = dict(factor_rel=0.0, factor_rms=0.0, lml_rel=0.0, hyper_rel=0.0)
    for r, lanes in lanes_by_rank.items():
        if r not in answer["ranks"]:
            return {key: math.inf for key in out}
        k = answer["ranks"].index(r)
        fg = [_factor_gaps(answer, k, lanes, i)
              for i in range(len(lanes.lml))]
        j = int(np.argmin([g[0] for g in fg]))
        best = lanes.lml[ref.select(lanes)]
        lml = max(abs(answer["lml"][k] - lanes.lml[j]), best - lanes.lml[j])
        hyp = max(abs(answer["hyper"][h][k] - getattr(lanes, h)[j])
                  / abs(getattr(lanes, h)[j]) for h in HYPERS)
        for key, v in (("factor_rel", fg[j][0]), ("factor_rms", fg[j][1]),
                       ("lml_rel", lml / abs(best)), ("hyper_rel", hyp)):
            v = float(v) if np.isfinite(v) else math.inf
            out[key] = max(out[key], v)
    return out


def check_sample(traffic, n_scans, seed):
    """The scan and the rank positions the reference follows, drawn from
    the run's seed."""
    rng = np.random.default_rng([int(seed), 7])
    nranks = len(traffic["ranks"])
    take = min(int(traffic["check"]["ranks"]), nranks)
    scan = int(rng.integers(n_scans))
    return scan, sorted(int(k) for k in rng.choice(nranks, take,
                                                   replace=False))


def reference(cx, traffic, seed, ranks_at, precision="f64"):
    """The reference's runs of the ranks at positions ``ranks_at`` of the
    scan seeded by ``seed``."""
    ranks = [int(r) for r in traffic["ranks"] if r <= cx.x.shape[1]]
    return ref.rank_scan(cx, seed, ranks, int(traffic["nrun"]),
                         int(traffic["Itmax"]), ranks_at, precision)
