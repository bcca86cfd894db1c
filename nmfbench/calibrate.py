"""The readings the limits of ``limits/<workload>.json`` are set from,
at the cell's own size, on the card::

    python3 -m nmfbench.calibrate --workload <name> --seeds 11 12 13 [--detail]

For each seed it draws the run's counts, runs the window's first scan
of the program, and prints one JSON line with the compared numbers of
that scan (the lower readings) and of the control (the reference in
TF32, put in the program's place: the upper readings), both against the
float64 reference, on the ranks a run of that seed checks; ``--detail``
adds each rank's and array's gaps.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def detail(entry, answer, lanes_by_rank):
    """Each followed rank's gaps of each factor array from the run the
    answer lies closest to: {rank: {array: [widest, rms]}}, relative to
    the run's largest entry and its rms."""
    import numpy as np

    out = {}
    for r, lanes in lanes_by_rank.items():
        k = answer["ranks"].index(r)
        j = int(np.argmin([entry._factor_gaps(answer, k, lanes, i)[0]
                           for i in range(len(lanes.lml))]))
        refs = (lanes.ew[j], lanes.eh[j], np.sqrt(lanes.dw[j]),
                np.sqrt(lanes.dh[j]))
        out[r] = {f: ["%.3g" % (np.abs(d).max() / np.abs(ref).max()),
                      "%.3g" % (np.sqrt((d ** 2).mean())
                                / np.sqrt((ref ** 2).mean()))]
                  for f, ref in zip(entry.FACTORS, refs)
                  for d in [np.asarray(answer[f][k], np.float64) - ref]}
        out[r]["run"] = j
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m nmfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--detail", action="store_true",
                    help="also each rank's and array's widest and rms gap")
    args = ap.parse_args(argv)

    import torch

    from nmfbench import harness
    from nmfbench import reference as ref

    _, wl, cfg, traffic, _ = harness.cell(args.workload)
    entry = importlib.import_module(f"nmfbench.entries.{traffic['entry']}")
    dataset = importlib.import_module(
        f"nmfbench.datasets.{cfg['data']['kind']}")
    port = harness._import_port()
    for seed in args.seeds:
        t = {}
        t0 = time.perf_counter()
        x = harness.drop_empty(dataset.generate(
            cfg["data"], harness.scan_seed(seed, harness.DATA), args.device))
        scset = harness._to_scset(port, x)
        x_host = x.cpu()
        del x
        t["data_s"] = time.perf_counter() - t0
        s = harness.scan_seed(seed, 0)
        t0 = time.perf_counter()
        ans = entry.call(port, scset, traffic, s, args.device)
        t["scan_s"] = time.perf_counter() - t0
        del scset
        torch.cuda.empty_cache()
        _, at = entry.check_sample(traffic, 1, seed)
        cx = ref.counts(x_host.to(args.device))
        t0 = time.perf_counter()
        lanes = entry.reference(cx, traffic, s, at, "f64")
        t["reference_s"] = time.perf_counter() - t0
        line = dict(seed=seed, ranks=[traffic["ranks"][k] for k in at],
                    program=entry.gaps(ans, lanes),
                    program_lml=[float(v) for v in ans["lml"]])
        t0 = time.perf_counter()
        ctl = entry.control_answer(entry.reference(cx, traffic, s, at,
                                                   "tf32"), s)
        t["control_s"] = time.perf_counter() - t0
        line["control"] = entry.gaps(ctl, lanes)
        if args.detail:
            line["detail"] = dict(program=detail(entry, ans, lanes),
                                  control=detail(entry, ctl, lanes))
        line["seconds"] = t
        del cx
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
