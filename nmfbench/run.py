"""Run one cell once on the card::

    python3 -m nmfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up's split and each scan on earlier lines, the compared
numbers beside their limits as the last lines of standard error, and
the result as one JSON object on the last line of standard output.
Without the port in the checkout it fails on its import; without as
many CUDA devices as the cell asks for, it prints no result and exits
with 2, never falling back to the CPU; with JAX or the JAX package
loaded once the window has closed, with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m nmfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from nmfbench import harness

    _, wl, *_ = harness.cell(args.workload)
    harness._import_port()
    import torch

    need = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"nmfbench: {args.workload} needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                                 args.trace, device="cuda", t_start=T0,
                                 log=lambda s: print(s, flush=True))
    barred = harness.barred_modules()
    if barred:
        print(f"nmfbench: modules loaded that the run may not load: "
              f"{', '.join(barred)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
