"""The whole traced scan's share of the card's peak: the operations its
sweeps need (``nmfbench.counting``, each lane by its live rank) over the
device's traced window (from the marker launched before the entry's
call to the one launched after it returns) and the TF32 peak.  Unlike
``kernel_roofline`` it counts the driver's set-up and the idle device
too, so work moved out of the loop's kernels still shows here."""

from nmfbench import counting
from nmfbench.entries import vb_factorize as entry


def read(run):
    peak = counting.peaks(run.device_kind)
    if run.trace is None or run.trace["window_s"] <= 0 or peak is None:
        return None
    live = entry.live_ranks(run.traffic, run.m)
    flops = int(run.traffic["Itmax"]) * counting.sweep_flops(run.nnz, live)
    return 100.0 * flops / (run.trace["window_s"] * peak["flops"])
