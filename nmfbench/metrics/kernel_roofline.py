"""The least time the traced scan's sweeps need on this card (the larger
of their operations over the TF32 peak and their bytes over HBM's, from
``nmfbench.counting``) over the summed time of the kernels of its loop
(from the port's first kernel to its last)."""

from nmfbench import counting
from nmfbench.entries import vb_factorize as entry


def read(run):
    peak = counting.peaks(run.device_kind)
    if run.trace is None or not run.trace["loop_kernel_s"] or peak is None:
        return None
    live = entry.live_ranks(run.traffic, run.m)
    sweeps = int(run.traffic["Itmax"])
    bound = sweeps * counting.bound_seconds(
        counting.sweep_flops(run.nnz, live),
        counting.sweep_bytes(run.n, run.m, run.nnz, live), peak)
    return 100.0 * bound / run.trace["loop_kernel_s"]
