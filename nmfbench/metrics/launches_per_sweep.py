"""Kernels the device ran inside the traced scan's window (between its
two markers), over the sweeps that scan ran (Itmax)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["launches"] / int(run.traffic["Itmax"])
