"""The share of the traced scan's window (from the marker launched before
the entry's call to the one launched after it returns, the scan traced
for the device alone) in which the device ran nothing: one minus the
union of its kernels, copies and sets over the window."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
