"""All the lane-sweeps of the window's completed scans (lanes x Itmax a
scan, counted by the harness) over the window's whole length."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(s["lane_sweeps"] for s in run.scans) / run.window_s
