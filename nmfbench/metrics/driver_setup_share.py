"""The share of the scans' summed wall time outside the driver's
``vb_rank_batch`` phase (``metadata['timings']``): the driver's per-scan
set-up (input conversion, guards, starts, layout) and the result's host
copy.  Over the untraced scans, of which every run has one."""


def read(run):
    scans = [s for s in run.scans
             if not s["traced"] and s["loop_s"] is not None]
    wall = sum(s["wall_s"] for s in scans)
    if not scans or wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s["loop_s"] for s in scans) / wall)
