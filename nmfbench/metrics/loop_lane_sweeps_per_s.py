"""The loop's rate alone: the scans' lane-sweeps over the summed time of
the driver's ``vb_rank_batch`` phase, without the driver's per-scan
set-up.  Over the untraced scans, of which every run has one.  Steadier
than ``lane_sweeps_per_s`` where the loop runs on the device, as the
host's load moves the set-up."""


def read(run):
    scans = [s for s in run.scans if not s["traced"] and s["loop_s"]]
    if not scans:
        return None
    return sum(s["lane_sweeps"] for s in scans) / sum(s["loop_s"]
                                                      for s in scans)
