"""Tracing: a ``torch.profiler`` trace around any block of work.

Counterpart of ``ccfindr_tpu.utils.profiling.profile_trace`` (a
``jax.profiler`` trace for TensorBoard/XProf).  Here the trace is
``torch.profiler``'s: host operators always, and the card's kernels
when CUDA is available, written as a Chrome trace under ``log_dir``
(open it in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json``; yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
