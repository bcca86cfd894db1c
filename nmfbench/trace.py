"""Reading the ``torch.profiler`` traces of a ``--trace 1`` run.

Two scans of the window are traced.  The first is traced for the
device's activity alone, so that the host's operators run at their
untraced pace: the harness launches a marker (``torch.cuda._sleep``'s
kernel) on the idle device just before the entry's call, and the window
runs from the marker's end for as long as the host measured from there
to the call's return with the device synchronised.  (A second marker
after the call would need the profiler to keep the last record before
its stop, which it does not always do.)  Busy time is the union of the
device's intervals (kernels, copies, sets) within the window; the loop
is the stretch from the port's first kernel to its last (``ccfindr::``
in the name), so that the driver's set-up copies and casts fall outside
it.

The second is traced with the host's operators too, inside the
harness's ``record_function`` span, only to say what the host was doing
over the device's longest idle gaps.  Recording every host operator
slows a loop that the host paces, so its gaps are longer than the
first scan's; no metric reads them.
"""

from __future__ import annotations

SPAN = "nmfbench.scan"
PORT_KERNEL = "ccfindr::"
MARKER = "spin_kernel"        # torch.cuda._sleep's kernel, the marker
TOP = 10


def _short(name, width=120):
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:width] if "(" in name else name[:width]


def _union(intervals, lo, hi):
    """Merged [a, b) intervals clipped to [lo, hi], in order."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(busy, w0, w1):
    """The idle stretches of [w0, w1) between the busy intervals,
    longest first, at most ``TOP``."""
    gaps, end = [], w0
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = b
    if end < w1:
        gaps.append((end, w1))
    return sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]


def _device(evs):
    from torch.autograd import DeviceType

    return [e for e in evs if e.device_type == DeviceType.CUDA
            and e.name != SPAN]


def read(prof, span_s):
    """The reading of a device-only trace that opens with a ``MARKER``
    kernel, over the window from the marker's end that lasts ``span_s``
    seconds: a dict with ``window_s``, ``busy_s``, ``launches`` (kernels
    in the window), ``loop_kernel_s`` (the summed time of the loop's
    kernels) and ``device_ops`` (the breakdown's list); None where the
    trace holds no marker or no device event in the window."""
    dev = sorted(_device(prof.events()), key=lambda e: e.time_range.start)
    marks = [e for e in dev if MARKER in e.name]
    if not marks or span_s <= 0:
        return None
    w0 = marks[0].time_range.end
    w1 = w0 + span_s * 1e6
    dev = [e for e in dev if MARKER not in e.name
           and w0 <= e.time_range.start < w1]
    if not dev:
        return None
    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev],
                  w0, w1)
    ours = [e for e in kern if PORT_KERNEL in e.name]
    loop_s = None
    if ours:
        l0 = min(e.time_range.start for e in ours)
        l1 = max(e.time_range.end for e in ours)
        loop_s = sum(e.time_range.elapsed_us() for e in kern
                     if e.time_range.start >= l0
                     and e.time_range.end <= l1) / 1e6
    by = {}
    for e in dev:
        name = _short(e.name)
        by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=(w1 - w0) / 1e6,
                busy_s=sum(b - a for a, b in busy) / 1e6,
                launches=len(kern), loop_kernel_s=loop_s,
                device_ops=[[k, v] for k, v in ops])


def describe(prof):
    """A line on a device-only trace that :func:`read` could not read:
    its device events, markers, and the first and last events."""
    dev = sorted(_device(prof.events()), key=lambda e: e.time_range.start)
    ends = [(e.name[:60], e.time_range.start) for e in dev[:2] + dev[-2:]]
    return (f"{len(dev)} device events, "
            f"{sum(MARKER in e.name for e in dev)} markers, ends {ends}")


def _label(cpu, a, b):
    """What the host was doing over the gap [a, b): the innermost host
    operator or span running at its middle, with the outermost below the
    scan's span, as ``outer > inner``."""
    mid = (a + b) / 2
    over = [e for e in cpu if e.time_range.start <= mid < e.time_range.end
            and e.name != SPAN]
    if not over:
        return "host, no torch operator"
    inner = min(over, key=lambda e: e.time_range.elapsed_us())
    outer = max(over, key=lambda e: e.time_range.elapsed_us())
    if outer is inner:
        return inner.name
    return f"{outer.name} > {inner.name}"


def idle_gaps(prof):
    """The longest idle gaps of the device within a host-and-device
    trace's ``SPAN``, each ``[label, seconds]``; None where the trace
    holds no span or no device event."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    spans = [e for e in evs if e.name == SPAN
             and e.device_type == DeviceType.CPU]
    dev = _device(evs)
    if not spans or not dev:
        return None
    w0 = min(s.time_range.start for s in spans)
    w1 = max(s.time_range.end for s in spans)
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev],
                  w0, w1)
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    return [[_label(cpu, a, b), (b - a) / 1e6]
            for a, b in _gaps(busy, w0, w1)]
