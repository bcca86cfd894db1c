"""The counting functions against hand-worked values, the trace
arithmetic on a made-up trace, and the metric readers on a made-up
run."""

from types import SimpleNamespace as NS

import pytest

from conftest import WORKLOADS


def test_sweep_work_by_hand():
    from nmfbench import counting

    # 10 nonzeros, lanes of live rank 2 and 3: 3 r multiply-adds a
    # nonzero and lane -> 6 * (2 + 3) * 10
    assert counting.sweep_flops(10, [2, 3]) == 300
    # X's 10 nonzeros at a byte; lw read and ew, lw, dw written, each
    # 3 x (2 + 3) floats: 4 * 15 * 4 = 240; lh read and eh, lh, dh
    # written, each (2 + 3) x 4 floats: 4 * 20 * 4 = 320
    assert counting.sweep_bytes(3, 4, 10, [2, 3]) == 10 + 240 + 320
    peak = {"flops": 100.0, "bytes": 1000.0}
    assert counting.bound_seconds(300, 570, peak) == pytest.approx(3.0)
    assert counting.bound_seconds(30, 570, peak) == pytest.approx(0.57)


def test_pbmc68k_sweep_by_hand():
    from nmfbench import counting
    from nmfbench.entries import vb_factorize as entry

    traffic = dict(ranks=[2, 3, 4, 5, 6, 7, 8], nrun=5)
    live = entry.live_ranks(traffic, 68579)
    assert len(live) == 35 and sum(live) == 175
    nnz = 28_100_000
    assert counting.sweep_flops(nnz, live) == 6 * 175 * nnz
    h100 = counting.peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"flops": 495e12, "bytes": 3.35e12}
    b = counting.sweep_bytes(4096, 68579, nnz, live)
    # W family 4 x 4,096 x 175 floats = 11,468,800 B; H family
    # 4 x 68,579 x 175 floats = 192,021,200 B; X 28,100,000 B
    assert b == 231_590_000
    # bytes bound it: 69.13 us against 29.505 GFLOP over 495 TFLOP/s,
    # 59.61 us
    assert counting.sweep_flops(nnz, live) == 29_505_000_000
    assert counting.bound_seconds(counting.sweep_flops(nnz, live), b,
                                  h100) == pytest.approx(69.1313e-6,
                                                         rel=1e-5)
    assert counting.peaks("some other card") is None


def _ev(name, a, b, dev):
    from torch.autograd import DeviceType

    return NS(name=name, device_type=DeviceType.CUDA if dev
              else DeviceType.CPU,
              time_range=NS(start=a, end=b, elapsed_us=lambda: b - a))


def test_trace_reading_by_hand():
    from nmfbench import trace

    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    evs = [_ev("before", -20, -10, True),
           _ev(spin, 0, 2, True),
           _ev("Memcpy HtoD", 10, 25, True),
           _ev("void ccfindr::k1<float>(float*)", 30, 50, True),
           _ev("elementwise", 45, 60, True),
           _ev("void ccfindr::k4(double*)", 70, 80, True),
           _ev(spin, 100, 102, True),
           _ev("after", 110, 120, True),
           _ev("aten::copy_", 0, 20, False)]
    r = trace.read(NS(events=lambda: evs), 98e-6)
    # the window: from the marker's end, 98 us by the host, [2, 100)
    assert r["window_s"] == pytest.approx(98e-6)
    # busy: [10, 25) + [30, 60) + [70, 80)
    assert r["busy_s"] == pytest.approx(55e-6)
    assert r["launches"] == 3
    # the loop: first to last ccfindr kernel, [30, 80)
    assert r["loop_kernel_s"] == pytest.approx(45e-6)
    assert r["device_ops"][0] == ["ccfindr::k1<float>", pytest.approx(20e-6)]
    assert {"before", "after", "spin_kernel"}.isdisjoint(
        dict(r["device_ops"]))


def test_trace_without_markers_reads_nothing():
    from nmfbench import trace

    evs = [_ev("Memcpy HtoD", 10, 25, True),
           _ev("void ccfindr::k1<float>(float*)", 30, 50, True)]
    assert trace.read(NS(events=lambda: evs), 1.0) is None
    assert trace.read(NS(events=lambda: []), 1.0) is None
    assert "2 device events, 0 markers" in trace.describe(
        NS(events=lambda: evs))


def test_idle_gaps_by_hand():
    from nmfbench import trace

    evs = [_ev(trace.SPAN, 0, 100, False),
           _ev("aten::copy_", 0, 20, False),
           _ev("aten::to", 0, 30, False),
           _ev("Memcpy HtoD", 10, 25, True),
           _ev("void ccfindr::k1<float>(float*)", 30, 50, True),
           _ev("elementwise", 45, 60, True),
           _ev("void ccfindr::k4(double*)", 70, 80, True),
           _ev("outside", 150, 160, True)]
    gaps = trace.idle_gaps(NS(events=lambda: evs))
    # gaps [80, 100), [0, 10), [60, 70), [25, 30), longest first
    assert [[n, round(s * 1e6)] for n, s in gaps] == [
        ["host, no torch operator", 20], ["aten::to > aten::copy_", 10],
        ["host, no torch operator", 10],
        ["aten::to", 5]]


def test_idle_gaps_without_device_events_read_nothing():
    from nmfbench import trace

    evs = [_ev(trace.SPAN, 0, 100, False)]
    assert trace.idle_gaps(NS(events=lambda: evs)) is None


def _run(trace=None):
    from nmfbench import harness

    traffic = dict(entry="vb_factorize", ranks=[2, 3], nrun=2, Itmax=10)
    rn = harness.Run(traffic=traffic,
                     device_kind="NVIDIA H100 80GB HBM3", n=100, m=1000,
                     nnz=5000, setup_s=12.5, window_s=4.0,
                     peak_bytes=3 * 2 ** 30, trace=trace)
    rn.scans = [dict(wall_s=2.0, loop_s=1.5, traced=False, lane_sweeps=40),
                dict(wall_s=2.0, loop_s=1.0, traced=False, lane_sweeps=40)]
    return rn


def test_metric_readers_by_hand():
    from nmfbench import counting, harness

    rn = _run(dict(window_s=2.0, busy_s=1.5, launches=850,
                   loop_kernel_s=0.001, device_ops=[], idle_gaps=[]))
    read = {m: harness.metric_reader(m)(rn) for m in (
        "lane_sweeps_per_s", "peak_device_gib", "setup_s",
        "driver_setup_share", "launches_per_sweep", "kernel_roofline",
        "device_idle_share", "loop_lane_sweeps_per_s", "step_mfu")}
    assert read["lane_sweeps_per_s"] == 20.0
    assert read["peak_device_gib"] == 3.0
    assert read["setup_s"] == 12.5
    assert read["driver_setup_share"] == pytest.approx(37.5)
    assert read["loop_lane_sweeps_per_s"] == pytest.approx(80 / 2.5)
    assert read["launches_per_sweep"] == 85.0
    assert read["device_idle_share"] == pytest.approx(25.0)
    live = [2, 2, 3, 3]
    bound = 10 * counting.bound_seconds(
        counting.sweep_flops(5000, live),
        counting.sweep_bytes(100, 1000, 5000, live),
        counting.peaks(rn.device_kind))
    assert read["kernel_roofline"] == pytest.approx(100 * bound / 0.001)
    # 10 sweeps of 6 * 10 * 5000 operations over the traced 2 s at TF32
    assert read["step_mfu"] == pytest.approx(100 * 3e6 / (2.0 * 495e12))


@pytest.mark.parametrize("name", ["launches_per_sweep", "kernel_roofline",
                                  "device_idle_share", "step_mfu"])
def test_trace_readers_read_nothing_without_a_trace(name):
    from nmfbench import harness

    assert harness.metric_reader(name)(_run()) is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_reports_its_metrics(workload):
    from nmfbench import harness

    spec = harness.cell(workload)[0]
    e2e = [m["name"] for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", [workload])]
    assert layer and all(m["moves"] in e2e for m in layer)
