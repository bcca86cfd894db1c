"""The reference against the port on the CPU, and the control's
failure, at a small size."""

import numpy as np
import pytest
import torch

from conftest import WORKLOADS, small


def _scan(backend, dtype, seed=77, itmax=40, ranks=(2, 3, 4), nrun=3):
    import ccfindr_tpu_torch as ct
    from nmfbench import harness
    from nmfbench import reference as ref
    from nmfbench.datasets import planted
    from nmfbench.entries import vb_factorize as entry

    data = dict(n_genes=96, n_cells=300, rank=16, mean=2.0, cap=127,
                density=0.1)
    x = harness.drop_empty(planted.generate(data, 1234567, "cpu"))
    scset = harness._to_scset(ct, x)
    traffic = dict(entry="vb_factorize", backend=backend, ranks=list(ranks),
                   nrun=nrun, Itmax=itmax, Tol=0.0, options={},
                   check=dict(ranks=len(ranks)))
    if dtype is not None:
        traffic["options"] = dict(dtype=dtype)
    ans = entry.call(ct, scset, traffic, seed, "cpu")
    cx = ref.counts(x)
    at = list(range(len(ranks)))
    return (ans, entry.reference(cx, traffic, seed, at, "f64"),
            entry.reference(cx, traffic, seed, at, "tf32"))


@pytest.mark.parametrize("backend", ["pallas", "sparse"])
def test_reference_is_the_port_in_float64(backend):
    from nmfbench.entries import vb_factorize as entry

    ans, lanes, _ = _scan(backend, None)
    g = entry.gaps(ans, lanes)
    # the port's float64 scan starts from the unrounded draws, the
    # reference from the float32 start the card's scan keeps
    assert g["factor_rel"] < 1e-6
    assert g["lml_rel"] < 1e-9
    assert g["hyper_rel"] < 1e-7


@pytest.mark.parametrize("workload", WORKLOADS)
def test_float32_port_meets_the_limits_and_the_control_does_not(workload):
    from nmfbench import harness
    from nmfbench.entries import vb_factorize as entry

    traffic, limits = harness.cell(workload)[3:]
    limits = limits["limits"]
    ans, lanes, ctl = _scan(traffic["backend"], torch.float32)
    prog = entry.gaps(ans, lanes)
    assert all(prog[k] <= v for k, v in limits.items()), prog
    control = entry.gaps(entry.control_answer(ctl, 77), lanes)
    assert any(control[k] > v for k, v in limits.items()), control


def test_starts_follow_the_lane_order():
    from nmfbench import reference as ref

    a = ref.starts(5, 7, 9, 4, [0, 3])
    b = ref.starts(5, 7, 9, 4, [3])
    assert torch.equal(a[3][0], b[3][0]) and torch.equal(a[3][1], b[3][1])
    assert not torch.equal(a[0][0], a[3][0])
    # kept in float32, as the scan's factors are
    assert torch.equal(a[0][0], a[0][0].float().double())


def test_round_tf32_keeps_ten_mantissa_bits():
    from nmfbench.reference import round_tf32

    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 2 ** -11), 3.0], dtype=torch.float32)
    got = round_tf32(x)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                         -(1.0 + 2 ** -10), 3.0], dtype=torch.float32)
    assert torch.equal(got, want)


def test_selection_picks_the_highest_evidence():
    from nmfbench import reference as ref

    z = np.zeros((3, 1, 1))
    lanes = ref.Lanes(lml=np.array([-3.0, -1.0, -2.0]), ew=z, eh=z, dw=z,
                      dh=z, aw=z[:, 0, 0], bw=z[:, 0, 0], ah=z[:, 0, 0],
                      bh=z[:, 0, 0])
    assert ref.select(lanes) == 1


def test_small_cell_has_its_files():
    spec, wl, cfg, traffic, limits = small("pbmc68k.vb_pallas")
    assert cfg["data"]["n_genes"] == 128 and traffic["Itmax"] == 30
    assert "lml_rel" in limits["limits"]


def test_calibration_reads_program_and_control(monkeypatch, capsys):
    import json

    from nmfbench import calibrate, harness

    cut = small("pbmc68k.vb_pallas")
    monkeypatch.setattr(harness, "cell", lambda w: cut)
    calibrate.main(["--workload", "pbmc68k.vb_pallas", "--seeds", "3",
                    "--device", "cpu", "--detail"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = cut[4]["limits"]
    assert line["seed"] == 3 and len(line["ranks"]) == 2
    assert all(line["program"][k] <= v for k, v in limits.items())
    assert any(line["control"][k] > v for k, v in limits.items())
    assert set(line["detail"]) == {"program", "control"}
