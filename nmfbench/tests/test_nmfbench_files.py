"""``BENCHMARK.json`` and every file it names load, by name, and keep to
the benchmark's contract where a file can show it."""

import json
import re

import pytest

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["nmfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_loads_by_name(cfg):
    assert NAME.match(cfg["name"])
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("nmfbench/configs/")
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert set(cfg["reduced"]) <= set(body["reduced"])
    assert 1 <= len(cfg["source"]) <= 200 and "\n" not in cfg["source"]
    for k in ("n_genes", "n_cells", "rank", "density"):
        assert k in body["data"]


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files_load_by_name(wl):
    from nmfbench import harness

    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"])
    assert wl["chips"] in (1, 4) and len(wl["why"]) <= 200
    spec, w, cfg, traffic, limits = harness.cell(wl["name"])
    assert w == wl
    assert traffic["Tol"] == 0.0 and traffic["entry"] == "vb_factorize"
    assert all(v > 0 for v in limits["limits"].values())


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_its_reader(m):
    from nmfbench import harness

    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(harness.metric_reader(m["name"]))
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert m["layer"] and "\n" not in m["layer"]
