"""BENCHMARK.json keeps to the benchmark's contract, and everything it
names is found by name: each configuration's file and scene recipe, each
traffic mix and its frame-loop driver, each per-layer metric's reader."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("entry", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_config_found(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"])
    path = os.path.join(ROOT, entry["file"])
    cfg = json.load(open(path))
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert os.path.exists(os.path.join(BENCH, "scenes",
                                       cfg["recipe"] + ".py"))
    assert 1 <= len(entry["source"]) <= 200 and 1 <= len(entry["why"]) <= 200


@pytest.mark.parametrize("entry", BENCHMARK["workloads"],
                         ids=lambda w: w["name"])
def test_workload_found(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.fullmatch(entry["name"]) and entry["chips"] == 1
    assert entry["config"] in {c["name"] for c in BENCHMARK["configs"]}
    traffic = json.load(open(os.path.join(BENCH, "traffic",
                                          entry["traffic"] + ".json")))
    assert os.path.exists(os.path.join(BENCH, "loops",
                                       traffic["app"] + ".py"))
    assert len(entry["why"]) <= 200
    assert set(traffic["limits"]) and all(
        v >= 0 for v in traffic["limits"].values())


@pytest.mark.parametrize("entry", BENCHMARK["end_to_end"]
                         + BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_metric_found(entry):
    assert NAME.fullmatch(entry["name"]) and UNIT.fullmatch(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    assert set(entry.get("workloads", [])) <= cells
    if "bound" in entry:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
        assert set(entry) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
    else:
        assert set(entry) == {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
        assert entry["moves"] in {m["name"] for m in BENCHMARK["end_to_end"]}
    import harness

    assert os.path.exists(os.path.join(
        BENCH, "metrics", harness.reader_of(entry["name"]) + ".py"))


def test_every_cell_reports_enough():
    import harness

    for w in BENCHMARK["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(BENCHMARK, w["name"],
                                                     False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = harness.metrics_of(BENCHMARK, w["name"], True)
        assert per_layer and {m["moves"] for m in per_layer} <= e2e
    assert {w["config"] for w in BENCHMARK["workloads"]} == {
        c["name"] for c in BENCHMARK["configs"]}
