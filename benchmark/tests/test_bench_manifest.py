"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from benchmark.manifest import ROOT as REPO, Manifest

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16


def test_entries_have_only_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    man = Manifest()
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in man.metrics(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.metrics(w["name"], True)


def test_layer_metrics_move_a_metric_their_cells_report():
    man = Manifest()
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            reported = [e["name"] for e in man.metrics(cell, False)]
            assert m["moves"] in reported, (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_a_cell_names_is_found(cell):
    man = Manifest()
    w = man.cell(cell)
    conf = man.config(w["config"])
    kind = man.entry(conf["entry"])
    assert kind.unit and kind.root
    for name in ("schedule", "warm", "call", "spans", "reference", "units"):
        assert callable(getattr(kind, name))
    mix = man.mix(w["traffic"])
    assert hasattr(man.generator(mix), "make")
    assert man.limits(cell)
    for trace in (False, True):
        for m in man.metrics(cell, trace):
            assert callable(man.reader(m["name"], trace))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_holds_every_pipeline_key(config):
    from icpflow_tpu_torch import config_from_dict
    d = json.loads((REPO / config["file"]).read_text())
    cfg = config_from_dict(d["pipeline"])
    assert set(d["pipeline"]) == {f.name for f in dataclasses.fields(cfg)}
    assert sorted(d["reduced"]) == sorted(config["reduced"])
    assert set(d["changed"]) == set(d["reduced"])
