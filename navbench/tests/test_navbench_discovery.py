"""BENCHMARK.json and the files it names: every configuration, traffic
mix, driver and per-layer reader is found by name, within the contract's
limits."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from navbench import run as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return R.load_json(R.ROOT / "BENCHMARK.json")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["navbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((R.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_one_line_fields(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k], e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell, config, traffic = R.cell_files(bench, w["name"])
        assert config["name"] == w["config"]
        importlib.import_module(f"navbench.drivers.{traffic['driver']}")
        e2e = {m["name"] for m in R.reported_e2e(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert R.reported_per_layer(bench, w["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_per_layer_metric_has_a_reader(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(R.metric_reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_hold_their_limits(bench):
    for conf in bench["configs"]:
        c = json.loads((R.ROOT / conf["file"]).read_text())
        assert c["reduced"] == conf["reduced"]
        assert all(v >= 0 for v in c["limits"].values())
