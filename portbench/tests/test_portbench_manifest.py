"""BENCHMARK.json against the benchmark's contract: names, units and
files, every cell's files found by name, and every per-layer metric read
where the end-to-end metric it moves is reported."""

from __future__ import annotations

import json
import re

import pytest

from portbench.tests._tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in MAN["paths"])
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert (ROOT / MAN["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_setup_metric_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all("bound" in m for m in MAN["end_to_end"])
    assert not any("bound" in m for m in MAN["per_layer"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_resolve_by_name(cell):
    from portbench.core import bench

    c = bench.load_cell(cell["name"], ROOT)
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert c.driver.run is not None
    assert set(c.spec["limits"]) and all(
        isinstance(v, (int, float)) for v in c.spec["limits"].values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    moved = e2e[metric["moves"]]
    cells = {w["name"] for w in MAN["workloads"]}
    reporting = set(moved.get("workloads", cells))
    assert set(metric["workloads"]) <= reporting
    assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").is_file()
    assert 1 <= len(metric["layer"]) <= 200


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    path = ROOT / config["file"]
    assert config["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert config["source"].startswith("https://")
    assert len(config["reduced"]) <= 16
    assert all(NAME.match(k) for k in config["reduced"])


def test_every_configuration_is_used():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
