"""BENCHMARK.json against the benchmark's contract, and every file that a
name in it leads to."""

from __future__ import annotations

import json
import re

import pytest

from portbench import common, harness

SPEC_PATH = common.CHECKOUT / "BENCHMARK.json"
SPEC = json.loads(SPEC_PATH.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_and_paths():
    assert set(SPEC) == TOP
    assert SPEC_PATH.stat().st_size <= 64 * 1024
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert SPEC["command"][1].startswith("portbench/")
    assert (common.CHECKOUT / SPEC["command"][1]).is_file()


def test_run_seconds_fit_the_check_with_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        body = json.loads((common.CHECKOUT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("name", CELLS)
def test_cells_find_their_files(name):
    cell = harness.Cell(SPEC, name)
    w = cell.workload
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _line(w["why"])
    assert cell.driver().Driver
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()
    for m in cell.per_layer():
        assert harness.load_reader(cell.root, m["name"])
        assert m["moves"] in e2e
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_cells_are_unique_pairs():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs) == len(set(CELLS))


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    allm = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in allm}) == len(allm)
    for m in allm:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in CELLS for c in m.get("workloads", CELLS))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
