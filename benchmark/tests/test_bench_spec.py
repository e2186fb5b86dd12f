"""BENCHMARK.json against the format's limits on names, units and keys,
and the harness's files found by name."""

import json
import re

import pytest

from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                                   for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_units_and_keys(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
            assert len(e["why"]) <= 200


def test_every_metric_source_and_bound():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m and "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_each_cell_reports_what_its_per_layer_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        reported = {n for n, m in e2e.items() if cell["name"] in m.get("workloads",
                                                                     [cell["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", [])]
        assert layer, cell["name"]
        for m in layer:
            assert m["moves"] in reported, (cell["name"], m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"


def test_files_found_by_name():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert set(cfg["limits"]) and all(v >= 0 for v in cfg["limits"].values())
    for w in BENCH["workloads"]:
        traffic = json.loads((ROOT / "benchmark/traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark/drivers" / f"{traffic['driver']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark/metrics" / f"{m['name']}.py").is_file(), m["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
