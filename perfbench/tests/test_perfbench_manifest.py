"""BENCHMARK.json keeps to the benchmark's contract, and every file a cell
names is found by name."""

import importlib
import json
import os
import re

import pytest

from perfbench import harness

MANIFEST = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_shape():
    assert set(MANIFEST) == KEYS
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    for key, allowed in ENTRY_KEYS.items():
        for entry in MANIFEST[key]:
            assert set(entry) - {"workloads"} <= allowed <= set(entry), (key, entry)


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(key):
    names = [e["name"] for e in MANIFEST[key]]
    assert len(names) == len(set(names))
    for entry in MANIFEST[key]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert _line(entry[text]), (entry["name"], text)


def test_configs_files_and_reductions():
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("perfbench/") and os.path.isfile(
            os.path.join(harness.ROOT, c["file"]))
        config = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"] == []
        assert config["source"] == c["source"]
    assert len({c["file"] for c in MANIFEST["configs"]}) == len(MANIFEST["configs"])


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_file_a_cell_names_is_found(workload):
    spec = harness.load_cell(workload)
    cell = next(w for w in MANIFEST["workloads"] if w["name"] == workload)
    assert cell["chips"] in (1, 4) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert harness.load_entry(spec["traffic"]["entry"]).build
    reported = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in reported, m["name"]
        assert harness.load_reader(m["name"]).read


def test_metrics_of_one_layer_share_its_name_and_each_moves_one_metric():
    end_to_end = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in end_to_end
        assert all(w in {x["name"] for x in MANIFEST["workloads"]} for w in m["workloads"])
    assert importlib.import_module("perfbench.peaks").HBM_BYTES_PER_S == 3.35e12
