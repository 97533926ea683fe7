"""BENCHMARK.json against the benchmark's contract: keys, characters and
limits of every entry, every name found as a file, and every per-layer
metric moving an end-to-end metric that each of its cells reports."""

import json
import os
import re

import pytest

import harness

BENCH_PATH = os.path.join(harness.ROOT, "BENCHMARK.json")
BENCH = harness.load_json(BENCH_PATH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(BENCH_PATH) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    files = [w for w in BENCH["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in BENCH["paths"]) for f in files)
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43_200


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        group_names = [g["name"] for g in group]
        assert len(group_names) == len(set(group_names))
        assert all(NAME.match(n) for n in group_names)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_setup_s_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if reported(m, cell)]
    layer = [m["name"] for m in BENCH["per_layer"] if reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_of_its_cells_reports(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    assert "workloads" in metric and metric["workloads"]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert reported(e2e[metric["moves"]], cell)
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"]:
        assert metric["unit"] == "%"


def test_each_name_is_found_as_a_file():
    here = harness.HERE
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics", m["name"] + ".py")), m["name"]
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(here, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(here, "limits", w["name"] + ".json"))
        harness.Cell(w["name"])


def test_layers_match_perf_md():
    with open(os.path.join(harness.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert layer in perf


def test_files_under_paths_use_name_characters():
    for p in BENCH["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(harness.ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
                assert PATH.match(rel), rel
    json.dumps(BENCH)
