"""BENCHMARK.json and the files it names keep to the benchmark's contract."""

import json
import re

import pytest

from harness import common

SPEC = json.loads((common.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24 and len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in METRICS] + [w["config"] for w in SPEC["workloads"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    assert all(_line(w["why"]) for w in SPEC["workloads"] + SPEC["configs"])
    assert all(_line(m["layer"]) for m in SPEC["per_layer"])
    assert all(_line(c["source"]) for c in SPEC["configs"])


def test_entries_have_only_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = common.load_cell(cell)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert hasattr(common.load_reader(m["name"]), "read")
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert c.config["reduced"] == next(x["reduced"] for x in SPEC["configs"]
                                       if x["file"].endswith(f"{c.config['name']}.json"))


def test_configuration_files_state_their_keys():
    for c in SPEC["configs"]:
        conf = json.loads((common.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert sorted(conf["overrides"]) == sorted(c["reduced"])


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moves = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", m["workloads"]))
