"""``BENCHMARK.json`` against the benchmark's contract, and every name it
gives found as a file of the harness."""
import json
import re

import pytest

from harness.common import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    full = 2 + 14 * 24
    assert full * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in E2E_SOURCES and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


def _reporters(metric):
    return set(metric.get("workloads", [w["name"] for w in SPEC["workloads"]]))


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    assert metric["source"] in SOURCES
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    moved = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
    assert _reporters(metric) <= _reporters(moved)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell["name"] in _reporters(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in _reporters(m) for m in SPEC["per_layer"])
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
