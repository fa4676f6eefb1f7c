"""BENCHMARK.json against the contract's shape, and every file a cell
names found by its name."""
from __future__ import annotations

import os
import re

import pytest

from benchmark.harness import common

BENCH = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = common.find_cell(w["name"], BENCH)
    assert cell.mix["kind"] and common.generator(cell.mix["kind"]).run
    assert os.path.isfile(os.path.join(common.BENCH_DIR, "limits", w["name"] + ".json"))
    for m in cell.end_to_end + cell.per_layer:
        assert callable(common.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.isfile(
            os.path.join(common.ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        names += [w["name"], w["traffic"]]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS and m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(open(os.path.join(common.ROOT, "BENCHMARK.json"), "rb").read()) <= 64 * 1024


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])
