"""BENCHMARK.json against the benchmark's contract, and the files it
names against the folder."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + list(CELLS) + [c["name"] for c in BENCH["configs"]])
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name)


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_sources(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert len(e2e) - 1 <= 4
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_moves_one_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert isinstance(metric["moves"], str) and metric["moves"] in e2e
    assert metric["workloads"]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert reports(cell, e2e[metric["moves"]])
    assert (ROOT / "port_bench" / "metrics" / f"{metric['name']}.py") \
        .exists()
    assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_one_layer_name_per_layer():
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


@pytest.mark.parametrize("cell", list(CELLS))
def test_cells(cell):
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    wl = json.loads((ROOT / "port_bench" / "workloads"
                     / f"{w['traffic']}.json").read_text())
    assert wl["config"] == w["config"] and wl.get("chips", 1) == w["chips"]
    assert (ROOT / "port_bench" / "drivers" / f"{wl['driver']}.py").exists()
    e2e = [m for m in BENCH["end_to_end"] if reports(cell, m)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(reports(cell, m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("port_bench/configs/")
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in CELLS.values())


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_are_few():
    four = [w for w in CELLS.values() if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
