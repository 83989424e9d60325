"""The benchmark's files hold together: every cell names a configuration,
an entry and a scene that exist, every name and unit keeps to the
allowed characters, and every per-layer metric has a reader and is reported
by the cells it lists."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def names():
    yield from ((c["name"], "config") for c in BENCH["configs"])
    yield from ((w["name"], "workload") for w in BENCH["workloads"])
    yield from ((w["config"], "config of a workload") for w in BENCH["workloads"])
    yield from ((w["traffic"], "traffic") for w in BENCH["workloads"])
    yield from ((m["name"], "metric") for m in METRICS)
    yield from ((k, "reduced key") for c in BENCH["configs"] for k in c["reduced"])


@pytest.mark.parametrize("name,what", list(names()))
def test_names_use_allowed_characters(name, what):
    assert NAME.match(name), f"{what} {name!r}"


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_units_and_directions(metric):
    m = next(m for m in METRICS if m["name"] == metric)
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names)), names


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(p and not p.startswith("/") and ".." not in p for p in BENCH["paths"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_workload_files_name_existing_pieces(cell):
    w = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["config"] == entry["config"]
    assert (harness.HERE / "configs" / f"{w['config']}.json").is_file()
    assert (harness.HERE / "entries" / f"{w['entry']}.py").is_file()
    assert (harness.HERE / "scenes" / f"{w['scene']}.json").is_file()
    assert w["why"] and w["check"]["limits"]
    assert entry["chips"] == 1


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    c = next(x for x in BENCH["configs"] if x["name"] == config)
    assert c["file"] == f"benchmark/configs/{config}.json"
    data = harness.load_json(harness.ROOT / c["file"])
    assert data["name"] == config and data["source"] == c["source"]
    assert data["reduced"] == c["reduced"]
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_reader_and_its_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert (harness.HERE / "metrics" / f"{metric}.py").is_file()
    moves = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moves.get("workloads", [cell]), f"{cell} does not report {m['moves']}"
        assert m in harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


def test_layers_of_one_name_are_spelt_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for a in layers:
        for b in layers - {a}:
            assert a.split(" (")[0] != b.split(" (")[0], (a, b)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
