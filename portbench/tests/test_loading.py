"""BENCHMARK.json, and every configuration, mix, entry, generator and
metric reader it names, load by name; names and units keep to the rules."""

import re

import pytest

from tiny import BENCH, CELLS, RAW, REPO, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(RAW) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert RAW["paths"] == ["portbench"]
    assert 1 <= RAW["run_seconds"] <= 51
    used = {w["config"] for w in RAW["workloads"]}
    assert used == {c["name"] for c in RAW["configs"]}
    assert all(m["workloads"] and set(m["workloads"]) <= {w["name"] for w in RAW["workloads"]}
               for m in RAW["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = harness.Cell.load(BENCH, name)
    assert harness.load_module("entries", cell.traffic["entry"])
    assert harness.load_module("corpora", cell.config["corpus"]["generator"])
    assert cell.end_to_end and cell.per_layer
    assert {"setup_s", "qps", "p95_ms", "device_mem_gib"} <= {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("metric", sorted({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}))
def test_metric_reader_loads(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in RAW["end_to_end"] + RAW["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] == 1


def test_config_files():
    for c in BENCH["configs"]:
        cfg = harness.load_json(REPO / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["source"]) <= 200
        assert c["file"].startswith("portbench/configs/")
