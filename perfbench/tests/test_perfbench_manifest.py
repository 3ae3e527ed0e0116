"""BENCHMARK.json against the benchmark's rules: names, units, keys, the
files each entry names, and the metrics each cell reports."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_tok)")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and FILE.match(c["file"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        model = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "perfbench" / "models"
                / f"{model['family']}.py").is_file()
        assert (ROOT / "perfbench" / "reference"
                / f"{model['family']}.py").is_file()


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    assert 1 <= len(BENCH["workloads"]) <= 24
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "cells" / f"{w['name']}.json").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e_names = {m["name"] for m in e2e}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e_names and _line(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


def _reports(cell, kind):
    return [m for m in BENCH[kind]
            if "workloads" not in m or cell in m["workloads"]]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports(cell):
    e2e = {m["name"] for m in _reports(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = _reports(cell, "per_layer")
    assert layer
    for m in layer:
        # the metric it moves is reported in this cell
        assert m["moves"] in e2e, (cell, m["name"])
    names = {m["name"] for m in layer}
    assert any("mfu" in n for n in names)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    d = ROOT / "perfbench" / "metrics"
    assert (d / f"{metric}.py").is_file() or (
        d / f"{metric.split('.')[0]}.py").is_file()


def test_file_names_under_paths():
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert FILE.match(rel) and len(rel) <= 200, rel
