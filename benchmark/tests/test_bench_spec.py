"""BENCHMARK.json against the rules of its format, and every file it names."""

import json
import re

import pytest

from benchmark import harness

from .conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_are_the_formats():
    assert set(SPEC) == KEYS["top"]
    for kind, group in (("config", "configs"), ("workload", "workloads"),
                        ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        for entry in SPEC[group]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert KEYS[kind] <= set(entry) <= KEYS[kind] | extra, entry["name"]


@pytest.mark.parametrize("name", [e["name"] for g in ("configs", "workloads", "end_to_end",
                                                      "per_layer") for e in SPEC[g]]
                         + [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
                         + [k for c in SPEC["configs"] for k in c["reduced"]])
def test_names_use_the_allowed_characters(name):
    assert NAME.fullmatch(name)
    assert harness.NAME.fullmatch(name)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader_that_agrees(metric):
    assert UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    mod = harness.load_module("metrics", metric["name"])
    assert mod.UNIT == metric["unit"]
    assert mod.read({}) is None  # nothing to read, nothing reported
    if "layer" in metric:
        assert mod.LAYER == metric["layer"] and _line(metric["layer"])
        assert mod.MOVES == metric["moves"]
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25


def test_cells_report_setup_another_end_to_end_metric_and_a_layer():
    names = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(SPEC, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(SPEC, w["name"], True)
        assert w["chips"] in (1, 4) and _line(w["why"])
        for m in harness.cell_metrics(SPEC, w["name"], True):
            assert m["moves"] in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", names)) <= names


def test_every_named_file_is_under_paths():
    assert SPEC["paths"] == ["benchmark"]
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "benchmark" / "drivers" / f"{cfg['driver']}.py").is_file()
        assert _line(c["source"]) and c["source"].startswith("https://")
    for w in SPEC["workloads"]:
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()


def test_file_names_use_the_characters_of_names():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or ".cache" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
