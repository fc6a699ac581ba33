"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
BENCH = os.path.join(ROOT, "port_bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["port_bench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["command"][1:])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("section", list(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" or key == "layer" \
                    and key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert names == {"index_emb_per_s", "query_p95_ms", "queries_per_s",
                     "setup_s"}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] == 0.25 and "workloads" not in setup


def _reports(cell: str, section: str):
    return {m["name"] for m in SPEC[section]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = _reports(cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in SPEC["per_layer"]
              if cell in m.get("workloads", [cell])]
    assert layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], cell)


def test_per_layer_metrics_move_one_end_to_end_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"])
    assert all(len(layer) <= 200 for layer in by_layer)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    configs = {c["name"]: c for c in SPEC["configs"]}
    cfg = configs[w["config"]]
    assert cfg["file"].startswith("port_bench/")
    assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
    mix = json.load(open(os.path.join(BENCH, "traffic",
                                      w["traffic"] + ".json")))
    assert os.path.isfile(os.path.join(BENCH, "drivers",
                                       mix["driver"] + ".py"))
    limits = json.load(open(os.path.join(BENCH, "limits",
                                         w["name"] + ".json")))
    assert limits and all(v >= 0 for v in limits.values())
    assert w["chips"] == 1


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(section):
    for m in SPEC[section]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        assert os.path.isfile(path), path


def test_config_files_state_their_keys():
    for c in SPEC["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["compute_dtype"] == "float32"
        assert cfg["conv_precision"] == "highest"
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_config_is_used_and_pairs_are_unique():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel


def test_every_config_names_a_family_whose_module_exists():
    for c in SPEC["configs"]:
        family = json.load(open(os.path.join(ROOT, c["file"])))["family"]
        assert NAME.match(family), c["name"]
        assert os.path.isfile(os.path.join(BENCH, "families",
                                           family + ".py")), family


def _mixes():
    return {f[:-5]: json.load(open(os.path.join(BENCH, "traffic", f)))
            for f in sorted(os.listdir(os.path.join(BENCH, "traffic")))}


@pytest.mark.parametrize("name", sorted(_mixes()))
def test_arrivals_name_a_known_process_and_a_positive_rate(name):
    arrivals = _mixes()[name].get("arrivals")
    if arrivals is None:
        return
    assert set(arrivals) == {"process", "rate_per_s"}
    assert arrivals["process"] == "poisson"
    rate = arrivals["rate_per_s"]
    assert isinstance(rate, (int, float)) and rate > 0


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_a_cell_with_arrivals_does_not_report_queries_per_s(w):
    if "arrivals" in _mixes()[w["traffic"]]:
        assert "queries_per_s" not in _reports(w["name"], "end_to_end")
        assert "query_p95_ms" in _reports(w["name"], "end_to_end")
