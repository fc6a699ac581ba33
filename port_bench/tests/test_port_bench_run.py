"""Whole runs of every cell at a tiny size on the CPU (the look for a card
skipped): sound runs come out correct; the control (the reference in TF32
in the program's place) and each fault the cells can have, planted in the
program underneath the timed path, come out not correct against the
cells' own limits. A mix, a cell, a metric added as files only are found
and run. One test, marked ``card``, runs each cell through the command on
a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import harness

CELLS = ["rsz-index", "cont-index", "rsz-a2s-library", "cont-s2a",
         "rsz-a2s-open"]
QUERY_CELLS = ["rsz-a2s-library", "cont-s2a", "rsz-a2s-open"]
A2S_CELLS = ["rsz-a2s-library", "rsz-a2s-open"]
SEED = 2**31 + 77


def run(root, cell, seconds=0.3):
    return harness.run_cell(harness.Bench(root), cell, SEED, seconds, False,
                            device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in harness.Bench(
        tiny_root).metrics(cell, "end_to_end")}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    bench = harness.Bench(tiny_root)
    drv, state, _ = harness.setup_cell(bench, cell, SEED, "cpu")
    drv.release(state)
    ok, checks = harness.judge(
        drv.compare(drv.reference(state, "tf32"), drv.reference(state,
                                                                "f32")),
        harness.Bench(ROOT).limits(cell))
    assert not ok, checks


def _plant_index(monkeypatch, fault):
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy, gallery

    orig = accuracy.build_piece_gallery

    def broken(*a, **k):
        g = orig(*a, **k)
        if fault == "altered":
            g.gallery_n[len(g.ids) // 2, 0] += 0.01
        elif fault == "half":
            half = len(g.ids) // 2
            g = gallery.DeviceGallery(g.gallery_n[:half], g.ids[:half],
                                      device="cpu")
        elif fault == "unchanged":
            g.gallery_n.zero_()
        return g

    monkeypatch.setattr(accuracy, "build_piece_gallery", broken)


def _plant_query(monkeypatch, fault, cell):
    from audio_sheet_retrieval_tpu_torch.retrieval import gallery

    if fault == "half":
        name = ("embed_spec_excerpts" if cell in A2S_CELLS
                else "embed_strip_windows")
        orig = getattr(gallery, name)

        def half(*a):
            a = list(a)
            i = 4 if name == "embed_spec_excerpts" else 2
            a[i] = np.asarray(a[i])[: len(a[i]) // 2]
            return orig(*a)

        monkeypatch.setattr(gallery, name, half)
        return
    orig = gallery._vote_counts
    first = []

    def broken(*a):
        counts = orig(*a)
        if fault == "altered":   # every vote given to the runner-up
            top = int(torch.argmax(counts))
            other = torch.zeros_like(counts)
            other[(top + 1) % counts.numel()] = counts.sum()
            counts = other
        elif fault == "unchanged":
            first.append(counts)
            counts = first[0]
        return counts

    monkeypatch.setattr(gallery, "_vote_counts", broken)


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_are_not_correct(tiny_root, monkeypatch, cell, fault):
    if cell in QUERY_CELLS:
        _plant_query(monkeypatch, fault, cell)
    else:
        _plant_index(monkeypatch, fault)
    r = run(tiny_root, cell, seconds=0.5)
    assert not r["correct"], r["checks"]


def test_a_mix_cell_and_metric_added_as_files_are_found(tmp_path):
    from conftest import make_tiny_root

    root = make_tiny_root(str(tmp_path))
    bench_json = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(bench_json))
    spec["workloads"].append({"name": "dummy-cell",
                              "config": "mutopia_ccal_cont_rsz",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "a mix added as a data file"})
    spec["per_layer"].append({"name": "dummy_calls", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "gallery build",
                              "moves": "index_emb_per_s",
                              "workloads": ["dummy-cell"]})
    for m in spec["end_to_end"]:
        if m["name"] == "index_emb_per_s":
            m["workloads"].append("dummy-cell")
    json.dump(spec, open(bench_json, "w"))
    pb = os.path.join(root, "port_bench")
    mix = dict(json.load(open(os.path.join(pb, "traffic", "index.json"))),
               pieces=2, onsets_min=10, onsets_max=14)
    json.dump(mix, open(os.path.join(pb, "traffic", "dummy-mix.json"), "w"))
    json.dump({"code_gap": 1e-4, "id_mismatch": 0},
              open(os.path.join(pb, "limits", "dummy-cell.json"), "w"))
    with open(os.path.join(pb, "metrics", "dummy_calls.py"), "w") as fp:
        fp.write("def read(run):\n    return run.work['calls']\n")
    bench = harness.Bench(root)
    r = harness.run_cell(bench, "dummy-cell", 5, 0.2, False, device="cpu")
    assert r["correct"] and set(r["metrics"]) == {"index_emb_per_s",
                                                  "setup_s"}
    assert [m["name"] for m in bench.metrics("dummy-cell", "per_layer")] \
        == ["dummy_calls"]
    assert bench.reader("dummy_calls")(type("R", (), {"work": {
        "calls": 3}})) == 3


def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "rsz-index", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_command_refuses_to_run_without_the_port(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "rsz-index", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        cell, "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
