"""Fixtures of the benchmark's tests.

``tiny_root``: a copy of ``BENCHMARK.json`` and ``port_bench/`` in a
temporary directory, every mix cut to a size the CPU runs in seconds (3
pieces, few excerpts, a small gallery), the checkpoint named by its
absolute path. Tests marked ``card`` need a CUDA card; the fixture
``card`` skips them where there is none.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"pieces": 3, "onsets_min": 12, "onsets_max": 20}
TINY_QUERIES = {"excerpts": 12, "windows": 12, "candidates": 10,
                "gallery_rows": 600, "distractor_block": 50}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped where there is none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return "cuda:0"


def make_tiny_root(dst: str) -> str:
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    os.path.join(dst, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = os.path.join(dst, "port_bench", "traffic")
    for name in os.listdir(traffic):
        path = os.path.join(traffic, name)
        with open(path) as fp:
            mix = json.load(fp)
        mix.update(TINY)
        mix.update({k: v for k, v in TINY_QUERIES.items() if k in mix})
        if "distractor_moments" in mix:
            mix["distractor_moments"] = os.path.join(
                ROOT, mix["distractor_moments"])
        with open(path, "w") as fp:
            json.dump(mix, fp)
    configs = os.path.join(dst, "port_bench", "configs")
    for name in os.listdir(configs):
        path = os.path.join(configs, name)
        with open(path) as fp:
            cfg = json.load(fp)
        if "checkpoint" in cfg["weights"]:
            cfg["weights"]["checkpoint"] = os.path.join(
                ROOT, cfg["weights"]["checkpoint"])
        with open(path, "w") as fp:
            json.dump(cfg, fp)
    return dst


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny_bench")))
