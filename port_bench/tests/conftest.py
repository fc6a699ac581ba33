"""Fixtures of the benchmark's tests.

``tiny_root``: a copy of ``BENCHMARK.json`` and ``port_bench/`` in a
temporary directory, every mix cut to a size the CPU runs in seconds (3
pieces, few excerpts, a small gallery), the checkpoint named by its
absolute path. ``add_toy_cells``: a model family, a configuration and two
cells (closed and open loop) of a toy model added to such a copy as new
files only. Tests marked ``card`` need a CUDA card; the fixture ``card``
skips them where there is none.
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


TOY_FAMILY = '''"""A model family of one weight vector, for the harness's tests."""

import numpy as np
import torch


def corpus(seed, mix):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((mix["rows"], 4)).astype(np.float32)


def program_config(config):
    return {"scale": float(config["scale"])}


def raw_weights(config, seed, corpus, device, root):
    return {"w": np.full(4, config["scale"], np.float32)}


def program_params(config, cfg, raw, device, root):
    return torch.as_tensor(raw["w"], device=device)
'''

TOY_DRIVER = '''"""Row sums of the toy family's corpus; each call spins for the mix's
``service_s``, so that a test knows how long a call takes."""

import time
from types import SimpleNamespace

import numpy as np
import torch


def setup(ctx):
    return SimpleNamespace(x=torch.as_tensor(ctx.corpus), w=ctx.params,
                           raw=ctx.raw, corpus=ctx.corpus,
                           service_s=ctx.mix["service_s"])


def call(state):
    end = time.perf_counter() + state.service_s
    out = (state.x * state.w).sum(1).numpy()
    while time.perf_counter() < end:
        pass
    return out


def keep(answer):
    return answer


def work(state, answers):
    return {"calls": len(answers), "queries": len(answers)}


def produced(state, answers):
    return answers


def release(state):
    state.w = None


def reference(state, precision):
    return state.corpus @ state.raw["w"]


def compare(prod, ref):
    return {"gap": max(float(np.abs(a - ref).max()) for a in prod)}
'''


def add_toy_cells(root: str, service_s: float = 0.005,
                  rate_per_s: float = 100.0) -> dict:
    """A configuration of the toy family and two cells of it, closed
    (``toy-closed``) and open (``toy-open``), added to the copy of the
    benchmark at ``root`` as new files and appended entries only ->
    {relative path: bytes} of every file that was there before."""
    before = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fp:
                before[os.path.relpath(path, root)] = fp.read()
    pb = os.path.join(root, "port_bench")
    with open(os.path.join(pb, "families", "toy.py"), "w") as fp:
        fp.write(TOY_FAMILY)
    with open(os.path.join(pb, "drivers", "toy.py"), "w") as fp:
        fp.write(TOY_DRIVER)
    with open(os.path.join(pb, "configs", "toy_model.json"), "w") as fp:
        json.dump({"name": "toy_model", "family": "toy", "scale": 0.5}, fp)
    mix = {"driver": "toy", "rows": 8, "service_s": service_s}
    for name, extra in (("toy-closed", {}),
                        ("toy-open", {"arrivals": {
                            "process": "poisson",
                            "rate_per_s": rate_per_s}})):
        with open(os.path.join(pb, "traffic", name + ".json"), "w") as fp:
            json.dump(dict(mix, **extra), fp)
        with open(os.path.join(pb, "limits", name + ".json"), "w") as fp:
            json.dump({"gap": 1e-5}, fp)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fp:
        spec = json.load(fp)
    spec["configs"].append({"name": "toy_model", "source": "a test",
                            "file": "port_bench/configs/toy_model.json",
                            "reduced": [], "why": "a test"})
    for name in ("toy-closed", "toy-open"):
        spec["workloads"].append({"name": name, "config": "toy_model",
                                  "traffic": name, "chips": 1,
                                  "why": "a test"})
    with open(path, "w") as fp:
        json.dump(spec, fp)
    return before
