"""Configurations name their model family (``families/<family>.py``): the
retrieval family gives both configurations the corpus, weights and model
they had before families were named, bit for bit; a family added as new
files runs through ``setup_cell`` and a whole run with no other file
changed; a configuration naming a family with no module fails with the
file's name."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY, add_toy_cells, make_tiny_root
from port_bench import harness

# Digests of what set-up made, recorded on the commit before families
# were named (its ``corpus.make_corpus`` and ``weights.*``, called
# directly) at ``a2s-library``'s mix cut to ``conftest.TINY``.
PARENT = {
    ("mutopia_ccal_cont_rsz", 5): ("2565c037e6335911", "39f288d8d5e44e4e",
                                   "1b05a3db33be84d5", "cd0dcb638e76601b"),
    ("mutopia_ccal_cont_rsz", 2**31 + 77): (
        "d1a3ddc8a5caf87f", "39f288d8d5e44e4e", "1b05a3db33be84d5",
        "cd0dcb638e76601b"),
    ("mutopia_ccal_cont", 5): ("2565c037e6335911", "3fc50fabaf97df91",
                               "1021a4a5a69c1efd", "1e1befdd80145855"),
    ("mutopia_ccal_cont", 2**31 + 77): (
        "d1a3ddc8a5caf87f", "3fc50fabaf97df91", "38db5f5cdf4dba4b",
        "cc6e74d29df4f5b1"),
}


def digest(obj) -> str:
    """A hash of every array's dtype, shape and bytes and of every other
    leaf's repr, in a fixed walk of dicts (sorted keys), sequences and
    modules (their state dicts)."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.nn.Module):
            walk(x.state_dict())
        elif isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            h.update(str(x.dtype).encode())
            walk((x.float() if x.dtype == torch.bfloat16 else x).numpy())
        elif isinstance(x, np.ndarray):
            h.update(f"{x.dtype}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(repr(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(f"{type(x).__name__}{len(x)}".encode())
            for e in x:
                walk(e)
        else:
            h.update(repr(x).encode())

    walk(obj)
    return h.hexdigest()[:16]


@pytest.mark.parametrize("config,seed", sorted(PARENT))
def test_the_retrieval_family_makes_what_it_made_before(config, seed):
    bench = harness.Bench(ROOT)
    c = bench.config(config)
    assert c["family"] == "retrieval"
    family = bench.family(c["family"])
    mix = dict(bench.mix("a2s-library"), **TINY)
    corpus = family.corpus(seed, mix)
    cfg = family.program_config(c)
    raw = family.raw_weights(c, seed, corpus, "cpu", ROOT)
    params = family.program_params(c, cfg, raw, "cpu", ROOT)
    assert tuple(digest(x) for x in (corpus, cfg, raw, params)) \
        == PARENT[config, seed]


def test_a_family_added_as_files_runs(tmp_path):
    root = make_tiny_root(str(tmp_path))
    before = add_toy_cells(root)
    bench = harness.Bench(root)
    drv, state, ctx = harness.setup_cell(bench, "toy-closed", 3, "cpu")
    assert ctx.cfg == {"scale": 0.5} and ctx.corpus.shape == (8, 4)
    assert torch.equal(state.w, torch.full((4,), 0.5))
    r = harness.run_cell(bench, "toy-closed", 3, 0.05, False, device="cpu")
    assert r["correct"] and r["attempted"] > 0, r
    assert set(r["metrics"]) == {"setup_s"}
    for rel, data in before.items():          # nothing there was edited
        with open(os.path.join(root, rel), "rb") as fp:
            now = fp.read()
        if rel == "BENCHMARK.json":
            old, new = json.loads(data), json.loads(now)
            assert {k: v for k, v in new.items()
                    if k not in ("configs", "workloads")} \
                == {k: v for k, v in old.items()
                    if k not in ("configs", "workloads")}
            for key in ("configs", "workloads"):
                assert new[key][:len(old[key])] == old[key]
        else:
            assert now == data, rel


def test_a_missing_family_module_names_the_file(tmp_path):
    root = make_tiny_root(str(tmp_path))
    add_toy_cells(root)
    path = os.path.join(root, "port_bench", "configs", "toy_model.json")
    with open(path) as fp:
        cfg = json.load(fp)
    with open(path, "w") as fp:
        json.dump(dict(cfg, family="nonesuch"), fp)
    with pytest.raises(FileNotFoundError,
                       match=r"port_bench/families/nonesuch\.py"):
        harness.setup_cell(harness.Bench(root), "toy-closed", 3, "cpu")
