"""An AST walk of every module the harness and the reference import,
first-party modules followed to their files: none may import JAX, Flax or
the JAX package (top-level names compared whole), and the reference may
import nothing of the program."""

from __future__ import annotations

import ast
import os
from typing import Dict, Set

import pytest

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "audio_sheet_retrieval_tpu"}
FIRST_PARTY = ("port_bench", "audio_sheet_retrieval_tpu_torch")
BENCH = os.path.join(ROOT, "port_bench")


def imported(path: str) -> Set[str]:
    """Every module name an import statement of ``path`` names, anywhere
    in the file (function bodies included)."""
    tree = ast.parse(open(path).read(), path)
    pkg = os.path.relpath(os.path.dirname(path), ROOT).replace(os.sep, ".")
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1]
                                + ([base] if base else []))
            names.add(base)
            names.update(f"{base}.{a.name}" for a in node.names)
    return names


def module_file(name: str):
    base = os.path.join(ROOT, *name.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def closure(paths) -> Dict[str, Set[str]]:
    """file -> the names it imports, over every first-party file reached."""
    seen, todo = {}, list(paths)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = imported(path)
        for name in seen[path]:
            if name.split(".")[0] in FIRST_PARTY:
                f = module_file(name)
                if f and f not in seen:
                    todo.append(f)
    return seen


def harness_files():
    out = []
    for dirpath, dirnames, files in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d not in ("tests",
                                                        "__pycache__")]
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_walk_finds_the_harness_and_the_program():
    files = closure(harness_files())
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert "port_bench/run.py" in rel and "port_bench/drivers/a2s.py" in rel
    assert "audio_sheet_retrieval_tpu_torch/retrieval/gallery.py" in rel
    assert any(r.startswith("port_bench/metrics/") for r in rel)


def test_nothing_imports_jax_or_the_jax_package():
    bad = {os.path.relpath(f, ROOT): sorted(
        n for n in names if n.split(".")[0] in BANNED)
        for f, names in closure(harness_files()).items()}
    assert {f: n for f, n in bad.items() if n} == {}


def test_the_reference_imports_nothing_of_the_program():
    ref = [os.path.join(BENCH, "reference", f)
           for f in os.listdir(os.path.join(BENCH, "reference"))
           if f.endswith(".py")]
    for f, names in closure(ref).items():
        tops = {n.split(".")[0] for n in names}
        assert not tops & (BANNED | {"audio_sheet_retrieval_tpu_torch"}), f
        assert os.path.relpath(f, ROOT).startswith("port_bench/reference")


@pytest.mark.parametrize("source,hit", [
    ("import jax.numpy as jnp", True),
    ("from jaxlib import xla_client", True),
    ("def f():\n    import audio_sheet_retrieval_tpu.ops", True),
    ("import audio_sheet_retrieval_tpu_torch", False),
    ("import jaxtyping", False),
])
def test_the_walk_compares_whole_top_level_names(tmp_path, source, hit):
    p = tmp_path / "m.py"
    p.write_text(source)
    assert bool({n.split(".")[0] for n in imported(str(p))} & BANNED) == hit
