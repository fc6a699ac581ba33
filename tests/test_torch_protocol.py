"""The port's protocol layer (``scripts/torch_full_protocol.py`` and the
``scripts/torch_*.sh`` sweeps) against the JAX side's
(``scripts/full_protocol.py``, ``scripts/*.sh``), with a tiny registered
model (4 filters, an 8-D latent) on the CPU.

The two scripts train different models (the port initialises from a
``torch.Generator``, JAX from a ``PRNGKey``), so the port's script is held
to JAX through its artefacts:

  * the npz export and split yaml: identical, array for array;
  * JAX's ``run_eval --estimate_UV`` over the port's refined dumps (which
    the port writes in the JAX package's format): hits within 1 at every k
    and MRR within 1e-3 of the port's eval yamls (float32 products in
    another order may swap two neighbours at a near-tie), both ways;
  * JAX's ``reports retrieval`` over the port's yamls: the port's table
    text for text;
  * each ``scripts/torch_*.sh``: JAX's script with the CLI module prefix
    replaced, and nothing else.
"""

import dataclasses
import difflib
import glob
import importlib.util
import os
import shutil
import subprocess

import numpy as np
import pytest
import yaml

from audio_sheet_retrieval_tpu.models import configs as jconfigs
from audio_sheet_retrieval_tpu.utils import profiling as jprofiling
from audio_sheet_retrieval_tpu_torch.models import configs as tconfigs
import torch_port_helpers  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_filters=4, dim_latent=8, batch_size=8, k_samples=32,
            patience=0, refinement_steps=1, refinement_patience=0,
            max_epochs=2)
# the JAX side's tiny sizes (tests/test_cli_workflow.py)
SIZES = ["--model", "tiny_test", "--n_train_pieces", "3",
         "--n_valid_pieces", "2", "--n_test_pieces", "2", "--n_onsets", "40",
         "--max_epochs", "1", "--n_test", "40", "--n_refine", "80",
         "--compute_dtype", "float32"]
SH_SCRIPTS = ["train_models", "eval_models", "train_models_dset_size",
              "eval_models_dset_size", "eval_piece_retrieval",
              "eval_piece_retrieval_umc", "eval_audio2sheet_align"]
PREFIX = ("audio_sheet_retrieval_tpu.cli.", "audio_sheet_retrieval_tpu_torch.cli.")
EVAL_HITS_SLACK = 1
EVAL_MRR_ATOL = 1e-3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jprotocol = _script("full_protocol")
tprotocol = _script("torch_full_protocol")


def _register_tiny(mp):
    """The tiny model in both packages' registries, undone on exit."""
    for configs in (jconfigs, tconfigs):
        cfg = dataclasses.replace(configs.get_model_config(
            "mutopia_ccal_cont_rsz", **TINY), name="tiny_test")
        mp.setitem(configs.MODEL_REGISTRY, "tiny_test", cfg)
    # the JAX scripts' compile cache is process-wide state
    mp.setattr(jprofiling, "enable_compile_cache", lambda *a, **k: None)


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """The port's protocol, one regime -> (its output, JAX's eval yamls over
    a copy of its experiment root, JAX's ``reports`` rows over the port's
    yamls)."""
    from audio_sheet_retrieval_tpu.cli import reports as jreports
    from audio_sheet_retrieval_tpu.cli import run_eval as jrun_eval

    work = str(tmp_path_factory.mktemp("protocol"))
    with pytest.MonkeyPatch.context() as mp:
        _register_tiny(mp)
        out = tprotocol.main(SIZES + ["--device", "cpu", "--workdir", work,
                                      "--regimes", "mutopia_no_aug"])
        jexp = os.path.join(work, "jax_exp")
        shutil.copytree(os.path.join(work, "exp"), jexp)
        for path in glob.glob(os.path.join(jexp, "*_est_UV", "eval_*")):
            os.remove(path)
        npz_dir = os.path.join(work, "npz")
        for dir_flag in ([], ["--V2_to_V1"]):
            jrun_eval.main([
                "--model", "tiny_test", "--data", f"npz:{npz_dir}",
                "--train_split", os.path.join(npz_dir, "all_split.yaml"),
                "--exp_root", jexp, "--config",
                os.path.join(REPO, "exp_configs", "mutopia_no_aug.yaml"),
                "--estimate_UV", "--dump_results", "--n_test", "40"]
                + dir_flag)
        jrows = jreports.main(["retrieval", "--out_path", os.path.join(
            work, "exp", "tiny_test_est_UV")])
    return out, os.path.join(jexp, "tiny_test_est_UV"), jrows


def test_export_synthetic_npz_equals_jax(tmp_path):
    args = (31, 3, 2, 2, 2, 40)
    jsplit = jprotocol.export_synthetic_npz(str(tmp_path / "jax"), *args)
    tsplit = tprotocol.export_synthetic_npz(str(tmp_path / "port"), *args)
    with open(jsplit) as a, open(tsplit) as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len([n for n in names if n.endswith(".npz")]) == 7
    for name in names:
        if not name.endswith(".npz"):
            continue
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files), name
            for key in a.files:
                assert a[key].dtype == b[key].dtype, (name, key)
                np.testing.assert_array_equal(a[key], b[key])


def test_constants_and_flags_equal_jax():
    assert tprotocol.REGIMES == jprotocol.REGIMES
    tparser = tprotocol.build_arg_parser()
    assert tparser.get_default("device") == "cuda"
    for flag, default in (("n_train_pieces", 60), ("n_valid_pieces", 10),
                          ("n_test_pieces", 12), ("n_performances", 2),
                          ("n_onsets", 200), ("max_epochs", 25),
                          ("n_test", 1000), ("n_refine", 25000),
                          ("compute_dtype", "bfloat16"), ("seed", 31),
                          ("workdir", None),
                          ("model", "mutopia_ccal_cont_rsz"),
                          ("regimes", ",".join(jprotocol.REGIMES))):
        assert tparser.get_default(flag) == default, flag


def test_protocol_fills_its_regime(protocol):
    out = protocol[0]
    assert set(out) == {"workdir", "timings", "total_s", "table"}
    assert set(out["timings"]) == {"export_s", "mutopia_no_aug_s", "eval_s"}
    assert len(out["table"]) == 8
    filled = [r for r in out["table"]
              if not r.endswith("- & - & - & - \\\\")]
    assert len(filled) == 2
    for row in filled:
        assert row.count("&") == 12 and row.startswith("none")
    npz_dir = os.path.join(out["workdir"], "npz")
    assert len([f for f in os.listdir(npz_dir) if f.endswith(".npz")]) == 7


@pytest.mark.parametrize("direction", ["S2A", "A2S"])
def test_jax_run_eval_over_the_ports_dumps(protocol, direction):
    out, jdir = protocol[0], protocol[1]
    name = f"eval_all_split_mutopia_no_aug_{direction}.yaml"
    with open(os.path.join(out["workdir"], "exp", "tiny_test_est_UV",
                           name)) as fp:
        got = yaml.safe_load(fp)
    with open(os.path.join(jdir, name)) as fp:
        want = yaml.safe_load(fp)
    assert abs(got["map"] - want["map"]) <= EVAL_MRR_ATOL
    assert sorted(got["recall_at_k"]) == sorted(want["recall_at_k"])
    for k, pct in want["recall_at_k"].items():
        hits = round(pct * 40 / 100)
        assert abs(round(got["recall_at_k"][k] * 40 / 100) - hits) \
            <= EVAL_HITS_SLACK, k


def test_jax_reports_reproduce_the_ports_table(protocol):
    assert protocol[2] == protocol[0]["table"]


@pytest.mark.parametrize("name", SH_SCRIPTS)
def test_sh_sweeps_differ_only_in_the_module_prefix(name):
    jpath = os.path.join(REPO, "scripts", name + ".sh")
    tpath = os.path.join(REPO, "scripts", "torch_" + name + ".sh")
    subprocess.run(["bash", "-n", tpath], check=True)
    with open(jpath) as a, open(tpath) as b:
        want, got = a.read(), b.read()
    assert PREFIX[0] in want
    assert PREFIX[0] not in got
    assert got == want.replace(*PREFIX)
    changed = [ln for ln in difflib.ndiff(want.splitlines(),
                                         got.splitlines())
               if ln.startswith("+ ")]
    assert changed and all(PREFIX[1] in ln for ln in changed)
    assert os.access(tpath, os.X_OK) == os.access(jpath, os.X_OK)


@pytest.mark.slow
def test_both_protocol_scripts_fill_the_same_table(tmp_path):
    """JAX's protocol beside the port's on two regimes: the same rows
    filled, the same number of cells."""
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        _register_tiny(mp)
        for name, main, extra in (("jax", jprotocol.main, []),
                                  ("port", tprotocol.main,
                                   ["--device", "cpu"])):
            outs[name] = main(SIZES + extra + [
                "--workdir", str(tmp_path / name),
                "--regimes", "mutopia_no_aug,mutopia_full_aug"])
    shape = {name: [(r.split(" ")[0], r.count("&"),
                     r.endswith("- & - & - & - \\\\"))
                    for r in out["table"]] for name, out in outs.items()}
    assert shape["port"] == shape["jax"]
    assert sum(not empty for _, _, empty in shape["port"]) == 4
