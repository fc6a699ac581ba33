"""The port's ``reports`` CLI against the JAX package's, on result files
the port's own CLIs write: ``run_eval --dump_results`` (snippet retrieval,
both directions, and a reduced-split run for ``dset-size``), the server
and UMC servers' dump function (``audio_sheet_server.evaluate``, as the
four server CLIs call it), ``audio2sheet_align --dump_alignment`` and
``run_train``'s results curves, all on the synthetic corpus on the CPU.
Tolerance: none; each subcommand's rows and printed output are compared as
text."""

import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest

from audio_sheet_retrieval_tpu.cli import reports as jreports
from audio_sheet_retrieval_tpu_torch import assets
from audio_sheet_retrieval_tpu_torch.cli import (
    audio2sheet_align,
    reports,
    run_eval,
    run_train,
)
from audio_sheet_retrieval_tpu_torch.cli.audio_sheet_server import evaluate
from audio_sheet_retrieval_tpu_torch.models import configs as mconfigs

import torch_port_helpers  # noqa: F401  (one torch thread a test process)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """A directory of the port's result files under the JAX names."""
    out = str(tmp_path_factory.mktemp("reports"))
    ckpt = assets.asset_path("synth_serving_ckpt.pkl")

    def params(tag):
        path = os.path.join(out, "params_%s.pkl" % tag)
        shutil.copy(ckpt, path)
        return path

    common = ["--data", "synthetic", "--n_test", "24", "--device", "cpu",
              "--dump_results"]
    for tag, flips in (("all_split_mutopia_no_aug", ([], ["--V2_to_V1"])),
                       ("bach_split_mutopia_full_aug", ([],)),
                       ("all_split_25_mutopia_no_aug", (["--V2_to_V1"],))):
        p = params(tag)
        for flip in flips:
            run_eval.main(common + ["--param_file", p] + flip)
    # rank lists through the servers' dump function, as their CLIs call it
    rng = np.random.default_rng(0)
    pieces = ["piece_%02d" % i for i in range(12)]

    def detect(tp):
        order = list(rng.permutation(pieces))
        return order, list(np.linspace(1, 0, len(order)))

    p = params("all_split_mutopia_no_aug")
    for suffix in ("A2S.yaml", "S2A.yaml"):
        evaluate(pieces, detect, "scores", p, True, suffix)
    umc = params("umc")
    for ret_dir in ("A2S", "A2S_real", "S2A"):
        evaluate(pieces, detect, "scores", umc, True,
                 "umc_mozart_%s.yaml" % ret_dir, prefix="umc_retrieval_")
    audio2sheet_align.main(["--data", "synthetic", "--n_test_pieces", "2",
                            "--device", "cpu", "--param_file", p,
                            "--align_by", "pydtw", "--dump_alignment"])
    mconfigs.MODEL_REGISTRY["tiny_reports"] = dataclasses.replace(
        mconfigs.get_model_config("mutopia_ccal_cont_rsz", num_filters=4,
                                  dim_latent=8, batch_size=8, k_samples=16),
        name="tiny_reports")
    try:
        run_train.main(["--model", "tiny_reports", "--data", "synthetic",
                        "--device", "cpu", "--exp_root", out,
                        "--max_epochs", "2"])
    finally:
        del mconfigs.MODEL_REGISTRY["tiny_reports"]
    return out


def _both(capsys, argv):
    capsys.readouterr()
    got = reports.main(argv)
    got_out = capsys.readouterr().out
    want = jreports.main(argv)
    want_out = capsys.readouterr().out
    return got, want, got_out, want_out


@pytest.mark.parametrize("cmd", ["retrieval", "piece-retrieval",
                                 "dset-size", "umc-piece-retrieval"])
def test_table_subcommands_equal_jax(dumps, capsys, cmd):
    got, want, got_out, want_out = _both(capsys, [cmd, "--out_path", dumps])
    assert got == want and got_out == want_out
    # each table reads real files, not only the "-" of missing ones
    assert any(any(ch.isdigit() for ch in row.replace("num_pieces", ""))
               for row in got)


def test_retrieval_rows_hold_the_dumped_numbers(dumps):
    import yaml

    with open(os.path.join(
            dumps, "eval_all_split_mutopia_no_aug_S2A.yaml")) as fp:
        res = yaml.safe_load(fp)
    row = [r for r in reports.report_retrieval(dumps) if r.startswith(
        "none")][1]   # S2A rows come second
    cells = row.split(" & ")
    assert cells[-4:-1] == ["%.2f" % (res["recall_at_k"]["1"] / 100),
                            "%.2f" % (res["recall_at_k"]["25"] / 100),
                            "%.2f" % res["map"]]


def test_alignment_equals_jax(dumps, capsys):
    files = sorted(os.path.join(dumps, f) for f in os.listdir(dumps)
                   if f.startswith("alignment_res_"))
    assert files == [os.path.join(dumps,
                                  "alignment_res_all_split_mutopia_no_aug"
                                  "_pydtw.pkl")]
    got, want, got_out, want_out = _both(capsys, ["alignment"] + files)
    assert got == want and got_out == want_out and len(got) == 1
    with open(files[0], "rb") as fp:
        assert len(pickle.load(fp)) == 2


def test_curves_equal_jax(dumps, capsys):
    log = os.path.join(dumps, "tiny_reports", "results.pkl")
    got, want, got_out, want_out = _both(capsys, ["curves", log])
    assert got_out == want_out and "2 epochs" in got_out
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(np.asarray(got[key], dtype=object),
                                      np.asarray(want[key], dtype=object))
