"""Every CLI of the port parses to the JAX package's defaults (apart from
the port's own ``--device``): each ``main`` is stopped right after its
``parse_args`` on the required arguments only, in both packages."""

import argparse
import importlib

import pytest

import torch_port_helpers  # noqa: F401  (one torch thread a test process)

# CLI module -> its required arguments
CLIS = {
    "alignment_video": ["dump.pkl"],
    "audio2sheet_align": [],
    "audio_sheet_server": [],
    "export_msmd_npz": ["--train_split", "split.yaml", "--out_dir", "out"],
    "prepare_umc_data": ["--data_dir", "umc"],
    "refine_cca": [],
    "reports": ["curves", "results.pkl"],
    "run_eval": [],
    "run_train": [],
    "sheet_audio_server": [],
    "tutorial": [],
    "umc_a2s_server": ["--data_dir", "umc"],
    "umc_s2a_server": ["--data_dir", "umc"],
}


class _Parsed(Exception):
    pass


def _parsed_defaults(monkeypatch, module, argv) -> dict:
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def stop_after_parse(self, args=None, namespace=None):
        seen["args"] = vars(parse(self, args, namespace))
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        stop_after_parse)
    with pytest.raises(_Parsed):
        importlib.import_module(module).main(list(argv))
    monkeypatch.undo()
    return seen["args"]


def test_every_cli_is_ported():
    import os

    import audio_sheet_retrieval_tpu.cli as jcli
    import audio_sheet_retrieval_tpu_torch.cli as tcli

    def names(pkg):
        return sorted(f[:-3] for f in os.listdir(os.path.dirname(
            pkg.__file__)) if f.endswith(".py") and f != "__init__.py")

    assert names(tcli) == names(jcli) == sorted(CLIS)


@pytest.mark.parametrize("name", sorted(CLIS))
def test_parser_defaults_equal_jax(monkeypatch, name):
    argv = CLIS[name]
    want = _parsed_defaults(monkeypatch,
                            f"audio_sheet_retrieval_tpu.cli.{name}", argv)
    got = _parsed_defaults(monkeypatch,
                           f"audio_sheet_retrieval_tpu_torch.cli.{name}",
                           argv)
    assert got.pop("device", "cuda") == "cuda"   # the port runs on the card
    assert got == want
