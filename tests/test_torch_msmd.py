"""The port's real-MSMD loader (``data/msmd.py``), its export CLI, the
``mutopia`` pools and the audio readers against the JAX package's, on the
CPU, over the ``msmd`` stub the repo carries (``tests/msmd_stub``: the
Piece / Score / mungo / alignment surface the loader reads, pieces made
from a hash of their name).

Tolerances: none. The loader, the pools and the readers are numpy (and the
same native decoder library, read by path), and the DSP fallback of a
performance without a spectrogram runs ``AudioProcessor.process_host``,
which ``tests/test_torch_audio.py`` already holds to the JAX package's bit
for bit: images, spectrograms, onset maps, exported arrays, pool entities
and batches are compared with ``assert_array_equal``.
"""

import os
import sys

import numpy as np
import pytest
import yaml

from audio_sheet_retrieval_tpu import assets as jassets
from audio_sheet_retrieval_tpu import config as jconfig
from audio_sheet_retrieval_tpu.cli import export_msmd_npz as jexport
from audio_sheet_retrieval_tpu.data import msmd as jmsmd
from audio_sheet_retrieval_tpu.data import pools as jpools
from audio_sheet_retrieval_tpu.utils import audio_io as jaudio
from audio_sheet_retrieval_tpu_torch import config as tconfig
from audio_sheet_retrieval_tpu_torch.cli import export_msmd_npz as texport
from audio_sheet_retrieval_tpu_torch.data import msmd as tmsmd
from audio_sheet_retrieval_tpu_torch.data import pools as tpools
from audio_sheet_retrieval_tpu_torch.utils import audio_io as taudio

import torch_port_helpers  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(REPO, "tests", "msmd_stub")
COLLECTION = "/fake/collection"   # the stub seeds its pieces from it
FULL_AUGMENT_YAML = os.path.join(REPO, "exp_configs", "mutopia_full_aug.yaml")


def _drop_msmd(monkeypatch):
    for mod in [m for m in sys.modules if m == "msmd" or m.startswith("msmd.")]:
        monkeypatch.delitem(sys.modules, mod)


@pytest.fixture()
def msmd_stub(monkeypatch):
    monkeypatch.syspath_prepend(STUB)
    _drop_msmd(monkeypatch)   # the stub wins over any imported msmd
    monkeypatch.setattr(jconfig, "DATA_ROOT_MSMD", COLLECTION)
    monkeypatch.setattr(tconfig, "DATA_ROOT_MSMD", COLLECTION)
    yield
    for mod in [m for m in sys.modules if m == "msmd" or m.startswith("msmd.")]:
        sys.modules.pop(mod, None)


def assert_pieces_equal(got, want):
    (gi, gs, go), (wi, ws, wo) = got, want
    assert gi.dtype == wi.dtype
    np.testing.assert_array_equal(gi, wi)
    assert len(gs) == len(ws) and len(go) == len(wo) == len(ws)
    for a, b in zip(gs + go, ws + wo):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_config_and_augment_constants_match_jax():
    assert tconfig.DATA_ROOT_MSMD == jconfig.DATA_ROOT_MSMD
    assert tpools.NO_AUGMENT == jpools.NO_AUGMENT


@pytest.mark.parametrize("augment", ["NO_AUGMENT", "FULL_AUGMENT"])
@pytest.mark.parametrize("piece", ["StubPiece_A", "StubPiece_Ragged",
                                   "StubPiece_NoAlign"])
def test_prepare_piece_data_msmd_bit_for_bit(msmd_stub, capsys, piece,
                                             augment):
    assert tmsmd.msmd_available()
    got = tmsmd.prepare_piece_data_msmd(COLLECTION, piece,
                                        aug_config=getattr(jpools, augment))
    printed = capsys.readouterr().out
    want = jmsmd.prepare_piece_data_msmd(COLLECTION, piece,
                                         aug_config=getattr(jpools, augment))
    assert printed == capsys.readouterr().out   # the same skip lines
    assert_pieces_equal(got, want)
    assert len(got[1]) == (2 if augment == "FULL_AUGMENT"
                           and "NoAlign" not in piece else 1)
    if "NoAlign" in piece and augment == "FULL_AUGMENT":
        assert "Problems with performance %s_tempo-950_ElectricPiano of %s" \
            % (piece, piece) in printed


def test_resample_fallback_bit_for_bit(msmd_stub):
    """No precomputed spectrogram, 44.1 kHz audio only: the host DSP chain
    with its polyphase resample, in both packages."""
    got = tmsmd.prepare_piece_data_msmd(COLLECTION, "StubPiece_Audio44k")
    want = jmsmd.prepare_piece_data_msmd(COLLECTION, "StubPiece_Audio44k")
    assert_pieces_equal(got, want)
    spec = got[1][0]
    assert spec.shape[0] == 92 and spec.shape[1] > 200
    assert spec.dtype == np.float32 and np.isfinite(spec).all()


def test_load_piece_list_skips_like_jax(monkeypatch, capsys):
    """Without the msmd package every piece is skipped with JAX's message."""
    _drop_msmd(monkeypatch)
    monkeypatch.setitem(sys.modules, "msmd", None)   # import msmd fails
    assert not tmsmd.msmd_available() and not jmsmd.msmd_available()
    got = tmsmd.load_piece_list(["P1", "P2"], collection_dir=COLLECTION)
    printed = capsys.readouterr().out
    want = jmsmd.load_piece_list(["P1", "P2"], collection_dir=COLLECTION)
    assert printed == capsys.readouterr().out
    assert got == want == ([], [], [])
    assert "Problems with loading piece P2" in printed


def test_load_piece_list_from_the_stub_matches_jax(msmd_stub):
    names = ["StubPiece_A", "StubPiece_NoAlign", "StubPiece_B"]
    got = tmsmd.load_piece_list(names, aug_config=jpools.FULL_AUGMENT,
                                collection_dir=COLLECTION)
    want = jmsmd.load_piece_list(names, aug_config=jpools.FULL_AUGMENT,
                                 collection_dir=COLLECTION)
    assert len(got[0]) == len(want[0]) == 3
    for p in range(3):
        assert_pieces_equal([g[p] for g in got], [w[p] for w in want])


@pytest.mark.parametrize("source", ["collection", "npz"])
def test_load_piece_list_takes_jax_argument_order(msmd_stub, tmp_path,
                                                  source):
    """A positional call in the JAX package's order (piece names,
    augmentation, collection, npz directory) loads the same pieces through
    both loaders; in the old order of the port's the augmentation dict was
    taken for the npz directory and every piece was skipped."""
    names = ["StubPiece_A", "StubPiece_B"]
    if source == "npz":
        for name in names:
            texport.export_piece(COLLECTION, name, str(tmp_path),
                                 jpools.FULL_AUGMENT)
        args = (names, jpools.FULL_AUGMENT, None, str(tmp_path))
    else:
        args = (names, jpools.FULL_AUGMENT, COLLECTION)
    got = tmsmd.load_piece_list(*args)
    want = jmsmd.load_piece_list(*args)
    assert len(got[0]) == len(want[0]) == 2
    for p in range(2):
        assert_pieces_equal([g[p] for g in got], [w[p] for w in want])


def _split(tmp_path):
    split = dict(train=["StubPiece_A", "StubPiece_B", "StubPiece_Ragged"],
                 valid=["StubPiece_C"],
                 test=["StubPiece_D", "StubPiece_NoAlign"])
    path = tmp_path / "split.yaml"
    path.write_text(yaml.safe_dump(split))
    return str(path)


def test_export_matches_jax_file_for_file(msmd_stub, tmp_path, capsys):
    split = _split(tmp_path)
    argv = ["--train_split", split, "--config", FULL_AUGMENT_YAML]
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    n = texport.main(argv + ["--out_dir", out_t])
    report = capsys.readouterr().out
    assert jexport.main(argv + ["--out_dir", out_j]) == n == 6
    assert report.replace(out_t, out_j) == capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 6
    for name in names:
        got = np.load(tmp_path / "port" / name)
        want = np.load(tmp_path / "jax" / name)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
        # what the JAX package's loader reads from the port's file
        assert_pieces_equal(
            jmsmd.load_piece_npz(str(tmp_path / "port" / name)),
            jmsmd.load_piece_npz(str(tmp_path / "jax" / name)))


@pytest.mark.parametrize("config", [None, FULL_AUGMENT_YAML],
                         ids=["no_config", "full_aug"])
def test_select_data_mutopia_pools_bit_for_bit(msmd_stub, tmp_path, config):
    split = _split(tmp_path)
    kw = dict(seed=7, max_train_pieces=2)
    got = tmsmd.select_data("mutopia", split, config, **kw)
    want = jmsmd.select_data("mutopia", split, config, **kw)
    assert got["train_tag"] == want["train_tag"] == ""
    for name in ("train", "valid", "test"):
        g, w = got[name], want[name]
        assert g.shape == w.shape and g.shape[0] > 0, name
        np.testing.assert_array_equal(g.train_entities, w.train_entities)
        key = slice(0, min(40, g.shape[0]))  # the same draws, in order
        for a, b in zip(g[key], w[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    test_only = tmsmd.select_data("mutopia", split, config, test_only=True)
    assert test_only["train"] is None and test_only["valid"] is None
    np.testing.assert_array_equal(test_only["test"].train_entities,
                                  want["test"].train_entities)


def _write_wav(path, sig, sr):
    from scipy.io import wavfile

    wavfile.write(path, sr, sig)
    return str(path)


@pytest.mark.parametrize("dtype", ["int16", "float32", "int32", "uint8",
                                   "stereo"])
def test_read_wav_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(1)
    sig = rng.uniform(-0.9, 0.9, 4000)
    sig = {"int16": (sig * 30000).astype(np.int16),
           "float32": sig.astype(np.float32),
           "int32": (sig * 2e9).astype(np.int32),
           "uint8": (sig * 100 + 128).astype(np.uint8),
           "stereo": (np.stack([sig, -sig], 1) * 30000).astype(np.int16)
           }[dtype]
    path = _write_wav(tmp_path / "a.wav", sig, 16000)
    got, want = taudio.read_audio(path), jaudio.read_audio(path)
    assert got[1] == want[1] == 16000
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("channels", [1, 2])
def test_read_flac_matches_jax(tmp_path, channels):
    from tests.flac_test_encoder import encode_flac

    rng = np.random.default_rng(channels)
    sig = (rng.standard_normal((6000, channels)) * 4000).clip(
        -32768, 32767).astype(np.int16)
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(sig[:, 0] if channels == 1 else sig,
                                 22050))
    got, want = taudio.read_audio(str(path)), jaudio.read_audio(str(path))
    assert got[1] == want[1] == 22050
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0].reshape(sig.shape), sig)


def test_read_mp3_and_unsupported_like_jax(tmp_path):
    path = jassets.tutorial_audio_path()
    try:
        want = jaudio.read_audio(path)
    except RuntimeError as e:   # no libmpg123.so.0 on this host
        with pytest.raises(RuntimeError, match="libmpg123"):
            taudio.read_audio(path)
        assert "libmpg123" in str(e)
    else:
        got = taudio.read_audio(path)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="unsupported audio format"):
        taudio.read_audio(str(tmp_path / "a.ogg"))
