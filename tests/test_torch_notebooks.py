"""The port's tutorial notebooks (``tutorials/torch_*.ipynb``) run on the
CPU: their code cells, with the one device assignment of the first code
cell set to ``"cpu"``, against the vendored assets, with the assertions
of the JAX notebooks' own test (``tests/test_notebooks.py``), and each
notebook's distance matrix held to the one the JAX package computes
through its ``RetrievalWrapper`` and ``default_processor`` on the same
snippets and the same recording (1e-4)."""

import json
import os

import numpy as np
import pytest

from audio_sheet_retrieval_tpu.models.configs import get_model_config as jcfg_of
from audio_sheet_retrieval_tpu.ops.audio import default_processor
from audio_sheet_retrieval_tpu.retrieval.server import (
    linspace_starts,
    slice_windows,
)
from audio_sheet_retrieval_tpu.retrieval.wrapper import RetrievalWrapper

import torch_port_helpers  # noqa: F401  (one torch thread a test process)

NB_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tutorials")
DEVICE_LINE = 'device = "cuda"'


def run_notebook(name, device="cpu"):
    """Execute the notebook's code cells in one namespace, the first code
    cell's ``device = "cuda"`` set to ``device`` -> the namespace."""
    with open(os.path.join(NB_DIR, name)) as fp:
        cells = [c for c in json.load(fp)["cells"] if c["cell_type"] == "code"]
    sources = ["".join(c["source"]) for c in cells]
    assert sources[0].count(DEVICE_LINE) == 1
    assert all(DEVICE_LINE not in s and "device = " not in s
               for s in sources[1:])
    sources[0] = sources[0].replace(DEVICE_LINE, f"device = {device!r}")
    ns = {}
    for i, src in enumerate(sources):
        exec(compile(src, f"{name}:cell{i}", "exec"), ns)
    return ns


def jax_wrapper():
    from audio_sheet_retrieval_tpu import assets as jassets

    cfg = jcfg_of("mutopia_ccal_cont_rsz")
    return cfg, RetrievalWrapper(cfg,
                                 param_file=jassets.tutorial_checkpoint_path())


def jax_spectrogram(ns):
    return default_processor().process(ns["signal"], sample_rate=ns["sr"])


def test_a2a_notebook_executes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ns = run_notebook("torch_Embedding_Tutorial_Audio_to_Audio.ipynb")
    dists = ns["dists"]
    diag = float(np.diag(dists).mean())
    offdiag = float(dists[~np.eye(len(dists), dtype=bool)].mean())
    assert diag < 0.1 and offdiag > 0.5
    _, jw = jax_wrapper()
    spec = jax_spectrogram(ns)
    np.testing.assert_allclose(ns["spec"], spec, atol=1e-4)
    starts = linspace_starts(spec.shape[1], 42, 200)
    np.testing.assert_array_equal(ns["starts"], starts)
    a = jw.compute_view_2(slice_windows(spec, 42, starts))
    b = jw.compute_view_2(slice_windows(
        spec, 42, np.clip(starts + 2, 0, spec.shape[1] - 42)))
    np.testing.assert_allclose(dists, 1.0 - a @ b.T, atol=1e-4)


def test_embedding_notebook_executes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ns = run_notebook("torch_Embedding_Tutorial.ipynb")
    dists = ns["dists"]
    am = np.argmin(dists, axis=0)
    corr = float(np.corrcoef(np.arange(dists.shape[1]), am)[0, 1])
    assert corr > 0.97
    assert os.path.exists(tmp_path / "distances.png")
    cfg, jw = jax_wrapper()
    sheet = jw.compute_view_1(ns["snippets"])
    spec = jax_spectrogram(ns)
    np.testing.assert_allclose(ns["spectrogram"], spec, atol=1e-4)
    sstarts = linspace_starts(spec.shape[1], cfg.input_shape_2[2], 100)
    np.testing.assert_array_equal(ns["sstarts"], sstarts)
    audio = jw.compute_view_2(slice_windows(spec, cfg.input_shape_2[2],
                                            sstarts))
    np.testing.assert_allclose(dists, 1.0 - sheet @ audio.T, atol=1e-4)


@pytest.mark.parametrize("name", ["torch_Embedding_Tutorial.ipynb",
                                  "torch_Embedding_Tutorial_Audio_to_Audio"
                                  ".ipynb"])
def test_notebook_is_the_jax_notebook_over_the_port(name):
    """The same cells as the JAX notebook, with the port's imports, the
    image reader, ``AudioProcessor(device=device)`` and the device in
    place of JAX's; nothing of JAX, cv2 or the JAX package."""
    def code(n):
        with open(os.path.join(NB_DIR, n)) as fp:
            return ["".join(c["source"]) for c in json.load(fp)["cells"]
                    if c["cell_type"] == "code"]

    port, jax_cells = code(name), code(name[len("torch_"):])
    assert len(port) == len(jax_cells)
    for p in port:
        assert "jax" not in p.replace("audio_sheet_retrieval_tpu_torch", "")
        assert "cv2" not in p
        assert "default_processor" not in p
    joined = "\n".join(port)
    assert "AudioProcessor(device=device)" in joined
    assert "RetrievalWrapper(\n    cfg, param_file=assets.tutorial_checkpoint_path(), device=device)" in joined


def test_decoded_recording_golden_is_the_mp3():
    """``tests/golden/tutorial_audio_22050.npz`` holds the tutorial
    recording as ``AudioProcessor.process`` first turns it (the mp3's two
    channels averaged, resampled to 22,050 Hz, int16). ``chip_smoke.py``
    phase 20b feeds it to the notebooks where no libmpg123 decodes the mp3;
    ``process`` of it at 22,050 Hz gives the mp3's spectrogram bit for bit.
    Made by ``np.savez_compressed(path, signal=AudioProcessor(device="cpu")
    ._mono(*read_audio(assets.tutorial_audio_path())), sample_rate=22050)``.
    """
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor
    from audio_sheet_retrieval_tpu_torch.utils.audio_io import read_audio

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden", "tutorial_audio_22050.npz")
    with np.load(golden) as z:
        signal, rate = z["signal"], int(z["sample_rate"])
    proc = AudioProcessor(device="cpu")
    mp3, sr = read_audio(assets.tutorial_audio_path())
    assert rate == proc.sample_rate and signal.dtype == np.int16
    np.testing.assert_array_equal(signal, proc._mono(mp3, sr))
    np.testing.assert_array_equal(proc.process(signal, sample_rate=rate),
                                  proc.process(mp3, sample_rate=sr))
