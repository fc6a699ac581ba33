#!/usr/bin/env python
"""The JAX package's OMR results on the vendored tutorial page, the golden
file the port's OMR tests and ``chip_smoke.py`` phase 15 are held to.

    JAX_PLATFORMS=cpu python scripts/jax_omr_golden.py \
        [--out tests/golden/omr_tutorial_page.npz]

It runs the JAX package only, on the CPU (a few minutes), in float32
``highest`` with raw page and map wires (``page_wire="raw"``,
``map_wire="raw"``: the rANS wires are lossless, so the codes are the
same), and stores, for the full page (``full_*``) and for its rows 0:420
(``crop_*``, one row of three 512 x 512 tiles per net):

* ``*_systems`` [N, 4, 2], ``*_bars`` (with the systems),
  ``*_bars_nosys`` (without) and ``*_notes`` (the note net, input shape
  256 x 512) of ``OpticalMusicRecognizer``;
* the system net's u16 map codes (``*_system_codes``);
* ``*_tutorial_dists``: ``cli.tutorial.main(["--synth_audio", ...])``'s
  100 x 100 distance matrix with that page as ``--sheet``;
* over a two-piece UMC directory built from that page as
  ``tests/test_umc.py::umc_dataset`` builds it (piece A the page, piece B
  the page with its top half white, an 8 s sine chord as each piece's
  ``score_ppq.wav`` and ``01_performance.wav``): ``*_a2s_host_ranks`` and
  ``*_a2s_device_ranks`` (``umc_a2s_server --full_eval``, without and
  with ``--device_db``), ``*_s2a_ranks`` (``umc_s2a_server --full_eval
  --device_db``), and the unrolled strips of ``load_umc_sheets`` as
  ``*_strip_names``, ``*_strip_shapes`` and ``*_strip_sha256``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import struct
import sys
import tempfile
import wave

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

CROP_ROWS = 420
SR = 22050


def umc_piece_pages(page: np.ndarray):
    """(name, page, chord frequencies) of the two pieces of
    ``tests/test_umc.py::umc_dataset``."""
    page_b = page.copy()
    page_b[: page.shape[0] // 2] = 255
    return (("PieceA", page, (262.0, 330.0, 392.0)),
            ("PieceB", page_b, (220.0, 277.0, 440.0)))


def write_wav(path: str, signal_i16: np.ndarray, sr: int = SR) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(struct.pack("<%dh" % len(signal_i16), *signal_i16))


def umc_signals(freqs):
    """(score_ppq, 01_performance) int16 signals of one piece."""
    t = np.arange(SR * 8) / SR
    sig = sum(0.2 * np.sin(2 * np.pi * f * t) for f in freqs)
    return (sig * 20000).astype(np.int16), (sig * 18000).astype(np.int16)


def build_umc_dir(root: str, page: np.ndarray, imwrite) -> str:
    for name, img, freqs in umc_piece_pages(page):
        d = os.path.join(root, name, "sheet")
        os.makedirs(d)
        imwrite(os.path.join(d, "01.png"), img)
        score, perf = umc_signals(freqs)
        write_wav(os.path.join(root, name, "score_ppq.wav"), score)
        write_wav(os.path.join(root, name, "01_performance.wav"), perf)
    return root


def detections(prep: np.ndarray) -> dict:
    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.omr import detectors, inference

    def net(kind, shape=(512, 512)):
        return inference.SegmentationNetwork.load(
            assets.omr_weights_path(kind), input_shape=shape,
            page_wire="raw", map_wire="raw")

    sysnet, barnet = net("system"), net("bar")
    omr = detectors.OpticalMusicRecognizer(
        system_detector=sysnet, bar_detector=barnet,
        note_detector=net("note", (256, 512)))
    systems = omr.detect_systems(prep)
    codes = np.round(sysnet.predict_proba(prep) * 65535.0).astype(np.uint16)
    return {"systems": systems,
            "bars": omr.detect_bars(prep, systems=systems),
            "bars_nosys": omr.detect_bars(prep),
            "notes": omr.detect_notes(prep),
            "system_codes": codes}


def umc_results(tmp: str, page: np.ndarray) -> dict:
    import cv2

    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.cli import umc_a2s_server, umc_s2a_server
    from audio_sheet_retrieval_tpu.retrieval import umc

    data = build_umc_dir(os.path.join(tmp, "umc"), page, cv2.imwrite)
    ckpt = assets.tutorial_checkpoint_path()
    out = {}
    for key, extra in (("a2s_host_ranks", []),
                       ("a2s_device_ranks", ["--device_db"])):
        out[key] = umc_a2s_server.main(
            ["--data_dir", data, "--param_file", ckpt, "--db_file",
             os.path.join(tmp, key + ".pkl"), "--init_sheet_db",
             "--full_eval"] + extra)
    out["s2a_ranks"] = umc_s2a_server.main(
        ["--data_dir", data, "--param_file", ckpt, "--db_file",
         os.path.join(tmp, "s2a.pkl"), "--init_audio_db", "--full_eval",
         "--device_db"])
    names, _, strips = umc.load_umc_sheets(data)
    out["strip_names"] = np.asarray(names)
    out["strip_shapes"] = np.asarray([s.shape for s in strips])
    out["strip_sha256"] = np.asarray(
        [hashlib.sha256(np.ascontiguousarray(s).tobytes()).hexdigest()
         for s in strips])
    return {k: np.asarray(v) for k, v in out.items()}


def tutorial_dists(tmp: str, sheet: str) -> np.ndarray:
    from audio_sheet_retrieval_tpu.cli import tutorial

    path = os.path.join(tmp, "dists.npy")
    tutorial.main(["--synth_audio", "--sheet", sheet, "--save_dists", path])
    return np.load(path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "golden", "omr_tutorial_page.npz"))
    args = parser.parse_args(argv)

    import cv2
    import jax

    jax.config.update("jax_platforms", "cpu")
    from audio_sheet_retrieval_tpu import assets
    from audio_sheet_retrieval_tpu.cli.tutorial import resize_page
    from audio_sheet_retrieval_tpu.omr.inference import prepare_image

    page = resize_page(cv2.imread(assets.tutorial_sheet_path(), 0))
    golden = {"jax_version": np.asarray(jax.__version__),
              "crop_rows": np.asarray(CROP_ROWS)}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, img in (("full", page), ("crop", page[:CROP_ROWS])):
            sub = os.path.join(tmp, tag)
            os.makedirs(sub)
            sheet = os.path.join(sub, "page.png")
            cv2.imwrite(sheet, img)
            found = dict(detections(prepare_image(img)),
                         tutorial_dists=tutorial_dists(sub, sheet),
                         **umc_results(sub, img))
            golden.update({f"{tag}_{k}": v for k, v in found.items()})
            print(tag, {k: np.shape(v) for k, v in found.items()},
                  flush=True)
    np.savez_compressed(args.out, **golden)
    print("wrote", args.out, os.path.getsize(args.out), "bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
