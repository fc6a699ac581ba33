"""End-to-end embedding tutorial pipeline on a torch device (the JAX
package's ``cli/tutorial.py``, script form of reference
tutorials/Embedding Tutorial{, Audio-to-Audio}.ipynb).

Pipeline: score page -> OMR system detection -> unroll to a SYSTEM_HEIGHT
strip -> 100 snippets -> sheet embeddings; audio -> log-filterbank
spectrogram -> 100 excerpts -> audio embeddings; pairwise cosine distance
matrix sanity check (and the audio-to-audio variant).

    python -m audio_sheet_retrieval_tpu_torch.cli.tutorial --synth_audio \
        [--sheet page.png] [--audio rec.wav] [--a2a] [--save_dists d.npy] \
        [--device cuda|cpu]

Audio input: .wav/.flac/.mp3 (mp3 through the system libmpg123). Defaults
to the vendored tutorial recording; ``--synth_audio`` generates a chord
instead. The page is read and resized without OpenCV
(``utils.image_io``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SYSTEM_HEIGHT = 160


def unroll_page(sheet_image: np.ndarray, page_systems: np.ndarray,
                system_height: int = SYSTEM_HEIGHT) -> np.ndarray:
    """Unwrap detected systems into one long strip (notebook cell parity:
    vertical center of each system, edge-padded to system_height)."""
    unwrapped = np.zeros((system_height, 0), dtype=np.uint8)
    for system in page_systems:
        r0 = int(np.mean([system[0, 0], system[2, 0]])) - system_height // 2
        r1 = r0 + system_height
        c0, c1 = int(system[0, 1]), int(system[1, 1])
        r0 = max(0, r0)
        r1 = min(r1, sheet_image.shape[0])
        r0 = max(r0, r1 - system_height)
        staff = sheet_image[r0:r1, c0:c1].astype(np.uint8)
        if staff.shape[0] < system_height:
            to_pad = system_height - staff.shape[0]
            if to_pad > 0.1 * system_height:
                print("Problem in system padding!!!")
                continue
            staff = np.pad(staff, ((0, to_pad), (0, 0)), mode="edge")
        unwrapped = np.hstack((unwrapped, staff))
    return unwrapped


def resize_page(img: np.ndarray, width: int = 835) -> np.ndarray:
    """``cv2.resize(img, (width, int(scale * h)))``, bit for bit."""
    from audio_sheet_retrieval_tpu_torch.utils.image_io import (
        resize_linear_u8,
    )

    scale = width / img.shape[1]
    return resize_linear_u8(img, (width, int(scale * img.shape[0])))


def main(argv=None):
    from audio_sheet_retrieval_tpu_torch import assets

    parser = argparse.ArgumentParser(description="Embedding tutorial pipeline.")
    parser.add_argument("--sheet", default=assets.tutorial_sheet_path())
    parser.add_argument("--audio", default=None,
                        help=".wav/.flac/.mp3 file (default: the vendored "
                             "tutorial audio.mp3 if present)")
    parser.add_argument("--synth_audio", action="store_true",
                        help="use a synthesized chord instead of a file")
    parser.add_argument("--param_file",
                        default=assets.tutorial_checkpoint_path())
    parser.add_argument("--omr_models", default=assets.assets_dir())
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--n_samples", type=int, default=100)
    parser.add_argument("--a2a", action="store_true",
                        help="audio-to-audio variant (audio encoder both sides)")
    parser.add_argument("--save_dists", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device the encoders and U-Nets run on")
    args = parser.parse_args(argv)

    from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
    from audio_sheet_retrieval_tpu_torch.omr.detectors import (
        OpticalMusicRecognizer,
    )
    from audio_sheet_retrieval_tpu_torch.omr.inference import (
        SegmentationNetwork,
        prepare_image,
    )
    from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor
    from audio_sheet_retrieval_tpu_torch.retrieval.server import (
        linspace_starts,
        slice_windows,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.umc import (
        resolve_omr_weights,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        RetrievalWrapper,
    )
    from audio_sheet_retrieval_tpu_torch.utils.image_io import imread_gray

    cfg = get_model_config(args.model)
    wrapper = RetrievalWrapper(cfg, param_file=args.param_file,
                               device=args.device)

    # ---- audio side ----------------------------------------------------------
    proc = AudioProcessor(device=args.device)
    if args.audio is None and not args.synth_audio:
        if os.path.exists(assets.tutorial_audio_path()):
            args.audio = assets.tutorial_audio_path()
    if args.synth_audio or args.audio is None:
        print("Synthesizing test audio...")
        sr = proc.sample_rate
        t = np.arange(sr * 10) / sr
        sig = sum(0.2 * np.sin(2 * np.pi * f * t)
                  for f in (262.0, 330.0, 392.0, 523.0))
        signal = (sig * 32767 / 2).astype(np.int16)
        spectrogram = proc.process(signal)
    else:
        from audio_sheet_retrieval_tpu_torch.utils.audio_io import read_audio

        signal, sr = read_audio(args.audio)
        spectrogram = proc.process(signal, sample_rate=sr)
    print("spectrogram:", spectrogram.shape)

    excerpt_shape = cfg.input_shape_2[1:]
    starts = linspace_starts(spectrogram.shape[1], excerpt_shape[1],
                             args.n_samples)
    spec_excerpts = slice_windows(spectrogram, excerpt_shape[1], starts)
    spec_codes = wrapper.compute_view_2(spec_excerpts)
    print("spectrogram codes:", spec_codes.shape)

    if args.a2a:
        # audio-to-audio: second pass over shifted excerpts
        starts2 = starts + excerpt_shape[1] // 8
        starts2 = np.clip(starts2, 0, spectrogram.shape[1] - excerpt_shape[1])
        codes2 = wrapper.compute_view_2(
            slice_windows(spectrogram, excerpt_shape[1], starts2))
        dists = 1.0 - spec_codes @ codes2.T
        print("A2A distance matrix:", dists.shape,
              "diag mean %.4f vs offdiag mean %.4f"
              % (np.diag(dists).mean(),
                 dists[~np.eye(len(dists), dtype=bool)].mean()))
        if args.save_dists:
            np.save(args.save_dists, dists)
        return dists

    # ---- sheet side ----------------------------------------------------------
    sheet_image = resize_page(imread_gray(args.sheet))
    prep = prepare_image(sheet_image)
    sysnet = SegmentationNetwork.load(
        resolve_omr_weights(args.omr_models, "system"), map_kind="system",
        device=args.device)
    barnet = SegmentationNetwork.load(
        resolve_omr_weights(args.omr_models, "bar"), map_kind="bar",
        device=args.device)
    omr = OpticalMusicRecognizer(system_detector=sysnet, bar_detector=barnet)
    page_systems = omr.detect_systems(prep)
    print("detected systems:", len(page_systems))

    unwrapped = unroll_page(sheet_image, page_systems)
    print("unwrapped sheet:", unwrapped.shape)

    snippet_shape = cfg.input_shape_1[1:]
    sheet_starts = linspace_starts(unwrapped.shape[1], snippet_shape[1],
                                   args.n_samples)
    r0 = unwrapped.shape[0] // 2 - snippet_shape[0] // 2
    sheet_snippets = slice_windows(unwrapped.astype(np.float32),
                                   snippet_shape[1], sheet_starts,
                                   row0=r0, rows=snippet_shape[0])
    sheet_codes = wrapper.compute_view_1(sheet_snippets)
    print("sheet codes:", sheet_codes.shape)

    dists = 1.0 - sheet_codes @ spec_codes.T
    print("cross-modal distance matrix:", dists.shape,
          "min %.4f max %.4f" % (dists.min(), dists.max()))
    # when sheet and audio are the same piece (the notebook's input pair),
    # temporally-aligned sampling makes low distances hug the diagonal
    n = min(dists.shape)
    sq = dists[:n, :n]
    off = sq[~np.eye(n, dtype=bool)]
    print("diag mean %.4f vs offdiag mean %.4f | row-argmin within 10%%: %d/%d"
          % (np.diag(sq).mean(), off.mean(),
             int(np.sum(np.abs(np.argmin(sq, axis=1) - np.arange(n))
                        <= max(1, n // 10))), n))
    if args.save_dists:
        np.save(args.save_dists, dists)
    return dists


if __name__ == "__main__":
    main()
