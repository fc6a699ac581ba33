"""Prepare a UMC-style dataset directory for retrieval.

The JAX package's ``cli/prepare_umc_data.py`` (reference
scripts/prepare_umc_data.py:17-85): per piece directory, resize every
sheet/*.png scan to the working width (835 px) in place, as ``cv2.resize``
and ``cv2.imwrite`` would (``utils.image_io``: the pages read back equal),
and render score_ppq audio from MIDI when the external ``msmd`` renderer is
installed (it is not part of this environment).

    python -m audio_sheet_retrieval_tpu_torch.cli.prepare_umc_data \
        --data_dir <dir> [--target_width 835] [--render_audio]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from audio_sheet_retrieval_tpu_torch.utils.image_io import (
    imread_gray,
    imwrite_gray,
    resize_linear_u8,
)

TARGET_WIDTH = 835


def prepare_piece(piece_dir: str, target_width: int = TARGET_WIDTH,
                  render_audio: bool = False) -> int:
    n = 0
    for page_path in sorted(glob.glob(os.path.join(piece_dir, "sheet/*.png"))):
        try:
            img = imread_gray(page_path)
        except ValueError as exc:  # skipped, as cv2.imread's None is
            print("skipping unreadable page:", exc)
            continue
        if img.shape[1] == target_width:
            continue
        scale = target_width / img.shape[1]
        out = resize_linear_u8(img, (target_width, int(scale * img.shape[0])))
        imwrite_gray(page_path, out)
        n += 1

    if render_audio:
        midi = sorted(glob.glob(os.path.join(piece_dir, "*.mid*")))
        if midi:
            try:
                from msmd import render_audio as msmd_render

                msmd_render(midi[0], sound_font="grand-piano-YDP-20160804")
            except ImportError:
                print("msmd renderer unavailable — skipping audio render "
                      "for", piece_dir)
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description="Prepare UMC sheet data.")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--target_width", type=int, default=TARGET_WIDTH)
    parser.add_argument("--render_audio", action="store_true")
    args = parser.parse_args(argv)

    piece_dirs = np.sort(glob.glob(os.path.join(args.data_dir, "*")))
    total = 0
    for i, piece_dir in enumerate(piece_dirs):
        print("(%03d/%03d) %s" % (i + 1, len(piece_dirs),
                                  os.path.basename(piece_dir)))
        total += prepare_piece(piece_dir, args.target_width,
                               args.render_audio)
    print("resized %d pages" % total)
    return total


if __name__ == "__main__":
    main()
