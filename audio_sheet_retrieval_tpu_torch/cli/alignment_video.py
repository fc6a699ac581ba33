"""Render per-frame alignment visualizations to figs/%05d.png.

The port's copy of the JAX package's ``cli/alignment_video.py`` (host
code only: numpy and matplotlib, imported inside the function). Parity
with reference:alignment_video.py:22-95 — for each spectrogram frame: sheet
strip with the aligned pixel cursor (500-px context window), the running
42-frame spectrogram excerpt, and the distance matrix with the DTW path
traced up to the current frame. Headless (matplotlib Agg).

Input: an alignment dump pickle [spec, sheet, a2s_mapping, dtw_res] as
produced by cli/audio2sheet_align.py --dump_alignment (full-dump mode), or
the components can be passed programmatically via render_alignment_video.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

SPEC_CONTEXT = 42


def render_alignment_video(spec, sheet, a2s_mapping, dtw_res,
                           out_dir: str = "figs", context: int = 500,
                           max_frames: int | None = None) -> int:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    fs = SPEC_CONTEXT // 2
    fe = spec.shape[1] - fs
    frames = range(fs, fe)
    n_rendered = 0
    for i, frame_id in enumerate(frames):
        if max_frames is not None and i >= max_frames:
            break
        if frame_id not in a2s_mapping:
            continue
        pxl_coord = a2s_mapping[frame_id]
        x_min = max(0, pxl_coord - context)
        x_max = min(x_min + 2 * context, sheet.shape[1] - 1)
        x_min = x_max - 2 * context

        fig = plt.figure("Alignment", figsize=(10, 10))
        fig.clf()
        gs = gridspec.GridSpec(2, 2, width_ratios=[4, 1],
                               height_ratios=[1, 2])
        plt.subplots_adjust(left=0.05, right=0.95, bottom=0.10, top=0.90,
                            hspace=0.05, wspace=0.05)

        plt.subplot(gs[0])
        plt.imshow(sheet, cmap=plt.cm.gray)
        plt.plot(2 * [pxl_coord], [0, sheet.shape[0]], "-", linewidth=5,
                 alpha=0.8)
        plt.xlim([x_min, x_max])
        plt.ylim([sheet.shape[0] - 1, 0])
        plt.axis("off")
        plt.title("Sheet Image")

        plt.subplot(gs[1])
        excerpt = spec[:, frame_id - fs:frame_id + fs]
        plt.imshow(excerpt, cmap="viridis", origin="lower")
        plt.plot(2 * [fs], [0, spec.shape[0] - 1], "w-", linewidth=3,
                 alpha=0.8)
        plt.axis("off")
        plt.title("Spectrogram")

        plt.subplot(gs[2])
        plt.imshow(dtw_res["dists"], cmap="viridis", interpolation="nearest")
        spec_idxs = np.asarray(dtw_res["spec_idxs"])
        if frame_id in spec_idxs:
            col = int(np.where(spec_idxs == frame_id)[0][0])
            row = dtw_res["aligned_sheet_idxs"][col]
            plt.plot(range(col), dtw_res["aligned_sheet_idxs"][:col], "-",
                     linewidth=5, alpha=0.8)
            plt.plot(col, row, "o", markersize=10)
        plt.xlim([0, dtw_res["dists"].shape[1] - 1])
        plt.ylim([0, dtw_res["dists"].shape[0] - 1])
        plt.ylabel("Sheet")
        plt.xlabel("Audio")
        plt.title("Audio - Sheet - Distances")

        fig.savefig(os.path.join(out_dir, "%05d.png" % i))
        n_rendered += 1
    import matplotlib.pyplot as plt

    plt.close("all")
    return n_rendered


def main(argv=None):
    parser = argparse.ArgumentParser(description="Render alignment video frames.")
    parser.add_argument("dump_file", help="pickle [spec, sheet, mapping, dtw_res]")
    parser.add_argument("--out_dir", default="figs")
    parser.add_argument("--max_frames", type=int, default=None)
    args = parser.parse_args(argv)
    with open(args.dump_file, "rb") as fp:
        spec, sheet, a2s_mapping, dtw_res = pickle.load(fp)
    n = render_alignment_video(spec, sheet, a2s_mapping, dtw_res,
                               out_dir=args.out_dir,
                               max_frames=args.max_frames)
    print(f"rendered {n} frames to {args.out_dir}/")
    return n


if __name__ == "__main__":
    main()
