"""Offline audio-to-sheet alignment over embedding distances.

CLI parity with reference:audio2sheet_align.py:25-233 and the JAX
package's ``cli/audio2sheet_align.py`` — per test piece: slice the
unrolled sheet every ``step_sheet`` px and the spectrogram every
``step_spec`` frames (linspace sampling between the half-window margins),
embed both sides, cosine distance matrix -> 'baseline' or 'pydtw' alignment
-> pixel errors at ground-truth onsets -> per-piece error pickle
``alignment_res_<tag>_<align_by>.pkl``.

Everything runs on ``--device`` (default ``cuda``): the embeddings, the
distance matrix and, for ``pydtw``, the DTW kernels of ``csrc/dtw.cu``.
Sources as the servers': ``--data synthetic``, ``npz:<dir>`` or
``mutopia`` (the MSMD collection under ``ASR_TPU_DATA_ROOT_MSMD``).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from audio_sheet_retrieval_tpu_torch import config as cfg_mod
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.retrieval.alignment import (
    compute_alignment,
    estimate_alignment_error,
)
from audio_sheet_retrieval_tpu_torch.retrieval.server import slice_windows
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import RetrievalWrapper


def align_piece(wrapper, model_cfg, sheet, spec, coords, onsets,
                step_sheet: int = 10, step_spec: int = 2,
                align_by: str = "pydtw"):
    """Align one piece on the wrapper's device; returns (pixel errors at
    onsets, mapping, dtw_res)."""
    sheet_win = model_cfg.input_shape_1[1:]
    spec_win = model_cfg.input_shape_2[1:]

    n_steps = spec.shape[1] // step_spec
    o0 = spec_win[1] // 2
    o1 = spec.shape[1] - o0
    spec_idxs = np.linspace(o0, o1, n_steps).astype(np.int32)

    n_steps = sheet.shape[1] // step_sheet
    c0 = sheet_win[1] // 2
    c1 = sheet.shape[1] - c0
    sheet_idxs = np.linspace(c0, c1, n_steps).astype(np.int32)

    r0 = sheet.shape[0] // 2 - sheet_win[0] // 2
    sheet_slices = slice_windows(sheet.astype(np.float32), sheet_win[1],
                                 sheet_idxs - c0, row0=r0, rows=sheet_win[0])
    spec_slices = slice_windows(spec, spec_win[1], spec_idxs - o0)

    img_codes = wrapper.compute_view_1(sheet_slices)
    spec_codes = wrapper.compute_view_2(spec_slices)

    a2s_mapping, dtw_res = compute_alignment(
        img_codes, spec_codes, sheet_idxs, spec_idxs, align_by,
        device=wrapper.device)
    pxl_errors = estimate_alignment_error(coords, onsets, a2s_mapping)
    return pxl_errors, a2s_mapping, dtw_res


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Audio-to-sheet offline alignment (PyTorch).")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="mutopia")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model, the distances and "
                             "the DTW")
    parser.add_argument("--estimate_UV", action="store_true")
    parser.add_argument("--step_sheet", type=int, default=10)
    parser.add_argument("--step_spec", type=int, default=2)
    parser.add_argument("--align_by", type=str, default="baseline",
                        choices=["baseline", "pydtw"])
    parser.add_argument("--dump_alignment", action="store_true")
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--n_test_pieces", type=int, default=None)
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    model_cfg = get_model_config(args.model)
    tag = cfg_mod.compile_tag(args.train_split, args.config)
    print("Experimental Tag:", tag)

    exp_name = model_cfg.name + ("_est_UV" if args.estimate_UV else "")
    dump_file = args.param_file
    if dump_file is None:
        exp_root = args.exp_root or cfg_mod.EXP_ROOT
        name = "params.pkl" if tag is None else "params_%s.pkl" % tag
        dump_file = os.path.join(exp_root, exp_name, name)
    wrapper = RetrievalWrapper(model_cfg, param_file=dump_file,
                               device=args.device)

    from audio_sheet_retrieval_tpu_torch.cli.audio_sheet_server import (
        make_piece_source,
    )

    if args.train_split:
        split = cfg_mod.load_split(args.train_split)
    else:
        split = {"test": ["x"] * (args.n_test_pieces or 4)}
    pieces, loader, _ = make_piece_source(args.data, split, args.config,
                                          device=args.device)

    piece_pxl_errors = {}
    for piece in pieces:
        print("\nTarget Piece: %s" % piece)
        image, specs, o2c_maps = loader(piece)
        spec = specs[0]
        coords = o2c_maps[0][:, 1]
        onsets = o2c_maps[0][:, 0]

        pxl_errors, a2s_mapping, dtw_res = align_piece(
            wrapper, model_cfg, image, spec, coords, onsets,
            step_sheet=args.step_sheet, step_spec=args.step_spec,
            align_by=args.align_by)
        abs_err = np.abs(pxl_errors)
        print("Mean Error:   %.3f" % np.mean(abs_err))
        print("Median Error: %.3f" % np.median(abs_err))
        print("Max Error:    %.3f" % np.max(abs_err))
        piece_pxl_errors[piece] = pxl_errors

    if args.dump_alignment:
        res_file = cfg_mod.derive_result_path(
            dump_file, "alignment_res_", "%s.pkl" % args.align_by)
        os.makedirs(os.path.dirname(os.path.abspath(res_file)), exist_ok=True)
        with open(res_file, "wb") as fp:
            pickle.dump(piece_pxl_errors, fp)
        print("dumped alignment errors to", res_file)
    return piece_pxl_errors


if __name__ == "__main__":
    main()
