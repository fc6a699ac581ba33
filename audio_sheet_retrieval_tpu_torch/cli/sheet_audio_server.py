"""Sheet -> audio piece identification: the direction-flipped evaluation.

CLI parity with reference:sheet_audio_server.py:21-111 and the JAX
package's ``cli/sheet_audio_server.py``: build or load the audio-excerpt DB
over the test pieces, query with each piece's unrolled sheet strip, and
rank; ``--dump_results`` writes retrieval_<tag>_S2A.yaml.

    python -m audio_sheet_retrieval_tpu_torch.cli.sheet_audio_server \
        --data synthetic --n_test_pieces 8 --param_file <ckpt> \
        --init_audio_db --full_eval [--fused]

``--fused`` sends each strip through ``detect_performance_from_sheet`` (the
raw uint8 strip uploads once; windows, embedding, top-k and votes run on
the device) instead of the host-sliced ``detect_performance``: the same
rankings. Sources as in ``cli/audio_sheet_server.py``: synthetic,
``npz:<dir>`` and ``mutopia``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.cli.audio_sheet_server import (
    evaluate,
    experiment_tag,
    load_split,
    make_piece_source,
    param_file_for,
)
from audio_sheet_retrieval_tpu_torch.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import RetrievalWrapper


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Run sheet 2 audio retrieval service (PyTorch).")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="mutopia")
    parser.add_argument("--device", default="cuda",
                        help="torch device the model and gallery live on")
    parser.add_argument("--estimate_UV", action="store_true")
    parser.add_argument("--init_audio_db", action="store_true")
    parser.add_argument("--full_eval", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="full_eval queries through the raw-strip device "
                             "query (detect_performance_from_sheet) instead "
                             "of detect_performance — same rankings")
    parser.add_argument("--n_candidates", type=int, default=25)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dump_results", action="store_true")
    parser.add_argument("--conv_precision", default=None,
                        choices=["highest", "high", "default"],
                        help="f32 conv precision: 'highest' or 'high' "
                             "(both full f32, TF32 off), or 'default' (each "
                             "conv one TF32 pass on the card, float32 on "
                             "the CPU); see cca_model.check_numerics")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--db_file", type=str, default="audio_db_file.pkl")
    parser.add_argument("--n_test_pieces", type=int, default=None,
                        help="synthetic source: number of test pieces")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    model_cfg = get_model_config(args.model)
    if args.conv_precision is not None:
        model_cfg = dataclasses.replace(model_cfg,
                                        conv_precision=args.conv_precision)
    tag = experiment_tag(args)
    print("Experimental Tag:", tag)
    split = load_split(args.train_split, args.n_test_pieces)
    dump_file = param_file_for(args, model_cfg, tag)

    srv = AudioSheetServer(
        sheet_shape=(model_cfg.input_shape_1[1], model_cfg.input_shape_1[2]),
        spec_shape=(model_cfg.input_shape_2[1], model_cfg.input_shape_2[2]),
        device=args.device)
    srv.initialize_embedding_network(
        RetrievalWrapper(model_cfg, param_file=dump_file, device=args.device))

    te_pieces, loader, _ = make_piece_source(args.data, split, args.config,
                                             device=args.device)

    if args.init_audio_db or not os.path.exists(args.db_file):
        srv.initialize_audio_db(te_pieces, loader)
        srv.save_audio_db_file(args.db_file)
    else:
        srv.load_audio_db_file(args.db_file)

    if args.full_eval:
        detect_fn = (srv.detect_performance_from_sheet if args.fused
                     else srv.detect_performance)

        def detect(tp):
            return detect_fn(loader(tp)[0], top_k=len(te_pieces),
                             n_candidates=args.n_candidates)

        return evaluate(te_pieces, detect, "performances", dump_file,
                        args.dump_results, "S2A.yaml")
    return None


if __name__ == "__main__":
    main()
