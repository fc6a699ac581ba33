"""Audio -> sheet retrieval on real (UMC-style) sheet music scans.

The JAX package's ``cli/umc_a2s_server.py`` (reference
umc_a2s_server.py:176-278) on a torch device: OMR-unrolled raw scans build
the sheet DB (sliding windows, stride context//4; on the host, or with
``--device_db`` on the device), queries are spectrograms of real or
synthesized performances, and the full evaluation dumps
umc_retrieval_<tag>_<dset>_A2S[_real].yaml rank lists.

    python -m audio_sheet_retrieval_tpu_torch.cli.umc_a2s_server \
        --data_dir <umc dir> --param_file <ckpt> --init_sheet_db \
        --full_eval [--device_db] [--dump_results] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

from audio_sheet_retrieval_tpu_torch.cli.audio_sheet_server import (
    evaluate,
    experiment_tag,
    param_file_for,
)
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor
from audio_sheet_retrieval_tpu_torch.retrieval import umc
from audio_sheet_retrieval_tpu_torch.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import RetrievalWrapper
from audio_sheet_retrieval_tpu_torch.utils.audio_io import read_audio


def add_umc_args(parser) -> None:
    """The flags both UMC servers share."""
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--device", default="cuda",
                        help="torch device the U-Nets, model and gallery "
                             "live on")
    parser.add_argument("--estimate_UV", action="store_true")
    parser.add_argument("--full_eval", action="store_true")
    parser.add_argument("--real_perf", action="store_true")
    parser.add_argument("--n_candidates", type=int, default=25)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dump_results", action="store_true")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--omr_models", type=str, default=umc.DEFAULT_OMR_DIR)
    parser.add_argument("--omr_map_bits", type=int, default=16,
                        choices=(8, 16),
                        help="probability-map download precision: 8 "
                        "halves it; 16 = strict")


def load_umc(args, require_performance: bool):
    """-> (the server with its embedding network, piece names, piece dirs,
    unrolled strips, the dataset's name, the params file)."""
    model_cfg = get_model_config(args.model)
    tag = experiment_tag(args)
    print("Experimental Tag:", tag)
    te_pieces, piece_paths, unwrapped_sheets = umc.load_umc_sheets(
        args.data_dir, require_performance=require_performance,
        omr=umc.make_omr(args.omr_models, map_bits=args.omr_map_bits,
                         device=args.device))
    srv = AudioSheetServer(
        sheet_shape=(model_cfg.input_shape_1[1], model_cfg.input_shape_1[2]),
        spec_shape=(model_cfg.input_shape_2[1], model_cfg.input_shape_2[2]),
        device=args.device)
    dump_file = param_file_for(args, model_cfg, tag)
    srv.initialize_embedding_network(RetrievalWrapper(
        model_cfg, param_file=dump_file, device=args.device))
    dset = os.path.basename(args.data_dir.rstrip("/"))
    return srv, te_pieces, piece_paths, unwrapped_sheets, dset, dump_file


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Audio to sheet retrieval on real sheet music.")
    add_umc_args(parser)
    parser.add_argument("--init_sheet_db", action="store_true")
    parser.add_argument("--db_file", type=str, default="umc_sheet_db_file.pkl")
    parser.add_argument("--device_db", action="store_true",
                        help="device DB build: each strip uploads once, "
                             "windows and embedding on the device")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    srv, te_pieces, piece_paths, strips, dset, dump_file = load_umc(
        args, require_performance=args.real_perf)

    if args.init_sheet_db or not os.path.exists(args.db_file):
        if args.device_db:
            srv.initialize_sheet_db_from_imges_device(te_pieces, strips)
        else:
            srv.initialize_sheet_db_from_imges(te_pieces, strips)
        srv.save_sheet_db_file(args.db_file)
    else:
        srv.load_sheet_db_file(args.db_file)

    if not args.full_eval:
        return None

    pattern = "01_performance" if args.real_perf else "score_ppq"
    audio = {}
    for tp, path in zip(te_pieces, piece_paths):
        audio_file = umc.get_performance_audio_path(path, pattern)
        if audio_file is not None and os.path.exists(audio_file):
            audio[tp] = audio_file
    proc = AudioProcessor(device=args.device)

    def detect(tp):
        signal, sr = read_audio(audio[tp])
        return srv.detect_score(proc.process(signal, sample_rate=sr),
                                top_k=len(te_pieces),
                                n_candidates=args.n_candidates)

    ret_dir = "A2S" + ("_real" if args.real_perf else "")
    return evaluate([tp for tp in te_pieces if tp in audio], detect,
                    "scores", dump_file, args.dump_results,
                    "%s_%s.yaml" % (dset, ret_dir), prefix="umc_retrieval_")


if __name__ == "__main__":
    main()
