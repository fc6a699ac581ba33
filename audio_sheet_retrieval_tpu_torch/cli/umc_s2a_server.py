"""Sheet -> audio retrieval on real (UMC-style) sheet music scans.

The JAX package's ``cli/umc_s2a_server.py`` (reference
umc_s2a_server.py:40-123) on a torch device: an audio-excerpt DB from the
performances' spectrograms (on the host, or with ``--device_db`` on the
device), queries are the OMR-unrolled sheet strips, and the full
evaluation dumps umc_retrieval_<tag>_<dset>_S2A[_real].yaml rank lists.

    python -m audio_sheet_retrieval_tpu_torch.cli.umc_s2a_server \
        --data_dir <umc dir> --param_file <ckpt> --init_audio_db \
        --full_eval [--device_db] [--dump_results] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

from audio_sheet_retrieval_tpu_torch.cli.audio_sheet_server import evaluate
from audio_sheet_retrieval_tpu_torch.cli.umc_a2s_server import (
    add_umc_args,
    load_umc,
)
from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor
from audio_sheet_retrieval_tpu_torch.retrieval import umc
from audio_sheet_retrieval_tpu_torch.utils.audio_io import read_audio


def load_specs(piece_paths, audio_file: str, *, device):
    """Spectrograms of each piece's performance (umc_a2s_server.py:34-44),
    computed on ``device``."""
    proc = AudioProcessor(device=device)
    spectrograms = []
    for piece_path in piece_paths:
        path = umc.get_performance_audio_path(piece_path, audio_file)
        signal, sr = read_audio(path)
        spectrograms.append(proc.process(signal, sample_rate=sr))
    return spectrograms


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Sheet to audio retrieval on real sheet music.")
    add_umc_args(parser)
    parser.add_argument("--init_audio_db", action="store_true")
    parser.add_argument("--db_file", type=str, default="umc_audio_db_file.pkl")
    parser.add_argument("--device_db", action="store_true",
                        help="device DB build: each spectrogram uploads "
                             "once, windows and embedding on the device")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    srv, te_pieces, piece_paths, strips, dset, dump_file = load_umc(
        args, require_performance=True)

    print("Loading spectrograms ...")
    audio_file = "01_performance" if args.real_perf else "score_ppq"
    spectrograms = load_specs(piece_paths, audio_file=audio_file,
                              device=args.device)

    if args.init_audio_db or not os.path.exists(args.db_file):
        if args.device_db:
            srv.initialize_audio_db_from_specs_device(te_pieces,
                                                      spectrograms)
        else:
            srv.initialize_audio_db_from_specs(te_pieces, spectrograms)
        srv.save_audio_db_file(args.db_file)
    else:
        srv.load_audio_db_file(args.db_file)

    if not args.full_eval:
        return None

    strip_of = dict(zip(te_pieces, strips))

    def detect(tp):
        return srv.detect_performance(strip_of[tp], top_k=len(te_pieces),
                                      n_candidates=args.n_candidates)

    ret_dir = "S2A" + ("_real" if args.real_perf else "")
    return evaluate(te_pieces, detect, "performances", dump_file,
                    args.dump_results, "%s_%s.yaml" % (dset, ret_dir),
                    prefix="umc_retrieval_")


if __name__ == "__main__":
    main()
