"""Audio -> sheet-music piece-identification service / full evaluation.

CLI parity with reference:audio_sheet_server.py:566-687 and the JAX
package's ``cli/audio_sheet_server.py``: build or load the sheet-snippet DB
over the test pieces, then either identify a single query performance or
run the full per-piece evaluation with rank bookkeeping (and a
retrieval_<tag>_A2S.yaml dump).

Ported so far: ``--data synthetic`` (the stored spectrograms act as the
performance recordings), ``--full_eval`` (with ``--fused``: the
spectrogram-upload device query) and the single-piece ``detect_score``
demo. Not yet: the npz and MSMD sources (they need the audio front end,
ROADMAP Queue 1 #2) and streaming (Queue 1 #5), which raise
``NotImplementedError``. yaml is imported only by the options that read or
write yaml files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from audio_sheet_retrieval_tpu.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import RetrievalWrapper
from audio_sheet_retrieval_tpu_torch.utils.logging import BColors

col = BColors()

STREAMING_TODO = ("streaming retrieval is not ported yet (ROADMAP Queue 1 "
                  "#5: retrieval/streaming.py, AudioSheetServer.run)")


def make_piece_source(data: str, n_test: int):
    """-> (test piece names, loader(name) -> (image, specs, o2c_maps),
    query_spec(name) -> full spectrogram)."""
    if data == "synthetic":
        from audio_sheet_retrieval_tpu.data import synthetic

        names = ["synthetic_%03d" % i for i in range(n_test)]
        images, specs, o2cs = synthetic.make_piece_list(
            25, len(names), n_onsets=60)
        table = {n: (images[i], specs[i], o2cs[i])
                 for i, n in enumerate(names)}
        return (names, lambda n: table[n], lambda n: table[n][1][0])
    raise NotImplementedError(
        f"--data {data}: only 'synthetic' is ported; the npz and MSMD "
        f"sources need the audio front end (ROADMAP Queue 1 #2)")


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Run audio 2 sheet music retrieval service (PyTorch).")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="synthetic")
    parser.add_argument("--device", default="cuda",
                        help="torch device the model and gallery live on")
    parser.add_argument("--estimate_UV", action="store_true")
    parser.add_argument("--init_sheet_db", action="store_true")
    parser.add_argument("--full_eval", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="full_eval queries through the spectrogram-"
                             "upload device query (detect_score_from_spec, "
                             "u16 wire) instead of detect_score — same "
                             "rankings")
    parser.add_argument("--n_candidates", type=int, default=25)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dump_results", action="store_true")
    parser.add_argument("--conv_precision", default=None,
                        choices=["highest", "high", "default"],
                        help="f32 conv precision; only 'highest' (full f32, "
                             "TF32 off) is ported")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--db_file", type=str, default="sheet_db_file.pkl")
    parser.add_argument("--n_test_pieces", type=int, default=None,
                        help="synthetic source: number of test pieces")
    parser.add_argument("--no_stream", action="store_true",
                        help="single-piece demo: run detect_score only, "
                             "without the streaming stage (not ported yet)")
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    model_cfg = get_model_config(args.model)
    if args.conv_precision is not None:
        model_cfg = dataclasses.replace(model_cfg,
                                        conv_precision=args.conv_precision)
    if args.train_split or args.config or args.dump_results:
        from audio_sheet_retrieval_tpu import config as cfg_mod  # yaml
    tag = (cfg_mod.compile_tag(args.train_split, args.config)
           if args.train_split or args.config else None)
    print("Experimental Tag:", tag)

    if args.train_split:
        n_test = len(cfg_mod.load_split(args.train_split)["test"])
    else:
        n_test = args.n_test_pieces or 8

    exp_name = model_cfg.name + ("_est_UV" if args.estimate_UV else "")
    dump_file = args.param_file
    if dump_file is None:
        from audio_sheet_retrieval_tpu import config as cfg_mod  # yaml

        exp_root = args.exp_root or cfg_mod.EXP_ROOT
        name = "params.pkl" if tag is None else "params_%s.pkl" % tag
        dump_file = os.path.join(exp_root, exp_name, name)

    srv = AudioSheetServer(
        sheet_shape=(model_cfg.input_shape_1[1], model_cfg.input_shape_1[2]),
        spec_shape=(model_cfg.input_shape_2[1], model_cfg.input_shape_2[2]),
        device=args.device)
    srv.initialize_embedding_network(
        RetrievalWrapper(model_cfg, param_file=dump_file, device=args.device))

    te_pieces, loader, query_spec = make_piece_source(args.data, n_test)

    if args.init_sheet_db or not os.path.exists(args.db_file):
        srv.initialize_sheet_db(te_pieces, loader)
        srv.save_sheet_db_file(args.db_file)
    else:
        srv.load_sheet_db_file(args.db_file)

    if args.full_eval:
        print(col.print_colored("\nRunning full evaluation:", col.UNDERLINE))
        ranks = []
        for tp in te_pieces:
            spec = query_spec(tp)
            if args.fused:
                ret_result, ret_votes = srv.detect_score_from_spec(
                    spec, top_k=len(te_pieces),
                    n_candidates=args.n_candidates, quantize=16)
            else:
                ret_result, ret_votes = srv.detect_score(
                    spec, top_k=len(te_pieces),
                    n_candidates=args.n_candidates)
            if tp in ret_result:
                rank = ret_result.index(tp) + 1
                ratio = ret_votes[ret_result.index(tp)]
            else:
                rank = len(ret_result)
                ratio = 0.0
            ranks.append(rank)
            color = col.OKBLUE if rank == 1 else col.WARNING
            print(col.print_colored("rank: %02d (%.2f) " % (rank, ratio),
                                    color) + tp)

        ranks = np.asarray(ranks)
        for r in range(1, len(ranks) + 1):
            n_correct = int(np.sum(ranks == r))
            if n_correct > 0:
                print(col.print_colored(
                    "%d of %d retrieved scores ranked at position %d."
                    % (n_correct, len(ranks), r), col.WARNING))

        if args.dump_results:
            import yaml

            res_file = cfg_mod.derive_result_path(
                dump_file, "retrieval_", "A2S.yaml")
            os.makedirs(os.path.dirname(os.path.abspath(res_file)),
                        exist_ok=True)
            with open(res_file, "w") as fp:
                yaml.safe_dump([int(r) for r in ranks], fp,
                               default_flow_style=False)
            print("dumped results to", res_file)
        return list(ranks)

    # single-piece demo (+ streaming, not ported yet)
    tp = te_pieces[0]
    spec = query_spec(tp)
    print(col.print_colored("\nQuery piece: %s" % tp, color=col.OKBLUE))
    srv.detect_score(spec, top_k=min(7, len(te_pieces)),
                     n_candidates=args.n_candidates, verbose=True)
    if not args.no_stream:
        raise NotImplementedError(
            STREAMING_TODO + "; pass --no_stream to run the detect_score "
            "demo alone")
    return None


if __name__ == "__main__":
    main()
