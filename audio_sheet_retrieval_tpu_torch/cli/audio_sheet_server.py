"""Audio -> sheet-music piece-identification service / full evaluation.

CLI parity with reference:audio_sheet_server.py:566-687 and the JAX
package's ``cli/audio_sheet_server.py``: build or load the sheet-snippet DB
over the test pieces, then either identify a single query performance and
stream it (the device stream by default, the host loop with
``--host_stream``) or run the full per-piece evaluation with rank
bookkeeping (and a retrieval_<tag>_A2S.yaml dump).

Sources: ``--data synthetic``, ``--data npz:<dir>`` (one ``<piece>.npz``
per test piece of ``--train_split``, as ``cli/export_msmd_npz.py`` writes
them), whose stored spectrograms act as the performance recordings, and
``--data mutopia``: the MSMD collection under ``ASR_TPU_DATA_ROOT_MSMD``
through the ``msmd`` package, queried with the test performance's audio.
yaml is imported only by the options that read or write yaml files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from audio_sheet_retrieval_tpu_torch import config as cfg_mod
from audio_sheet_retrieval_tpu_torch.data import synthetic
from audio_sheet_retrieval_tpu_torch.data.msmd import load_piece_npz
from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
from audio_sheet_retrieval_tpu_torch.retrieval.server import AudioSheetServer
from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import RetrievalWrapper
from audio_sheet_retrieval_tpu_torch.utils.logging import BColors

col = BColors()


def make_piece_source(data: str, split: dict, config_file=None, *,
                      device="cuda"):
    """-> (test piece names, loader(name) -> (image, specs, o2c_maps),
    query_spec(name) -> full spectrogram). ``mutopia`` reads the MSMD
    collection under ``config.DATA_ROOT_MSMD``; its query is the test
    performance's audio (``exp.test_synth`` of ``config_file``) through the
    DSP chain on ``device``, or its precomputed ``_spec.npy``."""
    if data == "synthetic":
        names = ["synthetic_%03d" % i for i in range(len(split["test"]))]
        images, specs, o2cs = synthetic.make_piece_list(
            25, len(names), n_onsets=60)
        table = {n: (images[i], specs[i], o2cs[i])
                 for i, n in enumerate(names)}
        return (names, lambda n: table[n], lambda n: table[n][1][0])
    if data.startswith("npz:"):
        npz_dir = data[4:]
        names = split["test"]

        def loader(n):
            return load_piece_npz(os.path.join(npz_dir, n + ".npz"))

        return names, loader, lambda n: loader(n)[1][0]
    if data == "mutopia":
        from audio_sheet_retrieval_tpu_torch.data.msmd import (
            prepare_piece_data_msmd,
        )
        from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor
        from audio_sheet_retrieval_tpu_torch.utils.audio_io import read_audio

        exp = cfg_mod.load_experiment_config(config_file)
        names = split["test"]

        def loader(n):
            return prepare_piece_data_msmd(cfg_mod.DATA_ROOT_MSMD, n)

        def query_spec(n):
            audio_file = os.path.join(
                cfg_mod.DATA_ROOT_MSMD,
                "%s/performances/%s_tempo-1000_%s/%s_tempo-1000_%s.flac"
                % (n, n, exp.test_synth, n, exp.test_synth))
            if os.path.exists(audio_file):
                signal, sr = read_audio(audio_file)
                return AudioProcessor(device=device).process(
                    signal, sample_rate=sr)
            spec_file = os.path.join(
                cfg_mod.DATA_ROOT_MSMD,
                "%s/performances/%s_tempo-1000_%s/features/"
                "%s_tempo-1000_%s.flac_spec.npy"
                % (n, n, exp.test_synth, n, exp.test_synth))
            return np.load(spec_file)

        return names, loader, query_spec
    raise ValueError(f"unknown data source {data}")


def load_split(train_split, n_test_pieces):
    """{"test": piece names}: the yaml split, or n placeholders (the
    synthetic source only counts them)."""
    if train_split:
        return cfg_mod.load_split(train_split)
    return {"test": ["x"] * (n_test_pieces or 8)}


def experiment_tag(args):
    """`<split-stem>_<config-stem>`, or None without a split or config."""
    if not (args.train_split or args.config):
        return None
    return cfg_mod.compile_tag(args.train_split, args.config)


def param_file_for(args, model_cfg, tag):
    """--param_file, or the experiment's params file under --exp_root."""
    if args.param_file is not None:
        return args.param_file
    exp_name = model_cfg.name + ("_est_UV" if args.estimate_UV else "")
    exp_root = args.exp_root or cfg_mod.EXP_ROOT
    name = "params.pkl" if tag is None else "params_%s.pkl" % tag
    return os.path.join(exp_root, exp_name, name)


def evaluate(pieces, detect, what: str, dump_file: str, dump_results: bool,
             suffix: str, prefix: str = "retrieval_"):
    """Rank of each piece's own entry under ``detect(name) -> (ranking,
    vote shares)`` (a piece missing from the ranking gets its length), a
    per-position summary, and with ``dump_results`` the rank list as
    ``<prefix><tag>_<suffix>`` beside the params file. -> the ranks."""
    print(col.print_colored("\nRunning full evaluation:", col.UNDERLINE))
    ranks = []
    for tp in pieces:
        ret_result, ret_votes = detect(tp)
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
                "%d of %d retrieved %s ranked at position %d."
                % (n_correct, len(ranks), what, r), col.WARNING))

    if dump_results:
        import yaml

        res_file = cfg_mod.derive_result_path(dump_file, prefix, suffix)
        os.makedirs(os.path.dirname(os.path.abspath(res_file)),
                    exist_ok=True)
        with open(res_file, "w") as fp:
            yaml.safe_dump([int(r) for r in ranks], fp,
                           default_flow_style=False)
        print("dumped results to", res_file)
    return list(ranks)


def build_arg_parser():
    parser = argparse.ArgumentParser(
        description="Run audio 2 sheet music retrieval service (PyTorch).")
    parser.add_argument("--model", default="mutopia_ccal_cont_rsz")
    parser.add_argument("--data", default="mutopia")
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
    parser.add_argument("--running_frames", type=int, default=100)
    parser.add_argument("--n_candidates", type=int, default=25)
    parser.add_argument("--train_split", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dump_results", action="store_true")
    parser.add_argument("--conv_precision", default=None,
                        choices=["highest", "high", "default"],
                        help="f32 conv precision: 'highest' or 'high' "
                             "(both full f32, TF32 off: see "
                             "cca_model.check_numerics); 'default' is not "
                             "ported")
    parser.add_argument("--exp_root", type=str, default=None)
    parser.add_argument("--param_file", type=str, default=None)
    parser.add_argument("--db_file", type=str, default="sheet_db_file.pkl")
    parser.add_argument("--n_test_pieces", type=int, default=None,
                        help="synthetic source: number of test pieces")
    parser.add_argument("--host_stream", action="store_true",
                        help="stream through the reference-style host loop "
                             "instead of the device stream")
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

    te_pieces, loader, query_spec = make_piece_source(
        args.data, split, args.config, device=args.device)

    if args.init_sheet_db or not os.path.exists(args.db_file):
        srv.initialize_sheet_db(te_pieces, loader)
        srv.save_sheet_db_file(args.db_file)
    else:
        srv.load_sheet_db_file(args.db_file)

    if args.full_eval:
        def detect(tp):
            if args.fused:  # u16 wire, same rankings
                return srv.detect_score_from_spec(
                    query_spec(tp), top_k=len(te_pieces),
                    n_candidates=args.n_candidates, quantize=16)
            return srv.detect_score(query_spec(tp), top_k=len(te_pieces),
                                    n_candidates=args.n_candidates)

        return evaluate(te_pieces, detect, "scores", dump_file,
                        args.dump_results, "A2S.yaml")

    # single-piece demo + streaming
    tp = te_pieces[0]
    spec = query_spec(tp)
    print(col.print_colored("\nQuery piece: %s" % tp, color=col.OKBLUE))
    top_k = min(7, len(te_pieces))
    srv.detect_score(spec, top_k=top_k, n_candidates=args.n_candidates,
                     verbose=True)
    if args.host_stream:
        srv.run(spec, top_k=top_k, n_candidates=args.n_candidates,
                running_frames=args.running_frames, target_piece=tp,
                max_frames=200)
    else:
        ranking, votes, fps = srv.run_device_stream(
            spec, top_k=top_k, n_candidates=args.n_candidates,
            running_frames=args.running_frames, max_frames=200)
        print("device streaming at %.1f frames/s; top: %s"
              % (fps, ranking[:3]))
    return None


if __name__ == "__main__":
    main()
