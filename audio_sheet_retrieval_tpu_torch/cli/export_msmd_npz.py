"""Export an MSMD corpus to this framework's .npz piece format.

The port's copy of the JAX package's ``cli/export_msmd_npz.py``, over the
port's loader; the files are the ones the JAX package's
``data/msmd.py:load_piece_npz`` reads.

Runs where the ``msmd`` package + corpus exist; the resulting directory
feeds every CLI via ``--data npz:<dir>`` (one ``<piece>.npz`` per piece with
``image`` [H, W] uint8, ``spec_<k>`` [bins, T] float32 and ``o2c_<k>``
[N, 2] int64 per performance — see data/msmd.py:load_piece_npz).

This front-loads the slow host-side MSMD loading (score parsing, alignment,
unwrapping) once, so training/eval environments only need numpy files.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from audio_sheet_retrieval_tpu_torch import config as cfg_mod
from audio_sheet_retrieval_tpu_torch.data.msmd import prepare_piece_data_msmd
from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT


def export_piece(collection_dir: str, piece: str, out_dir: str,
                 aug_config=None) -> str:
    image, specs, o2c_maps = prepare_piece_data_msmd(
        collection_dir, piece, aug_config=aug_config or NO_AUGMENT)
    payload = {"image": np.asarray(image, np.uint8)}
    for k, (sp, oc) in enumerate(zip(specs, o2c_maps)):
        payload[f"spec_{k}"] = np.asarray(sp, np.float32)
        payload[f"o2c_{k}"] = np.asarray(oc, np.int64)
    out = os.path.join(out_dir, piece + ".npz")
    np.savez_compressed(out, **payload)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export MSMD pieces to npz.")
    parser.add_argument("--train_split", required=True,
                        help="split yaml; all three lists are exported")
    parser.add_argument("--config", default=None,
                        help="experiment config (synth/tempo filtering for "
                             "the train list)")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--collection_dir", default=None)
    args = parser.parse_args(argv)

    collection = args.collection_dir or cfg_mod.DATA_ROOT_MSMD
    exp = cfg_mod.load_experiment_config(args.config)
    split = cfg_mod.load_split(args.train_split)
    os.makedirs(args.out_dir, exist_ok=True)

    n_ok = 0
    for part, aug in (("train", exp.augment), ("valid", NO_AUGMENT),
                      ("test", NO_AUGMENT)):
        for piece in split.get(part, []):
            try:
                out = export_piece(collection, piece, args.out_dir, aug)
                n_ok += 1
                print("exported", out)
            except Exception as e:
                print(f"Problems with exporting piece {piece}: {e!r}")
    print(f"exported {n_ok} pieces to {args.out_dir}")
    return n_ok


if __name__ == "__main__":
    main()
