"""Dataset assembly: MSMD (when available), precomputed pieces or synthetic
pools.

The port's own copy of the JAX package's ``data/msmd.py`` (parity with
reference:utils/mutopia_data.py:21-98: per-piece try/except loading,
config-driven context/augment overrides, test-time synth+tempo override,
train(aug, shuffled)/valid(no-aug)/test(no-aug) pool construction). Three
sources:

  * ``mutopia``     — the MSMD collection under ``config.DATA_ROOT_MSMD``
    (``ASR_TPU_DATA_ROOT_MSMD``), read through the ``msmd`` package
    (piece/score object model + alignment, reference data_pools.py:369-439),
    which is imported only when a piece is loaded
  * ``synthetic``   — generated pieces (data/synthetic.py)
  * ``npz:<dir>``   — precomputed pieces, one ``<piece>.npz`` per piece with
    arrays ``image`` [H, W] uint8, ``spec_<k>`` [bins, T] float32 and
    ``o2c_<k>`` [N, 2] int for each performance k (what
    ``cli/export_msmd_npz.py`` writes).

Everything here is host code (numpy); a performance without a precomputed
spectrogram is run through the numpy DSP chain,
``ops.audio.AudioProcessor.process_host``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from audio_sheet_retrieval_tpu_torch import config as cfg_mod
from audio_sheet_retrieval_tpu_torch.data import pools
from audio_sheet_retrieval_tpu_torch.data.pools import (
    NO_AUGMENT,
    AudioScoreRetrievalPool,
)


def msmd_available() -> bool:
    try:
        import msmd  # noqa: F401

        return True
    except ImportError:
        return False


def _performance_spectrogram(performance) -> np.ndarray:
    """Load a performance's log-filterbank spectrogram, computing it from
    raw audio when the precomputed feature is absent.

    The MSMD corpus ships ``features/*_spec.npy`` per performance
    (reference audio_sheet_server.py:634) but real collections have holes;
    the fallback decodes the audio (``load_audio()`` -> (signal, sr) or an
    ``audio_path`` attribute via utils.audio_io) and runs the
    madmom-equivalent DSP chain on the host — including the polyphase
    resample for non-22050 Hz material."""
    try:
        return performance.load_spectrogram()
    except Exception:
        pass
    from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor

    load_audio = getattr(performance, "load_audio", None)
    if callable(load_audio):
        signal, sr = load_audio()
    else:
        audio_path = getattr(performance, "audio_path", None)
        if audio_path is None:
            raise IOError(
                f"performance {getattr(performance, 'key', '?')} has "
                "neither a spectrogram nor audio")
        from audio_sheet_retrieval_tpu_torch.utils.audio_io import read_audio

        signal, sr = read_audio(audio_path)
    return AudioProcessor(device="cpu").process_host(np.asarray(signal),
                                                     sample_rate=int(sr))


def prepare_piece_data_msmd(collection_dir: str, piece_name: str,
                            aug_config=NO_AUGMENT, require_audio=False):
    """Real-MSMD piece loader (reference data_pools.py:369-439): stitch pages,
    unwrap systems, align performances, build onset->coord maps.

    Ragged-corpus behavior (the JAX package's hardening over the reference,
    whose per-PIECE try/except discards a whole piece when any one
    performance fails — mutopia_data.py:31-37): a performance with a
    broken/empty alignment or unusable features is skipped with a warning
    and the piece survives with its remaining performances; missing
    precomputed spectrograms fall back to DSP from audio (any sample
    rate)."""
    from msmd.alignments import align_score_to_performance
    from msmd.data_model.piece import Piece
    from msmd.midi_parser import FPS, notes_to_onsets

    piece = Piece(root=collection_dir, name=piece_name)
    score = piece.load_score(piece.available_scores[0])
    mungos = score.load_mungos()
    mdict = {m.objid: m for m in mungos}
    mungos_per_page = score.load_mungos(by_page=True)
    images = score.load_images()

    coords_per_page = [
        {m.objid: m.middle for m in page} for page in mungos_per_page
    ]
    systems_per_page = [
        [m.bounding_box for m in page if m.clsname == "staff"]
        for page in mungos_per_page
    ]
    image, coords, systems = pools.stack_images(
        images, coords_per_page, systems_per_page)

    # system order + notehead assignment via mungo links
    page_mungos = [m for page in mungos_per_page for m in page]
    system_mungos = sorted(
        [c for c in page_mungos if c.clsname == "staff"], key=lambda m: m.top)
    assignment = [
        [i for i in sm.inlinks if mdict[i].clsname == "notehead-full"]
        for sm in system_mungos
    ]
    un_wrapped_image, un_wrapped_coords = pools.unwrap_sheet_image(
        image, [sm.bounding_box for sm in system_mungos], coords,
        note_system_assignment=assignment)

    spectrograms, o2c_maps = [], []
    for performance_key in piece.available_performances:
        tempo, synth = performance_key.split("tempo-")[1].split("_", 1)
        tempo = float(tempo) / 1000
        if (synth not in aug_config["synths"]
                or tempo < aug_config["tempo_range"][0]
                or tempo > aug_config["tempo_range"][1]):
            continue
        try:
            performance = piece.load_performance(performance_key,
                                                 require_audio=require_audio)
            alignment = align_score_to_performance(score, performance)
            if len(alignment) == 0:
                raise ValueError("empty alignment")
            note_events = performance.load_note_events()
            spec = _performance_spectrogram(performance)
            pairs = []
            for m_objid, e_idx in alignment:
                # a corrupt alignment can reference e_idx out of range of
                # note_events: the same broken-performance class as an
                # empty alignment, so it stays inside this skip guard
                onset_frame = notes_to_onsets([note_events[e_idx]],
                                              dt=1.0 / FPS)
                # notes_to_onsets returns an array of unique onset frames;
                # a single event yields one entry (numpy>=2 forbids
                # int(array))
                pairs.append((m_objid, int(np.atleast_1d(onset_frame)[0])))
            o2c = pools.onset_to_coordinates(pairs, un_wrapped_coords)
        except Exception:
            # skip the broken performance, keep the piece (see docstring)
            print("Problems with performance %s of %s"
                  % (performance_key, piece_name))
            print(sys.exc_info()[0])
            continue
        spectrograms.append(spec)
        o2c_maps.append(o2c)

    return un_wrapped_image, spectrograms, o2c_maps


def load_piece_npz(path: str):
    """-> (image, [spectrograms], [o2c maps]) of one exported piece."""
    data = np.load(path)
    image = data["image"]
    specs, o2cs = [], []
    k = 0
    while f"spec_{k}" in data:
        specs.append(data[f"spec_{k}"])
        o2cs.append(data[f"o2c_{k}"])
        k += 1
    return image, specs, o2cs


def load_piece_list(piece_names: List[str], aug_config=NO_AUGMENT,
                    collection_dir: Optional[str] = None,
                    npz_dir: Optional[str] = None):
    """Per-piece loop with defensive skip (reference mutopia_data.py:21-44):
    from ``npz_dir`` when given, else from the MSMD collection."""
    all_images, all_specs, all_o2c = [], [], []
    for piece_name in piece_names:
        try:
            if npz_dir is not None:
                image, specs, o2cs = load_piece_npz(
                    os.path.join(npz_dir, piece_name + ".npz"))
            else:
                image, specs, o2cs = prepare_piece_data_msmd(
                    collection_dir, piece_name, aug_config=aug_config)
        except Exception:
            print("Problems with loading piece %s" % piece_name)
            print(sys.exc_info()[0])
            continue
        all_images.append(image)
        all_specs.append(specs)
        all_o2c.append(o2cs)
    return all_images, all_specs, all_o2c


def load_audio_score_retrieval(
    split_file: str,
    config_file: Optional[str] = None,
    test_only: bool = False,
    npz_dir: Optional[str] = None,
    seed: int = 23,
    max_train_pieces: Optional[int] = None,
) -> Dict:
    """MSMD analog of reference mutopia_data.py:47-98, from the collection
    or, with ``npz_dir``, from exported pieces.

    ``max_train_pieces`` truncates the train split's piece list — the
    native equivalent of the reference's bach_split_{10,25,50,75} subset
    yamls (train_models_dset_size.sh:11); valid/test splits are untouched.
    """
    exp = cfg_mod.load_experiment_config(config_file)
    augment = dict(exp.augment)
    test_augment = dict(NO_AUGMENT)
    test_augment["synths"] = [exp.test_synth]
    test_augment["tempo_range"] = [exp.test_tempo, exp.test_tempo]

    split = cfg_mod.load_split(split_file)
    pool_kwargs = dict(
        spec_context=exp.spec_context, sheet_context=exp.sheet_context,
        staff_height=exp.system_height)
    src = dict(npz_dir=npz_dir,
               collection_dir=cfg_mod.DATA_ROOT_MSMD if npz_dir is None else None)

    tr_pool = va_pool = None
    if not test_only:
        train_pieces = split["train"]
        if max_train_pieces is not None:
            train_pieces = train_pieces[:max_train_pieces]
        tr = load_piece_list(train_pieces, aug_config=augment, **src)
        tr_pool = AudioScoreRetrievalPool(
            *tr, data_augmentation=augment, shuffle=True,
            rng=np.random.default_rng(seed), **pool_kwargs)
        print("Train: %d" % tr_pool.shape[0])
        va = load_piece_list(split["valid"], aug_config=NO_AUGMENT, **src)
        va_pool = AudioScoreRetrievalPool(
            *va, data_augmentation=NO_AUGMENT, shuffle=False,
            rng=np.random.default_rng(seed + 1), **pool_kwargs)
        va_pool.reset_batch_generator()
        print("Valid: %d" % va_pool.shape[0])

    te = load_piece_list(split["test"], aug_config=test_augment, **src)
    te_pool = AudioScoreRetrievalPool(
        *te, data_augmentation=NO_AUGMENT, shuffle=False,
        rng=np.random.default_rng(seed + 2), **pool_kwargs)
    print("Test: %d" % te_pool.shape[0])

    return dict(train=tr_pool, valid=va_pool, test=te_pool, train_tag="")


def select_data(data_name: str, split_file: Optional[str],
                config_file: Optional[str], seed: int = 23,
                test_only: bool = False,
                max_train_pieces: Optional[int] = None) -> Dict:
    """Data selector (reference run_train.py:32-41) with the MSMD, npz and
    synthetic sources. ``max_train_pieces`` subsets the training pieces
    (dataset-size sweeps, train_models_dset_size.sh)."""
    if data_name == "mutopia":
        return load_audio_score_retrieval(split_file, config_file,
                                          test_only=test_only, seed=seed,
                                          max_train_pieces=max_train_pieces)
    if data_name.startswith("npz:"):
        return load_audio_score_retrieval(split_file, config_file,
                                          test_only=test_only, seed=seed,
                                          npz_dir=data_name[4:],
                                          max_train_pieces=max_train_pieces)
    if data_name == "synthetic":
        from audio_sheet_retrieval_tpu_torch.data import synthetic

        exp = cfg_mod.load_experiment_config(config_file)
        kw = {}
        if max_train_pieces is not None:
            kw["n_train"] = max_train_pieces
        return synthetic.load_synthetic_retrieval(
            seed=seed, augment=exp.augment, test_only=test_only, **kw)
    raise ValueError(f"unknown data source: {data_name}")
