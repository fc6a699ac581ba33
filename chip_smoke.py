"""Smoke run of the PyTorch port on one CUDA card (an H100 / sm_90a).

    python3 chip_smoke.py

Phases, each printed as JSON lines (any failure raises and the script
exits non-zero):

1. device: the card's name and power limit; TF32 off for convolutions and
   matmuls.
2. build: the four CUDA sources compiled from
   ``audio_sheet_retrieval_tpu_torch/csrc`` with nvcc, one process each,
   all started together (ptxas register / shared-memory report).
3. kernels: each kernel against its plain PyTorch version on the card
   (top-k: scores atol 1e-4, equal index sets, tie rule, NaN queries, k up
   to 20,000 and k = N, at the boundaries of its launch plan (query-block
   widths, k <= 32 or above, d in {8, 32, 128}, N off the tile, scores in
   shared and in global memory), the evaluation's shapes Q = N = 2,000 at
   d = 32 and 16, and every shape it is timed at; the streaming pass 1 at
   a catalogue's 4,194,304 rows and one more, Q in {1, 8, 100, 128}, k in
   {1, 25, 32}, d in {8, 20, 32}, on duplicate rows and NaN queries, and
   bit-identical to the chunked pass 1 at Q = 100, k = 25, with the count
   of searches it took; gather: bit-identical,
   f32 and bf16, at the serving shape, 1 to 1,000 windows, a short strip,
   one column, 1 and 96 channels, starts at both ends of the legal range
   and beyond it (the all-ones pattern)), and each one's median time beside the
   plain version's, the least time the card could take (``bound_ms``:
   bytes at 3.35 TB/s or float32 FMAs at 67 TFLOP/s, the larger) and one
   library call's (``torch.topk(q @ g.T, k)``; one ``torch.gather`` over
   the expanded plane), CUDA events after a warm-up, at the serving
   shapes: Q = 100 excerpts, the streaming shapes Q = 1 and Q = 8, the
   evaluation's Q = N = 2,000, k = 1,024 and 2,048, and Q = 100 at a
   catalogue's 4,194,304 rows (the streaming pass 1); the gather and its
   library call also by their device time (``device_us``,
   ``library_device_us``, torch.profiler: the event time of so short a
   launch is host time), with the share of the bound the kernel's device
   time reaches.
4. main path: the vendored synthetic-corpus serving checkpoint at full
   width (``mutopia_ccal_cont_rsz``, f32), a 60-piece synthetic corpus,
   gallery built on the card, 100-excerpt piece-ID queries; rank<=1 >= 59/60
   and per-query ranks equal to a replay through the plain top-k.
5. fullconv: the same gallery through the strip-level first block and the
   feature-window gather kernel; the same embeddings as through the plain
   gather, rank<=1 >= 59/60, and the cosine to the exact build reported.
   The ``gather_half`` strip path equals the standard one bit for bit at
   even window starts.
6. cli: both server CLIs' full evaluations (audio -> sheet and sheet ->
   audio, 8 pieces), each with and without ``--fused``: the same ranks.
7. s2a: sheet -> audio on the 60-piece corpus: the audio DB built on the
   card (u16 upload), each strip queried with
   ``detect_performance_from_sheet`` (the strip up as the rle2 wire); ranks
   equal to a replay through the raw strips and the
   plain top-k, rank<=1 at least the JAX package's own count less one.
8. streaming: ``run_device_stream`` over 400 frames of three pieces against
   phase 4's gallery, at chunk 8 and per frame; vote histograms equal to
   the host loop ``run``'s; frames/s, also against a 10^6-row gallery.
9. audio: ``AudioProcessor.process`` on the card against the golden
   spectrogram (2e-5) and the numpy DSP (2e-4), the golden spectrogram
   codes of the tutorial checkpoint (2e-4), and the mu-law raw-audio query
   ``detect_score_from_audio`` against process -> ``detect_score``: the
   same top-1, votes within 0.05.

10. evaluate / refine: ``cli.run_eval.main`` on the synthetic test set
   (2,000 queries, both directions, and ``--estimate_UV`` on the refitted
   file): its ranks up to 25 come from the top-k kernel and equal the full
   argsort's, and its report equals a replay on the host copy of the codes;
   ``cli.refine_cca.refine`` over 10,000 train pairs (60 pieces of 200
   onsets): the canonical correlations within 1e-3 of a float64 numpy fit
   of the same latents (the eigen and eigen-4 families and the summed
   moments of two shards too), the refitted checkpoint written in the JAX
   package's format and reloaded to the same embeddings; MRR before and
   after the refit on 2,000 distinct test pairs; unequal galleries and the
   packed 8-vector on the card against the CPU's answers.

11. train: one train step of the full-width model (batch 100, f32, polar)
   on the card against the same step on the CPU from one numpy tree and one
   batch (loss, every gradient, the new BN and CCA state), then the eigh
   whitening on loss and ``corr``; ``train.engine.fit`` over the host
   iterator for 3 epochs from a seeded init with FULL augmentation over 60
   train pieces of 200 onsets (``k_samples`` 10,000: 100 steps a
   sub-epoch) and 5 valid pieces (1,000 pairs): train loss falls,
   validation MRR rises above epoch 1's and above twice chance, no NaN,
   the top-k kernel launched at least twice an epoch, the last
   evaluation's ranks equal the full argsort's, and the dump read back by
   ``run_eval`` gives the MRR ``fit`` reported; ``cli.run_train.main
   --host_data`` on the card (the dump and curves written, no snapshot
   left, the run reporting the host iterator); kill and resume (2 epochs,
   then resumed to 4, over a pool that reshuffles every second epoch) bit
   for bit as an uninterrupted 4-epoch run under deterministic cuDNN; the
   step time (CUDA events), the eigh step, updates/s and seconds an epoch
   inside ``fit`` (step loop, iterator wait, evaluation), launches a step,
   peak memory, and kernel 1 at the evaluation's shape (Q = N = 1,000).

12. device_pool: batches assembled on the card against the CPU from one
   set of draws made on the CPU, bit-identical in every branch of the
   assembly (scale and translation, translation only, scale only,
   neither, the frequency shift), 5 batches of 100 each, and one
   assembly's time; phase 11's fit over the same pieces lifted onto
   device pools (``from_host_pool``, as ``run_train`` lifts them), held to
   phase 11's criteria, its evaluation the fused one
   (``engine.make_fused_eval``, ranks through kernel 1); its updates/s,
   step-loop and evaluation seconds an epoch and peak memory beside phase
   11's; kill and resume over device pools bit for bit; ``run_train``
   without flags, the run reporting the device pool.

13. precision: the JAX package's other three numerics on phase 4's corpus
   and checkpoint at full width. a. ``compute_dtype="bfloat16"`` gallery
   builds in the JAX bench's three serving arms (exact, ``gather_half``,
   fullconv): sheet emb/s, rank<=1 >= 59/60 each, the top-1 piece equal to
   the float32 build's of the same arm on >= 59 of 60 queries, the share
   of excerpts whose nearest gallery row is float32's, query p50, and the
   codes farther from float32's than float32 noise (the build ran bf16);
   kernel 2 on its bf16 path in the fullconv build, each launch
   bit-identical to the plain version on the same plane. b. bf16 sheet ->
   audio: rank<=1 at least the JAX package's own bf16 count less one, the
   audio codes farther from phase 7's than float32 noise; audio emb/s, p50.
   c. ``conv_precision="high"`` (full float32 in the port, as
   ``cca_model.check_numerics`` says): each block's conv of both views
   against float64 on its real inputs, within 4x the float32 conv's error;
   the gallery codes within 1e-5 of highest's and the ranks equal; a
   float32 forward after a ``high`` one bit-identical to one before it (no
   TF32 left on); emb/s. d. bf16 training: one step card vs CPU (loss
   1e-2) and vs a float64 step (the card's gradient no farther from it,
   relative L2, than twice the CPU's bf16 step, and farther than 10x the
   card's float32 step: the step ran bf16), phase 12's fit in
   bf16 held to phase 11's criteria (``run_eval``, which re-embeds the dump
   in float32, within 1e-2 of the MRR), the step's event ms, device busy
   and peak memory beside float32's.
   e. ``conv_precision="default"`` in float32 (``encoder.TF32``: each
   conv, forward and both gradients, one TF32 pass): the three builds'
   codes farther than 1e-5 from highest's of the same arm (the builds ran
   TF32) and nearer them than 13a's bf16 codes, rank<=1 >= 59/60 and the
   top-1 piece equal to the float32 build's on >= 59 of 60 queries each,
   kernel 1's ranks equal to the plain top-k's replay, kernel 2's float32
   launches in the fullconv build each bit-identical to the plain
   version; the audio DB and sheet -> audio (codes as above, rank<=1 at
   least the JAX package's own count less one: its CPU ``default`` is
   its highest bit for bit); each block's conv error from float64 in
   highest, default and bf16; both TF32 flags off after every default
   call and a float32 forward after a default one bit-identical to one
   before it; one default step (loss within 1e-3 of the card's float32
   step's, its gradient farther from a float64 step than the float32
   step's and nearer than the CPU's bf16 step's: the backward ran TF32)
   and a 3-epoch fit over device pools held to phase 11's criteria
   (``run_eval --conv_precision default`` within 1e-3 of its MRR); OMR
   on the tutorial page under 15b's bf16 gate against the float32 run,
   the system map's u16 codes off float64 in the three modes. Reported:
   each build's sheet emb/s, device ms and MFU against the TF32 peak,
   query p50s, step ms, page ms, each beside highest's and bf16's.

14. alignment: a. both DTW kernels (``csrc/dtw.cu``: the accumulation,
   which writes a direction code a cell and the accumulated costs when
   asked, and the walk over the codes) against their plain versions on
   the card at (90, 70), (64, 128) (wide, so transposed), (70, 65) and
   (604, 860), each with random costs and with costs quantized to
   quarters (many exact ties), at the corpus piece with NaN cells and
   with all-zero costs (every comparison a tie), at 6,000 x 4,000 (with
   NaN cells too) and at 16,500 x 16,400 (65 CTAs handing their columns
   on through L2): the codes, the accumulated costs and the final cost
   bit-identical (NaN where the plain version has NaN), the path
   identical to the plain walk over the codes and to the walk over the
   costs themselves, ``dtw_by_dist`` on the card equal to the CPU's up to
   10^6 cells; their times at the corpus piece's shape and at 6,000 x
   4,000 beside the plain versions', the bound (the bytes against the
   dependency chain: R + C - 1 NaN-propagating min-adds,
   ``dtw_cell_probe``, and the path's steps of one dependent shared byte
   load, ``dtw_walk_probe``) and the barrier floor of a design with one
   CTA-wide barrier a diagonal (the
   diagonals times one empty barrier round, ``dtw_barrier_rounds``). b.
   ``audio2sheet_align.main`` at full width (``mutopia_ccal_cont_rsz``,
   ``synth_serving_ckpt.pkl``) over 12 corpus pieces (``npz:``), in
   ``pydtw`` and ``baseline``, at the CLI's default steps (a 604 x 860
   distance matrix a piece): every onset's pixel error finite, the DTW
   path from the card's distances equal to the CPU's, the card's
   alignment equal to the CPU's from the same codes, the errors' mean and
   median and the seconds a piece; then ``--data synthetic``. c.
   ``--data mutopia`` over the msmd stub (``tests/msmd_stub``, on
   ``sys.path`` for this phase only) against ``--data npz:`` of
   ``export_msmd_npz``'s export of the same pieces: the same errors.

15. OMR (no kernel of its own: the JAX package reaches no ``pallas_call``
   there): the vendored tutorial page through the three vendored U-Nets
   (system, bar, note) on the card, against the JAX package's results in
   ``tests/golden/omr_tutorial_page.npz`` (``scripts/jax_omr_golden.py``),
   the page and map over the rANS wires (the defaults; both rANS kernels
   must launch in c-d).
   a. float32 ``highest``: systems, bars with and without systems, and
   noteheads equal to JAX's; the system map's u16 codes within 1 of JAX's,
   and no more of them off a plain float64 run of the same U-Net and
   blend on the card than JAX's own codes are; ``high`` giving the same
   codes. b. bf16 against that float32 run under the JAX package's own
   bf16 gate (systems and bars within 2 px, as many bars, noteheads
   within 2 % in count), the bf16 map's largest deviation and flip share.
   c. ``tutorial --synth_audio``: 6 systems, the distance matrix within
   1e-3 of JAX's (and the tutorial mp3 where libmpg123.so.0 loads; a line
   says which ran). d. a two-piece UMC directory from the page, written
   with ``imwrite_gray``: ``umc_a2s_server --full_eval`` (host and
   ``--device_db``) and ``umc_s2a_server --full_eval --device_db``, ranks
   equal to JAX's and the yaml dumps read back; ``prepare_umc_data`` on a
   copy at width 1200 writing ``resize_linear_u8``'s pages. e. each net's
   page time (events, 15 tiles, float32 and bf16), tiles per second, peak
   memory and the system net's device time by kind (torch.profiler)
   beside the bound.

16. reports and data parallelism. a. ``reports``' six subcommands over
   the dumps phases 6, 10, 11, 14 and 15d left in a reports directory,
   each row holding its dump's numbers; the model FLOPs of
   ``utils/roofline.py`` and the achieved TFLOP/s and MFU of phase 4's
   float32 build, phase 13a's bf16 build and phase 11's step against the
   card's peaks (``card_peaks``: the same table gives every bound here);
   one fused audio -> sheet query inside ``utils.profiling.trace``, its
   trace holding kernels and its spans one ``query`` root over the stages,
   on the trace's clock: every launch from the root's start to its end,
   none before. b. this script started twice more
   (``--mesh-rank``) as two gloo ranks sharing card 0, at full width:
   one step on each half of phase 11's batch against one rank's step on
   the whole and a float64 step; under deterministic cuDNN, a 3-epoch
   ``fit`` over a ``ShardedDevicePool`` of phase 11's corpus held to phase
   11's learning criteria, the ranks equal epoch for epoch, and a fit
   stopped after epoch 2 and resumed on both ranks, bit for bit as the
   uninterrupted one; the step ms and peak memory a rank (two
   processes on one card, not a scaling figure). c. once more as a
   one-rank NCCL group: one fit epoch (20 steps) over replicated device
   pools, bit for bit as without a group.

17. the sharded gallery: this script started four more times as four
   gloo ranks sharing card 0, laid out as ``make_hybrid_mesh((1, 2), (2,
   1), ("data", "db"))`` (data 2 x db 2), at full width (phase 4's
   corpus and checkpoint, float32, TF32 off); the parent writes the
   corpus, the model, phase 10's latent pairs and phase 8's 10^6-row
   gallery into the work directory and computes the single card's answers.
   a. each rank's axis indices and sub-groups. b.
   ``build_sharded_sheet_gallery`` of the 60 strips over db (30 pieces a
   shard): the valid rows within 1e-5 of the single card's stride-grid
   build of the same strips (phase 4's own gallery sits on the noteheads,
   an arm the JAX sharded build lacks), the same ids, padding rows zero.
   c. ``make_sharded_piece_query`` of phase 4's 100-excerpt queries over
   phase 4's gallery (its 12,000 rows as host rows, 6,000 a shard) and
   over the sharded build: the single card's counts bit for bit on every
   rank (both db ranks, both data replicas); rank<=1 >= 59/60 over phase
   4's gallery (the stride grid's is reported: the checkpoint ranks
   notehead-centred windows). d. ``build_sharded_audio_gallery``
   (u16) and the raw ``make_sharded_sheet_query`` of the 60 strips: rows
   within 1e-5 of phase 7's audio gallery, its counts bit for bit. e.
   d2. the wires in the ranks: ``build_sharded_sheet_gallery_coded`` and
   ``build_sharded_audio_gallery(coded=True, quantize=8)`` within 1e-5 of
   the raw builds (whether bit-identical is reported), the sheet query
   over the rle2 wire (its default) with the raw counts bit for bit, the
   rANS decode kernel launched on every rank. e.
   ``sharded_gallery_search`` of phase 8's gallery at Q = 100, k = 25:
   the indices of kernel 1 over the whole gallery on one card, scores
   within TOPK_ATOL, whether bit-identical. f. ``sharded_cca_fit`` over
   data of phase 10's 10,000 pairs within 1e-3 of its float64 fit. g.
   ``python -m audio_sheet_retrieval_tpu_torch.parallel.dryrun --ranks 4``
   on card 0: exit 0, six sections. h. each rank's build seconds, query
   p50 and peak memory (four processes on one card, not a scaling
   figure); kernel 1 at a db shard's shape (Q = 100, N = 6,000) beside
   its plain version, ``torch.topk(q @ g.T, k)`` and its bound. Phases 16
   and 17 start their ranks through one launcher (``spawn_ranks`` with a
   scenario name, ``parallel.dryrun.spawn_ranks`` underneath: a log file
   a rank, one deadline).

18. the wire codecs. a. both rANS kernels (``csrc/rans.cu``) against
   their plain versions on the card, bit for bit, and against the native
   host decoder / the numpy encoder: the decode at phase 4's sheet corpus
   (60 strips padded white to 8,192 px, the three rle2 components; unequal
   word counts), its spectrogram corpus (60 x 92 x 1,720 u8 codes,
   S = 256) and the tutorial page's plane segments (S = 2,048), n < S,
   constant rows (no words) and a one-symbol table of frequency 4,096; the
   encode at the tutorial page's system map plane (its static table and
   budget), K S < w_budget, an overflowing budget and the 4,096 table;
   the cases the staged design can get wrong: words many times the
   decode's shared-memory ring (10^6 uniform bytes, S = 4,096, 16 lanes a
   thread), steps in which every lane consumes, S = 200, 60 payloads at
   S = 128 and 2 lanes a thread, n not a multiple of S, an encode whose
   emission masks span several tiles of its scan, one whose words fill
   the budget exactly, one in which every lane emits; event times and
   back-to-back (queued) times beside the plain versions' and the bound
   (the bytes at 3.35 TB/s or the steps times one barrier round of the
   narrowest CTA that holds S lanes at 16 a thread, the larger), the
   microseconds a step beside that barrier round, the
   encode's steps and scan apart from the placement of its words,
   the host encode times (numpy and native). b. the sheet wire: each
   strip through the rle2 embedder against the raw one on the padded
   strip, exact and fullconv, bit for bit; the corpus decode's strips; the
   sheet query's counts over the rle2 wire equal to raw on phase 7's
   gallery; the server's build wall over the rle2 wire against the raw
   upload; bytes a strip. c. the spectrogram wire: the corpus decode
   equal to ``spec_quantize(..., 8)`` for every piece, the delta flags,
   bytes a spectrogram. d. OMR: page_wire x map_wire in {raw, rans}^2 on
   the tutorial page, the three nets with their own map tables, map_bits
   8 and 16: the maps bit-identical; a tiny budget takes the overflow
   path and equals raw; each wire pair's page time; bytes a page.
19. the experiment layer. a. ``scripts/torch_accuracy_sweep.py``'s
   ``sweep`` over 30 confusable pieces (seed 31, 120 onsets), onset
   galleries, all four arms of its ladder: ``high``'s per-query ranks
   equal to highest's in every cell, the f32-highest e100 cell's ranks
   equal to a replay through the plain top-k, the bf16-fcp builds' gather
   launches each bit-identical to the plain version, 30, 60 or 90 queries
   a cell; seconds, rank<=1 a cell, bf16-fcp against bf16 at e100 (b, c,
   McNemar p). b. ``scripts/torch_full_protocol.py`` at full width in its
   default bf16 over 6 / 2 / 2 pieces of 60 onsets, 2 epochs, one regime:
   the table's two rows of that regime filled, the refined dump read back
   with a finite CCA state; seconds.
20. the scale runs and the tutorials. a. ``scripts/torch_capstone.py``'s
   ``main`` at full width in bf16, cut to 17 train pieces of 3
   performances (100 steps an epoch), 4 eval pieces, 3 epochs and 200
   test samples, with ``--serving_ab``, under deterministic cuDNN: JAX's
   JSON keys, every metric finite, phase 11's learning criteria, the saved
   checkpoint read back embedding as the refined params the script served
   (1e-5), rank<=1 of both serving dtypes over 60 pieces reported. b. both
   ``tutorials/torch_*.ipynb`` notebooks' cells on the card (the CPU
   tests' thresholds; their first 10 sheet and spectrogram codes within
   1e-4 of the port's CPU codes for the same inputs; where no libmpg123
   decodes the tutorial mp3, its committed decode
   ``tests/golden/tutorial_audio_22050.npz``, and where no matplotlib is
   installed, a stand-in ``pyplot`` that saves the figure as a gray PNG).
   c. a 5-epoch ``mutopia_ccal_cont`` fit over phase 11's pieces on
   device pools, deterministic cuDNN: phase 11's thresholds on the MRR of
   the params ``fit`` returns (its best epoch; the last is reported),
   updates/s.

The launch counters are zeroed before phase 4 and read after phase 6, and
zeroed before and read after each of phases 7-10 and each entry point of
phases 11-16 (``fit``, ``run_eval``, the CLI, the resume runs, each build
and query set of phases 13 and 13e, each ``audio2sheet_align`` run of
phase 14,
each command line of phase 15, the traced query and each rank process of
phases 16-17, whose counts its ranks report) and zeroed before phase
18b and read after 18d, and around each of 19a, 19b and 20a-c; each of
phases 4-13e, 15, 16, 19 and 20 must launch the
top-k kernel, phase 17 on every rank, and phase 14 both DTW kernels once
for each piece it aligns by ``pydtw``; phases 15 and 18b-d both rANS
kernels, phase 17 the decode on every rank, 13e and 19a the gather
kernel; the
single-card references of phase 17, the checks of 18a and 19a's plain
replay are not counted. The ``kernels`` line reports the sum over phases
4-20 (kernel 2's bf16 launches of phases 13 and 19a and its float32
launches of 13e among them), beside each kernel's times at the main
path's shape
(top-k: Q = 100, N = 12,000, k = 25, and at a db shard's N = 6,000
under ``db_shard``; gather: one 6040-px strip, float32,
its bf16 times on a line of their own; DTW: one corpus piece, 860 x 604
after the transpose, the accumulation's launches as ``launches`` and the
traceback's as ``traceback_launches``; the rANS decode: the tutorial
page's 4 segments of 246,534 B at S = 2,048, its other shapes under
``shapes``; the encode: the page's system map plane). The last line is
``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

TOPK_ATOL = 1e-4   # kernel vs cuBLAS + sort: f32 sums in another order


def _plain(o):
    """numpy scalars and arrays in an emitted line -> Python values."""
    return np.asarray(o).tolist()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=_plain), flush=True)


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    return torch


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_us(fn, name: str = "", iters: int = 20) -> float:
    """Mean device microseconds a call of ``fn()`` spends in the kernels
    whose name holds ``name`` (torch.profiler; no host launch gap in it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and name in ev.name) / iters


def queued_ms(fn, n: int = 20) -> float:
    """Milliseconds a call of ``fn()`` over ``n`` calls queued back to back
    between two events: for a launch longer than the host's enqueue, the
    device's time (the card never waits for the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def card_peaks() -> dict:
    """The data-sheet peaks of card 0, looked up by its name in the port's
    ``utils/roofline.py`` (an H100 SXM: float32 FMAs outside the tensor
    cores 67 TFLOP/s, where the port's float32 runs with TF32 off; bf16
    989 TFLOP/s; device memory 3.35 TB/s). A card the table lacks fails
    the run."""
    import torch

    from audio_sheet_retrieval_tpu_torch.utils import roofline

    name = torch.cuda.get_device_name(0)
    peaks = roofline.chip_peaks(name)
    if peaks is None or "f32_flops" not in peaks:
        raise SystemExit(f"chip_smoke: utils/roofline.py has no peaks for "
                         f"{name!r}")
    return peaks


def bound(nbytes: float, flops: float):
    """-> (least milliseconds the card could take, "bytes" or
    "operations"): each input read once, each output written once, at the
    memory rate, against the operations at the float32 rate (both the
    card's, ``card_peaks``)."""
    peaks = card_peaks()
    t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
    t_ops = flops / peaks["f32_flops"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def topk_bound(q: int, n: int, d: int, k: int):
    """Kernel 1: queries and gallery read, [Q, k] f32 + int64 written;
    2 Q N d flops of scoring."""
    return bound(4 * (q + n) * d + 12 * q * k, 2 * q * n * d)


def gather_bound(c: int, h4: int, wq: int, n_cols: int, starts,
                 elem: int = 4):
    """Kernel 2: the part of the plane these windows reach and the starts
    read, the windows written. A window reaches columns [s, s + 2 (n_cols
    - 1)]; the union over the host array ``starts`` is counted row by row
    in the 32-byte sectors device memory moves (a plane of 32-byte-aligned
    base), so one window of a long strip does not count the whole plane."""
    s = np.asarray(starts, np.int64).reshape(-1)
    edges = np.zeros(wq + 1, np.int64)
    np.add.at(edges, np.clip(s, 0, wq), 1)
    np.add.at(edges, np.clip(s + 2 * (n_cols - 1) + 1, 0, wq), -1)
    cols = np.nonzero(np.cumsum(edges)[:wq] > 0)[0]
    sectors = (np.arange(c * h4)[:, None] * wq + cols[None, :]) * elem // 32
    read = 32 * np.unique(sectors).size
    return bound(read + 4 * s.size + elem * s.size * c * h4 * n_cols, 0)


# --- phase 1-2 -----------------------------------------------------------------


def phase_device(torch):
    from audio_sheet_retrieval_tpu_torch.models import encoder

    encoder.pin_full_f32()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), capability=list(
             torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi)
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from audio_sheet_retrieval_tpu_torch.ops import _native

    # one nvcc per source, all started together
    with ThreadPoolExecutor() as pool:
        list(pool.map(_native.build, _native.SIGNATURES))
    for name in _native.SIGNATURES:
        t0 = time.perf_counter()
        _native.load(name)
        ptxas = [ln.strip() for ln in _native.BUILD_LOG[name]["ptxas"]
                 .splitlines() if "Used" in ln or "spill" in ln]
        emit("build", kernel=name, load_seconds=time.perf_counter() - t0,
             nvcc_seconds=_native.BUILD_LOG[name]["seconds"],
             cached=_native.BUILD_LOG[name]["cached"], ptxas=ptxas)


# --- phase 3: kernels against their plain versions ----------------------------


def check_topk(torch, q, g, k, launch=None):
    """Kernel vs plain top-k on the card -> max abs score error.

    Scores must agree to TOPK_ATOL and the index sets must be equal; an
    index may differ only between rows whose scores tie within TOPK_ATOL
    at the k-th place (f32 sums in another order). Among equal kernel
    scores the lower gallery index must come first. ``launch(q, g, k)``
    replaces ``topk_gallery`` (a pass 1 chosen by its plan)."""
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery,
        topk_gallery_plain,
    )

    s, i = (launch or topk_gallery)(q, g, k)
    ps, pi = topk_gallery_plain(q, g, k)
    torch.cuda.synchronize()
    assert s.shape == (q.shape[0], k) and i.dtype == torch.int64
    finite = torch.isfinite(ps)
    assert torch.equal(finite, torch.isfinite(s)), "-inf slots differ"
    err = float((s - ps)[finite].abs().max()) if finite.any() else 0.0
    assert err <= TOPK_ATOL, f"top-k scores differ by {err}"
    assert bool((s[:, 1:] <= s[:, :-1]).all()), "not descending"
    tie = s[:, 1:] == s[:, :-1]
    assert bool((i[:, 1:] > i[:, :-1])[tie].all()), "tie rule broken"
    kth = ps[:, -1:]
    ref = torch.where(torch.isnan(q @ g.T), float("-inf"), q @ g.T)
    for r in range(q.shape[0]):
        got, want = set(i[r].tolist()), set(pi[r].tolist())
        for j in got ^ want:  # only rows tied with the k-th score may swap
            assert abs(float(ref[r, j] - kth[r, 0])) <= TOPK_ATOL, \
                f"row {r}: index {j} differs"
    return err


def phase_stream_checks(torch, randn, unit) -> float:
    """Kernel 1's streaming pass 1 (``topk_chunk_stream_kernel``) on the
    card -> max abs score error: against the plain version at a catalogue's
    4,194,304 rows and one row more (off the tile), Q in {1, 8, 100, 128}
    (1 and 8 through its plan by the private launcher: the plan keeps the
    chunked pass 1 there), k in {1, 25, 32}, at d = 8 and 20; the tie rule
    on duplicate rows and NaN queries; and at Q = 100, N = 4,194,304, k = 25
    scores and indices bit-identical to the chunked pass 1."""
    from audio_sheet_retrieval_tpu_torch.ops import topk_gallery as tk

    def stream(q, g, k):
        p = tk.stream_plan(q.shape[0], g.shape[0], k, q.shape[1])
        return tk._launch(q, g, k, p)

    def chunked(q, g, k):
        p = tk.chunk_plan(q.shape[0], g.shape[0], k, q.shape[1])
        return tk._launch(q, g, k, p)

    err = 0.0
    before = tk.topk_gallery.stream_launches
    big = unit(randn(4_194_305, 32))
    for n in (4_194_304, 4_194_305):
        g = big[:n]
        for qn in (1, 8, 100, 128):
            engages = tk.plan(qn, n, 25, 32).stream
            for k in (1, 25, 32):
                e = check_topk(torch, unit(randn(qn, 32)), g, k,
                               None if engages else stream)
                err = max(err, e)
                emit("kernels", kernel="topk_gallery", case="stream", Q=qn,
                     N=n, d=32, k=k, by_plan=engages, max_abs_err=e)
    for d in (8, 20):
        e = check_topk(torch, unit(randn(100, d)), unit(randn(300_001, d)),
                       25)
        err = max(err, e)
        emit("kernels", kernel="topk_gallery", case="stream", Q=100,
             N=300_001, d=d, k=25, max_abs_err=e)
    # duplicate rows: the lower index wins every tie
    base = randn(500, 32)
    g = base.repeat(800, 1).contiguous()        # row r == row r % 500
    for qn in (1, 24, 70, 100):
        for k in (25, 32):
            q = randn(qn, 32)
            s, i = stream(q, g, k)
            ps, pi = tk.topk_gallery_plain(q, g, k)
            assert torch.equal(i, pi), \
                f"streaming pass 1, duplicate rows: Q={qn} k={k}"
            err = max(err, float((s - ps).abs().max()))
    # NaN queries count as -inf: their lists are rows 0 .. k - 1
    for qn in (9, 100):
        q = randn(qn, 32)
        q[[1, 4]] = float("nan")
        s, i = stream(q, big[:1_000_000], 25)
        torch.cuda.synchronize()
        assert bool(torch.isneginf(s[[1, 4]]).all())
        assert torch.equal(i[[1, 4]].cpu(), torch.arange(25).repeat(2, 1))
        assert bool(torch.isfinite(s[0]).all())
    # the cell's shape: bit for bit the chunked pass 1's answer
    q = unit(randn(100, 32))
    g = big[:4_194_304]
    assert tk.plan(100, 4_194_304, 25, 32).stream
    a, b = tk.topk_gallery(q, g, 25), chunked(q, g, 25)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), \
        "streaming and chunked pass 1 differ at the catalogue's shape"
    launched = tk.topk_gallery.stream_launches - before
    assert launched > 0, "no search took the streaming pass 1"
    emit("kernels", kernel="topk_gallery", case="stream vs chunked",
         Q=100, N=4_194_304, k=25, bit_identical=True,
         stream_launches=launched)
    return err


def phase_gather_checks(torch, randn, gen) -> float:
    """Kernel 2 against the plain version, bit for bit, float32 and
    bfloat16 -> the largest absolute difference (0.0)."""
    from audio_sheet_retrieval_tpu_torch.ops.windows import (
        gather_feature_windows,
        gather_feature_windows_plain,
    )

    dev = torch.device("cuda")
    worst = 0.0
    # (H4, Wq, C, n_cols, N): the port's first shapes; the serving shape
    # with 1, 8, 117 and 1,000 windows; a short strip; one column; 1 and 96
    # channels; a plane of one row; a strip of many segments
    shapes = [(8, 301, 24, 25, 32), (40, 998, 24, 25, 32),
              (16, 130, 8, 13, 32), (40, 3019, 24, 50, 480),
              (40, 3019, 24, 50, 1), (40, 3019, 24, 50, 8),
              (40, 3019, 24, 50, 117), (40, 3019, 24, 50, 1000),
              (40, 299, 24, 50, 9), (40, 3019, 24, 1, 64),
              (40, 3019, 1, 50, 117), (40, 3019, 96, 50, 30),
              (1, 99, 1, 3, 5), (5, 70_001, 2, 50, 40)]
    for h4, wq, c, n_cols, n in shapes:
        last = wq - 2 * (n_cols - 1) - 1   # the last legal start
        # both ends of the legal range, odd and even, then seeded starts of
        # both parities
        starts = torch.cat([
            torch.tensor([0, 1, last, last - 1], device=dev),
            torch.randint(0, last + 1, (n,), generator=gen, device=dev)]
        )[:n].to(torch.int32)
        for dt in (torch.float32, torch.bfloat16):
            plane = randn(c, h4, wq).to(dt)
            got = gather_feature_windows(plane, starts, n_cols)
            want = gather_feature_windows_plain(plane, starts, n_cols)
            torch.cuda.synchronize()
            worst = max(worst, float((got.float() - want.float())
                                     .abs().max()))
            assert torch.equal(got, want), f"gather differs {h4, wq, c, dt}"
        emit("kernels", kernel="gather_feature_windows", H4=h4, Wq=wq, C=c,
             n_cols=n_cols, N=n, bit_identical=True)
    # starts out of range: every column outside [0, Wq) reads as the
    # element type's all-ones pattern, the others as the plane's
    starts = torch.tensor([-1000, -99, -98, -97, -3, -1, 0, 2920, 2921, 2922,
                           3000, 3018, 3019, 3020, 2**31 - 1, -2**31],
                          device=dev, dtype=torch.int32)
    cols = starts.long()[:, None] + 2 * torch.arange(50, device=dev)
    inside = ((cols >= 0) & (cols < 3019))[:, None, None, :]
    for dt, bits in ((torch.float32, torch.int32),
                     (torch.bfloat16, torch.int16)):
        plane = randn(24, 40, 3019).to(dt)
        got = gather_feature_windows(plane, starts, 50).view(bits)
        want = plane[:, :, cols.clamp(0, 3018)].permute(2, 0, 1, 3).view(bits)
        want = torch.where(inside, want, torch.full_like(want, -1))
        assert torch.equal(got, want), f"out-of-range pattern differs {dt}"
        assert bool((got[0] == -1).all()) and bool((got[6] != -1).any())
    emit("kernels", kernel="gather_feature_windows", case="out of range",
         all_ones_pattern=True)
    before = gather_feature_windows.launches
    empty = gather_feature_windows(randn(24, 40, 3019),
                                   torch.zeros(0, dtype=torch.int32,
                                               device=dev), 50)
    assert empty.shape == (0, 24, 40, 50)
    assert gather_feature_windows.launches == before, "N = 0 launched"
    return worst


def phase_kernels(torch):
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery,
        topk_gallery_plain,
    )
    from audio_sheet_retrieval_tpu_torch.ops.windows import (
        gather_feature_windows,
        gather_feature_windows_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    topk_err = 0.0
    cases = [("tier1", 16, 2048, 32, 8), ("tier1", 8, 1536, 32, 25),
             ("tier1", 40, 4096, 32, 25), ("unaligned", 5, 777, 32, 10),
             ("serving", 100, 12000, 32, 25),
             ("serving", 100, 100_000, 32, 25),
             ("serving", 100, 1_000_000, 32, 25),
             # the streaming shapes: one frame (Q = 1) and a chunk (Q = 8)
             ("streaming", 1, 12_000, 32, 25),
             ("streaming", 8, 12_000, 32, 25),
             ("streaming", 1, 1_000_000, 32, 25),
             ("streaming", 8, 1_000_000, 32, 25),
             ("k128", 100, 100_000, 32, 128),
             ("k1024", 100, 100_000, 32, 1024),
             ("k1024", 3, 2000, 128, 1024),
             ("k2048", 100, 100_000, 32, 2048),
             ("k=N", 8, 3000, 128, 3000), ("k=N", 5, 777, 32, 777)]
    # the boundaries of the kernel's launch plan: Q around each query-block
    # width (1, 8, 32; 64, 65, 100 and 129 fill several 32-query blocks),
    # k around each selection's switch (k <= 32 in a warp's registers,
    # above by radix select: a warp a query, or the whole CTA for one-query
    # blocks) and sort size (a power of two), chunks shortened to keep an
    # 8-query block (k = 2,048 and 2,049 at d = 32), d in {8, 32, 128}, N
    # off the 128-row tile, and scores or sort areas too large for shared
    # memory (kept in global memory: both passes' at k = 20,000, d = 32;
    # pass 1's at k = 12,000, d = 128, whose merge reads the part lists from
    # global memory)
    cases += [("qblock", qn, 12_345, 32, 25)
              for qn in (1, 8, 9, 32, 33, 64, 65, 100, 129)]
    cases += [("klist", 16, 50_001, 32, k)
              for k in (1, 32, 33, 127, 128, 129, 2048, 2049, 4096, 4097)]
    cases += [("d", qn, 20_011, d, k) for d in (8, 128)
              for qn, k in ((33, 25), (9, 1000), (1, 2049))]
    cases += [("global lists", 2, 200_000, 32, 20_000),
              ("global lists", 3, 100_000, 128, 12_000),
              ("k=N", 1, 129, 32, 129), ("k=N", 65, 1000, 8, 1000)]
    for kind, qn, n, d, k in cases:
        unit_rows = kind not in ("tier1", "unaligned")
        g = unit(randn(n, d)) if unit_rows else randn(n, d)
        q = unit(randn(qn, d)) if unit_rows else randn(qn, d)
        err = check_topk(torch, q, g, k)
        topk_err = max(topk_err, err)
        emit("kernels", kernel="topk_gallery", case=kind, Q=qn, N=n, d=d,
             k=k, max_abs_err=err)
    # anti-correlated queries: every score negative
    g = randn(10, 8)
    topk_err = max(topk_err, check_topk(torch, -g[:3].contiguous(), g, 8))
    g = randn(50_000, 32)
    topk_err = max(topk_err, check_topk(torch, -g[:64].contiguous(), g, 25))
    # duplicate rows: exact ties; the lower index must win, on each side of
    # each switch and with the scores in global memory (d = 128,
    # k = 12,000)
    for d, k, reps in ((32, 25, 40), (32, 32, 40), (32, 33, 40),
                       (32, 1024, 40), (32, 2049, 40), (128, 12_000, 200)):
        base = randn(500, d)
        g = base.repeat(reps, 1).contiguous()        # row r == row r % 500
        for qn in (1, 24, 70):
            q = randn(qn, d)
            s, i = topk_gallery(q, g, k)
            ps, pi = topk_gallery_plain(q, g, k)
            assert torch.equal(i, pi), \
                f"duplicate rows: tie order differs, Q={qn} d={d} k={k}"
            topk_err = max(topk_err, float((s - ps).abs().max()))
    # NaN queries: NaN scores count as -inf, nothing raises; a NaN query's
    # list is rows 0..k-1
    for d, n, k in ((32, 3000, 25), (32, 3000, 33), (32, 3000, 1024),
                    (32, 3000, 2049), (32, 3000, 3000),
                    (128, 100_000, 12_000)):
        for qn in (9, 40):
            q = randn(qn, d)
            q[[1, 4]] = float("nan")
            s, i = topk_gallery(q, randn(n, d), k)
            torch.cuda.synchronize()
            assert bool(torch.isneginf(s[[1, 4]]).all())
            assert torch.equal(i[[1, 4]].cpu(), torch.arange(k).repeat(2, 1))
            assert bool(torch.isfinite(s[0]).all())
    emit("kernels", kernel="topk_gallery", case="anti/dup/nan", ok=True)
    topk_err = max(topk_err, phase_stream_checks(torch, randn, unit))

    # the evaluation's shapes: every test pair a query and a gallery row
    for d in (32, 16):
        g, q = unit(randn(2000, d)), unit(randn(2000, d))
        err = check_topk(torch, q, g, 25)
        topk_err = max(topk_err, err)
        emit("kernels", kernel="topk_gallery", case="evaluation", Q=2000,
             N=2000, d=d, k=25, max_abs_err=err)

    gather_err = phase_gather_checks(torch, randn, gen)

    # times at the main path's shapes: Q = 100 excerpts x the 60-piece
    # gallery (12,000 rows), d = 32, k = 25; the streaming shapes Q = 1 (one
    # frame) and Q = 8 (a chunk); one large k; one 6040-px strip's plane
    times = {}
    for qn, n, k in ((100, 12_000, 25), (100, 100_000, 25),
                     (100, 1_000_000, 25), (1, 12_000, 25), (8, 12_000, 25),
                     (1, 1_000_000, 25), (8, 1_000_000, 25),
                     (2000, 2000, 25),
                     (100, 100_000, 1024), (100, 100_000, 2048),
                     (100, 4_194_304, 25)):
        g, q = unit(randn(n, 32)), unit(randn(qn, 32))
        iters = 5 if k > 128 else 20
        b_ms, b_by = topk_bound(qn, n, 32, k)
        row = dict(
            ms=cuda_ms(lambda: topk_gallery(q, g, k), iters=iters),
            plain_ms=cuda_ms(lambda: topk_gallery_plain(q, g, k),
                             iters=iters),
            bound_ms=b_ms, bound_by=b_by,
            # the library's answer to the same question (its tie order is
            # not the kernel's); timed only, never called by the port
            library_ms=cuda_ms(lambda: torch.topk(q @ g.T, k, dim=1),
                               iters=iters))
        times[("topk", qn, n, k)] = row
        emit("timing", kernel="topk_gallery", Q=qn, N=n, d=32, k=k, **row)
    plane = randn(24, 40, 3019)
    starts = torch.arange(0, 2920, 25, device=dev, dtype=torch.int32)
    b_ms, b_by = gather_bound(24, 40, 3019, 50, starts.cpu().numpy())
    # the library's one call for the same function in the same layout: a
    # gather along the columns of the plane expanded over the windows
    # (views, nothing copied); timed only, never called by the port
    idx = (starts.long()[:, None] + 2 * torch.arange(50, device=dev))[
        :, None, None, :].expand(len(starts), 24, 40, 50)
    wide = plane[None].expand(len(starts), -1, -1, -1)
    assert torch.equal(torch.gather(wide, 3, idx),
                       gather_feature_windows(plane, starts, 50))
    # an event time of so short a launch is the wrapper's host time, so
    # the kernel and the library call are also read from the profiler
    kw = dict(iters=50, warmup=10)
    times["gather"] = dict(
        ms=cuda_ms(lambda: gather_feature_windows(plane, starts, 50), **kw),
        plain_ms=cuda_ms(lambda: gather_feature_windows_plain(
            plane, starts, 50), **kw),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.gather(wide, 3, idx), **kw),
        device_us=device_us(lambda: gather_feature_windows(
            plane, starts, 50), "gather_staged"),
        library_device_us=device_us(lambda: torch.gather(wide, 3, idx)))
    times["gather"]["share_of_bound"] = \
        b_ms * 1e3 / times["gather"]["device_us"]
    assert times["gather"]["device_us"] > 0, "the profiler saw no launch"
    emit("timing", kernel="gather_feature_windows", C=24, H4=40, Wq=3019,
         n_cols=50, N=len(starts), **times["gather"])
    # the bf16 plane the fullconv build gathers under compute_dtype=
    # "bfloat16" (phase 13): half the bytes, the same windows
    plane16 = plane.to(torch.bfloat16)
    b16_ms, b16_by = gather_bound(24, 40, 3019, 50, starts.cpu().numpy(),
                                  elem=2)
    wide16 = plane16[None].expand(len(starts), -1, -1, -1)
    assert torch.equal(torch.gather(wide16, 3, idx),
                       gather_feature_windows(plane16, starts, 50))
    g16 = dict(
        ms=cuda_ms(lambda: gather_feature_windows(plane16, starts, 50), **kw),
        plain_ms=cuda_ms(lambda: gather_feature_windows_plain(
            plane16, starts, 50), **kw),
        bound_ms=b16_ms, bound_by=b16_by,
        library_ms=cuda_ms(lambda: torch.gather(wide16, 3, idx), **kw),
        device_us=device_us(lambda: gather_feature_windows(
            plane16, starts, 50), "gather_staged"),
        library_device_us=device_us(lambda: torch.gather(wide16, 3, idx)))
    g16["share_of_bound"] = b16_ms * 1e3 / g16["device_us"]
    emit("timing", kernel="gather_feature_windows", dtype="bfloat16", C=24,
         H4=40, Wq=3019, n_cols=50, N=len(starts), **g16)
    # the kernels line reports each kernel at the main path's shape: Q = 100
    # excerpts x the 60-piece gallery (12,000 rows), k = 25; one strip
    return {"topk_gallery": dict(max_abs_err=topk_err,
                                 **times[("topk", 100, 12_000, 25)]),
            "gather_feature_windows": dict(max_abs_err=gather_err,
                                           **times["gather"])}


# --- phase 4-6: the serving path -------------------------------------------------


def plain_replay_ranks(torch, params, cfg, gallery, specs, n_pieces):
    """piece_id_accuracy's queries with the plain top-k in place of the
    kernel -> per-query ranks."""
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery_plain,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
        embed_spec_excerpts,
    )

    ranks = []
    for p, (payload, scale, starts) in enumerate(accuracy.query_payloads(
            cfg, specs, 1, 100, 16)):
        payload = torch.from_numpy(payload).to(gallery.device)
        for st in starts:
            codes = embed_spec_excerpts(params, cfg, payload, scale, st, True)
            _, idx = topk_gallery_plain(codes, gallery.gallery_n, 25)
            counts = torch.bincount(gallery.ids_device[idx].reshape(-1),
                                    minlength=n_pieces)[:n_pieces]
            ranks.append(accuracy.rank_and_margin(counts.cpu().numpy(),
                                                  p)[0])
    return ranks


def plain_fullconv_codes(torch, params, cfg, images, coords):
    """The fullconv gallery with the plain gather in place of kernel 2."""
    from audio_sheet_retrieval_tpu_torch.models.cca_model import length_norm
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy

    out = []
    with torch.no_grad():
        for im, st in zip(images, accuracy.gallery_starts(cfg, images,
                                                          coords)):
            plane = win.fullconv_plane(
                params, torch.from_numpy(im).to(params.device), 160)
            wins = win.gather_feature_windows_plain(
                plane, torch.from_numpy(st // 2).to(plane.device), 50)
            h1 = params.view1.forward_from(wins, 2)
            out.append(length_norm((h1 - params.cca.mean1) @ params.cca.U))
    return out


def zero_launches():
    from audio_sheet_retrieval_tpu_torch.ops import dtw, rans
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery

    topk_gallery.launches = 0
    topk_gallery.stream_launches = 0
    win.gather_feature_windows.launches = 0
    dtw.dtw_accumulate.launches = 0
    dtw.dtw_traceback.launches = 0
    rans.rans_decode_kernel.launches = 0
    rans.rans_encode_kernel.launches = 0


def read_launches() -> dict:
    from audio_sheet_retrieval_tpu_torch.ops import dtw, rans
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery

    return {"topk_gallery": topk_gallery.launches,
            "topk_gallery_stream": topk_gallery.stream_launches,
            "gather_feature_windows": win.gather_feature_windows.launches,
            "dtw_accumulate": dtw.dtw_accumulate.launches,
            "dtw_traceback": dtw.dtw_traceback.launches,
            "rans_decode": rans.rans_decode_kernel.launches,
            "rans_encode": rans.rans_encode_kernel.launches}


def report_params(ctx) -> str:
    """The serving checkpoint copied under the results' naming convention
    (``params_<split>_<aug>.pkl``) into phase 16's reports directory, so
    the CLIs' result dumps land there under names ``reports`` reads."""
    path = os.path.join(ctx["reports_dir"], "params_%s.pkl" % REPORT_TAG)
    if not os.path.exists(path):
        shutil.copy(ctx["ckpt"], path)
    return path


def phase_serving(torch, reports_dir):
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config
    from audio_sheet_retrieval_tpu_torch.cli import audio_sheet_server as cli
    from audio_sheet_retrieval_tpu_torch.cli import sheet_audio_server as \
        s2a_cli
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        load_any_checkpoint,
    )

    dev = torch.device("cuda")
    ckpt = assets.asset_path("synth_serving_ckpt.pkl")
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    params = load_any_checkpoint(ckpt, cfg, device=dev)
    images, specs, o2cs = synthetic.make_piece_list(
        26, 60, n_performances=1, n_onsets=200)
    specs = [sp[0] for sp in specs]
    coords = [oc[0][:, 1] for oc in o2cs]
    # warm-up (cuDNN plans, both arms) before the timed, counted run
    for fullconv in (False, True):
        accuracy.build_piece_gallery(params, cfg, images[:1],
                                     coords=coords[:1], fullconv=fullconv,
                                     device=dev)
    torch.cuda.synchronize()

    zero_launches()
    run, build_s_of = {}, {}
    for arm, fullconv in (("exact", False), ("fullconv", True)):
        t0 = time.perf_counter()
        gal = accuracy.build_piece_gallery(params, cfg, images, coords=coords,
                                           fullconv=fullconv, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        acc = accuracy.piece_id_accuracy(
            params, cfg, images, specs, coords=coords, n_candidates=25,
            queries_per_piece=1, excerpts_per_query=100, quantize=16,
            gallery=gal, device=dev)
        run[arm] = (gal, acc)
        build_s_of[arm] = build_s
        emit("main_path" if arm == "exact" else "fullconv", arm=arm,
             gallery_rows=gal.n, build_s=build_s,
             sheet_emb_per_s=gal.n / build_s, rank1=acc["rank1"],
             rank5=acc["rank5"], n=acc["n"], margin_p10=acc["margin_p10"],
             margin_p50=acc["margin_p50"], query_p50_ms=acc["p50_ms"])
    # the CLIs' rank dumps go to phase 16's reports directory
    report_ckpt = report_params(dict(reports_dir=reports_dir, ckpt=ckpt))
    with tempfile.TemporaryDirectory() as tmp:
        cli_ranks = {}
        for fused in (False, True):
            argv = ["--data", "synthetic", "--n_test_pieces", "8",
                    "--param_file", report_ckpt, "--db_file",
                    os.path.join(tmp, "sheet_db.pkl"), "--init_sheet_db",
                    "--full_eval", "--dump_results"] + (
                        ["--fused"] if fused else [])
            cli_ranks[fused] = [int(r) for r in cli.main(argv)]
        s2a_ranks = {}
        for fused in (False, True):
            argv = ["--data", "synthetic", "--n_test_pieces", "8",
                    "--param_file", report_ckpt, "--db_file",
                    os.path.join(tmp, "audio_db.pkl"), "--init_audio_db",
                    "--full_eval", "--dump_results"] + (
                        ["--fused"] if fused else [])
            s2a_ranks[fused] = [int(r) for r in s2a_cli.main(argv)]
    launches = read_launches()

    exact_gal, exact = run["exact"]
    fc_gal, fc = run["fullconv"]
    assert launches["topk_gallery"] > 0, "the serving path ran no top-k kernel"
    assert launches["gather_feature_windows"] > 0, \
        "the fullconv build ran no gather kernel"
    assert exact["n"] == 60 and exact["rank1"] >= 59, exact["rank1"]
    plain = plain_replay_ranks(torch, params, cfg, exact_gal, specs, 60)
    assert plain == exact["ranks"], "plain top-k replay ranks differ"
    emit("main_path", check="plain top-k replay", ranks_equal=True)

    # fullconv through the plain gather: the same embeddings
    assert fc_gal.n == exact_gal.n
    plain_fc = torch.cat(plain_fullconv_codes(torch, params, cfg, images,
                                              coords))
    fc_err = float((fc_gal.gallery_n - plain_fc).abs().max())
    assert fc_err <= 1e-6, fc_err
    strip = torch.from_numpy(images[0]).to(dev)
    plane = win.fullconv_plane(params, strip, 160)
    st = accuracy.gallery_starts(cfg, images[:1], coords[:1])[0]
    starts_half = torch.from_numpy(st // 2).to(dev)
    assert torch.equal(win.gather_feature_windows(plane, starts_half, 50),
                       win.gather_feature_windows_plain(plane, starts_half,
                                                        50))
    assert fc["n"] == 60 and fc["rank1"] >= 59, fc["rank1"]
    # gather_half (windows cut from the strip's half plane): the standard
    # path's embeddings bit for bit at even window starts
    even = st - st % 2
    half_err = float((win.embed_strip_windows(params, strip, even, cfg, 160,
                                              gather_half=True)
                      - win.embed_strip_windows(params, strip, even, cfg,
                                                160)).abs().max())
    assert half_err == 0.0, f"gather_half differs by {half_err}"
    # cosine to the per-window build: reported, not bounded (the JAX
    # package's fullconv arm sits as far from it on this checkpoint)
    cos = (fc_gal.gallery_n * exact_gal.gallery_n).sum(1)
    emit("fullconv", max_abs_err_vs_plain_gather_route=fc_err,
         cosine_to_exact_min=float(cos.min()),
         cosine_to_exact_median=float(cos.median()), rank1=fc["rank1"],
         rank1_exact=exact["rank1"], gather_bit_identical=True,
         gather_half_bit_identical=True)

    assert cli_ranks[False] == cli_ranks[True], cli_ranks
    assert s2a_ranks[False] == s2a_ranks[True], s2a_ranks
    emit("cli", n_test_pieces=8, ranks=cli_ranks[True],
         ranks_equal_fused=True, s2a_ranks=s2a_ranks[True],
         s2a_ranks_equal_fused=True, launches=launches)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    ctx = dict(dev=dev, cfg=cfg, params=params, ckpt=ckpt,
               reports_dir=reports_dir, images=images,
               specs=specs, coords=coords, o2cs=o2cs, gallery=exact_gal,
               galleries={arm: g for arm, (g, _) in run.items()},
               serving={arm: dict(emb_per_s=g.n / build_s_of[arm],
                                  rank1=a["rank1"],
                                  ranks=a["ranks"], query_p50_ms=a["p50_ms"])
                        for arm, (g, a) in run.items()})
    return ctx, launches


# --- phases 7-9: sheet -> audio, streaming, raw audio ---------------------------

# rank<=1 of the JAX package itself on phase 7's corpus and checkpoint: its
# device audio-DB build (u16) and detect_performance (the host chain, whose
# votes equal its fused sheet query's: tests/test_server.py), 25 candidates,
# 100 windows a strip, ties counted against the true piece; run once on the
# CPU with jax 0.9.0 (PERF.md, Findings)
JAX_S2A_RANK1 = 19
STREAM_VOTES_ATOL = 1e-9   # the JAX test's bound: identical vote histograms
MULAW_VOTES_ATOL = 0.05    # tests/test_server.py's mu-law jitter bound


def pessimistic_rank(shares: dict, names, true_name) -> int:
    """Rank of ``true_name`` with every tie counted against it (pieces
    without a vote have share 0)."""
    mine = shares.get(true_name, 0.0)
    return sum(1 for n in names if shares.get(n, 0.0) >= mine)


def make_server(ctx):
    from audio_sheet_retrieval_tpu_torch.retrieval.server import (
        AudioSheetServer,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        RetrievalWrapper,
    )

    srv = AudioSheetServer(device=ctx["dev"])
    srv.initialize_embedding_network(RetrievalWrapper(
        ctx["cfg"], params=ctx["params"], device=ctx["dev"]))
    return srv


def with_sheet_gallery(srv, ctx, codes=None, ids=None):
    """Attach phase 4's exact gallery (or the given codes and labels)."""
    gal = ctx["gallery"]
    srv.sheet_snippet_codes = gal.gallery_n if codes is None else codes
    srv.sheet_snippet_ids = gal.ids if ids is None else ids
    srv.id_to_piece = {p: "piece_%03d" % p
                       for p in range(len(ctx["images"]))}
    srv._refresh_sheet_gallery()
    return srv


def phase_s2a(torch, ctx):
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery_plain,
    )
    from audio_sheet_retrieval_tpu_torch.ops.windows import (
        embed_strip_windows,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.server import (
        linspace_starts,
    )

    images, specs, cfg = ctx["images"], ctx["specs"], ctx["cfg"]
    names = ["piece_%03d" % p for p in range(len(images))]
    srv = make_server(ctx)
    srv.initialize_audio_db_from_specs_device(names[:2], specs[:2])  # warm
    srv.detect_performance_from_sheet(images[0], top_k=2, n_candidates=25)
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    srv.initialize_audio_db_from_specs_device(names, specs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ranks, lat = [], []
    for p, name in enumerate(names):
        t0 = time.perf_counter()
        result, votes = srv.detect_performance_from_sheet(
            images[p], top_k=len(names), n_candidates=25)
        lat.append(time.perf_counter() - t0)
        ranks.append(pessimistic_rank(dict(zip(result, votes)), names, name))
    launches = read_launches()
    assert launches["topk_gallery"] > 0, "sheet -> audio ran no top-k kernel"

    gal = srv._audio_gallery
    plain = []
    for p, im in enumerate(images):
        strip = torch.from_numpy(im).to(ctx["dev"])
        codes = embed_strip_windows(
            ctx["params"], strip, linspace_starts(im.shape[1], 200, 100),
            cfg, 160)
        _, idx = topk_gallery_plain(codes, gal.gallery_n, 25)
        counts = torch.bincount(gal.ids_device[idx].reshape(-1),
                                minlength=len(names)).cpu().numpy()
        plain.append(int((counts >= counts[p]).sum()))
    assert plain == ranks, "plain top-k replay ranks differ"
    rank1 = sum(r <= 1 for r in ranks)
    rank5 = sum(r <= 5 for r in ranks)
    emit("s2a", audio_rows=gal.n, build_s=build_s,
         audio_emb_per_s=gal.n / build_s, rank1=rank1, rank5=rank5,
         n=len(ranks), jax_cpu_rank1=JAX_S2A_RANK1,
         query_p50_ms=float(np.percentile(lat, 50) * 1000),
         plain_replay_ranks_equal=True, launches=launches)
    assert rank1 >= JAX_S2A_RANK1 - 1, (rank1, JAX_S2A_RANK1)
    ctx["s2a"] = dict(rank1=rank1, rank5=rank5,
                      audio_emb_per_s=gal.n / build_s,
                      query_p50_ms=float(np.percentile(lat, 50) * 1000))
    ctx["s2a_codes"] = gal.gallery_n   # phase 13b's float32 control
    ctx["s2a_gallery"] = gal           # phase 17's single-card reference
    return launches


def phase_streaming(torch, ctx, pieces=(0, 17, 42), n_frames=400):
    srv = with_sheet_gallery(make_server(ctx), ctx)
    kw = dict(top_k=5, n_candidates=25)
    srv.run_device_stream(ctx["specs"][0][:, :48], **kw)  # warm-up
    srv.run(ctx["specs"][0][:, :48], on_update=lambda *a: None, **kw)
    torch.cuda.synchronize()

    zero_launches()
    rows = []
    for p in pieces:
        spec = ctx["specs"][p][:, :n_frames]
        out = {}
        for mode, chunk in (("chunk8", 8), ("per_frame", 1)):
            t0 = time.perf_counter()
            rank, votes, _ = srv.run_device_stream(spec, chunk=chunk, **kw)
            out[mode] = (rank, votes, n_frames / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        rank, votes = srv.run(spec, on_update=lambda *a: None, **kw)
        out["host_loop"] = (rank, votes, n_frames / (time.perf_counter()
                                                     - t0))
        diffs = {m: float(np.abs(np.asarray(out[m][1])
                                 - np.asarray(votes)).max())
                 for m in ("chunk8", "per_frame")}
        rows.append(dict(piece=p, top1={m: v[0][0] for m, v in out.items()},
                         fps={m: v[2] for m, v in out.items()},
                         max_vote_diff_vs_host_loop=diffs,
                         rankings_equal={m: out[m][0] == rank
                                         for m in ("chunk8", "per_frame")}))
        emit("streaming", **rows[-1])
    launches = read_launches()

    # frames/s at chunk 8 against a 1,000,000-row random unit gallery
    gen = torch.Generator(device=ctx["dev"]).manual_seed(1)
    big = torch.randn(1_000_000, 32, generator=gen, device=ctx["dev"])
    big = big / torch.linalg.vector_norm(big, dim=1, keepdim=True)
    ids = np.random.default_rng(1).integers(0, len(ctx["images"]),
                                            1_000_000)
    big_srv = with_sheet_gallery(make_server(ctx), ctx, big, ids)
    spec = ctx["specs"][pieces[0]][:, :n_frames]
    big_srv.run_device_stream(spec[:, :48], **kw)  # warm-up
    torch.cuda.synchronize()
    before = read_launches()["topk_gallery"]
    t0 = time.perf_counter()
    big_srv.run_device_stream(spec, chunk=8, **kw)
    fps_1m = n_frames / (time.perf_counter() - t0)
    launches["topk_gallery"] += read_launches()["topk_gallery"] - before
    emit("streaming", gallery_rows=1_000_000, chunk=8, frames=n_frames,
         fps=fps_1m, launches=launches)
    assert launches["topk_gallery"] > 0, "streaming ran no top-k kernel"
    for row in rows:
        assert row["rankings_equal"]["per_frame"], row
        assert row["max_vote_diff_vs_host_loop"]["per_frame"] \
            <= STREAM_VOTES_ATOL, row
        assert row["rankings_equal"]["chunk8"], row
        assert row["max_vote_diff_vs_host_loop"]["chunk8"] \
            <= STREAM_VOTES_ATOL, row
    return launches


def golden_chirp():
    """The 5 s chirp of tests/test_golden.py."""
    t = np.arange(22050 * 5) / 22050
    return (0.4 * np.sin(2 * np.pi * (220 + 80 * t) * t) * 32767
            ).astype(np.int16)


def phase_audio(torch, ctx):
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.ops.audio import AudioProcessor
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        load_any_checkpoint,
    )

    dev, cfg = ctx["dev"], ctx["cfg"]
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests", "golden", "reference_embeddings.npz"))
    chirp = golden_chirp()
    proc = AudioProcessor(device=dev)
    spec = proc.process(chirp)
    golden_err = float(np.abs(spec[:, :300] - golden["spec"]).max())
    host_err = float(np.abs(spec - proc.process_host(chirp)).max())
    tut = load_any_checkpoint(assets.tutorial_checkpoint_path(), cfg,
                              device=dev)
    exc = np.stack([spec[:, i * 6:i * 6 + 42] for i in range(8)])[:, None]
    codes = cca_model.embed_view2(tut, torch.from_numpy(exc).to(dev), cfg)
    codes_err = float(np.abs(codes.cpu().numpy()
                             - golden["spec_codes"]).max())

    srv = with_sheet_gallery(make_server(ctx), ctx)
    kw = dict(top_k=5, n_candidates=25)
    srv.detect_score_from_audio(chirp, **kw)  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    got = srv.detect_score_from_audio(chirp, **kw)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        srv.detect_score_from_audio(chirp, **kw)
        lat.append(time.perf_counter() - t0)
    launches = read_launches()
    want = srv.detect_score(proc.process(chirp), **kw)
    n = min(len(got[1]), len(want[1]))
    vote_err = float(np.abs(got[1][:n] - want[1][:n]).max())
    emit("audio", golden_spec_max_abs_err=golden_err,
         process_host_max_abs_err=host_err,
         golden_spec_codes_max_abs_err=codes_err,
         top1=got[0][0], top1_host_chain=want[0][0],
         votes=[float(v) for v in got[1]],
         votes_host_chain=[float(v) for v in want[1]],
         max_vote_diff=vote_err,
         mulaw_query_p50_ms=float(np.percentile(lat, 50) * 1000),
         launches=launches)
    assert golden_err <= 2e-5, golden_err
    assert host_err <= 2e-4, host_err
    assert codes_err <= 2e-4, codes_err
    assert launches["topk_gallery"] > 0, "the audio query ran no top-k kernel"
    assert got[0][0] == want[0][0], (got, want)
    assert vote_err <= MULAW_VOTES_ATOL, vote_err
    return launches


# --- phase 10: evaluate / refine ---------------------------------------------------

EVAL_HITS_SLACK = 1      # a near-tie may swap two neighbours between two
EVAL_MRR_ATOL = 1e-3     # float32 products taken in another order
REFIT_COEFFS_ATOL = 1e-3  # float32 moments of 10,000 rows against float64
EVAL_N_TEST = 2000        # run_eval's --n_test
REFIT_N_TRAIN = 10_000    # train pairs of the refit
REFIT_PIECES = dict(n_train=60, n_valid=1, n_test=12, n_onsets=200)


def numpy_cca_coeffs(H1: np.ndarray, H2: np.ndarray, r: float = 1e-3):
    """Canonical correlations of two [n, d] views in float64 (the 'svd'
    family of the offline fit, ridge ``r`` on both covariances)."""
    H1, H2 = np.asarray(H1, np.float64), np.asarray(H2, np.float64)
    n, d = H1.shape
    H1c, H2c = H1 - H1.mean(0), H2 - H2.mean(0)
    S11 = H1c.T @ H1c / (n - 1) + r * np.eye(d)
    S22 = H2c.T @ H2c / (n - 1) + r * np.eye(d)
    S12 = H1c.T @ H2c / (n - 1)

    def inv_sqrt(S):
        w, A = np.linalg.eigh(S)
        return (A / np.sqrt(w)) @ A.T

    return np.linalg.svd(inv_sqrt(S11) @ S12 @ inv_sqrt(S22),
                         compute_uv=False)


def check_eval_ranks(torch, dev, lv1: np.ndarray, lv2: np.ndarray,
                     results: dict):
    """The evaluation's ranks on the card: the top-k kernel's equal the full
    argsort's wherever found (but where the match ties another row within
    float32 rounding), and ``results`` (what ``run_eval.main`` returned)
    equals a replay on the host copy of the codes."""
    from audio_sheet_retrieval_tpu_torch.ops import metrics

    n = lv1.shape[0]
    before = read_launches()["topk_gallery"]
    ranks, found = metrics.retrieval_ranks_topk(lv1, lv2, 25, device=dev)
    assert read_launches()["topk_gallery"] == before + 1
    full, _ = metrics.retrieval_ranks(lv1, lv2, device=dev)
    differ = np.nonzero(found & (ranks != full))[0]
    if len(differ):
        scores = (torch.from_numpy(lv1[differ]) @ torch.from_numpy(lv2).T
                  ).numpy()
        for row, i in zip(scores, differ):
            gaps = np.abs(np.delete(row, i) - row[i])
            assert gaps.min() <= 2e-6, f"query {i}: ranks differ without a tie"
    assert (full[~found] > 25).all()
    # plain replay: the same evaluation on the CPU copy of the codes
    _, med, _, hits, mrr = metrics.eval_retrieval(lv1, lv2, device="cpu")
    for k, v in hits.items():
        got = results["recall_at_k"]["%d" % k] * n / 100.0
        assert abs(got - v) <= EVAL_HITS_SLACK, (k, got, v)
    assert abs(results["map"] - mrr) <= EVAL_MRR_ATOL, (results["map"], mrr)
    assert abs(results["med_rank"] - med) <= 1.0, (results["med_rank"], med)
    return dict(found=int(found.sum()), ranks_differ_on_ties=len(differ),
                hits_replay={int(k): v for k, v in hits.items()},
                mrr_replay=mrr)


def phase_eval_refine(torch, ctx):
    from audio_sheet_retrieval_tpu_torch.cli import refine_cca, run_eval
    from audio_sheet_retrieval_tpu_torch.data import msmd, synthetic
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import
    from audio_sheet_retrieval_tpu_torch.ops import cca as cca_ops
    from audio_sheet_retrieval_tpu_torch.ops import metrics
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        RetrievalWrapper,
        load_checkpoint_tree,
    )
    from audio_sheet_retrieval_tpu_torch.utils import io as uio

    dev, cfg, ckpt = ctx["dev"], ctx["cfg"], ctx["ckpt"]
    assert run_eval.build_arg_parser().get_default("device") == "cuda"
    assert refine_cca.build_arg_parser().get_default("device") == "cuda"
    wrapper = RetrievalWrapper(cfg, params=ctx["params"], device=dev)

    def cli_codes(w):
        """The codes ``run_eval.main`` evaluates: the CLI's synthetic test
        pool, sampled at ``EVAL_N_TEST`` linspace indices."""
        pool = msmd.select_data("synthetic", None, None, 23,
                                test_only=True)["test"]
        X1, X2 = pool[np.linspace(0, pool.shape[0] - 1,
                                  EVAL_N_TEST).astype(int)]
        return w.compute_view_1(X1), w.compute_view_2(X2), pool.shape[0]

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    rows = {}
    common = ["--data", "synthetic", "--n_test", str(EVAL_N_TEST)]
    for direction, flag in (("S2A", []), ("A2S", ["--V2_to_V1"])):
        t0 = time.perf_counter()
        # the dump goes to phase 16's reports directory
        rows[direction] = run_eval.main(common + flag + [
            "--param_file", report_params(ctx), "--dump_results"])
        rows[direction + "_seconds"] = time.perf_counter() - t0
    launches = read_launches()   # of the entry points alone, not the checks
    assert launches["topk_gallery"] >= 2, "run_eval ran no top-k kernel"
    lv1, lv2, n_pool = cli_codes(wrapper)
    checks = {"S2A": check_eval_ranks(torch, dev, lv1, lv2, rows["S2A"]),
              "A2S": check_eval_ranks(torch, dev, lv2, lv1, rows["A2S"])}
    emit("evaluate", n_test=EVAL_N_TEST, test_pool=n_pool, results=rows,
         checks=checks, launches=launches)

    # the refit at full size: 60 train pieces of 200 onsets
    t0 = time.perf_counter()
    data = synthetic.load_synthetic_retrieval(**REFIT_PIECES)
    pools_s = time.perf_counter() - t0
    n_train = REFIT_N_TRAIN
    assert data["train"].shape[0] >= n_train, data["train"].shape
    assert data["test"].shape[0] >= EVAL_N_TEST, data["test"].shape
    X1, X2 = data["train"][0:n_train]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat1, lat2 = refine_cca.pre_cca_latents(ctx["params"], cfg, X1, X2)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit = cca_ops.cca_fit(lat1, lat2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    new_params, res = refine_cca.refine(ctx["params"], cfg, data,
                                        n_train=n_train)
    assert res.U.device == ctx["params"].device
    assert float((res.coeffs - fit.coeffs).abs().max()) <= 1e-5
    want = numpy_cca_coeffs(lat1.cpu().numpy(), lat2.cpu().numpy())
    ctx["refit_pairs"] = (lat1.cpu().numpy(), lat2.cpu().numpy(), want)
    coeffs_err = float(np.abs(res.coeffs.cpu().numpy() - want).max())
    assert coeffs_err <= REFIT_COEFFS_ATOL, coeffs_err
    # the other two families and the summed moments of two shards, on the
    # card: the same correlations (the eigen families take them as square
    # roots of float32 eigenvalues, so one near zero moves by up to
    # sqrt(1e-6 / 1) = 1e-3 more)
    family_err = {}
    for method in ("eigen", "eigen-4"):
        alt = cca_ops.cca_fit(lat1, lat2, method=method)
        family_err[method] = float(np.abs(alt.coeffs.cpu().numpy()
                                          - want).max())
        assert family_err[method] <= 3 * REFIT_COEFFS_ATOL, family_err
    half = n_train // 2
    summed = cca_ops.CCAMoments(*(a + b for a, b in zip(
        cca_ops.cca_moments(lat1[:half], lat2[:half]),
        cca_ops.cca_moments(lat1[half:], lat2[half:]))))
    family_err["summed moments"] = float(
        (cca_ops.cca_fit_from_moments(summed).coeffs - res.coeffs)
        .abs().max())
    assert family_err["summed moments"] <= 1e-4, family_err

    te = data["test"]
    T1, T2 = te[np.linspace(0, te.shape[0] - 1, EVAL_N_TEST).astype(int)]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, cfg.name + "_est_UV", "params.pkl")
        uio.save_pytree(out, refine_cca.refined_tree(
            load_checkpoint_tree(ckpt, cfg), res),
            meta={"model": cfg.name, "refined": True, "n_train": n_train})
        reloaded = RetrievalWrapper(cfg, param_file=out, device=dev)
        refined = RetrievalWrapper(cfg, params=new_params, device=dev)
        codes = {name: (w.compute_view_1(T1), w.compute_view_2(T2))
                 for name, w in (("before", wrapper), ("after", refined),
                                 ("reloaded", reloaded))}
        reload_err = max(float(np.abs(a - b).max()) for a, b in zip(
            codes["after"], codes["reloaded"]))
        assert reload_err <= 1e-6, reload_err
        zero_launches()   # the checks above launched the kernel too
        est = run_eval.main(common + ["--estimate_UV", "--exp_root", tmp])
        for name, count in read_launches().items():
            launches[name] += count
        assert launches["topk_gallery"] >= 3
        e1, e2, _ = cli_codes(reloaded)
        est_check = check_eval_ranks(torch, dev, e1, e2, est)
    mrr = {name: metrics.eval_retrieval(c1, c2, device=dev)[4]
           for name, (c1, c2) in codes.items()}
    # unequal galleries on the card (two gallery rows a query, two queries
    # a gallery row) and the packed 8-vector: the CPU's answers
    c1, c2 = codes["after"]
    for a, b in ((c1[::2], c2), (c1, c2[::2])):
        on_card = metrics.eval_retrieval(a, b, device=dev)
        on_cpu = metrics.eval_retrieval(a, b, device="cpu")
        assert all(abs(on_card[3][k] - on_cpu[3][k]) <= EVAL_HITS_SLACK
                   for k in on_cpu[3]), (on_card, on_cpu)
        assert abs(on_card[4] - on_cpu[4]) <= EVAL_MRR_ATOL
    packed = metrics.unpack_retrieval_metrics(metrics.retrieval_metrics_device(
        torch.from_numpy(c1).to(dev), torch.from_numpy(c2).to(dev)))
    whole = metrics.eval_retrieval(c1, c2, device=dev)
    assert all(abs(packed[3][k] - whole[3][k]) <= EVAL_HITS_SLACK
               for k in whole[3]) and abs(packed[4] - whole[4]) <= \
        EVAL_MRR_ATOL, (packed, whole)
    emit("refine", n_train=n_train, train_pool=data["train"].shape[0],
         pools_seconds=pools_s, embed_seconds=embed_s, fit_seconds=fit_s,
         pairs_per_s=n_train / embed_s,
         coeffs_max_abs_err_vs_float64=coeffs_err,
         other_fits_coeffs_max_abs_err=family_err,
         canonical_correlation=float(res.coeffs.mean()),
         reload_max_abs_err=reload_err, mrr_distinct_test_pairs=mrr,
         estimate_UV_results=est, estimate_UV_check=est_check,
         max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches)
    assert not torch.backends.cuda.matmul.allow_tf32
    return launches


# --- phase 11: training ------------------------------------------------------

# one step, card against CPU: float32 sums over up to 800,000 terms a
# channel, cuDNN against oneDNN, in other orders, and 70 Newton-Schulz
# products that carry the rounding. Both are held to a float64 run of the
# same step on the card: the loss and corr; every gradient element within
# STEP_GRAD_TOL (card vs float64) and STEP_GRAD_CPU_TOL (card vs CPU) of
# the largest gradient element of the step (measured on an H100 at 700 W:
# the card 2.3e-3 from float64, the CPU 8.8e-3: the CPU is the farther);
# the BN statistics and covariances within STEP_STATE_RTOL; the polar U
# and V within STEP_UV_ATOL. eigh: loss and corr only (cuSOLVER and LAPACK
# sign the eigenvectors differently).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 5e-3
STEP_GRAD_CPU_TOL = 2e-2
STEP_STATE_RTOL = 1e-4
STEP_UV_ATOL = 1e-3
TRAIN_PIECES = dict(n_train=60, n_valid=5, n_test=1, n_onsets=200)
TRAIN_EPOCHS = 3
RESUME_PIECES = dict(n_train=3, n_valid=1, n_test=1, n_onsets=100)
FIT_MRR_ATOL = 1e-3   # the dump re-embedded by run_eval, in another order


def count_launches(torch, fn) -> int:
    """Kernels ``fn()`` launches on the card (torch.profiler; copies,
    memsets, runtime calls and user ranges mirrored on the device left
    out, as ``scripts/torch_profile_train.py`` counts them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.name.startswith(("Memcpy", "Memset", "cuda",
                                           "cuLaunch"))
               and "#" not in ev.name)


def one_step(torch, cfg, tree, x1, x2, device, dtype):
    """Loss, gradients and new running state of one train step from the
    numpy ``tree`` on ``device`` in ``dtype`` (float64: the params and the
    prepared inputs converted; the same arithmetic) -> host arrays."""
    import torch.nn.functional as F

    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import
    from audio_sheet_retrieval_tpu_torch.ops import losses
    from audio_sheet_retrieval_tpu_torch.train import engine

    p = lasagne_import.train_params_from_numpy(tree, cfg, device=device)
    t1 = torch.from_numpy(x1).to(device)
    t2 = torch.from_numpy(x2).to(device)
    if dtype == torch.float32:
        loss, new, corr = engine.train_loss(p, t1, t2, cfg)
    else:   # train_loss's arithmetic, with prepare_view1_device in float64
        p = p.to(dtype)
        lv1, lv2, new, corr = cca_model.forward_train(
            p, F.avg_pool2d(t1.to(dtype) / 255.0, 2), t2.to(dtype), cfg)
        loss = losses.contrastive_cos_loss(lv1, lv2, gamma=cfg.gamma) + \
            cfg.l2 * sum((q * q).sum() for q in p.parameters())
    loss.backward()
    return dict(loss=loss.item(), corr=corr.detach().cpu().numpy(),
                grads=[q.grad.cpu().numpy() for q in p.parameters()],
                bn=[t.cpu().numpy() for st in new.bn1 + new.bn2 for t in st],
                cca=[t.cpu().numpy() for t in new.cca])


def step_errors(a, b) -> dict:
    """Differences of two ``one_step`` results; gradients as the largest
    element difference over the largest gradient element of ``b``."""
    g_max = max(float(np.abs(g).max()) for g in b["grads"])

    def worst(xs, ys, rel=False):
        return max(float(np.abs(x - y).max()
                         / (np.abs(y).max() if rel else 1.0))
                   for x, y in zip(xs, ys))

    return dict(loss=abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                corr=float(np.abs(a["corr"] - b["corr"]).max()),
                grad=worst(a["grads"], b["grads"]) / g_max, grad_max=g_max,
                bn_rel=worst(a["bn"], b["bn"], rel=True),
                cov_rel=worst(a["cca"][4:], b["cca"][4:], rel=True),
                means=worst(a["cca"][2:4], b["cca"][2:4]),
                uv=worst(a["cca"][:2], b["cca"][:2]))


def step_card_vs_cpu(torch, cfg, tree, x1, x2, dev):
    """One step on the card against the CPU (and both against float64 on
    the card, polar only) -> the differences (raises past the
    tolerances)."""
    card = one_step(torch, cfg, tree, x1, x2, dev, torch.float32)
    cpu = one_step(torch, cfg, tree, x1, x2, "cpu", torch.float32)
    err = {"card_vs_cpu": step_errors(card, cpu)}
    e = err["card_vs_cpu"]
    assert e["loss"] <= STEP_LOSS_RTOL, err
    assert e["corr"] <= 1e-4, err
    if cfg.whitening == "polar":
        f64 = one_step(torch, cfg, tree, x1, x2, dev, torch.float64)
        err["card_vs_float64"] = step_errors(card, f64)
        err["cpu_vs_float64"] = step_errors(cpu, f64)
        assert e["grad"] <= STEP_GRAD_CPU_TOL, err
        assert err["card_vs_float64"]["grad"] <= STEP_GRAD_TOL, err
        assert e["bn_rel"] <= STEP_STATE_RTOL, err
        assert e["cov_rel"] <= STEP_STATE_RTOL, err
        assert e["means"] <= 1e-5, err
        assert e["uv"] <= STEP_UV_ATOL, err
    return err


def valid_npz(tmp, pieces):
    """The valid pieces as an ``npz:`` source and a split yaml whose test
    split they are, for ``run_eval`` to read."""
    import yaml

    images, specs, o2cs = pieces
    names = []
    for i, (im, sp, oc) in enumerate(zip(images, specs, o2cs)):
        names.append("valid_%02d" % i)
        np.savez(os.path.join(tmp, names[-1] + ".npz"), image=im,
                 **{"spec_%d" % k: s for k, s in enumerate(sp)},
                 **{"o2c_%d" % k: o for k, o in enumerate(oc)})
    split = os.path.join(tmp, "valid_split.yaml")
    with open(split, "w") as fp:
        yaml.safe_dump({"train": [], "valid": [], "test": names}, fp)
    return split


def learning_fit(torch, ctx, data, iters, count,
                 run_eval_atol=FIT_MRR_ATOL, keep_curves=None,
                 run_eval_args=()):
    """A full-width ``fit`` of ``TRAIN_EPOCHS`` epochs over ``data`` with
    the iterators ``iters`` under deterministic algorithms (``deterministic``),
    held to the learning criteria: train loss
    falls, validation MRR rises above epoch 1's and above twice chance, no
    NaN, kernel 1 launched at least twice an epoch; the last evaluation's
    ranks through kernel 1 equal the full argsort's, and the dump read back
    by ``run_eval`` gives the MRR ``fit`` reported (within
    ``run_eval_atol``; ``run_eval_args`` added to its command line); the
    results curves are copied to ``keep_curves`` when given -> the fit's
    record."""

    from audio_sheet_retrieval_tpu_torch.cli import run_eval
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.ops import metrics
    from audio_sheet_retrieval_tpu_torch.train import engine

    dev, cfg = ctx["dev"], ctx["cfg"]
    n_va = TRAIN_PIECES["n_valid"] * TRAIN_PIECES["n_onsets"]   # 1,000
    fit_cfg = dataclasses.replace(cfg, max_epochs=TRAIN_EPOCHS)
    recs = []
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "params.pkl")
        torch.cuda.reset_peak_memory_stats()
        launches = {}

        def run():
            out = engine.fit(
                cca_model.init_model(torch.Generator().manual_seed(23), cfg,
                                     device="cpu"),
                data, fit_cfg, *iters, device=dev, out_path=tmp,
                dump_file=dump, verbose=False, on_epoch=recs.append)
            launches.update(read_launches())
            return out

        with deterministic(torch):
            best, best_map = count(run)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if keep_curves is not None:
            shutil.copy(os.path.join(tmp, "results.pkl"), keep_curves)
        assert len(recs) == TRAIN_EPOCHS, recs
        assert all(np.isfinite(r["train_loss"]) for r in recs), recs
        assert recs[-1]["train_loss"] < recs[0]["train_loss"], recs
        chance = float(np.mean(1.0 / np.arange(1, n_va + 1)))
        assert recs[-1]["map_va"] > recs[0]["map_va"], recs
        assert recs[-1]["map_va"] > 2 * chance, recs
        assert launches["topk_gallery"] >= 2 * TRAIN_EPOCHS, launches
        # the valid codes of the best params, as fit's evaluation embeds
        # them: kernel 1's ranks equal the full argsort's
        embed_pair = engine.make_eval_fns(cfg)[0]
        folded = best.to(dev).fold()
        V = [embed_pair(folded, torch.from_numpy(a).to(dev),
                        torch.from_numpy(b).to(dev))
             for a, b in (ctx["valid_pool"][i:i + cfg.batch_size]
                          for i in range(0, n_va, cfg.batch_size))]
        lv1 = torch.cat([v[0] for v in V]).cpu().numpy()
        lv2 = torch.cat([v[1] for v in V]).cpu().numpy()
        _, med, _, hits, mrr = metrics.eval_retrieval(lv1, lv2, device=dev)
        assert abs(mrr - best_map) <= FIT_MRR_ATOL, (mrr, best_map)
        as_cli = {"map": mrr, "med_rank": med, "recall_at_k": {
            "%d" % k: 100.0 * v / n_va for k, v in hits.items()}}
        rank_check = check_eval_ranks(torch, dev, lv1, lv2, as_cli)
        # the dump, read back by run_eval over the same valid pieces
        split = valid_npz(tmp, synthetic.make_piece_list(
            23 + 1, TRAIN_PIECES["n_valid"],
            n_onsets=TRAIN_PIECES["n_onsets"]))
        ev = count(lambda: run_eval.main(
            ["--data", "npz:" + tmp, "--train_split", split, "--n_test",
             str(n_va), "--param_file", dump, "--device", str(dev)]
            + list(run_eval_args)))
        assert abs(ev["map"] - best_map) <= run_eval_atol, (ev, best_map)
    return dict(epochs=recs, best_map=best_map, chance_mrr=chance,
                run_eval_map=ev["map"], max_memory_allocated_mb=peak_mb,
                eval_ranks=rank_check, launches=launches)


def fit_numbers(recs) -> list:
    return [dict(number=r["number"], data=r["data"],
                 updates_per_s=r["updates_per_s"],
                 step_loop_s=r["loop_seconds"],
                 iterator_wait_s=r["wait_seconds"],
                 iterator_wait_share=r["wait_seconds"] / r["loop_seconds"],
                 eval_s=r["eval_seconds"]) for r in recs]


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and PyTorch's deterministic-
    algorithms check (warning mode) inside the block, the flags restored
    after. With cuDNN's default choice the backward-weight convolutions of
    blocks 0-3 and 8 differ run to run, and with them a 3-epoch fit's
    trajectory: one such fit in about eight did not learn (PERF.md §7);
    ``scripts/torch_fit_seeds.py`` holds the deterministic fit to the
    learning criteria over five seed pairs."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags


def resume_bit_identical(torch, ctx, data_and_iters, count):
    """Kill and resume, bit for bit, under deterministic cuDNN: a 4-epoch
    ``fit`` against one stopped after 2 epochs and resumed from its
    snapshot to 4 (the train pool reshuffles every second epoch);
    ``data_and_iters()`` makes fresh data and iterators. PyTorch's
    deterministic-algorithms check, in warning mode, names every op of the
    path that has no deterministic CUDA implementation -> (epochs, those
    ops)."""
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.train import engine

    dev, cfg = ctx["dev"], ctx["cfg"]
    res_cfg = dataclasses.replace(cfg, k_samples=150, patience=50)

    def resume_run(outdir, resume_file, n_epochs):
        recs = []
        data, train_it, valid_it = data_and_iters()
        count(lambda: engine.fit(
            cca_model.init_model(torch.Generator().manual_seed(5), cfg,
                                 device="cpu"),
            data, res_cfg, train_it, valid_it, device=dev,
            out_path=outdir, num_epochs=n_epochs, verbose=False,
            on_epoch=recs.append, resume_file=resume_file))
        return [(r["train_loss"], r["valid_loss"], r["map_va"], r["map_tr"])
                for r in recs]

    with deterministic(torch), tempfile.TemporaryDirectory() as tmp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        snap = os.path.join(tmp, "fit_state.pkl")
        full = resume_run(os.path.join(tmp, "full"), None, 4)
        first = resume_run(os.path.join(tmp, "p1"), snap, 2)
        second = resume_run(os.path.join(tmp, "p2"), snap, 4)
    nondeterministic = sorted({str(w.message)[:160] for w in caught
                               if "determinis" in str(w.message)})
    assert first == full[:2] and second == full[2:], (full, first, second)
    return full, nondeterministic


def cli_run(count, argv, path):
    """``run_train.main(argv)`` on the card into a temporary root: the dump
    and the curves written, no snapshot left, and the data path the run
    itself printed (its "Training data:" line) naming ``path`` -> (files,
    that line)."""
    import contextlib
    import io

    from audio_sheet_retrieval_tpu_torch.cli import run_train

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            count(lambda: run_train.main(argv + ["--exp_root", tmp]))
        root = os.path.join(tmp, os.listdir(tmp)[0])
        files = sorted(os.listdir(root))
    assert "params.pkl" in files and "results.pkl" in files, files
    assert not any(f.startswith("fit_state") for f in files), files
    said = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("Training data:")]
    assert len(said) == 1 and said[0].startswith("Training data: " + path), \
        said
    return files, said[0]


def launch_counter(launches):
    """-> count(fn): runs ``fn`` with the launch counters zeroed before
    and adds what it launched to ``launches``."""
    def count(fn):
        zero_launches()
        out = fn()
        for name, n in read_launches().items():
            launches[name] += n
        return out
    return count


def phase_train(torch, ctx):
    from audio_sheet_retrieval_tpu_torch import config
    from audio_sheet_retrieval_tpu_torch.cli import run_train
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.data.iterators import (
        MultiviewPoolIteratorUnsupervised as PoolIterator,
    )
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery,
        topk_gallery_plain,
    )
    from audio_sheet_retrieval_tpu_torch.train import engine
    from audio_sheet_retrieval_tpu_torch.train import state as ts

    dev, cfg = ctx["dev"], ctx["cfg"]
    assert run_train.build_arg_parser().get_default("device") == "cuda"
    augment = config.load_experiment_config("mutopia_full_aug").augment
    ctx["augment"] = augment
    launches = {name: 0 for name in read_launches()}
    count = launch_counter(launches)

    # 1. one step, card against CPU, polar then eigh
    tree = lasagne_import.train_params_to_numpy(cca_model.init_model(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    small = synthetic.load_synthetic_retrieval(
        n_train=1, n_valid=1, n_test=1, n_onsets=120, augment=augment)
    x1, x2 = small["train"][0:cfg.batch_size]
    ctx["step_batch"], ctx["step_tree"] = (x1, x2), tree
    step_err = {w: step_card_vs_cpu(
        torch, dataclasses.replace(cfg, whitening=w), tree, x1, x2, dev)
        for w in ("polar", "eigh")}
    emit("train", check="one step, card vs cpu", batch=cfg.batch_size,
         errors=step_err)

    # 2. a short full-width fit over the host iterator, its evaluation
    # through kernel 1
    t0 = time.perf_counter()
    data = synthetic.load_synthetic_retrieval(**TRAIN_PIECES, augment=augment)
    pools_s = time.perf_counter() - t0
    assert data["train"].shape[0] == (TRAIN_PIECES["n_train"]
                                      * TRAIN_PIECES["n_onsets"])
    assert data["valid"].shape[0] == (TRAIN_PIECES["n_valid"]
                                      * TRAIN_PIECES["n_onsets"])
    ctx["train_data"], ctx["valid_pool"] = data, data["valid"]
    host = learning_fit(torch, ctx, data, (
        PoolIterator(cfg.batch_size, k_samples=cfg.k_samples),
        PoolIterator(cfg.batch_size, shuffle=False)), count,
        keep_curves=os.path.join(ctx["reports_dir"], "results.pkl"))
    assert {r["data"] for r in host["epochs"]} == {"host iterator"}
    ctx["host_fit"] = host
    emit("train", check="fit", pools_seconds=pools_s, **host)

    # 3. the CLI on the card over the host iterator
    files, said = cli_run(count, ["--data", "synthetic", "--max_epochs", "2",
                                  "--host_data"], "host iterator")
    emit("train", check="run_train cli --host_data", files=files,
         reported=said)

    # 4. kill and resume, bit for bit, under deterministic cuDNN
    def host_data():
        rdata = synthetic.load_synthetic_retrieval(**RESUME_PIECES,
                                                   augment=augment)
        return rdata, PoolIterator(cfg.batch_size, k_samples=150), \
            PoolIterator(cfg.batch_size, shuffle=False)

    full, nondeterministic = resume_bit_identical(torch, ctx, host_data,
                                                  count)
    emit("train", check="kill and resume", epochs=full,
         resumed_bit_identical=True, cudnn_deterministic=True,
         ops_without_deterministic_cuda_path=nondeterministic)

    # 5. numbers: the step and the eigh step (CUDA events), launches a
    # step, peak memory, kernel 1 at the evaluation's shape
    numbers = {}
    x1d = torch.from_numpy(x1).to(dev)
    x2d = torch.from_numpy(x2).to(dev)
    for w in ("polar", "eigh"):
        c = dataclasses.replace(cfg, whitening=w)
        state = ts.init_train_state(lasagne_import.train_params_from_numpy(
            tree, c, device=dev), c)
        step = engine.make_train_step(c)
        torch.cuda.reset_peak_memory_stats()
        numbers[w] = dict(
            step_ms=cuda_ms(lambda: step(state, x1d, x2d), iters=20,
                            warmup=5),
            launches_per_step=count_launches(
                torch, lambda: step(state, x1d, x2d)),
            max_memory_allocated_mb=torch.cuda.max_memory_allocated()
            / 2**20)
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(1000, 32, generator=gen, device=dev)
    g = torch.randn(1000, 32, generator=gen, device=dev)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    g = g / torch.linalg.vector_norm(g, dim=1, keepdim=True)
    err = check_topk(torch, q, g, 25)
    b_ms, b_by = topk_bound(1000, 1000, 32, 25)
    k1 = dict(ms=cuda_ms(lambda: topk_gallery(q, g, 25)),
              plain_ms=cuda_ms(lambda: topk_gallery_plain(q, g, 25)),
              bound_ms=b_ms, bound_by=b_by,
              library_ms=cuda_ms(lambda: torch.topk(q @ g.T, 25, dim=1)),
              max_abs_err=err)
    emit("timing", kernel="topk_gallery", case="training evaluation",
         Q=1000, N=1000, d=32, k=25, **k1)
    ctx["f32_step"] = numbers["polar"]
    emit("train", check="numbers", step=numbers,
         fit_epochs=fit_numbers(host["epochs"]),
         fit_max_memory_allocated_mb=host["max_memory_allocated_mb"],
         launches=launches)
    assert launches["topk_gallery"] > 0, "training ran no top-k kernel"
    assert not torch.backends.cudnn.allow_tf32
    return launches


# --- phase 12: the device pool --------------------------------------------------

# the four branches of the batch assembly and the frequency shift, on top
# of NO_AUGMENT (the shipped mutopia_full_aug is the first)
POOL_BRANCHES = {
    "scale_and_translation": dict(sheet_scaling=[0.95, 1.05],
                                  system_translation=5, onset_translation=1),
    "translation_only": dict(system_translation=5),
    "scale_only": dict(sheet_scaling=[0.9, 1.1]),
    "neither": {},
    "spec_padding": dict(spec_padding=3, onset_translation=1),
}


def pool_card_vs_cpu(torch, dev, pieces, n_batches=5):
    """Each branch: one set of draws made on the CPU, the batch assembled
    on the card and on the CPU, bit-identical, over ``n_batches`` batches
    of 100 (edge entities among them); the card's own draws in their
    ranges; one assembly's time on the card (CUDA events) -> per branch."""
    from audio_sheet_retrieval_tpu_torch.data import device_pool as dp
    from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT

    out = {}
    for name, extra in POOL_BRANCHES.items():
        aug = dict(NO_AUGMENT, **extra)
        card, cpu = (dp.DevicePool(*pieces, data_augmentation=aug,
                                   rng=np.random.default_rng(0), device=d)
                     for d in (dev, "cpu"))
        assert torch.equal(card.strip.cpu(), cpu.strip)
        assert torch.equal(card.spec.cpu(), cpu.spec)
        assert np.array_equal(card._order, cpu._order)
        g = torch.Generator().manual_seed(1)
        rng = np.random.default_rng(2)
        n = cpu.shape[0]
        for _ in range(n_batches):
            sel = rng.integers(0, n, 100)
            sel[:2] = (0, n - 1)
            coords, onsets = cpu.entity_coords[sel], cpu.entity_onsets[sel]
            draws = dp.draw(g, 100, aug, True)
            want = cpu._assemble(cpu.strip, cpu.spec, torch.from_numpy(coords),
                                 torch.from_numpy(onsets), draws, True)
            got = card._assemble(
                card.strip, card.spec, card.put(coords), card.put(onsets),
                dp.Draws(*(None if x is None else x.to(dev) for x in draws)),
                True)
            assert all(a.device.type == "cuda" for a in got)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), \
                name
        d = dp.draw(card.generator, 1000, aug, True)
        if d.scale is not None:
            sc = aug["sheet_scaling"]
            assert sc[0] <= float(d.scale.min()) <= float(d.scale.max()) \
                <= sc[1]
        if d.shift is not None:
            assert set(d.shift.tolist()) == set(range(-aug["spec_padding"],
                                                      0))
        c, o = card.put(coords), card.put(onsets)
        out[name] = dict(batches_bit_identical=n_batches, batch=100,
                         assemble_ms=cuda_ms(lambda: card.assemble(c, o)))
    return out


def phase_device_pool(torch, ctx):
    from audio_sheet_retrieval_tpu_torch.cli import run_train
    from audio_sheet_retrieval_tpu_torch.data import device_pool as dp
    from audio_sheet_retrieval_tpu_torch.data import synthetic

    dev, cfg, augment = ctx["dev"], ctx["cfg"], ctx["augment"]
    assert run_train.build_arg_parser().get_default("host_data") is False
    launches = {name: 0 for name in read_launches()}
    count = launch_counter(launches)

    # a. batches, card against CPU, in every branch
    branches = pool_card_vs_cpu(torch, dev, synthetic.make_piece_list(
        23, 10, n_onsets=TRAIN_PIECES["n_onsets"]))
    emit("device_pool", check="batches, card vs cpu", branches=branches)

    # b. the same full-width fit over the device pools, lifted as
    # run_train lifts them
    def lift(data, seed):
        return dict(data, train=dp.from_host_pool(
            data["train"], rng=np.random.default_rng(seed), device=dev),
            valid=dp.from_host_pool(data["valid"], shuffle=False,
                                    rng=np.random.default_rng(seed + 1),
                                    device=dev))

    t0 = time.perf_counter()
    data = lift(ctx["train_data"], 23)
    lift_s = time.perf_counter() - t0
    pool_mb = (data["train"].strip.numel() + 4 * data["train"].spec.numel()
               + data["valid"].strip.numel()
               + 4 * data["valid"].spec.numel()) / 2**20
    fit = learning_fit(torch, ctx, data, (
        dp.DeviceBatchIterator(cfg.batch_size, k_samples=cfg.k_samples),
        dp.DeviceBatchIterator(cfg.batch_size, shuffle=False, train=False)),
        count)
    assert {r["data"] for r in fit["epochs"]} == {"device pool"}
    emit("device_pool", check="fit", lift_seconds=lift_s, pools_mb=pool_mb,
         **fit)

    # c. numbers, beside the host iterator's fit of phase 11
    ctx["pool_fit"] = fit
    emit("device_pool", check="numbers",
         device_pool=fit_numbers(fit["epochs"]),
         host_iterator=fit_numbers(ctx["host_fit"]["epochs"]),
         max_memory_allocated_mb=dict(
             device_pool=fit["max_memory_allocated_mb"],
             host_iterator=ctx["host_fit"]["max_memory_allocated_mb"]))

    # d. kill and resume over the device pools, every augmentation on
    def device_data():
        rdata = lift(synthetic.load_synthetic_retrieval(
            **RESUME_PIECES, augment=augment), 5)
        return rdata, dp.DeviceBatchIterator(cfg.batch_size, k_samples=150), \
            dp.DeviceBatchIterator(cfg.batch_size, shuffle=False, train=False)

    full, nondeterministic = resume_bit_identical(torch, ctx, device_data,
                                                  count)
    emit("device_pool", check="kill and resume", epochs=full,
         resumed_bit_identical=True, cudnn_deterministic=True,
         ops_without_deterministic_cuda_path=nondeterministic)

    # e. run_train's default path is the device pool
    files, said = cli_run(count, ["--data", "synthetic", "--max_epochs",
                                  "2"], "device pool, batches assembled on "
                          "cuda")
    emit("device_pool", check="run_train cli", files=files, reported=said,
         launches=launches)
    assert launches["topk_gallery"] > 0, "the device pool ran no top-k kernel"
    return launches

# --- phase 13: the precision ladder ---------------------------------------------

# sheet -> audio rank<=1 of the JAX package itself in bfloat16 on phase 7's
# corpus and checkpoint, as JAX_S2A_RANK1 in float32:
# scripts/jax_s2a_rank1.py (its fused sheet query), run once on the CPU
# with jax 0.9.0 (rank<=5 37; float32 19 and 40, as above)
JAX_S2A_RANK1_BF16 = 20
HIGH_CONV_ERR_RATIO = 4.0  # high's conv error from float64 over f32's
HIGH_CODES_ATOL = 1e-5     # high's gallery codes against highest's
# bf16 codes against float32's of the same build: farther than this, ten
# times HIGH_CODES_ATOL, or the build ran float32 (a bf16 build reads
# 1e-3 or more; float32 reorderings 1e-5 or less)
BF16_CODES_MIN_DIFF = 1e-4
BF16_STEP_LOSS_RTOL = 1e-2
BF16_STEP_GRAD_RATIO = 2.0  # card's gradient distance from float64 / CPU's
# the card's bf16 gradient distance from float64 over its float32 step's:
# more than this, or the step ran float32 (tests/test_torch_precision.py
# holds the CPU step to the same)
BF16_STEP_OVER_F32 = 10.0
# run_eval re-embeds the bf16-trained dump in float32 (its CLI, like the
# JAX package's, takes no dtype) where fit evaluated it in bf16: other
# codes, other near-ties (8.0e-4 apart at MRR 0.096 on an H100)
BF16_RUN_EVAL_MRR_ATOL = 1e-2


def top1_details(torch, params, cfg, gallery, specs, n_pieces):
    """Phase 4's queries (one 100-excerpt query a piece, u16 spectrogram)
    -> (each query's top-1 piece: the most votes, the lowest index on a
    tie; each excerpt's nearest gallery row), host arrays."""
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import topk_gallery
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
        embed_spec_excerpts,
    )

    tops, nearest = [], []
    for payload, scale, starts in accuracy.query_payloads(cfg, specs, 1, 100,
                                                          16):
        payload = torch.from_numpy(payload).to(gallery.device)
        for st in starts:
            codes = embed_spec_excerpts(params, cfg, payload, scale, st, True)
            _, idx = topk_gallery(codes.contiguous(), gallery.gallery_n, 25)
            counts = torch.bincount(gallery.ids_device[idx].reshape(-1),
                                    minlength=n_pieces)[:n_pieces]
            tops.append(int(counts.argmax()))
            nearest.append(idx[:, 0].cpu().numpy())
    return np.array(tops), np.concatenate(nearest)


def block_inputs(torch, enc_mod, x):
    """The input of each block of an eval encoder on the batch ``x``
    (float32)."""
    from audio_sheet_retrieval_tpu_torch.models import encoder

    out, h = [], x
    with torch.no_grad():
        for i in range(encoder.N_CONV_BLOCKS):
            out.append(h)
            h = enc_mod.block(i, h)
            if encoder.pools_after(i):
                h = encoder.maxpool2(h)
    return out


def piece0_batches(torch, ctx):
    """Piece 0's real encoder batches: its gallery windows as the sheet
    build embeds them, prepared, and its audio-DB excerpts (stride 10)."""
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.train.engine import (
        prepare_view1_device,
    )

    dev, cfg = ctx["dev"], ctx["cfg"]
    im, sp = ctx["images"][0], ctx["specs"][0]
    st = accuracy.gallery_starts(cfg, [im], ctx["coords"][:1])[0]
    r0 = im.shape[0] // 2 - 80
    wins = np.stack([im[r0:r0 + 160, s:s + 200] for s in st])[:, None]
    x1 = prepare_view1_device(torch.from_numpy(wins).to(dev), cfg)
    x2 = torch.from_numpy(np.ascontiguousarray(np.stack(
        [sp[:, s:s + 42] for s in range(0, sp.shape[1] - 42, 10)])[:, None]
    )).to(dev)
    return x1, x2


def conv_errors(torch, ctx, modes):
    """Each block's conv of both views on its real inputs (piece 0's
    batches) in each of ``modes`` (a name -> an encoder mode, the block run
    as the eval encoder runs it) against float64 on the card: the largest
    error over the largest output -> rows."""
    import torch.nn.functional as F

    params = ctx["params"]
    x1, x2 = piece0_batches(torch, ctx)
    rows = []
    with torch.no_grad():
        for view, e, x in (("view1", params.view1, x1),
                           ("view2", params.view2, x2)):
            for i, h in enumerate(block_inputs(torch, e, x)):
                blk = e.blocks[i]
                ref = F.conv2d(h.double(), blk.w.double(), blk.b.double(),
                               padding=blk.w.shape[-1] // 2)
                top = float(ref.abs().max())
                row = dict(view=view, block=i, input=list(h.shape))
                for name, mode in modes.items():
                    row[name] = float((blk(h, mode).double() - ref).abs()
                                      .max()) / top
                rows.append(row)
    return rows


def high_conv_errors(torch, ctx, mode):
    """``conv_errors`` of float32 highest and ``high`` (the block run in
    ``mode``, what ``check_numerics`` maps ``high`` onto) -> rows with
    their ratio (raises past HIGH_CONV_ERR_RATIO)."""
    from audio_sheet_retrieval_tpu_torch.models import encoder

    rows = conv_errors(torch, ctx, {"highest": encoder.HIGHEST,
                                    "high": mode})
    for row in rows:
        row["ratio"] = row["high"] / row["highest"]
    assert not torch.backends.cudnn.allow_tf32
    worst = max(r["ratio"] for r in rows)
    assert worst <= HIGH_CONV_ERR_RATIO, rows
    return rows


def relative_l2(a, b) -> float:
    """||a - b|| / ||b|| over lists of arrays (a whole gradient)."""
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
    return float(np.sqrt(num / sum(float((y ** 2).sum()) for y in b)))


def device_busy_ms(torch, fn, n: int) -> float:
    """Device busy time a call of ``fn`` (torch.profiler over ``n`` calls:
    the union of the intervals of every device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert spans, "the profiler recorded no device activity"
    busy, (cs, ce) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > ce:
            busy, cs, ce = busy + ce - cs, a, b
        else:
            ce = max(ce, b)
    return (busy + ce - cs) / 1000.0 / n


def phase_precision(torch, ctx):
    """13. The JAX package's bf16 and ``high`` numerics on phase 4's corpus
    and checkpoint at full width: a. bf16 builds in the JAX bench's three
    serving arms, b. bf16 sheet -> audio, c. ``high``, d. bf16 training."""
    from audio_sheet_retrieval_tpu_torch.data import device_pool as dp
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.server import (
        AudioSheetServer,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        RetrievalWrapper,
    )
    from audio_sheet_retrieval_tpu_torch.train import engine
    from audio_sheet_retrieval_tpu_torch.train import state as ts

    dev, cfg, params = ctx["dev"], ctx["cfg"], ctx["params"]
    images, specs, coords = ctx["images"], ctx["specs"], ctx["coords"]
    n_pieces = len(images)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cfg_high = dataclasses.replace(cfg, conv_precision="high")
    launches = {name: 0 for name in read_launches()}
    count = launch_counter(launches)
    acc_kw = dict(coords=coords, n_candidates=25, queries_per_piece=1,
                  excerpts_per_query=100, quantize=16, device=dev)

    # a. bf16 builds in the JAX bench's serving arms (bench.py:713-721),
    # each beside the float32 build of its arm (phase 4's exact and
    # fullconv galleries; gather_half's built here)
    arms = {"exact": {}, "gather_half": dict(gather_half=True),
            "fullconv": dict(fullconv=True)}
    f32_gals = dict(ctx["galleries"], gather_half=count(
        lambda: accuracy.build_piece_gallery(params, cfg, images,
                                             coords=coords, device=dev,
                                             gather_half=True)))
    f32_top = {arm: count(lambda: top1_details(torch, params, cfg, g, specs,
                                               n_pieces))
               for arm, g in f32_gals.items()}
    for kw in arms.values():     # warm-up: cuDNN's bf16 plans
        accuracy.build_piece_gallery(params, cfg16, images[:1],
                                     coords=coords[:1], device=dev, **kw)
    torch.cuda.synchronize()
    # kernel 2's launches in the bf16 builds are kept for the check below
    # (the wrapper appends each launch to its ``recorded`` list)
    recorded = []

    def build(kw):
        win.gather_feature_windows.recorded = recorded
        try:
            return accuracy.build_piece_gallery(params, cfg16, images,
                                                coords=coords, device=dev,
                                                **kw)
        finally:
            win.gather_feature_windows.recorded = None

    bf16, bf16_gals = {}, {}
    for arm, kw in arms.items():
        t0 = time.perf_counter()
        gal = bf16_gals[arm] = count(lambda: build(kw))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        acc = count(lambda: accuracy.piece_id_accuracy(
            params, cfg16, images, specs, gallery=gal, **acc_kw))
        top, near = count(lambda: top1_details(torch, params, cfg16, gal,
                                               specs, n_pieces))
        f32 = ctx["serving"].get(arm, {})
        assert gal.gallery_n.shape == f32_gals[arm].gallery_n.shape, arm
        bf16[arm] = dict(
            codes_max_abs_diff_f32=float((gal.gallery_n - f32_gals[arm]
                                          .gallery_n).abs().max()),
            gallery_rows=gal.n, build_s=build_s,
            sheet_emb_per_s=gal.n / build_s, rank1=acc["rank1"],
            rank5=acc["rank5"], n=acc["n"], query_p50_ms=acc["p50_ms"],
            piece_top1_equal_f32=int((top == f32_top[arm][0]).sum()),
            excerpt_top1_share_equal_f32=float(
                (near == f32_top[arm][1]).mean()),
            f32_sheet_emb_per_s=f32.get("emb_per_s"),
            f32_query_p50_ms=f32.get("query_p50_ms"))
        emit("precision", check="a. bf16 build", arm=arm, **bf16[arm])
    ctx["bf16_builds"] = bf16
    # phase 13e's references: each arm's float32 and bf16 builds, and the
    # float32 builds' top-1 pieces
    ctx["f32_gals"], ctx["f32_top"] = f32_gals, f32_top
    ctx["bf16_gals"] = bf16_gals
    for arm, row in bf16.items():    # >= 59 of 60 each
        assert row["n"] == n_pieces and row["rank1"] >= n_pieces - 1, \
            (arm, row)
        assert row["piece_top1_equal_f32"] >= n_pieces - 1, (arm, row)
        # the build ran bf16, not float32 on the quiet
        assert row["codes_max_abs_diff_f32"] > BF16_CODES_MIN_DIFF, (arm, row)
    # kernel 2 ran its bf16 path in the fullconv build, each launch
    # bit-identical to the plain version on the same plane
    assert len(recorded) == n_pieces, len(recorded)
    for plane, starts, n_cols, out in recorded:
        assert plane.dtype == out.dtype == torch.bfloat16
        assert torch.equal(out, win.gather_feature_windows_plain(
            plane, starts, n_cols)), "bf16 gather differs"
    emit("precision", check="a. kernel 2 in bf16", launches=len(recorded),
         bit_identical_to_plain=True, plane=list(recorded[0][0].shape))
    del recorded

    # b. bf16 sheet -> audio
    names = ["piece_%03d" % p for p in range(n_pieces)]
    srv = AudioSheetServer(device=dev)
    srv.initialize_embedding_network(RetrievalWrapper(cfg16, params=params,
                                                      device=dev))
    srv.initialize_audio_db_from_specs_device(names[:2], specs[:2])  # warm
    srv.detect_performance_from_sheet(images[0], top_k=2, n_candidates=25)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count(lambda: srv.initialize_audio_db_from_specs_device(names, specs))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ranks, lat = [], []

    def queries():
        for p, name in enumerate(names):
            t0 = time.perf_counter()
            result, votes = srv.detect_performance_from_sheet(
                images[p], top_k=n_pieces, n_candidates=25)
            lat.append(time.perf_counter() - t0)
            ranks.append(pessimistic_rank(dict(zip(result, votes)), names,
                                          name))

    count(queries)
    audio_codes = srv._audio_gallery.gallery_n
    assert audio_codes.shape == ctx["s2a_codes"].shape
    s2a = dict(codes_max_abs_diff_f32=float((audio_codes - ctx["s2a_codes"])
                                            .abs().max()),
               audio_rows=srv._audio_gallery.n, build_s=build_s,
               audio_emb_per_s=srv._audio_gallery.n / build_s,
               rank1=sum(r <= 1 for r in ranks),
               rank5=sum(r <= 5 for r in ranks), n=len(ranks),
               query_p50_ms=float(np.percentile(lat, 50) * 1000),
               jax_cpu_rank1_bf16=JAX_S2A_RANK1_BF16, f32=ctx["s2a"])
    emit("precision", check="b. bf16 sheet -> audio", **s2a)
    ctx["bf16_s2a"] = s2a
    assert s2a["rank1"] >= JAX_S2A_RANK1_BF16 - 1, s2a
    assert s2a["codes_max_abs_diff_f32"] > BF16_CODES_MIN_DIFF, s2a

    # c. high: each block's conv against float64, the codes and ranks
    # against highest's, no TF32 left behind
    conv_rows = high_conv_errors(torch, ctx,
                                 cca_model.check_numerics(cfg_high))
    emit("precision", check="c. high conv error vs float64",
         worst_ratio=max(r["ratio"] for r in conv_rows), blocks=conv_rows)
    x1 = torch.from_numpy(np.stack([images[0][20:180, s:s + 200] for s in
                                    np.linspace(0, images[0].shape[1] - 200,
                                                20).astype(int)])[:, None]
                          ).to(dev)
    x2 = torch.from_numpy(np.ascontiguousarray(np.stack(
        [specs[0][:, s:s + 42] for s in np.linspace(
            0, specs[0].shape[1] - 42, 20).astype(int)])[:, None])).to(dev)
    before = engine.make_eval_fns(cfg)[0](params, x1, x2)
    engine.make_eval_fns(cfg_high)[0](params, x1, x2)
    after = engine.make_eval_fns(cfg)[0](params, x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(before, after)), "TF32 leak"
    assert not torch.backends.cudnn.allow_tf32
    accuracy.build_piece_gallery(params, cfg_high, images[:1],
                                 coords=coords[:1], device=dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gal = count(lambda: accuracy.build_piece_gallery(
        params, cfg_high, images, coords=coords, device=dev))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    acc = count(lambda: accuracy.piece_id_accuracy(
        params, cfg_high, images, specs, gallery=gal, **acc_kw))
    codes_err = float((gal.gallery_n - ctx["gallery"].gallery_n).abs().max())
    high = dict(gallery_rows=gal.n, build_s=build_s,
                sheet_emb_per_s=gal.n / build_s,
                f32_sheet_emb_per_s=ctx["serving"]["exact"]["emb_per_s"],
                codes_max_abs_err_vs_highest=codes_err, rank1=acc["rank1"],
                ranks_equal_highest=acc["ranks"]
                == ctx["serving"]["exact"]["ranks"],
                query_p50_ms=acc["p50_ms"], f32_forward_after_high_equal=True)
    emit("precision", check="c. high", **high)
    assert codes_err <= HIGH_CODES_ATOL, high
    assert high["ranks_equal_highest"], high

    # d. bf16 training: one step card vs CPU vs float64, a fit over device
    # pools at phase 12's settings, the numbers beside float32's
    tree = lasagne_import.train_params_to_numpy(cca_model.init_model(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    x1s, x2s = ctx["step_batch"]
    card = one_step(torch, cfg16, tree, x1s, x2s, dev, torch.float32)
    cpu = one_step(torch, cfg16, tree, x1s, x2s, "cpu", torch.float32)
    f64 = one_step(torch, cfg, tree, x1s, x2s, dev, torch.float64)
    card32 = one_step(torch, cfg, tree, x1s, x2s, dev, torch.float32)
    step = dict(loss_card=card["loss"], loss_cpu=cpu["loss"],
                loss_float64=f64["loss"],
                loss_rel_card_vs_cpu=abs(card["loss"] - cpu["loss"])
                / abs(cpu["loss"]),
                grad_rel_l2_card_vs_float64=relative_l2(card["grads"],
                                                        f64["grads"]),
                grad_rel_l2_cpu_vs_float64=relative_l2(cpu["grads"],
                                                       f64["grads"]),
                f32_grad_rel_l2_card_vs_float64=relative_l2(card32["grads"],
                                                            f64["grads"]))
    emit("precision", check="d. one bf16 step, card vs cpu vs float64",
         batch=cfg.batch_size, **step)
    ctx["bf16_step"] = step
    assert step["loss_rel_card_vs_cpu"] <= BF16_STEP_LOSS_RTOL, step
    assert step["grad_rel_l2_card_vs_float64"] <= BF16_STEP_GRAD_RATIO * \
        step["grad_rel_l2_cpu_vs_float64"], step
    # the step ran bf16, not float32 on the quiet
    assert step["grad_rel_l2_card_vs_float64"] > BF16_STEP_OVER_F32 * \
        step["f32_grad_rel_l2_card_vs_float64"], step

    def lift(data, seed):
        return dict(data, train=dp.from_host_pool(
            data["train"], rng=np.random.default_rng(seed), device=dev),
            valid=dp.from_host_pool(data["valid"], shuffle=False,
                                    rng=np.random.default_rng(seed + 1),
                                    device=dev))

    fit = learning_fit(torch, dict(ctx, cfg=cfg16), lift(ctx["train_data"],
                                                         23), (
        dp.DeviceBatchIterator(cfg.batch_size, k_samples=cfg.k_samples),
        dp.DeviceBatchIterator(cfg.batch_size, shuffle=False, train=False)),
        count, run_eval_atol=BF16_RUN_EVAL_MRR_ATOL)
    assert {r["data"] for r in fit["epochs"]} == {"device pool"}
    x1d = torch.from_numpy(x1s).to(dev)
    x2d = torch.from_numpy(x2s).to(dev)
    numbers = {}
    for name, c in (("bfloat16", cfg16), ("float32", cfg)):
        state = ts.init_train_state(lasagne_import.train_params_from_numpy(
            tree, c, device=dev), c)
        train_step = engine.make_train_step(c)
        torch.cuda.reset_peak_memory_stats()
        numbers[name] = dict(
            step_ms=cuda_ms(lambda: train_step(state, x1d, x2d), iters=20,
                            warmup=5),
            device_busy_ms_per_step=device_busy_ms(
                torch, lambda: train_step(state, x1d, x2d), 5),
            max_memory_allocated_mb=torch.cuda.max_memory_allocated()
            / 2**20)
    emit("precision", check="d. bf16 training", fit=fit,
         fit_epochs=fit_numbers(fit["epochs"]),
         f32_fit_epochs=fit_numbers(ctx["pool_fit"]["epochs"]),
         fit_max_memory_allocated_mb=dict(
             bfloat16=fit["max_memory_allocated_mb"],
             float32=ctx["pool_fit"]["max_memory_allocated_mb"]),
         step=numbers, f32_step_phase11=ctx["f32_step"], launches=launches)
    ctx["step_numbers"] = numbers
    assert launches["topk_gallery"] > 0 and \
        launches["gather_feature_windows"] > 0, launches
    assert not torch.backends.cudnn.allow_tf32
    return launches


# --- phase 13e: conv_precision="default", one TF32 pass a conv --------------

# default's codes against highest's of the same build: farther than high's
# gate, or the build ran float32 (one TF32 pass keeps 10 mantissa bits;
# float32 in another order stays within 1e-5)
TF32_CODES_MIN_DIFF = HIGH_CODES_ATOL
TF32_STEP_LOSS_RTOL = 1e-3   # a default step's loss against the f32 step's


def build_times(torch, params, cfg, images, coords, dev, kw) -> dict:
    """One gallery build of ``images`` in ``cfg``'s numerics, after a
    warm-up: its sheet embeddings a second (host clock, synchronised) and
    its device busy ms (``device_busy_ms``)."""
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy

    def run():
        return accuracy.build_piece_gallery(params, cfg, images,
                                            coords=coords, device=dev, **kw)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gal = run()
    torch.cuda.synchronize()
    return dict(sheet_emb_per_s=gal.n / (time.perf_counter() - t0),
                device_ms=device_busy_ms(torch, run, 1))


def phase_default(torch, ctx):
    """13e. The JAX package's ``conv_precision="default"`` in float32,
    each conv one TF32 pass (``encoder.TF32``), on phase 4's corpus and
    checkpoint at full width: a. the three builds, b. sheet -> audio, c.
    each block's conv error and the flags, d. a step and a fit, e. OMR;
    each beside highest's and bf16's from this run."""
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.cli.tutorial import resize_page
    from audio_sheet_retrieval_tpu_torch.data import device_pool as dp
    from audio_sheet_retrieval_tpu_torch.models import cca_model, encoder
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import
    from audio_sheet_retrieval_tpu_torch.omr.inference import prepare_image
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.server import (
        AudioSheetServer,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        RetrievalWrapper,
    )
    from audio_sheet_retrieval_tpu_torch.train import engine
    from audio_sheet_retrieval_tpu_torch.train import state as ts
    from audio_sheet_retrieval_tpu_torch.utils import roofline
    from audio_sheet_retrieval_tpu_torch.utils.image_io import imread_gray

    t_phase = time.perf_counter()
    dev, cfg, params = ctx["dev"], ctx["cfg"], ctx["params"]
    images, specs, coords = ctx["images"], ctx["specs"], ctx["coords"]
    n_pieces = len(images)
    cfg_def = dataclasses.replace(cfg, conv_precision="default")
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    assert cca_model.check_numerics(cfg_def) == encoder.TF32
    launches = {name: 0 for name in read_launches()}
    count = launch_counter(launches)
    acc_kw = dict(coords=coords, n_candidates=25, queries_per_piece=1,
                  excerpts_per_query=100, quantize=16, device=dev)

    def flags_off(where):
        assert not torch.backends.cudnn.allow_tf32, "TF32 left on: " + where
        assert not torch.backends.cuda.matmul.allow_tf32, where

    # a. the three builds under default, each beside the float32 and bf16
    # builds of its arm (phase 4's and phase 13a's)
    arms = {"exact": {}, "gather_half": dict(gather_half=True),
            "fullconv": dict(fullconv=True)}
    for kw in arms.values():     # warm-up: cuDNN's TF32 plans
        accuracy.build_piece_gallery(params, cfg_def, images[:1],
                                     coords=coords[:1], device=dev, **kw)
    torch.cuda.synchronize()
    flags_off("warm-up")
    recorded = []

    def build(kw):
        win.gather_feature_windows.recorded = recorded
        try:
            return accuracy.build_piece_gallery(params, cfg_def, images,
                                                coords=coords, device=dev,
                                                **kw)
        finally:
            win.gather_feature_windows.recorded = None

    rows, gals = {}, {}
    for arm, kw in arms.items():
        t0 = time.perf_counter()
        gal = gals[arm] = count(lambda: build(kw))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        flags_off(arm + " build")
        acc = count(lambda: accuracy.piece_id_accuracy(
            params, cfg_def, images, specs, gallery=gal, **acc_kw))
        top, near = count(lambda: top1_details(torch, params, cfg_def, gal,
                                               specs, n_pieces))
        replay = plain_replay_ranks(torch, params, cfg_def, gal, specs,
                                    n_pieces)
        f32_gal, f32_top = ctx["f32_gals"][arm], ctx["f32_top"][arm]
        # each mode's build timed alike here (not counted)
        times = {name: build_times(torch, params, c, images, coords, dev, kw)
                 for name, c in (("float32", cfg), ("bfloat16", cfg16),
                                 ("default", cfg_def))}
        flops = roofline.embed_flops(cfg, 1) * gal.n
        rows[arm] = dict(
            codes_max_abs_diff_f32=float((gal.gallery_n - f32_gal.gallery_n)
                                         .abs().max()),
            bf16_codes_max_abs_diff_f32=ctx["bf16_builds"][arm][
                "codes_max_abs_diff_f32"],
            gallery_rows=gal.n, build_s=build_s, build_times=times,
            mfu_default_vs_tf32_peak=roofline.mfu(
                flops / (times["default"]["device_ms"] / 1e3),
                torch.cuda.get_device_name(0), "float32", "default"),
            rank1=acc["rank1"], rank5=acc["rank5"], n=acc["n"],
            ranks_equal_plain_replay=replay == acc["ranks"],
            piece_top1_equal_f32=int((top == f32_top[0]).sum()),
            excerpt_top1_share_equal_f32=float((near == f32_top[1]).mean()),
            query_p50_ms=acc["p50_ms"],
            f32_query_p50_ms=ctx["serving"].get(arm, {}).get("query_p50_ms"),
            bf16_query_p50_ms=ctx["bf16_builds"][arm]["query_p50_ms"])
        emit("default", check="a. default build", arm=arm, **rows[arm])
    flags_off("the builds")
    for arm, row in rows.items():
        # it ran TF32 (past float32 noise), and it is nearer float32 than
        # bf16 is
        assert row["codes_max_abs_diff_f32"] > TF32_CODES_MIN_DIFF, \
            (arm, row)
        assert row["codes_max_abs_diff_f32"] < \
            row["bf16_codes_max_abs_diff_f32"], (arm, row)
        assert row["n"] == n_pieces and row["rank1"] >= n_pieces - 1, \
            (arm, row)
        assert row["piece_top1_equal_f32"] >= n_pieces - 1, (arm, row)
        assert row["ranks_equal_plain_replay"], (arm, row)
    # kernel 2 ran its float32 path in the default fullconv build, each
    # launch bit-identical to the plain version on the same plane
    assert len(recorded) == n_pieces, len(recorded)
    for plane, starts, n_cols, out in recorded:
        assert plane.dtype == out.dtype == torch.float32
        assert torch.equal(out, win.gather_feature_windows_plain(
            plane, starts, n_cols)), "default's f32 gather differs"
    emit("default", check="a. kernel 2 in the default fullconv build",
         launches=len(recorded), plane_dtype="float32",
         bit_identical_to_plain=True, plane=list(recorded[0][0].shape))
    del recorded

    # b. sheet -> audio: the audio DB and the strips' queries in default
    names = ["piece_%03d" % p for p in range(n_pieces)]
    srv = AudioSheetServer(device=dev)
    srv.initialize_embedding_network(RetrievalWrapper(cfg_def, params=params,
                                                      device=dev))
    srv.initialize_audio_db_from_specs_device(names[:2], specs[:2])  # warm
    srv.detect_performance_from_sheet(images[0], top_k=2, n_candidates=25)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count(lambda: srv.initialize_audio_db_from_specs_device(names, specs))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ranks, lat = [], []

    def queries():
        for p, name in enumerate(names):
            t0 = time.perf_counter()
            result, votes = srv.detect_performance_from_sheet(
                images[p], top_k=n_pieces, n_candidates=25)
            lat.append(time.perf_counter() - t0)
            ranks.append(pessimistic_rank(dict(zip(result, votes)), names,
                                          name))

    count(queries)
    flags_off("sheet -> audio")
    audio_codes = srv._audio_gallery.gallery_n
    s2a = dict(codes_max_abs_diff_f32=float((audio_codes - ctx["s2a_codes"])
                                            .abs().max()),
               bf16_codes_max_abs_diff_f32=ctx["bf16_s2a"][
                   "codes_max_abs_diff_f32"],
               audio_rows=srv._audio_gallery.n, build_s=build_s,
               audio_emb_per_s=srv._audio_gallery.n / build_s,
               f32_audio_emb_per_s=ctx["s2a"]["audio_emb_per_s"],
               bf16_audio_emb_per_s=ctx["bf16_s2a"]["audio_emb_per_s"],
               rank1=sum(r <= 1 for r in ranks),
               rank5=sum(r <= 5 for r in ranks), n=len(ranks),
               query_p50_ms=float(np.percentile(lat, 50) * 1000),
               f32_query_p50_ms=ctx["s2a"]["query_p50_ms"],
               bf16_query_p50_ms=ctx["bf16_s2a"]["query_p50_ms"],
               jax_cpu_rank1_default=JAX_S2A_RANK1, f32_rank1=ctx["s2a"][
                   "rank1"], bf16_rank1=ctx["bf16_s2a"]["rank1"])
    emit("default", check="b. default sheet -> audio", **s2a)
    # JAX's CPU default equals its highest bit for bit, so its count is 19
    assert s2a["rank1"] >= JAX_S2A_RANK1 - 1, s2a
    assert s2a["codes_max_abs_diff_f32"] > TF32_CODES_MIN_DIFF, s2a
    assert s2a["codes_max_abs_diff_f32"] < \
        s2a["bf16_codes_max_abs_diff_f32"], s2a

    # c. each block's conv against float64 in the three modes, and a
    # float32 forward after a default one bit-identical to one before it
    conv_rows = conv_errors(torch, ctx, {"highest": encoder.HIGHEST,
                                         "default": encoder.TF32,
                                         "bfloat16": encoder.BF16})
    flags_off("the conv errors")
    emit("default", check="c. conv error vs float64, three modes",
         worst={m: max(r[m] for r in conv_rows)
                for m in ("highest", "default", "bfloat16")},
         blocks=conv_rows)
    x1 = torch.from_numpy(np.stack([images[0][20:180, s:s + 200] for s in
                                    np.linspace(0, images[0].shape[1] - 200,
                                                20).astype(int)])[:, None]
                          ).to(dev)
    x2 = torch.from_numpy(np.ascontiguousarray(np.stack(
        [specs[0][:, s:s + 42] for s in np.linspace(
            0, specs[0].shape[1] - 42, 20).astype(int)])[:, None])).to(dev)
    before = engine.make_eval_fns(cfg)[0](params, x1, x2)
    engine.make_eval_fns(cfg_def)[0](params, x1, x2)
    flags_off("an eval forward")
    after = engine.make_eval_fns(cfg)[0](params, x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(before, after)), "TF32 leak"

    # d. one default step against the card's f32 step, float64 and the
    # CPU's bf16 step (phase 13d), then a fit over device pools
    tree = lasagne_import.train_params_to_numpy(cca_model.init_model(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    x1s, x2s = ctx["step_batch"]
    card = one_step(torch, cfg_def, tree, x1s, x2s, dev, torch.float32)
    flags_off("a default step")
    card32 = one_step(torch, cfg, tree, x1s, x2s, dev, torch.float32)
    f64 = one_step(torch, cfg, tree, x1s, x2s, dev, torch.float64)
    step = dict(loss_card=card["loss"], loss_f32=card32["loss"],
                loss_float64=f64["loss"],
                loss_rel_vs_f32=abs(card["loss"] - card32["loss"])
                / abs(card32["loss"]),
                grad_rel_l2_vs_float64=relative_l2(card["grads"],
                                                   f64["grads"]),
                f32_grad_rel_l2_vs_float64=relative_l2(card32["grads"],
                                                       f64["grads"]),
                cpu_bf16_grad_rel_l2_vs_float64=ctx["bf16_step"][
                    "grad_rel_l2_cpu_vs_float64"])
    emit("default", check="d. one default step vs f32, float64, bf16",
         batch=cfg.batch_size, **step)
    assert step["loss_rel_vs_f32"] <= TF32_STEP_LOSS_RTOL, step
    # the backward ran TF32 too: farther from float64 than float32, nearer
    # than bf16
    assert step["f32_grad_rel_l2_vs_float64"] < \
        step["grad_rel_l2_vs_float64"] < \
        step["cpu_bf16_grad_rel_l2_vs_float64"], step

    fit = learning_fit(torch, dict(ctx, cfg=cfg_def), dict(
        ctx["train_data"],
        train=dp.from_host_pool(ctx["train_data"]["train"],
                                rng=np.random.default_rng(23), device=dev),
        valid=dp.from_host_pool(ctx["train_data"]["valid"], shuffle=False,
                                rng=np.random.default_rng(24), device=dev)), (
        dp.DeviceBatchIterator(cfg.batch_size, k_samples=cfg.k_samples),
        dp.DeviceBatchIterator(cfg.batch_size, shuffle=False, train=False)),
        count, run_eval_args=["--conv_precision", "default"])
    assert {r["data"] for r in fit["epochs"]} == {"device pool"}
    flags_off("the default fit")
    x1d = torch.from_numpy(x1s).to(dev)
    x2d = torch.from_numpy(x2s).to(dev)
    state = ts.init_train_state(lasagne_import.train_params_from_numpy(
        tree, cfg_def, device=dev), cfg_def)
    train_step = engine.make_train_step(cfg_def)
    torch.cuda.reset_peak_memory_stats()
    numbers = dict(ctx["step_numbers"], default=dict(
        step_ms=cuda_ms(lambda: train_step(state, x1d, x2d), iters=20,
                        warmup=5),
        device_busy_ms_per_step=device_busy_ms(
            torch, lambda: train_step(state, x1d, x2d), 5),
        max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20))
    emit("default", check="d. default training", fit=fit,
         fit_epochs=fit_numbers(fit["epochs"]),
         f32_fit_epochs=fit_numbers(ctx["pool_fit"]["epochs"]), step=numbers)

    # e. OMR in float32 default on the tutorial page, under the JAX
    # package's bf16 gate against the float32 run
    prep = prepare_image(resize_page(imread_gray(
        assets.tutorial_sheet_path())))
    nets = {"float32": omr_nets(torch)}
    weights = {k: n.params for k, n in nets["float32"].items()}
    nets["default"] = omr_nets(torch, "float32", "default", weights)
    nets["bfloat16"] = omr_nets(torch, "bfloat16", "default", weights)
    assert all(n.net.tf32 for n in nets["default"].values())
    found = omr_detect(nets["float32"], prep)
    got = omr_detect(nets["default"], prep)
    flags_off("OMR")
    maps = {m: n["system"].predict_proba(prep) for m, n in nets.items()}
    ref64 = float64_system_codes(torch, weights["system"].to_numpy(), prep,
                                 nets["float32"]["system"])
    page_ms = {m: {k: cuda_ms(lambda: net.predict_proba(prep), iters=5,
                              warmup=1) for k, net in n.items()}
               for m, n in nets.items()}
    sys_dev = np.abs(got["systems"].astype(int)
                     - found["systems"].astype(int)).max() \
        if got["systems"].shape == found["systems"].shape else None
    bars_dev = np.abs(np.asarray(got["bars"], float)
                      - np.asarray(found["bars"], float)).max() \
        if np.shape(got["bars"]) == np.shape(found["bars"]) else None
    omr = dict(systems=len(got["systems"]), system_corner_dev_px=sys_dev,
               bars=len(got["bars"]), bars_f32=len(found["bars"]),
               bar_dev_px=bars_dev, notes=len(got["notes"]),
               notes_f32=len(found["notes"]),
               system_map_max_dev_f32=float(np.abs(
                   maps["default"] - maps["float32"]).max()),
               u16_share_off_float64={m: float((u16_codes(p) != ref64)
                                               .mean())
                                      for m, p in maps.items()},
               page_ms=page_ms)
    emit("default", check="e. OMR default vs f32 (JAX's bf16 gate)", **omr)
    assert sys_dev is not None and sys_dev <= OMR_BF16_PX, omr
    assert omr["bars"] == omr["bars_f32"], omr
    assert bars_dev is not None and bars_dev <= OMR_BF16_PX, omr
    assert abs(omr["notes"] - omr["notes_f32"]) <= \
        OMR_BF16_NOTES * omr["notes_f32"], omr
    assert omr["system_map_max_dev_f32"] > 1e-5, "the default arm ran f32"

    emit("default", check="done", launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    assert launches["topk_gallery"] > 0 and \
        launches["gather_feature_windows"] > 0, launches
    flags_off("phase 13e")
    return launches


# --- phase 14: alignment -----------------------------------------------------

# the shapes phase 14a holds the DTW kernels to their plain versions at:
# small, wide (so transposed), near-square, chip_smoke's corpus piece at the
# CLI's default steps (604 sheet x 860 spectrogram positions) and the
# 6,000 x 4,000 alignment the JAX package's docstring names
DTW_SHAPES = ((90, 70), (64, 128), (70, 65), (604, 860))
DTW_LARGE = (6000, 4000)
# the widest check: 65 CTAs at two columns a lane, chained through L2
DTW_GLOBAL = (16_500, 16_400)
ALIGN_PIECES = 12          # of the 60-piece corpus, through npz:
STUB_PIECES = ["StubPiece_A", "StubPiece_Ragged", "StubPiece_Audio44k",
               "StubPiece_D"]
STUB_COLLECTION = "/fake/collection"   # the msmd stub seeds pieces from it


def dtw_costs(shape, kind, seed):
    """Costs of ``kind``: random in [0, 1), rounded to quarters (ties),
    with a few NaN cells (NaN spreads down and right), or all zero (every
    comparison a tie)."""
    rng = np.random.default_rng(seed)
    d = rng.random(shape).astype(np.float32)
    if kind == "quarters":
        d = np.round(d * 4) / 4
    elif kind == "nan":
        d.flat[rng.integers(0, d.size, 4)] = np.nan
    elif kind == "ties":
        d[:] = 0
    return d


def same_bits(torch, a, b) -> bool:
    """Bit for bit, a NaN wherever the other has one (payloads not
    compared)."""
    na, nb = a.isnan(), b.isnan()
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0, a).view(torch.int32),
        torch.where(nb, 0, b).view(torch.int32)))


def same_cost(a, b) -> bool:
    return a == b or (a != a and b != b)


def check_dtw(torch, dist: np.ndarray) -> dict:
    """Both DTW kernels against their plain versions on the card, on the
    tall orientation ``dtw_by_dist`` runs (a wide matrix is transposed):
    the codes, the accumulated costs and the final cost bit-identical (NaN
    for NaN), with and without the costs asked for; the path identical to
    the plain walk over the codes and to the walk over the costs; the
    whole ``dtw_by_dist`` on the card equal to the CPU's (float32 path)."""
    from audio_sheet_retrieval_tpu_torch.ops import dtw

    tall = dist if dist.shape[0] >= dist.shape[1] else dist.T
    x = torch.from_numpy(np.ascontiguousarray(tall)).to("cuda")
    got = dtw.dtw_accumulate(x, return_acc=True)
    ref = dtw.dtw_accumulate_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got.codes, ref.codes), f"codes differ at {dist.shape}"
    assert same_bits(torch, got.acc, ref.acc), f"acc differs at {dist.shape}"
    assert same_bits(torch, got.cost, ref.cost), f"cost at {dist.shape}"
    lean = dtw.dtw_accumulate(x)
    assert lean.acc is None and torch.equal(lean.codes, ref.codes) and \
        same_bits(torch, lean.cost, ref.cost)
    path = dtw.dtw_traceback(lean.codes, lean.cost)
    want = dtw.walk_codes_plain(ref.codes, ref.cost)
    by_value = dtw.dtw_traceback_plain(ref.acc)
    for k in (0, 1):
        assert np.array_equal(path[k], want[k]) and \
            np.array_equal(by_value[k], want[k]), f"path at {dist.shape}"
    assert same_cost(path[2], want[2]) and \
        same_cost(path[2], float(ref.acc[-1, -1])), (path[2], want[2])
    if dist.size <= 10 ** 8:   # the whole float32 path, its matrix downloaded
        card = dtw.dtw_by_dist(dist, device="cuda")
        assert np.array_equal(card[2], ref.acc.cpu().numpy().astype(
            np.float64), equal_nan=True)
    if dist.size <= 10 ** 6:   # the CPU's plain loop, at the small shapes
        cpu = dtw.dtw_by_dist(dist, device="cpu")
        assert same_cost(card[0], cpu[0])
        assert np.array_equal(card[2], cpu[2], equal_nan=True)
        assert all(np.array_equal(a, b) for a, b in zip(card[3], cpu[3]))
    return dict(shape=list(dist.shape), path_len=len(path[0]),
                cost=path[2] if path[2] == path[2] else "nan",
                plan=list(dtw.acc_plan(tall.shape[1])), max_abs_err=0.0)


def dtw_latency_ns(torch, entry: str, steps: int = 100_000) -> float:
    """Nanoseconds a step of the one-thread probe ``entry`` of
    ``csrc/dtw.cu`` (its time at 11 x steps less its time at steps, over
    10 x steps: the launch cancels)."""
    from audio_sheet_retrieval_tpu_torch.ops import _native

    fn = getattr(_native.load("dtw"), entry)
    out = torch.empty(4, dtype=torch.int32, device="cuda")

    def run(n):
        return lambda: _native.check(fn(n, out.data_ptr(), torch.cuda
                                        .current_stream().cuda_stream), entry)
    return (cuda_ms(run(11 * steps), iters=5) - cuda_ms(run(steps), iters=5)
            ) * 1e6 / (10 * steps)


def dtw_bound(r: int, c: int, n_path: int, cell_ns: float, walk_ns: float):
    """The least time of a DTW of an [r, c] matrix (no accumulated costs
    asked), whatever the design: the larger of the bytes (the distances
    read once, a code a cell written once, the path's int32 pairs) at the
    card's memory rate and the dependency chain (r + c - 1 cells of one
    NaN-propagating min and one add, then n_path dependent walk steps)."""
    peaks = card_peaks()
    bytes_ms = (5 * r * c + 8 * n_path) / peaks["hbm_bytes_per_s"] * 1e3
    chain_ms = ((r + c - 1) * cell_ns + n_path * walk_ns) * 1e-6
    return (max(bytes_ms, chain_ms),
            "bytes" if bytes_ms >= chain_ms else "operations",
            bytes_ms, chain_ms)


def dtw_times(torch, dist: np.ndarray, plain_iters: int) -> dict:
    """Times of the DTW kernels on the tall orientation of ``dist``: event
    ms of a call (``ms``: the accumulation and the walk with its path
    download; each alone), each kernel queued back to back (its device
    time); the plain versions' on the card; the bound (``dtw_bound``, its
    two latencies from the probes) and the barrier floor of a design with
    one CTA-wide barrier a diagonal (the one this kernel replaced): the
    diagonals times one empty barrier round at that design's CTA width
    (``dtw_barrier_rounds``)."""
    from audio_sheet_retrieval_tpu_torch.ops import _native, dtw

    tall = dist if dist.shape[0] >= dist.shape[1] else dist.T
    r, c = tall.shape
    x = torch.from_numpy(np.ascontiguousarray(tall)).to("cuda")
    res = dtw.dtw_accumulate(x)
    n_path = len(dtw.dtw_traceback(res.codes, res.cost)[0])
    cell_ns = dtw_latency_ns(torch, "dtw_cell_probe")
    walk_ns = dtw_latency_ns(torch, "dtw_walk_probe")
    b_ms, b_by, bytes_ms, chain_ms = dtw_bound(r, c, n_path, cell_ns,
                                               walk_ns)
    lib = _native.load("dtw")
    barrier_threads = min(1024, -(-c // 32) * 32)
    scratch = torch.empty(barrier_threads, dtype=torch.int32, device="cuda")
    out = torch.empty(2 + 2 * (r + c - 1), dtype=torch.int32, device="cuda")
    n_diag = r + c - 1
    round_ms = cuda_ms(lambda: _native.check(lib.dtw_barrier_rounds(
        n_diag, barrier_threads, scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "barrier"),
        iters=10) / n_diag
    row = dict(
        ms=cuda_ms(lambda: dtw.dtw_traceback(*dtw.dtw_accumulate(x)[:2]),
                   iters=10),
        plain_ms=cuda_ms(lambda: dtw.walk_codes_plain(
            *dtw.dtw_accumulate_plain(x, return_acc=False)[:2]),
            iters=plain_iters, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        # no single PyTorch call computes DTW
        library_ms=None,
        bytes_ms=bytes_ms, chain_ms=chain_ms, cell_ns=cell_ns,
        walk_step_ns=walk_ns,
        barrier_floor_ms=round_ms * n_diag,
        barrier_round_ns=round_ms * 1e6,
        accumulate_ms=cuda_ms(lambda: dtw.dtw_accumulate(x), iters=10),
        accumulate_queued_ms=queued_ms(lambda: dtw.dtw_accumulate(x)),
        traceback_ms=cuda_ms(lambda: dtw.dtw_traceback(res.codes, res.cost),
                             iters=10),
        # the bare kernel, queued, without the wrapper's path download
        traceback_queued_ms=queued_ms(lambda: _native.check(
            lib.dtw_traceback(res.codes.data_ptr(), r, c,
                              res.codes.stride(0), res.cost.data_ptr(),
                              out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream),
            "dtw_traceback")),
        plan=list(dtw.acc_plan(c)))
    emit("timing", kernel="dtw", R=r, C=c, diagonals=n_diag,
         path_len=n_path, **row)
    return row


def pieces_npz(tmp, names, images, specs, o2cs):
    """Pieces as an ``npz:`` source and a split yaml whose test split they
    are."""
    import yaml

    for name, im, sp, oc in zip(names, images, specs, o2cs):
        np.savez(os.path.join(tmp, name + ".npz"), image=im, spec_0=sp,
                 o2c_0=oc)
    split = os.path.join(tmp, "split.yaml")
    with open(split, "w") as fp:
        yaml.safe_dump({"train": [], "valid": [], "test": list(names)}, fp)
    return split


def run_align(count, argv) -> dict:
    """``audio2sheet_align.main(argv)`` on the card, its launches counted,
    its report kept off the output -> {piece: pixel errors}, seconds."""
    import contextlib
    import io

    from audio_sheet_retrieval_tpu_torch.cli import audio2sheet_align

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        errors = count(lambda: audio2sheet_align.main(argv))
    seconds = time.perf_counter() - t0
    for piece, err in errors.items():
        assert np.isfinite(err).all() and len(err) > 0, piece
    return errors, seconds


def error_summary(errors: dict) -> dict:
    e = np.abs(np.concatenate(list(errors.values())))
    return dict(pieces=len(errors), onsets=int(e.size),
                mean_abs_px=float(e.mean()), median_abs_px=float(np.median(e)),
                max_abs_px=float(e.max()))


def align_cli(torch, ctx, count) -> dict:
    """14b-c. ``audio2sheet_align.main`` at full width on ``ctx["dev"]``:
    over 12 corpus pieces (npz:), the synthetic source and the msmd stub
    (``--data mutopia`` against ``npz:`` of its export) -> the numbers."""
    from audio_sheet_retrieval_tpu_torch import config
    from audio_sheet_retrieval_tpu_torch.cli import audio2sheet_align as a2s
    from audio_sheet_retrieval_tpu_torch.cli import export_msmd_npz
    from audio_sheet_retrieval_tpu_torch.ops import dtw
    from audio_sheet_retrieval_tpu_torch.retrieval import alignment

    dev, ckpt = str(ctx["dev"]), ctx["ckpt"]
    names = ["align_%02d" % i for i in range(ALIGN_PIECES)]
    seen = []
    orig = a2s.compute_alignment

    def record(*args, **kw):   # the codes and indices the CLI aligns
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        seen.append((args, out, time.perf_counter() - t0))
        return out

    npz = {}
    with tempfile.TemporaryDirectory() as tmp:
        split = pieces_npz(tmp, names, ctx["images"][:ALIGN_PIECES],
                           ctx["specs"][:ALIGN_PIECES],
                           [oc[0] for oc in ctx["o2cs"][:ALIGN_PIECES]])
        common = ["--data", "npz:" + tmp, "--train_split", split,
                  "--param_file", ckpt, "--device", dev]
        a2s.compute_alignment = record
        try:
            for align_by in ("pydtw", "baseline"):
                seen.clear()
                errors, seconds = run_align(count, common + [
                    "--align_by", align_by, "--dump_alignment"])
                npz[align_by] = dict(
                    error_summary(errors), seconds_per_piece=seconds
                    / len(errors), align_s_per_piece=float(np.mean(
                        [s for _, _, s in seen])))
                if align_by == "pydtw":
                    pydtw_seen = list(seen)
                dumped = config.derive_result_path(
                    ckpt, "alignment_res_", align_by + ".pkl")
                assert os.path.exists(dumped), dumped
                # kept for phase 16's reports
                shutil.move(dumped, os.path.join(
                    ctx["reports_dir"], os.path.basename(dumped)))
        finally:
            a2s.compute_alignment = orig
    # the DTW path from the card's own distances, card against CPU, and
    # the card's alignment against the CPU's from the same codes
    same_codes = 0
    for args, (_, res), _ in pydtw_seen:
        _, cpu = alignment.compute_alignment(*args[:5], device="cpu")
        same_codes += int(np.array_equal(cpu["aligned_sheet_idxs"],
                                         res["aligned_sheet_idxs"]))
        card = dtw.dtw_by_dist(res["dists"], return_acc=False, device=dev)
        host = dtw.dtw_by_dist(res["dists"], return_acc=False, device="cpu")
        assert card[0] == host[0] and all(
            np.array_equal(a, b) for a, b in zip(card[3], host[3]))
    emit("alignment", check="b. audio2sheet_align npz",
         model="mutopia_ccal_cont_rsz", checkpoint="synth_serving_ckpt.pkl",
         dist_shape=list(pydtw_seen[0][1][1]["dists"].shape),
         pieces=ALIGN_PIECES, card_path_equals_cpu_from_same_dists=True,
         card_alignment_equals_cpu_from_same_codes="%d of %d" % (
             same_codes, len(pydtw_seen)), **npz)
    assert same_codes == len(pydtw_seen), same_codes
    synth = {}
    for align_by in ("pydtw", "baseline"):
        errors, seconds = run_align(count, [
            "--data", "synthetic", "--n_test_pieces", "4", "--param_file",
            ckpt, "--align_by", align_by, "--device", dev])
        synth[align_by] = dict(error_summary(errors),
                               seconds_per_piece=seconds / len(errors))
    emit("alignment", check="b. audio2sheet_align synthetic", **synth)

    stub = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "msmd_stub")
    sys.path.insert(0, stub)
    root = config.DATA_ROOT_MSMD
    config.DATA_ROOT_MSMD = STUB_COLLECTION
    mutopia = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            import contextlib
            import io

            import yaml

            split = os.path.join(tmp, "split.yaml")
            with open(split, "w") as fp:
                yaml.safe_dump({"train": [], "valid": [],
                                "test": STUB_PIECES}, fp)
            out = os.path.join(tmp, "npz")
            with contextlib.redirect_stdout(io.StringIO()):
                n = export_msmd_npz.main(["--train_split", split,
                                          "--out_dir", out])
            assert n == len(STUB_PIECES), n
            for align_by in ("pydtw", "baseline"):
                base = ["--train_split", split, "--param_file", ckpt,
                        "--align_by", align_by, "--device", dev]
                mut, _ = run_align(count, ["--data", "mutopia"] + base)
                exported, _ = run_align(count, ["--data", "npz:" + out]
                                        + base)
                assert sorted(mut) == sorted(exported) == sorted(STUB_PIECES)
                for piece in STUB_PIECES:
                    assert np.array_equal(mut[piece], exported[piece]), piece
                mutopia[align_by] = error_summary(mut)
    finally:
        config.DATA_ROOT_MSMD = root
        sys.path.remove(stub)
        for mod in [m for m in sys.modules if m.split(".")[0] == "msmd"]:
            del sys.modules[mod]
    emit("alignment", check="c. audio2sheet_align --data mutopia (stub)",
         pieces=STUB_PIECES, equal_to_npz_export=True, **mutopia)
    return dict(npz=npz, synthetic=synth, mutopia=mutopia)


def phase_alignment(torch, ctx):
    """14. The DTW kernels against their plain versions at every listed
    shape and their times, then ``align_cli`` with its launches counted."""
    t0 = time.perf_counter()
    checked = []
    cases = [(shape, kind, i) for i, shape in enumerate(DTW_SHAPES)
             for kind in ("random", "quarters")]
    cases += [(DTW_SHAPES[-1], "nan", 5), (DTW_SHAPES[-1], "ties", 6),
              (DTW_LARGE, "random", 9), (DTW_LARGE, "nan", 11),
              (DTW_GLOBAL, "random", 10)]
    for shape, kind, seed in cases:
        checked.append(dict(check_dtw(torch, dtw_costs(shape, kind, seed)),
                            kind=kind))
    emit("alignment", check="a. kernels vs plain", bit_identical=True,
         cases=checked)
    times = dtw_times(torch, dtw_costs(DTW_SHAPES[-1], "random", 3), 5)
    large = dtw_times(torch, dtw_costs(DTW_LARGE, "random", 9), 2)

    launches = {name: 0 for name in read_launches()}
    align_cli(torch, ctx, launch_counter(launches))
    emit("alignment", check="launches", launches=launches,
         phase_seconds=time.perf_counter() - t0)
    # the 12 corpus pieces through pydtw: one accumulation and one
    # traceback a piece; then the synthetic and stub pieces
    assert launches["dtw_accumulate"] == launches["dtw_traceback"] == \
        ALIGN_PIECES + 4 + 2 * len(STUB_PIECES), launches
    ctx["dtw_stats"] = dict(times, max_abs_err=0.0,
                            large={"R": DTW_LARGE[0], "C": DTW_LARGE[1],
                                   **large})
    return launches


# --- phase 15: OMR -----------------------------------------------------------

OMR_GOLDEN = os.path.join("tests", "golden", "omr_tutorial_page.npz")
OMR_NOTE_SHAPE = (256, 512)
# 15b, the JAX package's own bf16 gate against its float32 arm
# (tests/test_omr.py::test_omr_precision_ladder_detection_equality_gate)
OMR_BF16_PX = 2
OMR_BF16_NOTES = 0.02
# 15a: the share of the system map's u16 codes that differ from a float64
# run of the same U-Net may be at most this many times the JAX package's
# own share (0.42 % of the page, its float32 on the CPU). Two float32
# orders of summation round about as many codes the other way: the port
# on the CPU 0.39 %, cuDNN on an H100 at 700 W 0.47 % (PERF.md), so a
# share of 1e-4 of the pixels off JAX's map is below what any float32
# order gives (the CPU port: 0.074 %; the card 0.11 %). A TF32 or bf16
# conv moves codes by far more than 1, which the 1-code gate catches.
OMR_F32_BAND = 1.5
TUTORIAL_DIST_ATOL = 1e-3
UMC_SR = 22050
OMR_DEVICE = "cuda"        # phase 15's device (a CPU rehearsal sets "cpu")


def omr_nets(torch, compute_dtype="float32", conv_precision="highest",
             params=None):
    """kind -> SegmentationNetwork on the card (the note net at its 256 x
    512 input), the given float32 weights or the vendored ones."""
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.models import unet
    from audio_sheet_retrieval_tpu_torch.omr.inference import (
        SegmentationNetwork,
    )

    nets = {}
    for kind in ("system", "bar", "note"):
        p = params[kind] if params else unet.load_unet_checkpoint(
            assets.omr_weights_path(kind), OMR_DEVICE)
        nets[kind] = SegmentationNetwork(
            p, OMR_NOTE_SHAPE if kind == "note" else (512, 512),
            compute_dtype=compute_dtype, conv_precision=conv_precision,
            device=OMR_DEVICE)
    return nets


def omr_detect(nets, prep) -> dict:
    from audio_sheet_retrieval_tpu_torch.omr.detectors import (
        OpticalMusicRecognizer,
    )

    omr = OpticalMusicRecognizer(system_detector=nets["system"],
                                 bar_detector=nets["bar"],
                                 note_detector=nets["note"])
    systems = omr.detect_systems(prep)
    return {"systems": systems,
            "bars": omr.detect_bars(prep, systems=systems),
            "bars_nosys": omr.detect_bars(prep),
            "notes": omr.detect_notes(prep)}


def u16_codes(proba: np.ndarray) -> np.ndarray:
    return np.round(proba.astype(np.float64) * 65535.0).astype(np.int64)


def float64_system_codes(torch, tree: dict, prep: np.ndarray, net):
    """The system map's u16 codes from a plain float64 run of the same
    U-Net (the JAX package's forward, written out here) and the same tile
    blend on the card: the reference both float32 maps are held to. The
    inputs are the float32 runs' own: the page's u16 codes times the
    float32 1 / 65535, the float32 window."""
    import torch.nn.functional as F

    dev = torch.device(OMR_DEVICE)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64, device=dev)

    def bn(h, b):
        return (h - t(b["mean"]).view(-1, 1, 1)) * t(
            b["inv_std"] * b["gamma"]).view(-1, 1, 1) + t(
            b["beta"]).view(-1, 1, 1)

    def conv_bn(h, b):
        return bn(F.conv2d(h, t(np.transpose(b["w"], (3, 2, 0, 1))),
                           padding=1), b)

    def forward(x):
        h, skips = x, []
        for i, b in enumerate(tree["enc"]):
            h = F.elu(conv_bn(h, b))
            if i % 2 == 1 and i < 7:
                skips.append(h)
                h = F.max_pool2d(h, 2, 2)
        for st, skip in zip(tree["dec"], reversed(skips)):
            h = F.relu(bn(F.conv_transpose2d(h, t(st["tconv_w"]), stride=2),
                          st["tconv_bn"]))
            h = bn(h + skip, st["sum_bn"])
            h = F.elu(conv_bn(F.elu(conv_bn(h, st["conv1"])), st["conv2"]))
        w = t(np.transpose(tree["head"]["w"], (3, 2, 0, 1)))
        return torch.sigmoid((F.conv2d(h, w) + t(tree["head"]["b"]).view(
            1, -1, 1, 1))[:, 0])

    h, w = prep.shape
    sh, sw = net.input_shape
    (top, bottom, left, right), origins = net.tile_origins(h, w)
    padded = np.pad(prep, ((top, bottom), (left, right)))
    page = t(np.round(np.clip(padded, 0, 1) * 65535.0).astype(np.float32)
             * np.float32(1.0 / 65535.0))
    ham = t(np.sqrt(np.outer(np.hamming(sh), np.hamming(sw))).astype(
        np.float32))
    R = torch.zeros_like(page)
    V = torch.zeros_like(page)
    with torch.no_grad():
        for r, c in origins:
            p = forward(page[None, None, r:r + sh, c:c + sw])[0]
            R[r:r + sh, c:c + sw] += p * ham
            V[r:r + sh, c:c + sw] += ham
    blended = (R / V)[top:top + h, left:left + w].clamp(0, 1)
    return torch.round(blended * 65535.0).to(torch.int64).cpu().numpy()


def unet_work(tree: dict, h: int, w: int):
    """(multiply-adds, activation bytes in float32) of one U-Net forward at
    [h, w]: each 3x3 / transposed / head conv's MACs from its weight's
    shape, and every stage output (conv-BN-ELU fused, pool, transposed
    conv, the skip sum) written once and read once."""
    macs, acts = 0, 0
    for i, b in enumerate(tree["enc"]):
        kh, kw, ci, co = b["w"].shape
        macs += h * w * kh * kw * ci * co
        acts += 2 * h * w * co
        if i % 2 == 1 and i < 7:
            h, w = h // 2, w // 2
            acts += 2 * h * w * co
    for st in tree["dec"]:
        ci, co, kh, kw = st["tconv_w"].shape
        macs += h * w * ci * co * kh * kw
        h, w = h * kh, w * kw
        acts += 2 * 2 * h * w * co                  # tconv-BN-ReLU, sum-BN
        for blk in (st["conv1"], st["conv2"]):
            kh, kw, ci, co = blk["w"].shape
            macs += h * w * kh * kw * ci * co
            acts += 2 * h * w * co
    kh, kw, ci, co = tree["head"]["w"].shape
    macs += h * w * kh * kw * ci * co
    return macs, 4 * (acts + h * w)


def kernel_kind(name: str) -> str:
    """A device activity's kind, by its kernel name (cuDNN / ATen)."""
    low = name.lower()
    if "dgrad" in low:
        return "transposed conv"
    if "pool" in low:
        return "pool"
    if any(k in low for k in ("fprop", "conv", "gemm", "winograd", "xmma",
                              "cutlass", "implicit")):
        return "conv"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout"
    if "elementwise" in low:
        return "elementwise"
    if low.startswith(("memcpy", "memset")):
        return "copy"
    return "other"


def omr_device_breakdown(torch, net, prep) -> dict:
    """One page through ``net`` under torch.profiler: device ms by kind
    (the U-Net's kernels, the blend's slice-adds among the elementwise
    ones), the blend and tile gather alone, and the top kernel names."""
    from torch.profiler import ProfilerActivity, profile

    def by_kind(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kinds, names = {}, {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = ev.time_range.elapsed_us() / 1000.0
            k = kernel_kind(ev.name)
            kinds[k] = kinds.get(k, 0.0) + ms
            names[ev.name[:80]] = names.get(ev.name[:80], 0.0) + ms
        top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
        return kinds, [{"name": n, "device_ms": v} for n, v in top]

    (top, bottom, left, right), origins = net.tile_origins(*prep.shape)
    sh, sw = net.input_shape
    tiles = torch.zeros((len(origins), 1, sh, sw), device=OMR_DEVICE)
    page_kinds, top_names = by_kind(lambda: net.predict_proba(prep))
    unet_kinds, _ = by_kind(lambda: net.net(tiles))
    total = sum(page_kinds.values())
    rest = total - sum(unet_kinds.values())
    return {"page_device_ms": total, "by_kind_ms": page_kinds,
            "unet_device_ms": sum(unet_kinds.values()),
            "unet_by_kind_ms": unet_kinds,
            "blend_and_wire_device_ms": rest,
            "blend_and_wire_share": rest / total, "top": top_names}


def write_wav(path: str, signal_i16: np.ndarray, sr: int = UMC_SR) -> None:
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(signal_i16, "<i2").tobytes())


def build_umc_dir(root: str, page: np.ndarray) -> str:
    """``tests/test_umc.py::umc_dataset``'s two pieces from ``page``: A the
    page, B the page with its top half white, an 8 s sine chord as each
    piece's score_ppq.wav and 01_performance.wav (the recipe of
    ``scripts/jax_omr_golden.py``, which made the golden ranks)."""
    from audio_sheet_retrieval_tpu_torch.utils.image_io import imwrite_gray

    page_b = page.copy()
    page_b[: page.shape[0] // 2] = 255
    t = np.arange(UMC_SR * 8) / UMC_SR
    for name, img, freqs in (("PieceA", page, (262.0, 330.0, 392.0)),
                             ("PieceB", page_b, (220.0, 277.0, 440.0))):
        os.makedirs(os.path.join(root, name, "sheet"))
        imwrite_gray(os.path.join(root, name, "sheet", "01.png"), img)
        sig = sum(0.2 * np.sin(2 * np.pi * f * t) for f in freqs)
        write_wav(os.path.join(root, name, "score_ppq.wav"),
                  (sig * 20000).astype(np.int16))
        write_wav(os.path.join(root, name, "01_performance.wav"),
                  (sig * 18000).astype(np.int16))
    return root


def quiet(fn):
    """``fn()`` with its standard output captured -> (result, text)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn()
    return res, out.getvalue()


def omr_device_geometry(torch, nets, page: np.ndarray, golden) -> dict:
    """15f. The system detector's geometry on the card
    (``omr/geometry.py``): the tutorial page through the device path (the
    page up raw, both maps left on the card, only the boxes down) gives
    the JAX package's systems (the golden's) as a u8 scan and as a float
    page, eagerly at a shape's first page and as CUDA graphs after, and
    so do its rows 0:420 between them (a second page height); each kernel
    of ``csrc/omr_geometry.cu`` equals its plain version (numpy / scipy,
    the same function on CPU tensors) bit for bit: the labels of the
    page's closed foreground and of seeded masks (blobs over and under
    50,000 px, touching the edges, speckle), the pairwise row sums and
    the 3-tap blurs of the page, the column means over every slot range
    (empty and reversed ones too), the Otsu thresholds of both maps; and
    the device geometry's time a page (CUDA events)."""
    from audio_sheet_retrieval_tpu_torch.omr import detectors, geometry
    from audio_sheet_retrieval_tpu_torch.omr.inference import (
        prepare_image,
        prepare_page_device,
    )

    omr = detectors.OpticalMusicRecognizer(system_detector=nets["system"],
                                           bar_detector=nets["bar"])
    crop = page[:420]
    runs = [(page, "full"), (page, "full"), (crop, "crop"), (page, "full"),
            (prepare_image(page), "full"), (prepare_image(page), "full"),
            (crop, "crop")]
    graphed = []
    for p, key in runs:
        found = omr.detect_systems(p)
        assert np.array_equal(found, golden[key + "_systems"]), \
            (key, p.dtype, found)
        stages = omr._stages[(p.shape, p.dtype == np.uint8)]
        graphed.append(stages.graphs is not None)
    # captured at a shape's second page; two shapes kept, so the crop's
    # stages were let go for the float page's
    assert graphed == [False, True, False, True, False, True, False], \
        graphed
    cuda = torch.device(OMR_DEVICE)
    image, x = prepare_page_device(torch.from_numpy(page).to(cuda))
    assert np.array_equal(image.cpu().numpy(), prepare_image(page))
    sys_p = nets["system"].predict_proba_device(x)
    bar_p = nets["bar"].predict_proba_device(x)
    checked, failed = {}, []

    def same(name, fn, *args):
        got = fn(*[a.to(cuda) if torch.is_tensor(a) else a for a in args])
        want = fn(*[a.cpu() if torch.is_tensor(a) else a for a in args])
        ok = all(np.array_equal(g.cpu().numpy(), w.numpy(), equal_nan=True)
                 for g, w in zip(*[(x,) if torch.is_tensor(x) else x
                                   for x in (got, want)]))
        checked[name] = checked.get(name, 0) + 1
        if not ok:
            failed.append(name)

    gen = np.random.default_rng(15)
    fg = geometry.close_rows(sys_p > geometry.otsu_threshold(sys_p).to(
        torch.float32))
    masks = [fg]
    for density in (0.05, 0.45, 0.6):
        masks.append(torch.from_numpy(gen.random(page.shape) < density))
    big = np.zeros(page.shape, bool)
    big[0:300, 0:400] = True             # over 50,000 px, at two edges
    big[500:560, 200:835] = True         # at the right edge
    big[700:720, 100:200] = True         # under 50,000 px
    big[900:1181, 600:835] = True        # the bottom right corner
    masks.append(torch.from_numpy(big))
    for m in masks:
        same("omr_label", geometry.label_components, m)
    img = 1.0 - image
    for arr in (bar_p, sys_p, img, geometry.box3(img, 1)):
        same("omr_row_sums", geometry.row_sums, arr)
    for axis in (0, 1):
        same("omr_box3", geometry.box3, img, axis)
    h = page.shape[0]
    r0 = torch.tensor([0, 116, 300, 500, 1000, 1180, 90], dtype=torch.int64)
    r1 = torch.tensor([h, 214, 300, 420, 1181, 1181, 1300],
                      dtype=torch.int64)
    same("omr_col_means", geometry.col_means, geometry.box3(img, 0), r0, r1)
    for arr in (sys_p, bar_p, geometry.row_sums(bar_p)):
        same("omr_otsu", geometry.otsu_threshold, arr)
    assert not failed, failed
    ms = cuda_ms(lambda: geometry.detect_systems(sys_p, bar_p, image),
                 iters=20, warmup=3)
    page_ms = cuda_ms(lambda: omr.detect_systems_device(page).cpu(),
                      iters=10, warmup=2)
    return {"systems": len(found), "equal_to_golden": len(runs),
            "kernel_checks": checked, "geometry_ms": ms,
            "page_to_boxes_ms": page_ms}


def phase_omr(torch, ctx):
    """15. OMR on the card: the three vendored U-Nets on the tutorial page
    against the JAX package's golden (f32 highest and high, bf16 under
    JAX's bf16 gate), the tutorial, the UMC command lines and
    ``prepare_umc_data``, then page times beside their bounds."""
    import ctypes

    import yaml

    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.cli import (
        prepare_umc_data,
        tutorial,
        umc_a2s_server,
        umc_s2a_server,
    )
    from audio_sheet_retrieval_tpu_torch.omr.inference import prepare_image
    from audio_sheet_retrieval_tpu_torch.utils.image_io import (
        imread_gray,
        imwrite_gray,
        resize_linear_u8,
    )

    t_phase = time.perf_counter()
    launches = {name: 0 for name in read_launches()}
    count = launch_counter(launches)
    with np.load(OMR_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    page = tutorial.resize_page(imread_gray(assets.tutorial_sheet_path()))
    prep = prepare_image(page)

    # a. f32 highest: detections equal to JAX's; the system map's codes
    nets = omr_nets(torch)
    found = omr_detect(nets, prep)
    for key in ("systems", "bars", "bars_nosys", "notes"):
        np.testing.assert_array_equal(found[key], golden["full_" + key],
                                      err_msg="15a " + key)
    codes = u16_codes(nets["system"].predict_proba(prep))
    want = golden["full_system_codes"].astype(np.int64)
    ref64 = float64_system_codes(torch, nets["system"].params.to_numpy(),
                                 prep, nets["system"])
    diff = np.abs(codes - want)
    share = {"card_vs_jax": float((diff > 0).mean()),
             "card_vs_float64": float((codes != ref64).mean()),
             "jax_vs_float64": float((want != ref64).mean())}
    high = omr_nets(torch, "float32", "high",
                    {k: n.params for k, n in nets.items()})
    codes_high = u16_codes(high["system"].predict_proba(prep))
    emit("omr", check="a. f32 highest vs the JAX golden", systems=len(
        found["systems"]), bars=len(found["bars"]),
        notes=len(found["notes"]), detections_equal=True,
        max_code_diff=int(diff.max()), codes_differing=int((diff > 0).sum()),
        pixels=int(diff.size), share=share,
        max_code_diff_float64=int(np.abs(codes - ref64).max()),
        high_identical=bool(np.array_equal(codes_high, codes)))
    assert len(found["systems"]) == 6
    assert diff.max() <= 1, diff.max()
    # a float32 map may round a code the other way wherever float32 lands
    # within its rounding of a half-code: held to the float32 band of the
    # JAX package's own map (see OMR_F32_BAND)
    assert share["card_vs_float64"] <= \
        OMR_F32_BAND * share["jax_vs_float64"], share
    assert np.array_equal(codes_high, codes), "high differs from highest"

    # b. bf16 against the f32 run, JAX's bf16 gate
    bf16 = omr_nets(torch, "bfloat16", "default",
                    {k: n.params for k, n in nets.items()})
    got = omr_detect(bf16, prep)
    sys_dev = np.abs(got["systems"].astype(int)
                     - found["systems"].astype(int)).max() \
        if got["systems"].shape == found["systems"].shape else None
    bars_dev = np.abs(np.asarray(got["bars"], float)
                      - np.asarray(found["bars"], float)).max() \
        if np.shape(got["bars"]) == np.shape(found["bars"]) else None
    p32 = nets["system"].predict_proba(prep)
    p16 = bf16["system"].predict_proba(prep)
    emit("omr", check="b. bf16 vs f32 (JAX's bf16 gate)",
         systems=len(got["systems"]), system_corner_dev_px=sys_dev,
         bars=len(got["bars"]), bar_dev_px=bars_dev,
         notes=len(got["notes"]), notes_f32=len(found["notes"]),
         system_map_max_dev=float(np.abs(p16 - p32).max()),
         system_map_flip_share=float(
             np.logical_xor(p16 > 0.5, p32 > 0.5).mean()))
    assert sys_dev is not None and sys_dev <= OMR_BF16_PX, sys_dev
    assert len(got["bars"]) == len(found["bars"])
    assert bars_dev is not None and bars_dev <= OMR_BF16_PX, bars_dev
    assert abs(len(got["notes"]) - len(found["notes"])) <= \
        OMR_BF16_NOTES * len(found["notes"])
    assert np.abs(p16 - p32).max() > 1e-4, "the bf16 arm ran float32"

    with tempfile.TemporaryDirectory() as tmp:
        # c. the tutorial, synthesized audio (and the mp3 where it decodes)
        dists_path = os.path.join(tmp, "dists.npy")
        t0 = time.perf_counter()
        dists, said = quiet(lambda: count(lambda: tutorial.main(
            ["--synth_audio", "--save_dists", dists_path, "--device",
             OMR_DEVICE])))
        tut_s = time.perf_counter() - t0
        n_sys = [ln for ln in said.splitlines()
                 if ln.startswith("detected systems:")]
        dist_err = float(np.abs(dists - golden["full_tutorial_dists"]).max())
        try:
            ctypes.CDLL("libmpg123.so.0")
            mp3 = True
        except OSError:
            mp3 = False
        print("15c audio:", "synthesized and the tutorial mp3" if mp3
              else "synthesized only (libmpg123.so.0 does not load)",
              flush=True)
        mp3_stats = None
        if mp3:
            mp3_dists, mp3_said = quiet(lambda: count(
                lambda: tutorial.main(["--device", OMR_DEVICE])))
            mp3_stats = {"shape": list(mp3_dists.shape),
                         "finite": bool(np.isfinite(mp3_dists).all()),
                         "systems": [ln for ln in mp3_said.splitlines()
                                     if ln.startswith("detected")]}
            assert mp3_stats["finite"], mp3_stats
        emit("omr", check="c. tutorial", systems_line=n_sys,
             max_dist_err=dist_err, seconds=tut_s, mp3=mp3_stats)
        assert n_sys == ["detected systems: 6"], n_sys
        assert dists.shape == (100, 100) and dist_err <= \
            TUTORIAL_DIST_ATOL, dist_err

        # d. the UMC command lines over the two-piece directory
        data = build_umc_dir(os.path.join(tmp, "umc"), page)
        ckpt = assets.tutorial_checkpoint_path()
        dset = ctx["umc_dset"] = os.path.basename(data)
        runs = {}
        cwd = os.getcwd()
        os.chdir(tmp)    # the vendored checkpoint's yaml dumps go to cwd
        try:
            for key, cli, extra in (
                    ("a2s_host", umc_a2s_server, ["--init_sheet_db"]),
                    ("a2s_device", umc_a2s_server,
                     ["--init_sheet_db", "--device_db"]),
                    ("s2a", umc_s2a_server,
                     ["--init_audio_db", "--device_db"])):
                t0 = time.perf_counter()
                ranks, _ = quiet(lambda: count(lambda: cli.main(
                    ["--data_dir", data, "--param_file", ckpt,
                     "--db_file", os.path.join(tmp, key + ".pkl"),
                     "--full_eval", "--dump_results", "--device",
                     OMR_DEVICE] + extra)))
                secs = time.perf_counter() - t0
                suffix = "S2A" if key == "s2a" else "A2S"
                dumped = os.path.join(
                    tmp, "umc_retrieval_tutorial_checkpoint_%s_%s.yaml"
                    % (dset, suffix))
                with open(dumped) as fp:
                    read_back = yaml.safe_load(fp)
                # kept for phase 16's reports
                shutil.move(dumped, os.path.join(ctx["reports_dir"],
                                                 os.path.basename(dumped)))
                runs[key] = {"ranks": [int(r) for r in ranks],
                             "seconds_a_piece": secs / 2,
                             "yaml_read_back": read_back}
        finally:
            os.chdir(cwd)
        for key, run in runs.items():
            run["jax_ranks"] = [int(r) for r in golden[f"full_{key}_ranks"]]
        # prepare_umc_data on a copy at width 1200
        wide_dir = os.path.join(tmp, "wide")
        shutil.copytree(data, wide_dir)
        wide = resize_linear_u8(page, (1200, int(1200 / 835 * page.shape[0])))
        for piece in ("PieceA", "PieceB"):
            imwrite_gray(os.path.join(wide_dir, piece, "sheet", "01.png"),
                         wide)
        n_resized, _ = quiet(lambda: prepare_umc_data.main(
            ["--data_dir", wide_dir]))
        want_page = resize_linear_u8(wide, (835, int(835 / 1200
                                                     * wide.shape[0])))
        prepared = [np.array_equal(imread_gray(os.path.join(
            wide_dir, p, "sheet", "01.png")), want_page)
            for p in ("PieceA", "PieceB")]
        emit("omr", check="d. UMC command lines", runs=runs,
             prepare_umc_data_resized=n_resized,
             prepare_umc_data_pages_equal=prepared)
        for key, run in runs.items():
            assert run["ranks"] == run["jax_ranks"], (key, run)
            assert run["yaml_read_back"] == run["ranks"], (key, run)
        assert n_resized == 2 and all(prepared), (n_resized, prepared)
    assert launches["topk_gallery"] > 0, "the UMC servers ran no top-k"
    # the tutorial's and the UMC servers' systems take the device path,
    # which codes nothing on the host (phase 18 holds the OMR wires)
    assert launches["rans_decode"] == 0 and launches["rans_encode"] == 0, \
        "phase 15 coded a page or map on the host"

    # f. the system geometry on the card, and its kernels
    geo = omr_device_geometry(torch, nets, page, golden)
    emit("omr", check="f. device geometry", **geo)

    # e. times on the card, at 15 tiles a page
    tree = nets["system"].params.to_numpy()
    n_tiles = len(nets["system"].tile_origins(*prep.shape)[1])
    macs, act_bytes = unet_work(tree, *nets["system"].input_shape)
    flops = 2.0 * macs * n_tiles
    times = {}
    for arm, arm_nets in (("float32", nets), ("bfloat16", bf16)):
        per_net = {}
        for kind, net in arm_nets.items():
            ms = cuda_ms(lambda: net.predict_proba(prep), iters=10,
                         warmup=2)
            tiles = len(net.tile_origins(*prep.shape)[1])
            per_net[kind] = {"page_ms": ms, "tiles": tiles,
                             "tiles_per_s": tiles / ms * 1e3}
        torch.cuda.reset_peak_memory_stats()
        arm_nets["system"].predict_proba(prep)
        torch.cuda.synchronize()
        times[arm] = {
            "per_net": per_net,
            "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "system_net_device": omr_device_breakdown(
                torch, arm_nets["system"], prep)}
    # the page in and the map out once (the function's own bytes) against
    # its multiply-adds; the activations' traffic beside it
    bound_ms, bound_by = bound(n_tiles * 2 * 512 * 512 * 4, flops)
    emit("omr", check="e. page times", times=times,
         bound={"flops_a_page": flops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "bf16_ops_ms": flops / card_peaks()["bf16_flops"] * 1e3,
                "activation_bytes_a_page": act_bytes * n_tiles,
                "activation_ms_at_3.35TB/s": act_bytes * n_tiles
                / card_peaks()["hbm_bytes_per_s"] * 1e3},
         launches=launches, phase_seconds=time.perf_counter() - t_phase)
    return launches


# --- phase 16: reports, roofline, profiling; data-parallel training -------

REPORT_TAG = "all_split_mutopia_no_aug"   # <split>_<aug> of the dumps' names
# the two-rank step's gradients against a float64 step on the
# concatenated batch: every element within this share of the largest. The
# one-rank float32 step is itself 2.3e-3 from float64 on this batch (an
# H100 at 700 W; phase 11 reads the same), so against it the two ranks are
# held to phase 11's float32 gate, STEP_GRAD_TOL
MESH_GRAD_TOL = 2e-3
MESH_TIMEOUT = 600     # seconds a group of rank processes may take
RANK_DEVICE = "cuda:0"  # the rank processes' card (a CPU rehearsal: "cpu")


def reports_rows(argv) -> list:
    """``reports.main(argv)``'s rows, its printing kept out of the log."""
    import contextlib
    import io

    from audio_sheet_retrieval_tpu_torch.cli import reports

    with contextlib.redirect_stdout(io.StringIO()):
        return reports.main(argv)


def rank_cells(ranks) -> list:
    """The piece tables' cells of a rank list: rank <= 1, 5, 10, > 10."""
    r = np.sort(np.asarray(ranks))
    cnt = [float(np.sum(r <= t)) for t in (1, 5, 10)] + [float(np.sum(r > 10))]
    return ["%d (%.2f)" % (c, c / len(r)) for c in cnt]


def check_reports(ctx) -> dict:
    """16a. Each ``reports`` subcommand over the dumps of phases 6, 10, 11,
    14 and 15d: its rows hold the dumps' own numbers -> the rows."""
    import glob
    import pickle

    import yaml

    out = ctx["reports_dir"]

    def dump(name):
        with open(os.path.join(out, name)) as fp:
            return yaml.safe_load(fp)

    rows = {}
    # snippet retrieval (phase 10's run_eval, both directions)
    got = [r for r in reports_rows(["retrieval", "--out_path", out])
           if r.startswith("none ")]
    for direction, row in zip(("A2S", "S2A"), got):
        res = dump(f"eval_{REPORT_TAG}_{direction}.yaml")
        want = ["%.2f" % (res["recall_at_k"]["1"] / 100),
                "%.2f" % (res["recall_at_k"]["25"] / 100),
                "%.2f" % res["map"], "%d" % res["med_rank"]]
        assert row.removesuffix(" \\\\").split(" & ")[-4:] == want, (row,
                                                                     want)
    rows["retrieval"] = got
    # piece identification (phase 6's server CLIs)
    got = [r for r in reports_rows(["piece-retrieval", "--out_path", out])
           if r.startswith("all_split & ")]
    want = [c for d in ("A2S", "S2A")
            for c in rank_cells(dump(f"retrieval_{REPORT_TAG}_{d}.yaml"))]
    assert got[0].removesuffix(" \\\\").split(" & ")[-8:] == want, (got, want)
    rows["piece-retrieval"] = got[:1]
    # the share of training data (phase 10's A2S file is the 100 % row)
    res = dump(f"eval_{REPORT_TAG}_A2S.yaml")
    got = reports_rows(["dset-size", "--out_path", out])
    assert got == ["100%% train data: MRR %.3f med-rank %d"
                   % (res["map"], res["med_rank"])], got
    rows["dset-size"] = got
    # UMC piece identification (phase 15d)
    dset = ctx["umc_dset"]
    got = reports_rows(["umc-piece-retrieval", "--out_path", out,
                        "--dset", dset])
    want = []
    for d in ("A2S", "S2A"):
        (f,) = glob.glob(os.path.join(out, f"umc_retrieval_*_{dset}_{d}"
                                      ".yaml"))
        want.append("%s %s & %s \\\\" % (
            dset, d, " & ".join(rank_cells(dump(os.path.basename(f))))))
    assert got == want, (got, want)
    rows["umc-piece-retrieval"] = got
    # alignment errors (phase 14, both aligners)
    files = sorted(glob.glob(os.path.join(out, "alignment_res_*.pkl")))
    assert len(files) == 2, files
    got = reports_rows(["alignment"] + files)
    for f, row in zip(files, got):
        with open(f, "rb") as fp:
            e = np.concatenate([np.abs(np.asarray(v))
                                for v in pickle.load(fp).values()])
        assert row == "%s: mean %.1f median %.1f p90 %.1f (<=25px: %.1f%%)" \
            % (os.path.basename(f), e.mean(), np.median(e),
               np.percentile(e, 90), 100.0 * np.mean(e <= 25)), row
    rows["alignment"] = got
    # phase 11's curves
    log = os.path.join(out, "results.pkl")
    with open(log, "rb") as fp:
        curves = pickle.load(fp)
    got = reports_rows(["curves", log])
    assert got["map_val"] == curves["map_val"] and \
        got["pred_tr_err"] == curves["pred_tr_err"], got
    rows["curves"] = {"epochs": len(curves["map_val"]),
                      "best_map_va": max(curves["map_val"])}
    return rows


def roofline_numbers(ctx) -> dict:
    """16a. Model FLOPs (``utils.roofline``) and the achieved rate and MFU
    of phase 4's float32 build, phase 13a's bf16 build and phase 11's
    step against the card's data-sheet peaks."""
    import torch

    from audio_sheet_retrieval_tpu_torch.utils import roofline

    name = torch.cuda.get_device_name(0)
    flops = roofline.summarize(ctx["cfg"], name)
    assert flops["chip"] is not None, name
    sheet, update = flops["flops_per_sheet_embed"], flops["flops_per_update"]
    runs = {"phase 4 float32 build": (
                sheet * ctx["serving"]["exact"]["emb_per_s"], "float32"),
            "phase 13a bf16 build": (
                sheet * ctx["bf16_builds"]["exact"]["sheet_emb_per_s"],
                "bfloat16"),
            "phase 11 float32 step": (
                update / (ctx["f32_step"]["step_ms"] / 1e3), "float32")}
    return dict(model_flops=flops, peaks=card_peaks(), rates={
        k: dict(tflop_per_s=r / 1e12, compute_dtype=dt,
                peak_tflop_per_s=roofline.effective_peak_flops(
                    name, dt, "highest") / 1e12,
                mfu=roofline.mfu(r, name, dt, "highest"))
        for k, (r, dt) in runs.items()})


LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
QUERY_STAGES = {"upload", "decode", "windows", "encoder", "topk", "vote"}


def traced_query(ctx) -> dict:
    """16a. One fused audio -> sheet query (``detect_score_from_spec``, the
    u16 wire) inside ``utils.profiling.trace``: its trace holds kernels,
    and its ``spans.json`` one ``query`` root over the stages. Every
    kernel launch of the trace that lies between the root's start and end
    is one the root's span covers, and none lies before the root's start:
    the spans share the device trace's clock."""
    from audio_sheet_retrieval_tpu_torch.utils import profiling

    srv = with_sheet_gallery(make_server(ctx), ctx)
    kw = dict(top_k=5, n_candidates=25)
    srv.detect_score_from_spec(ctx["specs"][0], **kw)    # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as path:
            top = srv.detect_score_from_spec(ctx["specs"][0], **kw)
        size = os.path.getsize(path)
        with open(path) as fp:
            events = json.load(fp)["traceEvents"]
        with open(os.path.join(tmp, "spans.json")) as fp:
            spans = json.load(fp)
    kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    assert size > 0 and kernels > 0, (size, kernels)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["query"], roots
    root = roots[0]
    assert {s["name"] for s in spans if s["parent"] is not None} \
        == QUERY_STAGES, spans
    t0, t1 = root["ts_us"], root["ts_us"] + root["dur_us"]
    launches = sorted(float(ev["ts"]) for ev in events
                      if ev.get("ph") == "X" and ev.get("name") in LAUNCHES)
    inside = [t for t in launches if t0 <= t <= t1]
    assert inside and len(inside) == sum(t <= t1 for t in launches), (
        t0, t1, launches[:5])
    mem = profiling.device_memory_stats()["cuda:0"]
    assert mem["allocated_bytes.all.peak"] > 0
    return dict(trace_bytes=size, device_kernels_traced=kernels,
                top1=str(top[0][0]), spans=len(spans),
                query_span_ms=root["dur_us"] / 1e3,
                launches_in_query=len(inside),
                launches_after_query=len(launches) - len(inside),
                peak_allocated_mb=mem["allocated_bytes.all.peak"] / 2**20)


def mesh_step(torch, cfg, tree, x1, x2, mesh) -> dict:
    """``one_step`` on this rank's slice of the batch: the loss of the
    global batch, the gradients summed over the ranks, the new running
    state."""
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import
    from audio_sheet_retrieval_tpu_torch.train import engine

    p = lasagne_import.train_params_from_numpy(tree, cfg, device=mesh.device)
    loss, new, corr = engine.train_loss(
        p, torch.from_numpy(mesh.shard(x1)).to(mesh.device),
        torch.from_numpy(mesh.shard(x2)).to(mesh.device), cfg, mesh)
    loss.backward()
    mesh.all_reduce_grads(p.parameters())
    return dict(loss=loss.item(), corr=corr.detach().cpu().numpy(),
                grads=[q.grad.cpu().numpy() for q in p.parameters()],
                bn=[t.cpu().numpy() for st in new.bn1 + new.bn2 for t in st],
                cca=[t.cpu().numpy() for t in new.cca])


def mesh_pieces(n_train, n_valid, n_onsets, seed):
    from audio_sheet_retrieval_tpu_torch.data import synthetic

    return (synthetic.make_piece_list(seed, n_train, n_onsets=n_onsets),
            synthetic.make_piece_list(seed + 1, n_valid, n_onsets=n_onsets))


def mesh_data(mesh, dev, pieces, augment, seed, k_samples, batch,
              sharded=True):
    """Train and valid pools and iterators on ``mesh`` (or none) on
    ``dev``: the train pool a ShardedDevicePool (or a replicated
    DevicePool), the valid pool a replicated DevicePool, as ``fit``'s
    docstring advises."""
    from audio_sheet_retrieval_tpu_torch.data import device_pool as dp
    from audio_sheet_retrieval_tpu_torch.data.pools import NO_AUGMENT
    from audio_sheet_retrieval_tpu_torch.parallel import sharded_pool as sp

    tr, va = pieces
    if sharded:
        train = sp.ShardedDevicePool(*tr, mesh=mesh, data_augmentation=augment,
                                     rng=np.random.default_rng(seed))
        tr_it = sp.ShardedBatchIterator(batch, k_samples=k_samples)
    else:
        train = dp.DevicePool(*tr, data_augmentation=augment,
                              rng=np.random.default_rng(seed), mesh=mesh,
                              device=dev)
        tr_it = dp.DeviceBatchIterator(batch, k_samples=k_samples)
    valid = dp.DevicePool(*va, data_augmentation=NO_AUGMENT, shuffle=False,
                          rng=np.random.default_rng(seed + 1), mesh=mesh,
                          device=dev)
    return ({"train": train, "valid": valid}, tr_it,
            dp.DeviceBatchIterator(batch, shuffle=False, train=False))


def mesh_fit(torch, cfg, mesh, dev, data_and_iters, epochs, out,
             resume=None, init_seed=5):
    """``fit`` from the ``init_seed`` init -> its epoch records as float
    hex (train and valid loss, valid and train MRR), and the record."""
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.train import engine

    data, tr_it, va_it = data_and_iters()
    recs = []
    engine.fit(cca_model.init_model(torch.Generator().manual_seed(init_seed),
                                    cfg, device="cpu"),
               data, cfg, tr_it, va_it, device=dev, out_path=out, num_epochs=epochs, verbose=False,
               on_epoch=recs.append, resume_file=resume, mesh=mesh)
    return [[float(r[k]).hex() for k in ("train_loss", "valid_loss",
                                         "map_va", "map_tr")]
            for r in recs], recs


def rank_gloo(torch, mesh, work) -> dict:
    """16b, on one of two ranks sharing card 0 over gloo: the step on this
    rank's half of phase 11's batch; then, under deterministic cuDNN, a
    3-epoch fit over a ShardedDevicePool of phase 11's corpus and a fit
    stopped after epoch 2 and resumed against the uninterrupted one.
    ``scripts/torch_fit_seeds.py`` holds this fit to the learning criteria
    over several seeds."""
    import pickle

    from audio_sheet_retrieval_tpu_torch import config
    from audio_sheet_retrieval_tpu_torch.train import engine
    from audio_sheet_retrieval_tpu_torch.train import state as ts
    from audio_sheet_retrieval_tpu_torch.models import lasagne_import

    with open(os.path.join(work, "step.pkl"), "rb") as fp:
        cfg, tree, x1, x2 = pickle.load(fp)
    res = {}
    with open(os.path.join(work, f"step_{mesh.rank}.pkl"), "wb") as fp:
        pickle.dump(mesh_step(torch, cfg, tree, x1, x2, mesh), fp)
    state = ts.init_train_state(lasagne_import.train_params_from_numpy(
        tree, cfg, device=mesh.device), cfg)
    train_step = engine.make_train_step(cfg, mesh)
    t1 = torch.from_numpy(mesh.shard(x1)).to(mesh.device)
    t2 = torch.from_numpy(mesh.shard(x2)).to(mesh.device)
    torch.cuda.reset_peak_memory_stats()
    res["step_ms"] = cuda_ms(lambda: train_step(state, t1, t2), iters=20,
                             warmup=5)
    res["step_max_memory_allocated_mb"] = \
        torch.cuda.max_memory_allocated() / 2**20

    with deterministic(torch):
        augment = config.load_experiment_config("mutopia_full_aug").augment
        pieces = mesh_pieces(TRAIN_PIECES["n_train"],
                             TRAIN_PIECES["n_valid"],
                             TRAIN_PIECES["n_onsets"], 23)
        fit_cfg = dataclasses.replace(cfg, max_epochs=TRAIN_EPOCHS)
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dev = mesh.device
        hexes, recs = mesh_fit(
            torch, fit_cfg, mesh, dev, lambda: mesh_data(
                mesh, dev, pieces, augment, 23, cfg.k_samples,
                cfg.batch_size), TRAIN_EPOCHS, os.path.join(work, "fit"))
        res["fit"] = dict(
            seconds=time.perf_counter() - t0, epochs_hex=hexes,
            epochs=[dict(number=r["number"], train_loss=r["train_loss"],
                         map_va=r["map_va"], map_tr=r["map_tr"],
                         updates_per_s=r["updates_per_s"],
                         eval_s=r["eval_seconds"]) for r in recs],
            max_memory_allocated_mb=torch.cuda.max_memory_allocated()
            / 2**20, launches=read_launches())

        res_cfg = dataclasses.replace(cfg, k_samples=2 * cfg.batch_size,
                                      patience=50)
        small = mesh_pieces(RESUME_PIECES["n_train"],
                            RESUME_PIECES["n_valid"],
                            RESUME_PIECES["n_onsets"], 5)

        def small_data():
            return mesh_data(mesh, dev, small, augment, 5,
                             res_cfg.k_samples, cfg.batch_size)

        zero_launches()
        snap = os.path.join(work, "fit_state.pkl")
        full = mesh_fit(torch, res_cfg, mesh, dev, small_data, 4,
                        os.path.join(work, "full"))[0]
        first = mesh_fit(torch, res_cfg, mesh, dev, small_data, 2,
                         os.path.join(work, "part"), snap)[0]
        second = mesh_fit(torch, res_cfg, mesh, dev, small_data, 4,
                          os.path.join(work, "part"), snap)[0]
        res["resume"] = dict(full=full, first=first, second=second,
                             launches=read_launches())
        assert first == full[:2] and second == full[2:], res["resume"]
    return res


def rank_nccl(torch, mesh, work) -> dict:
    """16c, a one-rank NCCL group: one epoch of the fit over replicated
    device pools with the mesh and without, deterministic cuDNN; the epoch
    cut to 20 steps (bit-identity needs no more)."""
    from audio_sheet_retrieval_tpu_torch import config
    from audio_sheet_retrieval_tpu_torch.models.configs import get_model_config

    cfg = get_model_config("mutopia_ccal_cont_rsz")
    cfg = dataclasses.replace(cfg, k_samples=20 * cfg.batch_size)
    augment = config.load_experiment_config("mutopia_full_aug").augment
    pieces = mesh_pieces(TRAIN_PIECES["n_train"], TRAIN_PIECES["n_valid"],
                         TRAIN_PIECES["n_onsets"], 23)
    zero_launches()
    runs = {}
    with deterministic(torch):
        for name, m in (("mesh", mesh), ("none", None)):
            runs[name] = mesh_fit(
                torch, cfg, m, mesh.device, lambda: mesh_data(
                    m, mesh.device, pieces, augment, 23, cfg.k_samples,
                    cfg.batch_size, sharded=False), 1,
                os.path.join(work, name))[0]
    assert runs["mesh"] == runs["none"], runs
    return dict(epochs_hex=runs, launches=read_launches())


def mesh_rank_main(argv) -> int:
    """A rank process of phases 16-17 (``chip_smoke.py --mesh-rank RANK
    WORLD INIT_METHOD BACKEND SCENARIO WORKDIR``): joins the group on card
    0, runs its scenario, prints its result as the last line."""
    import torch
    import torch.distributed as dist

    from audio_sheet_retrieval_tpu_torch.models import encoder
    from audio_sheet_retrieval_tpu_torch.parallel import mesh as pm

    rank, world, init, backend, scenario, work = argv
    encoder.pin_full_f32()
    mesh = pm.make_mesh(backend, device=RANK_DEVICE, init_method=init,
                        rank=int(rank), world_size=int(world))
    try:
        res = RANK_SCENARIOS[scenario](torch, mesh, work)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"rank": mesh.rank, "result": res}, default=_plain))
    return 0


def spawn_ranks(world: int, backend: str, scenario: str, work: str) -> list:
    """Start ``world`` rank processes of this script on card 0 running
    ``scenario`` and wait for them (``parallel.dryrun.spawn_ranks``: a log
    file a rank, one deadline; a rendezvous file in ``work``) -> each
    rank's result."""
    from audio_sheet_retrieval_tpu_torch.parallel import dryrun

    init = dryrun.rendezvous(work)
    outs = dryrun.spawn_ranks(
        lambda r: [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                   str(r), str(world), init, backend, scenario, work],
        world, work, f"{scenario}_{backend}", MESH_TIMEOUT)
    return [json.loads(out.strip().splitlines()[-1])["result"]
            for out in outs]


def phase_reports(torch, ctx):
    """16a. ``reports`` on the earlier phases' dumps, the roofline and a
    traced query."""
    rows = check_reports(ctx)
    emit("reports", check="a. reports on the dumps", rows=rows)
    emit("reports", check="a. roofline", **roofline_numbers(ctx))
    zero_launches()
    emit("reports", check="a. traced query", **traced_query(ctx))
    launches = read_launches()
    assert launches["topk_gallery"] > 0, "the traced query ran no top-k"
    return launches


def phase_mesh(torch, ctx):
    """16b-c. Two ranks on card 0 over gloo at full width: the step against
    one rank on the concatenated batch, a learning fit over a
    ShardedDevicePool, kill and resume; a one-rank NCCL group's fit bit
    for bit as no group's. The ranks' kernel launches are added up."""
    import pickle

    t_phase = time.perf_counter()
    launches = {name: 0 for name in read_launches()}
    cfg, dev = ctx["cfg"], ctx["dev"]
    x1, x2 = ctx["step_batch"]
    tree = ctx["step_tree"]
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, "step.pkl"), "wb") as fp:
            pickle.dump((cfg, tree, x1, x2), fp)
        t0 = time.perf_counter()
        ranks = spawn_ranks(2, "gloo", "fit", work)
        gloo_s = time.perf_counter() - t0
        two = []
        for r in range(2):
            with open(os.path.join(work, f"step_{r}.pkl"), "rb") as fp:
                two.append(pickle.load(fp))
    step = two[0]
    for key in ("grads", "bn", "cca"):     # both ranks took the same step
        assert all(np.array_equal(a, b) for a, b in zip(step[key],
                                                        two[1][key])), key
    assert step["loss"] == two[1]["loss"]
    one = one_step(torch, cfg, tree, x1, x2, dev, torch.float32)
    f64 = one_step(torch, cfg, tree, x1, x2, dev, torch.float64)
    err = step_errors(step, one)
    exact = {"two_ranks": step_errors(step, f64),
             "one_rank": step_errors(one, f64)}
    emit("mesh", check="b. two-rank step vs one rank, concatenated batch",
         ranks=2, backend="gloo", batch=cfg.batch_size,
         per_rank=cfg.batch_size // 2, errors=err, against_float64=exact)
    assert err["loss"] <= STEP_LOSS_RTOL, err
    assert err["corr"] <= 1e-4, err
    assert err["grad"] <= STEP_GRAD_TOL, err
    assert exact["two_ranks"]["grad"] <= MESH_GRAD_TOL, exact
    assert err["bn_rel"] <= STEP_STATE_RTOL, err
    assert err["cov_rel"] <= STEP_STATE_RTOL, err
    assert err["means"] <= 1e-5, err
    assert err["uv"] <= STEP_UV_ATOL, err

    fits = [r["fit"] for r in ranks]
    assert fits[0]["epochs_hex"] == fits[1]["epochs_hex"], fits
    recs = fits[0]["epochs"]
    n_va = TRAIN_PIECES["n_valid"] * TRAIN_PIECES["n_onsets"]
    chance = float(np.mean(1.0 / np.arange(1, n_va + 1)))
    assert len(recs) == TRAIN_EPOCHS, recs
    assert all(np.isfinite(r["train_loss"]) for r in recs), recs
    assert recs[-1]["train_loss"] < recs[0]["train_loss"], recs
    assert recs[-1]["map_va"] > recs[0]["map_va"], recs
    assert recs[-1]["map_va"] > 2 * chance, recs
    for r in ranks:
        assert r["fit"]["launches"]["topk_gallery"] >= 2 * TRAIN_EPOCHS, r
        for part in ("fit", "resume"):
            for name, n in r[part]["launches"].items():
                launches[name] += n
    emit("mesh", check="b. fit over a ShardedDevicePool, two ranks",
         epochs=recs, chance_mrr=chance, seconds=fits[0]["seconds"],
         ranks_agree_bit_for_bit=True,
         max_memory_allocated_mb=[f["max_memory_allocated_mb"]
                                  for f in fits])
    emit("mesh", check="b. kill and resume, two ranks",
         epochs=ranks[0]["resume"]["full"], resumed_bit_identical=True,
         cudnn_deterministic=True)
    emit("mesh", check="b. step times: two processes sharing one card "
         "(not a scaling figure)", one_rank_step_ms=ctx["f32_step"]["step_ms"],
         one_rank_max_memory_allocated_mb=ctx["f32_step"][
             "max_memory_allocated_mb"],
         two_rank_step_ms=[r["step_ms"] for r in ranks],
         two_rank_max_memory_allocated_mb=[
             r["step_max_memory_allocated_mb"] for r in ranks],
         gloo_processes_seconds=gloo_s)

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        (nccl,) = spawn_ranks(1, "nccl", "nccl_fit", work)
        nccl_s = time.perf_counter() - t0
    for name, n in nccl["launches"].items():
        launches[name] += n
    emit("mesh", check="c. one-rank nccl group vs no group, one epoch",
         epochs_hex=nccl["epochs_hex"], bit_identical=True,
         seconds=nccl_s, launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    assert launches["topk_gallery"] > 0, "phase 16 ran no top-k kernel"
    return launches


# --- phase 17: the sharded gallery and CCA fit over a data x db mesh --------

GALLERY_MESH = ((1, 2), (2, 1))   # make_hybrid_mesh: data 2 x db 2
GALLERY_ROWS_ATOL = 1e-5  # sharded rows vs the single card's: one encoder,
                          # windows batched by piece in both
BIG_ROWS = 1_000_000      # phase 8's gallery
BIG_Q, BIG_K = 100, 25
SHARD_N = 6_000           # kernel 1 timed at a db shard of phase 4's gallery
DRYRUN_TIMEOUT = 300


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def big_gallery(torch, dev):
    """Phase 8's 10^6-row random unit gallery, on the host."""
    gen = torch.Generator(device=dev).manual_seed(1)
    big = torch.randn(BIG_ROWS, 32, generator=gen, device=dev)
    return (big / torch.linalg.vector_norm(big, dim=1, keepdim=True)
            ).cpu().numpy()


def rank_gallery(torch, mesh, work) -> dict:
    """17, on one of four gloo ranks sharing card 0, a data x db mesh at
    full width: the sharded sheet build and piece queries, the sharded
    audio build and raw sheet queries, the sharded search of phase 8's
    gallery, the CCA fit over data. Arrays go to ``work``; the timings and
    launches come back as the result."""
    import pickle

    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.parallel import gallery as pg
    from audio_sheet_retrieval_tpu_torch.parallel import mesh as pm
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy

    dev = mesh.device
    with open(os.path.join(work, "gallery.pkl"), "rb") as fp:
        inp = pickle.load(fp)
    cfg, images, specs = inp["cfg"], inp["images"], inp["specs"]
    params = inp["params"].to(dev)
    hmesh = pm.make_hybrid_mesh(*GALLERY_MESH, device=dev)
    res = {"axes": {name: dict(index=ax.index, size=ax.size,
                               ranks=list(ax.ranks))
                    for name, ax in hmesh.axes.items()}}
    n_pieces = len(images)
    # warm-up: cuDNN's first calls of both encoders and kernel 1
    warm = pg.build_sharded_sheet_gallery(hmesh, params, cfg, images[:2])
    pg.make_sharded_piece_query(hmesh, params, cfg, warm, warm.ids, 2)(
        *win.spec_quantize(specs[0][:, :200], 16),
        win.linspace_starts(200, 42, 10))
    sync(torch, dev)

    zero_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sheet = pg.build_sharded_sheet_gallery(hmesh, params, cfg, images)
    sync(torch, dev)
    res["sheet_build_s"] = time.perf_counter() - t0
    # phase 4's queries over phase 4's gallery (host rows, each rank
    # uploading its block) and over the sharded build
    counts = {}
    for name, gal, ids in (("phase4", inp["phase4_rows"], inp["phase4_ids"]),
                           ("build", sheet, sheet.ids)):
        query = pg.make_sharded_piece_query(hmesh, params, cfg, gal, ids,
                                            n_pieces, n_candidates=25)
        counts[name], lat = [], []
        for payload, scale, starts in accuracy.query_payloads(
                cfg, specs, 1, 100, 16):
            for st in starts:
                t0 = time.perf_counter()
                counts[name].append(query(payload, scale, st).cpu().numpy())
                lat.append(time.perf_counter() - t0)
        res[f"piece_query_{name}_p50_ms"] = float(np.percentile(lat, 50)
                                                  * 1000)
    t0 = time.perf_counter()
    audio = pg.build_sharded_audio_gallery(hmesh, params, cfg, specs,
                                           quantize=16)
    sync(torch, dev)
    res["audio_build_s"] = time.perf_counter() - t0
    # the sheet queries over the rle2 wire (the default coding), and raw
    squery = pg.make_sharded_sheet_query(hmesh, params, cfg, audio,
                                         audio.ids, n_pieces,
                                         n_candidates=25, coding="raw")
    rqueries = {}
    s_counts, r_counts, lat, r_lat = [], [], [], []
    for im in images:
        starts = win.linspace_starts(im.shape[1], cfg.input_shape_1[2], 100)
        t0 = time.perf_counter()
        s_counts.append(squery(im, starts).cpu().numpy())
        lat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        bm2, vals2, values, shape = win.rle_bitmap2_encode_padded(im)
        if shape not in rqueries:
            rqueries[shape] = pg.make_sharded_sheet_query(
                hmesh, params, cfg, audio, audio.ids, n_pieces,
                n_candidates=25, strip_shape=shape)
        r_counts.append(rqueries[shape](bm2, vals2, values, starts)
                        .cpu().numpy())
        r_lat.append(time.perf_counter() - t0)
    res["sheet_query_p50_ms"] = float(np.percentile(lat, 50) * 1000)
    res["sheet_query_rle2_p50_ms"] = float(np.percentile(r_lat, 50) * 1000)
    # the coded builds: the sheet over the rANS corpus wire, the audio
    # (u8) over the spectrogram rANS wire, beside the u8 raw build
    t0 = time.perf_counter()
    sheet_c = pg.build_sharded_sheet_gallery_coded(hmesh, params, cfg,
                                                   images)
    sync(torch, dev)
    res["sheet_build_coded_s"] = time.perf_counter() - t0
    audio8 = pg.build_sharded_audio_gallery(hmesh, params, cfg, specs,
                                            quantize=8)
    t0 = time.perf_counter()
    audio8c = pg.build_sharded_audio_gallery(hmesh, params, cfg, specs,
                                             quantize=8, coded=True)
    sync(torch, dev)
    res["audio_build_coded_s"] = time.perf_counter() - t0
    big = np.load(os.path.join(work, "big.npy"), mmap_mode="r")
    t0 = time.perf_counter()
    big_s, big_i = pg.sharded_gallery_search(
        hmesh, big, np.load(os.path.join(work, "big_q.npy")), BIG_K)
    res["big_search_s"] = time.perf_counter() - t0
    lat1, lat2 = inp["refit_pairs"]
    fit = pg.sharded_cca_fit(hmesh, lat1, lat2, axis=pm.DATA_AXIS)
    res["launches"] = read_launches()
    res["max_memory_allocated_mb"] = (
        torch.cuda.max_memory_allocated(dev) / 2**20
        if dev.type == "cuda" else 0.0)
    np.savez(os.path.join(work, f"gallery_{mesh.rank}.npz"),
             sheet_rows=sheet.rows.cpu().numpy(), sheet_offset=sheet.offset,
             sheet_total=sheet.total, sheet_ids=sheet.ids,
             audio_rows=audio.rows.cpu().numpy(), audio_offset=audio.offset,
             audio_total=audio.total, audio_ids=audio.ids,
             counts=np.stack(counts["phase4"]),
             build_counts=np.stack(counts["build"]),
             s_counts=np.stack(s_counts), r_counts=np.stack(r_counts),
             sheetc_rows=sheet_c.rows.cpu().numpy(), sheetc_ids=sheet_c.ids,
             audio8_rows=audio8.rows.cpu().numpy(),
             audio8c_rows=audio8c.rows.cpu().numpy(),
             big_s=big_s, big_i=big_i, coeffs=fit.coeffs.cpu().numpy())
    return res


def whole_rows(outs, key):
    """The blocks of one data replica's db ranks, at their offsets."""
    rows = np.zeros((int(outs[0][key + "_total"]),
                     outs[0][key + "_rows"].shape[1]), np.float32)
    for o in outs:
        off = int(o[key + "_offset"])
        rows[off:off + o[key + "_rows"].shape[0]] = o[key + "_rows"]
    return rows


def run_dryrun() -> dict:
    """17g: ``python -m ...parallel.dryrun --ranks 4`` on card 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "audio_sheet_retrieval_tpu_torch.parallel."
         "dryrun", "--ranks", "4", "--device",
         "cpu" if RANK_DEVICE == "cpu" else "cuda", "--timeout",
         str(DRYRUN_TIMEOUT)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=DRYRUN_TIMEOUT + 30)
    marks = [line for line in proc.stdout.splitlines()
             if line.startswith("[dryrun +") and line.endswith(" done")]
    if proc.returncode != 0 or len(marks) != 6:
        raise SystemExit(f"phase 17 dry run exited {proc.returncode} with "
                         f"{len(marks)} of 6 sections:\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return dict(seconds=time.perf_counter() - t0, sections=marks,
                summary=proc.stdout.strip().splitlines()[-1])


def phase_gallery(torch, ctx):
    """17. Four gloo ranks on card 0 as ``make_hybrid_mesh((1, 2), (2, 1),
    ("data", "db"))`` at full width, against the single card: the sheet
    build and piece queries, the audio build and raw sheet queries, the
    search of phase 8's gallery, the CCA fit of phase 10's pairs; then the
    dry run on four ranks. The ranks' kernel launches are added up; the
    single-card references' are not counted."""
    import pickle

    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.ops.topk_gallery import (
        topk_gallery,
        topk_gallery_plain,
    )
    from audio_sheet_retrieval_tpu_torch.parallel import gallery as pg
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
        make_fused_piece_query_spec,
        make_fused_sheet_query,
    )

    t_phase = time.perf_counter()
    dev, cfg, params = ctx["dev"], ctx["cfg"], ctx["params"]
    images, specs = ctx["images"], ctx["specs"]
    n_pieces = len(images)
    # the single card: phase 4's gallery and counts; the sharded build's
    # geometry, the stride grid (phase 4's gallery takes its windows at the
    # noteheads, an arm the JAX sharded build lacks); phase 7's audio
    # gallery
    ref = accuracy.build_piece_gallery(params, cfg, images, device=dev)
    ref_counts = {}
    for name, gal in (("phase4", ctx["gallery"]), ("build", ref)):
        query = make_fused_piece_query_spec(params, cfg, gal, n_pieces,
                                            n_candidates=25)
        ref_counts[name] = np.stack([
            query(payload, scale, st).cpu().numpy()
            for payload, scale, starts in accuracy.query_payloads(
                cfg, specs, 1, 100, 16) for st in starts])
    s2a = ctx["s2a_gallery"]
    s2a_query = make_fused_sheet_query(params, cfg, s2a, n_pieces,
                                       n_candidates=25, coding="raw")
    ref_s_counts = np.stack([s2a_query(im, win.linspace_starts(
        im.shape[1], cfg.input_shape_1[2], 100)).cpu().numpy()
        for im in images])
    lat1, lat2, coeffs64 = ctx["refit_pairs"]
    launches = {name: 0 for name in read_launches()}
    with tempfile.TemporaryDirectory() as work:
        big = big_gallery(torch, dev)
        np.save(os.path.join(work, "big.npy"), big)
        q = np.random.default_rng(17).standard_normal((BIG_Q, 32)).astype(
            np.float32)
        np.save(os.path.join(work, "big_q.npy"), q)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        ref_big_s, ref_big_i = (t.cpu().numpy() for t in topk_gallery(
            torch.from_numpy(qn).to(dev),
            torch.from_numpy(pg.host_block(big, 1, 0)).to(dev), BIG_K))
        del big
        with open(os.path.join(work, "gallery.pkl"), "wb") as fp:
            pickle.dump(dict(cfg=cfg, params=params.to("cpu"), images=images,
                             specs=specs, refit_pairs=(lat1, lat2),
                             phase4_rows=ctx["gallery"].gallery_n.cpu()
                             .numpy(), phase4_ids=ctx["gallery"].ids), fp)
        t0 = time.perf_counter()
        ranks = spawn_ranks(4, "gloo", "gallery", work)
        ranks_s = time.perf_counter() - t0
        outs = [dict(np.load(os.path.join(work, f"gallery_{r}.npz")))
                for r in range(4)]

    # a. axes: rank = data * 2 + db, each sub-group of two
    for r, res in enumerate(ranks):
        ax = res["axes"]
        assert (ax["data"]["index"], ax["db"]["index"]) == divmod(r, 2), ax
        assert ax["db"]["ranks"] == [r - r % 2, r - r % 2 + 1], ax
        assert ax["data"]["ranks"] == [r % 2, r % 2 + 2], ax
        assert ax["data"]["size"] == ax["db"]["size"] == 2, ax
    emit("gallery", check="a. data x db mesh, four gloo ranks on one card",
         axes=[res["axes"] for res in ranks])

    # b. the sheet build: each data replica's rows are the single card's
    replica_rows = [whole_rows(outs[d:d + 2], "sheet") for d in (0, 2)]
    ids = outs[0]["sheet_ids"]
    real = ids != n_pieces
    assert all(np.array_equal(o["sheet_ids"], ids) for o in outs)
    np.testing.assert_array_equal(ids[real], ref.ids)
    ref_rows = ref.gallery_n.cpu().numpy()
    rows_gap = [float(np.abs(rows[:len(ids)][real] - ref_rows).max())
                for rows in replica_rows]
    assert max(rows_gap) <= GALLERY_ROWS_ATOL, rows_gap
    assert not replica_rows[0][:len(ids)][~real].any() and \
        not replica_rows[0][len(ids):].any()
    emit("gallery", check="b. sharded sheet build vs the single card",
         pieces=n_pieces, pieces_a_shard=-(-n_pieces // 2),
         rows=int(real.sum()), rows_a_shard=outs[0]["sheet_rows"].shape[0],
         max_abs_gap=rows_gap, ids_equal=True, padding_rows_zero=True,
         replicas_rows_max_abs_diff=float(np.abs(
             replica_rows[0] - replica_rows[1]).max()))

    # c. piece queries over phase 4's gallery (6,000 rows a shard) and over
    # the sharded build: the single card's counts, on every rank
    rank1 = {}
    for name, key in (("phase4", "counts"), ("build", "build_counts")):
        for r, o in enumerate(outs):
            np.testing.assert_array_equal(o[key], ref_counts[name],
                                          err_msg=f"{name}, rank {r}")
        ranks1 = [accuracy.rank_and_margin(c, p)[0]
                  for p, c in enumerate(outs[0][key])]
        rank1[name] = sum(r <= 1 for r in ranks1)
        emit("gallery", check="c. sharded piece queries vs the single card",
             gallery="phase 4's (notehead windows, host rows)"
             if name == "phase4" else "the sharded build (stride grid)",
             queries=len(ranks1), counts_equal_bit_for_bit=True,
             ranks_agree=True, rank1=rank1[name],
             rank5=sum(r <= 5 for r in ranks1))
    assert rank1["phase4"] >= 59, rank1

    # d. the audio build and raw sheet queries: phase 7's
    audio_rows = whole_rows(outs[:2], "audio")
    a_ids = outs[0]["audio_ids"]
    a_real = a_ids != n_pieces
    np.testing.assert_array_equal(a_ids[a_real], s2a.ids)
    audio_gap = float(np.abs(audio_rows[:len(a_ids)][a_real]
                             - s2a.gallery_n.cpu().numpy()).max())
    assert audio_gap <= GALLERY_ROWS_ATOL, audio_gap
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["s_counts"], ref_s_counts,
                                      err_msg=f"rank {r}")
    s_ranks = [int((c >= c[p]).sum()) for p, c in enumerate(ref_s_counts)]
    emit("gallery", check="d. sharded audio build (u16) and raw sheet "
         "queries vs phase 7", rows=int(a_real.sum()),
         max_abs_gap=audio_gap, counts_equal_bit_for_bit=True,
         rank1=sum(r <= 1 for r in s_ranks))

    # d2. the wires in the ranks: the coded builds' rows are the raw
    # builds' (the decodes are exact; one encoder, the same windows), the
    # rle2 sheet queries count as the raw ones
    wire_gap = {}
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["sheetc_ids"], o["sheet_ids"])
        np.testing.assert_array_equal(o["r_counts"], ref_s_counts,
                                      err_msg=f"rle2, rank {r}")
        for coded, raw in (("sheetc", "sheet"), ("audio8c", "audio8")):
            gap = float(np.abs(o[coded + "_rows"] - o[raw + "_rows"]).max())
            wire_gap.setdefault(coded, []).append(gap)
    assert max(max(g) for g in wire_gap.values()) <= GALLERY_ROWS_ATOL, \
        wire_gap
    emit("gallery", check="d2. the wires on four ranks: coded builds vs "
         "raw, rle2 sheet queries vs raw", max_abs_gap=wire_gap,
         bit_identical={k: all(x == 0.0 for x in g)
                        for k, g in wire_gap.items()},
         rle2_counts_equal_bit_for_bit=True)

    # e. phase 8's gallery searched over db: kernel 1's on the whole
    s_gap = 0.0
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["big_i"], ref_big_i,
                                      err_msg=f"rank {r}")
        s_gap = max(s_gap, float(np.abs(o["big_s"] - ref_big_s).max()))
    assert s_gap <= TOPK_ATOL, s_gap
    emit("gallery", check="e. sharded search of 10^6 rows vs kernel 1 on "
         "one card", rows=BIG_ROWS, q=BIG_Q, k=BIG_K, indices_equal=True,
         scores_max_abs_err=s_gap,
         bit_identical=all(np.array_equal(o["big_s"], ref_big_s)
                           for o in outs))

    # f. the CCA fit over data
    coeffs_err = max(float(np.abs(o["coeffs"] - coeffs64).max())
                     for o in outs)
    assert coeffs_err <= REFIT_COEFFS_ATOL, coeffs_err
    emit("gallery", check="f. CCA fit over data vs float64", pairs=len(lat1),
         coeffs_max_abs_err_vs_float64=coeffs_err)

    # g. the dry run on four ranks
    emit("gallery", check="g. dry run, four ranks on one card",
         **run_dryrun())

    # h. the ranks' own numbers, and kernel 1 at a db shard's shape
    for res in ranks:
        assert res["launches"]["topk_gallery"] > 0, res
        assert res["launches"]["rans_decode"] > 0, res   # coded builds
        for name, n in res["launches"].items():
            launches[name] += n
    emit("gallery", check="h. per rank: four processes sharing one card "
         "(not a scaling figure)",
         **{key: [res[key] for res in ranks] for key in (
             "sheet_build_s", "piece_query_phase4_p50_ms",
             "piece_query_build_p50_ms", "audio_build_s",
             "sheet_query_p50_ms", "sheet_query_rle2_p50_ms",
             "sheet_build_coded_s", "audio_build_coded_s", "big_search_s",
             "max_memory_allocated_mb")},
         launches_a_rank=[res["launches"]["topk_gallery"] for res in ranks],
         ranks_seconds=ranks_s)
    if dev.type == "cuda":
        # beside the whole gallery's in the same window: the event time of
        # so short a launch is mostly host time, the profiler's is not
        whole = ctx["gallery"].gallery_n
        g = whole[:SHARD_N].contiguous()
        qs = torch.from_numpy(qn).to(dev)
        check_topk(torch, qs, g, 25)
        ctx["shard_topk"] = dict(
            n=SHARD_N, ms=cuda_ms(lambda: topk_gallery(qs, g, 25)),
            plain_ms=cuda_ms(lambda: topk_gallery_plain(qs, g, 25)),
            library_ms=cuda_ms(lambda: torch.topk(qs @ g.T, 25)),
            bound_ms=topk_bound(BIG_Q, SHARD_N, 32, 25)[0],
            device_us=device_us(lambda: topk_gallery(qs, g, 25), "topk"),
            whole_n=whole.shape[0],
            whole_ms=cuda_ms(lambda: topk_gallery(qs, whole, 25)),
            whole_device_us=device_us(lambda: topk_gallery(qs, whole, 25),
                                      "topk"))
        emit("gallery", check="h. kernel 1 at a db shard's shape",
             q=BIG_Q, **ctx["shard_topk"])
    emit("gallery", launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


# --- phase 18: the wires -----------------------------------------------------

WIRE_BUCKET = 4096        # the server's strip width bucket
WIRE_PLAIN_ITERS = 3      # the plain decode / encode loops are slow


BARRIER_ROUNDS = 10_000   # rounds a barrier measurement times (the launch's
                          # own microseconds spread over them)


def rans_bound_threads(S: int) -> int:
    """The CTA width whose barrier round floors a step of S lanes: the
    narrowest whole warps that hold S lanes at 16 lanes a thread (the
    most a kernel's thread runs), from the function's inputs alone, not
    from the width a kernel's plan chooses."""
    return -(-(-(-S // 16)) // 32) * 32


def rans_bound(torch, nbytes: float, steps: int, threads: int):
    """-> (bound ms, "bytes" or "operations", bytes ms, barrier floor ms,
    one barrier round ns) of a rANS kernel: its bytes (each input read
    once, each output written once) at the memory rate against its
    ``steps`` dependent steps, each at least one CTA-wide barrier round of
    ``threads`` threads (``dtw_barrier_rounds``, the DTW row's floor;
    ``rans_bound_threads(S)`` for S lanes)."""
    from audio_sheet_retrieval_tpu_torch.ops import _native

    lib = _native.load("dtw")
    scratch = torch.empty(threads, dtype=torch.int32, device="cuda")
    round_ms = cuda_ms(lambda: _native.check(lib.dtw_barrier_rounds(
        BARRIER_ROUNDS, threads, scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "barrier"),
        iters=10) / BARRIER_ROUNDS
    bytes_ms = nbytes / card_peaks()["hbm_bytes_per_s"] * 1e3
    floor_ms = round_ms * steps
    return (max(bytes_ms, floor_ms),
            "bytes" if bytes_ms >= floor_ms else "operations",
            bytes_ms, floor_ms, round_ms * 1e6)


def check_decode_kernel(torch, name, freqs, states, words, n,
                        want=None, time_it=False, lanes=None) -> dict:
    """18a: the decode kernel on ``(freqs, states, words)`` against its
    plain version and the native host decoder, bit for bit (and against
    ``want``, the coded rows, where given); ``lanes``: the lanes a thread
    (default: ``decode_plan``'s); its times at the path's shapes, and the
    microseconds a step beside one barrier round of the bound's width
    (``rans_bound_threads``)."""
    from audio_sheet_retrieval_tpu_torch.ops import rans

    dev = torch.device("cuda")
    freqs, states, words = (np.asarray(a) for a in (freqs, states, words))
    f = rans._bits(freqs, torch.int16, dev)
    s = rans._bits(states, torch.int32, dev)
    w = rans._bits(words if words.shape[1] else np.zeros(
        (states.shape[0], 1), np.uint16), torch.int16, dev)
    def kernel():
        return rans.rans_decode_kernel(f, s, w, n, _lanes=lanes)

    got = kernel()
    plain = rans.rans_decode_batch_plain(rans._wide(f), rans._wide(s),
                                         rans._wide(w), n)
    assert torch.equal(got, plain), f"18a decode {name}: kernel != plain"
    host = np.stack([rans.rans_decode_host(freqs[p], states[p], words[p], n)
                     for p in range(states.shape[0])])
    got_h = got.cpu().numpy()
    assert np.array_equal(got_h, host), f"18a decode {name}: != native host"
    if want is not None:
        assert np.array_equal(got_h, want), f"18a decode {name}: != data"
    P, S = states.shape
    plan = rans.decode_plan(S, lanes)
    row = dict(case=name, P=P, n=n, S=S, K=-(-n // S),
               w_max=int(words.shape[1]), lanes_a_thread=plan.g,
               threads=plan.threads, max_abs_err=0)
    if time_it:
        K = -(-n // S)
        nbytes = 2 * words.size + 4 * states.size + 2 * freqs.size + P * n
        b = rans_bound(torch, nbytes, K, rans_bound_threads(S))
        # back to back between two events: the device's time (the
        # profiler records none of these ctypes launches on the card)
        q = queued_ms(kernel)
        row.update(
            ms=cuda_ms(kernel),
            plain_ms=cuda_ms(lambda: rans.rans_decode_batch_plain(
                rans._wide(f), rans._wide(s), rans._wide(w), n),
                iters=WIRE_PLAIN_ITERS, warmup=1),
            queued_ms=q, us_a_step=q * 1e3 / K,
            bound_ms=b[0], bound_by=b[1], bytes_ms=b[2],
            barrier_floor_ms=b[3], barrier_round_ns=b[4], library_ms=None)
    emit("wire", check="a. decode kernel vs plain", **row)
    return row


def check_encode_kernel(torch, name, data: np.ndarray, freqs: np.ndarray,
                        S: int, w_budget: int, time_it=False) -> dict:
    """18a: the encode kernel against its plain version, bit for bit
    (states, words padded to w_budget, the true n_words), and against the
    numpy encoder ``rans_encode(..., freqs=...)``; timed, also with
    w_budget = 0 (the lanes' steps and the scan of their emissions alone:
    nothing to place), so the placement of the words is the difference."""
    from audio_sheet_retrieval_tpu_torch.ops import rans

    dev = torch.device("cuda")
    d = torch.from_numpy(np.ascontiguousarray(data, np.uint8)).to(dev)
    f = rans._bits(freqs, torch.int16, dev)
    pad = int(np.argmax(freqs))
    st, w, nw = rans.rans_encode_kernel(d, f, S, w_budget, pad)
    pst, pw, pnw = rans.rans_encode_plain(d.to(torch.int64), rans._wide(f),
                                          S, w_budget, pad)
    assert torch.equal(rans._wide(st), pst) and torch.equal(
        rans._wide(w), pw) and int(nw) == int(pnw), \
        f"18a encode {name}: kernel != plain"
    _, st_h, w_h = rans.rans_encode(data, S, freqs=freqs)
    m = min(w_budget, w_h.size)
    words = rans._wide(w).cpu().numpy()
    assert np.array_equal(rans._wide(st).cpu().numpy(), st_h) \
        and int(nw) == w_h.size and np.array_equal(words[:m], w_h[:m]) \
        and not words[m:].any(), f"18a encode {name}: != numpy encoder"
    n = data.size
    plan = rans.encode_plan(S)
    row = dict(case=name, n=n, S=S, K=-(-n // S), w_budget=w_budget,
               n_words=int(nw), overflow=int(nw) > w_budget,
               lanes_a_thread=1, threads=plan.threads, ctas=plan.ctas,
               max_abs_err=0)
    if time_it:
        K = -(-n // S)
        nbytes = n + 2 * 256 + 4 * S + 2 * w_budget + 4
        b = rans_bound(torch, nbytes, K, rans_bound_threads(S))
        q = queued_ms(lambda: rans.rans_encode_kernel(d, f, S, w_budget,
                                                      pad))
        loop_q = queued_ms(lambda: rans.rans_encode_kernel(d, f, S, 0, pad))
        row.update(
            ms=cuda_ms(lambda: rans.rans_encode_kernel(d, f, S, w_budget,
                                                       pad)),
            plain_ms=cuda_ms(lambda: rans.rans_encode_plain(
                d.to(torch.int64), rans._wide(f), S, w_budget, pad),
                iters=WIRE_PLAIN_ITERS, warmup=1),
            queued_ms=q, loop_queued_ms=loop_q, tail_queued_ms=q - loop_q,
            us_a_step=loop_q * 1e3 / K,
            bound_ms=b[0], bound_by=b[1], bytes_ms=b[2],
            barrier_floor_ms=b[3], barrier_round_ns=b[4], library_ms=None)
    emit("wire", check="a. encode kernel vs plain", **row)
    return row


def host_ms(fn, iters: int = 1) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


@contextlib.contextmanager
def numpy_rans():
    """The host rANS encoder pinned to numpy (ASR_NO_NATIVE_RANS=1)."""
    old = os.environ.get("ASR_NO_NATIVE_RANS")
    os.environ["ASR_NO_NATIVE_RANS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["ASR_NO_NATIVE_RANS"]
        else:
            os.environ["ASR_NO_NATIVE_RANS"] = old


def tutorial_prep():
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.cli import tutorial
    from audio_sheet_retrieval_tpu_torch.omr.inference import prepare_image
    from audio_sheet_retrieval_tpu_torch.utils.image_io import imread_gray

    return prepare_image(tutorial.resize_page(imread_gray(
        assets.tutorial_sheet_path())))


def wire_kernels(torch, ctx) -> dict:
    """18a. Both rANS kernels against their plain versions on the card at
    the path's shapes and the edge cases; the host encode times."""
    from audio_sheet_retrieval_tpu_torch.omr import inference as omr
    from audio_sheet_retrieval_tpu_torch.ops import rans
    from audio_sheet_retrieval_tpu_torch.ops import windows as win

    images, specs = ctx["images"], ctx["specs"]
    out = {"decode": {}, "encode": {}, "host": {}}
    # the sheet corpus: phase 4's strips padded white to the width bucket
    # (to the widest bucket, should their buckets differ: one corpus shape)
    width = max(-(-im.shape[1] // WIRE_BUCKET) for im in images) \
        * WIRE_BUCKET
    padded = [win._pad_white(im, width) for im in images]
    out["host"]["rle2_encode_ms_a_strip"] = host_ms(
        lambda: [win.rle_bitmap2_encode_strip(p) for p in padded]) / len(
            padded)
    payload, lens, piece_bytes = win.rans_encode_corpus_strips(padded)
    out["host"]["sheet_corpus_encode_native_ms"] = host_ms(
        lambda: win.rans_encode_corpus_strips(padded))
    with numpy_rans():
        out["host"]["sheet_corpus_encode_numpy_ms"] = host_ms(
            lambda: win.rans_encode_corpus_strips(padded))
        assert all(np.array_equal(a, b) for comp, ncomp in zip(
            payload, win.rans_encode_corpus_strips(padded)[0])
            for a, b in zip(comp, ncomp)), "numpy and native payloads differ"
    encs = [win.rle_bitmap2_encode_strip(p) for p in padded]
    for k, name in enumerate(("sheet_bm2", "sheet_vals2", "sheet_values")):
        want = np.stack([np.pad(e[k], (0, lens[k] - e[k].size))
                         for e in encs])
        out["decode"][name] = check_decode_kernel(
            torch, name, *payload[k], lens[k], want=want, time_it=True)
    assert len(set(piece_bytes)) > 1, "18a: no unequal word counts"
    ctx["wire_sheet"] = dict(padded=padded, payload=payload, lens=lens,
                             piece_bytes=piece_bytes)
    # the spectrogram corpus: phase 4's u8 codes, zero-padded to one length
    T = max(s.shape[1] for s in specs)
    spad = [np.pad(s, ((0, 0), (0, T - s.shape[1]))) for s in specs]
    coded = win.spec_rans_encode_corpus(spad)
    out["host"]["spec_corpus_encode_native_ms"] = host_ms(
        lambda: win.spec_rans_encode_corpus(spad))
    with numpy_rans():
        out["host"]["spec_corpus_encode_numpy_ms"] = host_ms(
            lambda: win.spec_rans_encode_corpus(spad))
    out["decode"]["spec_u8"] = check_decode_kernel(
        torch, "spec_u8", *coded[0], spad[0].size, time_it=True)
    ctx["wire_spec"] = dict(specs=spad, coded=coded)
    # the tutorial page's planes, four segments a plane, S = 2,048
    prep = ctx["wire_prep"] = tutorial_prep()
    page_u16 = omr._quantize_page(prep)
    omr._page_wire_cache.clear()
    out["host"]["page_encode_native_ms"] = host_ms(
        lambda: (omr._page_wire_cache.clear(),
                 omr._encode_page_wire(page_u16)))
    with numpy_rans():
        out["host"]["page_encode_numpy_ms"] = host_ms(
            lambda: (omr._page_wire_cache.clear(),
                     omr._encode_page_wire(page_u16)))
    omr._page_wire_cache.clear()
    freqs, states, words, n_px, reuse = omr._encode_page_wire(page_u16)
    c = -(-n_px // 4)
    out["decode"]["page_segments"] = check_decode_kernel(
        torch, "page_segments", freqs, states, words, c, time_it=True)
    # edge cases: n < S, constant rows (no words), a one-symbol table of
    # frequency 4,096
    rng = np.random.default_rng(18)
    small = [np.minimum(rng.geometric(0.3, 100) - 1, 255).astype(np.uint8)]
    f_s, s_s, w_s, _ = rans.rans_encode_batch(small, 128)
    check_decode_kernel(torch, "n_below_S", f_s, s_s, w_s, 100,
                        want=np.stack(small))
    const = [np.full(700, 3, np.uint8), np.full(700, 250, np.uint8)]
    f_c, s_c, w_c, _ = rans.rans_encode_batch(const)
    assert w_c.shape[1] == 0
    check_decode_kernel(torch, "constant", f_c, s_c, w_c, 700,
                        want=np.stack(const))
    one = np.zeros(256, np.uint16)
    one[9] = 4096
    check_encode_kernel(torch, "freq_4096", np.full(1000, 9, np.uint8), one,
                        128, 64)
    _, s1, w1 = rans.rans_encode(np.full(1000, 9, np.uint8), 128, freqs=one)
    check_decode_kernel(torch, "freq_4096", one[None], s1[None],
                        w1[None], 1000, want=np.full((1, 1000), 9, np.uint8))
    # the encode at a map plane of the tutorial page (the system net's hi
    # bytes, its static table and budget), K*S < w_budget, an overflow
    net = omr.SegmentationNetwork(ctx["omr_system_params"], map_kind="system",
                                  page_wire="raw", map_wire="raw",
                                  device=ctx["dev"])
    codes = np.round(net.predict_proba(prep).astype(np.float64) * 65535)
    plane = (codes.astype(np.uint16) >> 8).astype(np.uint8).ravel()
    sfreqs, budget, _ = omr._map_wire_tables("system")
    w_budget = omr._map_w_budget(*prep.shape, budget)
    out["encode"]["map_plane"] = check_encode_kernel(
        torch, "map_plane", plane, sfreqs, rans.auto_streams(plane.size),
        w_budget, time_it=True)
    check_encode_kernel(torch, "K_S_below_budget", plane[:300], sfreqs, 128,
                        1024)
    check_encode_kernel(torch, "overflow", plane, sfreqs, 2048, 64)
    wire_ring_cases(torch, rng)
    return out


def all_lanes_alike(rng, n: int, S: int) -> np.ndarray:
    """n bytes in which every lane of S codes one sequence of rare
    symbols: the lanes' states stay equal, so a step that consumes (or
    emits) a word does so in every lane."""
    seq = np.where(rng.random(-(-n // S)) < 0.9,
                   rng.integers(1, 256, -(-n // S)), 0).astype(np.uint8)
    return np.repeat(seq, S)[:n]


def wire_ring_cases(torch, rng) -> None:
    """18a, the cases the staged design can get wrong, each bit for bit
    against the plain version and the native decoder / numpy encoder:
    words many times the decode's ring (10^6 uniform bytes at S = 4,096,
    16 lanes a thread), steps in which every lane consumes, S not a
    multiple of 32, 60 payloads at S = 128 and 2 lanes a thread, n not a
    multiple of S; an encode whose emission masks span several tiles of
    its scan (and its words many CTAs of the placement), one whose words
    fill the budget exactly, and one in which every lane emits."""
    from audio_sheet_retrieval_tpu_torch.ops import rans

    def decode(name, arrays, S, lanes=None):
        f, s, w, _ = rans.rans_encode_batch(arrays, S)
        check_decode_kernel(torch, name, f, s, w, arrays[0].size,
                            want=np.stack(arrays), lanes=lanes)

    decode("ring_many_times_S4096_G16",
           [rng.integers(0, 256, 1_000_000, dtype=np.uint8)], 4096, 16)
    decode("all_lanes_consume",
           [all_lanes_alike(rng, 60_000, 2048) for _ in range(2)], 2048)
    decode("S_200", [np.minimum(rng.geometric(0.3, 7777) - 1, 255)
                     .astype(np.uint8) for _ in range(5)], 200)
    decode("P60_S128_G2", [np.minimum(rng.geometric(0.4, 3000) - 1, 255)
                           .astype(np.uint8) for _ in range(60)], 128, 2)
    decode("n_not_a_multiple_of_S",
           [rng.integers(0, 256, 3001, dtype=np.uint8) for _ in range(3)],
           128)
    data = rng.integers(0, 256, 1_000_001, dtype=np.uint8)
    freqs = rans.quantize_freqs(np.bincount(data, minlength=256))
    check_encode_kernel(torch, "S_200", data[:50_000], freqs, 200, 30_000)
    row = check_encode_kernel(torch, "many_scan_tiles", data, freqs, 2048,
                              600_000)
    plan = rans.encode_plan(2048)
    assert row["K"] * plan.warps_a_step > 2 * plan.scan_tile, row
    check_encode_kernel(torch, "budget_equals_n_words", data, freqs, 2048,
                        row["n_words"])
    check_encode_kernel(torch, "all_lanes_emit",
                        all_lanes_alike(rng, 60_000, 2048),
                        rans.quantize_freqs(np.ones(256)), 2048, 60_000)


def wire_sheet(torch, ctx) -> dict:
    """18b. The sheet wire: each strip through the rle2 embedder against
    the raw embedder on the same padded strip, exact and fullconv, bit for
    bit; the corpus decode's stacks; the sheet query's counts, rle2 against
    raw, on phase 7's gallery; the server's build wall over each wire; the
    wire bytes a strip."""
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from audio_sheet_retrieval_tpu_torch.retrieval.gallery import (
        make_fused_sheet_query,
    )

    dev, cfg, params = ctx["dev"], ctx["cfg"], ctx["params"]
    images, w = ctx["images"], ctx["wire_sheet"]
    padded = w["padded"]
    for fullconv in (False, True):
        rle2 = win.make_strip_embedder_rle_bitmap2(
            params, cfg, padded[0].shape, center_crop=160, fullconv=fullconv,
            device=dev)
        raw = win.make_strip_embedder(params, cfg, center_crop=160,
                                      fullconv=fullconv, device=dev)
        for im, pad in zip(images, padded):
            starts = np.arange(0, im.shape[1] - 200, 50, dtype=np.int32)
            assert torch.equal(rle2(*win.rle_bitmap2_encode_strip(pad),
                                    starts), raw(pad, starts)), \
                f"18b rle2 embedder, fullconv={fullconv}"
    stacks = win.make_corpus_rans_decoder(w["lens"], device=dev)(
        w["payload"])
    for p, pad in enumerate(padded):
        strip = win.rle_bitmap2_decode_device(stacks[0][p], stacks[1][p],
                                              stacks[2][p], *pad.shape)
        assert np.array_equal(strip.cpu().numpy(), pad), f"18b strip {p}"
    # the sheet query over phase 7's audio gallery: rle2 vs raw counts
    gal, n = ctx["s2a_gallery"], len(images)
    raw_q = make_fused_sheet_query(params, cfg, gal, n, n_candidates=25,
                                   coding="raw")
    rle_q = make_fused_sheet_query(params, cfg, gal, n, n_candidates=25,
                                   coding="rle_bitmap2",
                                   strip_shape=padded[0].shape)
    lat = {"raw": [], "rle_bitmap2": []}
    for im, pad in zip(images, padded):
        starts = win.linspace_starts(im.shape[1], 200, 100)
        t0 = time.perf_counter()
        a = raw_q(im, starts).cpu().numpy()
        lat["raw"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        b = rle_q(*win.rle_bitmap2_encode_strip(pad), starts).cpu().numpy()
        lat["rle_bitmap2"].append(time.perf_counter() - t0)
        assert np.array_equal(a, b), "18b rle2 counts differ from raw"
    # the server's device build over the rle2 wire against the raw upload
    # of PR 12 (the same embedder over each unpadded raw strip)
    srv = make_server(ctx)
    names = ["piece_%03d" % p for p in range(n)]
    srv.initialize_sheet_db_from_imges_device(names[:2], images[:2])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.initialize_sheet_db_from_imges_device(names, images)
    torch.cuda.synchronize()
    rle2_build_s = time.perf_counter() - t0
    embed = win.make_strip_embedder(params, cfg, center_crop=160,
                                    device=dev)
    t0 = time.perf_counter()
    raw_codes = torch.cat([embed(im, np.arange(0, im.shape[1] - 200, 50,
                                               dtype=np.int32))
                           for im in images])
    torch.cuda.synchronize()
    raw_build_s = time.perf_counter() - t0
    build_gap = float((srv.sheet_snippet_codes - raw_codes).abs().max())
    assert build_gap <= GALLERY_ROWS_ATOL, build_gap
    enc0 = [win.rle_bitmap2_encode_strip(p) for p in padded]
    row = dict(
        strips=n, strip_shape=list(images[0].shape),
        padded_shape=list(padded[0].shape),
        rle2_embedders_bit_identical=True, corpus_decode_bit_identical=True,
        counts_rle2_equal_raw=True, queries=n,
        query_p50_ms={k: float(np.percentile(v, 50) * 1000)
                      for k, v in lat.items()},
        server_build_s={"rle2_wire": rle2_build_s, "raw_upload": raw_build_s},
        server_build_max_abs_gap_vs_raw=build_gap,
        bytes_a_strip={
            "raw": int(images[0].size),
            "raw_padded": int(padded[0].size),
            "rle2": float(np.mean([sum(c.size for c in e) for e in enc0])),
            "rans_corpus": float(np.mean(w["piece_bytes"]))})
    emit("wire", check="b. the sheet wire", **row)
    return row


def wire_spec(torch, ctx) -> dict:
    """18c. The spectrogram wire: the corpus decode equals spec_quantize's
    u8 codes of every piece; the delta flags; the bytes a spectrogram."""
    from audio_sheet_retrieval_tpu_torch.ops import windows as win

    specs, coded = ctx["wire_spec"]["specs"], ctx["wire_spec"]["coded"]
    payload, flags, scales, shape, piece_bytes = coded
    codes = win.make_corpus_spec_rans_decoder(shape, device=ctx["dev"])(
        payload, flags).cpu().numpy()
    for p, s in enumerate(specs):
        want, scale = win.spec_quantize(s, 8)
        assert np.array_equal(codes[p], want), f"18c piece {p}"
        assert scale == scales[p]
    bins, T = shape
    row = dict(pieces=len(specs), shape=list(shape), codes_equal=True,
               delta_coded=int(flags.sum()), raw_coded=int(len(flags)
                                                          - flags.sum()),
               bytes_a_spec={"f32": 4 * bins * T, "u16": 2 * bins * T,
                             "u8": bins * T,
                             "rans": float(np.mean(piece_bytes))})
    emit("wire", check="c. the spectrogram wire", **row)
    return row


def wire_omr(torch, ctx) -> dict:
    """18d. OMR on the tutorial page: page_wire x map_wire in {raw, rans}^2
    for the three nets (their own map tables) at map_bits 8 and 16: the
    maps bit-identical, the page time of each pair; a tiny budget takes
    the overflow path and equals raw; the bytes a page."""
    from audio_sheet_retrieval_tpu_torch.omr import inference as omr

    prep, dev = ctx["wire_prep"], ctx["dev"]
    params = ctx["omr_params"]
    pairs = [(p, m) for p in ("raw", "rans") for m in ("raw", "rans")]
    times, overflows = {}, 0
    for bits in (8, 16):
        for kind in ("system", "bar", "note"):
            shape = OMR_NOTE_SHAPE if kind == "note" else (512, 512)
            maps = {}
            for pw, mw in pairs:
                net = omr.SegmentationNetwork(
                    params[kind], shape, map_bits=bits, page_wire=pw,
                    map_wire=mw, map_kind=kind, device=dev)
                maps[pw, mw] = net.predict_proba(prep)
                if bits == 16:
                    times.setdefault(kind, {})[f"{pw}/{mw}"] = cuda_ms(
                        lambda: net.predict_proba(prep), iters=5, warmup=1)
                overflows += net.map_overflows
            ref = maps["raw", "raw"]
            assert all(np.array_equal(m, ref) for m in maps.values()), \
                f"18d maps differ: {kind}, map_bits {bits}"
        # the overflow path: a near-uniform table and a tiny budget
        omr._map_wire_cache["_tiny"] = (np.full(256, 16, np.uint16), 0.001, 0)
        try:
            net = omr.SegmentationNetwork(params["system"], map_bits=bits,
                                          map_kind="_tiny", device=dev)
            got = net.predict_proba(prep)
        finally:
            omr._map_wire_cache.pop("_tiny")
        assert net.map_overflows == 1 and np.array_equal(
            got, omr.SegmentationNetwork(params["system"], map_bits=bits,
                                         page_wire="raw", map_wire="raw",
                                         device=dev).predict_proba(prep))
    net = omr.SegmentationNetwork(params["system"], map_kind="system",
                                  device=dev)
    (top, bottom, left, right), _ = net.tile_origins(*prep.shape)
    freqs, states, words, n_px, reuse = omr._encode_page_wire(
        omr._quantize_page(prep))
    sfreqs, budget, pad_sym = omr._map_wire_tables("system")
    w_budget = omr._map_w_budget(*prep.shape, budget)
    S = omr.rans.auto_streams(n_px)
    row = dict(
        nets=["system", "bar", "note"], map_bits=[8, 16],
        maps_bit_identical=True, overflow_path_equal_raw=True,
        real_table_overflows=overflows, page_ms=times,
        bytes_a_page={
            "page_raw_u16_canvas": 2 * (prep.shape[0] + top + bottom)
            * (prep.shape[1] + left + right),
            "page_rans_upload": int(freqs.nbytes + states.nbytes
                                    + words.nbytes),
            "plane_reuse": bool(reuse),
            "map_raw_u16": 2 * n_px,
            "map_coded_u16": 2 * (2 + 2 * S + w_budget + (n_px + 1) // 2)})
    emit("wire", check="d. OMR wires", **row)
    return row


def phase_wire(torch, ctx):
    """18. The wire codecs: both rANS kernels against their plain versions
    (18a, not counted), then the sheet, spectrogram and OMR wires end to
    end (18b-d, counted)."""
    from audio_sheet_retrieval_tpu_torch.models import unet
    from audio_sheet_retrieval_tpu_torch import assets

    t_phase = time.perf_counter()
    ctx["omr_params"] = {kind: unet.load_unet_checkpoint(
        assets.omr_weights_path(kind), ctx["dev"])
        for kind in ("system", "bar", "note")}
    ctx["omr_system_params"] = ctx["omr_params"]["system"]
    kernels = wire_kernels(torch, ctx)
    emit("wire", check="a. host encodes (ms)", **kernels["host"])
    zero_launches()
    sheet = wire_sheet(torch, ctx)
    spec = wire_spec(torch, ctx)
    omr_row = wire_omr(torch, ctx)
    launches = read_launches()
    assert launches["rans_decode"] > 0 and launches["rans_encode"] > 0, \
        launches
    ctx["wire"] = dict(kernels=kernels, sheet=sheet, spec=spec, omr=omr_row)
    emit("wire", launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


# --- phase 19: the experiment layer -------------------------------------------

SWEEP_SEED = 31
SWEEP_PIECES = 30          # confusable pieces of 120 onsets
PROTOCOL_ARGV = ["--n_train_pieces", "6", "--n_valid_pieces", "2",
                 "--n_test_pieces", "2", "--n_onsets", "60",
                 "--max_epochs", "2", "--n_test", "100",
                 "--n_refine", "2000", "--regimes", "mutopia_no_aug"]


def script_module(name: str):
    """``scripts/<name>.py`` of this checkout, imported as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def experiment_sweep(torch, ctx, count) -> dict:
    """19a. The accuracy sweep's function over 30 confusable pieces, seed
    31, onset galleries, all four arms: ``high`` equal to highest query
    for query, the f32-highest e100 ranks equal to a replay through the
    plain top-k, each of bf16-fcp's gather launches bit-identical to the
    plain version, every cell of 30, 60 or 90 queries."""
    from audio_sheet_retrieval_tpu_torch.ops import windows as win

    sweep_mod = script_module("torch_accuracy_sweep")
    dev, params, cfg = ctx["dev"], ctx["params"], ctx["cfg"]
    recorded = []
    t0 = time.perf_counter()
    win.gather_feature_windows.recorded = recorded
    try:
        out, _, ranks = count(lambda: quiet(lambda: sweep_mod.sweep(
            n_pieces=SWEEP_PIECES, seeds=(SWEEP_SEED,), modes=("onset",),
            device=dev))[0])
    finally:
        win.gather_feature_windows.recorded = None
    sweep_s = time.perf_counter() - t0
    cells = out["cells"]
    assert len(cells) == 18, sorted(cells)
    for key, cell in cells.items():
        epq = int(key.rsplit("|e", 1)[1])
        qpp = dict(sweep_mod.DIFFICULTY)[epq]
        assert cell["n"] == SWEEP_PIECES * qpp, (key, cell["n"])
    for epq, _ in sweep_mod.DIFFICULTY:
        high = ranks[(SWEEP_SEED, "f32-high+u16", "onset", epq)]
        highest = ranks[(SWEEP_SEED, "f32-highest+u16", "onset", epq)]
        assert np.array_equal(high, highest), f"high differs at e{epq}"
    # the bf16-fcp builds' gather launches, each against the plain version
    assert len(recorded) == SWEEP_PIECES, len(recorded)
    for plane, starts, n_cols, got in recorded:
        assert plane.dtype == torch.bfloat16
        assert torch.equal(got, win.gather_feature_windows_plain(
            plane, starts, n_cols)), "bf16-fcp gather differs"
    del recorded[:]
    # the f32-highest e100 cell through the plain top-k (not counted)
    images, specs, coords, _ = sweep_mod.seed_corpus(
        SWEEP_SEED, SWEEP_PIECES, out["n_onsets"])
    gal = sweep_mod.build_gallery(params, cfg, "f32-highest", "onset",
                                  images, coords, device=dev)
    plain = plain_replay_ranks(torch, params, cfg, gal, specs, SWEEP_PIECES)
    kernel = ranks[(SWEEP_SEED, "f32-highest+u16", "onset", 100)]
    assert plain == [int(r) for r in kernel], "plain top-k replay differs"
    fcp = out["comparisons"]["bf16-fcp+u16 vs bf16+u16|onset|e100"]
    row = dict(seconds=sweep_s, n_pieces=SWEEP_PIECES, seed=SWEEP_SEED,
               rank1={key.split("|")[0] + "|" + key.rsplit("|", 1)[1]:
                      cell["rank1"] for key, cell in cells.items()},
               high_equals_highest=True, plain_replay_equal=True,
               fcp_gather_launches_bit_identical=True,
               bf16_fcp_vs_bf16_e100=dict(
                   b=fcp["discordant_a_only"], c=fcp["discordant_b_only"],
                   p=fcp["mcnemar_p"]))
    emit("experiments", check="a. accuracy sweep", **row)
    return row


def experiment_protocol(torch, ctx, count) -> dict:
    """19b. The protocol script at full width in its default bf16, one
    regime, a few pieces: the table filled as the CPU test fills it, the
    refined dump read back."""
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        load_any_checkpoint,
    )

    proto = script_module("torch_full_protocol")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        out, _ = count(lambda: quiet(lambda: proto.main(
            PROTOCOL_ARGV + ["--workdir", work])))
        seconds = time.perf_counter() - t0
        table = out["table"]
        filled = [r for r in table if not r.endswith("- & - & - & - \\\\")]
        assert len(table) == 8 and len(filled) == 2, table
        assert all(r.count("&") == 12 and r.startswith("none")
                   for r in filled), filled
        model = proto.build_arg_parser().get_default("model")
        dump = os.path.join(work, "exp", model + "_est_UV",
                            "params_all_split_mutopia_no_aug.pkl")
        refined = load_any_checkpoint(dump, ctx["cfg"], device=ctx["dev"])
        assert all(bool(torch.isfinite(t).all()) for t in refined.cca), \
            "refined CCA state not finite"
    row = dict(seconds=seconds, argv=PROTOCOL_ARGV,
               timings=out["timings"], table=filled,
               refined_dump_loaded=True)
    emit("experiments", check="b. protocol script", **row)
    return row


def phase_experiments(torch, ctx):
    """19. The experiment layer on the card: a. the accuracy sweep, b. the
    four-regime protocol script (one regime here); each counted."""
    t_phase = time.perf_counter()
    launches = {name: 0 for name in read_launches()}
    count = launch_counter(launches)
    sweep_row = experiment_sweep(torch, ctx, count)
    assert launches["gather_feature_windows"] > 0, \
        "the sweep's bf16-fcp builds ran no gather kernel"
    assert launches["topk_gallery"] > 0, "the sweep ran no top-k kernel"
    sweep_topk = launches["topk_gallery"]
    protocol_row = experiment_protocol(torch, ctx, count)
    assert launches["topk_gallery"] > sweep_topk, \
        "the protocol ran no top-k kernel"
    ctx["experiments"] = dict(sweep=sweep_row, protocol=protocol_row)
    emit("experiments", launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


# --- phase 20: the scale runs and the tutorials --------------------------------

# 17 train pieces of 3 performances make 100-step epochs (10,200
# entities); 6 pieces (36 steps an epoch) did not lift the validation MRR
# off chance in 3 epochs (PERF.md §6)
CAPSTONE_ARGV = ["--n_train_pieces", "17", "--n_eval_pieces", "4",
                 "--max_epochs", "3", "--n_test", "200", "--serving_ab",
                 "--compute_dtype", "bfloat16"]
CAPSTONE_KEYS = ["a2s", "a2s_refined", "cca_grad", "dtype", "entities",
                 "s2a", "s2a_refined", "serving_ab", "train_secs", "val_mrr",
                 "whitening"]
NOTEBOOKS = ("torch_Embedding_Tutorial.ipynb",
             "torch_Embedding_Tutorial_Audio_to_Audio.ipynb")
# the tutorial recording as AudioProcessor.process first turns it (mono,
# 22,050 Hz, int16), for a machine without libmpg123 to decode the mp3
# (tests/test_torch_notebooks.py holds it to the mp3's decode)
TUTORIAL_AUDIO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "golden", "tutorial_audio_22050.npz")
NOTEBOOK_CODES_ATOL = 1e-4
# the cont model's validation MRR read 0.0079, 0.0093, 0.0130, 0.0314 and
# 0.0084 over 5 epochs (chance 0.0075; PERF.md §6): it learns by
# epoch 4 and falls back at lr 2e-3, as the rehearsal's curve does until
# its first refinement restart
CONT_EPOCHS = 5


def chance_mrr(n: int) -> float:
    return float(np.mean(1.0 / np.arange(1, n + 1)))


def scale_capstone(torch, ctx, count) -> dict:
    """20a. ``scripts/torch_capstone.py``'s ``main`` at full width in bf16,
    cut to 6 train pieces of 3 performances, 4 eval pieces, 2 epochs, 200
    test samples, with ``--serving_ab``, under deterministic cuDNN: JAX's
    keys with every metric finite, the validation MRR above epoch 1's and
    twice chance (phase 11's criteria), the saved checkpoint read back by
    ``load_any_checkpoint`` embedding as the refined params the script
    served (1e-5), rank<=1 of both serving dtypes over 60 pieces."""
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        load_any_checkpoint,
    )
    from audio_sheet_retrieval_tpu_torch.train import engine

    cap = script_module("torch_capstone")
    dev = ctx["dev"]
    recs, served = [], []
    real_fit, real_acc = engine.fit, accuracy.piece_id_accuracy

    def fit(params, data, *args, **kw):
        recs.append(data["valid"].shape[0])
        return real_fit(params, data, *args, on_epoch=recs.append, **kw)

    def piece_id_accuracy(params, cfg, *args, **kw):
        served.append((params, cfg.compute_dtype))
        return real_acc(params, cfg, *args, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "refined.pkl")
        engine.fit, accuracy.piece_id_accuracy = fit, piece_id_accuracy
        t0 = time.perf_counter()
        try:
            with deterministic(torch):
                out, _ = count(lambda: quiet(lambda: cap.main(
                    CAPSTONE_ARGV + ["--save_ckpt", ckpt,
                                     "--device", str(dev)])))
        finally:
            engine.fit, accuracy.piece_id_accuracy = real_fit, real_acc
        seconds = time.perf_counter() - t0
        assert sorted(out) == CAPSTONE_KEYS, sorted(out)
        for key in ("s2a", "a2s", "s2a_refined", "a2s_refined"):
            assert sorted(out[key]) == ["MRR", "R@1", "R@25", "med_rank"]
            assert all(np.isfinite(v) for v in out[key].values()), out[key]
        n_va, recs = recs[0], recs[1:]
        epochs = int(CAPSTONE_ARGV[CAPSTONE_ARGV.index("--max_epochs") + 1])
        assert len(recs) == epochs, recs
        assert all(np.isfinite(r["train_loss"]) for r in recs), recs
        assert recs[-1]["map_va"] > recs[0]["map_va"], recs
        assert recs[-1]["map_va"] > 2 * chance_mrr(n_va), recs
        assert out["val_mrr"] == round(max(r["map_va"] for r in recs), 4)
        # the checkpoint file against the params the script served
        assert [d for _, d in served] == ["float32", "bfloat16"], served
        refined = served[0][0]
        loaded = load_any_checkpoint(ckpt, ctx["cfg"], device=dev)
        x1, x2 = ctx["valid_pool"][0:100]
        x1 = torch.from_numpy(x1).to(dev)
        x2 = torch.from_numpy(x2).to(dev)
        cfg = ctx["cfg"]
        for fn, x in ((cca_model.embed_view1,
                       engine.prepare_view1_device(x1, cfg)),
                      (cca_model.embed_view2,
                       engine.prepare_view2_device(x2))):
            err = float((fn(loaded, x, cfg) - fn(refined, x, cfg))
                        .abs().max())
            assert err <= 1e-5, err
    ab = out["serving_ab"]
    assert sorted(ab) == ["bfloat16", "float32"]
    assert all(ab[d]["n"] == 60 for d in ab), ab
    row = dict(seconds=seconds, argv=CAPSTONE_ARGV, entities=out["entities"],
               train_secs=out["train_secs"], val_mrr=out["val_mrr"],
               chance_mrr=chance_mrr(n_va),
               epochs=[dict(number=r["number"], train_loss=r["train_loss"],
                            map_va=r["map_va"],
                            updates_per_s=r["updates_per_s"])
                       for r in recs],
               s2a=out["s2a"], a2s=out["a2s"],
               s2a_refined=out["s2a_refined"],
               a2s_refined=out["a2s_refined"],
               serving_rank1={d: ab[d]["rank1"] for d in ab},
               serving_rank5={d: ab[d]["rank5"] for d in ab},
               checkpoint_reads_back=True)
    emit("scale", check="a. capstone", **row)
    return row


def tutorial_audio(read_audio, path):
    """``read_audio(path)`` of the tutorial mp3 where libmpg123 decodes it,
    else the committed decode of it (``TUTORIAL_AUDIO``) at 22,050 Hz ->
    (signal, rate, what was read)."""
    try:
        sig, sr = read_audio(path)
        return sig, sr, "mp3"
    except RuntimeError:
        with np.load(TUTORIAL_AUDIO) as z:
            return (z["signal"], int(z["sample_rate"]),
                    os.path.relpath(TUTORIAL_AUDIO, os.path.dirname(
                        os.path.abspath(__file__))))


def pyplot_stand_in():
    """A stand-in ``matplotlib`` for a machine without it, enough for the
    tutorial's plotting cell: ``imshow`` keeps the image and ``savefig``
    writes it as a gray PNG (``utils.image_io``, min to max over 0-255);
    labels and the colour bar are dropped -> {module name: module}."""
    import types

    from audio_sheet_retrieval_tpu_torch.utils.image_io import imwrite_gray

    shown = {}
    plt = types.ModuleType("matplotlib.pyplot")

    def imshow(img, **kw):
        shown["img"] = np.asarray(img, np.float64)

    def savefig(path, **kw):
        img = shown["img"]
        span = max(float(img.max() - img.min()), 1e-12)
        imwrite_gray(path, np.round(255 * (img - img.min()) / span)
                     .astype(np.uint8))

    plt.imshow, plt.savefig = imshow, savefig
    plt.xlabel = plt.ylabel = plt.colorbar = lambda *a, **k: None
    mpl = types.ModuleType("matplotlib")
    mpl.use = lambda *a, **k: None
    mpl.pyplot = plt
    return {"matplotlib": mpl, "matplotlib.pyplot": plt}


def run_notebook(name: str, device: str = "cuda") -> dict:
    """The notebook's code cells in one namespace, the first code cell's
    ``device = "cuda"`` set to ``device``, from a temporary working
    directory (the figure is saved there) -> the namespace."""
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.utils import audio_io

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tutorials", name)) as fp:
        cells = ["".join(c["source"]) for c in json.load(fp)["cells"]
                 if c["cell_type"] == "code"]
    assert cells[0].count('device = "cuda"') == 1
    cells[0] = cells[0].replace('device = "cuda"', f"device = {device!r}")
    ns, real = {}, audio_io.read_audio
    read = {}

    def read_audio(path):
        if path != assets.tutorial_audio_path():
            return real(path)
        sig, sr, read["audio"] = tutorial_audio(real, path)
        return sig, sr

    try:
        import matplotlib  # noqa: F401
        stand_in = {}
    except ImportError:
        stand_in = pyplot_stand_in()
    cwd = os.getcwd()
    audio_io.read_audio = read_audio
    sys.modules.update(stand_in)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            for i, cell in enumerate(cells):
                exec(compile(cell, f"{name}:cell{i}", "exec"), ns)
            ns["_figure_saved"] = os.path.exists("distances.png")
    finally:
        os.chdir(cwd)
        audio_io.read_audio = real
        for key in stand_in:
            del sys.modules[key]
    ns["_audio_read"] = read.get("audio")
    ns["_pyplot"] = "stand-in" if stand_in else "matplotlib"
    return ns


def scale_notebooks(torch, ctx, count) -> dict:
    """20b. Both tutorial notebooks' cells on the card with the CPU tests'
    thresholds (the path-versus-time correlation > 0.97; diagonal < 0.1 and
    off-diagonal > 0.5); the first 10 sheet and spectrogram codes within
    1e-4 of the port's CPU codes for the same snippets and excerpts."""
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.retrieval.server import (
        slice_windows,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        RetrievalWrapper,
    )

    rows = {}
    for name in NOTEBOOKS:
        t0 = time.perf_counter()
        ns, _ = count(lambda: quiet(lambda: run_notebook(
            name, str(ctx["dev"]))))
        seconds = time.perf_counter() - t0
        assert ns["wrapper"].device == ctx["dev"], ns["wrapper"].device
        cpu = RetrievalWrapper(ns["cfg"],
                               param_file=assets.tutorial_checkpoint_path(),
                               device="cpu")
        dists = ns["dists"]
        if "sheet_codes" in ns:
            am = np.argmin(dists, axis=0)
            corr = float(np.corrcoef(np.arange(dists.shape[1]), am)[0, 1])
            assert corr > 0.97, corr
            assert ns["_figure_saved"]
            pairs = ((ns["sheet_codes"][:10],
                      cpu.compute_view_1(ns["snippets"][:10])),
                     (ns["spec_codes"][:10],
                      cpu.compute_view_2(ns["excerpts"][:10])))
            row = dict(corr=corr, systems=len(ns["page_systems"]))
        else:
            diag = float(np.diag(dists).mean())
            offdiag = float(dists[~np.eye(len(dists), dtype=bool)].mean())
            assert diag < 0.1 and offdiag > 0.5, (diag, offdiag)
            pairs = ((ns["codes_a"][:10], cpu.compute_view_2(slice_windows(
                ns["spec"], 42, ns["starts"][:10]))),)
            row = dict(diag=diag, offdiag=offdiag)
        errs = [float(np.abs(card - host).max()) for card, host in pairs]
        assert max(errs) <= NOTEBOOK_CODES_ATOL, errs
        rows[name] = dict(row, seconds=seconds, codes_vs_cpu=errs,
                          audio=ns["_audio_read"], pyplot=ns["_pyplot"])
    emit("scale", check="b. notebooks", **rows)
    return rows


def scale_cont_fit(torch, ctx, count) -> dict:
    """20c. A ``CONT_EPOCHS``-epoch ``mutopia_ccal_cont`` fit (160 x 200
    sheet input, the ``cont`` arm of the schedule rehearsal) at full width
    over phase 11's pieces lifted onto device pools, under deterministic
    cuDNN: phase 11's thresholds held by the MRR of the params ``fit``
    returns (its best epoch: above epoch 1's and twice chance; the train
    loss falls), every epoch reported, and the step's updates/s."""
    from audio_sheet_retrieval_tpu_torch.data import device_pool as dp
    from audio_sheet_retrieval_tpu_torch.models import cca_model
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )
    from audio_sheet_retrieval_tpu_torch.train import engine

    dev = ctx["dev"]
    cfg = get_model_config("mutopia_ccal_cont", max_epochs=CONT_EPOCHS)
    host = ctx["train_data"]
    data = dict(host, train=dp.from_host_pool(
        host["train"], rng=np.random.default_rng(23), device=dev),
        valid=dp.from_host_pool(host["valid"], shuffle=False,
                                rng=np.random.default_rng(24), device=dev))
    recs, launches = [], {}

    def run():
        with tempfile.TemporaryDirectory() as tmp:
            out = engine.fit(
                cca_model.init_model(torch.Generator().manual_seed(23), cfg,
                                     device="cpu"),
                data, cfg,
                dp.DeviceBatchIterator(cfg.batch_size,
                                       k_samples=cfg.k_samples),
                dp.DeviceBatchIterator(cfg.batch_size, shuffle=False,
                                       train=False),
                device=dev, out_path=tmp, verbose=False,
                on_epoch=recs.append)
        launches.update(read_launches())
        return out

    t0 = time.perf_counter()
    with deterministic(torch):
        _, best_map = count(run)
    seconds = time.perf_counter() - t0
    n_va = data["valid"].shape[0]
    assert len(recs) == CONT_EPOCHS, recs
    assert all(np.isfinite(r["train_loss"]) for r in recs), recs
    assert recs[-1]["train_loss"] < recs[0]["train_loss"], recs
    assert best_map == max(r["map_va"] for r in recs), (best_map, recs)
    assert best_map > recs[0]["map_va"], recs
    assert best_map > 2 * chance_mrr(n_va), recs
    assert launches["topk_gallery"] >= 2 * CONT_EPOCHS, launches
    row = dict(model=cfg.name, seconds=seconds, best_map=best_map,
               chance_mrr=chance_mrr(n_va), valid=n_va,
               epochs=[dict(number=r["number"], train_loss=r["train_loss"],
                            map_va=r["map_va"], n_batches=r["n_batches"],
                            updates_per_s=r["updates_per_s"],
                            step_loop_s=r["loop_seconds"],
                            eval_s=r["eval_seconds"]) for r in recs])
    emit("scale", check="c. cont fit", **row)
    return row


def phase_scale(torch, ctx):
    """20. The scale runs and the tutorials, cut to a smoke run: a. the
    capstone script, b. both tutorial notebooks, c. a ``cont`` fit; each
    counted."""
    t_phase = time.perf_counter()
    launches = {name: 0 for name in read_launches()}
    count = launch_counter(launches)
    capstone = scale_capstone(torch, ctx, count)
    assert launches["topk_gallery"] > 0, "the capstone ran no top-k kernel"
    notebooks = scale_notebooks(torch, ctx, count)
    cont = scale_cont_fit(torch, ctx, count)
    ctx["scale"] = dict(capstone=capstone, notebooks=notebooks, cont=cont)
    emit("scale", launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


RANK_SCENARIOS = {"fit": rank_gloo, "nccl_fit": rank_nccl,
                  "gallery": rank_gallery}


def main() -> int:
    torch = require_cuda()
    smi = phase_device(torch)
    phase_build()
    kernel_stats = phase_kernels(torch)
    with tempfile.TemporaryDirectory() as reports_dir:
        ctx, launches = phase_serving(torch, reports_dir)
        for phase in (phase_s2a, phase_streaming, phase_audio,
                      phase_eval_refine, phase_train, phase_device_pool,
                      phase_precision, phase_default, phase_alignment,
                      phase_omr,
                      phase_reports, phase_mesh, phase_gallery,
                      phase_wire, phase_experiments, phase_scale):
            for name, n in phase(torch, ctx).items():
                launches[name] += n
    rows = []
    replaces = {"topk_gallery":
                "audio_sheet_retrieval_tpu/ops/topk_gallery.py:45",
                "gather_feature_windows":
                "audio_sheet_retrieval_tpu/ops/windows.py:84",
                "dtw": "audio_sheet_retrieval_tpu/ops/dtw.py:46",
                "rans_decode": "audio_sheet_retrieval_tpu/ops/rans.py:411",
                "rans_encode": "audio_sheet_retrieval_tpu/ops/rans.py:549"}
    sources = {"topk_gallery": "topk_gallery.cu",
               "gather_feature_windows": "feature_windows.cu",
               "dtw": "dtw.cu", "rans_decode": "rans.cu",
               "rans_encode": "rans.cu"}
    kernel_stats["dtw"] = dict(
        ctx["dtw_stats"], traceback_launches=launches["dtw_traceback"],
        note="replaces lax.scan loops (not Pallas): the accumulation "
        "audio_sheet_retrieval_tpu/ops/dtw.py:46, the traceback "
        "audio_sheet_retrieval_tpu/ops/dtw.py:94")
    launches["dtw"] = launches["dtw_accumulate"]
    kernel_stats["topk_gallery"]["db_shard"] = ctx["shard_topk"]
    # searches through the streaming pass 1 (phases 3-20)
    kernel_stats["topk_gallery"]["stream_launches"] = \
        launches["topk_gallery_stream"]
    # the rANS kernels: a JAX lax.scan each (not Pallas); the decode's
    # headline shape is the tutorial page's segments (phase 15's OMR
    # path), the encode's a map plane of that page
    wire = ctx["wire"]["kernels"]
    kernel_stats["rans_decode"] = dict(
        wire["decode"]["page_segments"], shapes=wire["decode"],
        note="replaces a lax.scan (not Pallas): "
        "audio_sheet_retrieval_tpu/ops/rans.py:411 _decode_batch_jit")
    kernel_stats["rans_encode"] = dict(
        wire["encode"]["map_plane"],
        note="replaces a lax.scan and sort (not Pallas): "
        "audio_sheet_retrieval_tpu/ops/rans.py:549 _encode_device_jit")
    for name, stats in kernel_stats.items():
        rows.append({"name": name, "route": "cuda",
                     "source": "audio_sheet_retrieval_tpu_torch/csrc/"
                     + sources[name],
                     "replaces": replaces[name], "launches": launches[name],
                     **stats})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:     # a rank process of 16-17
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(main())
