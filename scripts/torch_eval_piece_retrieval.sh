#!/bin/bash
# Piece identification in both directions (reference:eval_piece_retrieval.sh).
# usage: ./eval_piece_retrieval.sh <data> <model> <split.yaml> [exp_root]
set -e
data=${1:-mutopia}
model=${2:-mutopia_ccal_cont_rsz}
split=$3
exp_root=${4:-${ASR_TPU_EXP_ROOT:-$HOME/experiments/asr_tpu}}
for config in mutopia_no_aug mutopia_sheet_aug mutopia_audio_aug mutopia_full_aug; do
    python -m audio_sheet_retrieval_tpu_torch.cli.audio_sheet_server \
        --model "$model" --data "$data" --train_split "$split" \
        --config "exp_configs/${config}.yaml" --exp_root "$exp_root" \
        --init_sheet_db --full_eval --estimate_UV --dump_results \
        --n_candidates 25
    python -m audio_sheet_retrieval_tpu_torch.cli.sheet_audio_server \
        --model "$model" --data "$data" --train_split "$split" \
        --config "exp_configs/${config}.yaml" --exp_root "$exp_root" \
        --init_audio_db --full_eval --estimate_UV --dump_results \
        --n_candidates 25
done
