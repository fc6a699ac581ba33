#!/bin/bash
# Train all four augmentation regimes for a split (reference:train_models.sh).
# usage: ./train_models.sh <data> <model> <split.yaml> [exp_root]
set -e
data=${1:-mutopia}
model=${2:-mutopia_ccal_cont_rsz}
split=$3
exp_root=${4:-${ASR_TPU_EXP_ROOT:-$HOME/experiments/asr_tpu}}
for config in mutopia_no_aug mutopia_sheet_aug mutopia_audio_aug mutopia_full_aug; do
    python -m audio_sheet_retrieval_tpu_torch.cli.run_train \
        --model "$model" --data "$data" --train_split "$split" \
        --config "exp_configs/${config}.yaml" --exp_root "$exp_root"
    python -m audio_sheet_retrieval_tpu_torch.cli.refine_cca \
        --model "$model" --data "$data" --train_split "$split" \
        --config "exp_configs/${config}.yaml" --exp_root "$exp_root" \
        --n_train 25000
done
