#!/bin/bash
# Dataset-size sweep: train + refine at 10/25/50/75/100% of the training
# pieces (reference:train_models_dset_size.sh — there via
# bach_split_{10,25,50,75} subset yamls; here via --max_train_pieces and
# --tag so artifacts land under the reference's split-name convention that
# `reports dset-size` aggregates).
# usage: ./train_models_dset_size.sh <data> <model> <n_pieces_100pct> [split.yaml] [exp_root]
set -e
data=${1:-synthetic}
model=${2:-mutopia_ccal_cont_rsz}
total=${3:-40}
split=$4
exp_root=${5:-${ASR_TPU_EXP_ROOT:-$HOME/experiments/asr_tpu}}
split_args=()
[ -n "$split" ] && split_args=(--train_split "$split")
for pct in 10 25 50 75 100; do
    n=$(( total * pct / 100 ))
    if [ "$pct" = 100 ]; then tag="all_split_mutopia_no_aug";
    else tag="all_split_${pct}_mutopia_no_aug"; fi
    python -m audio_sheet_retrieval_tpu_torch.cli.run_train \
        --model "$model" --data "$data" "${split_args[@]}" \
        --config exp_configs/mutopia_no_aug.yaml --exp_root "$exp_root" \
        --max_train_pieces "$n" --tag "$tag"
    python -m audio_sheet_retrieval_tpu_torch.cli.refine_cca \
        --model "$model" --data "$data" "${split_args[@]}" \
        --config exp_configs/mutopia_no_aug.yaml --exp_root "$exp_root" \
        --max_train_pieces "$n" --tag "$tag" --n_train 25000
done
