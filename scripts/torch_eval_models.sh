#!/bin/bash
# Evaluate snippet retrieval for all regimes/directions (reference:eval_models.sh).
# usage: ./eval_models.sh <data> <model> <split.yaml> [exp_root]
set -e
data=${1:-mutopia}
model=${2:-mutopia_ccal_cont_rsz}
split=$3
exp_root=${4:-${ASR_TPU_EXP_ROOT:-$HOME/experiments/asr_tpu}}
for config in mutopia_no_aug mutopia_sheet_aug mutopia_audio_aug mutopia_full_aug; do
    for dir_flag in "" "--V2_to_V1"; do
        python -m audio_sheet_retrieval_tpu_torch.cli.run_eval \
            --model "$model" --data "$data" --train_split "$split" \
            --config "exp_configs/${config}.yaml" --exp_root "$exp_root" \
            --n_test 2000 --estimate_UV --dump_results $dir_flag
    done
done
