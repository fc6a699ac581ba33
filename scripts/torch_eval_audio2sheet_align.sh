#!/bin/bash
# Offline alignment for both aligners (reference:eval_audio2sheet_align.sh).
set -e
data=${1:-mutopia}
model=${2:-mutopia_ccal_cont_rsz}
split=$3
exp_root=${4:-${ASR_TPU_EXP_ROOT:-$HOME/experiments/asr_tpu}}
for align_by in baseline pydtw; do
    python -m audio_sheet_retrieval_tpu_torch.cli.audio2sheet_align \
        --model "$model" --data "$data" --train_split "$split" \
        --config exp_configs/mutopia_full_aug.yaml --exp_root "$exp_root" \
        --estimate_UV --align_by "$align_by" --dump_alignment
done
