#!/bin/bash
# Dataset-size sweep evaluation (reference:eval_models_dset_size.sh):
# refined-projection A2S eval per training-set fraction, then the
# aggregated MRR-vs-size table via `reports dset-size`.
# usage: ./eval_models_dset_size.sh <data> <model> [split.yaml] [exp_root]
set -e
data=${1:-synthetic}
model=${2:-mutopia_ccal_cont_rsz}
split=$3
exp_root=${4:-${ASR_TPU_EXP_ROOT:-$HOME/experiments/asr_tpu}}
split_args=()
[ -n "$split" ] && split_args=(--train_split "$split")
for pct in 10 25 50 75 100; do
    if [ "$pct" = 100 ]; then tag="all_split_mutopia_no_aug";
    else tag="all_split_${pct}_mutopia_no_aug"; fi
    python -m audio_sheet_retrieval_tpu_torch.cli.run_eval \
        --model "$model" --data "$data" "${split_args[@]}" \
        --config exp_configs/mutopia_no_aug.yaml --exp_root "$exp_root" \
        --tag "$tag" --estimate_UV --dump_results --n_test 2000 --V2_to_V1
done
python -m audio_sheet_retrieval_tpu_torch.cli.reports dset-size \
    --out_path "$exp_root/${model}_est_UV"
