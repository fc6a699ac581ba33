#!/bin/bash
# UMC piece-retrieval sweep (reference:eval_piece_retrieval_umc.sh):
# both directions x {synthesized, --real_perf} performances on a real-data
# directory, then the aggregated rank table via `reports
# umc-piece-retrieval`.
# usage: ./eval_piece_retrieval_umc.sh <data_dir> [model] [split.yaml] [config.yaml] [exp_root]
# env:   ASR_UMC_PARAM_FILE  use an explicit checkpoint instead of the
#        trained-experiment convention (results then land in the cwd)
set -e
data_dir=$1
model=${2:-mutopia_ccal_cont_rsz}
split=${3:-all_split.yaml}
config=${4:-exp_configs/mutopia_full_aug.yaml}
exp_root=${5:-${ASR_TPU_EXP_ROOT:-$HOME/experiments/asr_tpu}}
[ -z "$data_dir" ] && { echo "usage: $0 <data_dir> [model] [split] [config] [exp_root]" >&2; exit 2; }

param_args=(--estimate_UV --train_split "$split" --config "$config" \
            --exp_root "$exp_root")
report_path="$exp_root/${model}_est_UV"
if [ -n "$ASR_UMC_PARAM_FILE" ]; then
    param_args=(--param_file "$ASR_UMC_PARAM_FILE")
    report_path=${ASR_UMC_REPORT_PATH:-.}
fi

db_dir=$(mktemp -d)
trap 'rm -rf "$db_dir"' EXIT
for real in "" "--real_perf"; do
    python -m audio_sheet_retrieval_tpu_torch.cli.umc_s2a_server \
        --model "$model" --data_dir "$data_dir" --dump_results \
        --init_audio_db --full_eval --device_db \
        --db_file "$db_dir/umc_audio_db_file.pkl" \
        "${param_args[@]}" $real
    python -m audio_sheet_retrieval_tpu_torch.cli.umc_a2s_server \
        --model "$model" --data_dir "$data_dir" --dump_results \
        --init_sheet_db --full_eval --device_db \
        --db_file "$db_dir/umc_sheet_db_file.pkl" \
        "${param_args[@]}" $real
done
python -m audio_sheet_retrieval_tpu_torch.cli.reports umc-piece-retrieval \
    --out_path "$report_path" --dset "$(basename "$data_dir")"
