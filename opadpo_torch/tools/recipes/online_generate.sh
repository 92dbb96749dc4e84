#!/usr/bin/env bash
# Stages 1-2 on the port: rollout + GPT-4V correction (reference
# run/online_generate.sh).  NPROC GPUs under torchrun, one data rank each
# (add mesh.model=2 for two-way tensor parallelism).
set -euo pipefail

export MODEL_DIR=${MODEL_DIR:-./base_models/llava-v1.5-7b}
export OUTPUT_DIR=${OUTPUT_DIR:-./output/llava7b_online_generation_subset1}
export DATA_DIR=${DATA_DIR:-./base_datasets/online_generation/subset1}
# GPT-4V endpoints: export API_NUM, API_KEY0..N, AZURE_POINT0..N

torchrun --nproc-per-node "${NPROC:-1}" -m opadpo_torch.pipeline.online_generation \
    --config configs/llava_online_generation.yaml \
    training.temperature=1.0 \
    training.top_k=30 \
    training.top_p=0.95 \
    training.query_len=128 \
    training.response_len=896 \
    training.rollout_per_device_batch_size=8 \
    "$@"
