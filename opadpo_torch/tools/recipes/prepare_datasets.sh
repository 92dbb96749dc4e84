#!/usr/bin/env bash
# Dataset prep on the port (reference run/prepare_datasets.sh): RLAIF-V
# subsets (the source comes from the HF hub), then after the rollout the
# OPA / OPA-DPO training datasets.
set -euo pipefail

case "${1:-subsets}" in
  subsets)
    python -m opadpo_torch.pipeline.dataset_ops make-subsets \
        --source "${RLAIF_DATASET:-./base_datasets/RLAIF-V}" \
        --out-dir ./base_datasets/online_generation \
        --num-subsets 4 --subset-size 2500
    ;;
  opadpo)
    python -m opadpo_torch.pipeline.dataset_ops make-opadpo \
        --rollout-dirs ./output/llava7b_online_generation_subset1/rollouts \
                       ./output/llava7b_online_generation_subset2/rollouts \
        --opa-out ./base_datasets/opa_training_data-7B \
        --opadpo-out ./base_datasets/opadpo_training_data-7B
    ;;
  *)
    echo "usage: $0 [subsets|opadpo]" >&2; exit 1;;
esac
