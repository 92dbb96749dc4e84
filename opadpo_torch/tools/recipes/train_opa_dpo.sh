#!/usr/bin/env bash
# Stage 4 on the port: OPA-DPO (reference run/train_opa_dpo.sh recipe),
# from stage 3's adapter.  NPROC GPUs under torchrun.
set -euo pipefail

export MODEL_DIR=${MODEL_DIR:-./base_models/llava-v1.5-7b}
export OUTPUT_DIR=${OUTPUT_DIR:-./output/llava7b_opadpo_model}
export DATA_DIR=${DATA_DIR:-./base_datasets/opadpo_training_data-7B}
export POLICY_LORA_DIR=${POLICY_LORA_DIR:-./output/llava7b_opa_model/checkpoint-final/adapter_model/lora_policy}

torchrun --nproc-per-node "${NPROC:-1}" -m opadpo_torch.pipeline.opadpo_train \
    --config configs/llava_dpo.yaml \
    training.lora_r=256 \
    training.lora_alpha=512 \
    training.learning_rate=1e-6 \
    training.total_epochs=4 \
    training.warmup_steps=5 \
    training.max_step=500 \
    training.rollout_batch_size=64 \
    training.step_batch_size=32 \
    training.rollout_per_device_batch_size=2 \
    training.step_per_device_batch_size=2 \
    training.noptepochs=1 \
    training.beta=0.1 \
    training.CoPO=true \
    training.CoPO_mask_ratio=0.3 \
    training.CoPO_method=random \
    training.CoPO_coef=0.2 \
    training.AncPO=true \
    training.mDPO_anchor=true \
    training.Anchor_coef=1.0 \
    "$@"
