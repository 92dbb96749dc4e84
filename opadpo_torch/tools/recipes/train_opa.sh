#!/usr/bin/env bash
# Stage 3 on the port: OPA LoRA-SFT (reference run/train_opa.sh recipe).
# NPROC GPUs under torchrun (data parallel with ZeRO-1).
set -euo pipefail

export MODEL_DIR=${MODEL_DIR:-./base_models/llava-v1.5-7b}
export OUTPUT_DIR=${OUTPUT_DIR:-./output/llava7b_opa_model}
export DATA_DIR=${DATA_DIR:-./base_datasets/opa_training_data-7B}

torchrun --nproc-per-node "${NPROC:-1}" -m opadpo_torch.pipeline.opa_train \
    --config configs/llava_opa.yaml \
    training.lora_r=256 \
    training.lora_alpha=512 \
    training.tune_vision_tower=true \
    training.per_device_train_batch_size=4 \
    training.gradient_accumulation_steps=8 \
    training.num_train_epochs=2 \
    training.learning_rate=2e-5 \
    training.lr_scheduler_type=cosine \
    "$@"
