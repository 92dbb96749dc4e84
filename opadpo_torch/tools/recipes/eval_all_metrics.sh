#!/usr/bin/env bash
# The 5-benchmark eval on the port (reference run/eval_all_metrics.sh),
# with stage 4's adapter.
set -euo pipefail

MODEL_DIR=${MODEL_DIR:-./base_models/llava-v1.5-7b}
ADAPTER=${ADAPTER:-./output/llava7b_opadpo_model/checkpoint-500/adapter_model/lora_policy}
EVAL_DATA=${EVAL_DATA:-./eval_data}
IMAGE_ROOT=${IMAGE_ROOT:-./coco/val2014}
OUT=${OUT:-./output/eval_results}

python -m opadpo_torch.eval.run_all \
    --model-path "$MODEL_DIR" \
    --adapter-path "$ADAPTER" \
    --data-root "$EVAL_DATA" \
    --image-root "$IMAGE_ROOT" \
    --output-dir "$OUT" \
    --benchmarks pope amber mmhal llava_bench objhal \
    "$@"
