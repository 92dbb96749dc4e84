#!/usr/bin/env bash
# Checkpoint bootstrap (reference run/prepare_basemodels.sh): fetch the
# CLIP vision tower and the LLaVA-1.5 checkpoints from the HF hub (needs
# the network), then point each base model's config at the local tower so
# the port's loader resolves it offline (pipeline/dataset_ops
# patch-model-config).
set -euo pipefail

BASE_DIR="${BASE_DIR:-./base_models}"
mkdir -p "$BASE_DIR"

hf_get() {
  local repo="$1" dest="$2"
  if [ -e "$dest/config.json" ] || [ -e "$dest/preprocessor_config.json" ]; then
    echo "skip $repo (already at $dest)"
    return
  fi
  huggingface-cli download "$repo" --repo-type model \
    --local-dir "$dest" --local-dir-use-symlinks False
}

hf_get openai/clip-vit-large-patch14-336 "$BASE_DIR/vision_tower-clip336"
hf_get liuhaotian/llava-v1.5-7b  "$BASE_DIR/llava-v1.5-7b"
if [ "${WITH_13B:-0}" = "1" ]; then
  hf_get liuhaotian/llava-v1.5-13b "$BASE_DIR/llava-v1.5-13b"
fi

for model in "$BASE_DIR"/llava-v1.5-*; do
  [ -d "$model" ] || continue
  python -m opadpo_torch.pipeline.dataset_ops patch-model-config \
    --model-dir "$model" \
    --image-checkpoint "$BASE_DIR/vision_tower-clip336"
done
echo "base models ready under $BASE_DIR"
