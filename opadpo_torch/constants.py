"""Model/pipeline constants.

Mirrors the reference's ``utils/constants.py:26-34`` so datasets, collators
and checkpoints stay interchangeable.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# Llama/Vicuna tokenizer facts the reference hard-codes and asserts on
# (reference dpo_trainer.py:276-280, slice_input_shift_pad at
# dpo_trainer.py:185-187, data_utils_dpo.py:121).
LLAMA_QMARK_TOKEN = 1577          # tokenizer.encode("?")[0] (no specials)
LLAMA_NL_QMARK_TOKEN = 29973      # tokenizer.encode("\n?")[-1]
LLAMA_SPACE_TOKEN = 29871
LLAMA_PERIOD_TOKEN = 29889
LLAMA_IMAGE_GLYPH_TOKEN = 30861   # '图' — placeholder glyph remapped to IMAGE_TOKEN_INDEX
# " ASSISTANT: " tail used to repair over-long queries
# (reference dpo_trainer.py:185-187).
ASSISTANT_TAIL_TOKENS = (29889, 29871, 319, 1799, 9047, 13566, 29901, 29871)

# Sequence-budget defaults (reference run/train_opa_dpo.sh:126-128 and
# run/online_generate.sh:110-111).
DEFAULT_QUERY_LEN = 128
DEFAULT_RESPONSE_LEN = 896
DEFAULT_MODEL_MAX_LENGTH = 2048

# CLIP-ViT-L/14-336 vision geometry (reference §2.9: 576 patch tokens).
CLIP_IMAGE_SIZE = 336
CLIP_PATCH_SIZE = 14
NUM_IMAGE_PATCHES = (CLIP_IMAGE_SIZE // CLIP_PATCH_SIZE) ** 2  # 576
