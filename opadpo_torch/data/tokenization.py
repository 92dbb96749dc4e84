"""Image-token splicing at tokenization: copy of
``opadpo_tpu/data/tokenization.tokenizer_image_token`` (LLaVA ``mm_utils``
semantics)."""

from __future__ import annotations

from typing import List

from opadpo_torch.constants import IMAGE_TOKEN_INDEX


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """Tokenize a prompt containing ``<image>`` markers, inserting
    ``image_token_index`` at each marker."""
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    input_ids: List[int] = []
    offset = 0
    if (chunks and chunks[0] and tokenizer.bos_token_id is not None
            and chunks[0][0] == tokenizer.bos_token_id):
        offset = 1
        input_ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, chunk in enumerate(chunks):
        merged.append(chunk)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        input_ids.extend(x[offset:])
    return input_ids
