"""Character-level tokenizer with the HF surface the data layer uses: the
port's copy of the test suite's fake tokenizer (``debug.tiny`` and
``debug.fake_tokenizer`` runs of the stage-4 driver use it).

Prefix-consistent (the token stream of a concatenation is the
concatenation of the streams, after BOS handling), so the preprocess_v1
masking walk behaves as it does with sentencepiece.  '图' maps to the
LLaMA glyph id that the DPO collator remaps to the image token.
"""

from __future__ import annotations

import re
from typing import List, Union

import numpy as np

from opadpo_torch.constants import LLAMA_IMAGE_GLYPH_TOKEN


class Encoding:
    def __init__(self, input_ids, attention_mask):
        self.input_ids = input_ids
        self.attention_mask = attention_mask

    def __getitem__(self, key):
        return getattr(self, key)


class CharTokenizer:
    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    unk_token_id = 3
    model_max_length = 2048
    padding_side = "right"

    OFFSET = 10  # char ids start here so specials stay distinct

    def _encode_one(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = []
        # sentencepiece-style: special token strings collapse to one id
        for part in re.split(r"(</s>|<s>)", text):
            if part == "</s>":
                ids.append(self.eos_token_id)
            elif part == "<s>":
                ids.append(self.bos_token_id)
            else:
                ids.extend(LLAMA_IMAGE_GLYPH_TOKEN if c == "图"
                           else self.OFFSET + (ord(c) % 500) for c in part)
        return ([self.bos_token_id] + ids) if add_bos else ids

    def __call__(self, text: Union[str, List[str]], padding=None,
                 truncation=False, max_length=None, return_tensors=None,
                 add_special_tokens=True):
        if isinstance(text, str):
            ids = self._encode_one(text, add_bos=add_special_tokens)
            if truncation and max_length:
                ids = ids[:max_length]
            return Encoding(ids, [1] * len(ids))

        rows = [self._encode_one(t, add_bos=add_special_tokens) for t in text]
        if truncation and max_length:
            rows = [r[:max_length] for r in rows]
        width = (max_length if padding == "max_length"
                 else max(len(r) for r in rows))
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            n = min(len(r), width)
            if self.padding_side == "left":
                ids[i, width - n:] = r[:n]
                mask[i, width - n:] = 1
            else:
                ids[i, :n] = r[:n]
                mask[i, :n] = 1
        return Encoding(ids, mask)

    def encode(self, text, add_special_tokens=True):
        return self._encode_one(text, add_bos=add_special_tokens)

    def decode(self, ids, skip_special_tokens=True):
        chars = []
        for t in ids:
            t = int(t)
            if t >= self.OFFSET:
                chars.append(chr((t - self.OFFSET) % 500))
            elif not skip_special_tokens:
                chars.append(f"<{t}>")
        return "".join(chars)

    def batch_decode(self, rows, skip_special_tokens=True):
        return [self.decode(r, skip_special_tokens) for r in rows]
