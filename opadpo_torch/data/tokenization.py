"""Tokenization: image-token splicing and conversation preprocessing with
assistant-only label masks.  Copy of ``opadpo_tpu/data/tokenization.py``
(LLaVA ``mm_utils`` semantics and the reference's ``preprocess_v1`` /
``preprocess_llama_2``, ``utils/common_utils.py:224-523``) on numpy.

The masking walk (split rounds on sep2, instruction_len - 2, initial
cur_len 1) is kept token for token: POPE/AMBER parity depends on the exact
token stream the GPU reference produced.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from opadpo_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from opadpo_torch.data import conversation as conversation_lib
from opadpo_torch.data.conversation import SeparatorStyle


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


def _tokenize_conversations(conversations: Sequence[str], tokenizer,
                            has_image: bool) -> np.ndarray:
    if has_image:
        rows = [tokenizer_image_token(p, tokenizer) for p in conversations]
        max_len = max(len(r) for r in rows)
        pad = tokenizer.pad_token_id or 0
        out = np.full((len(rows), max_len), pad, np.int64)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out
    enc = tokenizer(list(conversations), padding="longest",
                    max_length=tokenizer.model_max_length, truncation=True)
    return np.asarray(enc.input_ids, np.int64)


def _preprocess(conv, sep: str, sources, tokenizer, has_image: bool,
                mask_target: bool, query_len: Optional[int],
                response_len: Optional[int]) -> Dict:
    """Template ``sources`` with ``conv``, tokenize, and mask everything
    but the assistant turns (each round split at ``sep``, the separator
    that ends an instruction)."""
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    input_ids = _tokenize_conversations(conversations, tokenizer, has_image)
    targets = input_ids.copy()
    validity = [True] * len(input_ids)

    def count(text: str) -> int:
        if has_image:
            return len(tokenizer_image_token(text, tokenizer))
        return len(tokenizer(text).input_ids)

    for c, (conversation, target) in enumerate(zip(conversations, targets)):
        total_len = int((target != (tokenizer.pad_token_id or 0)).sum())
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        if mask_target:
            target[:cur_len] = IGNORE_INDEX
        final_query_len, final_response_len = 0, 0
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = count(rou)
            instruction_len = count(parts[0]) - 2
            if mask_target:
                target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            final_query_len = cur_len
            final_response_len = round_len
            cur_len += round_len
        if final_response_len == 0:
            raise ValueError(f"Empty response: {conversation}")
        validity[c] = (
            (query_len is None or final_query_len <= query_len)
            and (response_len is None or final_response_len <= response_len))
        if mask_target:
            target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            if mask_target:
                target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs {total_len}")

    return dict(input_ids=input_ids, labels=targets, validity=validity)


def preprocess_v1(sources, tokenizer, has_image: bool = False,
                  mask_target: bool = True, query_len: Optional[int] = None,
                  response_len: Optional[int] = None) -> Dict:
    """Vicuna-v1 templating + tokenization + assistant-only labels
    (reference common_utils.py:336-475)."""
    conv = conversation_lib.default_conversation.copy()
    assert conv.sep_style == SeparatorStyle.TWO
    return _preprocess(conv, conv.sep + conv.roles[1] + ": ", sources,
                       tokenizer, has_image, mask_target, query_len,
                       response_len)


def preprocess_llama_2(sources, tokenizer, has_image: bool = False,
                       mask_target: bool = True,
                       query_len: Optional[int] = None,
                       response_len: Optional[int] = None) -> Dict:
    """LLaMA-2 ``[INST]``-style templating (reference
    common_utils.py:224-333): the v1 walk with ``"[/INST] "`` ending each
    instruction and rounds delimited by ``</s>``."""
    conv = conversation_lib.conv_llava_llama_2.copy()
    assert conv.sep_style == SeparatorStyle.LLAMA_2
    return _preprocess(conv, "[/INST] ", sources, tokenizer, has_image,
                       mask_target, query_len, response_len)


def preprocess(sources, tokenizer, has_image: bool = False,
               mask_target: bool = True, query_len: Optional[int] = None,
               response_len: Optional[int] = None) -> Dict:
    """Dispatch on the active conversation template (reference
    common_utils.py:478-523: LLAMA_2 sep-style first, then v1)."""
    conv = conversation_lib.default_conversation
    if conv.sep_style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image=has_image,
                                  mask_target=mask_target,
                                  query_len=query_len,
                                  response_len=response_len)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image=has_image,
                             mask_target=mask_target, query_len=query_len,
                             response_len=response_len)
    raise NotImplementedError(conv.version)


def split_query_response(
    input_ids: np.ndarray,      # [B, L]
    labels: np.ndarray,         # [B, L] IGNORE outside response
    query_len: int,
    pad_token_id: int,
    assistant_tail: Sequence[int],
) -> Dict[str, np.ndarray]:
    """Left-pad queries to ``query_len`` / right-pad responses: the
    reference's ``slice_input_shift_pad`` (dpo_trainer.py:155-212),
    including the over-long-query repair that re-appends the
    " ASSISTANT: " tail (``:183-187``)."""
    b, max_len = input_ids.shape
    starts = [int(np.argmax(labels[i] != IGNORE_INDEX)) for i in range(b)]
    resp_len = max_len - min(starts)
    queries = np.zeros((b, query_len), input_ids.dtype)
    query_mask = np.zeros((b, query_len), np.int64)
    responses = np.zeros((b, resp_len), input_ids.dtype)
    tail = np.asarray(assistant_tail, input_ids.dtype)
    for i in range(b):
        qlen = starts[i]
        rest = max_len - qlen
        if qlen <= query_len:
            queries[i, -qlen:] = input_ids[i, :qlen]
            query_mask[i, -qlen:] = 1
        else:
            queries[i] = input_ids[i, :query_len]
            if IMAGE_TOKEN_INDEX not in input_ids[i, :query_len - 9]:
                queries[i, -9:] = np.concatenate(
                    [[IMAGE_TOKEN_INDEX], tail])
            else:
                queries[i, -8:] = tail
            query_mask[i] = 1
        responses[i, :rest] = input_ids[i, qlen:]
    return dict(queries=queries, query_attn_masks=query_mask,
                responses=responses)
