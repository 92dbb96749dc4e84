"""Batch collators (numpy) for the three data modules: copy of
``opadpo_tpu/data/collators.py``.

The DPO collator is the behavioral port of the reference's
``DataCollatorForCausalLM`` (``utils/data_utils_dpo.py:101-285``): it
re-tokenizes the GPT-4V sentence report per batch to produce *aligned*
``(response_ids, scores, image_relations)`` triples — the sentence-level
score ∈ {1..4} → weight {2.5, 2.0, 1.5, 1.0} and error-type → image
weight {3.0, 1.0} mappings drive the token-weighted DPO pairs.  Edge cases
preserved: ``complete_copied_content`` re-alignment, leading-space token
29871 stripping, EOS score inheritance, and the plain-tokenization
fallback on any exception.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from opadpo_torch.constants import (
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    LLAMA_IMAGE_GLYPH_TOKEN,
    LLAMA_SPACE_TOKEN,
)

SCORE_MAPPING = {1: 2.5, 2: 2.0, 3: 1.5, 4: 1.0}
ERROR_TYPE_MAPPING = {
    "image_recognition_error": 3.0,
    "correct": 1.0,
    "language_comprehension_error": 1.0,
}


def pad_and_stack(rows: Sequence[np.ndarray], pad_value, max_length=None,
                  dtype=None) -> np.ndarray:
    if max_length is None:
        max_length = max(len(r) for r in rows)
    dtype = dtype or rows[0].dtype
    out = np.full((len(rows), max_length), pad_value, dtype)
    for i, r in enumerate(rows):
        n = min(len(r), max_length)
        out[i, :n] = r[:n]
    return out


def complete_copied_content(original_string: str,
                            string_list: List[str]) -> List[str]:
    """Re-align the report's copied sentences against the actual generated
    response so dropped fragments re-attach (reference
    data_utils_dpo.py:56-73)."""
    fixed_list: List[str] = []
    remaining = original_string
    for s in string_list:
        trimmed = s.strip()
        if len(trimmed) > 0:
            pos = remaining.find(trimmed)
            if pos == -1:
                return string_list
            fixed_list.append(remaining[:pos + len(trimmed)].strip(" "))
            remaining = remaining[pos + len(trimmed):]
        else:
            fixed_list.append("")
    if fixed_list and remaining.strip():
        fixed_list[-1] += remaining.strip()
    return fixed_list


def add_eos_inplace(ids: np.ndarray, pad_id: int, eos_id: int) -> np.ndarray:
    """First pad of each row becomes EOS (reference add_eos)."""
    for row in ids:
        pads = np.nonzero(row == pad_id)[0]
        if pads.size:
            row[pads[0]] = eos_id
    return ids


def inherit_eos_score_inplace(resp: np.ndarray, scores: np.ndarray,
                              eos_id: int) -> np.ndarray:
    """EOS position inherits the previous token's weight (reference
    pad_eos, data_utils_dpo.py:90-99)."""
    for row_resp, row_score in zip(resp, scores):
        eos_pos = np.nonzero(row_resp == eos_id)[0]
        if eos_pos.size:
            p = eos_pos[0]
            prev = row_score[p - 1] if p > 0 and row_score[p - 1] != 0 else 1.0
            row_score[p] = prev
    return scores


def _get(report_entry: dict, *names, default=""):
    for n in names:
        if n in report_entry:
            return report_entry[n]
    return default


@dataclass
class DPOCollator:
    tokenizer: object
    query_len: int = 128
    response_len: int = 896
    detailed_report: bool = True

    def _tok(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer(text).input_ids, np.int64)

    def _encode_report(self, report: dict, original_response: str):
        """One sample's report → (orig_ids, ai_ids, orig_scores, ai_scores,
        orig_relations, ai_relations)."""
        report = {k: v for k, v in report.items()
                  if k not in ("image_description", "image description")}
        # re-align copied contents against the real generated response
        copied_list = [
            _get(report[k], "copied content", "copied_content") or ""
            for k in report
        ]
        completed = complete_copied_content(original_response, copied_list)
        for j, k in enumerate(report):
            if completed[j]:
                if "copied content" in report[k]:
                    report[k]["copied content"] = completed[j]
                elif "copied_content" in report[k]:
                    report[k]["copied_content"] = completed[j]

        orig_ids, ai_ids = [], []
        orig_sc, ai_sc, orig_rel, ai_rel = [], [], [], []
        count = 0
        for k in report:
            rewritten = self._tok(_get(report[k], "rewritten content",
                                       "rewritten_content"))
            if rewritten.size <= 1:
                rewritten = None
            elif count != 0:
                rewritten = rewritten[1:]      # drop BOS after first chunk

            copied = None
            if k != "Added":
                copied = self._tok(_get(report[k], "copied content",
                                        "copied_content"))
                if copied.size <= 1:
                    copied = None
                else:
                    if count != 0:
                        copied = copied[1:]
                    if copied.size and copied[0] == LLAMA_SPACE_TOKEN:
                        copied = copied[1:]
                score = report[k].get("score", 4)
                error_type = _get(report[k], "error type", "error_type",
                                  default="correct")
                s_w = SCORE_MAPPING.get(score, 1.0)
                r_w = ERROR_TYPE_MAPPING.get(error_type, 1.0)
                if copied is not None:
                    orig_ids.append(copied)
                    orig_sc.append(np.full(len(copied), s_w, np.float32))
                    orig_rel.append(np.full(len(copied), r_w, np.float32))
                if rewritten is not None:
                    ai_ids.append(rewritten)
                    ai_sc.append(np.full(len(rewritten), s_w, np.float32))
                    ai_rel.append(np.full(len(rewritten), r_w, np.float32))
            else:
                if rewritten is not None:
                    ai_ids.append(rewritten)
                    ai_sc.append(np.ones(len(rewritten), np.float32))
                    ai_rel.append(np.ones(len(rewritten), np.float32))
            count += 1

        return (np.concatenate(orig_ids), np.concatenate(ai_ids),
                np.concatenate(orig_sc), np.concatenate(ai_sc),
                np.concatenate(orig_rel), np.concatenate(ai_rel))

    def _plain_encode(self, texts: List[str]) -> Dict[str, np.ndarray]:
        self.tokenizer.padding_side = "right"
        enc = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=self.response_len)
        ids = np.asarray(enc.input_ids, np.int64)
        add_eos_inplace(ids, self.tokenizer.pad_token_id,
                        self.tokenizer.eos_token_id)
        return ids

    def __call__(self, instances: List[Dict]) -> Dict[str, np.ndarray]:
        pad_id = self.tokenizer.pad_token_id
        eos_id = self.tokenizer.eos_token_id
        queries = [inst["queries"] for inst in instances]
        images = np.stack([inst["images"] for inst in instances])
        standard = [inst["standard_response"] for inst in instances]
        original = [inst["original_generate_response"] for inst in instances]
        ai_pseudo = [inst["AI_pseudo_response"] for inst in instances]

        self.tokenizer.padding_side = "left"
        q_enc = self.tokenizer(queries, padding="max_length", truncation=True,
                               max_length=self.query_len)
        q_ids = np.asarray(q_enc.input_ids, np.int64)
        q_ids[q_ids == LLAMA_IMAGE_GLYPH_TOKEN] = IMAGE_TOKEN_INDEX
        q_mask = np.asarray(q_enc.attention_mask, np.int64)

        std_ids = self._plain_encode(standard)
        batch = {
            "queries": q_ids,
            "queries_attention_mask": q_mask,
            "standard_response": std_ids,
            "standard_response_attention_mask": (std_ids != pad_id).astype(np.int64),
            "images": images,
        }

        use_report = self.detailed_report
        if use_report:
            try:
                reports = [json.loads(inst["AI_json_report"])
                           for inst in instances]
                rows = [self._encode_report(r, orig)
                        for r, orig in zip(reports, original)]
                orig_ids = pad_and_stack([r[0] for r in rows], pad_id,
                                         self.response_len, np.int64)
                ai_ids = pad_and_stack([r[1] for r in rows], pad_id,
                                       self.response_len, np.int64)
                add_eos_inplace(orig_ids, pad_id, eos_id)
                add_eos_inplace(ai_ids, pad_id, eos_id)
                orig_sc = pad_and_stack([r[2] for r in rows], 0.0,
                                        self.response_len, np.float32)
                ai_sc = pad_and_stack([r[3] for r in rows], 0.0,
                                      self.response_len, np.float32)
                inherit_eos_score_inplace(ai_ids, ai_sc, eos_id)
                orig_rel = pad_and_stack([r[4] for r in rows], 0.0,
                                         self.response_len, np.float32)
                ai_rel = pad_and_stack([r[5] for r in rows], 0.0,
                                       self.response_len, np.float32)
                inherit_eos_score_inplace(ai_ids, ai_rel, eos_id)
                batch.update({
                    "original_generate_response": orig_ids,
                    "original_generate_response_attention_mask":
                        (orig_ids != pad_id).astype(np.int64),
                    "AI_pseudo_response": ai_ids,
                    "AI_pseudo_response_attention_mask":
                        (ai_ids != pad_id).astype(np.int64),
                    "original_generate_response_scores": orig_sc,
                    "AI_pseudo_response_scores": ai_sc,
                    "original_generate_response_image_relations": orig_rel,
                    "AI_pseudo_response_image_relations": ai_rel,
                })
                return batch
            except Exception as e:             # fallback path (reference :259-278)
                print(f"DPO collator report fallback: {e}")

        orig_ids = self._plain_encode(original)
        ai_ids = self._plain_encode(ai_pseudo)
        batch.update({
            "original_generate_response": orig_ids,
            "original_generate_response_attention_mask":
                (orig_ids != pad_id).astype(np.int64),
            "AI_pseudo_response": ai_ids,
            "AI_pseudo_response_attention_mask":
                (ai_ids != pad_id).astype(np.int64),
        })
        if use_report:
            zeros = np.zeros_like(orig_ids, np.float32)
            batch.update({
                "original_generate_response_scores": zeros,
                "AI_pseudo_response_scores": np.zeros_like(ai_ids, np.float32),
                "original_generate_response_image_relations": zeros,
                "AI_pseudo_response_image_relations":
                    np.zeros_like(ai_ids, np.float32),
            })
        return batch


@dataclass
class SFTCollator:
    """Right-padding collator for the OPA stage (reference
    utils/data_utils_sft.py:20-69)."""

    tokenizer: object

    def __call__(self, instances: List[Dict]) -> Dict[str, np.ndarray]:
        pad_id = self.tokenizer.pad_token_id
        ids = pad_and_stack([np.asarray(i["input_ids"]) for i in instances],
                            pad_id, dtype=np.int64)
        labels = pad_and_stack([np.asarray(i["labels"]) for i in instances],
                               IGNORE_INDEX, dtype=np.int64)
        images = np.stack([i["images"] for i in instances])
        mask = np.logical_or(ids != pad_id,
                             labels != IGNORE_INDEX).astype(np.int64)
        return {"input_ids": ids, "labels": labels, "attention_mask": mask,
                "images": images}


@dataclass
class QueryCollator:
    """Rollout query batches (reference data_utils_online_gpt4v.py:176-185):
    tensors stacked, metadata (paths/urls/raw bytes for the GPT-4V call)
    kept as lists."""

    tensor_keys = ("queries", "query_attn_masks", "images",
                   "standard_responses")

    def __call__(self, instances: List[Dict]) -> Dict:
        out: Dict = {}
        for key in instances[0]:
            vals = [inst[key] for inst in instances]
            if key in self.tensor_keys:
                out[key] = np.stack([np.asarray(v) for v in vals])
            else:
                out[key] = vals
        return out
