"""Dataset modules: rollout queries, OPA-SFT, OPA-DPO.  Port of
``opadpo_tpu/data/datasets.py``.

Same on-disk formats as the reference (HF ``datasets`` directories written
by ``base_operations/make_opadpo_dataset.py``): columns ``queries``,
``image_bytes``/``images``/``image_id``, ``standard_response``,
``AI_pseudo_response`` (+ ``original_generate_response``,
``AI_json_report`` for DPO).  A dataset here is anything with ``len`` and
integer indexing that gives such rows; the ``make_*_data_module``
functions read a directory with ``datasets.load_from_disk``.  Images go
through the PIL path (``image_processing.preprocess_image``); each
dataset decodes them in ``pixels``.
"""

from __future__ import annotations

import base64
import os
from typing import Dict, Optional

import numpy as np

from opadpo_torch.constants import DEFAULT_IMAGE_TOKEN
from opadpo_torch.data import conversation as conversation_lib
from opadpo_torch.data.collators import DPOCollator, QueryCollator, SFTCollator
from opadpo_torch.data.image_processing import preprocess_image
from opadpo_torch.data.tokenization import preprocess, tokenizer_image_token


def _image_source(item: Dict, image_dir: Optional[str] = None):
    """Raw image source (path or encoded bytes) for a dataset row."""
    for key in ("images", "image_id"):
        src = item.get(key)
        if isinstance(src, str) and src:
            path = os.path.join(image_dir, src) if image_dir else src
            if os.path.exists(path):
                return path
    if item.get("image_bytes"):
        raw = item["image_bytes"]
        if isinstance(raw, str):
            raw = base64.b64decode(raw.encode("utf-8"))
        return raw
    raise ValueError("No image found in dataset item")


class _ImageRows:
    """Rows of ``dataset`` with their images decoded by ``pixels``."""

    def __init__(self, dataset, image_dir: Optional[str] = None,
                 image_size: int = 336):
        self.dataset = dataset
        self.image_dir = image_dir
        self.image_size = image_size

    def __len__(self):
        return len(self.dataset)

    def pixels(self, item: Dict) -> np.ndarray:
        """The row's image, CLIP-preprocessed: f32 [size, size, 3]."""
        return preprocess_image(_image_source(item, self.image_dir),
                                size=self.image_size)


class DPODataset(_ImageRows):
    """Reference ``DPO_Dataset`` (utils/data_utils_dpo.py:287-350): rebuilds
    the query from the fixed vicuna template with the '图 ' glyph standing
    in for ``<image>``, CLIP-preprocesses the image."""

    def __getitem__(self, idx: int) -> Dict:
        item = self.dataset[int(idx)]
        query = (conversation_lib.DPO_QUERY_PREFIX
                 + item["queries"].replace(DEFAULT_IMAGE_TOKEN, "图 ")
                 + conversation_lib.DPO_QUERY_SUFFIX)
        return {
            "queries": query,
            "images": self.pixels(item),
            "standard_response": item["standard_response"],
            "original_generate_response": item["original_generate_response"],
            "AI_pseudo_response": item["AI_pseudo_response"],
            "AI_json_report": item["AI_json_report"],
        }


class SFTDataset(_ImageRows):
    """Reference ``make_sft_data_module`` semantics
    (utils/data_utils_sft.py:218-296): every example yields BOTH the GT
    ("standard") and the GPT-4V-corrected ("AI_pseudo") response as SFT
    targets, as a virtual 2x-length dataset."""

    def __init__(self, dataset, tokenizer, image_dir: Optional[str] = None,
                 query_len: int = 128, response_len: int = 896,
                 image_size: int = 336):
        super().__init__(dataset, image_dir, image_size)
        self.tokenizer = tokenizer
        self.query_len = query_len
        self.response_len = response_len

    def __len__(self):
        return 2 * len(self.dataset)

    def __getitem__(self, idx: int) -> Dict:
        base_idx, which = divmod(int(idx), 2)
        item = self.dataset[base_idx]
        response_key = ("standard_response" if which == 0
                        else "AI_pseudo_response")
        query = item["queries"]
        if DEFAULT_IMAGE_TOKEN not in query:
            query = DEFAULT_IMAGE_TOKEN + "\n" + query
        source = [
            {"from": "human", "value": query},
            {"from": "gpt", "value": item[response_key]},
        ]
        enc = preprocess([source], self.tokenizer, has_image=True,
                         query_len=self.query_len,
                         response_len=self.response_len)
        return {
            "input_ids": enc["input_ids"][0],
            "labels": enc["labels"][0],
            "images": self.pixels(item),
            "validity": enc["validity"][0],
        }


class QueryDataset(_ImageRows):
    """Rollout prompt dataset (reference ``QueryResponseDataset``,
    utils/data_utils_online_gpt4v.py:36-173): left-padded templated
    queries + image payloads for the GPT-4V correction call."""

    def __init__(self, dataset, tokenizer, image_dir: Optional[str] = None,
                 query_len: int = 128, image_size: int = 336):
        super().__init__(dataset, image_dir, image_size)
        self.tokenizer = tokenizer
        self.query_len = query_len

    def __getitem__(self, idx: int) -> Dict:
        item = self.dataset[int(idx)]
        query = item["queries"] if "queries" in item else item["question"]
        if DEFAULT_IMAGE_TOKEN not in query:
            query = DEFAULT_IMAGE_TOKEN + "\n" + query
        conv = conversation_lib.default_conversation.copy()
        conv.append_message(conv.roles[0], query)
        conv.append_message(conv.roles[1], None)
        ids = np.asarray(tokenizer_image_token(conv.get_prompt(),
                                               self.tokenizer), np.int64)
        qlen = self.query_len
        queries = np.zeros(qlen, np.int64)
        mask = np.zeros(qlen, np.int64)
        n = min(len(ids), qlen)
        queries[-n:] = ids[-n:] if len(ids) > qlen else ids
        mask[-n:] = 1
        return {
            "queries": queries,
            "query_attn_masks": mask,
            "images": self.pixels(item),
            "standard_responses": np.zeros(1, np.int64),
            "query_text": item.get("queries", query),
            "standard_response_text": item.get("standard_response", ""),
            "image_bytes": item.get("image_bytes", ""),
            "image_id": item.get("image_id", item.get("images", "")),
        }


# ---------------------------------------------------------------------------
# data-module factories (reference make_*_data_module signatures)
# ---------------------------------------------------------------------------

def _load_from_disk(data_path: str):
    try:
        from datasets import load_from_disk
    except ImportError as e:
        raise ImportError(
            "reading a dataset directory needs the HF datasets package, "
            "which is not installed; build the data module from rows "
            "instead (DPODataset(rows), DPOCollator(tokenizer))") from e
    return load_from_disk(data_path)


def make_dpo_data_module(tokenizer, data_path: str,
                         image_dir: Optional[str] = None,
                         query_len: int = 128, response_len: int = 896,
                         detailed_report: bool = True,
                         image_size: int = 336) -> Dict:
    return dict(
        train_dataset=DPODataset(_load_from_disk(data_path),
                                 image_dir=image_dir, image_size=image_size),
        eval_dataset=None,
        data_collator=DPOCollator(tokenizer=tokenizer, query_len=query_len,
                                  response_len=response_len,
                                  detailed_report=detailed_report),
    )


def make_sft_data_module(tokenizer, data_path: str,
                         image_dir: Optional[str] = None,
                         query_len: int = 128, response_len: int = 896,
                         image_size: int = 336) -> Dict:
    return dict(
        train_dataset=SFTDataset(_load_from_disk(data_path), tokenizer,
                                 image_dir=image_dir, query_len=query_len,
                                 response_len=response_len,
                                 image_size=image_size),
        eval_dataset=None,
        data_collator=SFTCollator(tokenizer=tokenizer),
    )


def make_rollout_data_module(tokenizer, data_path: str,
                             image_dir: Optional[str] = None,
                             query_len: int = 128,
                             image_size: int = 336) -> Dict:
    return dict(
        train_dataset=QueryDataset(_load_from_disk(data_path), tokenizer,
                                   image_dir=image_dir, query_len=query_len,
                                   image_size=image_size),
        eval_dataset=None,
        data_collator=QueryCollator(),
    )
