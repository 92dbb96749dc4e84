"""Dataset construction (reference ``base_operations/``): copy of
``opadpo_tpu/pipeline/dataset_ops.py``.

- ``build_online_generation_subsets``: RLAIF-V prompt pool -> stratified
  4 x 2500 subsets (reference make_online_generation_dataset.py:10-50).
- ``build_opadpo_datasets``: merge rollout JSON shards from one or more
  run directories, apply the three quality filters (empty report,
  degenerate repetition, empty pseudo response), and write the OPA and
  OPA-DPO HF datasets (reference make_opadpo_dataset.py:19-128), with the
  reference's columns (``opa_columns``, ``opadpo_columns``), so either
  package's training stages read either's data.

The dataset writers import ``datasets`` inside the call; everything up to
the columns needs only the standard library.

    python -m opadpo_torch.pipeline.dataset_ops make-opadpo \\
        --rollout-dirs <run>/rollouts --opa-out <dir> --opadpo-out <dir>
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Sequence


def _shard_sort_key(file_name: str):
    nums = re.findall(r"\d+", file_name)
    return (int(nums[0]), int(nums[1])) if len(nums) >= 2 else (0, 0)


def load_rollout_shards(json_dir: str) -> List[Dict]:
    out: List[Dict] = []
    for name in sorted(os.listdir(json_dir), key=_shard_sort_key):
        if name.endswith(".json"):
            with open(os.path.join(json_dir, name), encoding="utf-8") as f:
                out.extend(json.load(f))
    return out


def has_repeating_last_sentence(text: str) -> bool:
    """Degenerate-generation filter 2a (reference :19-28): the response's
    final sentence already appears earlier."""
    sentences = text.split(".")
    if len(sentences) < 2:
        return False
    last = sentences[-2].strip()
    rest = ".".join(sentences[:-2])
    return last in rest


def has_repeating_last_word(text: str) -> bool:
    """Filter 2b (reference :31-37): the last word repeated > 30 times."""
    words = text.split()
    if len(words) < 2:
        return False
    return words[:-2].count(words[-1].strip()) > 30


def _normalize_query(query: str) -> str:
    """Strip the rendered conversation prefix back to '<image>\\n<question>'
    (reference :80-83)."""
    marker = "USER:  \n"
    if marker in query:
        query = query[query.find(marker) + len(marker):]
        query = "<image>\n" + query
    return query


def merge_and_filter(json_dirs: Sequence[str]) -> List[Dict]:
    merged: List[Dict] = []
    for d in json_dirs:
        if os.path.isdir(d):
            merged.extend(load_rollout_shards(d))
        else:
            print(f"Directory {d} does not exist.")
    original = len(merged)

    for item in merged:
        report = item.get("AI_json_report", "")
        if not isinstance(report, str):
            item["AI_json_report"] = json.dumps(report, ensure_ascii=False,
                                                indent=4)
        item["query"] = _normalize_query(item.get("query", ""))

    data = [x for x in merged
            if x.get("AI_json_report") not in ("", '""', None)]
    n1 = len(data)
    data = [x for x in data
            if not has_repeating_last_sentence(x["original_generate_response"])
            and not has_repeating_last_word(x["original_generate_response"])]
    n2 = len(data)
    data = [x for x in data
            if isinstance(x.get("AI_pseudo_response", ""), str)
            and len(x.get("AI_pseudo_response", "")) > 0]
    print(f"merge_and_filter: {original} -> empty-report {n1} -> "
          f"degenerate {n2} -> empty-pseudo {len(data)}")
    return data


def _datasets():
    try:
        import datasets
    except ImportError as e:
        raise ImportError(
            "writing or reading a dataset directory needs the HF datasets "
            "package, which is not installed; merge_and_filter and "
            "opa_columns give the rows without it") from e
    return datasets


def opa_columns(data: List[Dict]) -> Dict[str, list]:
    """The OPA (stage-3) dataset's columns of merged rollout records."""
    return {
        "queries": [x["query"] for x in data],
        "image_bytes": [x["image_bytes"] for x in data],
        "standard_response": [x["standard_response"] for x in data],
        "AI_pseudo_response": [x["AI_pseudo_response"] for x in data],
    }


def opadpo_columns(data: List[Dict]) -> Dict[str, list]:
    """The OPA-DPO (stage-4) dataset's columns: the OPA ones, the sampled
    response and the GPT-4V report."""
    return {
        **opa_columns(data),
        "original_generate_response": [x["original_generate_response"]
                                       for x in data],
        "AI_json_report": [x["AI_json_report"] for x in data],
    }


def build_opadpo_datasets(json_dirs: Sequence[str], opa_path: str,
                          opadpo_path: str) -> None:
    Dataset = _datasets().Dataset

    data = merge_and_filter(json_dirs)
    for path in (opa_path, opadpo_path):
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Dataset.from_dict(opa_columns(data)).save_to_disk(opa_path)
    Dataset.from_dict(opadpo_columns(data)).save_to_disk(opadpo_path)
    print(f"wrote {opa_path} and {opadpo_path} ({len(data)} rows)")


def build_online_generation_subsets(source_dataset_path: str, out_dir: str,
                                    num_subsets: int = 4,
                                    subset_size: int = 2500,
                                    seed: int = 42) -> None:
    """Stratified subsets of the RLAIF-V prompt pool (reference
    make_online_generation_dataset.py: stratify by origin dataset)."""
    import numpy as np

    ds = _datasets().load_from_disk(source_dataset_path)
    strata_key = "origin_dataset" if "origin_dataset" in ds.column_names \
        else None
    rng = np.random.default_rng(seed)
    idx = np.arange(len(ds))
    if strata_key:
        order = []
        labels = np.asarray(ds[strata_key])
        for lab in np.unique(labels):
            sub = idx[labels == lab]
            rng.shuffle(sub)
            order.append(sub)
        # interleave strata round-robin so every subset is stratified
        interleaved = []
        ptrs = [0] * len(order)
        while any(p < len(o) for p, o in zip(ptrs, order)):
            for s, o in enumerate(order):
                if ptrs[s] < len(o):
                    interleaved.append(o[ptrs[s]])
                    ptrs[s] += 1
        idx = np.asarray(interleaved)
    else:
        rng.shuffle(idx)

    for k in range(num_subsets):
        sel = idx[k * subset_size:(k + 1) * subset_size]
        ds.select(sel).save_to_disk(
            os.path.join(out_dir, f"subset{k + 1}"))
    print(f"wrote {num_subsets} subsets of {subset_size} to {out_dir}")


def patch_model_config(model_dir: str, image_checkpoint: str) -> None:
    """Point a base checkpoint's config at a local CLIP tower (reference
    base_operations/modify_base_model_config.py:2-19)."""
    path = os.path.join(model_dir, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["mm_vision_tower"] = image_checkpoint
    cfg["image_checkpoint"] = image_checkpoint
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"patched {path} -> vision tower {image_checkpoint}")


def main():
    import argparse
    p = argparse.ArgumentParser(description="dataset construction")
    sub = p.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make-opadpo")
    mk.add_argument("--rollout-dirs", nargs="+", required=True)
    mk.add_argument("--opa-out", required=True)
    mk.add_argument("--opadpo-out", required=True)
    gen = sub.add_parser("make-subsets")
    gen.add_argument("--source", required=True)
    gen.add_argument("--out-dir", required=True)
    gen.add_argument("--num-subsets", type=int, default=4)
    gen.add_argument("--subset-size", type=int, default=2500)
    pc = sub.add_parser("patch-model-config")
    pc.add_argument("--model-dir", required=True)
    pc.add_argument("--image-checkpoint", required=True)
    args = p.parse_args()
    if args.cmd == "make-opadpo":
        build_opadpo_datasets(args.rollout_dirs, args.opa_out,
                              args.opadpo_out)
    elif args.cmd == "patch-model-config":
        patch_model_config(args.model_dir, args.image_checkpoint)
    else:
        build_online_generation_subsets(args.source, args.out_dir,
                                        args.num_subsets, args.subset_size)


if __name__ == "__main__":
    main()
