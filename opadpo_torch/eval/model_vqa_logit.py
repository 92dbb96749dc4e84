"""Yes / no logit readout eval: port of ``opadpo_tpu/eval/model_vqa_logit.py``
(the reference's ``model_vqa_logit.py``).  Instead of decoding text it reads
the first-token probabilities of the yes / no variants (" Yes", " No",
"\\nYes", "\\nNo", "yes", "no") after the prompt and answers with the
larger sum: a deterministic, fast alternative for binary benchmarks such as
POPE.  One prefill per batch (``llava.prefill_unrolled``, the flash kernel
on the GPU), no decode.

    python -m opadpo_torch.eval.model_vqa_logit --model-path DIR \\
        --question-file Q.jsonl --image-folder IMGS --answers-file A.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from opadpo_torch.data.image_processing import preprocess_images
from opadpo_torch.data.tokenization import tokenizer_image_token
from opadpo_torch.eval.model_vqa import (
    build_prompt, iter_jsonl_questions, left_pad, load_for_eval, model_args,
)
from opadpo_torch.models import llava as llava_model


def yes_no_token_ids(tokenizer) -> Dict[str, int]:
    """Last token id of each textual yes / no variant (reference
    :107-114)."""
    variants = ("yes", "no", " Yes", " No", "\nYes", "\nNo")
    return {v.strip().lower() + ("_nl" if v.startswith("\n") else
                                 "_sp" if v.startswith(" ") else ""):
            tokenizer(v).input_ids[-1] for v in variants}


def run_logit_inference(
    model,
    tokenizer,
    questions: List[Dict],
    image_dir: Optional[str],
    answers_file: str,
    lora=None,
    lora_scaling: float = 1.0,
    batch_size: int = 8,
    query_len: int = 128,
    short_eval: bool = True,
) -> None:
    tok_ids = yes_no_token_ids(tokenizer)
    yes_ids = [v for k, v in tok_ids.items() if k.startswith("yes")]
    no_ids = [v for k, v in tok_ids.items() if k.startswith("no")]
    img_size = model.cfg.vision.image_size
    dev = next(model.parameters()).device

    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    with open(answers_file, "w") as out_f, torch.inference_mode():
        for start in range(0, len(questions), batch_size):
            chunk = questions[start:start + batch_size]
            b = len(chunk)
            rows = [np.asarray(tokenizer_image_token(
                build_prompt(q["text"], short_eval), tokenizer), np.int64)
                for q in chunk]
            longest = max(len(r) for r in rows)
            qlen = max(query_len, -(-longest // 64) * 64)
            ids, mask = left_pad(rows, batch_size, qlen)
            images = np.zeros((batch_size, img_size, img_size, 3),
                              np.float32)
            images[:b] = preprocess_images([q["image"] for q in chunk],
                                           image_dir, size=img_size)
            pf = llava_model.prefill_unrolled(
                model, torch.from_numpy(ids).to(dev),
                torch.from_numpy(mask).to(dev),
                torch.from_numpy(images).to(dev), lora=lora,
                lora_scaling=lora_scaling)
            probs = torch.softmax(pf["last_logits"][:b].float(),
                                  dim=-1).cpu().numpy()
            for i, q in enumerate(chunk):
                p_yes = float(probs[i, yes_ids].sum())
                p_no = float(probs[i, no_ids].sum())
                out_f.write(json.dumps({
                    "question_id": q["question_id"],
                    "prompt": q["text"],
                    "text": "Yes" if p_yes >= p_no else "No",
                    "p_yes": p_yes,
                    "p_no": p_no,
                    "model_id": "llava-tpu-logit",
                }) + "\n")
            out_f.flush()
            print(f"[{start + b}/{len(questions)}]", flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="yes / no logit readout on one "
                                "GPU (the PyTorch port)")
    model_args(p)
    p.add_argument("--question-file", required=True)
    p.add_argument("--image-folder", default=None)
    p.add_argument("--answers-file", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None, tokenizer=None) -> None:
    """The CLI; ``tokenizer`` in place of the checkpoint's."""
    from opadpo_torch.pipeline.runtime import load_tokenizer

    args = parse_args(argv)
    _, model, lora, scaling = load_for_eval(args)
    if tokenizer is None:
        tokenizer = load_tokenizer(args.model_path)
    questions = list(iter_jsonl_questions(args.question_file))
    run_logit_inference(model, tokenizer, questions, args.image_folder,
                        args.answers_file, lora=lora, lora_scaling=scaling,
                        batch_size=args.batch_size)


if __name__ == "__main__":
    main()
