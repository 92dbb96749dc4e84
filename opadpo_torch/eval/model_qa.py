"""Text-only QA inference: port of ``opadpo_tpu/eval/model_qa.py`` (the
reference's ``eval_llava_rlhf_coco/model_qa.py``): generation on the
language model alone, without the vision tower, for language sanity
benchmarks and the GPT-3.5 baseline comparisons.

    python -m opadpo_torch.eval.model_qa --model-path DIR \\
        --question-file Q.jsonl --answers-file A.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from opadpo_torch.data import conversation as conversation_lib
from opadpo_torch.engine.sampler import (
    decode_loop_unrolled, truncate_after_tokens,
)
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.eval.model_vqa import left_pad, load_for_eval, model_args
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models.lora import tree_get


class TextSampler:
    """Prefill then decode on the language model only, as a host loop: the
    decoder's prompt pass (``llama.forward_prefill_unrolled``, the flash
    kernel on the GPU) leaves a bf16 prompt cache, and each step writes its
    token's KV into a bf16 suffix (``sampler.decode_loop_unrolled``)."""

    def __init__(self, sampling: SamplingConfig, lora_scaling: float = 1.0):
        self.sampling = sampling
        self.lora_scaling = lora_scaling

    def generate(self, model, ids: torch.Tensor, mask: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 lora=None) -> torch.Tensor:
        """[B, L] left-padded prompts and their mask -> tokens [B,
        max_new_tokens]; ``model`` a LLaVA model (its decoder runs)."""
        embeds = llama_model.embed_tokens(model.llama, ids)
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        last_logits, kv_list = llama_model.forward_prefill_unrolled(
            model.llama, embeds, mask, positions,
            lora=tree_get(lora, "llama"), lora_scaling=self.lora_scaling)
        out, _ = decode_loop_unrolled(
            model, kv_list, mask, positions[:, -1] + 1, last_logits,
            generator, self.sampling, lora=lora,
            lora_scaling=self.lora_scaling)
        return out


def run_text_qa(model, tokenizer, questions: List[Dict], answers_file: str,
                lora=None, lora_scaling: float = 1.0, batch_size: int = 8,
                max_new_tokens: int = 512) -> None:
    sampling = SamplingConfig(greedy=True, max_new_tokens=max_new_tokens,
                              eos_token_id=tokenizer.eos_token_id,
                              pad_token_id=tokenizer.pad_token_id)
    sampler = TextSampler(sampling, lora_scaling)
    dev = next(model.parameters()).device
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    with open(answers_file, "w") as out_f, torch.inference_mode():
        for start in range(0, len(questions), batch_size):
            chunk = questions[start:start + batch_size]
            rows = []
            for q in chunk:
                conv = conversation_lib.default_conversation.copy()
                conv.append_message(conv.roles[0], q["text"])
                conv.append_message(conv.roles[1], None)
                rows.append(np.asarray(
                    tokenizer(conv.get_prompt()).input_ids, np.int64))
            longest = max(len(r) for r in rows)
            ids, mask = left_pad(rows, batch_size, -(-longest // 64) * 64)
            tokens = sampler.generate(
                model, torch.from_numpy(ids).to(dev),
                torch.from_numpy(mask).to(dev), lora=lora
            ).cpu().numpy()[:len(chunk)]
            tokens = truncate_after_tokens(tokens, tokenizer.eos_token_id,
                                           tokenizer.pad_token_id)
            texts = tokenizer.batch_decode(tokens, skip_special_tokens=True)
            for q, text in zip(chunk, texts):
                out_f.write(json.dumps({
                    "question_id": q.get("question_id", q.get("id")),
                    "prompt": q["text"],
                    "text": text.strip(),
                    "answer_id": uuid.uuid4().hex[:22],
                    "model_id": "llava-tpu-textqa",
                }) + "\n")
            out_f.flush()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="text-only QA on one GPU (the "
                                "PyTorch port)")
    model_args(p, vision=False)
    p.add_argument("--question-file", required=True)
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
    with open(args.question_file) as f:
        questions = [json.loads(line) for line in f if line.strip()]
    run_text_qa(model, tokenizer, questions, args.answers_file, lora=lora,
                lora_scaling=scaling, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
