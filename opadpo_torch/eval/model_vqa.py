"""Benchmark inference CLI: port of ``opadpo_tpu/eval/model_vqa.py`` (the
reference's ``model_vqa*.py`` family: ``eval_llava_rlhf_coco/
model_vqa.py:71-260``, ``model_vqa_mmhal.py``, ``model_vqa_objectHal.py``,
``AMBER_generate.py``).

One driver covers the five benchmarks: per question it renders the
vicuna_v1 conversation, preprocesses the image (expand2square + CLIP) and
decodes greedily, either in fixed batches on the ``Sampler`` or, with
``continuous_slots``, through the slot-pool engine
(``engine/continuous.py``), where a finished answer frees its slot for the
next question.  Answers are written in the reference's JSONL schema, with
the JAX package's model ids, so the judge and summariser stages take the
files of either package.  ``--short_eval`` appends the single-word-answer
instruction used for POPE.

    python -m opadpo_torch.eval.model_vqa --model-path DIR \\
        --question-file Q.jsonl --image-folder IMGS --answers-file A.jsonl \\
        [--continuous-slots 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import uuid
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from opadpo_torch.constants import DEFAULT_IMAGE_TOKEN
from opadpo_torch.data import conversation as conversation_lib
from opadpo_torch.data.image_processing import (
    preprocess_images, set_pil_preprocess,
)
from opadpo_torch.data.tokenization import tokenizer_image_token
from opadpo_torch.engine.sampler import Sampler, truncate_after_tokens
from opadpo_torch.engine.sampling import SamplingConfig

SHORT_EVAL_SUFFIX = "\nAnswer the question using a single word or phrase."


def iter_jsonl_questions(path: str) -> Iterator[Dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def iter_amber_questions(path: str) -> Iterator[Dict]:
    """AMBER query json: [{"id", "image", "query"}]."""
    with open(path) as f:
        data = json.load(f)
    for item in data:
        yield {"question_id": item["id"], "image": item["image"],
               "text": item["query"]}


def iter_mmhal_questions(path: str) -> Iterator[Dict]:
    """MMHal-Bench response template json (a list of dicts with
    'question' and 'image_src' / 'image_path')."""
    with open(path) as f:
        data = json.load(f)
    for i, item in enumerate(data):
        yield {"question_id": i, "image": item.get("image_path")
               or item.get("image_src"), "text": item["question"],
               "meta": item}


def build_prompt(question: str, short_eval: bool = False) -> str:
    q = question
    if DEFAULT_IMAGE_TOKEN not in q:
        q = DEFAULT_IMAGE_TOKEN + "\n" + q
    if short_eval:
        q = q + SHORT_EVAL_SUFFIX
    conv = conversation_lib.default_conversation.copy()
    conv.append_message(conv.roles[0], q)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def _record(q: Dict, text: str, model_id: str) -> Dict:
    rec = {"question_id": q["question_id"], "prompt": q["text"],
           "text": text, "answer_id": uuid.uuid4().hex[:22],
           "model_id": model_id, "metadata": {}}
    if "meta" in q:
        rec["meta"] = q["meta"]
    return rec


def left_pad(rows: List[np.ndarray], batch: int, qlen: int):
    """Token rows -> (ids, mask) [batch, qlen] int64, left-padded, each
    row left-truncated to ``qlen``."""
    ids = np.zeros((batch, qlen), np.int64)
    mask = np.zeros((batch, qlen), np.int64)
    for i, r in enumerate(rows):
        r = r[-qlen:]
        ids[i, -len(r):] = r
        mask[i, -len(r):] = 1
    return ids, mask


def run_inference(
    model,
    tokenizer,
    questions: List[Dict],
    image_dir: Optional[str],
    answers_file: str,
    lora=None,
    lora_scaling: float = 1.0,
    batch_size: int = 8,
    max_new_tokens: int = 1024,
    temperature: float = 0.0,
    short_eval: bool = False,
    query_len: int = 128,
    model_id: str = "llava-tpu",
    kv_bits: int = 16,
    head_bits: int = 16,
    decode_chunk: int = 0,
    continuous_slots: int = 0,
    seg_len: int = 64,
) -> Dict:
    """Answer ``questions`` into ``answers_file`` -> what ran: the
    sampler's per-batch stats, or the engine's ``stats``."""
    sampling = SamplingConfig(
        greedy=(temperature == 0.0), temperature=max(temperature, 1e-4),
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id,
        max_new_tokens=max_new_tokens)
    if continuous_slots:
        return _run_inference_continuous(
            model, tokenizer, questions, image_dir, answers_file,
            lora=lora, lora_scaling=lora_scaling, slots=continuous_slots,
            seg_len=seg_len, sampling=sampling, short_eval=short_eval,
            query_len=query_len, model_id=model_id, head_bits=head_bits)

    sampler = Sampler(sampling, lora_scaling=lora_scaling, kv_bits=kv_bits,
                      head_bits=head_bits, chunk=decode_chunk)
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(0)
    img_size = model.cfg.vision.image_size
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    with open(answers_file, "w") as out_f, torch.inference_mode():
        for start in range(0, len(questions), batch_size):
            chunk = questions[start:start + batch_size]
            rows = [np.asarray(tokenizer_image_token(
                build_prompt(q["text"], short_eval), tokenizer), np.int64)
                for q in chunk]
            pixels = preprocess_images([q["image"] for q in chunk],
                                       image_dir, size=img_size)
            # prompt lengths in 64-token buckets, the batch at full size
            longest = max(len(r) for r in rows)
            qlen = max(query_len, -(-longest // 64) * 64)
            b = len(chunk)
            ids, mask = left_pad(rows, batch_size, qlen)
            images = np.zeros((batch_size, img_size, img_size, 3),
                              np.float32)
            images[:b] = pixels
            t0 = time.time()
            tokens = sampler.generate(
                model, torch.from_numpy(ids).to(dev),
                torch.from_numpy(mask).to(dev),
                torch.from_numpy(images).to(dev), generator,
                lora=lora).cpu().numpy()[:b]
            tokens = truncate_after_tokens(tokens, tokenizer.eos_token_id,
                                           tokenizer.pad_token_id)
            texts = tokenizer.batch_decode(tokens, skip_special_tokens=True)
            dt = time.time() - t0
            for q, text in zip(chunk, texts):
                out_f.write(json.dumps(_record(q, text.strip(), model_id))
                            + "\n")
            out_f.flush()
            print(f"[{start + b}/{len(questions)}] {b} answers in "
                  f"{dt:.1f}s", flush=True)
    return {"batches": list(sampler.stats)}


def _run_inference_continuous(
    model, tokenizer, questions, image_dir, answers_file, *, lora,
    lora_scaling, slots, seg_len, sampling, short_eval, query_len, model_id,
    head_bits,
) -> Dict:
    """All questions through the slot-pool engine (int8 cache): images are
    read at admission, one admission wave ahead of the segments, and the
    answers are written in question order (scorers that pair answers with
    labels by line stay right)."""
    from opadpo_torch.engine.continuous import ContinuousEngine

    rows = [np.asarray(tokenizer_image_token(
        build_prompt(q["text"], short_eval), tokenizer), np.int64)
        for q in questions]
    longest = max((len(r) for r in rows), default=query_len)
    qlen = max(query_len, -(-longest // 64) * 64)
    eng = ContinuousEngine(model, sampling, lora=lora,
                           lora_scaling=lora_scaling, max_batch=slots,
                           qlen=qlen, seg_len=seg_len, head_bits=head_bits)
    img_size = model.cfg.vision.image_size
    rid_to_idx: Dict[int, int] = {}
    answers: Dict[int, str] = {}
    next_q = 0
    t0 = time.time()
    while next_q < len(questions) or eng.has_work():
        while next_q < len(questions) and eng.queue_length < slots:
            q = questions[next_q]
            pix = preprocess_images([q["image"]], image_dir,
                                    size=img_size)[0]
            rid = eng.add_request(rows[next_q], np.ones_like(rows[next_q]),
                                  pix)
            rid_to_idx[rid] = next_q
            next_q += 1
        for rid, toks in eng.step():
            text = tokenizer.batch_decode(toks[None],
                                          skip_special_tokens=True)[0]
            answers[rid_to_idx[rid]] = text.strip()
            n_done = len(answers)
            if n_done % 50 == 0 or n_done == len(questions):
                print(f"[{n_done}/{len(questions)}] {time.time() - t0:.1f}s",
                      flush=True)
    if len(answers) != len(questions):
        raise RuntimeError(f"{len(answers)} answers for {len(questions)} "
                           "questions")
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    with open(answers_file, "w") as out_f:
        for i, q in enumerate(questions):
            out_f.write(json.dumps(_record(q, answers[i], model_id)) + "\n")
    return {"engine": eng.stats}


def load_for_eval(args: argparse.Namespace):
    """(cfg, model, lora, lora_scaling) from a driver's ``--model-path``,
    ``--vision-path``, ``--adapter-path``, ``--device`` and, where the
    driver has them, ``--visual-tokens`` and ``--pil-preprocess``."""
    from opadpo_torch.models.loader import adapter_scaling, load_peft_adapter
    from opadpo_torch.pipeline.runtime import setup_model

    if getattr(args, "pil_preprocess", False):
        set_pil_preprocess(True)
    cfg, model, _ = setup_model(args.model_path,
                                vision_dir=getattr(args, "vision_path", None),
                                device=args.device,
                                visual_tokens=getattr(args, "visual_tokens",
                                                      0) or None)
    lora, scaling = None, 1.0
    if args.adapter_path:
        lora = load_peft_adapter(args.adapter_path, cfg.llama,
                                 device=args.device)
        scaling = adapter_scaling(args.adapter_path)
    return cfg, model, lora, scaling


def model_args(p: argparse.ArgumentParser, vision: bool = True) -> None:
    """The drivers' model flags."""
    p.add_argument("--model-path", required=True)
    if vision:
        p.add_argument("--vision-path", default=None)
    p.add_argument("--adapter-path", default=None)
    p.add_argument("--device", default="cuda",
                   help="cpu runs the plain PyTorch versions of the kernels")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="benchmark inference on one GPU "
                                "(the PyTorch port)")
    model_args(p)
    p.add_argument("--question-file", required=True)
    p.add_argument("--question-format", default="jsonl",
                   choices=["jsonl", "amber", "mmhal"])
    p.add_argument("--image-folder", default=None)
    p.add_argument("--answers-file", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--short_eval", action="store_true")
    p.add_argument("--kv-bits", type=int, default=16, choices=(16, 8, 4))
    p.add_argument("--head-bits", type=int, default=16, choices=(16, 8, 4))
    p.add_argument("--decode-chunk", type=int, default=0)
    p.add_argument("--continuous-slots", type=int, default=0,
                   help="slot-pool scheduling across questions (int8 KV): "
                        "a finished answer frees its slot at once")
    p.add_argument("--seg-len", type=int, default=64,
                   help="continuous mode: decode steps per segment")
    p.add_argument("--pil-preprocess", action="store_true",
                   help="force the PIL image path (strict HF-numerics "
                        "parity) instead of the native C++ JPEG pipeline")
    p.add_argument("--visual-tokens", type=int, default=0,
                   help="training-free visual-token pruning: keep only "
                        "the top-K projected patches (0 = all 576)")
    args = p.parse_args(argv)
    if args.visual_tokens < 0:
        p.error("--visual-tokens must be >= 0 (0 = all patches)")
    return args


def main(argv=None, tokenizer=None) -> None:
    """The CLI; ``tokenizer`` in place of the checkpoint's."""
    from opadpo_torch.pipeline.runtime import load_tokenizer

    args = parse_args(argv)
    _, model, lora, scaling = load_for_eval(args)
    if tokenizer is None:
        tokenizer = load_tokenizer(args.model_path)
    iters = {"jsonl": iter_jsonl_questions, "amber": iter_amber_questions,
             "mmhal": iter_mmhal_questions}
    questions = list(iters[args.question_format](args.question_file))
    run_inference(model, tokenizer, questions, args.image_folder,
                  args.answers_file, lora=lora, lora_scaling=scaling,
                  batch_size=args.batch_size,
                  max_new_tokens=args.max_new_tokens,
                  temperature=args.temperature, short_eval=args.short_eval,
                  kv_bits=args.kv_bits, head_bits=args.head_bits,
                  decode_chunk=args.decode_chunk,
                  continuous_slots=args.continuous_slots,
                  seg_len=args.seg_len)


if __name__ == "__main__":
    main()
