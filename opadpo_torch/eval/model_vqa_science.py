"""ScienceQA inference and scorer: port of
``opadpo_tpu/eval/model_vqa_science.py`` (the reference's
``model_vqa_science.py``, a stock-LLaVA extra): multiple-choice science
questions with an optional image and context hint; the answer letter is
parsed from the generation (``model_vqa.run_inference``, 64 tokens).

    python -m opadpo_torch.eval.model_vqa_science --model-path DIR \
        --question-file problems.json --image-folder IMGS \
        --answers-file A.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List

OPTION_LETTERS = ("A", "B", "C", "D", "E")


def build_science_prompt(item: Dict) -> str:
    """question + hint + lettered choices → single-letter-answer prompt."""
    q = item["conversations"][0]["value"] if "conversations" in item \
        else item["question"]
    parts = [q]
    hint = item.get("hint", "")
    if hint:
        parts.insert(0, f"Context: {hint}")
    choices = item.get("choices", [])
    if choices:
        lettered = " ".join(f"({OPTION_LETTERS[i]}) {c}"
                            for i, c in enumerate(choices))
        parts.append(lettered)
    parts.append("Answer with the option's letter from the given choices "
                 "directly.")
    return "\n".join(parts)


def science_questions(path: str, image_dir: str) -> List[Dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = [{"id": k, **v} for k, v in data.items()]
    out = []
    for item in data:
        img = item.get("image")
        out.append({
            "question_id": item.get("id"),
            "text": build_science_prompt(item),
            "image": os.path.join(item.get("id", ""), img) if img else None,
            "answer_idx": item.get("answer"),
        })
    return out


_LETTER_RE = re.compile(r"\b([A-E])\b")


def parse_answer_letter(text: str) -> str:
    m = _LETTER_RE.search(text.strip())
    return m.group(1) if m else ""


def score_science(answers_file: str, questions: List[Dict]) -> Dict:
    by_id = {q["question_id"]: q for q in questions}
    total, correct = 0, 0
    with open(answers_file) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for rec in recs:
        q = by_id.get(rec["question_id"])
        if q is None or q.get("answer_idx") is None:
            continue
        total += 1
        pred = parse_answer_letter(rec["text"])
        gold = OPTION_LETTERS[q["answer_idx"]]
        if pred == gold:
            correct += 1
    return {"accuracy": round(correct / max(total, 1) * 100, 2),
            "num_questions": total}


def parse_args(argv=None) -> argparse.Namespace:
    from opadpo_torch.eval.model_vqa import model_args

    p = argparse.ArgumentParser(description="ScienceQA on one GPU (the "
                                "PyTorch port)")
    model_args(p)
    p.add_argument("--question-file", required=True)
    p.add_argument("--image-folder", required=True)
    p.add_argument("--answers-file", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None, tokenizer=None) -> Dict:
    """The CLI -> the scores it prints; ``tokenizer`` in place of the
    checkpoint's."""
    from opadpo_torch.eval.model_vqa import load_for_eval, run_inference
    from opadpo_torch.pipeline.runtime import load_tokenizer

    args = parse_args(argv)
    _, model, lora, scaling = load_for_eval(args)
    if tokenizer is None:
        tokenizer = load_tokenizer(args.model_path)
    questions = [q for q in science_questions(args.question_file,
                                              args.image_folder)
                 if q["image"]]
    run_inference(model, tokenizer, questions, args.image_folder,
                  args.answers_file, lora=lora, lora_scaling=scaling,
                  batch_size=args.batch_size, max_new_tokens=64)
    scores = score_science(args.answers_file, questions)
    print(json.dumps(scores))
    return scores


if __name__ == "__main__":
    main()
