"""Generic GPT-4 pairwise answer review (the two stock-LLaVA eval extras).

Ports the last two reference eval scripts (SURVEY §2.7 extras row):

- ``eval_llava_rlhf_coco/eval_gpt_review.py:12-60`` — rule-based pairwise
  QA review: per question, pick the judge rule by the question's
  ``category`` from a rule JSON (falling back to ``default``), send both
  answers, parse two scores from the first reply line.
- ``eval_llava_rlhf_coco/eval_gpt_review_bench.py`` — the LLaVA-Bench
  (in-the-wild) variant: adds the image's caption context block, prefixes
  the category with ``llava_bench_`` (no default fallback), and resumes an
  interrupted run by appending only reviews past the existing output.

Differences from the reference by design: the Azure/OpenAI plumbing is the
shared :mod:`opadpo_torch.pipeline.gpt4v_client` (sqlite cache + retry)
instead of ray/openai-SDK loops; score parsing is shared with
``llava_bench.parse_scores`` (identical first-line two-float contract).

A copy of ``opadpo_tpu/eval/gpt_review.py``; it imports nothing of that
package.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from opadpo_torch.eval.llava_bench import parse_scores


def _load_jsonl(path: str) -> List[Dict]:
    with open(os.path.expanduser(path)) as f:
        return [json.loads(line) for line in f if line.strip()]


def pick_rule(rule_dict: Dict, category: str,
              bench_mode: bool = False) -> Dict:
    """Rule lookup: plain mode falls back to 'default'
    (eval_gpt_review.py:85-88); bench mode requires the prefixed category
    (eval_gpt_review_bench.py: assert on miss)."""
    if bench_mode:
        key = "llava_bench_" + category
        if key not in rule_dict:
            raise KeyError(f"Visual QA category not found in rule file: {key}")
        return rule_dict[key]
    return rule_dict.get(category, rule_dict["default"])


def build_review_content(question: str, answer_1: str, answer_2: str,
                         rule: Dict, context: Optional[str] = None) -> str:
    """The judge-visible layout: optional [Context], then question, the two
    answers delimited by role markers, then the rule's own prompt.  The
    rule file supplies all judge instructions; this is the structural
    contract its prompts reference."""
    role = rule["role"]
    parts = []
    if context is not None:
        parts.append(f"[Context]\n{context}\n\n")
    parts.append(f"[Question]\n{question}\n\n")
    parts.append(f"[{role} 1]\n{answer_1}\n\n[End of {role} 1]\n\n")
    parts.append(f"[{role} 2]\n{answer_2}\n\n[End of {role} 2]\n\n")
    parts.append(f"[System]\n{rule['prompt']}\n\n")
    return "".join(parts)


def run_reviews(
    questions: List[Dict],
    answers_1: List[Dict],
    answers_2: List[Dict],
    rule_dict: Dict,
    api_service,
    output_path: str,
    contexts: Optional[Dict[str, Dict]] = None,
    bench_mode: bool = False,
    max_tokens: int = 1024,
) -> List[Dict]:
    """Review each (question, answer1, answer2) triple; append-resume via
    the existing output file (bench variant's skip-existing behavior)."""
    existing: List[Dict] = []
    if os.path.isfile(os.path.expanduser(output_path)):
        existing = _load_jsonl(output_path)

    reviews = list(existing)
    with open(os.path.expanduser(output_path), "a") as out:
        for idx, (q, a1, a2) in enumerate(zip(questions, answers_1,
                                              answers_2)):
            if idx < len(existing):
                continue
            category = q.get("category", "default")
            rule = pick_rule(rule_dict, category, bench_mode=bench_mode)
            context = None
            if bench_mode:
                inst = (contexts or {})[q["image"]]
                context = "\n".join(inst["caption"])
            content = build_review_content(q["text"], a1["text"], a2["text"],
                                           rule, context=context)
            review = api_service.call_llm_with_messages(
                [{"role": "system",
                  "content": "You are a helpful and precise assistant for "
                             "checking the quality of the answer."},
                 {"role": "user", "content": content}],
                temperature=0.2, max_tokens=max_tokens)
            rec = {
                "id": idx + 1,
                "question_id": q["question_id"],
                "answer1_id": a1.get("answer_id", a1.get("question_id")),
                "answer2_id": a2.get("answer_id", a2.get("question_id")),
                "category": ("llava_bench_" + category) if bench_mode
                            else category,
                "content": review,
                "tuple": list(parse_scores(review)),
            }
            out.write(json.dumps(rec) + "\n")
            out.flush()
            reviews.append(rec)
    return reviews


def main():
    from opadpo_torch.pipeline.gpt4v_client import get_api_service

    p = argparse.ArgumentParser(description="GPT-4 pairwise answer review")
    p.add_argument("-q", "--question", required=True)
    p.add_argument("-c", "--context",
                   help="context jsonl (bench mode only)")
    p.add_argument("-a", "--answer-list", nargs="+", required=True)
    p.add_argument("-r", "--rule", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--bench", action="store_true",
                   help="LLaVA-Bench (in-the-wild) mode with caption context")
    p.add_argument("--max-tokens", type=int, default=1024)
    args = p.parse_args()

    questions = _load_jsonl(args.question)
    answers_1 = _load_jsonl(args.answer_list[0])
    answers_2 = _load_jsonl(args.answer_list[1])
    with open(os.path.expanduser(args.rule)) as f:
        rule_dict = json.load(f)
    contexts = None
    if args.bench:
        ctx_list = _load_jsonl(args.context)
        contexts = {c["image"]: c for c in ctx_list}

    api = get_api_service(rank=0, cache_path=os.path.join(
        os.path.dirname(os.path.expanduser(args.output)) or ".",
        "review_cache.sqlite"))
    run_reviews(questions, answers_1, answers_2, rule_dict, api,
                args.output, contexts=contexts, bench_mode=args.bench,
                max_tokens=args.max_tokens)


if __name__ == "__main__":
    main()
