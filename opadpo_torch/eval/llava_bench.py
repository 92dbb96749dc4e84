"""LLaVA-Bench (COCO qa90): pairwise GPT-4 review + relative-score
summarizer.

Reference: ``eval_llava_rlhf_coco/eval_gpt_review_visual.py:12-60``
(assistant-1 = GPT-4 reference answers, assistant-2 = model; judge emits
two 1-10 scores on the first line) + ``summarize_gpt_review.py:38-73``
(relative score % = mean(model)/mean(reference)).

A copy of ``opadpo_tpu/eval/llava_bench.py``; it imports nothing of that
package.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

REVIEW_TEMPLATE = """\
We would like your feedback on the performance of two AI assistants that
answered a question about an image.

Visual context (captions and object boxes for the image):
{context}

Question: {question}

Assistant 1's answer:
{answer_1}

Assistant 2's answer:
{answer_2}

Rate the helpfulness, relevance, accuracy and level of detail of each
answer with respect to the image. Output a single line with two scores
from 1 to 10 separated by a space — the first for Assistant 1, the second
for Assistant 2 — followed by a blank line and a short explanation that
avoids position or length bias.
"""


def parse_scores(review_text: str) -> Tuple[float, float]:
    """First line → two floats (reference parse; (-1,-1) on failure)."""
    try:
        line = review_text.split("\n")[0]
        parts = line.replace(",", " ").split()
        return float(parts[0]), float(parts[1])
    except Exception:
        return -1.0, -1.0


def build_review_prompt(question: str, context: str, answer_gpt4: str,
                        answer_model: str) -> str:
    return REVIEW_TEMPLATE.format(context=context, question=question,
                                  answer_1=answer_gpt4,
                                  answer_2=answer_model)


def run_reviews(questions: List[Dict], gpt4_answers: List[Dict],
                model_answers: List[Dict], contexts: Dict[str, str],
                api_service, out_file: Optional[str] = None) -> List[Dict]:
    gpt4_by_id = {a["question_id"]: a for a in gpt4_answers}
    model_by_id = {a["question_id"]: a for a in model_answers}
    reviews = []
    for q in questions:
        qid = q["question_id"]
        ctx = contexts.get(str(q.get("image", "")), "")
        prompt = build_review_prompt(q["text"], ctx,
                                     gpt4_by_id[qid]["text"],
                                     model_by_id[qid]["text"])
        content = api_service.call_llm_with_messages(
            [{"role": "user", "content": prompt}])
        s1, s2 = parse_scores(content)
        reviews.append({"question_id": qid, "content": content,
                        "tuple": [s1, s2]})
    if out_file:
        with open(out_file, "w") as f:
            for r in reviews:
                f.write(json.dumps(r) + "\n")
    return reviews


def summarize(reviews: List[Dict]) -> Dict[str, float]:
    """reference summarize_gpt_review.py:38-73."""
    pairs = [r["tuple"] for r in reviews
             if r["tuple"][0] > 0 and r["tuple"][1] > 0]
    if not pairs:
        return {"relative_score": 0.0, "gpt4_avg": 0.0, "model_avg": 0.0,
                "num_reviews": 0}
    gpt4_avg = sum(p[0] for p in pairs) / len(pairs)
    model_avg = sum(p[1] for p in pairs) / len(pairs)
    return {
        "relative_score": round(model_avg / gpt4_avg * 100, 1),
        "gpt4_avg": round(gpt4_avg, 3),
        "model_avg": round(model_avg, 3),
        "num_reviews": len(pairs),
    }


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--reviews-file", required=True,
                   help="jsonl of judge outputs with 'tuple' scores")
    args = p.parse_args()
    reviews = [json.loads(l) for l in open(args.reviews_file)]
    print(json.dumps(summarize(reviews), indent=2))


if __name__ == "__main__":
    main()
