"""POPE summarizer (rule-based yes/no parsing).

Behavioral port of ``eval_llava_rlhf_coco/summarize_eval_pope.py:4-72``:
keep the first sentence, strip commas, answer is "no" iff any of
{No, not, no} appears as a word; metrics = F1/acc/precision/recall/
yes-ratio with "yes" as the positive class.

A copy of ``opadpo_tpu/eval/pope.py``; it imports nothing of that
package.
"""

from __future__ import annotations

import json
from typing import Dict, List


def parse_answer_to_label(text: str) -> int:
    """1 = yes, 0 = no (reference parsing rules)."""
    if text.find(".") != -1:
        text = text.split(".")[0]
    text = text.replace(",", "")
    words = text.split(" ")
    return 0 if ("No" in words or "not" in words or "no" in words) else 1


def evaluate_pope(answers: List[Dict], labels: List[str]) -> Dict[str, float]:
    pred = [parse_answer_to_label(a["text"]) for a in answers]
    gold = [0 if lab == "no" else 1 for lab in labels]
    assert len(pred) == len(gold), (len(pred), len(gold))

    tp = sum(1 for p, g in zip(pred, gold) if p == 1 and g == 1)
    fp = sum(1 for p, g in zip(pred, gold) if p == 1 and g == 0)
    tn = sum(1 for p, g in zip(pred, gold) if p == 0 and g == 0)
    fn = sum(1 for p, g in zip(pred, gold) if p == 0 and g == 1)

    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    acc = (tp + tn) / max(tp + tn + fp + fn, 1)
    yes_ratio = sum(pred) / max(len(pred), 1)
    return {"f1": f1, "accuracy": acc, "precision": precision,
            "recall": recall, "yes_ratio": yes_ratio,
            "tp": tp, "fp": fp, "tn": tn, "fn": fn,
            "num_examples": len(pred)}


def evaluate_pope_files(answers_file: str, label_file: str) -> Dict[str, float]:
    answers = [json.loads(l) for l in open(answers_file)]
    labels = [json.loads(l)["label"] for l in open(label_file)]
    return evaluate_pope(answers, labels)


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--answers-file", required=True)
    p.add_argument("--label-file", required=True)
    args = p.parse_args()
    m = evaluate_pope_files(args.answers_file, args.label_file)
    print("POPE Bench")
    print(f"TP {m['tp']}  FP {m['fp']}  TN {m['tn']}  FN {m['fn']}")
    for k in ("accuracy", "precision", "recall", "f1", "yes_ratio"):
        print(f"{k}: {m[k]:.4f}")
    print("%.3f, %.3f, %.3f, %.3f, %.3f" % (
        m["f1"], m["accuracy"], m["precision"], m["recall"], m["yes_ratio"]))


if __name__ == "__main__":
    main()
