"""Eval orchestrator: port of ``opadpo_tpu/eval/run_all.py`` (the
reference's ``run/eval_all_metrics.sh`` stages as one CLI): inference for
each benchmark on the GPU, then the judge / summariser.

Stages (a subset with --benchmarks):
  pope        model_vqa --short_eval over coco_pope_{random,popular,
              adversarial}.jsonl -> rule-based F1
  llava_bench qa90 inference -> GPT-4 pairwise review -> relative %
  mmhal       96-question inference -> GPT-4 judge -> avg score, hal rate
  amber       AMBER_data queries -> generative + discriminative scoring
  objhal      Object-HalBench 300 -> CHAIR metrics

``--continuous-slots`` sends every inference through the slot-pool engine
(``model_vqa.run_inference(continuous_slots=...)``, int8 KV).  The judge
stages need ``--judge`` and an ``API_KEY``.

    python -m opadpo_torch.eval.run_all --model-path DIR --data-root D \\
        --image-root IMGS --output-dir OUT --benchmarks pope \\
        [--continuous-slots 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def parse_args(argv=None) -> argparse.Namespace:
    from opadpo_torch.eval.model_vqa import model_args

    p = argparse.ArgumentParser(description="run the hallucination eval "
                                "suite on one GPU (the PyTorch port)")
    model_args(p)
    p.add_argument("--data-root", required=True,
                   help="dir with pope/, AMBER_data/, qa90 files, etc.")
    p.add_argument("--image-root", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--benchmarks", nargs="+",
                   default=["pope", "amber", "mmhal", "llava_bench",
                            "objhal"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--continuous-slots", type=int, default=0,
                   help="slot-pool scheduling across questions "
                        "(model_vqa --continuous-slots; int8 KV)")
    p.add_argument("--judge", action="store_true",
                   help="run the GPT-4 judge stages (needs API_KEY)")
    p.add_argument("--objhal-gpt-extraction", action="store_true",
                   help="Object-Hal: extract mentioned objects with the "
                        "GPT-4 API (the reference's shipped mode) instead "
                        "of the regex + synonym matcher (needs API_KEY)")
    p.add_argument("--pil-preprocess", action="store_true",
                   help="force the PIL image path (strict HF-numerics "
                        "parity) instead of the native C++ JPEG pipeline")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None) -> Tuple[Dict, Dict[str, Dict]]:
    """The CLI -> (the results it writes to ``eval_results.json``, each
    inference's seconds with what ``run_inference`` reports it ran);
    ``tokenizer`` in place of the checkpoint's."""
    from opadpo_torch.eval import model_vqa as mv
    from opadpo_torch.pipeline.runtime import load_tokenizer

    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    _, model, lora, scaling = mv.load_for_eval(args)
    if tokenizer is None:
        tokenizer = load_tokenizer(args.model_path)
    runs: Dict[str, Dict] = {}

    def infer(name, questions, answers_file, **kw):
        t0 = time.perf_counter()
        ran = mv.run_inference(model, tokenizer, questions, args.image_root,
                               answers_file, lora=lora, lora_scaling=scaling,
                               batch_size=args.batch_size,
                               continuous_slots=args.continuous_slots, **kw)
        runs[name] = {"seconds": time.perf_counter() - t0, **ran}

    results = {}

    if "pope" in args.benchmarks:
        from opadpo_torch.eval.pope import evaluate_pope_files
        for split in ("random", "popular", "adversarial"):
            qfile = os.path.join(args.data_root, "pope",
                                 f"coco_pope_{split}.jsonl")
            afile = os.path.join(args.output_dir, f"pope_{split}.jsonl")
            qs = list(mv.iter_jsonl_questions(qfile))
            infer(f"pope_{split}", qs, afile, short_eval=True,
                  max_new_tokens=64)
            results[f"pope_{split}"] = evaluate_pope_files(afile, qfile)

    if "amber" in args.benchmarks:
        from opadpo_torch.eval.amber import evaluate_amber
        amber_dir = os.path.join(args.data_root, "AMBER_data")
        qfile = os.path.join(amber_dir, "query", "query_all.json")
        afile = os.path.join(args.output_dir, "amber_answers.jsonl")
        qs = list(mv.iter_amber_questions(qfile))
        infer("amber", qs, afile, max_new_tokens=512)
        inference = [{"id": rec["question_id"], "response": rec["text"]}
                     for rec in _jsonl(afile)]
        with open(os.path.join(amber_dir, "safe_words.txt")) as f:
            safe_words = [line.rstrip("\n") for line in f]
        results["amber"] = evaluate_amber(
            inference, _json(os.path.join(amber_dir, "annotations.json")),
            _json(os.path.join(amber_dir, "relation.json")), safe_words)

    if "mmhal" in args.benchmarks:
        tmpl = os.path.join(args.data_root, "mmhal",
                            "response_template.json")
        afile = os.path.join(args.output_dir, "mmhal_answers.jsonl")
        qs = list(mv.iter_mmhal_questions(tmpl))
        infer("mmhal", qs, afile, max_new_tokens=512)
        records = []
        for rec in _jsonl(afile):
            meta = rec["meta"]
            meta["model_answer"] = rec["text"]
            records.append(meta)
        resp_file = os.path.join(args.output_dir, "mmhal_responses.json")
        with open(resp_file, "w") as f:
            json.dump(records, f, indent=2)
        if args.judge:
            from opadpo_torch.eval.mmhal import judge_answers, summarize
            from opadpo_torch.pipeline.gpt4v_client import get_api_service
            reviewed = judge_answers(
                records, get_api_service(),
                reviews_out=os.path.join(args.output_dir,
                                         "mmhal_reviews.json"))
            results["mmhal"] = summarize(reviewed)

    if "llava_bench" in args.benchmarks:
        qfile = os.path.join(args.data_root, "qa90_questions.jsonl")
        afile = os.path.join(args.output_dir, "qa90_answers.jsonl")
        qs = list(mv.iter_jsonl_questions(qfile))
        infer("llava_bench", qs, afile, max_new_tokens=1024)
        if args.judge:
            from opadpo_torch.eval.llava_bench import run_reviews, summarize
            from opadpo_torch.pipeline.gpt4v_client import get_api_service
            gpt4_answers = _jsonl(os.path.join(args.data_root,
                                               "qa90_gpt4_answer.jsonl"))
            ctx_path = os.path.join(args.data_root,
                                    "caps_boxes_coco2014.jsonl")
            contexts = {}
            if os.path.exists(ctx_path):
                for c in _jsonl(ctx_path):
                    contexts[str(c["image"])] = c.get("caption", "")
            reviews = run_reviews(
                qs, gpt4_answers, _jsonl(afile), contexts,
                get_api_service(),
                out_file=os.path.join(args.output_dir, "qa90_reviews.jsonl"))
            results["llava_bench"] = summarize(reviews)

    if "objhal" in args.benchmarks:
        qfile = os.path.join(args.data_root, "obj_halbench_300.jsonl")
        afile = os.path.join(args.output_dir, "objhal_answers.jsonl")
        qs = list(mv.iter_jsonl_questions(qfile))
        infer("objhal", qs, afile, max_new_tokens=1024)
        gt_path = os.path.join(args.data_root, "objhal_gt_objects.json")
        if os.path.exists(gt_path):
            from opadpo_torch.eval.object_hal import (
                evaluate_chair, make_gpt_extractor,
            )
            extractor = None
            if args.objhal_gpt_extraction:
                from opadpo_torch.pipeline.gpt4v_client import get_api_service
                extractor = make_gpt_extractor(get_api_service(
                    cache_path=os.path.join(args.output_dir,
                                            "objhal_extract.sqlite")))
            results["objhal"] = evaluate_chair(_jsonl(afile), _json(gt_path),
                                               extract_objects_fn=extractor)

    out = os.path.join(args.output_dir, "eval_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results, runs


if __name__ == "__main__":
    main()
