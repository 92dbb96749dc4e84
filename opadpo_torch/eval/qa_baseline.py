"""GPT-3.5 baseline answers: port of ``opadpo_tpu/eval/qa_baseline.py``
(the reference's ``qa_baseline_gpt35.py``): an answers JSONL for a
question file through the chat API (``pipeline/gpt4v_client``), for the
relative scores of the LLaVA-Bench pipeline.  Needs ``API_KEY`` and the
network; no model runs.

    python -m opadpo_torch.eval.qa_baseline --question-file Q.jsonl \\
        --answers-file A.jsonl [--model gpt-3.5-turbo]
"""

from __future__ import annotations

import argparse
import json
import uuid

from opadpo_torch.eval.model_vqa import iter_jsonl_questions
from opadpo_torch.pipeline.gpt4v_client import get_api_service


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="chat-API baseline answers")
    p.add_argument("--question-file", required=True)
    p.add_argument("--answers-file", required=True)
    p.add_argument("--model", default="gpt-3.5-turbo")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    api = get_api_service()
    api.model = args.model
    with open(args.answers_file, "w") as out_f:
        for q in iter_jsonl_questions(args.question_file):
            text = api.call_llm_with_messages([
                {"role": "system",
                 "content": "You are a helpful assistant."},
                {"role": "user", "content": q["text"]},
            ])
            out_f.write(json.dumps({
                "question_id": q["question_id"],
                "prompt": q["text"],
                "text": text.strip(),
                "answer_id": uuid.uuid4().hex[:22],
                "model_id": args.model,
            }) + "\n")
            out_f.flush()


if __name__ == "__main__":
    main()
