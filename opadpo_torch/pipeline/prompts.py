"""GPT-4V sentence-correction prompt: copy of
``opadpo_tpu/pipeline/prompts.py``.

Functionally equivalent to the reference's correction prompt
(``opadpo/generator_models/prompt/pseudo_rollout_coco.py:1-85``): the
model receives the image, the question, the policy's sampled response and
the ground-truth "approximate ideal answer" (the reference's
``standard_response`` field in ``input_format_coco_4V``, sent at
``online_generator.py:158``), and returns a JSON report that rewrites the
response sentence by sentence.  The JSON schema is what the DPO collator
parses (``utils/data_utils_dpo.py:140-258``):

    {"sentence_k": {"copied_content", "score", "error_type", "object",
                    "rewritten_content", "reason"}, ...,
     "Added": {"rewritten_content", "reason"}}

score in {1, 2, 3, 4} (1 = severe hallucination ... 4 = fully correct);
error_type in {"correct", "image_recognition_error",
"language_comprehension_error"}.
"""

CORRECTION_SYSTEM_PROMPT = """\
You are an expert visual-language verifier. You will be shown an image, a
question about that image, an AI assistant's answer, and a reference
answer that approximates the ideal response. Your job is to audit the
assistant's answer sentence by sentence against the image and produce a
corrected version.

Treat the image as the primary source of truth. The reference answer is a
guide: it points at what a good answer should cover, but it may itself be
incomplete or contain mistakes — when it conflicts with the image, trust
the image. Keep your edits minimal: preserve as much of the assistant's
original wording as possible and change only what the image (and, where
consistent with it, the reference answer) shows to be wrong or missing.

For each sentence of the answer, in order, emit one JSON entry:
- "copied_content": the sentence copied verbatim from the answer.
- "score": an integer 1-4 rating its factual accuracy with respect to the
  image (1 = severe hallucination, 2 = clear error, 3 = minor inaccuracy,
  4 = fully correct).
- "error_type": one of "correct", "image_recognition_error" (the claim
  contradicts what the image shows), or "language_comprehension_error"
  (the sentence misunderstands the question or is irrelevant).
- "object": the main visual object(s) the sentence is about.
- "rewritten_content": the sentence rewritten so it is fully supported by
  the image; keep correct sentences unchanged. If the sentence is beyond
  repair, rewrite it to a correct statement about the same topic or leave
  it empty.
- "reason": one brief sentence justifying the score and rewrite.

After covering every sentence, add a final entry "Added" whose
"rewritten_content" contains any important, image-grounded information the
answer should have mentioned but did not (empty string if nothing to add),
with a short "reason".

Respond with ONLY the JSON object, no prose around it.
"""

# Input payload mirrors the reference's ``input_format_coco_4V`` fields:
# query / generated_response / standard_response (pseudo_rollout_coco.py).
CORRECTION_INPUT_FORMAT = """\
Question: {question}
Answer to audit: {response}
Reference answer (approximate ideal; may be incomplete): {standard_response}
"""

CORRECTION_OUTPUT_FORMAT = """\
{"sentence_1": {"copied_content": "...", "score": 4, "error_type": \
"correct", "object": "...", "rewritten_content": "...", "reason": "..."}, \
"Added": {"rewritten_content": "", "reason": "..."}}
"""


def build_correction_messages(question: str, response: str,
                              image_b64: str,
                              standard_response: str = "") -> list:
    """OpenAI chat-format messages with an inline base64 image.

    ``standard_response`` is the GT answer the reference sends as the
    "approximate ideal answer" (``online_generator.py:158``) — it steers
    the sentence rewrites and therefore the OPA/DPO dataset quality.
    """
    return [
        {"role": "system", "content": CORRECTION_SYSTEM_PROMPT},
        {"role": "user", "content": [
            {"type": "image_url", "image_url": {
                "url": f"data:image/jpeg;base64,{image_b64}"}},
            {"type": "text", "text": CORRECTION_INPUT_FORMAT.format(
                question=question, response=response,
                standard_response=standard_response)},
        ]},
    ]
