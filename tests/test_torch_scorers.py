"""The port's copies of the eval scorers (``opadpo_torch.eval``: pope,
amber with amber_similarity, object_hal, mmhal, llava_bench, gpt_review)
against the JAX package's on the same inputs: the fixtures of
``tests/test_eval_suite.py``, ``test_eval_parity.py`` and
``test_gpt_review.py``, widened.  Every output is equal.  AMBER runs with
nltk and spaCy blocked in both packages (the offline fallbacks: the plural
lemmatiser and the bundled similarity table) and as installed; the judges
are fakes, so no test reaches the network.
"""

import json
import sys

import pytest

from opadpo_tpu.eval import amber as jax_amber
from opadpo_tpu.eval import amber_similarity as jax_sim
from opadpo_tpu.eval import gpt_review as jax_review
from opadpo_tpu.eval import llava_bench as jax_bench
from opadpo_tpu.eval import mmhal as jax_mmhal
from opadpo_tpu.eval import object_hal as jax_objhal
from opadpo_tpu.eval import pope as jax_pope
from opadpo_torch.eval import amber, amber_similarity, gpt_review
from opadpo_torch.eval import llava_bench, mmhal, object_hal, pope

POPE_TEXTS = [
    "Yes, there is a dog in the image.", "No, I cannot see one.",
    "There is not a cat here, only a sofa.",
    "Absolutely. The picture shows a red bus, no doubt about it.", "no",
    "Yes", "It does not appear so. But maybe yes.",
    "The answer is No, there is nothing like that.",
    "I think so, yes it is there.", "Nothing of the sort",
    "no way", "There is not a cat, I think.", "Yes it is.", "not really",
]
POPE_LABELS = ["yes", "no", "no", "yes", "no", "yes", "yes", "no", "yes",
               "no", "no", "no", "yes", "yes"]


def test_pope_matches_jax(tmp_path):
    for text in POPE_TEXTS:
        assert pope.parse_answer_to_label(text) == \
            jax_pope.parse_answer_to_label(text), text
    answers = [{"question_id": i, "text": t}
               for i, t in enumerate(POPE_TEXTS)]
    assert pope.evaluate_pope(answers, POPE_LABELS) == \
        jax_pope.evaluate_pope(answers, POPE_LABELS)
    afile, lfile = tmp_path / "a.jsonl", tmp_path / "l.jsonl"
    afile.write_text("".join(json.dumps(a) + "\n" for a in answers))
    lfile.write_text("".join(json.dumps({"question_id": i, "label": lab})
                             + "\n" for i, lab in enumerate(POPE_LABELS)))
    assert pope.evaluate_pope_files(str(afile), str(lfile)) == \
        jax_pope.evaluate_pope_files(str(afile), str(lfile))


@pytest.fixture(params=["blocked", "installed"])
def nlp_deps(request, monkeypatch):
    """nltk and spaCy blocked in both packages (the offline fallbacks), or
    as this machine has them; each package's spaCy cache reset."""
    if request.param == "blocked":
        for name in ("nltk", "nltk.stem", "spacy"):
            monkeypatch.setitem(sys.modules, name, None)
    for mod in (amber, jax_amber):
        monkeypatch.setattr(mod, "_SPACY_NLP", None)
    return request.param


AMBER_ASSOCIATION = {
    "dog": ["puppy", "canine"], "cat": ["kitten", "feline"],
    "tree": ["plant"], "couch": ["sofa"], "car": ["vehicle"],
    "person": ["man", "woman", "people"], "street": ["road"],
}
AMBER_ANNOTATIONS = [
    {"id": 1, "type": "generative", "truth": ["dog", "tree"],
     "hallu": ["cat"]},
    {"id": 2, "type": "generative", "truth": ["couch", "person"],
     "hallu": ["car", "dog"]},
    {"id": 3, "type": "generative", "truth": ["street"], "hallu": []},
    {"id": 4, "type": "discriminative-hallucination", "truth": "yes"},
    {"id": 5, "type": "discriminative-hallucination", "truth": "no"},
    {"id": 6, "type": "discriminative-attribute-state", "truth": "yes"},
    {"id": 7, "type": "discriminative-attribute-number", "truth": "no"},
    {"id": 8, "type": "discriminative-attribute-action", "truth": "yes"},
]
AMBER_INFERENCE = [
    {"id": 1, "response": "A dog next to a cat under a tree."},
    {"id": 2, "response": "Two people sit on a sofa; a vehicle and a puppy "
                          "wait outside."},
    {"id": 3, "response": "An empty road at night, the road is wet, the "
                          "road is long."},
    {"id": 4, "response": "Yes"}, {"id": 5, "response": "No"},
    {"id": 6, "response": "maybe"}, {"id": 7, "response": "No, there is "
                                                          "not."},
    {"id": 8, "response": "Yes, it is."},
]


@pytest.mark.parametrize("threshold", [0.8, 2.0])
def test_amber_matches_jax(nlp_deps, threshold):
    """``evaluate_amber`` with the similarity check on (0.8) and off
    (nothing crosses 2.0), the noun extraction, the backend name and the
    synonym check."""
    args = (AMBER_INFERENCE, AMBER_ANNOTATIONS, AMBER_ASSOCIATION,
            ["image", "scene", "night"])
    assert amber.evaluate_amber(*args, similarity_score=threshold) == \
        jax_amber.evaluate_amber(*args, similarity_score=threshold)
    vocab = {w for k, v in AMBER_ASSOCIATION.items() for w in (k, *v)}
    for text, _ in zip(POPE_TEXTS, range(4)):
        assert amber.extract_nouns(text, vocab) == \
            jax_amber.extract_nouns(text, vocab)
    assert amber.extract_nouns("Two dogs chase the cats around trees.") \
        == jax_amber.extract_nouns("Two dogs chase the cats around trees.")
    assert amber.similarity_backend() == jax_amber.similarity_backend()
    if nlp_deps == "blocked":
        assert amber.similarity_backend() == "bundled-table"
    for a, b in (("couch", "sofa"), ("zebra", "pizza"), ("dogs", "dog")):
        assert amber.check_synonyms_word(a, b) == \
            jax_amber.check_synonyms_word(a, b)


def test_bundled_similarity_matches_jax():
    words = ["couch", "sofa", "motorbike", "motorcycle", "TV", "television",
             "boy", "girl", "bike", "bicycle", "fridge", "refrigerator",
             "dogs", "dog", "street", "road", "cat", "rock", "stone",
             "watch", "clock", "zebra", "pizza", "desk", "table", "glasses"]
    for a in words:
        for b in words:
            assert amber_similarity.bundled_similarity(a, b) == \
                jax_sim.bundled_similarity(a, b), (a, b)


CHAIR_CAPTIONS = [
    "A man riding a motorbike past a fire hydrant while two dogs watch "
    "near some hot dogs.",
    "A dog and a cat on a couch.",
    "A man holding an umbrella.",
    "There is a dining table with wine glasses and a bowl of oranges.",
    "the seat of the toilet is up; a baby elephant stands nearby",
    "An empty street at night.",
]
CHAIR_GT = {0: ["person", "motorcycle", "dog"], 1: ["dog", "couch"],
            2: ["person", "umbrella"], 3: ["dining table", "bowl"],
            4: ["toilet"], 5: ["car"]}


def test_object_hal_matches_jax(tmp_path):
    for text in CHAIR_CAPTIONS:
        assert object_hal.extract_coco_objects(text) == \
            jax_objhal.extract_coco_objects(text), text
    responses = [{"image_id": i, "text": c}
                 for i, c in enumerate(CHAIR_CAPTIONS)]
    assert object_hal.evaluate_chair(responses, CHAIR_GT) == \
        jax_objhal.evaluate_chair(responses, CHAIR_GT)
    syn = tmp_path / "synonyms.txt"
    syn.write_text("airplane, jet, passenger jet\nbicycle, bike, cycle\n")
    tables = object_hal.SynonymTables(object_hal.load_synonym_file(str(syn)))
    jtables = jax_objhal.SynonymTables(
        jax_objhal.load_synonym_file(str(syn)))
    for text in ("a passenger jet over a bike", CHAIR_CAPTIONS[0]):
        assert object_hal.extract_coco_objects(text, tables) == \
            jax_objhal.extract_coco_objects(text, jtables)
    for reply in ('["man", "dog"]', '```json\n["cat", "sofa"]\n```'):
        assert object_hal.parse_object_list(reply) == \
            jax_objhal.parse_object_list(reply)


class _FakeService:
    """Canned replies by prompt substring, with a call log."""

    def __init__(self, replies, default="[]"):
        self.replies = dict(replies)
        self.default = default
        self.calls = []

    def call_llm_with_messages(self, messages, **kw):
        prompt = messages[-1]["content"]
        self.calls.append(messages)
        for key, reply in self.replies.items():
            if key in prompt:
                return reply
        return self.default


def test_object_hal_gpt_extraction_matches_jax():
    """The GPT extraction mode behind a fake service: the same objects,
    metrics and API calls (short answers make none)."""
    replies = {"a man and his dog": '["man", "dog", "red frisbee"]',
               "two cats on the couch": '```json\n["cat", "cat", "sofa"]\n```',
               "What animals are shown?": '["dog"]'}
    responses = [
        {"image_id": 1, "text": "The photo shows a man and his dog."},
        {"image_id": 2, "text": "I can see two cats on the couch today."},
        {"image_id": 3, "text": "Yes."},
        {"image_id": 4, "text": "A dog is running through the park.",
         "question": "What animals are shown?"}]
    gts = {1: ["person", "dog"], 2: ["cat"], 3: ["bed"], 4: ["dog"]}
    svc, jsvc = _FakeService(replies), _FakeService(replies)
    got = object_hal.evaluate_chair(
        responses, gts, extract_objects_fn=object_hal.make_gpt_extractor(svc))
    want = jax_objhal.evaluate_chair(
        responses, gts,
        extract_objects_fn=jax_objhal.make_gpt_extractor(jsvc))
    assert got == want and svc.calls == jsvc.calls and len(svc.calls) == 3


def _mmhal_records(n):
    types = jax_mmhal.QUESTION_TYPES
    return [{"question": f"What is object {i}?",
             "image_content": ["a dog", f"a {i}-legged table"],
             "gt_answer": f"Answer {i}", "model_answer": f"Model {i}",
             "question_type": types[i % len(types)]} for i in range(n)]


def test_mmhal_matches_jax(tmp_path):
    for text in ("blah blah\nRating: 5", "no rating here",
                 "Rating: 2 ... Rating: 6"):
        assert mmhal.parse_rating(text) == jax_mmhal.parse_rating(text)
    records = _mmhal_records(mmhal.NUM_MMHAL_QUESTIONS)
    assert mmhal.build_judge_prompt(records[3]) == \
        jax_mmhal.build_judge_prompt(records[3])
    replies = {f"Model {i}": f"Fine.\nRating: {i % 7}" for i in range(96)}
    got = mmhal.judge_answers(records, _FakeService(replies),
                              reviews_out=str(tmp_path / "port.json"))
    want = jax_mmhal.judge_answers(records, _FakeService(replies),
                                   reviews_out=str(tmp_path / "jax.json"))
    assert got == want
    assert mmhal.summarize(got) == jax_mmhal.summarize(want)
    with pytest.raises(AssertionError):
        mmhal.judge_answers(records[:3], _FakeService(replies))


def test_llava_bench_matches_jax(tmp_path):
    for text in ("8 7\n\nGood answers", "garbage", "8, 6\nexplanation"):
        assert llava_bench.parse_scores(text) == \
            jax_bench.parse_scores(text)
    qs = [{"question_id": i, "text": f"Q{i}?", "image": f"img{i}.jpg"}
          for i in range(4)]
    gpt4 = [{"question_id": i, "text": f"ref {i}"} for i in range(4)]
    model = [{"question_id": i, "text": f"model {i}"} for i in range(4)]
    ctx = {"img1.jpg": "a caption"}
    replies = {"model 0": "8 6\nok", "model 1": "10 9\nok",
               "model 2": "garbage"}
    got = llava_bench.run_reviews(qs, gpt4, model, ctx,
                                  _FakeService(replies, "7 7"),
                                  out_file=str(tmp_path / "port.jsonl"))
    want = jax_bench.run_reviews(qs, gpt4, model, ctx,
                                 _FakeService(replies, "7 7"),
                                 out_file=str(tmp_path / "jax.jsonl"))
    assert got == want
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "jax.jsonl").read_text()
    assert llava_bench.summarize(got) == jax_bench.summarize(want)
    assert llava_bench.summarize([]) == jax_bench.summarize([])


RULES = {
    "default": {"role": "Assistant", "prompt": "Rate both answers 1-10."},
    "conv": {"role": "Assistant", "prompt": "Judge the conversation."},
    "llava_bench_detail": {"role": "Assistant",
                           "prompt": "Judge detail vs the captions."},
}


def _review_rows(n, category, image):
    qs = [{"question_id": i, "text": f"What is in image {i}?",
           "category": category, "image": f"{image}{i}.jpg"}
          for i in range(n)]
    a1 = [{"question_id": i, "answer_id": f"a1-{i}",
           "text": f"Ref answer {i}"} for i in range(n)]
    a2 = [{"question_id": i, "answer_id": f"a2-{i}",
           "text": f"Model answer {i}"} for i in range(n)]
    return qs, a1, a2


@pytest.mark.parametrize("bench_mode", [False, True])
def test_gpt_review_matches_jax(tmp_path, bench_mode):
    """Rule choice, the review layout, and a review run interrupted after
    two questions and resumed: the same output file and reviews."""
    for cat in ("conv", "unknown", "detail"):
        try:
            want = jax_review.pick_rule(RULES, cat, bench_mode)
        except KeyError:
            with pytest.raises(KeyError):
                gpt_review.pick_rule(RULES, cat, bench_mode)
            continue
        assert gpt_review.pick_rule(RULES, cat, bench_mode) == want
    assert gpt_review.build_review_content("Q?", "A1", "A2",
                                           RULES["default"], "ctx") == \
        jax_review.build_review_content("Q?", "A1", "A2", RULES["default"],
                                        "ctx")
    qs, a1, a2 = _review_rows(4, "detail" if bench_mode else "conv", "img")
    contexts = {f"img{i}.jpg": {"caption": [f"cap {i}", "line2"]}
                for i in range(4)}
    outs = {}
    for name, mod in (("port", gpt_review), ("jax", jax_review)):
        out = str(tmp_path / f"{name}.jsonl")
        kw = dict(contexts=contexts, bench_mode=True) if bench_mode else {}
        mod.run_reviews(qs[:2], a1[:2], a2[:2], RULES,
                        _FakeService({}, "7 9\nok"), out, **kw)
        outs[name] = mod.run_reviews(qs, a1, a2, RULES,
                                     _FakeService({}, "3 4\nok"), out, **kw)
    assert outs["port"] == outs["jax"]
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "jax.jsonl").read_text()
