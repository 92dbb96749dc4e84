"""The port's eval drivers (``opadpo_torch.eval``) against the JAX
package's on the CPU, on the tiny LLaVA in f32 with the JAX weights carried
across, the test tokenizer, and the same question files with PNG images:
``run_inference`` in batch mode and through the slot pool
(``continuous_slots``), ``run_logit_inference``, ``run_text_qa``, the
ScienceQA driver and ``run_all --benchmarks pope`` from one checkpoint
directory.  Every answer line equals the JAX line apart from its
``answer_id`` (a uuid); the logit readout's probabilities agree to 1e-5.
"""

import functools
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from opadpo_tpu.eval import model_qa as jax_qa
from opadpo_tpu.eval import model_vqa as jax_vqa
from opadpo_tpu.eval import model_vqa_logit as jax_logit
from opadpo_tpu.eval import model_vqa_science as jax_science
from opadpo_tpu.eval import run_all as jax_run_all
from opadpo_tpu.models import loader as jax_loader
from opadpo_tpu.pipeline import runtime as jax_runtime
from opadpo_torch import bridge
from opadpo_torch.eval import model_qa, model_vqa, model_vqa_logit
from opadpo_torch.eval import model_vqa_science, run_all
from opadpo_torch.models import loader
from opadpo_torch.pipeline import runtime
from tests.fake_tokenizer import FakeTokenizer
from tests.torch_parity import (
    JCFG32, TCFG32, jax_params, to_np, torch_model,
)

PARAMS = jax_params()
MODEL = torch_model(PARAMS)


def _lines(path, drop=("answer_id",)):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop}
                for line in f]


def _pope_file(path, img_dir, n, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            name = f"img{seed}_{i}.png"
            Image.fromarray(rng.integers(0, 255, (30, 40, 3),
                                         dtype=np.uint8)).save(
                os.path.join(img_dir, name))
            f.write(json.dumps({
                "question_id": i, "image": name,
                "text": f"Is there a {['dog', 'cat', 'car'][i % 3]} in "
                        f"image {i}?",
                "label": "yes" if (i + seed) % 2 == 0 else "no"}) + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny f32 checkpoint directory, and POPE-style question files (three
    splits of 3 and one of 5) with their PNG images."""
    root = tmp_path_factory.mktemp("eval")
    loader.save_llava_checkpoint(
        bridge.llava_from_jax(to_np(PARAMS), TCFG32, device="cpu"),
        str(root / "llava"), vision_in_dir=True)
    imgs = root / "imgs"
    (root / "data" / "pope").mkdir(parents=True)
    imgs.mkdir()
    for k, split in enumerate(("random", "popular", "adversarial")):
        _pope_file(str(root / "data" / "pope" / f"coco_pope_{split}.jsonl"),
                   str(imgs), 3, 10 + k)
    _pope_file(str(root / "q.jsonl"), str(imgs), 5, 1)
    return root


@pytest.fixture
def f32(monkeypatch):
    """Both packages' config readers to the tiny f32 model, JAX's loader
    to f32 and its tokenizer to the test tokenizer."""
    monkeypatch.setattr(runtime, "llava_config_from_hf", lambda _: TCFG32)
    monkeypatch.setattr(jax_runtime, "llava_config_from_hf",
                        lambda _: JCFG32)
    monkeypatch.setattr(jax_runtime, "load_tokenizer",
                        lambda *_a, **_k: FakeTokenizer())
    monkeypatch.setattr(jax_loader, "load_llava_checkpoint", functools.partial(
        jax_loader.load_llava_checkpoint, dtype=jnp.float32))


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_run_inference_matches_jax(tmp_path, data, mode):
    """Five questions, batch 2 at kv 16 (short_eval, 4 tokens), or two
    slots with segments of 2 tokens (int8 pool): the same answer lines.
    The slot pool answers what the batch sampler answers at kv 8."""
    qs = list(model_vqa.iter_jsonl_questions(str(data / "q.jsonl")))
    kw = dict(batch_size=2, max_new_tokens=4, temperature=0.0,
              short_eval=True, query_len=64)
    if mode == "continuous":
        kw.update(continuous_slots=2, seg_len=2)
    ref, got = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jax_vqa.run_inference(PARAMS, JCFG32, FakeTokenizer(), qs,
                          str(data / "imgs"), str(ref), **kw)
    ran = model_vqa.run_inference(MODEL, FakeTokenizer(), qs,
                                  str(data / "imgs"), str(got), **kw)
    assert _lines(got) == _lines(ref)
    assert [r["question_id"] for r in _lines(got)] == list(range(5))
    if mode == "continuous":
        assert sum(ran["engine"]["admit_groups"]) == 5
        kv8 = tmp_path / "kv8.jsonl"
        model_vqa.run_inference(MODEL, FakeTokenizer(), qs,
                                str(data / "imgs"), str(kv8), kv_bits=8,
                                **{k: v for k, v in kw.items()
                                   if k not in ("continuous_slots",
                                                "seg_len")})
        assert [r["text"] for r in _lines(kv8)] == \
            [r["text"] for r in _lines(got)]
    else:
        assert len(ran["batches"]) == 3


def test_logit_inference_matches_jax(tmp_path, data):
    qs = list(model_vqa.iter_jsonl_questions(str(data / "q.jsonl")))
    ref, got = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    tok = FakeTokenizer()
    assert model_vqa_logit.yes_no_token_ids(tok) == \
        jax_logit.yes_no_token_ids(tok)
    jax_logit.run_logit_inference(PARAMS, JCFG32, tok, qs,
                                  str(data / "imgs"), str(ref),
                                  batch_size=2, query_len=64)
    model_vqa_logit.run_logit_inference(MODEL, tok, qs, str(data / "imgs"),
                                        str(got), batch_size=2,
                                        query_len=64)
    probs = ("p_yes", "p_no")
    assert _lines(got, probs) == _lines(ref, probs)
    for a, b in zip(_lines(got), _lines(ref)):
        for k in probs:
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)


def test_text_qa_matches_jax(tmp_path):
    qs = [{"question_id": i, "text": t} for i, t in enumerate(
        ["What is two plus two?", "Name a colour.", "Why is the sky blue?"])]
    ref, got = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    tok = FakeTokenizer()
    jax_qa.run_text_qa(PARAMS, JCFG32.llama, tok, qs, str(ref),
                       batch_size=2, max_new_tokens=6)
    model_qa.run_text_qa(MODEL, tok, qs, str(got), batch_size=2,
                         max_new_tokens=6)
    assert _lines(got) == _lines(ref)
    assert any(r["text"] for r in _lines(got))


def test_science_driver_matches_jax(tmp_path, monkeypatch, data, f32):
    """The ScienceQA CLI from the checkpoint against the JAX one: its
    prompts, answer lines and scores."""
    items = []
    for i in range(3):
        os.makedirs(tmp_path / "imgs" / f"s{i}", exist_ok=True)
        Image.fromarray(np.full((20, 24, 3), 40 * i, np.uint8)).save(
            tmp_path / "imgs" / f"s{i}" / "image.png")
        items.append({"id": f"s{i}", "image": "image.png",
                      "question": f"Which is heavier? ({i})",
                      "hint": "Weights." if i else "",
                      "choices": ["a stone", "a leaf", "a feather"],
                      "answer": i % 3})
    items.append({"id": "s3", "question": "No image here.",
                  "choices": ["x", "y"], "answer": 1})
    qfile = tmp_path / "problems.json"
    qfile.write_text(json.dumps(items))
    qs = model_vqa_science.science_questions(str(qfile), "")
    assert qs == jax_science.science_questions(str(qfile), "")
    for text in ("The answer is (B).", "b", "C) a feather", "None"):
        assert model_vqa_science.parse_answer_letter(text) == \
            jax_science.parse_answer_letter(text)
    argv = ["--model-path", str(data / "llava"), "--question-file",
            str(qfile), "--image-folder", str(tmp_path / "imgs"),
            "--batch-size", "2"]
    got = model_vqa_science.main(
        argv + ["--answers-file", str(tmp_path / "port.jsonl"), "--device",
                "cpu"], tokenizer=FakeTokenizer())
    monkeypatch.setattr(sys, "argv", ["model_vqa_science"] + argv + [
        "--answers-file", str(tmp_path / "jax.jsonl")])
    jax_science.main()
    assert _lines(tmp_path / "port.jsonl") == _lines(tmp_path / "jax.jsonl")
    assert got == jax_science.score_science(str(tmp_path / "jax.jsonl"), [
        q for q in qs if q["image"]])
    assert got["num_questions"] == 3


def test_run_all_pope_matches_jax(tmp_path, monkeypatch, data, f32):
    """``run_all --benchmarks pope`` from the checkpoint on both packages:
    three splits of 3 questions, batch 2, 64 tokens; every answer file's
    lines and ``eval_results.json`` equal."""
    argv = ["--model-path", str(data / "llava"), "--data-root",
            str(data / "data"), "--image-root", str(data / "imgs"),
            "--benchmarks", "pope", "--batch-size", "2"]
    results, runs = run_all.main(
        argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"],
        tokenizer=FakeTokenizer())
    monkeypatch.setattr(sys, "argv", ["run_all"] + argv + [
        "--output-dir", str(tmp_path / "jax")])
    jax_run_all.main()
    for split in ("random", "popular", "adversarial"):
        name = f"pope_{split}.jsonl"
        assert _lines(tmp_path / "port" / name) == \
            _lines(tmp_path / "jax" / name), split
        assert results[f"pope_{split}"]["num_examples"] == 3
    with open(tmp_path / "jax" / "eval_results.json") as f:
        assert json.load(f) == results
    assert set(runs) == {"pope_random", "pope_popular",
                         "pope_adversarial"}
    assert all(len(r["batches"]) == 2 for r in runs.values())


def test_question_readers_match_jax(tmp_path):
    """The AMBER and MMHal readers and ``build_prompt`` give the JAX
    package's questions and prompts."""
    amber_q = tmp_path / "query_all.json"
    amber_q.write_text(json.dumps([{"id": i, "image": f"AMBER_{i}.jpg",
                                    "query": f"Describe image {i}."}
                                   for i in range(3)]))
    mmhal_t = tmp_path / "response_template.json"
    mmhal_t.write_text(json.dumps([
        {"question": "What is it?", "image_src": "http://x/1.jpg",
         "question_type": "attribute", "gt_answer": "a dog"},
        {"question": "How many?", "image_path": "2.jpg",
         "image_src": "http://x/2.jpg", "gt_answer": "two"}]))
    for port, ref, path in (
            (model_vqa.iter_amber_questions, jax_vqa.iter_amber_questions,
             amber_q),
            (model_vqa.iter_mmhal_questions, jax_vqa.iter_mmhal_questions,
             mmhal_t),
            (model_vqa.iter_jsonl_questions, jax_vqa.iter_jsonl_questions,
             None)):
        if path is None:
            path = tmp_path / "q.jsonl"
            path.write_text('{"question_id": 1, "text": "a"}\n\n'
                            '{"question_id": 2, "text": "b <image>"}\n')
        assert list(port(str(path))) == list(ref(str(path)))
    for q in ("Is there a dog?", "<image>\nWhat is here?"):
        for short in (False, True):
            assert model_vqa.build_prompt(q, short) == \
                jax_vqa.build_prompt(q, short)


def test_qa_baseline_matches_jax(tmp_path, monkeypatch):
    """The chat-API baseline with the service faked in both packages: the
    same answer lines, the model name passed on."""
    from opadpo_tpu.eval import qa_baseline as jax_baseline
    from opadpo_torch.eval import qa_baseline

    class FakeApi:
        model = "default"

        def call_llm_with_messages(self, messages, **kw):
            return f"  {self.model}: {messages[-1]['content'][::-1]} "

    for mod in (qa_baseline, jax_baseline):
        monkeypatch.setattr(mod, "get_api_service", FakeApi)
    qfile = tmp_path / "q.jsonl"
    qfile.write_text("".join(json.dumps({"question_id": i,
                                         "text": f"question {i}?"}) + "\n"
                             for i in range(3)))
    argv = ["--question-file", str(qfile), "--model", "gpt-x"]
    qa_baseline.main(argv + ["--answers-file", str(tmp_path / "port.jsonl")])
    monkeypatch.setattr(sys, "argv", ["qa_baseline"] + argv + [
        "--answers-file", str(tmp_path / "jax.jsonl")])
    jax_baseline.main()
    got = _lines(tmp_path / "port.jsonl")
    assert got == _lines(tmp_path / "jax.jsonl")
    assert got[0]["text"] == "gpt-x: ?0 noitseuq" and len(got) == 3
