"""The port's stages 1-3 against the JAX package's, on the CPU.

- Stage 3 end to end on the tiny model in f32 against the JAX ``train``
  from the same checkpoint directory, initial adapter (the JAX init, the
  vision and projector parts included, carried across) and rows: each
  micro-step's ``loss/total`` within 1e-5 and the ``checkpoint-final``
  adapter within 1e-5; the PEFT directory holds the decoder's part only.
  The CLI runs the tiny debug model with ``training.device=cpu``.
- The correction plumbing: ``parse_correction_report``,
  ``build_correction_messages``, ``get_cache_key``, ``SqliteStore`` and
  ``APIService`` equal the JAX package's on canned inputs, with the
  transport (``requests``) patched: no test reaches the network.
- Stages 1-2 against the JAX ``run`` with ``top_k`` 1 (both packages take
  the argmax whatever their generators) and a stubbed GPT-4V service: the
  same shard records, also through the slot-pool engine
  (``continuous_slots``); a rerun is a no-op; two ranks write disjoint
  shards.
- ``merge_and_filter``, ``build_opadpo_datasets``, the subsets and the
  config patch give the JAX package's rows and files.
- The four stages chained on the port alone (rollout, datasets, OPA-SFT,
  OPA-DPO), as ``tests/test_pipeline_e2e.py::test_full_pipeline`` chains
  the JAX package's.
"""

import base64
import functools
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.models import loader as jax_loader
from opadpo_tpu.models.lora import LoraConfig as JaxLoraConfig
from opadpo_tpu.parallel import mesh as jax_mesh
from opadpo_tpu.pipeline import checkpoints as jax_ckpt
from opadpo_tpu.pipeline import config as jax_config
from opadpo_tpu.pipeline import dataset_ops as jax_ops
from opadpo_tpu.pipeline import gpt4v_client as jax_api
from opadpo_tpu.pipeline import online_generation as jax_gen
from opadpo_tpu.pipeline import opa_train as jax_opa
from opadpo_tpu.pipeline import prompts as jax_prompts
from opadpo_tpu.pipeline import runtime as jax_runtime
from opadpo_torch import bridge
from opadpo_torch.engine.train_state import OptimizerConfig, TrainState
from opadpo_torch.models import llava as t_llava
from opadpo_torch.models import loader
from opadpo_torch.models.lora import LoraConfig
from opadpo_torch.pipeline import checkpoints as ckpt_lib
from opadpo_torch.pipeline import config, dataset_ops, gpt4v_client
from opadpo_torch.pipeline import online_generation, opa_train, prompts
from opadpo_torch.pipeline import runtime
from tests.torch_parity import JCFG32, TCFG32, jax_params, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VARS = ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR", "IMAGE_DIR",
            "POLICY_LORA_DIR", "API_KEY", "API_KEY0", "API_NUM", "RANK",
            "WORLD_SIZE", "AZURE_POINT", "API_MODEL")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)


def _png(seed, hw=(20, 30)):
    arr = np.random.default_rng(seed).integers(0, 255, (*hw, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def prompt_rows(n):
    return [{"queries": f"<image>\nWhat is in image {i}?",
             "image_bytes": _png(100 + i),
             "standard_response": f"A standard answer number {i}.",
             "image_id": f"img{i}.png"} for i in range(n)]


def opa_rows(n):
    return [{"queries": f"<image>\nDescribe picture {i}.",
             "image_bytes": _png(200 + i),
             "standard_response": f"It shows {i} cats on a mat.",
             "AI_pseudo_response": f"It shows {i + 1} dogs."}
            for i in range(n)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A tiny f32 checkpoint from seeded JAX weights, 6 prompt rows and 4
    OPA rows on disk."""
    from datasets import Dataset

    root = tmp_path_factory.mktemp("stages")
    model = bridge.llava_from_jax(to_np(jax_params(31)), TCFG32, device="cpu")
    loader.save_llava_checkpoint(model, str(root / "llava"),
                                 vision_in_dir=True)
    Dataset.from_list(prompt_rows(6)).save_to_disk(str(root / "prompts"))
    Dataset.from_list(opa_rows(4)).save_to_disk(str(root / "opa"))
    return {k: str(root / k) for k in ("llava", "prompts", "opa")}


def _f32(monkeypatch, seed=0):
    """Both packages read the tiny f32 model from the checkpoint and start
    from one f32 adapter, JAX's init (the port's generator draws another)."""
    monkeypatch.setattr(runtime, "llava_config_from_hf", lambda _: TCFG32)
    monkeypatch.setattr(jax_runtime, "llava_config_from_hf",
                        lambda _: JCFG32)
    monkeypatch.setattr(jax_loader, "load_llava_checkpoint", functools.partial(
        jax_loader.load_llava_checkpoint, dtype=jnp.float32))
    monkeypatch.setattr(jax_runtime, "make_mesh", lambda c=None: (
        jax_mesh.make_mesh(c, jax.devices()[:1])))
    monkeypatch.setattr(jax_opa, "LoraConfig", functools.partial(
        JaxLoraConfig, dtype=jnp.float32))
    monkeypatch.setattr(opa_train, "LoraConfig", functools.partial(
        LoraConfig, dtype=torch.float32))

    def init_from_jax(cfg, lora_cfg, generator, include_vision=False):
        jcfg = JaxLoraConfig(rank=lora_cfg.rank, alpha=lora_cfg.alpha,
                             dtype=jnp.float32)
        return bridge.lora_from_jax(to_np(jax_llava.init_lora(
            jax.random.PRNGKey(seed), JCFG32, jcfg,
            include_vision=include_vision)), "cpu")

    monkeypatch.setattr(t_llava, "init_lora", init_from_jax)


def _cfg(mod, out, base, data, **training):
    t = dict(output_dir=out, seed=0, device="cpu")
    t.update(training)
    return mod.Config({
        "base_model": base, "image_checkpoint": None,
        "debug": {"fake_tokenizer": True},
        "model": {"skip_loading_weights": False}, "mesh": {"model": 1},
        "data": {"data_path": data}, "training": t})


def _log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# Stage 3
# ---------------------------------------------------------------------------

STAGE3 = dict(num_train_epochs=1, per_device_train_batch_size=2,
              gradient_accumulation_steps=2, save_steps=1, logging_steps=1,
              query_len=64, response_len=48, lora_r=4, lora_alpha=8,
              learning_rate=1e-3, warmup_ratio=0.0, tune_vision_tower=True)


def test_stage3_matches_jax_train(tmp_path, monkeypatch, inputs):
    """4 rows -> 8 SFT examples -> 4 micro-steps of 2, averaged in pairs:
    every micro-step's ``loss/total`` within 1e-5 of the JAX package's,
    ``checkpoint-1``, ``checkpoint-2``, ``checkpoint-final`` and
    ``completed`` written, the final adapter (decoder, vision blocks,
    projector) within 1e-5 of the JAX one and moved from the init, and the
    PEFT directory holding the decoder's entries only."""
    import orbax.checkpoint as ocp

    _f32(monkeypatch)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    timer = opa_train.train(_cfg(config, port_out, inputs["llava"],
                                 inputs["opa"], **STAGE3))
    jax_opa.train(_cfg(jax_config, jax_out, inputs["llava"], inputs["opa"],
                       **STAGE3))
    assert [e["name"] for e in timer.history] == ["sft_step"] * 4
    got, want = _log(port_out), _log(jax_out)
    assert [e["step"] for e in got] == [e["step"] for e in want] \
        == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert np.isfinite(g["loss/total"])
        for key in ("loss/total", "loss/base_sft", "loss/grad_norm"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-5, rtol=1e-5,
                                       err_msg=key)
    for name in ("checkpoint-1", "checkpoint-2", "checkpoint-final",
                 "completed", "config.yaml"):
        assert os.path.exists(os.path.join(port_out, name)), name

    final = os.path.join(port_out, "checkpoint-final")
    init = t_llava.init_lora(TCFG32, LoraConfig(rank=4, alpha=8.0), None,
                             include_vision=True)
    state = TrainState.create(init, OptimizerConfig(grad_accum_steps=2))
    start = jax.tree_util.tree_map(np.copy, bridge.lora_to_jax(init))
    ckpt_lib.restore_train_state(final, state, TCFG32.llama)
    ported = bridge.lora_to_jax(state.params)
    ref = ocp.StandardCheckpointer().restore(os.path.abspath(os.path.join(
        jax_out, "checkpoint-final", "adapter_full.ckpt")))["params"]
    leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
    moved = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ported):
        np.testing.assert_allclose(leaf, np.asarray(leaves[path]), atol=1e-5,
                                   rtol=0, err_msg=str(path))
        part = path[0].key
        diff = np.abs(leaf - dict(
            jax.tree_util.tree_leaves_with_path(start))[path]).max()
        moved[part] = max(moved.get(part, 0.0), float(diff))
    assert set(moved) == {"llama", "vision", "projector"}
    assert min(moved.values()) > 1e-4, moved
    peft = torch.load(os.path.join(final, "adapter_model", "lora_policy",
                                   "adapter_model.bin"), weights_only=True)
    want_keys = set(jax_loader.lora_to_peft_state(
        {"llama": {"layers": ref["llama"]["layers"]}}))
    assert set(peft) == want_keys
    assert all(k.startswith("base_model.model.model.layers.") for k in peft)


def test_stage3_refuses_a_tensor_parallel_mesh(tmp_path, inputs):
    """``mesh.model: 2`` in one process, with no process group: the
    mesh's resolve error, as the JAX package raises it (tensor parallelism
    runs under ``torchrun``, ``tests/test_torch_parallel_pipeline.py``)."""
    cfg = _cfg(config, str(tmp_path), inputs["llava"], inputs["opa"])
    cfg["mesh"]["model"] = 2
    with pytest.raises(ValueError, match=r"mesh 0x2 != 1 devices"):
        opa_train.train(cfg)


def test_stage3_cli_runs_the_tiny_debug_model(tmp_path, inputs):
    """``python -m opadpo_torch.pipeline.opa_train --config ... k=v`` on
    the tiny random model (``debug.tiny``, the character tokenizer, the
    vision adapter on) from the dataset directory, on the CPU."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "opadpo_torch.pipeline.opa_train",
           "--config", os.path.join(ROOT, "configs", "llava_opa.yaml"),
           "debug.tiny=true", "model.skip_loading_weights=true",
           f"data.data_path={inputs['opa']}", f"training.output_dir={out}",
           "training.device=cpu", "training.num_train_epochs=1",
           "training.per_device_train_batch_size=4",
           "training.gradient_accumulation_steps=1",
           "training.logging_steps=1", "training.lora_r=4",
           "training.lora_alpha=8"]
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (out / "completed").exists()
    final = out / "checkpoint-final"
    assert (final / "adapter_model" / "lora_policy"
            / "adapter_config.json").exists()
    saved = torch.load(final / "adapter_full.pt", weights_only=True)
    assert any(k.startswith("/vision/") for k in saved)
    assert any(k.startswith("/projector/") for k in saved)
    lines = _log(str(out))
    assert len(lines) == 2 and all(np.isfinite(x["loss/total"])
                                   for x in lines)


# ---------------------------------------------------------------------------
# The correction plumbing
# ---------------------------------------------------------------------------

REPORT = {
    "image description": "ignored",
    "sentence_1": {"copied_content": "A cat sits.", "score": 1,
                   "error_type": "image_recognition_error",
                   "rewritten_content": "A dog sits."},
    "sentence 2": {"copied content": "On a mat.", "score": 4,
                   "rewritten content": "On a mat."},
    "Added": {"rewritten_content": "It is sunny.",
              "copied_content": "never copied"},
}
REPORT_TEXTS = [
    "```json\n" + json.dumps(REPORT) + "\n```",
    "Sure: " + json.dumps(REPORT) + " hope it helps",
    json.dumps({"sentence_1": {"rewritten_content": ""}}),   # empty rewrite
    "not json at all",
    json.dumps({"sentence_1": "a string entry",
                "sentence_2": {"rewritten content": "Only this."}}),
]


@pytest.mark.parametrize("text", REPORT_TEXTS)
def test_parse_correction_report_matches_jax(text):
    assert online_generation.parse_correction_report(text, "orig") == \
        jax_gen.parse_correction_report(text, "orig")


def test_correction_messages_and_cache_key_match_jax():
    args = ("What is here?", "A cat.", "aGVsbG8=")
    for kw in ({}, {"standard_response": "A dog."}):
        msgs = prompts.build_correction_messages(*args, **kw)
        assert msgs == jax_prompts.build_correction_messages(*args, **kw)
        for params in ({}, {"temperature": 0.0, "max_tokens": 2048}):
            assert gpt4v_client.get_cache_key("m", msgs, **params) == \
                jax_api.get_cache_key("m", msgs, **params)
    assert prompts.CORRECTION_SYSTEM_PROMPT == \
        jax_prompts.CORRECTION_SYSTEM_PROMPT


class _FakeRequests:
    """The ``requests`` surface ``APIService`` uses: each ``post`` answers
    with the next status of ``statuses`` and records its call."""

    def __init__(self, statuses, text="corrected"):
        self.statuses, self.text, self.calls = list(statuses), text, []

    def post(self, url, headers=None, json=None, timeout=None):
        self.calls.append((url, headers, json))
        status = self.statuses.pop(0)
        text = self.text

        class Response:
            status_code = status

            @staticmethod
            def json():
                return {"choices": [{"message": {"content": text}}]}

        Response.text = "error body"
        return Response


@pytest.mark.parametrize("mod", [gpt4v_client, jax_api],
                         ids=["port", "jax"])
def test_api_service_retries_caches_and_picks_keys(tmp_path, monkeypatch,
                                                   mod):
    """Against a patched transport: a failed attempt is retried, the answer
    cached in the sqlite store (a second call posts nothing), and the
    per-rank key and endpoint picked as the JAX package picks them; the
    port's store reads what the JAX package's wrote."""
    fake = _FakeRequests([500, 200])
    monkeypatch.setitem(sys.modules, "requests", fake)
    monkeypatch.setenv("API_NUM", "2")
    monkeypatch.setenv("API_KEY1", "k1")
    monkeypatch.setenv("AZURE_POINT1", "https://x.azure.example/")
    db = str(tmp_path / "h.sqlite")
    api = mod.get_api_service(rank=3, cache_path=db)
    ref = jax_api.get_api_service(rank=3, cache_path=str(tmp_path / "j.db"))
    assert (api._url(), api._headers()) == (ref._url(), ref._headers())
    assert api.api_key == "k1" and api.is_azure
    api.retry_sleep = 0.0
    msgs = prompts.build_correction_messages("q", "r", "aW1n")
    assert api.call_llm_with_messages(msgs) == "corrected"
    assert len(fake.calls) == 2
    assert api.call_llm_with_messages(msgs) == "corrected"
    assert len(fake.calls) == 2
    key = jax_api.get_cache_key(api.model, msgs, temperature=0.0,
                                max_tokens=2048)
    assert gpt4v_client.SqliteStore(db).get(key) == "corrected"
    assert jax_api.SqliteStore(db).get(key) == "corrected"
    failing = _FakeRequests([503] * 3)
    monkeypatch.setitem(sys.modules, "requests", failing)
    api.max_retries = 3
    with pytest.raises(RuntimeError, match="after 3 retries"):
        api.call_llm_with_messages(msgs, use_cache=False)


# ---------------------------------------------------------------------------
# Stages 1-2
# ---------------------------------------------------------------------------

class _StubService:
    """A GPT-4V service that answers every call with a report built from
    the audited answer, so the records show which answer it saw."""

    model = "stub"

    def call_llm_with_messages(self, messages):
        text = messages[1]["content"][1]["text"]
        answer = text.split("Answer to audit: ")[1].split("\n")[0]
        return json.dumps({"sentence_1": {
            "copied_content": answer, "score": 2,
            "rewritten_content": f"Fixed {len(answer)} chars."}})


ROLLOUT = dict(query_len=64, response_len=8, rollout_per_device_batch_size=2,
               top_k=1, top_p=0.95, temperature=1.0)


def _shards(out):
    d = os.path.join(out, "rollouts")
    return {name: json.load(open(os.path.join(d, name)))
            for name in sorted(os.listdir(d))}


def test_stages12_match_jax_run_and_resume_is_noop(tmp_path, monkeypatch,
                                                   inputs):
    """6 prompts in steps of 2 with ``top_k`` 1 and the stubbed service
    (a dummy ``API_KEY`` takes the threaded path): the three shards equal
    the JAX package's record for record; a second run samples nothing and
    rewrites no shard."""
    _f32(monkeypatch)
    monkeypatch.setenv("API_KEY", "dummy")
    for mod in (online_generation, jax_gen):
        monkeypatch.setattr(mod, "get_api_service",
                            lambda rank=0, cache_path="": _StubService())
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    timer = online_generation.run(_cfg(config, port_out, inputs["llava"],
                                       inputs["prompts"], **ROLLOUT))
    jax_gen.run(_cfg(jax_config, jax_out, inputs["llava"],
                     inputs["prompts"], **ROLLOUT))
    assert [e["name"] for e in timer.history] == ["sample"] * 3
    got, want = _shards(port_out), _shards(jax_out)
    assert list(got) == ["step1_rank0.json", "step2_rank0.json",
                         "step3_rank0.json"]
    assert got == want
    recs = [r for shard in got.values() for r in shard]
    assert all(r["API_success"] and r["AI_pseudo_response"].startswith(
        "Fixed") for r in recs)
    assert any(r["original_generate_response"] for r in recs)
    mtimes = {n: os.path.getmtime(os.path.join(port_out, "rollouts", n))
              for n in got}
    again = online_generation.run(_cfg(config, port_out, inputs["llava"],
                                       inputs["prompts"], **ROLLOUT))
    assert again.history == []
    assert mtimes == {n: os.path.getmtime(os.path.join(port_out, "rollouts",
                                                       n)) for n in got}


def test_stages12_two_ranks_write_disjoint_shards(tmp_path, monkeypatch,
                                                  inputs):
    """Two ranks (``RANK`` / ``WORLD_SIZE`` 2), dry run: each writes its
    own shards over rows rank::2, which merge back to all 6 rows; the
    per-rank resume counts each rank's shards alone."""
    _f32(monkeypatch)
    out = str(tmp_path / "gen")
    monkeypatch.setenv("WORLD_SIZE", "2")
    for rank in (0, 1):
        monkeypatch.setenv("RANK", str(rank))
        online_generation.run(_cfg(config, out, inputs["llava"],
                                   inputs["prompts"], **ROLLOUT))
    shards = _shards(out)
    assert list(shards) == ["step1_rank0.json", "step1_rank1.json",
                            "step2_rank0.json", "step2_rank1.json"]
    ids = {r: {x["image_id"] for n, s in shards.items()
               if n.endswith(f"rank{r}.json") for x in s} for r in (0, 1)}
    assert ids == {0: {"img0.png", "img2.png", "img4.png"},
                   1: {"img1.png", "img3.png", "img5.png"}}
    assert all(x["AI_json_report"] == "" and not x["API_success"]
               for s in shards.values() for x in s)
    rollouts = os.path.join(out, "rollouts")
    os.remove(os.path.join(rollouts, "step2_rank0.json"))
    assert ckpt_lib.find_max_step(rollouts, rank=0) == \
        jax_ckpt.find_max_step(rollouts, rank=0) == 1
    assert ckpt_lib.find_max_step(rollouts, rank=1) == 2
    assert ckpt_lib.find_max_step(rollouts) == 2
    assert ckpt_lib.find_max_step(str(tmp_path / "none")) == 0


def test_stages12_refuse_the_continuous_engine(tmp_path, monkeypatch,
                                              inputs):
    """``training.continuous_slots``, refused before the slot pool was
    ported, now routes the rollout through it: 2 slots, segments of 3
    tokens, the int8 pool, ``top_k`` 1, the dry run; the shards equal the
    JAX ``run``'s at the same settings record for record."""
    _f32(monkeypatch)
    slots = dict(ROLLOUT, continuous_slots=2, continuous_seg_len=3)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    timer = online_generation.run(_cfg(config, port_out, inputs["llava"],
                                       inputs["prompts"], **slots))
    jax_gen.run(_cfg(jax_config, jax_out, inputs["llava"],
                     inputs["prompts"], **slots))
    assert [e["name"] for e in timer.history] == ["sample"] * 3
    got, want = _shards(port_out), _shards(jax_out)
    assert len(got) == 3 and got == want
    assert any(r["original_generate_response"] for shard in got.values()
               for r in shard)


# ---------------------------------------------------------------------------
# Dataset construction
# ---------------------------------------------------------------------------

def _rollout_records(n=8):
    report = json.dumps({"sentence_1": {"copied content": "x",
                                        "rewritten content": "y"}})
    recs = []
    for i in range(n):
        recs.append({
            "query": ("A chat. USER:  \nWhat is shown? ASSISTANT:" if i % 2
                      else "<image>\nWhat is shown?"),
            "image_id": f"img{i}.png", "image_bytes": _png(300 + i),
            "standard_response": f"Std {i}.",
            "original_generate_response": f"It is thing {i}. It is red.",
            "AI_pseudo_response": f"It is item {i}.",
            "AI_json_report": report})
    recs[1]["AI_json_report"] = ""                      # empty report
    recs[2]["original_generate_response"] = "A cat. A dog. A cat."
    recs[3]["original_generate_response"] = "go " * 40 + "go"
    recs[4]["AI_pseudo_response"] = ""                  # empty pseudo
    recs[5]["AI_json_report"] = {"sentence_1": {"score": 3}}   # not a str
    return recs


def test_dataset_ops_match_jax(tmp_path):
    """Shards in two run directories (one missing): the merged and filtered
    records, both written datasets, the prompt subsets and the patched
    config equal the JAX package's."""
    from datasets import Dataset, load_from_disk

    recs = _rollout_records()
    for d, part in (("a", recs[:5]), ("b", recs[5:])):
        os.makedirs(tmp_path / d)
        for j in range(0, len(part), 2):
            with open(tmp_path / d / f"step{j + 1}_rank0.json", "w") as f:
                json.dump(part[j:j + 2], f)
    dirs = [str(tmp_path / x) for x in ("a", "b", "missing")]
    got = dataset_ops.merge_and_filter(dirs)
    assert got == jax_ops.merge_and_filter(dirs)
    assert [r["image_id"] for r in got] == ["img0.png", "img5.png",
                                            "img6.png", "img7.png"]
    assert got[1]["query"] == "<image>\nWhat is shown? ASSISTANT:"
    paths = {}
    for name, mod in (("port", dataset_ops), ("jax", jax_ops)):
        paths[name] = (str(tmp_path / name / "opa"),
                       str(tmp_path / name / "dpo"))
        mod.build_opadpo_datasets(dirs, *paths[name])
    for i in range(2):
        assert load_from_disk(paths["port"][i]).to_list() == \
            load_from_disk(paths["jax"][i]).to_list()
    cols = dataset_ops.opa_columns(got)
    assert load_from_disk(paths["port"][0]).to_list() == [
        dict(zip(cols, v)) for v in zip(*cols.values())]

    pool = str(tmp_path / "pool")
    Dataset.from_dict({"queries": [f"q{i}" for i in range(12)],
                       "origin_dataset": ["a", "b", "b"] * 4}
                      ).save_to_disk(pool)
    for name, mod in (("port", dataset_ops), ("jax", jax_ops)):
        mod.build_online_generation_subsets(pool, str(tmp_path / f"s{name}"),
                                            num_subsets=3, subset_size=4)
    for k in (1, 2, 3):
        assert load_from_disk(str(tmp_path / f"sport/subset{k}")).to_list() \
            == load_from_disk(str(tmp_path / f"sjax/subset{k}")).to_list()

    texts = {}
    for name, mod in (("port", dataset_ops), ("jax", jax_ops)):
        os.makedirs(tmp_path / f"m{name}")
        with open(tmp_path / f"m{name}" / "config.json", "w") as f:
            json.dump({"hidden_size": 8}, f)
        mod.patch_model_config(str(tmp_path / f"m{name}"), "/clip")
        texts[name] = (tmp_path / f"m{name}" / "config.json").read_text()
    assert texts["port"] == texts["jax"]


def test_dataset_writers_need_datasets(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        dataset_ops.build_opadpo_datasets([str(tmp_path)], "a", "b")
    with pytest.raises(ImportError, match="datasets"):
        dataset_ops.build_online_generation_subsets(str(tmp_path), "x")


# ---------------------------------------------------------------------------
# The four stages on the port alone
# ---------------------------------------------------------------------------

def _tiny_cfg(out, data, **training):
    return config.Config({
        "debug": {"tiny": True}, "model": {"skip_loading_weights": True},
        "mesh": {"model": 1}, "data": {"data_path": data},
        "training": {"output_dir": out, "seed": 0, "device": "cpu",
                     **training}})


def test_four_stages_chain_on_the_port(tmp_path, monkeypatch, inputs):
    """Rollout (16 prompts, the stubbed service), dataset construction,
    OPA-SFT with the vision adapter, then OPA-DPO from the OPA dataset's
    sibling, all on the tiny random model on the CPU."""
    from datasets import Dataset, load_from_disk

    prompts_dir = str(tmp_path / "prompts")
    Dataset.from_list(prompt_rows(16)).save_to_disk(prompts_dir)
    monkeypatch.setenv("API_KEY", "dummy")
    monkeypatch.setattr(online_generation, "get_api_service",
                        lambda rank=0, cache_path="": _StubService())
    gen_out = str(tmp_path / "gen")
    online_generation.run(_tiny_cfg(gen_out, prompts_dir, query_len=64,
                                    response_len=8,
                                    rollout_per_device_batch_size=8))
    rollouts = os.path.join(gen_out, "rollouts")
    assert sorted(os.listdir(rollouts)) == ["step1_rank0.json",
                                            "step2_rank0.json"]

    opa_data, dpo_data = str(tmp_path / "opa"), str(tmp_path / "dpo")
    dataset_ops.build_opadpo_datasets([rollouts], opa_data, dpo_data)
    assert len(load_from_disk(dpo_data)) == 16

    opa_out = str(tmp_path / "opa_out")
    opa_train.train(_tiny_cfg(opa_out, opa_data, num_train_epochs=1,
                              per_device_train_batch_size=8,
                              gradient_accumulation_steps=2,
                              logging_steps=1, query_len=64,
                              response_len=32, lora_r=4, lora_alpha=8,
                              tune_vision_tower=True))
    assert ckpt_lib.get_last_checkpoint(opa_out)[1]
    assert os.path.isdir(os.path.join(opa_out, "checkpoint-final",
                                      "adapter_model", "lora_policy"))
    assert len(_log(opa_out)) == 4

    from opadpo_torch.pipeline import opadpo_train
    dpo_out = str(tmp_path / "dpo_out")
    opadpo_train.train(_tiny_cfg(
        dpo_out, dpo_data, total_epochs=1, max_step=2, rollout_batch_size=8,
        step_batch_size=8, rollout_per_device_batch_size=4,
        step_per_device_batch_size=4, noptepochs=1, save_steps=1,
        query_len=256, response_len=16, lora_r=4, lora_alpha=8, CoPO=True,
        CoPO_method="random", AncPO=True, warmup_steps=0))
    assert os.path.isdir(os.path.join(dpo_out, "checkpoint-2"))
    lines = _log(dpo_out)
    assert len(lines) == 2 and np.isfinite(lines[-1]["loss/total"])
