"""The port's stage-4 modules against the JAX package's, on the CPU.

- The YAML subset reader equals ``yaml.safe_load`` on every file under
  ``configs/``; ``load_config`` / ``apply_overrides`` equal the JAX
  package's on each top-level config; ``save_config`` round-trips.
- The checkpoint contract: discovery, ``completed``, the save / restore
  round trip (the gradient accumulator mid-accumulation included).
- ``preprocess``, ``split_query_response``, the three collators, the three
  datasets and the ``DataLoader`` order equal the JAX package's on the
  same rows with the character tokenizer: exactly.
- Stage 4 end to end on the tiny model in f32 against the JAX ``train``,
  from the same checkpoint directory, adapter and rows (CoPO off, whose
  masks come from different generators): ``loss/total`` of each step
  within 1e-5 and the final PEFT adapter within 1e-5.
- Resume: a run stopped after step 1 and resumed equals an uninterrupted
  2-step run bitwise (CoPO on); a completed run is a no-op.
"""

import base64
import functools
import glob
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from opadpo_tpu.data import collators as jax_collators
from opadpo_tpu.data import datasets as jax_datasets
from opadpo_tpu.data import loading as jax_loading
from opadpo_tpu.data import tokenization as jax_tok
from opadpo_tpu.models import loader as jax_loader
from opadpo_tpu.parallel import mesh as jax_mesh
from opadpo_tpu.pipeline import config as jax_config
from opadpo_tpu.pipeline import opadpo_train as jax_train
from opadpo_tpu.pipeline import runtime as jax_runtime
from opadpo_tpu.utils import metrics as jax_metrics
from opadpo_torch import bridge
from opadpo_torch.constants import ASSISTANT_TAIL_TOKENS
from opadpo_torch.data import collators, datasets, loading, tokenization
from opadpo_torch.data.char_tokenizer import CharTokenizer
from opadpo_torch.engine.train_state import AdamW, OptimizerConfig, TrainState
from opadpo_torch.models import loader
from opadpo_torch.models.lora import LoraConfig, named_leaves, make_trainable
from opadpo_torch.pipeline import checkpoints as ckpt_lib
from opadpo_torch.pipeline import config
from opadpo_torch.pipeline import opadpo_train
from opadpo_torch.pipeline import runtime
from opadpo_torch.utils import metrics
from tests.fake_tokenizer import FakeTokenizer
from tests.torch_parity import (
    JCFG32, TCFG32, jax_llama_lora, jax_params, to_np,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                              recursive=True))
TOP_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR", "IMAGE_DIR",
                "POLICY_LORA_DIR"):
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", YAML_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_yaml_reader_matches_pyyaml(path):
    text = open(path).read()
    assert config.parse_yaml(text) == yaml.safe_load(text)


OVERRIDES = ["training.learning_rate=5.0e-7", "mesh.model=2",
             "training.seed=7", "new.nested.key=abc", "training.CoPO=off",
             "data.data_path=null", "--training.lora_r=64",
             "training.tags=[a, 1, 2.5]"]


@pytest.mark.parametrize("path", TOP_CONFIGS,
                         ids=lambda p: os.path.basename(p))
def test_load_config_and_overrides_match_jax(path):
    got = config.load_config(path)
    want = jax_config.load_config(path)
    assert got == want
    assert config.apply_overrides(got, OVERRIDES) == \
        jax_config.apply_overrides(want, OVERRIDES)


@pytest.mark.parametrize("value", ["1e-6", "1.0e-6", "yes", "'quoted'",
                                   "", "[1, x]", "{a: 1}", "a: b", "0x10",
                                   "~", "- a"])
def test_override_values_parse_as_jax(value):
    got = config.apply_overrides(config.Config(), [f"k={value}"])
    want = jax_config.apply_overrides(jax_config.Config(), [f"k={value}"])
    assert got == want


def test_save_config_roundtrip(tmp_path):
    cfg = config.apply_overrides(
        config.load_config(os.path.join(ROOT, "configs", "llava_dpo.yaml")),
        ["training.note=it's: odd # yes", "training.eps=1.0e-8",
         "training.flag=on"])
    config.save_config(cfg, str(tmp_path))
    text = (tmp_path / "config.yaml").read_text()
    assert config.parse_yaml(text) == yaml.safe_load(text) == dict(cfg)
    assert jax_config.load_config(str(tmp_path / "config.yaml")) == cfg
    assert config.env_or(None, "NO_SUCH_VAR_SET", "d") == "d"


# ---------------------------------------------------------------------------
# Checkpoint contract
# ---------------------------------------------------------------------------

def test_checkpoint_discovery_and_completed(tmp_path):
    assert ckpt_lib.get_last_checkpoint(str(tmp_path / "none")) == \
        (None, False)
    for name in ("checkpoint-2", "checkpoint-10", "checkpoint-9", "other"):
        (tmp_path / name).mkdir()
    last, done = ckpt_lib.get_last_checkpoint(str(tmp_path))
    assert last == str(tmp_path / "checkpoint-10") and not done
    assert ckpt_lib.parse_checkpoint_step(last + "/") == 10
    assert ckpt_lib.parse_checkpoint_step(str(tmp_path / "other")) == 0
    ckpt_lib.mark_completed(str(tmp_path))
    assert ckpt_lib.get_last_checkpoint(str(tmp_path)) == (last, True)
    assert jax_train.ckpt_lib.get_last_checkpoint(str(tmp_path)) == \
        (last, True)


def _state(seed, accum):
    lora = bridge.lora_from_jax(to_np(jax_llama_lora(seed)), "cpu")
    opt = AdamW(OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                total_steps=10, grad_accum_steps=accum))
    return TrainState.create(make_trainable(lora), opt.cfg), opt


def _grads(state, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(t.shape, generator=g) * 1e-2
            for _, t in named_leaves(state.params)]


@pytest.mark.parametrize("accum", [1, 2])
def test_save_restore_train_state_roundtrip(tmp_path, accum):
    """Saved mid-accumulation (one micro-step of two applied after an
    update), restored into a fresh template: every tensor and count
    equal, and the next update the same as the original state's."""
    state, opt = _state(3, accum)
    for i in range(accum + 1):
        state = opt.apply_gradients(state, _grads(state, i))
    ckpt = str(tmp_path / "checkpoint-3")
    ckpt_lib.save_train_state(ckpt, state, LoraConfig(rank=4, alpha=8.0),
                              extra={"step": 3})
    assert os.path.exists(os.path.join(
        ckpt, "adapter_model", "lora_policy", "adapter_model.bin"))
    assert json.load(open(os.path.join(ckpt, "trainer_state.json"))) == \
        {"step": 3}
    fresh, _ = _state(5, accum)
    ckpt_lib.restore_train_state(ckpt, fresh, TCFG32.llama)
    assert (fresh.count, fresh.mini_step, fresh.step) == \
        (state.count, state.mini_step, state.step)
    if accum > 1:
        assert state.mini_step == 1
        assert any(bool(a.abs().sum() > 0) for a in state.acc)
    pairs = list(zip(named_leaves(fresh.params), named_leaves(state.params)))
    pairs += [((None, a), (None, b)) for a, b in
              zip(fresh.mu + fresh.nu + (fresh.acc or []),
                  state.mu + state.nu + (state.acc or []))]
    for (_, a), (_, b) in pairs:
        assert torch.equal(a, b)
    g = _grads(state, 9)
    opt.apply_gradients(fresh, g)
    opt.apply_gradients(state, g)
    for (_, a), (_, b) in zip(named_leaves(fresh.params),
                              named_leaves(state.params)):
        assert torch.equal(a, b)


def test_restore_from_peft_adapter_alone(tmp_path):
    """Without ``adapter_full.pt`` the decoder's adapter comes from the
    PEFT directory (f32 there, so exact)."""
    state, opt = _state(3, 1)
    state = opt.apply_gradients(state, _grads(state, 0))
    ckpt = str(tmp_path / "checkpoint-1")
    ckpt_lib.save_train_state(ckpt, state, LoraConfig(rank=4, alpha=8.0))
    os.remove(os.path.join(ckpt, "adapter_full.pt"))
    fresh, _ = _state(5, 1)
    ckpt_lib.restore_train_state(ckpt, fresh, TCFG32.llama)
    for (p, a), (_, b) in zip(named_leaves(fresh.params),
                              named_leaves(state.params)):
        if "/layers/" in p:
            assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# Data layer
# ---------------------------------------------------------------------------

def _png(seed, hw=(20, 30)):
    arr = np.random.default_rng(seed).integers(0, 255, (*hw, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def dpo_rows(n=8, seed=0):
    """Stage-4 rows with images, three responses and a GPT-4V report."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        resp = " ".join(["a cat", "sits", "on a mat"][:1 + i % 3]) + "."
        ai = "a dog stands." if i % 2 else "two dogs."
        report = {
            "image description": "ignored",
            "sentence_1": {"copied content": resp, "score": 1 + i % 4,
                           "error type": ["image_recognition_error",
                                          "correct"][i % 2],
                           "rewritten content": ai},
            "Added": {"rewritten content": " more." if i % 3 else ""}}
        rows.append({
            "queries": f"<image>\nWhat is in image {i}?",
            "image_bytes": _png(int(rng.integers(1 << 30))),
            "image_id": f"img{i}.png",
            "standard_response": f"std {i}.",
            "original_generate_response": resp,
            "AI_pseudo_response": ai,
            "AI_json_report": (json.dumps(report) if i != 5
                               else "not json"),   # the fallback path
        })
    return rows


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


SOURCES = [
    [{"from": "human", "value": "<image>\nWhat is this?"},
     {"from": "gpt", "value": "A cat on a mat."}],
    [{"from": "gpt", "value": "skipped first turn"},
     {"from": "human", "value": "Describe.\n<image>"},
     {"from": "gpt", "value": "It is red."},
     {"from": "human", "value": "And?"},
     {"from": "gpt", "value": "Round."}],
]


@pytest.mark.parametrize("which", ["preprocess", "preprocess_v1",
                                   "preprocess_llama_2"])
@pytest.mark.parametrize("has_image", [True, False])
def test_preprocess_matches_jax(which, has_image):
    kw = dict(has_image=has_image, query_len=40, response_len=12)
    got = getattr(tokenization, which)(SOURCES, CharTokenizer(), **kw)
    want = getattr(jax_tok, which)(SOURCES, FakeTokenizer(), **kw)
    _assert_same(got, want)


def test_split_query_response_matches_jax():
    enc = jax_tok.preprocess(SOURCES, FakeTokenizer(), has_image=True)
    for qlen in (16, 200):
        got = tokenization.split_query_response(
            enc["input_ids"], enc["labels"], qlen, 0, ASSISTANT_TAIL_TOKENS)
        want = jax_tok.split_query_response(
            enc["input_ids"], enc["labels"], qlen, 0, ASSISTANT_TAIL_TOKENS)
        _assert_same(got, want)


@pytest.mark.parametrize("detailed", [True, False])
def test_dpo_dataset_and_collator_match_jax(detailed):
    rows = dpo_rows(6)
    port = datasets.DPODataset(rows, image_size=28)
    ref = jax_datasets.DPODataset(rows, image_size=28)
    items = [port[i] for i in range(len(rows))]
    _assert_same(items, [ref[i] for i in range(len(rows))])
    got = collators.DPOCollator(CharTokenizer(), 256, 16, detailed)
    want = jax_collators.DPOCollator(FakeTokenizer(), 256, 16, detailed)
    _assert_same(got(items[:4]), want(items[:4]))
    _assert_same(got(items[4:]), want(items[4:]))      # the fallback row


def test_sft_and_query_datasets_and_collators_match_jax():
    rows = dpo_rows(3)
    tok, ftok = CharTokenizer(), FakeTokenizer()
    sft = datasets.SFTDataset(rows, tok, query_len=64, response_len=32,
                              image_size=28)
    j_sft = jax_datasets.SFTDataset(rows, ftok, query_len=64,
                                    response_len=32, image_size=28)
    assert len(sft) == len(j_sft) == 6
    items = [sft[i] for i in range(6)]
    _assert_same(items, [j_sft[i] for i in range(6)])
    _assert_same(collators.SFTCollator(tok)(items),
                 jax_collators.SFTCollator(ftok)(items))
    q = datasets.QueryDataset(rows, tok, query_len=24, image_size=28)
    j_q = jax_datasets.QueryDataset(rows, ftok, query_len=24, image_size=28)
    items = [q[i] for i in range(3)]
    _assert_same(items, [j_q[i] for i in range(3)])
    _assert_same(collators.QueryCollator()(items),
                 jax_collators.QueryCollator()(items))


@pytest.mark.parametrize("drop_last,workers", [(True, 1), (False, 4)])
def test_dataloader_order_matches_jax(drop_last, workers):
    rows = list(range(11))

    def collate(items):
        return {"i": np.asarray(items)}

    got = loading.DataLoader(rows, collate, 3, drop_last=drop_last, seed=5,
                             num_workers=workers)
    want = jax_loading.DataLoader(rows, collate, 3, drop_last=drop_last,
                                  seed=5, num_workers=workers)
    assert len(got) == len(want)
    for _ in range(2):                      # two epochs, reshuffled
        _assert_same(list(got), list(want))
    inf, j_inf = loading.InfiniteLoader(got), jax_loading.InfiniteLoader(want)
    _assert_same([next(inf) for _ in range(9)],
                 [next(j_inf) for _ in range(9)])
    shard = loading.ShardedDataset(rows, 1, 3)
    assert [shard[i] for i in range(len(shard))] == rows[1::3]
    with pytest.raises(ValueError):
        loading.ShardedDataset(rows, 3, 3)


def test_data_module_and_tokenizer_need_their_packages(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="datasets"):
        datasets.make_dpo_data_module(CharTokenizer(), "/nowhere")
    with pytest.raises(ImportError, match="transformers"):
        runtime.load_tokenizer("/nowhere")


def test_metrics_logger_matches_jax(tmp_path):
    stats = {"loss": {"total": np.float32(0.5), "n": 3}, "name": "x",
             "objective/a": torch.tensor(1.5)}
    assert metrics.flatten_dict(stats) == jax_metrics.flatten_dict(stats)
    for mod, d in ((metrics, "port"), (jax_metrics, "jax")):
        log = mod.MetricsLogger(str(tmp_path / d))
        log.log(stats, step=4)
        log.close()
    lines = [json.loads(open(tmp_path / d / "train_log.jsonl").read())
             for d in ("port", "jax")]
    for line in lines:
        line.pop("wall_s")
    assert lines[0] == lines[1] == {"step": 4, "loss/total": 0.5,
                                    "loss/n": 3.0, "objective/a": 1.5}


def test_step_timer_matches_jax():
    a, b = runtime.StepTimer(), jax_runtime.StepTimer()
    for timer in (a, b):
        timer.record("rollout", 1.0, tokens=3)
        timer.record("train", 2.0)
        timer.record("train", 4.0)
    assert a.history == b.history and a.summary() == b.summary()


# ---------------------------------------------------------------------------
# Stage 4 end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage4_inputs(tmp_path_factory):
    """A tiny f32 checkpoint, an OPA adapter (non-zero B) and 8 DPO rows on
    disk, from seeded JAX weights."""
    from datasets import Dataset

    root = tmp_path_factory.mktemp("stage4")
    model = bridge.llava_from_jax(to_np(jax_params(21)), TCFG32,
                                  device="cpu")
    loader.save_llava_checkpoint(model, str(root / "llava"),
                                 vision_in_dir=True)
    jlora = jax_llama_lora(22)
    loader.save_peft_adapter(
        bridge.lora_from_jax(
            to_np({"llama": {"layers": jlora["llama"]["layers"]}}), "cpu"),
        str(root / "opa"), LoraConfig(rank=4, alpha=8.0))
    Dataset.from_list(dpo_rows(8, seed=3)).save_to_disk(str(root / "data"))
    return {k: str(root / k) for k in ("llava", "opa", "data")}


def _stage4_cfg(out, inp, cfg_mod=config, **training):
    t = dict(output_dir=out, seed=0, device="cpu", total_epochs=1,
             max_step=2, rollout_batch_size=4, step_batch_size=2,
             rollout_per_device_batch_size=2, step_per_device_batch_size=1,
             reward_model_per_device_batch_size=1, noptepochs=1,
             save_steps=1, query_len=256, response_len=16, lora_r=4,
             lora_alpha=8, CoPO=False, warmup_steps=0, learning_rate=1e-3)
    t.update(training)
    return cfg_mod.Config({
        "base_model": inp["llava"], "policy_lora_dir": inp["opa"],
        "image_checkpoint": None, "debug": {"fake_tokenizer": True},
        "model": {"skip_loading_weights": False}, "mesh": {"model": 1},
        "data": {"data_path": inp["data"]}, "training": t})


def _f32_loaders(monkeypatch):
    """Both packages read the tiny f32 model and f32 adapters from the
    directories (their config readers default to the 7B, their adapter
    loaders to bf16)."""
    monkeypatch.setattr(runtime, "llava_config_from_hf", lambda _: TCFG32)
    monkeypatch.setattr(opadpo_train, "load_peft_adapter", functools.partial(
        loader.load_peft_adapter, dtype=torch.float32))
    monkeypatch.setattr(jax_runtime, "llava_config_from_hf",
                        lambda _: JCFG32)
    monkeypatch.setattr(jax_loader, "load_llava_checkpoint", functools.partial(
        jax_loader.load_llava_checkpoint, dtype=jnp.float32))
    monkeypatch.setattr(jax_train, "load_peft_adapter", functools.partial(
        jax_loader.load_peft_adapter, dtype=jnp.float32))
    monkeypatch.setattr(jax_runtime, "make_mesh", lambda c=None: (
        jax_mesh.make_mesh(c, jax.devices()[:1])))


def _log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _adapter(out, step):
    path = os.path.join(out, f"checkpoint-{step}", "adapter_model",
                        "lora_policy", "adapter_model.bin")
    return torch.load(path, weights_only=True)


def test_stage4_matches_jax_train(tmp_path, monkeypatch, stage4_inputs):
    """Two steps (two rollout chunks of two sub-batches each, then four
    micro-steps that the optimizer averages in pairs) from the same
    checkpoint, adapter and rows: each step's ``loss/total`` within 1e-5,
    the checkpoint-2 PEFT adapter within 1e-5 of the JAX package's, and
    moved from the OPA adapter."""
    _f32_loaders(monkeypatch)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    timer = opadpo_train.train(_stage4_cfg(port_out, stage4_inputs))
    jax_train.train(_stage4_cfg(jax_out, stage4_inputs, jax_config))
    assert [e["name"] for e in timer.history] == ["rollout", "train"] * 2
    got, want = _log(port_out), _log(jax_out)
    assert [e["step"] for e in got] == [e["step"] for e in want] == [1, 2]
    for g, w in zip(got, want):
        assert np.isfinite(g["loss/total"])
        np.testing.assert_allclose(g["loss/total"], w["loss/total"],
                                   atol=1e-5, rtol=0)
    for name in ("checkpoint-1", "checkpoint-2", "completed", "config.yaml"):
        assert os.path.exists(os.path.join(port_out, name)), name
    pa, ja = _adapter(port_out, 2), _adapter(jax_out, 2)
    opa = torch.load(os.path.join(stage4_inputs["opa"], "adapter_model.bin"),
                     weights_only=True)
    assert set(pa) == set(ja) == set(opa)
    for k in pa:
        np.testing.assert_allclose(pa[k].numpy(), ja[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    assert max(float((pa[k] - opa[k]).abs().max()) for k in pa) > 1e-4


def test_stage4_resume_is_bitwise_and_completed_is_noop(tmp_path,
                                                        monkeypatch,
                                                        stage4_inputs):
    """CoPO on (random masks from the per-chunk generators): a run stopped
    after step 1 (its checkpoint-1 and first log line kept) and resumed
    equals the uninterrupted run bitwise: the step-2 loss, adapter and
    optimizer state; a completed run returns at once."""
    _f32_loaders(monkeypatch)
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    opadpo_train.train(_stage4_cfg(full, stage4_inputs, CoPO=True))
    shutil.copytree(os.path.join(full, "checkpoint-1"),
                    os.path.join(cut, "checkpoint-1"))
    with open(os.path.join(cut, "train_log.jsonl"), "w") as f:
        f.write(json.dumps(_log(full)[0]) + "\n")
    timer = opadpo_train.train(_stage4_cfg(cut, stage4_inputs, CoPO=True))
    assert [e["name"] for e in timer.history] == ["rollout", "train"]
    a, b = _log(full), _log(cut)
    assert len(a) == len(b) == 2
    assert {k: v for k, v in a[1].items() if not k.endswith(
        ("seconds", "wall_s"))} == {k: v for k, v in b[1].items()
                                    if not k.endswith(("seconds", "wall_s"))}
    for name in ("adapter_full.pt", "optimizer.pt"):
        x = torch.load(os.path.join(full, "checkpoint-2", name),
                       weights_only=True)
        y = torch.load(os.path.join(cut, "checkpoint-2", name),
                       weights_only=True)
        for key in x:
            xs = x[key] if isinstance(x[key], list) else [x[key]]
            ys = y[key] if isinstance(y[key], list) else [y[key]]
            for u, v in zip(xs, ys):
                assert (torch.equal(u, v) if torch.is_tensor(u)
                        else u == v), (name, key)
    mtime = os.path.getmtime(os.path.join(cut, "checkpoint-2",
                                          "optimizer.pt"))
    assert opadpo_train.train(_stage4_cfg(cut, stage4_inputs)) is None
    assert os.path.getmtime(os.path.join(cut, "checkpoint-2",
                                         "optimizer.pt")) == mtime
    assert len(_log(cut)) == 2


def test_stage4_refuses_a_tensor_parallel_mesh(tmp_path, stage4_inputs):
    """``mesh.model: 2`` in one process, with no process group: the
    mesh's resolve error, as the JAX package raises it (tensor parallelism
    runs under ``torchrun``, ``tests/test_torch_parallel_pipeline.py``)."""
    cfg = _stage4_cfg(str(tmp_path), stage4_inputs)
    cfg["mesh"]["model"] = 2
    with pytest.raises(ValueError, match=r"mesh 0x2 != 1 devices"):
        opadpo_train.train(cfg)


def test_stage4_cli_runs_the_tiny_debug_model(tmp_path, stage4_inputs):
    """``python -m opadpo_torch.pipeline.opadpo_train --config ... k=v``
    on the tiny random model (``debug.tiny``, the character tokenizer, the
    fresh adapter) from the dataset directory, on the CPU."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "opadpo_torch.pipeline.opadpo_train",
           "--config", os.path.join(ROOT, "configs", "llava_dpo.yaml"),
           "debug.tiny=true", "model.skip_loading_weights=true",
           f"data.data_path={stage4_inputs['data']}",
           f"training.output_dir={out}", "training.device=cpu",
           "training.max_step=1", "training.rollout_batch_size=2",
           "training.step_batch_size=2", "training.query_len=256",
           "training.response_len=16", "training.lora_r=4",
           "training.lora_alpha=8", "training.save_steps=1"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR")}
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (out / "completed").exists()
    assert (out / "checkpoint-1" / "adapter_model" / "lora_policy"
            / "adapter_config.json").exists()
    lines = _log(str(out))
    assert len(lines) == 1 and np.isfinite(lines[0]["loss/total"])
    saved = config.parse_yaml((out / "config.yaml").read_text())
    assert saved["training"]["max_step"] == 1
