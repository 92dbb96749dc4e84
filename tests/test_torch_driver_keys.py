"""The config keys the JAX package's drivers honour and the port now reads
too, against the JAX package where it computes something:

- ``topk_impl`` (``engine/sampling.SamplingConfig``,
  ``engine/serving_config.make_serving_sampling``, the rollout driver):
  ``sort`` and ``approx`` draw equal tokens from one generator and give the
  same ``warped_topk_dist`` (1e-6 of the JAX package's, both values: JAX's
  ``approx`` is ``lax.approx_max_k`` at recall 1.0, the exact top-k); any
  other value raises the JAX package's ``ValueError`` text;
- ``pil_preprocess``: each of the three stage drivers switches the image
  path to PIL before it builds anything (the flag restored after each
  test);
- ``fused_attention``: false raises for a CUDA device, naming the key, and
  runs on the CPU, where the port's attention is the plain version anyway;
- ``profile_start_step`` (``pipeline/runtime.maybe_start_profiler``): the
  stage-4 driver on the tiny model writes a Chrome trace under
  ``output_dir/profile/``, also when the run ends inside the traced steps.
"""

import base64
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opadpo_tpu.engine import sampling as jax_sampling
from opadpo_tpu.engine import speculative as jax_spec
from opadpo_torch.data import image_processing as ip
from opadpo_torch.data.char_tokenizer import CharTokenizer
from opadpo_torch.data.collators import DPOCollator
from opadpo_torch.data.datasets import DPODataset
from opadpo_torch.engine.sampling import SamplingConfig, sample_tokens
from opadpo_torch.engine.serving_config import make_serving_sampling
from opadpo_torch.engine.speculative import warped_topk_dist
from opadpo_torch.models.llava import LlavaConfig
from opadpo_torch.pipeline import (
    online_generation, opa_train, opadpo_train, runtime,
)
from opadpo_torch.pipeline.config import Config

QUERY_LEN, RESPONSE_LEN = 256, 16


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR", "IMAGE_DIR",
                "POLICY_LORA_DIR"):
        monkeypatch.delenv(var, raising=False)
    saved = ip._PIL_ONLY
    ip.set_pil_preprocess(False)
    yield
    ip.set_pil_preprocess(saved)
    runtime.stop_profiler()


def _logits(seed=0, b=6, v=512):
    return np.random.default_rng(seed).normal(0, 3, (b, v)).astype(np.float32)


@pytest.mark.parametrize("top_p", [1.0, 0.9])
def test_topk_impl_values_draw_equal_tokens(top_p):
    logits = torch.from_numpy(_logits())
    draws = {}
    for impl in ("sort", "approx"):
        cfg = SamplingConfig(top_k=30, top_p=top_p, topk_impl=impl)
        g = torch.Generator().manual_seed(7)
        draws[impl] = torch.stack([sample_tokens(logits, cfg, g)
                                   for _ in range(8)])
    assert torch.equal(draws["sort"], draws["approx"])


@pytest.mark.parametrize("impl", ["sort", "approx"])
def test_warped_topk_dist_matches_jax_for_both_impls(impl):
    logits = _logits(1)
    probs, idx = warped_topk_dist(torch.from_numpy(logits), SamplingConfig(
        top_k=30, top_p=0.95, temperature=0.8, topk_impl=impl))
    ref_p, ref_i = jax_spec.warped_topk_dist(
        jnp.asarray(logits), jax_sampling.SamplingConfig(
            top_k=30, top_p=0.95, temperature=0.8, topk_impl=impl))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_p), atol=1e-6,
                               rtol=0)
    sort_p, sort_i = warped_topk_dist(torch.from_numpy(logits), SamplingConfig(
        top_k=30, top_p=0.95, temperature=0.8))
    assert torch.equal(idx, sort_i) and torch.equal(probs, sort_p)


def test_unknown_topk_impl_raises_the_jax_text():
    with pytest.raises(ValueError) as want:
        jax_sampling.SamplingConfig(topk_impl="radix")
    with pytest.raises(ValueError) as got:
        SamplingConfig(topk_impl="radix")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="topk_impl='radix'"):
        make_serving_sampling(topk_impl="radix")
    assert make_serving_sampling(topk_impl="approx").topk_impl == "approx"


def test_rollout_driver_reads_topk_impl(tmp_path):
    cfg = Config({"debug": {"tiny": True}, "mesh": {"model": 1},
                  "model": {"skip_loading_weights": True},
                  "training": {"output_dir": str(tmp_path), "device": "cpu",
                               "topk_impl": "radix"}})
    with pytest.raises(ValueError, match="topk_impl='radix'"):
        online_generation.run(cfg, tokenizer=CharTokenizer())


DRIVERS = {"online_generation": online_generation.run,
           "opa_train": opa_train.train, "opadpo_train": opadpo_train.train}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("pil", [True, False])
def test_drivers_set_pil_flag_and_refuse_unfused_attention_on_cuda(
        tmp_path, driver, pil):
    """``fused_attention: false`` on ``device: cuda`` raises before the
    model is made (no card is needed to see it), after the PIL switch,
    which comes first, as in the JAX drivers."""
    cfg = Config({"debug": {"tiny": True}, "mesh": {"model": 1},
                  "training": {"output_dir": str(tmp_path), "device": "cuda",
                               "pil_preprocess": pil,
                               "fused_attention": False}})
    assert ip._PIL_ONLY is False
    with pytest.raises(ValueError, match="fused_attention"):
        DRIVERS[driver](cfg)
    assert ip._PIL_ONLY is pil


def test_fused_attention_check():
    for dev in ("cuda", "cuda:0", torch.device("cuda", 1)):
        with pytest.raises(ValueError, match="fused_attention=false"):
            runtime.check_fused_attention(False, dev)
    for fused, dev in ((False, "cpu"), (True, "cuda"), (True, "cpu")):
        runtime.check_fused_attention(fused, dev)
    cfg, model, _ = runtime.setup_model(tiny=True, device="cpu",
                                        fused_attention=False)
    assert next(model.parameters()).device.type == "cpu"


def _png(seed):
    arr = np.random.default_rng(seed).integers(0, 255, (20, 30, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _stage4_module(tok, n=4):
    rows = [{"queries": f"<image>\nWhat is in image {i}?",
             "image_bytes": _png(i), "standard_response": f"std {i}.",
             "original_generate_response": "a cat sits.",
             "AI_pseudo_response": "a dog stands.",
             "AI_json_report": json.dumps({"sentence_1": {
                 "copied content": "a cat sits.", "score": 2,
                 "error type": "image_recognition_error",
                 "rewritten content": "a dog stands."}})}
            for i in range(n)]
    size = LlavaConfig.tiny().vision.image_size
    return {"train_dataset": DPODataset(rows, image_size=size),
            "eval_dataset": None,
            "data_collator": DPOCollator(tok, query_len=QUERY_LEN,
                                         response_len=RESPONSE_LEN)}


def _trace_events(out):
    files = os.listdir(os.path.join(out, "profile"))
    assert len(files) == 1, files
    with open(os.path.join(out, "profile", files[0])) as f:
        return files[0], json.load(f)["traceEvents"]


@pytest.mark.parametrize("max_step", [2, 5])
def test_stage4_profile_start_step_writes_a_trace(tmp_path, max_step):
    """``profile_start_step: 1``: the hook starts after step 1 and stops
    after step 4; at 2 steps the run ends inside the window and stage 4's
    ``train`` writes the trace, at 5 the hook does.  The traced steps' training
    ops are in it.  ``fused_attention: false`` runs on the CPU."""
    out = str(tmp_path / "out")
    cfg = Config({
        "debug": {"tiny": True}, "mesh": {"model": 1},
        "model": {"skip_loading_weights": True},
        "training": dict(
            output_dir=out, device="cpu", seed=0, total_epochs=10,
            max_step=max_step, rollout_batch_size=2, step_batch_size=2,
            rollout_per_device_batch_size=2, step_per_device_batch_size=2,
            save_steps=100, query_len=QUERY_LEN, response_len=RESPONSE_LEN,
            lora_r=4, lora_alpha=8, CoPO=False, profile_start_step=1,
            fused_attention=False)})
    tok = CharTokenizer()
    timer = opadpo_train.train(cfg, tokenizer=tok,
                               data_module=_stage4_module(tok))
    assert timer.summary()["train"]["count"] == max_step
    name, events = _trace_events(out)
    assert name.startswith("steps_2-4_")
    ops = {e.get("name") for e in events}
    assert "aten::mm" in ops or "aten::addmm" in ops or "aten::matmul" in ops
    assert os.path.exists(os.path.join(out, "completed"))


def test_maybe_start_profiler_window(tmp_path):
    out = str(tmp_path)
    assert runtime.stop_profiler() is None
    started = [runtime.maybe_start_profiler(out, s, start_step=2,
                                            num_steps=2) for s in (1, 2)]
    assert started == [False, True]
    torch.ones(8, 8) @ torch.ones(8, 8)
    assert runtime.maybe_start_profiler(out, 3, 2, 2) is False
    assert os.listdir(out) == []                 # still open
    assert runtime.maybe_start_profiler(out, 4, 2, 2) is False
    name, events = _trace_events(out)
    assert name.startswith("steps_3-4_")
    assert "aten::mm" in {e.get("name") for e in events}
    assert runtime.stop_profiler() is None
