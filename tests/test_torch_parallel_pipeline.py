"""The port's drivers over a ``2 x 2`` mesh on the CPU: four gloo ranks
(``tests/torch_parallel_worker.py``) started once for the file.

- Stage 4 (``opadpo_train.train``) with ``mesh.model: 2`` for one step:
  its loss against the JAX ``train`` on the ``data=2, model=2`` virtual
  mesh; its PEFT adapter against JAX's and against the port's one-process
  run at the same global batch (same keys, values within 1e-5); its
  ``optimizer.pt`` (ZeRO-1 moments made whole) resumes at world size 1
  and the second step's adapter matches the uninterrupted one-process run.
- Stages 1-2 (``online_generation.run``) with ``mesh.model: 2``: two data
  groups write two sets of shards equal to two one-process ranks'; each
  row is sampled by its model group and corrected once, by model rank 0
  (a counting stub in place of GPT-4V).
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.models import loader as jax_loader
from opadpo_tpu.parallel import mesh as jax_mesh
from opadpo_tpu.pipeline import config as jax_config
from opadpo_tpu.pipeline import opadpo_train as jax_train
from opadpo_tpu.pipeline import runtime as jax_runtime
from opadpo_torch import bridge
from opadpo_torch.models import loader
from opadpo_torch.models.lora import LoraConfig
from opadpo_torch.pipeline import config, online_generation, opadpo_train
from opadpo_torch.pipeline import runtime
from tests.test_torch_pipeline import dpo_rows
from tests.test_torch_stages import ROLLOUT, _StubService, prompt_rows
from tests.torch_parallel_worker import launch
from tests.torch_parity import (
    JCFG32, TCFG32, jax_llama_lora, jax_params, to_np,
)

ENV_VARS = ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR", "IMAGE_DIR",
            "POLICY_LORA_DIR", "API_KEY", "API_KEY0", "API_NUM", "RANK",
            "WORLD_SIZE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A tiny f32 checkpoint, an OPA adapter, 8 DPO rows and 6 prompts on
    disk, from seeded JAX weights."""
    from datasets import Dataset

    root = tmp_path_factory.mktemp("pipe")
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
    Dataset.from_list(prompt_rows(6)).save_to_disk(str(root / "prompts"))
    return {k: str(root / k) for k in ("llava", "opa", "data", "prompts")}


def _stage4(out, inp, model=2, per_dev=1, max_step=1):
    """One step of four rows: with per-device 1 over two data ranks, or 2
    on one process, each step is two micro-steps over the same four
    rows."""
    return {
        "base_model": inp["llava"], "policy_lora_dir": inp["opa"],
        "image_checkpoint": None, "debug": {"fake_tokenizer": True},
        "model": {"skip_loading_weights": False}, "mesh": {"model": model},
        "data": {"data_path": inp["data"]},
        "training": dict(
            output_dir=out, seed=0, device="cpu", total_epochs=1,
            max_step=max_step, rollout_batch_size=4, step_batch_size=4,
            rollout_per_device_batch_size=per_dev,
            step_per_device_batch_size=per_dev,
            reward_model_per_device_batch_size=1, noptepochs=1,
            save_steps=1, query_len=256, response_len=16, lora_r=4,
            lora_alpha=8, CoPO=False, warmup_steps=0, learning_rate=1e-3)}


def _stages12(out, inp, model):
    return {"base_model": inp["llava"], "image_checkpoint": None,
            "debug": {"fake_tokenizer": True},
            "model": {"skip_loading_weights": False},
            "mesh": {"model": model}, "data": {"data_path": inp["prompts"]},
            "training": dict(output_dir=out, seed=0, device="cpu",
                             **ROLLOUT)}


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    out = {"stage4": str(root / "stage4"), "gen": str(root / "gen")}
    res = launch(4, [("stage4", dict(cfg=_stage4(out["stage4"], inputs))),
                     ("stages12", dict(cfg=_stages12(out["gen"], inputs,
                                                     2)))],
                 root, timeout=85)
    return out, res


def _f32_port(monkeypatch):
    monkeypatch.setattr(runtime, "llava_config_from_hf", lambda _: TCFG32)
    monkeypatch.setattr(opadpo_train, "load_peft_adapter", functools.partial(
        loader.load_peft_adapter, dtype=torch.float32))


def _f32_jax(monkeypatch, devices):
    monkeypatch.setattr(jax_runtime, "llava_config_from_hf",
                        lambda _: JCFG32)
    monkeypatch.setattr(jax_loader, "load_llava_checkpoint", functools.partial(
        jax_loader.load_llava_checkpoint, dtype=jnp.float32))
    monkeypatch.setattr(jax_train, "load_peft_adapter", functools.partial(
        jax_loader.load_peft_adapter, dtype=jnp.float32))
    monkeypatch.setattr(jax_runtime, "make_mesh", lambda c=None: (
        jax_mesh.make_mesh(c, jax.devices()[:devices])))


def _log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _adapter(out, step):
    return torch.load(os.path.join(out, f"checkpoint-{step}",
                                   "adapter_model", "lora_policy",
                                   "adapter_model.bin"), weights_only=True)


def _same(a, b, atol, what):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_allclose(a[k].float().numpy(), b[k].float().numpy(),
                                   atol=atol, rtol=0, err_msg=f"{what} {k}")


def test_stage4_on_a_2x2_mesh_matches_jax_and_one_process(
        world, inputs, tmp_path, monkeypatch):
    """The 4-rank step's loss within 1e-5 of the JAX ``train`` on the
    ``2 x 2`` mesh; its PEFT adapter within 1e-5 of JAX's and of the
    one-process run's, key for key; only global rank 0 wrote files and
    every rank ran the collectives."""
    out, res = world
    got = out["stage4"]
    assert all(r[0]["history"] == ["rollout", "train"] for r in res)
    assert all(r[0]["counts"]["all_reduce"]["calls"] > 0 for r in res)
    jax_out = str(tmp_path / "jax")
    _f32_jax(monkeypatch, 4)
    jax_train.train(jax_config.Config(_stage4(jax_out, inputs)))
    (g,), (w,) = _log(got), _log(jax_out)
    np.testing.assert_allclose(g["loss/total"], w["loss/total"], atol=1e-5,
                               rtol=0)
    _same(_adapter(got, 1), _adapter(jax_out, 1), 1e-5, "against JAX")
    _f32_port(monkeypatch)
    one = str(tmp_path / "one")
    opadpo_train.train(config.Config(_stage4(one, inputs, model=1,
                                             per_dev=2, max_step=2)))
    np.testing.assert_allclose(g["loss/total"], _log(one)[0]["loss/total"],
                               atol=1e-5, rtol=0)
    _same(_adapter(got, 1), _adapter(one, 1), 1e-5, "against one process")
    full = torch.load(os.path.join(got, "checkpoint-1", "adapter_full.pt"),
                      weights_only=True)
    ref = torch.load(os.path.join(one, "checkpoint-1", "adapter_full.pt"),
                     weights_only=True)
    _same(full, ref, 1e-5, "adapter_full.pt")
    opt = torch.load(os.path.join(got, "checkpoint-1", "optimizer.pt"),
                     weights_only=True)
    ref = torch.load(os.path.join(one, "checkpoint-1", "optimizer.pt"),
                     weights_only=True)
    for key in ("mu", "nu"):
        for a, b in zip(opt[key], ref[key]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=1e-4 * float(b.abs().max()))
    assert (opt["count"], opt["step"]) == (ref["count"], ref["step"])


def test_stage4_optimizer_resumes_at_world_size_one(world, inputs, tmp_path,
                                                    monkeypatch):
    """The 4-rank run's ``checkpoint-1`` resumes on one process: step 2
    runs alone and its adapter matches the uninterrupted one-process
    run's (1e-5)."""
    out, _ = world
    _f32_port(monkeypatch)
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(out["stage4"], "checkpoint-1"),
                    os.path.join(resumed, "checkpoint-1"))
    timer = opadpo_train.train(config.Config(_stage4(
        resumed, inputs, model=1, per_dev=2, max_step=2)))
    assert [e["name"] for e in timer.history] == ["rollout", "train"]
    one = str(tmp_path / "one")
    opadpo_train.train(config.Config(_stage4(one, inputs, model=1,
                                             per_dev=2, max_step=2)))
    _same(_adapter(resumed, 2), _adapter(one, 2), 1e-5, "resumed")


def test_stages12_on_a_2x2_mesh_write_one_shard_set_per_data_rank(
        world, inputs, tmp_path, monkeypatch):
    """Data ranks 0 and 1 write ``step{N}_rank{0,1}.json``, equal to two
    one-process ranks' (``RANK`` / ``WORLD_SIZE`` 2); each of the 6 rows is
    corrected once, by model rank 0 of its group, and sampled by both
    ranks of the group."""
    out, res = world
    calls = [r[1]["calls"] for r in res]
    rows = [r[1]["rows"] for r in res]
    assert calls == [3, 0, 3, 0] and rows == [3, 3, 3, 3]
    _f32_port(monkeypatch)
    monkeypatch.setenv("API_KEY", "dummy")
    monkeypatch.setattr(online_generation, "get_api_service",
                        lambda rank=0, cache_path="": _StubService())
    one = str(tmp_path / "one")
    monkeypatch.setenv("WORLD_SIZE", "2")
    for rank in (0, 1):
        monkeypatch.setenv("RANK", str(rank))
        online_generation.run(config.Config(_stages12(one, inputs, 1)))

    def shards(d):
        d = os.path.join(d, "rollouts")
        return {n: json.load(open(os.path.join(d, n)))
                for n in sorted(os.listdir(d))}

    got, want = shards(out["gen"]), shards(one)
    assert list(got) == ["step1_rank0.json", "step1_rank1.json",
                         "step2_rank0.json", "step2_rank1.json"]
    assert got == want
    assert all(r["API_success"] for s in got.values() for r in s)
