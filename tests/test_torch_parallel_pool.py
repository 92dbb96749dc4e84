"""Tensor parallelism of the slot pool and of speculative decode at TP 2 on
the CPU: two gloo ranks (``tests/torch_parallel_worker.py``) started once
for the file, on the tiny LLaVA in f32 (2 heads: one a rank), against the
port's one process and the JAX package on its ``1 x 2`` virtual mesh.

- The pool (``ContinuousEngine``), int8 and int4: 3 requests, 2 slots,
  segments of 2, 4 tokens, greedy; token-exact against the port's
  one-process pool and the JAX ``ContinuousEngine`` under
  ``attn.set_tp_mesh`` (as ``tests/test_multichip.py`` runs it).
- The pool with speculative segments at k 3: token-exact against the
  port's one-process pool.
- The Sampler at ``spec_k`` 3, kv 16 and 8, shared and per-row advance,
  greedy: token-exact against plain greedy, and against the JAX TP
  speculative Sampler at the same advance; every suffix cache holds one
  head (the rank's own).
- Top-k sampling under TP speculative decode: tokens equal on both ranks.
- The rollout (``online_generation.run``) at ``mesh.model`` 2 with
  ``continuous_slots`` 2: its shards equal the one-process run's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.engine import continuous as jax_cont
from opadpo_tpu.engine.sampler import Sampler as JaxSampler
from opadpo_tpu.engine.sampling import SamplingConfig as JaxSampling
from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.ops import attention as jax_attn
from opadpo_tpu.parallel import (
    MeshConfig, make_mesh, param_partition_specs, shard_pytree,
)
from opadpo_torch import bridge
from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.engine.continuous import ContinuousEngine
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import loader
from opadpo_torch.pipeline import config, online_generation, runtime
from tests.test_torch_stages import ROLLOUT, _StubService, prompt_rows
from tests.torch_parallel_worker import launch, tiny_f32
from tests.torch_parity import JCFG32, TCFG32, inputs, t, to_np

QLEN = 10
POOL_RUNS = ((8, 0), (4, 0), (8, 3))
SPEC_RUNS = tuple((kv, adv, 0) for kv in (16, 8)
                  for adv in ("shared", "per_row")) + ((8, "per_row", 5),
                                                       (16, "shared", 5))
SPEC_NEW = 6
PARAMS = jax_llava.init_params(jax.random.PRNGKey(0), JCFG32)
IDS, MASK, IMAGES = inputs()
ENV_VARS = ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR", "IMAGE_DIR",
            "POLICY_LORA_DIR", "API_KEY", "API_KEY0", "API_NUM", "RANK",
            "WORLD_SIZE")


def _request(seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, JCFG32.llama.vocab_size, QLEN).astype(np.int64)
    ids[2] = IMAGE_TOKEN_INDEX
    sz = JCFG32.vision.image_size
    return (ids, np.ones(QLEN, np.int64),
            rng.normal(size=(sz, sz, 3)).astype(np.float32))


REQUESTS = [_request(s) for s in (51, 52, 53)]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def rollout_inputs(tmp_path_factory):
    """A tiny f32 checkpoint and 6 prompts on disk."""
    from datasets import Dataset

    root = tmp_path_factory.mktemp("pool_pipe")
    model = bridge.llava_from_jax(to_np(PARAMS), TCFG32, device="cpu")
    loader.save_llava_checkpoint(model, str(root / "llava"),
                                 vision_in_dir=True)
    Dataset.from_list(prompt_rows(6)).save_to_disk(str(root / "prompts"))
    return {k: str(root / k) for k in ("llava", "prompts")}


def _rollout_cfg(out, inp, model):
    return {"base_model": inp["llava"], "image_checkpoint": None,
            "debug": {"fake_tokenizer": True},
            "model": {"skip_loading_weights": False},
            "mesh": {"model": model}, "data": {"data_path": inp["prompts"]},
            "training": dict(output_dir=out, seed=0, device="cpu",
                             continuous_slots=2, continuous_seg_len=3,
                             kv_bits=8, **ROLLOUT)}


@pytest.fixture(scope="module")
def world(rollout_inputs, tmp_path_factory):
    """One TP-2 world for every case of the file."""
    root = tmp_path_factory.mktemp("tp_pool")
    gen = str(root / "gen")
    res = launch(2, [
        ("tp_pool", dict(params=to_np(PARAMS), requests=REQUESTS,
                         runs=POOL_RUNS)),
        ("tp_spec", dict(params=to_np(PARAMS), ids=IDS, mask=MASK,
                         images=IMAGES, runs=SPEC_RUNS, max_new=SPEC_NEW)),
        ("stages12", dict(cfg=_rollout_cfg(gen, rollout_inputs, 2)))],
        root, timeout=170)
    return res, gen


def _one_model():
    return bridge.llava_from_jax(to_np(PARAMS), tiny_f32(), "cpu")


def _one_pool(kv, spec_k):
    eng = ContinuousEngine(
        _one_model(), SamplingConfig(greedy=True, max_new_tokens=4,
                                     eos_token_id=-1, pad_token_id=0),
        max_batch=2, qlen=QLEN, seg_len=2, kv_bits=kv, spec_k=spec_k)
    rids = [eng.add_request(*r) for r in REQUESTS]
    done = {}
    while eng.has_work():
        done.update(eng.step())
    return [np.asarray(done[r]) for r in rids]


def _jax_tp_params():
    mesh = make_mesh(MeshConfig(data=1, model=2), jax.devices()[:2])
    return mesh, shard_pytree(PARAMS, param_partition_specs(PARAMS, mesh),
                              mesh)


def _jax_tp_pool(kv):
    sampling = JaxSampling(greedy=True, max_new_tokens=4, eos_token_id=-1,
                           pad_token_id=0)
    mesh, params_tp = _jax_tp_params()
    jax_attn.set_tp_mesh(mesh)
    try:
        prepped, _ = JaxSampler(JCFG32, sampling,
                                kv_bits=8).prepare_params(params_tp)
        eng = jax_cont.ContinuousEngine(JCFG32, sampling, prepped,
                                        max_batch=2, qlen=QLEN, seg_len=2,
                                        kv_bits=kv)
        rids = [eng.add_request(*(np.asarray(x) for x in r))
                for r in REQUESTS]
        done = {}
        while eng.has_work():
            for rid, toks in eng.step():
                done[rid] = np.asarray(toks)
    finally:
        jax_attn.set_tp_mesh(None)
    return [done[r] for r in rids]


@pytest.mark.parametrize("kv,spec_k", POOL_RUNS,
                         ids=["int8", "int4", "int8-spec3"])
def test_tp2_pool_is_token_exact(world, kv, spec_k):
    """Both ranks' pool tokens equal each other and the port's one-process
    pool's; the int8 and int4 pools also equal the JAX TP pool's.  Each
    segment broadcasts its tokens (and, with ``spec_k``, its verdicts)
    from model rank 0."""
    res, _ = world
    got0, got1 = res[0][0][(kv, spec_k)], res[1][0][(kv, spec_k)]
    one = _one_pool(kv, spec_k)
    assert len(got0["tokens"]) == len(one) == 3
    for a, b, c in zip(got0["tokens"], got1["tokens"], one):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got0["counts"]["broadcast"]["calls"] > 0
    assert got0["counts"] == got1["counts"]
    if not spec_k:
        for a, b in zip(got0["tokens"], _jax_tp_pool(kv)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv,advance", [(16, "shared"), (16, "per_row"),
                                        (8, "shared"), (8, "per_row")])
def test_tp2_spec_sampler_is_token_exact(world, kv, advance):
    """Greedy speculative tokens (k 3) of both ranks equal plain greedy and
    the JAX TP speculative Sampler at the same advance; every suffix cache
    the loop allocated holds the rank's 1 of the 2 heads."""
    r0, r1 = world[0][0][1], world[0][1][1]
    key = (kv, advance, 0)
    got0, got1 = r0[key], r1[key]
    np.testing.assert_array_equal(got0["tokens"], got1["tokens"])
    sampling = SamplingConfig(greedy=True, max_new_tokens=SPEC_NEW,
                              eos_token_id=-1)
    with torch.inference_mode():
        plain = Sampler(sampling, kv_bits=kv).generate(
            _one_model(), t(IDS), t(MASK), t(IMAGES)).numpy()
    np.testing.assert_array_equal(got0["tokens"], plain)
    for r in (r0, r1):
        assert r[key]["shapes"] and all(
            s[2:] == (1, JCFG32.llama.head_dim) for s in r[key]["shapes"])
    mesh, params_tp = _jax_tp_params()
    jax_attn.set_tp_mesh(mesh)
    try:
        want = np.asarray(JaxSampler(
            JCFG32, JaxSampling(greedy=True, max_new_tokens=SPEC_NEW,
                                eos_token_id=-1), kv_bits=kv, spec_k=3,
            spec_advance=advance).generate(
            params_tp, jnp.asarray(IDS), jnp.asarray(MASK),
            jnp.asarray(IMAGES), jax.random.PRNGKey(7)))
    finally:
        jax_attn.set_tp_mesh(None)
    np.testing.assert_array_equal(got0["tokens"], want)


@pytest.mark.parametrize("kv,advance", [(8, "per_row"), (16, "shared")])
def test_tp2_spec_top_k_sampling_is_equal_on_both_ranks(world, kv, advance):
    """Top-k 5 speculative sampling (k 3) from a generator seeded alike on
    each rank: both ranks emit the same tokens, inside the vocabulary."""
    key = (kv, advance, 5)
    a, b = world[0][0][1][key]["tokens"], world[0][1][1][key]["tokens"]
    np.testing.assert_array_equal(a, b)
    assert a.shape == (IDS.shape[0], SPEC_NEW)
    assert ((a >= 0) & (a < JCFG32.llama.vocab_size)).all()


def test_tp2_rollout_with_the_pool_matches_one_process(
        world, rollout_inputs, tmp_path, monkeypatch):
    """``online_generation.run`` at ``mesh.model`` 2 with
    ``continuous_slots`` 2 (``top_k`` 1, the stubbed service): model rank 0
    writes the one data rank's shards, equal to the one-process run's
    record for record; model rank 1 corrects nothing."""
    res, gen = world
    assert [r[2]["calls"] for r in res] == [6, 0]
    assert [r[2]["rows"] for r in res] == [6, 6]
    monkeypatch.setattr(runtime, "llava_config_from_hf", lambda _: TCFG32)
    monkeypatch.setenv("API_KEY", "dummy")
    monkeypatch.setattr(online_generation, "get_api_service",
                        lambda rank=0, cache_path="": _StubService())
    one = str(tmp_path / "one")
    online_generation.run(config.Config(_rollout_cfg(one, rollout_inputs,
                                                     1)))

    def shards(d):
        d = os.path.join(d, "rollouts")
        return {n: json.load(open(os.path.join(d, n)))
                for n in sorted(os.listdir(d))}

    got, want = shards(gen), shards(one)
    assert list(got) == ["step1_rank0.json", "step2_rank0.json",
                         "step3_rank0.json"]
    assert got == want
    assert any(r["original_generate_response"] for s in got.values()
               for r in s)
