"""Shared set-up for the parity tests of the PyTorch port against the JAX
package: tiny f32 configurations on both sides, one set of JAX weights
carried across through ``opadpo_torch.bridge``, and inputs made from a
numpy seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opadpo_tpu.constants import IMAGE_TOKEN_INDEX
from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.models.lora import LoraConfig as JaxLoraConfig
from opadpo_torch import bridge
from opadpo_torch.models.llava import LlavaConfig as TorchLlavaConfig

# the CPU workers of the test run share the machine
torch.set_num_threads(2)
# f32 matmuls in full f32 on any device, stated for the record
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_J = jax_llava.LlavaConfig.tiny()
JCFG32 = jax_llava.LlavaConfig(
    dataclasses.replace(_J.llama, dtype=jnp.float32),
    dataclasses.replace(_J.vision, dtype=jnp.float32),
    dataclasses.replace(_J.projector, dtype=jnp.float32))
_T = TorchLlavaConfig.tiny()
TCFG32 = TorchLlavaConfig(
    dataclasses.replace(_T.llama, dtype=torch.float32),
    dataclasses.replace(_T.vision, dtype=torch.float32),
    dataclasses.replace(_T.projector, dtype=torch.float32))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_params(seed: int = 0) -> dict:
    return jax_llava.init_params(jax.random.PRNGKey(seed), JCFG32)


def torch_model(params: dict):
    return bridge.llava_from_jax(to_np(params), TCFG32, device="cpu")


def jax_lora(seed: int = 1, rank: int = 4, cfg=None) -> dict:
    """A non-zero adapter over the decoder, the vision tower, the
    projector and the lm_head (the JAX init leaves B at zero), for ``cfg``
    (default ``JCFG32``)."""
    cfg = cfg or JCFG32
    lcfg = JaxLoraConfig(rank=rank, alpha=2.0 * rank, dtype=jnp.float32)
    lora = jax_llava.init_lora(jax.random.PRNGKey(seed), cfg, lcfg,
                               include_vision=True)
    rng = np.random.default_rng(seed)

    def fill_b(path, x):
        if getattr(path[-1], "key", None) == "b":
            return jnp.asarray(rng.normal(0, 0.05, x.shape), jnp.float32)
        return x

    lora = jax.tree_util.tree_map_with_path(fill_b, lora)
    d, v = cfg.llama.hidden_size, cfg.llama.vocab_size
    lora["llama"]["lm_head"] = {
        "a": jnp.asarray(rng.normal(0, 0.1, (d, rank)), jnp.float32),
        "b": jnp.asarray(rng.normal(0, 0.05, (rank, v)), jnp.float32)}
    return lora


def jax_llama_lora(seed: int) -> dict:
    """A non-zero adapter over the decoder and the lm_head (the DPO
    stage's adapter has no vision part)."""
    return {"llama": jax_lora(seed)["llama"]}


def dpo_batch(b=2, lq=6, r=8, seed=7):
    """A numpy DPO batch: left-padded queries with one image token, three
    response types with pad tails, scores and image relations."""
    rng = np.random.default_rng(seed)
    v = JCFG32.llama.vocab_size
    queries = rng.integers(5, v, (b, lq)).astype(np.int32)
    queries[:, 1] = IMAGE_TOKEN_INDEX
    q_mask = np.ones((b, lq), np.int32)
    q_mask[0, 0] = 0
    sz = JCFG32.vision.image_size
    out = {"queries": queries, "queries_attention_mask": q_mask,
           "images": rng.normal(size=(b, sz, sz, 3)).astype(np.float32)}
    keys = ("standard_response", "original_generate_response",
            "AI_pseudo_response")
    for i, key in enumerate(keys):
        ids = rng.integers(5, v, (b, r)).astype(np.int32)
        ids[:, r - 2 - i % 2:] = 0
        out[key] = ids
        out[key + "_attention_mask"] = (ids != 0).astype(np.int32)
    scores = rng.uniform(1.0, 2.5, (b, r)).astype(np.float32)
    scores *= out["AI_pseudo_response_attention_mask"]
    out["AI_pseudo_response_scores"] = scores
    out["original_generate_response_scores"] = scores[::-1].copy()
    out["AI_pseudo_response_image_relations"] = scores * 0.5 + 0.5
    return out


def grads_as_jax(params, grads):
    """Gradients in ``named_leaves`` order -> the JAX adapter layout."""
    from opadpo_torch.models.lora import named_leaves, tree_map
    for (_, leaf), g in zip(named_leaves(params), grads):
        leaf.grad = g
    return bridge.lora_to_jax(tree_map(lambda x: x.grad, params))


def assert_trees_close(port, ref, rel=None, atol=None):
    """Every leaf of ``port`` against ``ref``: within ``atol``, or ``rel``
    times the reference leaf's largest entry."""
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_p) == len(flat_r)
    for path, p in flat_p:
        r = np.asarray(flat_r[path])
        tol = atol if atol is not None else rel * np.abs(r).max()
        np.testing.assert_allclose(p, r, atol=tol, rtol=0, err_msg=str(path))


def inputs(b: int = 2, l: int = 10, seed: int = 4):
    """Left-padded prompts with one image token each, numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, JCFG32.llama.vocab_size, (b, l)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    mask = np.ones((b, l), np.int32)
    mask[1, 0] = 0
    sz = JCFG32.vision.image_size
    images = rng.normal(size=(b, sz, sz, 3)).astype(np.float32)
    return ids, mask, images


def t(x, dtype=None):
    out = torch.from_numpy(np.asarray(x))
    return out if dtype is None else out.to(dtype)
