"""Tensor parallelism of the port (``opadpo_torch/parallel``) at TP 2 on
the CPU: two gloo ranks (``tests/torch_parallel_worker.py``) started once
for the file, against the JAX package on its virtual mesh
(``MeshConfig(data=1, model=2)``) and the port's one-process run.

- the forward's logits, ``chunked_logprobs`` and entropies over the split
  vocabulary, and the adapter's gradients, at bits 16 / 8 / 4 (bits 4 on
  the tiny model with 4 heads: the tiny ``wo`` of 128 inputs would put
  half a group of 128 in each row shard, which the int4 kernel cannot
  take and the port refuses);
- the greedy Sampler at the bf16 split cache, int8 KV with the chunked
  fold and int4 KV, token for token.

Tolerances, f32: logits, logprobs and entropies 1e-5 of the largest
reference entry; gradients 1e-4 of each leaf's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.constants import IMAGE_TOKEN_INDEX
from opadpo_tpu.engine.sampler import Sampler as JaxSampler
from opadpo_tpu.engine.sampling import SamplingConfig as JaxSampling
from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.ops import attention as jax_attn
from opadpo_tpu.ops import logprobs as jax_lp
from opadpo_tpu.ops.quant import quantize_params
from opadpo_tpu.parallel import (
    MeshConfig, make_mesh, param_partition_specs, shard_pytree,
)
from opadpo_torch import bridge
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llava as t_llava
from opadpo_torch.models.lora import make_trainable, named_leaves
from opadpo_torch.ops.logprobs import chunked_logprobs
from tests.torch_parallel_worker import launch, tiny_f32
from tests.torch_parity import JCFG32, inputs, jax_lora, t, to_np

SCALING = 2.0
BITS = (16, 8, 4)
RUNS = ((16, 0, 5), (8, 0, 5), (4, 0, 5), (8, 128, 132))


def _jcfg(bits):
    heads = 4 if bits == 4 else 2
    return dataclasses.replace(JCFG32, llama=dataclasses.replace(
        JCFG32.llama, num_heads=heads, num_kv_heads=heads))


def _jparams(bits):
    p = jax_llava.init_params(jax.random.PRNGKey(0), _jcfg(bits))
    return p if bits == 16 else quantize_params(p, bits=bits)


def _labels(s, seed=9):
    """Random labels over the spliced sequence, ignored at row 0's first
    three positions and at row 1's left pad (a query that sees no key),
    where also the entropy is not scored (``ENT_W``)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, JCFG32.llama.vocab_size, (2, s)).astype(np.int32)
    lab[0, :3] = -100
    lab[1, 0] = -100
    return lab


def _spliced_len(ids):
    return ids.shape[1] - 1 + JCFG32.vision.num_patches


LORAS = {bits: jax_lora(1, cfg=_jcfg(bits)) for bits in BITS}
IDS, MASK, IMAGES = inputs()
LABELS = _labels(_spliced_len(IDS))
ENT_W = (LABELS != -100).astype(np.float32)
ENT_W[0, :3] = 1.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One TP-2 world for every case of the file."""
    cases = [("tp_forward", dict(
        params=to_np(_jparams(bits)), lora=to_np(LORAS[bits]), ids=IDS, mask=MASK,
        images=IMAGES, labels=LABELS, ent_w=ENT_W,
        num_heads=4 if bits == 4 else 2))
        for bits in BITS]
    cases.append(("tp_sampler", dict(params=to_np(_jparams(16)), ids=IDS,
                                     mask=MASK, images=IMAGES, runs=RUNS)))
    return launch(2, cases, tmp_path_factory.mktemp("tp"), timeout=85)


def _jax_forward(bits, mesh):
    cfg = _jcfg(bits)
    params = _jparams(bits)
    lora = LORAS[bits]
    if mesh is not None:
        params = shard_pytree(params, param_partition_specs(params, mesh),
                              mesh)
        lora = shard_pytree(lora, param_partition_specs(lora, mesh), mesh)

    def f(lo):
        logits = jax_llava.forward(params, cfg, IDS, MASK, IMAGES, lora=lo,
                                   lora_scaling=SCALING,
                                   remat=False)["logits"]
        lp = jax_lp.per_token_logprobs(logits, LABELS, -100)
        ent = jax_lp.per_token_entropy(logits)
        return jnp.sum(lp) + 0.1 * jnp.sum(ent * ENT_W), (logits, lp, ent)

    (_, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(lora)
    port = bridge.lora_from_jax(to_np(grads), "cpu")
    return [np.asarray(x) for x in aux], {
        p: g.numpy() for p, g in named_leaves(port)}


def _port_one_process(bits):
    model = bridge.llava_from_jax(to_np(_jparams(bits)),
                                  tiny_f32(4 if bits == 4 else 2), "cpu")
    lt = make_trainable(bridge.lora_from_jax(to_np(LORAS[bits]), "cpu"))
    hidden = t_llava.forward(model, t(IDS), t(MASK), t(IMAGES), lora=lt,
                             lora_scaling=SCALING,
                             return_hidden=True)["hidden"]
    lp, ent = chunked_logprobs(
        hidden, model.llama.lm_head.weight, t(LABELS).long(), -100,
        with_entropy=True, head_lora=lt["llama"]["lm_head"],
        lora_scaling=SCALING, chunk_size=100)
    leaves = named_leaves(lt)
    grads = torch.autograd.grad(lp.sum() + 0.1 * (ent * t(ENT_W)).sum(),
                                [x for _, x in leaves])
    return lp.detach().numpy(), ent.detach().numpy(), {
        p: g.numpy() for (p, _), g in zip(leaves, grads)}


def _close(got, want, rel, what):
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(),
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("bits", BITS)
def test_tp2_forward_logprobs_and_grads_match_jax(world, bits):
    """Both ranks' gathered logits, logprobs and entropies against the JAX
    forward on the ``1 x 2`` mesh and the port's one process; the adapter's
    gradients (split ``b`` leaves gathered) against JAX's."""
    i = BITS.index(bits)
    r0, r1 = world[0][i], world[1][i]
    mesh = make_mesh(MeshConfig(data=1, model=2), jax.devices()[:2])
    (logits, lp, ent), jgrads = _jax_forward(bits, mesh)
    for r in (r0, r1):
        _close(r["logits"], logits, 1e-5, f"logits bits {bits}")
        _close(r["lp"], lp, 1e-5, f"lp bits {bits}")
        _close(r["ent"], ent, 1e-5, f"ent bits {bits}")
    one_lp, one_ent, one_grads = _port_one_process(bits)
    _close(r0["lp"], one_lp, 1e-5, "lp against one process")
    _close(r0["ent"], one_ent, 1e-5, "ent against one process")
    for path, g in one_grads.items():
        _close(r0["grads"][path], g, 1e-4, path)
        np.testing.assert_array_equal(r0["grads"][path], r1["grads"][path])
    assert jgrads.keys() == one_grads.keys()
    for path, want in jgrads.items():
        _close(r0["grads"][path], want, 1e-4, path)
    # the row-parallel layers' sums and the vocabulary's
    assert r0["counts"]["all_reduce"]["calls"] > 0


def test_tp2_sampler_is_token_exact(world):
    """Greedy tokens of both ranks equal the port's one-process Sampler and
    the JAX Sampler on the ``1 x 2`` mesh (flash and decode kernels under
    ``shard_map``): the bf16 split cache, int8 KV, int4 KV, and int8 KV
    chunked at 128 with one fold (132 tokens)."""
    got0, got1 = world[0][len(BITS)], world[1][len(BITS)]
    params = _jparams(16)
    model = bridge.llava_from_jax(to_np(params), tiny_f32(), "cpu")
    mesh = make_mesh(MeshConfig(data=1, model=2), jax.devices()[:2])
    params_tp = shard_pytree(params, param_partition_specs(params, mesh),
                             mesh)
    ids = jnp.asarray(IDS)
    for kv, chunk, n in RUNS:
        np.testing.assert_array_equal(got0[(kv, chunk, n)],
                                      got1[(kv, chunk, n)])
        with torch.inference_mode():
            one = Sampler(SamplingConfig(greedy=True, max_new_tokens=n,
                                         eos_token_id=-1), kv_bits=kv,
                          chunk=chunk).generate(model, t(IDS), t(MASK),
                                                t(IMAGES)).numpy()
        np.testing.assert_array_equal(got0[(kv, chunk, n)], one)
        jax_attn.set_tp_mesh(mesh)
        try:
            want = np.asarray(JaxSampler(
                JCFG32, JaxSampling(greedy=True, max_new_tokens=n,
                                    eos_token_id=-1), kv_bits=kv,
                chunk=chunk).generate(
                params_tp, ids, jnp.asarray(MASK), jnp.asarray(IMAGES),
                jax.random.PRNGKey(7)))
        finally:
            jax_attn.set_tp_mesh(None)
        np.testing.assert_array_equal(got0[(kv, chunk, n)], want)
    assert IMAGE_TOKEN_INDEX in IDS
