"""Parity of the port's models and sampler with the JAX package on the
tiny LLaVA in f32, weights carried across through ``opadpo_torch.bridge``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.engine.sampler import Sampler as JaxSampler
from opadpo_tpu.engine.sampler import truncate_after_tokens as jax_truncate
from opadpo_tpu.engine.sampling import SamplingConfig as JaxSampling
from opadpo_tpu.models import clip as jax_clip
from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.models import projector as jax_projector
from opadpo_torch import bridge
from opadpo_torch.engine.sampler import Sampler, truncate_after_tokens
from opadpo_torch.engine.sampling import SamplingConfig, sample_tokens
from opadpo_torch.models import llava as t_llava
from tests.torch_parity import (
    JCFG32, TCFG32, inputs, jax_lora, jax_params, t, to_np, torch_model,
)

PARAMS = jax_params()
MODEL = torch_model(PARAMS)
LORA = jax_lora()
T_LORA = bridge.lora_from_jax(to_np(LORA), device="cpu")
SCALING = 2.0


@pytest.mark.parametrize("with_lora", [False, True])
def test_clip_and_projector_match_jax(with_lora):
    _, _, images = inputs()
    lora = LORA if with_lora else None
    ref = jax_clip.forward(PARAMS["vision"], JCFG32.vision,
                           jnp.asarray(images),
                           lora=lora and lora["vision"], lora_scaling=SCALING)
    with torch.inference_mode():
        out = MODEL.vision(t(images), lora=T_LORA["vision"] if with_lora
                           else None, lora_scaling=SCALING)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    ref_p = jax_projector.forward(PARAMS["projector"], ref,
                                  lora=lora and lora["projector"],
                                  lora_scaling=SCALING)
    with torch.inference_mode():
        out_p = MODEL.projector(out, lora=T_LORA["projector"] if with_lora
                                else None, lora_scaling=SCALING)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=1e-4)


def _jax_prefill(lora, quantize_kv=False):
    up, ul = jax_llava.unstack_for_decode(PARAMS, lora)
    ids, mask, images = inputs()
    return jax_llava.prefill_unrolled(
        up, JCFG32, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(images),
        lora=ul, lora_scaling=SCALING, quantize_kv=quantize_kv)


def _torch_prefill(lora, quantize_kv=False):
    ids, mask, images = inputs()
    with torch.inference_mode():
        return t_llava.prefill_unrolled(
            MODEL, t(ids, torch.int64), t(mask, torch.int64), t(images),
            lora=lora, lora_scaling=SCALING, quantize_kv=quantize_kv)


@pytest.mark.parametrize("with_lora", [False, True])
def test_prefill_unrolled_matches_jax(with_lora):
    """last_logits and every layer's KV to 1e-4, the spliced mask and the
    next positions exactly; the adapter covers the decoder, the vision
    tower, the projector and the lm_head."""
    ref = _jax_prefill(LORA if with_lora else None)
    out = _torch_prefill(T_LORA if with_lora else None)
    np.testing.assert_allclose(out["last_logits"].numpy(),
                               np.asarray(ref["last_logits"]), atol=1e-4)
    for (k, v), (rk, rv) in zip(out["kv_list"], ref["kv_list"]):
        np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-4)
    np.testing.assert_array_equal(out["key_mask"].numpy(),
                                  np.asarray(ref["key_mask"]))
    np.testing.assert_array_equal(out["next_position"].numpy(),
                                  np.asarray(ref["next_position"]))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_decode_step_matches_jax(kv_bits):
    """One decode step after prefill, bf16-free f32 model: logits to 1e-4
    and the suffix KV written at the step."""
    q8 = kv_bits == 8
    ref_pf = _jax_prefill(LORA, quantize_kv=q8)
    pf = _torch_prefill(T_LORA, quantize_kv=q8)
    nkv, hd = JCFG32.llama.num_kv_heads, JCFG32.llama.head_dim
    n_layers = JCFG32.llama.num_layers
    tok = np.asarray([7, 11])
    up, ul = jax_llava.unstack_for_decode(PARAMS, LORA)
    j_suffix = [(jnp.zeros((2, 4, nkv, hd)), jnp.zeros((2, 4, nkv, hd)))
                for _ in range(n_layers)]
    ref, ref_sfx = jax_llava.decode_step_unrolled(
        up, JCFG32, jnp.asarray(tok), list(ref_pf["kv_list"]),
        ref_pf["key_mask"], j_suffix, jnp.int32(1),
        ref_pf["next_position"], lora=ul, lora_scaling=SCALING)
    t_suffix = [(torch.zeros(2, 4, nkv, hd), torch.zeros(2, 4, nkv, hd))
                for _ in range(n_layers)]
    with torch.inference_mode():
        out, sfx = t_llava.decode_step_unrolled(
            MODEL, t(tok, torch.int64), pf["kv_list"], pf["key_mask"],
            t_suffix, 1, pf["next_position"], lora=T_LORA,
            lora_scaling=SCALING)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    for (k, v), (rk, rv) in zip(sfx, ref_sfx):
        np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-4)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_sampler_greedy_token_exact(kv_bits):
    ids, mask, images = inputs()
    n_new = 6
    ref = JaxSampler(JCFG32, JaxSampling(greedy=True, max_new_tokens=n_new,
                                         eos_token_id=-1),
                     kv_bits=kv_bits).generate(
        PARAMS, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(images),
        jax.random.PRNGKey(0))
    sampler = Sampler(SamplingConfig(greedy=True,
                                             max_new_tokens=n_new,
                                             eos_token_id=-1),
                      kv_bits=kv_bits)
    with torch.inference_mode():
        out = sampler.generate(MODEL, t(ids, torch.int64),
                               t(mask, torch.int64), t(images))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert sampler.stats[-1]["decode_steps"] == n_new - 1

    # EOS at the second row's third token: both stop and pad alike
    eos = int(out[1, 2])
    j_eos = JaxSampler(JCFG32, JaxSampling(greedy=True, max_new_tokens=n_new,
                                           eos_token_id=eos),
                       kv_bits=kv_bits).generate(
        PARAMS, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(images),
        jax.random.PRNGKey(0))
    with torch.inference_mode():
        t_eos = Sampler(SamplingConfig(
            greedy=True, max_new_tokens=n_new, eos_token_id=eos),
            kv_bits=kv_bits).generate(MODEL, t(ids, torch.int64),
                                      t(mask, torch.int64), t(images))
    np.testing.assert_array_equal(t_eos.numpy(), np.asarray(j_eos))
    extra = (int(out[0, 1]),)
    np.testing.assert_array_equal(
        truncate_after_tokens(t_eos.numpy(), eos, 0, extra),
        jax_truncate(np.asarray(j_eos), eos, 0, extra))


def test_sampled_tokens_stay_in_support():
    """top-k + top-p: every draw lies in the HF support (the top-p prefix
    of the top-k set) and the frequencies follow the renormalised
    probabilities; full-vocab top-p keeps the crossing token."""
    base = np.log(np.asarray([[0.4, 0.3, 0.15, 0.1, 0.05]], np.float32))
    logits = torch.from_numpy(np.pad(base, ((0, 0), (0, 3)),
                                     constant_values=-1e9))
    logits = logits.expand(3000, -1)
    g = torch.Generator().manual_seed(0)
    tok = sample_tokens(logits, SamplingConfig(top_k=4, top_p=0.8), g)
    counts = np.bincount(tok.numpy(), minlength=8)
    assert counts[3:].sum() == 0, counts
    expect = np.asarray([0.4, 0.3, 0.15]) / 0.85
    np.testing.assert_allclose(counts[:3] / 3000, expect, atol=0.04)
    tok = sample_tokens(logits[:200], SamplingConfig(top_p=0.6), g)
    assert set(tok.tolist()) == {0, 1}
    tok = sample_tokens(logits[:50], SamplingConfig(top_k=1), g)
    assert set(tok.tolist()) == {0}


def test_sampler_rejects_unported_modes():
    """The decode modes are ported (kv4, chunk, spec_k); the combinations
    the JAX Sampler asserts against are ValueErrors, as is the oracle
    draft; the pruned model variant (``visual_tokens``) is taken."""
    s = SamplingConfig(greedy=True)
    for kw in (dict(kv_bits=4), dict(kv_bits=8, chunk=128),
               dict(kv_bits=4, chunk=256), dict(spec_k=2),
               dict(kv_bits=8, spec_k=7, spec_advance="per_row",
                    spec_draft="pad")):
        Sampler(s, **kw)
    for kw, match in (
            (dict(kv_bits=16, chunk=128), "kv_bits 8 or 4"),
            (dict(kv_bits=8, chunk=64), "multiple of 128"),
            (dict(kv_bits=4, chunk=128), "multiple of 256"),
            (dict(kv_bits=8, chunk=128, spec_k=2), "without chunk"),
            (dict(kv_bits=4, spec_k=2), "kv_bits 16 or 8"),
            (dict(kv_bits=8, spec_k=8), "at most 8"),
            (dict(spec_k=2, spec_draft="oracle"), "oracle"),
            (dict(spec_k=2, spec_advance="row"), "spec_advance"),
            (dict(kv_bits=2), "kv_bits"), (dict(head_bits=5), "head_bits")):
        with pytest.raises(ValueError, match=match):
            Sampler(s, **kw)
    with pytest.raises(ValueError, match="top_k > 0"):
        Sampler(SamplingConfig(temperature=1.0, top_k=0), spec_k=2)
    Sampler(SamplingConfig(temperature=1.0, top_k=30), spec_k=2)
    import dataclasses
    # visual-token pruning, refused before it was ported: K caps at the
    # tower's patches, and a model takes the configuration
    pruned = dataclasses.replace(TCFG32, visual_tokens=64)
    assert pruned.num_patches == TCFG32.vision.num_patches == 4
    assert dataclasses.replace(TCFG32, visual_tokens=2).num_patches == 2
    assert t_llava.Llava(pruned).cfg.num_patches == 4
    # the port quantizes block linears only; a quantized lm_head is refused
    with pytest.raises(ValueError, match="quantized leaf"):
        bridge.llava_from_jax(
            {**to_np(PARAMS), "llama": {**to_np(PARAMS)["llama"],
                                        "lm_head": {"q": 0, "scale": 0}}},
            TCFG32, device="cpu")


def test_init_params_shapes_and_dtypes():
    """The port's own random init: JAX shapes (transposed to Linear
    layout), bf16 weights, f32 norms, std 0.02, zero biases."""
    g = torch.Generator().manual_seed(0)
    model = t_llava.init_params(t_llava.LlavaConfig.tiny(), g, device="cpu")
    lm = model.llama
    assert lm.layers[0].wq.weight.dtype == torch.bfloat16
    assert lm.layers[0].attn_norm.dtype == torch.float32
    assert torch.all(lm.layers[0].attn_norm == 1)
    assert torch.all(model.vision.layers[0].wq.bias == 0)
    assert tuple(lm.lm_head.weight.shape) == (512, 128)
    assert abs(lm.embed.float().std().item() - 0.02) < 2e-3
    jshapes = jax.eval_shape(lambda: jax_llava.init_params(
        jax.random.PRNGKey(0), jax_llava.LlavaConfig.tiny()))
    assert tuple(model.vision.patch_embed.weight.shape) == \
        jshapes["vision"]["patch_embed"].shape[::-1]
    assert len(lm.layers) == jshapes["llama"]["layers"]["wq"].shape[0]
    assert not any(p.requires_grad for p in model.parameters())


def test_quantized_prompt_kv_from_prefill_matches_jax():
    """The int8 prompt cache prefill hands to decode, end to end: the KV
    it quantizes agrees to ~1e-6, so scales agree to 1e-5 relative and a
    value may step by one where it sits on a rounding boundary
    (``test_quantize_prompt_kv_bit_exact`` holds the quantizer itself to
    bit-exactness)."""
    ref = _jax_prefill(None, quantize_kv=True)["kv_list"]
    out = _torch_prefill(None, quantize_kv=True)["kv_list"]
    for (k, v), (rk, rv) in zip(out, ref):
        for a, r in ((k, rk), (v, rv)):
            np.testing.assert_allclose(a["scale"].numpy(),
                                       np.asarray(r["scale"]), rtol=1e-5)
            diff = np.abs(a["q"].numpy().astype(np.int32)
                          - np.asarray(r["q"]).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
