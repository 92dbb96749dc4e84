"""Parity of the port's int4 prompt cache, chunked decode and the two
remaining decode-attention kernels' plain versions (#7 over the packed
int4 cache, #8 for G queries) with the JAX package, on the CPU; the JAX
kernels run in interpret mode.  Model-level checks use the tiny LLaVA in
f32 with the JAX weights carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.engine.sampler import Sampler as JaxSampler
from opadpo_tpu.engine.sampling import SamplingConfig as JaxSampling
from opadpo_tpu.models import llama as jax_llama
from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.ops import decode_attention as jax_decode
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llama as t_llama
from opadpo_torch.models import llava as t_llava
from opadpo_torch.ops import decode_attention as t_decode
from tests.torch_parity import JCFG32, inputs, jax_params, t, torch_model

PARAMS = jax_params()
MODEL = torch_model(PARAMS)


def _kv(seed, shape=(2, 300, 3, 16)):
    kv = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    kv[0, 7] = 0.0                       # an all-zero row: scale 1e-8/7
    kv[1, 11, 0, :3] = [3.5, -3.5, 0.5]  # values on rounding boundaries
    return kv


@pytest.mark.parametrize("total_len", [None, 1024])
def test_quantize_prompt_kv_int4_bit_exact(total_len):
    """Codes, packing and scales of the int4 quantizer equal the JAX
    package's bit for bit (padded to 512, or preallocated at 1024); the
    int8 quantizer's preallocation too; dequantizing gives JAX's values."""
    kv = _kv(6)
    ref = jax_llama.quantize_prompt_kv_int4(jnp.asarray(kv), total_len)
    out = t_llama.quantize_prompt_kv_int4(t(kv), total_len)
    np.testing.assert_array_equal(out["q4"].numpy(), np.asarray(ref["q4"]))
    np.testing.assert_array_equal(out["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    assert out["q4"].shape == (2, 3, (total_len or 512) // 2, 16)
    np.testing.assert_array_equal(
        t_llama.dequantize_prompt_kv_int4(out).numpy(),
        np.asarray(jax_llama.dequantize_prompt_kv_int4(ref)))
    ref8 = jax_llama.quantize_prompt_kv(jnp.asarray(kv), total_len)
    out8 = t_llama.quantize_prompt_kv(t(kv), total_len)
    for key in ("q", "scale"):
        np.testing.assert_array_equal(out8[key].numpy(),
                                      np.asarray(ref8[key]))
    with pytest.raises(ValueError, match="multiple of 256"):
        t_llama.quantize_prompt_kv_int4(t(kv), 640)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_fold_suffix_bit_exact(kv_bits):
    """The in-place fold writes the same cache and mask as the JAX
    package's ``fold_suffix_into_prompt_kv`` on the same suffix."""
    c = 256 if kv_bits == 4 else 128
    total, offset, filled = 3 * c, c, c - 3
    layers = [(_kv(s, (2, 60, 2, 16)), _kv(s + 1, (2, 60, 2, 16)))
              for s in (1, 3)]
    suffix = [(_kv(s, (2, c, 2, 16)), _kv(s + 1, (2, c, 2, 16)))
              for s in (5, 7)]
    mask = np.zeros((2, total), np.int32)
    mask[:, 2:60] = 1
    ref_kv, ref_mask = jax_llama.fold_suffix_into_prompt_kv(
        jax_llama.quantize_prompt_kv_list(
            [(jnp.asarray(k), jnp.asarray(v)) for k, v in layers], total,
            kv_bits),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in suffix],
        jnp.asarray(mask), jnp.int32(filled), jnp.int32(offset))
    cache = t_llama.quantize_prompt_kv_list(
        [(t(k), t(v)) for k, v in layers], total, kv_bits)
    t_mask = t(mask, torch.int64)
    out_kv, out_mask = t_llama.fold_suffix_into_prompt_kv(
        cache, [(t(k), t(v)) for k, v in suffix], t_mask, filled, offset)
    assert out_kv is cache and out_mask is t_mask          # in place
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    for pair, ref_pair in zip(out_kv, ref_kv):
        for d, r in zip(pair, ref_pair):
            assert d.keys() == r.keys()
            for key in d:
                np.testing.assert_array_equal(d[key].numpy(),
                                              np.asarray(r[key]))


def _softmax_state(out, m, l):
    """(normalised output, m, lse) from a kernel's flash state."""
    out, m, l = (np.asarray(x, np.float64) for x in (out, m, l))
    return out / l[..., None], m, m + np.log(l)


@pytest.mark.parametrize("sp_pad,sp_real,block_s,s_used", [
    (512, 400, 1024, None), (1024, 700, 256, None), (1024, 700, 1024, 768)])
def test_decode_attention_prompt4_plain_matches_jax(sp_pad, sp_real,
                                                    block_s, s_used):
    """#7's plain version against the interpret-mode Pallas kernel at the
    cases of ``tests/test_attention.py``.  The Pallas kernel keeps a
    running max per 128-position tile and the port normalises against the
    global max: m agrees to 1e-5; the normalised output and the lse differ
    only where p * v_scale was rounded to bf16 at another max (measured
    1.7e-3 of the output's largest entry and 1.1e-7), held at 1e-2 of the
    largest entry and 1e-5."""
    rng = np.random.default_rng(3)
    b, h, hd = 2, 4, 128
    q = rng.standard_normal((b, h, hd)).astype(np.float32) * 0.4
    kv = [rng.standard_normal((b, sp_pad, h, hd)).astype(np.float32)
          for _ in range(2)]
    pk, pv = (jax_llama.quantize_prompt_kv_int4(jnp.asarray(x)) for x in kv)
    bias = np.zeros((b, sp_pad), np.float32)
    bias[:, sp_real:] = -1e30
    bias[0, 5] = -1e30
    sm = hd ** -0.5
    ref = jax_decode.decode_attention_prompt4(
        jnp.asarray(q), pk["q4"], pk["scale"], pv["q4"], pv["scale"],
        jnp.asarray(bias), sm, block_s=block_s, s_used=s_used)
    out = t_decode.decode_attention_prompt4(
        t(q), t(pk["q4"]), t(pk["scale"]), t(pv["q4"]), t(pv["scale"]),
        t(bias), sm, s_used=s_used)
    (o, m, lse), (ro, rm, rlse) = (_softmax_state(*x) for x in (out, ref))
    np.testing.assert_allclose(m, rm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o, ro, rtol=0, atol=1e-2 * np.abs(ro).max())
    np.testing.assert_allclose(lse, rlse, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of 256"):
        t_decode.decode_attention_prompt4(
            t(q), t(pk["q4"]), t(pk["scale"]), t(pv["q4"]), t(pv["scale"]),
            t(bias), sm, s_used=384)


@pytest.mark.parametrize("kwargs", [{"block_h": 8},
                                    {"block_h": 8, "block_s": 256},
                                    {"block_h": 16, "s_used": 256}])
def test_decode_attention_multi_plain_matches_jax(kwargs):
    """#8's plain version against the interpret-mode Pallas kernel at the
    cases of ``tests/test_attention.py`` and against G calls of #6's plain
    version.  One sequence block (512 positions, or s_used 256): the raw
    (out, m, l) to 1e-4 (measured 2e-7); two blocks (block_s 256): m to
    1e-5, the normalised output to 1e-2 of its largest entry (measured
    1.8e-3) and the lse to 1e-5, as for #7.  The G single-query calls agree to 1e-5 (the same products,
    summed in another blocking)."""
    rng = np.random.default_rng(1)
    b, h, gq, hd, sp = 2, 16, 5, 128, 512
    q = rng.standard_normal((b, h, gq, hd)).astype(np.float32) * 0.4
    pk, pv = (rng.integers(-127, 128, (b, h, sp, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (np.abs(rng.standard_normal((b, h, sp))).astype(np.float32)
              * 0.01 + 1e-4 for _ in range(2))
    bias = np.zeros((b, sp), np.float32)
    bias[:, 400:] = -1e30
    sm = hd ** -0.5
    ref = jax_decode.decode_attention_prompt_multi(
        *(jnp.asarray(x) for x in (q, pk, ks, pv, vs, bias)), sm, **kwargs)
    args = [t(x) for x in (q, pk, ks, pv, vs, bias)]
    out = t_decode.decode_attention_prompt_multi(
        *args, sm, s_used=kwargs.get("s_used"))
    assert out[0].shape == (b, h, gq, hd) and out[1].shape == (b, h, gq)
    if "block_s" not in kwargs:
        for name, o, r in zip(("out", "m", "l"), out, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(o.numpy(), r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=name)
    else:
        (o, m, lse), (ro, rm, rlse) = (_softmax_state(*x)
                                       for x in (out, ref))
        np.testing.assert_allclose(m, rm, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o, ro, rtol=0,
                                   atol=1e-2 * np.abs(ro).max())
        np.testing.assert_allclose(lse, rlse, rtol=0, atol=1e-5)
    for g in range(gq):
        one = t_decode.decode_attention_prompt(
            args[0][:, :, g], *args[1:], sm, s_used=kwargs.get("s_used"))
        for a, r in zip((x[:, :, g] for x in out), one):
            torch.testing.assert_close(a, r, rtol=1e-5,
                                       atol=1e-5 * r.abs().max().item())


def _prefill(kv_bits, total_len=None):
    ids, mask, images = inputs()
    up, _ = jax_llava.unstack_for_decode(PARAMS, None)
    ref = jax_llava.prefill_unrolled(
        up, JCFG32, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(images),
        quantize_kv=True, kv_total_len=total_len, kv_bits=kv_bits)
    with torch.inference_mode():
        out = t_llava.prefill_unrolled(
            MODEL, t(ids, torch.int64), t(mask, torch.int64), t(images),
            quantize_kv=True, kv_total_len=total_len, kv_bits=kv_bits)
    return up, ref, out


def test_kv4_decode_step_matches_jax():
    """Two decode steps over the int4 cache (#7's plain version), the
    first at a fill watermark below the preallocated length, with the
    cache from both prefills bit-equal: logits to 1e-4 of their largest
    entry (measured 5e-7; the JAX kernel's per-tile maxima move the bf16
    rounding of p * v_scale)."""
    up, ref_pf, pf = _prefill(4, total_len=512)
    cache = pf["kv_list"][0][0]
    assert cache["q4"].shape == (2, 2, 256, 64) and cache["q4"].dtype == \
        torch.int8 and cache["scale"].shape == (2, 2, 512)
    for pair, ref_pair in zip(pf["kv_list"], ref_pf["kv_list"]):
        for d, r in zip(pair, ref_pair):
            np.testing.assert_array_equal(d["q4"].numpy(),
                                          np.asarray(r["q4"]))
    nkv, hd = JCFG32.llama.num_kv_heads, JCFG32.llama.head_dim
    n_layers = JCFG32.llama.num_layers
    j_sfx = [(jnp.zeros((2, 4, nkv, hd)), jnp.zeros((2, 4, nkv, hd)))
             for _ in range(n_layers)]
    t_sfx = [(torch.zeros(2, 4, nkv, hd), torch.zeros(2, 4, nkv, hd))
             for _ in range(n_layers)]
    sp_mask = np.pad(np.asarray(ref_pf["key_mask"]),
                     ((0, 0), (0, 512 - ref_pf["key_mask"].shape[1])))
    pos, tpos = ref_pf["next_position"], pf["next_position"]
    for step, (tok, su) in enumerate((([7, 11], 256), ([3, 5], None))):
        ref, j_sfx = jax_llava.decode_step_unrolled(
            up, JCFG32, jnp.asarray(tok), list(ref_pf["kv_list"]),
            jnp.asarray(sp_mask), j_sfx, jnp.int32(step), pos, sp_used=su)
        with torch.inference_mode():
            out, t_sfx = t_llava.decode_step_unrolled(
                MODEL, t(tok, torch.int64), pf["kv_list"],
                t(sp_mask, torch.int64), t_sfx, step, tpos, sp_used=su)
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        pos, tpos = pos + 1, tpos + 1


def _generate(kv_bits, chunk, n_new):
    ids, mask, images = inputs()
    ref = JaxSampler(JCFG32, JaxSampling(greedy=True, max_new_tokens=n_new,
                                         eos_token_id=-1),
                     kv_bits=kv_bits, chunk=chunk).generate(
        PARAMS, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(images),
        jax.random.PRNGKey(0))
    sampler = Sampler(SamplingConfig(greedy=True, max_new_tokens=n_new,
                                     eos_token_id=-1),
                      kv_bits=kv_bits, chunk=chunk)
    with torch.inference_mode():
        out = sampler.generate(MODEL, t(ids, torch.int64),
                               t(mask, torch.int64), t(images))
    return np.asarray(ref), out.numpy(), sampler.stats[-1]


@pytest.mark.parametrize("kv_bits,chunk,n_new,watermarks", [
    (4, 0, 5, []), (8, 128, 140, [128, 256]), (4, 256, 300, [256, 512])])
def test_sampler_kv4_and_chunked_greedy_token_exact(kv_bits, chunk, n_new,
                                                    watermarks):
    """Greedy output equal to the JAX Sampler's token for token: the int4
    cache, and chunked decode with one fold at kv 8 and kv 4 (every step
    of the first chunk runs its forward, its KV is folded and its last
    logits start the second chunk, which reads to the next watermark)."""
    ref, out, stats = _generate(kv_bits, chunk, n_new)
    np.testing.assert_array_equal(out, ref)
    assert stats["decode_steps"] == n_new - 1
    assert stats["folds"] == len(watermarks[1:])
    assert stats["sp_used"] == watermarks
