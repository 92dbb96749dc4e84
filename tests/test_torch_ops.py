"""Parity of the port's ops (``opadpo_torch.ops``) with the JAX package on
the CPU, and the guard that the port imports neither JAX nor the JAX
package.  The kernels themselves are held against their plain versions on
the GPU by ``tests/test_torch_gpu.py``."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opadpo_tpu.ops.attention as jax_attention
from opadpo_tpu.models import llama as jax_llama
from opadpo_tpu.ops import decode_attention as jax_decode
from opadpo_tpu.ops import rope as jax_rope
from opadpo_torch.models import llama as t_llama
from opadpo_torch.ops import attention as t_attention
from opadpo_torch.ops import decode_attention as t_decode
from opadpo_torch.ops import rope as t_rope
from tests.torch_parity import t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    k = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 60, (2, 5)).astype(np.int32)
    jc, js = jax_rope.rope_frequencies(8, 64)
    tc, ts = t_rope.rope_frequencies(8, 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    jq, jk = jax_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js,
                                 jnp.asarray(pos))
    tq, tk = t_rope.apply_rope(t(q), t(k), tc, ts, t(pos, torch.int64))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    ref = jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = t_llama.rms_norm(t(x), t(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def _attn_inputs(s, d, seed):
    """q, k, v [3, s, 2, d]; row 0 unmasked, row 1 left-padded by 37,
    row 2 masked everywhere."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(3, s, 2, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((3, s), np.int32)
    mask[1, :37] = 0
    mask[2, :] = 0
    return q, k, v, mask


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_plain_matches_jax_flash(monkeypatch, causal, d):
    """S=128 fits one Pallas tile, where the JAX kernel's fully masked
    rows are uniform over all keys as in the plain version: every row,
    padded and fully masked ones included, agrees to 1e-5."""
    monkeypatch.setattr(jax_attention, "_DEFAULT_IMPL", "flash")
    q, k, v, mask = _attn_inputs(128, d, seed=d + causal)
    ref = jax_attention.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=jnp.asarray(mask), causal=causal)
    out = t_attention.multi_head_attention(t(q), t(k), t(v),
                                           key_mask=t(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_length_matches_jax_flash(monkeypatch,
                                                         causal):
    """S=200 (not a tile multiple): rows that see at least one valid key
    agree to 1e-5.  The JAX kernel's rows with none average over its
    padded tiles, which no output downstream reads."""
    monkeypatch.setattr(jax_attention, "_DEFAULT_IMPL", "flash")
    q, k, v, mask = _attn_inputs(200, 64, seed=7)
    ref = np.asarray(jax_attention.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=jnp.asarray(mask), causal=causal))
    out = t_attention.multi_head_attention(
        t(q), t(k), t(v), key_mask=t(mask), causal=causal).numpy()
    seen = mask.astype(bool)
    if causal:
        seen = np.cumsum(mask, axis=1) > 0      # a valid key at or before
    np.testing.assert_allclose(out[seen], ref[seen], atol=1e-5)


def test_flash_lse_plain_matches_jax_kernel():
    """The plain version's log-sum-exp against the Pallas forward's saved
    LSE (interpret mode), causal, with left padding: 1e-5."""
    q, k, v, mask = _attn_inputs(128, 128, seed=3)
    mask[2, 5:] = 1
    scale = 128 ** -0.5
    kbias = np.where(mask != 0, 0.0, -1e30).astype(np.float32)[:, None, :]
    _, lse = jax_attention._flash_fwd(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
        jnp.asarray(kbias), True, scale, 128, 128)
    _, t_lse = t_attention.mha_reference_lse(t(q), t(k), t(v), t(mask),
                                             causal=True, scale=scale)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse)[..., 0],
                               rtol=1e-6, atol=1e-5)


def _decode_inputs(seed, b=3, h=2, sp=256, hd=64):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    pk = rng.integers(-127, 128, (b, h, sp, hd)).astype(np.int8)
    pv = rng.integers(-127, 128, (b, h, sp, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (b, h, sp)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (b, h, sp)).astype(np.float32)
    bias = np.zeros((b, sp), np.float32)
    bias[1, :40] = -1e30                 # left padding
    bias[:, 200:] = -1e30                # quantizer padding...
    ks[:, :, 200:] = 0.0                 # ...with zero scales
    vs[:, :, 200:] = 0.0
    bias[2, :] = -1e30                   # a prompt masked everywhere
    return q, pk, ks, pv, vs, bias


@pytest.mark.parametrize("s_used", [None, 128])
def test_decode_attention_plain_matches_jax(s_used):
    q, pk, ks, pv, vs, bias = _decode_inputs(seed=5)
    sm = 64 ** -0.5
    ref = jax_decode.decode_attention_prompt(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(ks), jnp.asarray(pv),
        jnp.asarray(vs), jnp.asarray(bias), sm, s_used=s_used)
    out = t_decode.decode_attention_prompt(
        t(q), t(pk), t(ks), t(pv), t(vs), t(bias), sm, s_used=s_used)
    for name, o, r in zip(("out", "m", "l"), out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_quantize_prompt_kv_bit_exact():
    rng = np.random.default_rng(6)
    kv = rng.normal(size=(2, 203, 3, 16)).astype(np.float32)
    kv[0, 7] = 0.0                       # an all-zero row: scale 1e-8/127
    ref = jax_llama.quantize_prompt_kv(jnp.asarray(kv))
    out = t_llama.quantize_prompt_kv(t(kv))
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_allclose(out["scale"].numpy(), np.asarray(ref["scale"]),
                               rtol=1e-7, atol=0)
    assert out["q"].shape == (2, 3, 256, 16)


def test_port_imports_no_jax():
    """Every opadpo_torch module, and chip_smoke.py, imports in a process
    where ``jax`` and ``opadpo_tpu`` cannot be imported; the training
    slice's, the quantized base's, speculative decode's and the stage-4
    slice's, the stage 1-3 slice's, the continuous engine's, the 13
    eval modules, the multi-GPU package's three and the native image
    pipeline's binding are among them.  A second
    process also blocks the packages the GPU machine lacks (``yaml``,
    ``safetensors``, ``transformers``, ``datasets``, ``PIL``,
    ``requests``): every module still imports, and the config reader and
    the safetensors reader and writer work."""
    blocked_missing = ("yaml", "safetensors", "transformers", "datasets",
                       "PIL", "requests")
    for extra in ((), blocked_missing):
        code = (
            "import sys, pkgutil, importlib, runpy, os, tempfile\n"
            f"for m in ('jax', 'opadpo_tpu') + {extra!r}:\n"
            "    sys.modules[m] = None\n"
            "import opadpo_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "opadpo_torch.__path__, 'opadpo_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "assert len(names) >= 60, names\n"
            "assert {'opadpo_torch.engine.dpo', 'opadpo_torch.engine.train_state',"
            " 'opadpo_torch.ops.heads_layout', 'opadpo_torch.ops.logprobs',"
            " 'opadpo_torch.ops.image_ops', 'opadpo_torch.ops.quant',"
            " 'opadpo_torch.pipeline.runtime', 'opadpo_torch.engine.speculative',"
            " 'opadpo_torch.models.loader', 'opadpo_torch.models.safetensors_io',"
            " 'opadpo_torch.pipeline.config', 'opadpo_torch.pipeline.checkpoints',"
            " 'opadpo_torch.pipeline.opadpo_train', 'opadpo_torch.serve',"
            " 'opadpo_torch.data.datasets', 'opadpo_torch.data.collators',"
            " 'opadpo_torch.data.loading', 'opadpo_torch.data.tokenization',"
            " 'opadpo_torch.data.char_tokenizer', 'opadpo_torch.utils.metrics',"
            " 'opadpo_torch.engine.sft', 'opadpo_torch.pipeline.opa_train',"
            " 'opadpo_torch.pipeline.online_generation',"
            " 'opadpo_torch.pipeline.gpt4v_client',"
            " 'opadpo_torch.pipeline.prompts',"
            " 'opadpo_torch.pipeline.dataset_ops',"
            " 'opadpo_torch.engine.continuous',"
            " 'opadpo_torch.parallel.mesh', 'opadpo_torch.parallel.comm',"
            " 'opadpo_torch.parallel.sharding',"
            " 'opadpo_torch.engine.serving_config',"
            " 'opadpo_torch.eval.model_vqa', 'opadpo_torch.eval.model_vqa_logit',"
            " 'opadpo_torch.eval.model_qa', 'opadpo_torch.eval.model_vqa_science',"
            " 'opadpo_torch.eval.qa_baseline', 'opadpo_torch.eval.pope',"
            " 'opadpo_torch.eval.amber', 'opadpo_torch.eval.amber_similarity',"
            " 'opadpo_torch.eval.mmhal', 'opadpo_torch.eval.llava_bench',"
            " 'opadpo_torch.eval.gpt_review', 'opadpo_torch.eval.object_hal',"
            " 'opadpo_torch.eval.run_all', 'opadpo_torch.data.native_image',"
            " 'opadpo_torch.data.image_processing'}"
            " <= set(names), names\n"
            "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
            "from opadpo_torch.pipeline.config import load_config\n"
            "cfg = load_config('configs/llava_dpo.yaml')\n"
            "assert cfg.training['learning_rate'] == 1e-6, cfg\n"
            "import torch\n"
            "from opadpo_torch.models import safetensors_io as sio\n"
            "t = {'w': torch.randn(3, 4).bfloat16(),"
            " 'i': torch.arange(5, dtype=torch.int8)}\n"
            "path = os.path.join(tempfile.mkdtemp(), 'x.safetensors')\n"
            "sio.save_file(t, path)\n"
            "back = sio.load_file(path)\n"
            "assert all(torch.equal(back[k], t[k]) for k in t)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'opadpo_tpu'))"
            " for k, v in sys.modules.items() if v is not None)\n"
            "print('ok', len(names))\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, (extra, res.stderr)
        assert res.stdout.startswith("ok")


def test_cuda_default_entry_raises_without_gpu(monkeypatch):
    from opadpo_torch.models import llava as t_llava
    from opadpo_torch.models.llava import LlavaConfig

    from opadpo_torch.serve import InferenceWorker
    from tests.fake_tokenizer import FakeTokenizer

    cpu_model = t_llava.empty_model(LlavaConfig.tiny(), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_llava.empty_model(LlavaConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceWorker(cpu_model, LlavaConfig.tiny(), FakeTokenizer())


def test_flash_attention_refuses_autograd_and_bad_s_used():
    """Gradients flow through the attention (to 1e-5 of autodiff through
    the plain forward, f32), and it still runs under no_grad; a decode
    watermark off the 128 grid still raises."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = t_attention.multi_head_attention(q, q, q)
    (g,) = torch.autograd.grad(out.square().sum(), q)
    (g_ref,) = torch.autograd.grad(
        t_attention.mha_reference(q, q, q).square().sum(), q)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    torch.testing.assert_close(g, g_ref, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        assert t_attention.multi_head_attention(q, q, q).shape == q.shape
    q8, pk, ks, pv, vs, bias = (t(x) for x in _decode_inputs(seed=1))
    with pytest.raises(ValueError, match="s_used"):
        t_decode.decode_attention_prompt(q8, pk, ks, pv, vs, bias, 0.1,
                                         s_used=100)
