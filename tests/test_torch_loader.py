"""The port's checkpoint loader (``opadpo_torch.models.loader``) and its
safetensors reader and writer, on the CPU at tiny sizes.

- The reader and writer against the ``safetensors`` package, both
  directions, every dtype the loader reads, an empty tensor and a sharded
  index: bitwise.
- HF parity: tiny random ``LlamaForCausalLM`` (MHA, GQA),
  ``CLIPVisionModel`` and ``LlavaForConditionalGeneration`` (both llava-hf
  layouts) loaded through the port, logits / features against HF's in f32
  within 2e-4 (1e-4 for the whole LLaVA), the tolerances of
  ``tests/test_loader_parity.py``.
- Port against JAX on the same directory: ``setup_model`` equals
  ``bridge.llava_from_jax`` of the JAX loader's tree, tensor for tensor
  (dtype and value), in the original-LLaVA layout with the vision tower in
  the directory or in a separate CLIP directory, ``.bin`` and
  ``.safetensors``, at bits 16, 8 and 4.
- ``resize_token_embeddings_with_mean`` against JAX (old rows exact, new
  rows within 1e-6, f32).
- PEFT adapters across packages: an adapter saved by either package loads
  in the other and gives the same log-probabilities within 1e-5 (f32).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as st
import torch

from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.models import loader as jax_loader
from opadpo_tpu.models.lora import LoraConfig as JaxLoraConfig
from opadpo_tpu.ops import quant as jq
from opadpo_torch import bridge
from opadpo_torch.models import clip as t_clip
from opadpo_torch.models import llama as t_llama
from opadpo_torch.models import llava as t_llava
from opadpo_torch.models import loader
from opadpo_torch.models import safetensors_io as sio
from opadpo_torch.models.lora import LoraConfig
from opadpo_torch.pipeline import runtime
from tests.torch_parity import (
    JCFG32, TCFG32, inputs, jax_llama_lora, jax_params, t, to_np,
)

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8,
          torch.int32, torch.int64, torch.bool]


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        full = torch.randn(3, 5, generator=g).to(dtype)
    elif dtype == torch.bool:
        full = torch.rand(4, 2, generator=g) > 0.5
    else:
        full = torch.randint(-100, 100, (2, 7), generator=g).to(dtype)
    return {"full": full, "scalar": full.reshape(-1)[0].clone(),
            "empty": torch.empty(0, 4, dtype=dtype),
            "odd": full.reshape(-1)[1:].clone()}


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("direction", ["package_to_port", "port_to_package"])
def test_safetensors_matches_package(tmp_path, dtype, direction):
    """Bitwise, both directions; a misaligned tensor ("odd" after a
    one-element one) and an empty one included."""
    tensors = {**_tensors(dtype), "pad": torch.ones(1, dtype=torch.int8)}
    path = str(tmp_path / "x.safetensors")
    if direction == "package_to_port":
        st.save_file(tensors, path, metadata={"format": "pt"})
        _equal(sio.load_file(path), tensors)
    else:
        sio.save_file(tensors, path, metadata={"format": "pt"})
        _equal(st.load_file(path), tensors)
        with st.safe_open(path, "pt") as f:
            assert f.metadata() == {"format": "pt"}


def test_safetensors_sharded_index(tmp_path):
    """A sharded directory (shards written by the package, HF's index
    naming) reads every tensor of the shards its ``weight_map`` names,
    and no other file; without an index every ``*.safetensors`` file."""
    tensors = {f"w{i}": torch.randn(64, 16).to(torch.bfloat16)
               for i in range(5)}
    shards = {"model-00001-of-00002.safetensors": ["w0", "w1", "w2"],
              "model-00002-of-00002.safetensors": ["w3", "w4"]}
    for f, names in shards.items():
        st.save_file({n: tensors[n] for n in names}, str(tmp_path / f))
    st.save_file({"stale": tensors["w0"]}, str(tmp_path / "old.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": 0}, "weight_map": {
            n: f for f, names in shards.items() for n in names}}))
    _equal(sio.load_dir(str(tmp_path)), tensors)
    os.remove(tmp_path / "model.safetensors.index.json")
    _equal(sio.load_dir(str(tmp_path)), {**tensors, "stale": tensors["w0"]})


# ---------------------------------------------------------------------------
# HF parity
# ---------------------------------------------------------------------------

def _hf_llama(gqa: bool):
    from transformers import LlamaConfig as HfLlamaConfig
    from transformers import LlamaForCausalLM

    heads, kv, inter, vocab = (4, 2, 224, 256) if gqa else (2, 2, 352, 512)
    hf_cfg = HfLlamaConfig(
        vocab_size=vocab, hidden_size=128, intermediate_size=inter,
        num_hidden_layers=2, num_attention_heads=heads,
        num_key_value_heads=kv, max_position_embeddings=2048,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=False,
        tie_word_embeddings=False)
    torch.manual_seed(1 if gqa else 0)
    cfg = t_llama.LlamaConfig(
        vocab_size=vocab, hidden_size=128, intermediate_size=inter,
        num_layers=2, num_heads=heads, num_kv_heads=kv, head_dim=128 // heads,
        dtype=torch.float32)
    return LlamaForCausalLM(hf_cfg).eval(), cfg


def _empty(module_cls, cfg):
    with torch.device("meta"):
        m = module_cls(cfg)
    return m.to_empty(device="cpu").requires_grad_(False)


@pytest.mark.parametrize("gqa", [False, True], ids=["mha", "gqa"])
def test_llama_matches_hf(tmp_path, gqa):
    hf_model, cfg = _hf_llama(gqa)
    hf_model.save_pretrained(str(tmp_path))
    llama = _empty(t_llama.LlamaModel, cfg)
    loader.llama_params_from_state(llama,
                                   loader.load_state_dict(str(tmp_path)))
    rng = np.random.default_rng(3)
    ids = rng.integers(4, cfg.vocab_size, (2, 14))
    mask = np.ones((2, 14), np.int64)
    mask[0, :3] = 0
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    with torch.no_grad():
        ref = hf_model(input_ids=t(ids), attention_mask=t(mask),
                       position_ids=t(positions)).logits.numpy()
        ours = t_llama.forward(llama, t_llama.embed_tokens(llama, t(ids)),
                               t(mask), t(positions), remat=False).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(ours[valid], ref[valid], atol=2e-4,
                               rtol=2e-4)


def _hf_clip_config():
    from transformers import CLIPVisionConfig as HfClipConfig

    return HfClipConfig(hidden_size=64, intermediate_size=128,
                        num_hidden_layers=3, num_attention_heads=2,
                        image_size=28, patch_size=14,
                        hidden_act="quick_gelu", layer_norm_eps=1e-5)


def test_clip_matches_hf(tmp_path):
    """Layer -2 features without CLS; the checkpoint's last layer and
    post_layernorm are in the file and skipped."""
    from transformers import CLIPVisionModel

    torch.manual_seed(0)
    hf_model = CLIPVisionModel(_hf_clip_config()).eval()
    hf_model.save_pretrained(str(tmp_path))
    state = loader.load_state_dict(str(tmp_path))
    assert "vision_model.encoder.layers.2.mlp.fc1.weight" in state
    assert "vision_model.post_layernorm.weight" in state
    tower = _empty(t_clip.ClipVisionTower, TCFG32.vision)
    loader.clip_params_from_state(tower, state)
    imgs = np.random.default_rng(1).normal(size=(2, 28, 28, 3)).astype(
        np.float32)
    with torch.no_grad():
        hf = hf_model(pixel_values=t(imgs.transpose(0, 3, 1, 2)),
                      output_hidden_states=True)
        ref = hf.hidden_states[-2][:, 1:, :].numpy()
        ours = tower(t(imgs)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("layout", ["transformers_4_52", "legacy"])
def test_llava_matches_hf(tmp_path, layout):
    """The whole assembly against ``LlavaForConditionalGeneration``,
    loaded from either llava-hf layout by ``load_llava_checkpoint``: the
    spliced sequence's logits over a ragged left-padded batch (HF expands
    the image token to the patches, the port splices at one marker)."""
    from transformers import LlamaConfig as HfLlamaConfig
    from transformers import LlavaConfig as HfLlavaConfig
    from transformers import LlavaForConditionalGeneration

    from opadpo_torch.constants import IMAGE_TOKEN_INDEX

    txt = HfLlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=352,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=False)
    image_token = 500
    torch.manual_seed(0)
    hf_model = LlavaForConditionalGeneration(HfLlavaConfig(
        vision_config=_hf_clip_config(), text_config=txt,
        image_token_index=image_token, projector_hidden_act="gelu",
        vision_feature_select_strategy="default",
        vision_feature_layer=-2)).eval()
    state = hf_model.state_dict()
    assert any(k.startswith("model.language_model.") for k in state)
    if layout == "legacy":
        hf_model.save_pretrained(str(tmp_path))     # writes the legacy names
        assert "language_model.lm_head.weight" in \
            sio.load_dir(str(tmp_path))
    else:
        sio.save_file({k: v.contiguous() for k, v in state.items()},
                      str(tmp_path / "model.safetensors"))
    model = loader.load_llava_checkpoint(str(tmp_path), TCFG32,
                                         device="cpu")

    rng = np.random.default_rng(2)
    b, l, p = 3, 16, TCFG32.num_patches
    pads, markers = [0, 3, 5], [1, 4, 7]
    ids = rng.integers(4, 500, (b, l))
    mask = np.ones((b, l), np.int64)
    for i in range(b):
        ids[i, :pads[i]] = 0
        mask[i, :pads[i]] = 0
        ids[i, markers[i]] = IMAGE_TOKEN_INDEX
    ids_hf = np.stack([np.concatenate([ids[i, :q], [image_token] * p,
                                       ids[i, q + 1:]])
                       for i, q in enumerate(markers)])
    mask_hf = np.stack([np.concatenate([mask[i, :q], [1] * p,
                                        mask[i, q + 1:]])
                        for i, q in enumerate(markers)])
    positions = np.maximum(np.cumsum(mask_hf, axis=1) - 1, 0)
    imgs = rng.normal(size=(b, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        ref = hf_model(input_ids=t(ids_hf), attention_mask=t(mask_hf),
                       position_ids=t(positions),
                       pixel_values=t(imgs.transpose(0, 3, 1, 2))
                       ).logits.numpy()
        out = t_llava.forward(model, t(ids), t(mask), t(imgs), remat=False)
    np.testing.assert_array_equal(out["key_mask"].numpy(), mask_hf)
    valid = mask_hf.astype(bool)
    np.testing.assert_allclose(out["logits"].numpy()[valid], ref[valid],
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The port against the JAX loader on the same directory
# ---------------------------------------------------------------------------

TCFG16 = t_llava.LlavaConfig.tiny()
JCFG16 = jax_llava.LlavaConfig.tiny()


def _write_checkpoint(root, fmt: str, vision_in_dir: bool, seed: int = 0):
    """A tiny original-LLaVA checkpoint in f16 (as LLaVA-1.5 ships) from
    JAX random weights -> (model_dir, vision_dir or None).  The CLIP
    checkpoint holds one layer above the selected one and post_layernorm,
    which both loaders skip."""
    model = bridge.llava_from_jax(to_np(jax_params(seed)), TCFG32,
                                  device="cpu")
    extra_prefix = (loader.VISION_IN_DIR if vision_in_dir
                    else "vision_model.")
    g = torch.Generator().manual_seed(seed + 7)
    extra = {}
    for name, w in loader.clip_state_dict(model.vision, "x.").items():
        if name.startswith("x.encoder.layers.0."):
            top = TCFG32.vision.num_layers - 1
            extra[name.replace("x.encoder.layers.0.", f"{extra_prefix}"
                               f"encoder.layers.{top}.")] = torch.randn(
                w.shape, generator=g)
    extra[extra_prefix + "post_layernorm.weight"] = torch.randn(64,
                                                                generator=g)
    extra[extra_prefix + "post_layernorm.bias"] = torch.randn(64, generator=g)

    state = dict(loader.llava_state_dict(model, vision_in_dir))
    vision = None if vision_in_dir else loader.clip_state_dict(model.vision)
    if vision_in_dir:
        state.update(extra)
    else:
        vision.update(extra)
    model_dir, vision_dir = root / "llava", root / "clip"

    def write(d, tensors, name):
        d.mkdir()
        half = {k: v.detach().to(torch.float16).contiguous()
                for k, v in tensors.items()}
        if fmt == "bin":
            torch.save(half, str(d / f"{name}.bin"))
            torch.save({"lr": 1.0}, str(d / "training_arguments.bin"))
        else:
            sio.save_file(half, str(d / f"{name}.safetensors"))

    write(model_dir, state, "pytorch_model" if fmt == "bin" else "model")
    if not vision_in_dir:
        write(vision_dir, vision, "pytorch_model" if fmt == "bin"
              else "model")
    return str(model_dir), (None if vision_in_dir else str(vision_dir))


def _state(model):
    return {k: v for k, v in model.state_dict().items()}


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("vision_in_dir", [True, False],
                         ids=["vision_in_dir", "vision_dir"])
def test_setup_model_matches_jax_loader(tmp_path, monkeypatch, bits, fmt,
                                        vision_in_dir):
    """``setup_model(model_dir, vision_dir=...)`` equals the JAX loader's
    tree (quantized by the JAX ``quantize_params`` at bits 8 / 4) carried
    across by ``bridge.llava_from_jax``: every tensor, bitwise, in the
    same dtype."""
    model_dir, vision_dir = _write_checkpoint(tmp_path, fmt, vision_in_dir)
    monkeypatch.setattr(runtime, "llava_config_from_hf",
                        lambda _: TCFG16)
    cfg, model, _ = runtime.setup_model(model_dir, vision_dir=vision_dir,
                                        bits=bits, device="cpu")
    jparams = jax_loader.load_llava_checkpoint(model_dir, JCFG16,
                                               vision_dir=vision_dir)
    if bits != 16:
        jparams = jq.quantize_params(jparams, bits=bits)
    ref = bridge.llava_from_jax(to_np(jparams), TCFG16, device="cpu")
    got, want = _state(model), _state(ref)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert not any(p.requires_grad for p in model.parameters())


def test_load_reports_missing_parts(tmp_path):
    model_dir, _ = _write_checkpoint(tmp_path, "safetensors", False)
    with pytest.raises(KeyError, match="vision_dir"):
        loader.load_llava_checkpoint(model_dir, TCFG16, device="cpu")
    state = sio.load_dir(model_dir)
    (tmp_path / "no_projector").mkdir()
    sio.save_file({k: v for k, v in state.items()
                   if "mm_projector" not in k},
                  str(tmp_path / "no_projector" / "model.safetensors"))
    with pytest.raises(KeyError, match="mm_projector"):
        loader.load_llava_checkpoint(str(tmp_path / "no_projector"), TCFG16,
                                     device="cpu")


def test_save_llava_checkpoint_roundtrip(tmp_path):
    """The port's writer (two ``.bin`` shards, index, ``config.json``)
    reads back through ``setup_model`` bitwise, and ``config.json``
    gives the model's configuration back."""
    model = bridge.llava_from_jax(to_np(jax_params(3)), TCFG16,
                                  device="cpu")
    files = loader.save_llava_checkpoint(model, str(tmp_path / "m"),
                                         num_shards=2, vision_in_dir=True)
    assert len(files) == 2
    index = json.load(open(tmp_path / "m" / "pytorch_model.bin.index.json"))
    assert set(index["weight_map"].values()) == set(files)
    hf_cfg = runtime.llava_config_from_hf(str(tmp_path / "m"))
    assert hf_cfg.llama == TCFG16.llama
    back = _state(loader.load_llava_checkpoint(str(tmp_path / "m"), TCFG16,
                                               device="cpu"))
    for k, v in _state(model).items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_resize_token_embeddings_with_mean_matches_jax():
    params = jax_params(5)
    model = bridge.llava_from_jax(to_np(params), TCFG32, device="cpu")
    v = TCFG32.llama.vocab_size
    loader.resize_token_embeddings_with_mean(model, v + 3)
    ref = jax_loader.resize_token_embeddings_with_mean(params, v + 3)
    embed, head = model.llama.embed.numpy(), \
        model.llama.lm_head.weight.numpy()
    j_embed = np.asarray(ref["llama"]["embed"])
    j_head = np.asarray(ref["llama"]["lm_head"]).T
    assert embed.shape == j_embed.shape == (v + 3, 128)
    assert head.shape == j_head.shape
    np.testing.assert_array_equal(embed[:v], j_embed[:v])
    np.testing.assert_array_equal(head[:v], j_head[:v])
    np.testing.assert_allclose(embed[v:], j_embed[v:], atol=1e-6, rtol=0)
    np.testing.assert_allclose(head[v:], j_head[v:], atol=1e-6, rtol=0)
    assert model.cfg.llama.vocab_size == v + 3
    before = model.llama.embed
    loader.resize_token_embeddings_with_mean(model, v)
    assert model.llama.embed is before


# ---------------------------------------------------------------------------
# PEFT adapters across packages
# ---------------------------------------------------------------------------

PARAMS = jax_params()
MODEL = bridge.llava_from_jax(to_np(PARAMS), TCFG32, device="cpu")


def _logprobs_port(lora, scaling):
    ids, mask, imgs = inputs()
    with torch.no_grad():
        out = t_llava.forward(MODEL, t(ids, torch.int64), t(mask), t(imgs),
                              lora=lora, lora_scaling=scaling, remat=False)
    return torch.log_softmax(out["logits"], -1).numpy()


def _logprobs_jax(lora, scaling):
    ids, mask, imgs = inputs()
    out = jax_llava.forward(PARAMS, JCFG32, jnp.asarray(ids),
                            jnp.asarray(mask), jnp.asarray(imgs), lora=lora,
                            lora_scaling=scaling, remat=False,
                            attn_impl="xla")
    return np.asarray(jax.nn.log_softmax(out["logits"], -1))


def _layers_only(jlora):
    return {"llama": {"layers": jlora["llama"]["layers"]}}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_peft_adapter_across_packages(tmp_path, writer):
    """The same directory contract (file names, ``adapter_config.json``,
    state names); an adapter written by one package loads in the other
    (f32) and gives the same log-probabilities, 1e-5."""
    jlora = _layers_only(jax_llama_lora(4))
    scaling = 2.0
    jcfg = JaxLoraConfig(rank=4, alpha=8.0, dtype=jnp.float32)
    tcfg = LoraConfig(rank=4, alpha=8.0, dtype=torch.float32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_loader.save_peft_adapter(jlora, jdir, jcfg)
    loader.save_peft_adapter(bridge.lora_from_jax(to_np(jlora), "cpu"),
                             tdir, tcfg)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert json.load(open(os.path.join(jdir, "adapter_config.json"))) == \
        json.load(open(os.path.join(tdir, "adapter_config.json")))
    assert loader.adapter_scaling(tdir) == scaling
    jstate = torch.load(os.path.join(jdir, "adapter_model.bin"))
    tstate = torch.load(os.path.join(tdir, "adapter_model.bin"))
    assert set(jstate) == set(tstate)
    for k in jstate:
        assert torch.equal(jstate[k], tstate[k]), k

    src = jdir if writer == "jax" else tdir
    port_lora = loader.load_peft_adapter(src, TCFG32.llama,
                                         dtype=torch.float32, device="cpu")
    jax_lora = jax_loader.load_peft_adapter(src, JCFG32.llama,
                                            dtype=jnp.float32)
    ref = _logprobs_jax(jlora, scaling)
    np.testing.assert_allclose(_logprobs_port(port_lora, scaling), ref,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_logprobs_jax(jax_lora, scaling), ref,
                               atol=1e-5, rtol=0)


def test_peft_adapter_skips_other_modules_and_casts():
    """Only the decoder's seven projections are read; factors are cast to
    the asked dtype, in PEFT's own [r, in] / [out, r] layout."""
    g = torch.Generator().manual_seed(0)
    state = {
        "base_model.model.model.layers.1.self_attn.q_proj.lora_A.weight":
            torch.randn(4, 128, generator=g),
        "base_model.model.model.layers.1.self_attn.q_proj.lora_B.weight":
            torch.randn(128, 4, generator=g),
        "base_model.model.model.vision_tower.vision_tower.vision_model."
        "encoder.layers.0.self_attn.q_proj.lora_A.weight":
            torch.randn(4, 64, generator=g),
        "base_model.model.lm_head.lora_A.weight": torch.randn(4, 128),
    }
    lora = loader.lora_from_peft_state(state, TCFG32.llama, device="cpu")
    assert lora["llama"]["layers"][0] == {}
    entry = lora["llama"]["layers"][1]["wq"]
    assert entry["a"].dtype == torch.bfloat16
    assert torch.equal(entry["b"], state[
        "base_model.model.model.layers.1.self_attn.q_proj.lora_B.weight"
    ].to(torch.bfloat16))
    back = loader.lora_to_peft_state(lora)
    assert set(back) == {k for k in state if ".layers.1." in k
                         and "vision" not in k}
