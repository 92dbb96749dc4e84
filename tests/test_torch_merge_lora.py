"""The port's ``models/lora.merge_lora`` against the JAX package's
(``opadpo_tpu/models/lora.py``) on the tiny LLaVA in f32, weights and
adapter carried across through ``opadpo_torch.bridge``.

- every merged weight (the decoder's seven linears a layer and the
  lm_head, the vision tower's six a block, the projector's two) against
  the JAX merged tree carried across: 1e-6 absolute in f32; the weights
  without an adapter entry unchanged, bitwise;
- the merged model's forward (no adapter) against the unmerged model's
  forward with the adapter: logits within 1e-5 absolute in f32 (the
  product W x + s B (A x) regrouped as (W + s B A) x; 8.6e-7 here, while
  the adapter moves them by 1.3);
- a bf16 base: the sum taken in f32 and cast back, as JAX does;
- a quantized base under an entry raises and changes nothing, where the
  JAX function returns the quantized leaf unmerged (both pinned).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.models import lora as jax_lora_mod
from opadpo_tpu.ops import quant as jq
from opadpo_torch import bridge
from opadpo_torch.models import llava as t_llava
from opadpo_torch.models.lora import merge_lora
from opadpo_torch.ops.quant import QuantLinear
from tests.torch_parity import (
    inputs, jax_lora, jax_params, t, to_np, torch_model,
)

PARAMS = jax_params()
LORA = jax_lora(seed=3)
SCALING = 2.0
FORWARD_TOL = 1e-5


def _port_lora():
    return bridge.lora_from_jax(to_np(LORA), device="cpu")


def test_merge_lora_matches_jax():
    ref = torch_model(jax_lora_mod.merge_lora(PARAMS, LORA, SCALING))
    base = torch_model(PARAMS)
    model = torch_model(PARAMS)
    assert merge_lora(model, _port_lora(), SCALING) is model
    got, want, before = (m.state_dict() for m in (model, ref, base))
    assert set(got) == set(want)
    changed = 0
    for name, w in got.items():
        np.testing.assert_allclose(w.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
        if not torch.equal(w, before[name]):
            changed += 1
    # decoder 2 x 7 + lm_head, vision blocks x 6, projector 2
    n_vision = len(model.vision.layers)
    assert changed == 2 * 7 + 1 + 6 * n_vision + 2
    for name in ("llama.embed", "vision.patch_embed.weight",
                 "llama.layers.0.attn_norm", "vision.layers.0.wq.bias"):
        assert torch.equal(got[name], before[name]), name


def test_merged_forward_matches_adapter_forward():
    ids, mask, images = inputs()
    base = torch_model(PARAMS)
    with torch.inference_mode():
        want = t_llava.forward(base, t(ids), t(mask), t(images),
                               lora=_port_lora(),
                               lora_scaling=SCALING)["logits"]
        plain = t_llava.forward(base, t(ids), t(mask), t(images))["logits"]
    merge_lora(base, _port_lora(), SCALING)
    with torch.inference_mode():
        got = t_llava.forward(base, t(ids), t(mask), t(images))["logits"]
    # the adapter moves the logits by far more than the bound
    assert float((want - plain).abs().max()) > 100 * FORWARD_TOL
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FORWARD_TOL,
                               rtol=0)


def test_merge_lora_bf16_base_sums_in_f32():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(24, 16)), jnp.bfloat16)      # [in, out]
    entry = {"a": jnp.asarray(rng.normal(0, 0.1, (24, 4)), jnp.float32),
             "b": jnp.asarray(rng.normal(0, 0.1, (4, 16)), jnp.float32)}
    ref = jax_lora_mod.merge_lora({"w": w}, {"w": entry}, SCALING)["w"]
    holder = torch.nn.Module()
    holder.w = torch.nn.Linear(24, 16, bias=False, dtype=torch.bfloat16)
    with torch.no_grad():
        holder.w.weight.copy_(t(np.asarray(w.astype(jnp.float32)).T))
    merge_lora(holder, {"w": {"a": t(np.asarray(entry["a"]).T),
                              "b": t(np.asarray(entry["b"]).T)}}, SCALING)
    assert holder.w.weight.dtype == torch.bfloat16
    merged = holder.w.weight.detach().float().numpy().T
    np.testing.assert_array_equal(merged, np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [8, 4])
def test_merge_lora_quantized_base(bits):
    qparams = jq.quantize_params(PARAMS, bits=bits)
    # the JAX function returns a quantized leaf unmerged ...
    merged = jax_lora_mod.merge_lora(qparams, LORA, SCALING)
    key = "q" if bits == 8 else "q4"
    np.testing.assert_array_equal(
        np.asarray(merged["llama"]["layers"]["wq"][key]),
        np.asarray(qparams["llama"]["layers"]["wq"][key]))
    # ... the port refuses, before changing any weight
    model = bridge.llava_from_jax(to_np(qparams),
                                  torch_model(PARAMS).cfg, device="cpu")
    assert isinstance(model.llama.layers[0].wq, QuantLinear)
    before = copy.deepcopy(model.state_dict())
    with pytest.raises(ValueError, match="quantized"):
        merge_lora(model, _port_lora(), SCALING)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_merge_lora_shape_mismatch_raises():
    model = torch_model(PARAMS)
    lora = _port_lora()
    entry = lora["llama"]["layers"][0]["wq"]
    entry["b"] = entry["b"][:-1]
    with pytest.raises(ValueError, match="against an adapter"):
        merge_lora(model, lora, SCALING)
