"""Parity of the port's QLoRA paths with the JAX package on the tiny LLaVA
in f32: an int8 and an int4 base (``opadpo_tpu.ops.quant.quantize_params``,
carried across through ``opadpo_torch.bridge``) under an f32 adapter,
through ``rollout_score``, one ``dpo_train_step`` and greedy generation
with a quantized decode head; and the port's own quantized set-up
(``init_params_quantized``, ``pipeline.runtime.setup_model``).

Tolerances as in ``test_torch_train``: logprobs, entropies, losses and
stats 1e-5 absolute; gradients 1e-4 relative to their largest entry; the
adapter after one AdamW step 1e-6 absolute against optax's step from the
same gradients; greedy tokens exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.engine import dpo as jax_dpo
from opadpo_tpu.engine import train_state as jax_ts
from opadpo_tpu.engine.sampler import Sampler as JaxSampler
from opadpo_tpu.engine.sampling import SamplingConfig as JaxSampling
from opadpo_tpu.ops import quant as jq
from opadpo_torch import bridge
from opadpo_torch.engine import dpo as t_dpo
from opadpo_torch.engine import train_state as t_ts
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llava as t_llava
from opadpo_torch.models.lora import make_trainable
from opadpo_torch.ops import quant as tq
from opadpo_torch.pipeline import runtime
from tests.torch_parity import (
    JCFG32, TCFG32, assert_trees_close, dpo_batch, grads_as_jax, inputs,
    jax_llama_lora, jax_params, t, to_np,
)

PARAMS = jax_params()
QPARAMS = {bits: jq.quantize_params(PARAMS, bits=bits) for bits in (8, 4)}
MODELS = {bits: bridge.llava_from_jax(to_np(p), TCFG32, device="cpu")
          for bits, p in QPARAMS.items()}
SCALING = 2.0
DPO = jax_dpo.DpoConfig(response_len=8, query_len=6, lora_scaling=SCALING)
T_DPO = t_dpo.DpoConfig(response_len=8, query_len=6, lora_scaling=SCALING)
J_REF, J_POL = jax_llama_lora(1), jax_llama_lora(2)
T_REF = bridge.lora_from_jax(to_np(J_REF), device="cpu")
BATCH = dpo_batch()
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10)

_J_ROLLOUT = jax.jit(jax_dpo.rollout_score, static_argnums=(1, 2))
_J_GRAD = jax.jit(jax.value_and_grad(jax_dpo.dpo_loss_and_stats,
                                     has_aux=True), static_argnums=(2, 3))


def _jnp(tree):
    return {k: jnp.asarray(x) for k, x in tree.items()}


@pytest.fixture(scope="module")
def jax_rollouts():
    return {bits: _J_ROLLOUT(p, JCFG32, DPO, J_REF, _jnp(BATCH),
                             jax.random.PRNGKey(3))
            for bits, p in QPARAMS.items()}


def test_bridge_makes_quantized_linears():
    """Every decoder and vision block linear crosses over quantized, int4
    where the JAX leaf is int4, with the JAX codes transposed."""
    for bits, model in MODELS.items():
        lins = [m for _, _, m in tq.quantizable_linears(model)]
        assert lins and all(isinstance(m, tq.QuantLinear) for m in lins)
        jw = QPARAMS[bits]["llama"]["layers"]["wq"]
        got = model.llama.layers[1].wq
        key = "q4" if bits == 4 else "q"
        assert got.bits == bits
        np.testing.assert_array_equal(got.q.numpy(),
                                      np.asarray(jw[key][1]).T)
        assert isinstance(model.llama.lm_head, torch.nn.Linear)
        assert isinstance(model.projector.fc1, torch.nn.Linear)


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_rollout_score_matches_jax(bits, jax_rollouts, monkeypatch):
    """Every rollout output on the quantized base, the JAX rollout's
    masked images fed across for the CoPO forward: 1e-5."""
    ref = jax_rollouts[bits]
    masked = torch.tensor(np.asarray(ref["masked_images"]))
    monkeypatch.setattr(t_dpo.image_ops, "mask_images_random",
                        lambda g, images, ratio: masked)
    out = t_dpo.rollout_score(MODELS[bits], T_DPO, T_REF,
                              bridge.tensors_from_jax(BATCH, device="cpu"),
                              torch.Generator().manual_seed(0))
    assert set(out) == set(ref)
    for key, val in ref.items():
        np.testing.assert_allclose(out[key].numpy(), np.asarray(val),
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_dpo_train_step_matches_jax(bits, jax_rollouts):
    """One ``dpo_train_step`` on the quantized base (dx through the frozen
    int8 / int4 weights into the adapter): the loss, every stat, the
    adapter's gradients and the adapter after the AdamW step, against the
    JAX package's loss and gradients, and optax's update from the same
    gradients."""
    full = {**BATCH, **{k: np.asarray(x) for k, x in
                        jax_rollouts[bits].items()}}
    (j_loss, j_stats), j_grads = _J_GRAD(J_POL, QPARAMS[bits], JCFG32, DPO,
                                         _jnp(full))
    opt = t_ts.AdamW(t_ts.OptimizerConfig(**OPT))
    state = t_ts.TrainState.create(
        make_trainable(bridge.lora_from_jax(to_np(J_POL), device="cpu")),
        opt.cfg)
    tb = bridge.tensors_from_jax(full, "cpu")
    _, _, grads = t_dpo.loss_and_grads(state, MODELS[bits], T_DPO, tb)
    t_grads = grads_as_jax(state.params, grads)
    assert_trees_close(t_grads, j_grads, rel=1e-4)
    # optax's update from the port's gradients: Adam's first step is about
    # lr * sign(g), so gradients that agree to 1e-4 can still move entries
    # whose gradient is near zero by different amounts
    tx = jax_ts.make_optimizer(jax_ts.OptimizerConfig(**OPT))
    j_state = jax_ts.TrainState.create(J_POL, tx).apply_gradients(
        tx, jax.tree_util.tree_map(jnp.asarray, t_grads))
    state, stats = t_dpo.dpo_train_step(state, MODELS[bits], tb, opt, T_DPO)
    np.testing.assert_allclose(stats["loss/total"].item(), float(j_loss),
                               atol=1e-5)
    assert set(stats) == set(j_stats) | {"loss/total", "loss/grad_norm"}
    for key, val in j_stats.items():
        np.testing.assert_allclose(stats[key].item(), float(val), atol=1e-5,
                                   err_msg=key)
    assert_trees_close(bridge.lora_to_jax(state.params),
                       to_np(j_state.params), atol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_greedy_with_quantized_head_token_exact(bits):
    """Greedy generation on the quantized base with an int8 / int4 decode
    head (``head_bits``), int8 prompt KV, against the JAX ``Sampler``:
    tokens exact; the head is quantized once per model."""
    ids, mask, images = inputs()
    n_new = 6
    ref = JaxSampler(JCFG32, JaxSampling(greedy=True, max_new_tokens=n_new,
                                         eos_token_id=-1),
                     kv_bits=8, head_bits=bits).generate(
        QPARAMS[bits], jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(images), jax.random.PRNGKey(0))
    sampler = Sampler(SamplingConfig(greedy=True, max_new_tokens=n_new,
                                     eos_token_id=-1),
                      kv_bits=8, head_bits=bits)
    with torch.inference_mode():
        out = sampler.generate(MODELS[bits], t(ids, torch.int64),
                               t(mask, torch.int64), t(images))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    head = sampler.decode_head(MODELS[bits])
    assert head.bits == bits and sampler.decode_head(MODELS[bits]) is head


@pytest.mark.parametrize("bits", [8, 4])
def test_init_params_quantized_equals_quantize_after_init(bits):
    """Drawing into quantized form layer by layer gives exactly the model
    that quantizing a whole random init gives: every buffer and
    parameter."""
    cfg = t_llava.LlavaConfig.tiny()
    a = t_llava.init_params_quantized(cfg, torch.Generator().manual_seed(5),
                                      bits, "cpu")
    b = tq.quantize_params(t_llava.init_params(
        cfg, torch.Generator().manual_seed(5), "cpu"), bits=bits)
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for key in sa:
        assert sa[key].dtype == sb[key].dtype, key
        assert torch.equal(sa[key], sb[key]), key
    assert not any(p.requires_grad for p in a.parameters())


def test_setup_model_quantizes_once_and_validates(tmp_path):
    """``setup_model(tiny=True, bits=...)`` quantizes the block linears
    once (a second ``quantize_params`` leaves the modules as they are),
    sets the w8a8 switches, and rejects what the JAX package rejects; a
    directory without ``config.json`` is no checkpoint; the HF config
    reader reads ``config.json`` alone."""
    cfg, model, _ = runtime.setup_model(tiny=True, bits=8, act_bits=8,
                                        act_outlier_cols=2,
                                        act_bwd_int8=True, device="cpu")
    lins = [m for _, _, m in tq.quantizable_linears(model)]
    assert all(isinstance(m, tq.QuantLinear) and m.q.dtype == torch.int8
               for m in lins)
    assert {m.mode for m in lins} == {tq.QuantMode(8, 2, True)}
    tq.quantize_params(model, bits=8)
    assert [m for _, _, m in tq.quantizable_linears(model)] == lins
    _, m4, _ = runtime.setup_model(tiny=True, bits=4, device="cpu")
    assert m4.llama.layers[0].wq.bits == 4
    assert m4.llama.layers[0].w_down.bits == 8        # K = 352
    with pytest.raises(ValueError, match="act_bits=8 requires bits=8"):
        runtime.setup_model(tiny=True, bits=4, act_bits=8, device="cpu")
    with pytest.raises(ValueError):
        runtime.setup_model(tiny=True, bits=3, device="cpu")
    with pytest.raises(FileNotFoundError, match="config.json"):
        runtime.setup_model(str(tmp_path), device="cpu")   # not a checkpoint
    (tmp_path / "config.json").write_text(
        '{"hidden_size": 5120, "intermediate_size": 13824, '
        '"num_hidden_layers": 40, "num_attention_heads": 40}')
    assert runtime.llava_config_from_hf(str(tmp_path)) == \
        t_llava.LlavaConfig.llava_13b()


def test_profile_tools_rehearse_quantized_on_cpu(tmp_path):
    """The profiling tools' quantized options on the tiny model on the CPU
    (an int4 base with an int4 decode head; the int8 single-chip training
    recipe), and the quantized kernels' group in their tables."""
    import json

    from opadpo_torch.tools import common, profile_serving, profile_train

    out = tmp_path / "s.json"
    assert profile_serving.main(["--device", "cpu", "--bits", "4",
                                 "--head-bits", "4", "--json",
                                 str(out)]) == 0
    res = json.loads(out.read_text())
    assert (res["bits"], res["head_bits"], res["model"]) == (4, 4, "tiny")
    assert res["phases"]["decode"]["host_ms"] > 0
    out = tmp_path / "t.json"
    assert profile_train.main(["--device", "cpu", "--bits", "8", "--json",
                               str(out)]) == 0
    res = json.loads(out.read_text())
    assert (res["bits"], res["batch"]) == (8, 1)
    assert set(res["phases"]) == {"rollout_score", "dpo_train_step"}
    for name in ("quant_mm_kernel<64, 2>", "splitk_reduce"):
        assert common.kernel_group(name) == "quant_matmul (csrc)"
