"""Parity of the port's training path (``opadpo_torch.models`` training
forwards, ``engine.dpo``, ``engine.train_state``) with the JAX package on
the tiny LLaVA in f32, weights and adapter carried across through
``opadpo_torch.bridge``, batches made with numpy from a seed.

Tolerances: logprobs, entropies, hidden states and losses agree to 1e-5
absolute (f32, the same math summed in another order); gradients to 1e-4
relative to their largest entry; the adapter after two AdamW steps to
1e-6 absolute, a thousandth of the learning rate, as Adam's first steps
move each entry by about the learning rate whatever its gradient's size."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.constants import IMAGE_TOKEN_INDEX
from opadpo_tpu.engine import dpo as jax_dpo
from opadpo_tpu.engine import train_state as jax_ts
from opadpo_tpu.models import llama as jax_llama
from opadpo_tpu.models import llava as jax_llava
from opadpo_torch import bridge
from opadpo_torch.engine import dpo as t_dpo
from opadpo_torch.engine import train_state as t_ts
from opadpo_torch.models import llama as t_llama
from opadpo_torch.models import llava as t_llava
from opadpo_torch.models.lora import make_trainable
from tests.torch_parity import (
    JCFG32, assert_trees_close, dpo_batch, grads_as_jax, jax_llama_lora,
    jax_params, t, to_np, torch_model,
)

PARAMS = jax_params()
MODEL = torch_model(PARAMS)
SCALING = 2.0
DPO = jax_dpo.DpoConfig(response_len=8, query_len=6, lora_scaling=SCALING)
T_DPO = t_dpo.DpoConfig(response_len=8, query_len=6, lora_scaling=SCALING)

J_REF, J_POL = jax_llama_lora(1), jax_llama_lora(2)
T_REF = bridge.lora_from_jax(to_np(J_REF), device="cpu")
BATCH = dpo_batch()


def _jnp(tree):
    return {k: jnp.asarray(x) for k, x in tree.items()}


# the JAX side jitted: compiling costs less than running it op by op
_J_ROLLOUT = jax.jit(jax_dpo.rollout_score, static_argnums=(1, 2))
_J_GRAD = jax.jit(jax.value_and_grad(jax_dpo.dpo_loss_and_stats,
                                     has_aux=True), static_argnums=(2, 3))
_J_STEP = jax.jit(jax_dpo.dpo_train_step, static_argnums=(3, 4, 5))


@pytest.fixture(scope="module")
def jax_rollout():
    return _J_ROLLOUT(PARAMS, JCFG32, DPO, J_REF, _jnp(BATCH),
                      jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def full_batch(jax_rollout):
    """The batch with the JAX rollout, numpy, as both packages read it."""
    return {**BATCH, **{k: np.asarray(x) for k, x in jax_rollout.items()}}


def _prefix_inputs(rng, b=2, kk=3, sp=9, sr=7):
    d = JCFG32.llama.hidden_size
    pe = rng.normal(0, 0.5, (b, sp, d)).astype(np.float32)
    re = rng.normal(0, 0.5, (b * kk, sr, d)).astype(np.float32)
    pm = np.ones((b, sp), np.int32)
    pm[1, :3] = 0
    rm = np.ones((b * kk, sr), np.int32)
    rm[:, -2:] = 0
    pp = np.maximum(np.cumsum(pm, 1) - 1, 0).astype(np.int32)
    rp = (pm.sum(1).repeat(kk)[:, None] + np.cumsum(rm, 1) - 1).astype(
        np.int32)
    return pe, pm, pp, re, rm, rp


def test_forward_shared_prefix_hidden_matches_jax():
    """Both streams' final-norm hidden states, with the adapter, 1e-5; and
    ``forward`` (return_hidden) over a plain sequence the same."""
    args = _prefix_inputs(np.random.default_rng(0))
    hp, hr = jax_llama.forward_shared_prefix(
        PARAMS["llama"], JCFG32.llama, *(jnp.asarray(x) for x in args),
        lora=J_REF["llama"], lora_scaling=SCALING)
    pe, pm, pp, re, rm, rp = args
    with torch.no_grad():
        thp, thr = t_llama.forward_shared_prefix(
            MODEL.llama, t(pe), t(pm, torch.int64), t(pp, torch.int64), t(re),
            t(rm, torch.int64), t(rp, torch.int64), lora=T_REF["llama"],
            lora_scaling=SCALING)
        th = t_llama.forward(MODEL.llama, t(pe), t(pm, torch.int64),
                             t(pp, torch.int64), lora=T_REF["llama"],
                             lora_scaling=SCALING, return_hidden=True)
    np.testing.assert_allclose(thp.numpy(), np.asarray(hp), atol=1e-5)
    np.testing.assert_allclose(thr.numpy(), np.asarray(hr), atol=1e-5)
    jh, _ = jax_llama.forward(PARAMS["llama"], JCFG32.llama, jnp.asarray(pe),
                              jnp.asarray(pm), jnp.asarray(pp),
                              lora=J_REF["llama"], lora_scaling=SCALING,
                              return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)


def test_score_responses_shared_matches_stacked():
    """The port's two layouts give the same logprobs and entropies, with a
    CoPO attention mask on the patches: 1e-5."""
    tb = bridge.tensors_from_jax(BATCH, device="cpu")
    resp, rmask = t_dpo._responses(tb)
    img_mask = torch.ones(2, JCFG32.num_patches, dtype=torch.int32)
    img_mask[0, 1] = 0
    outs = []
    for shared in (True, False):
        d = dataclasses.replace(T_DPO, shared_prefix=shared)
        with torch.no_grad():
            outs.append(t_dpo.score_responses(
                MODEL, d, tb["queries"], tb["queries_attention_mask"],
                tb["images"], resp, rmask, lora=T_REF,
                image_key_mask=img_mask, with_entropy=True))
    for key in ("logprobs", "entropies"):
        for a, b_ in zip(outs[0][key], outs[1][key]):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5)


def test_rollout_score_matches_jax(jax_rollout, monkeypatch):
    """Every output key of the rollout, with the JAX rollout's masked
    images fed across for the CoPO forward (the two packages draw from
    different generators): 1e-5."""
    masked = torch.tensor(np.asarray(jax_rollout["masked_images"]))
    monkeypatch.setattr(t_dpo.image_ops, "mask_images_random",
                        lambda g, images, ratio: masked)
    out = t_dpo.rollout_score(MODEL, T_DPO, T_REF,
                              bridge.tensors_from_jax(BATCH, device="cpu"),
                              torch.Generator().manual_seed(0))
    assert set(out) == set(jax_rollout)
    for key, ref in jax_rollout.items():
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref),
                                   atol=1e-5, err_msg=key)


def test_dpo_loss_and_stats_and_grads_match_jax(full_batch):
    """The loss, every stat, and the policy adapter's gradients (decoder
    and lm_head entries), on a model whose RoPE tables were first built
    under inference mode, as a model that served has them."""
    MODEL.llama._rope = None
    with torch.inference_mode():
        MODEL.llama.rope_tables()
    (j_loss, j_stats), j_grads = _J_GRAD(J_POL, PARAMS, JCFG32, DPO,
                                         _jnp(full_batch))
    state = t_ts.TrainState.create(
        make_trainable(bridge.lora_from_jax(to_np(J_POL), device="cpu")),
        t_ts.OptimizerConfig())
    loss, stats, grads = t_dpo.loss_and_grads(
        state, MODEL, T_DPO, bridge.tensors_from_jax(full_batch, "cpu"))
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    assert set(stats) == set(j_stats)
    for key, ref in j_stats.items():
        np.testing.assert_allclose(stats[key].item(), float(ref), atol=1e-5,
                                   err_msg=key)
    assert_trees_close(grads_as_jax(state.params, grads), j_grads,
                        rel=1e-4)


def test_dpo_train_step_two_steps_match_jax(full_batch):
    """Two train steps from the same adapter: the first at lr 0 (warmup)
    leaves it as it was, the second (clipped AdamW at lr 5e-4) moves it;
    the adapter after each and the stats of the second match the JAX
    package's."""
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    tx = jax_ts.make_optimizer(jax_ts.OptimizerConfig(**ocfg))
    j_state = jax_ts.TrainState.create(J_POL, tx)
    opt = t_ts.AdamW(t_ts.OptimizerConfig(**ocfg))
    state = t_ts.TrainState.create(
        make_trainable(bridge.lora_from_jax(to_np(J_POL), device="cpu")),
        opt.cfg)
    tb = bridge.tensors_from_jax(full_batch, "cpu")
    jb = _jnp(full_batch)
    for i in range(2):
        j_state, j_stats = _J_STEP(j_state, PARAMS, jb, tx, JCFG32, DPO)
        state, stats = t_dpo.dpo_train_step(state, MODEL, tb, opt, T_DPO)
        ported = bridge.lora_to_jax(state.params)
        assert_trees_close(ported, to_np(j_state.params), atol=1e-6)
    for key in ("loss/total", "loss/grad_norm"):
        np.testing.assert_allclose(stats[key].item(), float(j_stats[key]),
                                   rtol=1e-4, err_msg=key)
    moved = jax.tree_util.tree_map(lambda a, b_: np.abs(a - b_).max(),
                                   ported, to_np(J_POL))
    assert max(jax.tree_util.tree_leaves(moved)) > 1e-4


@pytest.mark.parametrize("ls,div", [(0.0, "reverse_kl"), (0.1, "reverse_kl"),
                                    (0.1, "js_divergence")])
def test_dpo_loss_formulas_match_jax(ls, div):
    """Sigmoid DPO with score weights, label smoothing and the JS variant,
    against the JAX package's ``dpo_loss``: 1e-6."""
    rng = np.random.default_rng(0)
    pc, pr, rc, rr = (rng.normal(size=(3, 5)).astype(np.float32)
                      for _ in range(4))
    cs, rs = (rng.uniform(1.0, 2.5, (3, 5)).astype(np.float32)
              for _ in range(2))
    jd = dataclasses.replace(DPO, label_smoothing=ls, f_divergence_type=div)
    td = dataclasses.replace(T_DPO, label_smoothing=ls, f_divergence_type=div)
    ref = jax_dpo.dpo_loss(*(jnp.asarray(x) for x in (pc, pr, rc, rr)), jd,
                           chosen_scores=jnp.asarray(cs),
                           rejected_scores=jnp.asarray(rs))
    out = t_dpo.dpo_loss(*(t(x) for x in (pc, pr, rc, rr)), td,
                         chosen_scores=t(cs), rejected_scores=t(rs))
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6)


def test_llava_forward_and_init_lora():
    """``llava.forward`` logits against the JAX package's with a CoPO
    patch mask (1e-4, f32 logits of the tiny vocabulary), and the port's
    own adapter init: the JAX shapes in Linear layout, A within its
    Kaiming bound, B zero."""
    rng = np.random.default_rng(5)
    ids = rng.integers(5, JCFG32.llama.vocab_size, (2, 7)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    mask = np.ones((2, 7), np.int32)
    mask[1, 0] = 0
    images = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    pm = np.ones((2, JCFG32.num_patches), np.int32)
    pm[1, 2] = 0
    ref = jax_llava.forward(PARAMS, JCFG32, jnp.asarray(ids),
                            jnp.asarray(mask), jnp.asarray(images),
                            lora=J_REF, lora_scaling=SCALING,
                            image_key_mask=jnp.asarray(pm))
    with torch.no_grad():
        out = t_llava.forward(MODEL, t(ids, torch.int64),
                              t(mask, torch.int64), t(images), lora=T_REF,
                              lora_scaling=SCALING,
                              image_key_mask=t(pm, torch.int64))
    np.testing.assert_array_equal(out["key_mask"].numpy(),
                                  np.asarray(ref["key_mask"]))
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), atol=1e-4)

    from opadpo_torch.models.lora import LoraConfig
    lcfg = LoraConfig(rank=4, alpha=8.0, dtype=torch.float32)
    lora = t_llava.init_lora(MODEL.cfg, lcfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda: jax_llava.init_lora(
        jax.random.PRNGKey(0), JCFG32, jax_llava.LoraConfig(rank=4)))
    ported = bridge.lora_to_jax(lora)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ported):
        ref_leaf = dict(jax.tree_util.tree_leaves_with_path(jshapes))[path]
        assert leaf.shape == ref_leaf.shape, path
    for layer in lora["llama"]["layers"]:
        for name, e in layer.items():
            bound = (3.0 / e["a"].shape[1]) ** 0.5
            assert e["a"].abs().max() <= bound and e["a"].std() > bound / 3
            assert torch.all(e["b"] == 0)
