"""Parity of the port's stage-3 training path (``models/llava`` with the
vision adapter, spliced labels and CLIP remat; ``engine/sft``) with the
JAX package on the tiny LLaVA in f32, weights and adapter carried across
through ``opadpo_torch.bridge``, batches made with numpy from a seed.

Tolerances, those of ``tests/test_torch_train.py``: spliced labels and
masks exactly; losses and stats to 1e-5 absolute (f32, the same math
summed in another order); gradients to 1e-4 relative to each leaf's
largest entry; the adapter after two AdamW steps to 1e-6 absolute, a
thousandth of the learning rate.  The entropy branch's masks come from
different generators in the two packages, so both packages' mask
functions are patched to return one numpy mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from opadpo_tpu.engine import sft as jax_sft
from opadpo_tpu.engine import train_state as jax_ts
from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.models.lora import LoraConfig as JaxLoraConfig
from opadpo_torch import bridge
from opadpo_torch.engine import sft as t_sft
from opadpo_torch.engine import train_state as t_ts
from opadpo_torch.models import llava as t_llava
from opadpo_torch.models.lora import LoraConfig, make_trainable, named_leaves
from tests.torch_parity import (
    JCFG32, assert_trees_close, grads_as_jax, jax_lora, jax_params, to_np,
    torch_model,
)

PARAMS = jax_params(3)
MODEL = torch_model(PARAMS)
SCALING = 2.0
J_LORA = jax_lora(4)
METHODS = ("random", "blockwise", "attention")


def sft_batch(b=2, lq=6, lr=9, seed=11):
    """Right-padded conversations: a query with one image token, then a
    response whose tokens are labelled; the second row three pads
    shorter."""
    rng = np.random.default_rng(seed)
    v = JCFG32.llama.vocab_size
    length = lq + lr
    ids = rng.integers(5, v, (b, length)).astype(np.int64)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    labels = np.where(np.arange(length)[None] >= lq, ids, IGNORE_INDEX)
    ids[1, -3:] = 0
    labels[1, -3:] = IGNORE_INDEX
    mask = ((ids != 0) | (labels != IGNORE_INDEX)).astype(np.int64)
    sz = JCFG32.vision.image_size
    images = rng.normal(size=(b, sz, sz, 3)).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "attention_mask": mask,
            "images": images}


BATCH = sft_batch()


def _configs(method=None):
    kw = dict(lora_scaling=SCALING)
    if method:
        kw.update(entropy_loss=True, entropy_mask_method=method,
                  entropy_mask_ratio=0.5, entropy_loss_coef=0.7)
    return jax_sft.SftConfig(**kw), t_sft.SftConfig(**kw)


def _patch_masks(monkeypatch, method, seed=2):
    """Both packages' mask draw for ``method`` returns one numpy mask:
    the images with half their pixels (random) or blocks (blockwise) set
    to the image mean, or a patch mask with half the patches off."""
    rng = np.random.default_rng(seed)
    images = BATCH["images"]
    b, h, w, c = images.shape
    mean = images.mean(axis=(1, 2, 3), keepdims=True)
    if method == "random":
        pick = rng.random((b, h, w, 1)) < 0.5
        out = np.where(pick, mean, images).astype(np.float32)
    elif method == "blockwise":
        pick = rng.random((b, h // 14, 1, w // 14, 1, 1)) < 0.5
        pick = np.broadcast_to(pick, (b, h // 14, 14, w // 14, 14, c))
        out = np.where(pick.reshape(b, h, w, c), mean, images).astype(
            np.float32)
    else:
        out = np.ones((b, JCFG32.num_patches), np.int32)
        out[0, 1] = out[1, 0] = out[1, 3] = 0
    name = {"random": "mask_images_random",
            "blockwise": "mask_images_blockwise",
            "attention": "mask_patches_per_row"}[method]
    monkeypatch.setattr(jax_sft.image_ops, name,
                        lambda *a, **k: jnp.asarray(out))
    monkeypatch.setattr(t_sft.image_ops, name,
                        lambda *a, **k: torch.from_numpy(out.copy()))


def _jnp(tree):
    return {k: jnp.asarray(x) for k, x in tree.items()}


def _tb():
    return bridge.tensors_from_jax(BATCH, device="cpu")


def test_forward_returns_jax_spliced_labels():
    """``forward(labels=)``'s spliced labels and key mask equal the JAX
    package's (IGNORE_INDEX on the patches, the right padding kept), and
    the logits agree to 1e-4 with the vision adapter on."""
    ref = jax_llava.forward(PARAMS, JCFG32, jnp.asarray(BATCH["input_ids"]),
                            jnp.asarray(BATCH["attention_mask"]),
                            jnp.asarray(BATCH["images"]), lora=J_LORA,
                            lora_scaling=SCALING,
                            labels=jnp.asarray(BATCH["labels"]))
    tb = _tb()
    with torch.no_grad():
        out = t_llava.forward(MODEL, tb["input_ids"], tb["attention_mask"],
                              tb["images"],
                              lora=bridge.lora_from_jax(to_np(J_LORA), "cpu"),
                              lora_scaling=SCALING, labels=tb["labels"])
    np.testing.assert_array_equal(out["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_array_equal(out["key_mask"].numpy(),
                                  np.asarray(ref["key_mask"]))
    p = JCFG32.num_patches
    assert (out["labels"][:, 1:1 + p] == IGNORE_INDEX).all()
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), atol=1e-4)
    with torch.no_grad():
        plain = t_llava.forward(MODEL, tb["input_ids"], tb["attention_mask"],
                                tb["images"])
    assert plain["labels"] is None


def test_init_lora_with_vision_matches_jax_and_round_trips():
    """``init_lora(include_vision=True)`` has the JAX package's entries and
    shapes (vision blocks, projector, decoder), A within its Kaiming bound
    and B zero; the bridge carries a JAX adapter's vision and projector
    parts across and back exactly."""
    lcfg = LoraConfig(rank=4, alpha=8.0, dtype=torch.float32)
    lora = t_llava.init_lora(MODEL.cfg, lcfg, torch.Generator().manual_seed(0),
                             include_vision=True)
    assert set(lora) == {"llama", "vision", "projector"}
    assert len(lora["vision"]["layers"]) == JCFG32.vision.num_active_layers
    jshapes = jax.eval_shape(lambda: jax_llava.init_lora(
        jax.random.PRNGKey(0), JCFG32, JaxLoraConfig(rank=4),
        include_vision=True))
    ported = bridge.lora_to_jax(lora)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(jshapes))
    flat = jax.tree_util.tree_leaves_with_path(ported)
    assert len(flat) == len(flat_ref)
    for path, leaf in flat:
        assert leaf.shape == flat_ref[path].shape, path
    for path, e in named_leaves(lora):
        if path.endswith("/b"):
            assert torch.all(e == 0), path
        else:
            bound = (3.0 / e.shape[1]) ** 0.5
            assert e.abs().max() <= bound, path
    back = bridge.lora_to_jax(bridge.lora_from_jax(to_np(J_LORA), "cpu"))
    assert_trees_close(back, to_np(J_LORA), atol=0.0)


@pytest.mark.parametrize("method", [None, *METHODS])
def test_sft_loss_stats_and_grads_match_jax(method, monkeypatch):
    """The loss, every stat and the gradients of every adapter entry
    (decoder, lm_head, vision blocks, projector), with the entropy branch
    off and with each masking method."""
    jcfg, tcfg = _configs(method)
    if method:
        _patch_masks(monkeypatch, method)
    grad_fn = jax.jit(jax.value_and_grad(jax_sft.sft_loss, has_aux=True),
                      static_argnums=(2, 3))
    (j_loss, j_stats), j_grads = grad_fn(J_LORA, PARAMS, JCFG32, jcfg,
                                         _jnp(BATCH), jax.random.PRNGKey(0))
    lora = make_trainable(bridge.lora_from_jax(to_np(J_LORA), "cpu"))
    loss, stats = t_sft.sft_loss(lora, MODEL, tcfg, _tb(),
                                 torch.Generator().manual_seed(0))
    leaves = [x for _, x in named_leaves(lora)]
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    assert set(stats) == set(j_stats)
    for key, ref in j_stats.items():
        np.testing.assert_allclose(stats[key].item(), float(ref), atol=1e-5,
                                   err_msg=key)
    ported = grads_as_jax(lora, grads)
    assert set(ported) == {"llama", "vision", "projector"}
    assert_trees_close(ported, j_grads, rel=1e-4)


def test_sft_train_step_two_steps_match_jax():
    """Two train steps from the same adapter, entropy branch off: the
    first at lr 0 (warmup), the second clipped AdamW at lr 5e-4; the
    adapter after each and the second's stats match the JAX package's,
    and the vision and projector parts moved."""
    jcfg, tcfg = _configs()
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    tx = jax_ts.make_optimizer(jax_ts.OptimizerConfig(**ocfg))
    j_state = jax_ts.TrainState.create(J_LORA, tx)
    step = jax.jit(jax_sft.sft_train_step, static_argnums=(3, 4, 5))
    opt = t_ts.AdamW(t_ts.OptimizerConfig(**ocfg))
    state = t_ts.TrainState.create(
        make_trainable(bridge.lora_from_jax(to_np(J_LORA), "cpu")), opt.cfg)
    for _ in range(2):
        j_state, j_stats = step(j_state, PARAMS, _jnp(BATCH), tx, JCFG32,
                                jcfg)
        state, stats = t_sft.sft_train_step(state, MODEL, _tb(), opt, tcfg)
        ported = bridge.lora_to_jax(state.params)
        assert_trees_close(ported, to_np(j_state.params), atol=1e-6)
    for key in ("loss/total", "loss/grad_norm"):
        np.testing.assert_allclose(stats[key].item(), float(j_stats[key]),
                                   rtol=1e-4, err_msg=key)
    for part in ("vision", "projector"):
        moved = jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(),
                                       ported[part], to_np(J_LORA[part]))
        assert max(jax.tree_util.tree_leaves(moved)) > 1e-4, part


def test_clip_remat_gives_the_same_gradients():
    """The CLIP blocks under ``torch.utils.checkpoint`` and not: the same
    features and the same adapter gradients (the recomputation repeats
    the forward exactly on the CPU)."""
    lora = make_trainable(bridge.lora_from_jax(to_np(J_LORA), "cpu"))
    images = _tb()["images"]
    leaves = [x for p, x in named_leaves(lora) if p.startswith("/vision")]
    outs = []
    for remat in (True, False):
        feats = MODEL.vision(images, lora=lora["vision"], lora_scaling=SCALING,
                             remat=remat)
        grads = torch.autograd.grad((feats.square()).sum(), leaves)
        outs.append((feats.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert not images.requires_grad
