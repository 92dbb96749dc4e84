"""Visual-token pruning (``LlavaConfig.visual_tokens``) in the port against
the JAX package, on the tiny LLaVA in f32 (4 patches, 2 kept) with the
JAX weights carried across: the four checks of
``tests/test_visual_tokens.py`` through the JAX functions, a tie case for
the index order, the slot pool at the pruned length and
``setup_model``'s refusal.

Tolerance: features and logits within 1e-5 of the largest reference
entry (f32 on both sides); tokens and selections exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.engine import continuous as jax_cont
from opadpo_tpu.engine.sampler import Sampler as JaxSampler
from opadpo_tpu.engine.sampling import SamplingConfig as JaxSampling
from opadpo_tpu.models import llava as jax_llava
from opadpo_torch import bridge
from opadpo_torch.engine.continuous import ContinuousEngine
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llava as t_llava
from opadpo_torch.pipeline import runtime
from tests.torch_parity import JCFG32, TCFG32, inputs, t, to_np

K = 2
JPRUNED = dataclasses.replace(JCFG32, visual_tokens=K)
TPRUNED = dataclasses.replace(TCFG32, visual_tokens=K)
PARAMS = jax_llava.init_params(jax.random.PRNGKey(0), JCFG32)
MODEL = bridge.llava_from_jax(to_np(PARAMS), TPRUNED, device="cpu")
FULL = bridge.llava_from_jax(to_np(PARAMS), TCFG32, device="cpu")
IDS, MASK, IMAGES = inputs()


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0, err_msg=what)


def test_selection_keeps_top_norm_patches_in_spatial_order():
    """The pruned features are the full features' K patches of largest
    sum of squares, in spatial order, and equal JAX's pruned features."""
    with torch.no_grad():
        full = t_llava.encode_images(FULL, t(IMAGES), remat=False).numpy()
        pruned = t_llava.encode_images(MODEL, t(IMAGES),
                                       remat=False).numpy()
    assert pruned.shape == (full.shape[0], K, full.shape[2])
    score = (full.astype(np.float32) ** 2).sum(-1)
    for i in range(full.shape[0]):
        keep = np.sort(np.argsort(-score[i], kind="stable")[:K])
        np.testing.assert_array_equal(pruned[i], full[i][keep])
    want = jax_llava.encode_images(PARAMS, JPRUNED, jnp.asarray(IMAGES))
    _close(pruned, want, "pruned features against JAX")


@pytest.mark.parametrize("scores,keep", [
    ([1.0, 1.0, 1.0, 1.0], 2), ([0.5, 2.0, 2.0, 2.0], 2),
    ([3.0, 1.0, 3.0, 1.0], 3), ([1.0, 2.0, 1.0, 2.0, 1.0, 2.0], 1)])
def test_ties_go_to_the_lower_patch_index_as_lax_top_k(scores, keep):
    """Patches whose sums of squares tie: the port keeps the same ones as
    ``lax.top_k`` (the lower index first), in spatial order."""
    s = np.asarray(scores, np.float32)
    # each patch a one-hot row scaled so that its sum of squares is s
    proj = (np.eye(len(s), dtype=np.float32) * np.sqrt(s)[:, None])[None]
    got = t_llava.prune_patches(torch.from_numpy(proj), keep).numpy()
    _, idx = jax.lax.top_k(jnp.sum(jnp.square(jnp.asarray(proj)), -1), keep)
    want = np.take_along_axis(proj, np.sort(np.asarray(idx), 1)[..., None],
                              axis=1)
    np.testing.assert_array_equal(got, want)


def test_num_patches_drives_downstream_shapes():
    """The spliced length is L - 1 + K, the logits equal JAX's pruned
    forward's, and K at or above the patch count changes nothing."""
    assert TPRUNED.num_patches == K
    with torch.no_grad():
        out = t_llava.forward(MODEL, t(IDS), t(MASK), t(IMAGES), remat=False)
    assert out["logits"].shape[1] == IDS.shape[1] - 1 + K
    assert out["key_mask"].shape[1] == IDS.shape[1] - 1 + K
    want = jax_llava.forward(PARAMS, JPRUNED, jnp.asarray(IDS),
                             jnp.asarray(MASK), jnp.asarray(IMAGES),
                             remat=False)["logits"]
    _close(out["logits"].numpy(), want, "pruned logits against JAX")
    same = bridge.llava_from_jax(
        to_np(PARAMS), dataclasses.replace(TCFG32, visual_tokens=4), "cpu")
    with torch.no_grad():
        a = t_llava.forward(same, t(IDS), t(MASK), t(IMAGES), remat=False)
        b = t_llava.forward(FULL, t(IDS), t(MASK), t(IMAGES), remat=False)
    assert torch.equal(a["logits"], b["logits"])


def test_pruning_rejects_image_key_mask():
    """A CoPO per-patch mask indexes the full grid: the pruned forward
    refuses it with JAX's error, before the vision tower runs."""
    mask = torch.ones(IMAGES.shape[0], K, dtype=torch.int64)
    calls = []
    hook = MODEL.vision.register_forward_hook(lambda *a: calls.append(1))
    try:
        with pytest.raises(ValueError, match="does not compose"):
            t_llava.forward(MODEL, t(IDS), t(MASK), t(IMAGES),
                            image_key_mask=mask, remat=False)
    finally:
        hook.remove()
    assert calls == []
    with pytest.raises(ValueError, match="does not compose"):
        jax_llava.encode_images(PARAMS, JPRUNED, jnp.asarray(IMAGES),
                                image_key_mask=jnp.asarray(mask.numpy()))
    # the full model takes it
    with torch.no_grad():
        t_llava.forward(FULL, t(IDS), t(MASK), t(IMAGES),
                        image_key_mask=torch.ones(IMAGES.shape[0], 4,
                                                  dtype=torch.int64),
                        remat=False)


@pytest.mark.parametrize("kv", [16, 8])
def test_pruned_sampler_matches_pruned_full_forward(kv):
    """Greedy tokens of the pruned Sampler equal the loop that reruns the
    pruned full forward, and the JAX pruned Sampler's; the prompt is
    L - 1 + K positions long."""
    n_new = 4
    sampling = SamplingConfig(greedy=True, max_new_tokens=n_new,
                              eos_token_id=-1)
    s = Sampler(sampling, kv_bits=kv)
    with torch.inference_mode():
        out = s.generate(MODEL, t(IDS), t(MASK), t(IMAGES)).numpy()
        ids, mask, naive = t(IDS), t(MASK), []
        for _ in range(n_new):
            logits = t_llava.forward(MODEL, ids, mask, t(IMAGES),
                                     remat=False)["logits"]
            nxt = logits[:, -1].argmax(-1)
            naive.append(nxt.numpy())
            ids = torch.cat([ids, nxt[:, None]], 1)
            mask = torch.cat([mask, torch.ones_like(nxt)[:, None]], 1)
    assert s.stats[-1]["prompt_positions"] == IDS.shape[1] - 1 + K
    np.testing.assert_array_equal(out, np.stack(naive, 1))
    want = np.asarray(JaxSampler(JPRUNED, JaxSampling(
        greedy=True, max_new_tokens=n_new, eos_token_id=-1),
        kv_bits=kv).generate(PARAMS, jnp.asarray(IDS), jnp.asarray(MASK),
                             jnp.asarray(IMAGES), jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(out, want)


def test_pool_at_visual_tokens_matches_jax_pool():
    """The slot pool on the pruned model: its prompts spliced at qlen - 1 +
    K, tokens equal to the JAX ``ContinuousEngine`` at the same
    configuration (int8, 2 slots, 3 requests, segments of 2)."""
    qlen = IDS.shape[1]
    reqs = [(IDS[i], MASK[i], IMAGES[i]) for i in range(IDS.shape[0])]
    reqs.append(reqs[0])
    eng = ContinuousEngine(
        MODEL, SamplingConfig(greedy=True, max_new_tokens=5,
                              eos_token_id=-1, pad_token_id=0),
        max_batch=2, qlen=qlen, seg_len=2, kv_bits=8)
    assert eng.sp_splice == qlen - 1 + K
    rids = [eng.add_request(*r) for r in reqs]
    done = {}
    while eng.has_work():
        done.update(eng.step())
    sampling = JaxSampling(greedy=True, max_new_tokens=5, eos_token_id=-1,
                           pad_token_id=0)
    prepped, _ = JaxSampler(JPRUNED, sampling,
                            kv_bits=8).prepare_params(PARAMS)
    jeng = jax_cont.ContinuousEngine(JPRUNED, sampling, prepped,
                                     max_batch=2, qlen=qlen, seg_len=2,
                                     kv_bits=8)
    jrids = [jeng.add_request(*r) for r in reqs]
    jdone = {}
    while jeng.has_work():
        for rid, toks in jeng.step():
            jdone[rid] = np.asarray(toks)
    for r, j in zip(rids, jrids):
        np.testing.assert_array_equal(np.asarray(done[r]), jdone[j])


def test_setup_model_takes_visual_tokens_and_refuses_zero():
    """``setup_model(visual_tokens=K)`` prunes the model it returns (config
    and model alike); K below 1 is refused with the JAX message."""
    cfg, model, _ = runtime.setup_model(tiny=True, device="cpu",
                                        visual_tokens=K)
    assert cfg.num_patches == model.cfg.num_patches == K
    for bad in (0, -3):
        with pytest.raises(ValueError, match="visual_tokens must be >= 1"):
            runtime.setup_model(tiny=True, device="cpu", visual_tokens=bad)
