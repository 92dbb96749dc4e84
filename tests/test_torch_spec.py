"""Parity of the port's speculative decoding (``opadpo_torch.engine.
speculative``, the verify forwards of ``models/llama``) with the JAX
package on the CPU: the acceptance machinery, the drafts, the per-row
compaction, one verify step of each advance against JAX logits, and greedy
generation token for token, on the tiny LLaVA in f32 with the JAX weights
carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.engine import speculative as jax_spec
from opadpo_tpu.engine.sampler import Sampler as JaxSampler
from opadpo_tpu.engine.sampling import SamplingConfig as JaxSampling
from opadpo_tpu.models import llava as jax_llava
from opadpo_torch.engine import speculative as t_spec
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llava as t_llava
from tests.torch_parity import JCFG32, inputs, jax_params, t, torch_model

PARAMS = jax_params()
MODEL = torch_model(PARAMS)
WARP = dict(temperature=0.7, top_k=6, top_p=0.8, eos_token_id=3)


def _logits(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * 2.0


@pytest.mark.parametrize("suppress_eos", [False, True])
def test_warped_topk_dist_matches_jax(suppress_eos):
    logits = _logits(0, (5, 40))
    ref_p, ref_i = jax_spec.warped_topk_dist(
        jnp.asarray(logits), JaxSampling(suppress_eos=suppress_eos, **WARP))
    p, i = t_spec.warped_topk_dist(
        t(logits), SamplingConfig(suppress_eos=suppress_eos, **WARP))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="top_k"):
        t_spec.warped_topk_dist(t(logits), SamplingConfig(top_k=0))


def test_accept_and_correct_matches_jax():
    """Greedy: verdicts and corrections equal JAX's.  Sampled: the
    acceptance probabilities p(d) and the residuals equal JAX's to 1e-6,
    and the first emitted token (the draft if kept, else the residual
    draw) follows the target distribution over 20000 rows to 0.015."""
    b, k, v = 3, 3, 40
    logits = _logits(1, (b, k + 1, v))
    drafts = np.argsort(-logits, axis=-1)[:, :k, 1]       # second choices
    drafts[0, 0] = int(np.argmax(logits[0, 0]))            # one greedy hit
    acc, corr = t_spec._accept_and_correct(
        t(logits), t(drafts, torch.int64), SamplingConfig(greedy=True), None)
    ref_acc, ref_corr = jax_spec._accept_and_correct(
        jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(drafts),
        JaxSampling(greedy=True))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(ref_corr))

    cfg, jcfg = SamplingConfig(**WARP), JaxSampling(**WARP)
    p_d, resid, idx = t_spec.accept_probs(t(logits), t(drafts, torch.int64),
                                          cfg)
    jp, ji = jax_spec.warped_topk_dist(
        jnp.asarray(logits[:, :k].reshape(b * k, v)), jcfg)
    is_d = np.asarray(ji) == drafts.reshape(b * k, 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(
        p_d.numpy(), (np.asarray(jp) * is_d).sum(-1).reshape(b, k),
        atol=1e-6)
    np.testing.assert_allclose(resid.numpy(),
                               np.where(is_d, 0.0, np.asarray(jp)),
                               atol=1e-6)

    n = 20000
    row = np.broadcast_to(logits[1:2, :2], (n, 2, v))
    draft = np.full((n, 1), int(drafts[1, 0]))
    g = torch.Generator().manual_seed(0)
    acc, corr = t_spec._accept_and_correct(t(np.ascontiguousarray(row)),
                                           t(draft, torch.int64), cfg, g)
    first = torch.where(acc[:, 0], t(draft[:, 0], torch.int64), corr[:, 0])
    target, tidx = t_spec.warped_topk_dist(t(logits[1:2, 0]), cfg)
    freq = np.bincount(first.numpy(), minlength=v) / n
    want = np.zeros(v)
    want[tidx[0].numpy()] = target[0].numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)


def test_ngram_drafts_match_jax():
    rng = np.random.default_rng(2)
    out = rng.integers(3, 9, (4, 24)).astype(np.int64)
    out[0, 3:7] = [5, 6, 7, 8]
    out[0, 12:14] = [5, 6]
    e = np.asarray([14, 9, 20, 2])
    last = out[np.arange(4), e - 1]
    for ee in (e, 14):
        lt = last if ee is e else out[:, 13]
        ref = jax_spec._ngram_drafts(jnp.asarray(out, jnp.int32),
                                     jnp.asarray(ee), jnp.asarray(lt), 3, 0)
        got = t_spec._ngram_drafts(t(out), torch.as_tensor(ee), t(lt), 3, 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 not in got[0].tolist()          # row 0's "5 6" occurred before


def test_compact_suffix_pr_matches_jax():
    rng = np.random.default_rng(3)
    raw = [tuple(rng.normal(size=(2, 6, 2, 4)).astype(np.float32)
                 for _ in range(2))]
    settled = [tuple(rng.normal(size=(2, 5, 2, 4)).astype(np.float32)
                     for _ in range(2))]
    tgt = np.asarray([[0, 1, -1, 2, -1, -1], [-1, 4, 3, -1, 0, -1]])
    ref = jax_spec.compact_suffix_pr(
        [tuple(map(jnp.asarray, p)) for p in raw],
        [tuple(map(jnp.asarray, p)) for p in settled], jnp.asarray(tgt))
    got = t_spec.compact_suffix_pr([tuple(map(t, p)) for p in raw],
                                   [tuple(t(x.copy()) for x in p)
                                    for p in settled], t(tgt))
    for pair, ref_pair in zip(got, ref):
        for a, r in zip(pair, ref_pair):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def _prefill(kv8):
    ids, mask, images = inputs()
    up, _ = jax_llava.unstack_for_decode(PARAMS, None)
    ref = jax_llava.prefill_unrolled(
        up, JCFG32, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(images),
        quantize_kv=kv8)
    with torch.inference_mode():
        out = t_llava.prefill_unrolled(
            MODEL, t(ids, torch.int64), t(mask, torch.int64), t(images),
            quantize_kv=kv8)
    return up, ref, out


@pytest.mark.parametrize("kv8", [False, True])
def test_verify_steps_match_jax(kv8):
    """One verify group of G = 3 through ``decode_step_multi`` (shared
    advance, after two groups' rows) and ``decode_step_multi_pr`` (raw rows
    accepted per row, a settled watermark per row) against JAX's: logits to
    1e-4 of their largest entry (the kv8 prompt piece is #8's plain version
    against the interpret-mode kernel) and the suffix rows it writes."""
    up, ref_pf, pf = _prefill(kv8)
    kv_j, kv_t = list(ref_pf["kv_list"]), pf["kv_list"]
    toks = np.asarray([[7, 11, 23], [9, 5, 31]])
    rng = np.random.default_rng(4)
    fill = [tuple(rng.normal(0, 0.5, (2, 12, 2, 64)).astype(np.float32)
                  for _ in range(2)) for _ in range(JCFG32.llama.num_layers)]
    pos_j, pos_t = ref_pf["next_position"] + 4, pf["next_position"] + 4
    j_sfx = [tuple(jnp.asarray(x) for x in p) for p in fill]
    t_sfx = [tuple(t(x.copy()) for x in p) for p in fill]
    ref, j_sfx = jax_llava.decode_step_multi(
        up, JCFG32, jnp.asarray(toks), kv_j, ref_pf["key_mask"], j_sfx,
        jnp.int32(4), pos_j)
    with torch.inference_mode():
        out, t_sfx = t_llava.decode_step_multi(
            MODEL, t(toks, torch.int64), kv_t, pf["key_mask"], t_sfx, 4,
            pos_t)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    for pair, ref_pair in zip(t_sfx, j_sfx):
        for a, r in zip(pair, ref_pair):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)

    raw_ok = np.zeros((2, 12), bool)
    raw_ok[0, :4] = raw_ok[1, [0, 1, 4]] = True
    w = np.asarray([3, 1])
    settled = [tuple(rng.normal(0, 0.5, (2, 8, 2, 64)).astype(np.float32)
                     for _ in range(2))
               for _ in range(JCFG32.llama.num_layers)]
    ref, j_raw = jax_llava.decode_step_multi_pr(
        up, JCFG32, jnp.asarray(toks), kv_j, ref_pf["key_mask"],
        [tuple(jnp.asarray(x) for x in p) for p in fill],
        [tuple(jnp.asarray(x) for x in p) for p in settled], jnp.int32(6),
        jnp.asarray(raw_ok), jnp.asarray(w, jnp.int32), pos_j)
    with torch.inference_mode():
        out, t_raw = t_llava.decode_step_multi_pr(
            MODEL, t(toks, torch.int64), kv_t, pf["key_mask"],
            [tuple(t(x.copy()) for x in p) for p in fill],
            [tuple(t(x) for x in p) for p in settled], 6, t(raw_ok),
            t(w, torch.int64), pos_t)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    for pair, ref_pair in zip(t_raw, j_raw):
        for a, r in zip(pair, ref_pair):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("advance,kv8,draft,compact", [
    ("shared", False, "ngram", 32), ("per_row", True, "ngram", 2),
    ("per_row", False, "pad", 3), ("shared", True, "oracle", 32),
    ("per_row", True, "oracle", 2)])
def test_decode_loop_spec_matches_jax(advance, kv8, draft, compact):
    """The loops themselves, greedy, against JAX's ``decode_loop_spec``:
    the same tokens, groups and accepted drafts; per-row across
    compaction boundaries (every 2 or 3 groups), and per-row in segment
    mode (a row done from the start, 5 tokens, the state returned: tokens,
    positions, the next logits and the settled suffix); the shared advance
    refuses segment mode.  The oracle draft reads each row's plain greedy
    tokens, one of them wrong."""
    up, ref_pf, pf = _prefill(kv8)
    n_new = 14
    spec = dict(k=3, draft=draft, advance=advance, compact_every=compact)
    oracle = {}
    if draft == "oracle":
        from opadpo_torch.engine.sampler import decode_loop_unrolled
        with torch.inference_mode():
            plain, _ = decode_loop_unrolled(
                MODEL, pf["kv_list"], pf["key_mask"], pf["next_position"],
                pf["last_logits"], None, SamplingConfig(
                    greedy=True, max_new_tokens=n_new, eos_token_id=-1))
        ora = np.concatenate([plain.numpy(), np.zeros((2, 3), np.int64)], 1)
        ora[0, 5] = (ora[0, 5] + 1) % JCFG32.llama.vocab_size
        oracle = {"jax": dict(oracle_tokens=jnp.asarray(ora, jnp.int32)),
                  "port": dict(oracle_tokens=t(ora))}
    ref, ref_st = jax_spec.decode_loop_spec(
        up, JCFG32, list(ref_pf["kv_list"]), ref_pf["key_mask"],
        ref_pf["next_position"], ref_pf["last_logits"],
        jax.random.PRNGKey(0), JaxSampling(greedy=True,
                                           max_new_tokens=n_new,
                                           eos_token_id=-1),
        jax_spec.SpecConfig(**spec), **oracle.get("jax", {}))
    with torch.inference_mode():
        out, st = t_spec.decode_loop_spec(
            MODEL, pf["kv_list"], pf["key_mask"], pf["next_position"],
            pf["last_logits"], None, SamplingConfig(
                greedy=True, max_new_tokens=n_new, eos_token_id=-1),
            t_spec.SpecConfig(**spec), **oracle.get("port", {}))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert st["groups"] == int(ref_st["groups"])
    assert st["accepted_drafts"] == int(ref_st["accepted_drafts"])
    if draft == "oracle":
        np.testing.assert_array_equal(out.numpy(), plain.numpy())
        assert st["accepted_drafts"] >= st["groups"] > 0
    assert [min(n_new, 1 + sum(a[i] for a in st["advances"]))
            for i in range(2)] == st["row_tokens"]
    if advance == "shared":
        with pytest.raises(ValueError, match="segment mode"):
            t_spec.decode_loop_spec(
                MODEL, pf["kv_list"], pf["key_mask"], pf["next_position"],
                pf["last_logits"], None, SamplingConfig(greedy=True),
                t_spec.SpecConfig(**spec), max_new=4,
                **oracle.get("port", {}))
        return
    # segment mode (the continuous engine's): row 1 starts done, 5 tokens
    # a row, and the state the engine folds, against JAX's segment mode
    done0 = np.asarray([False, True])
    ref, ref_st, ref_stats = jax_spec.decode_loop_spec(
        up, JCFG32, list(ref_pf["kv_list"]), ref_pf["key_mask"],
        ref_pf["next_position"], ref_pf["last_logits"],
        jax.random.PRNGKey(0), JaxSampling(greedy=True, eos_token_id=-1),
        jax_spec.SpecConfig(**spec), done_init=jnp.asarray(done0),
        max_new=5, return_state=True, **oracle.get("jax", {}))
    with torch.inference_mode():
        out, st, state = t_spec.decode_loop_spec(
            MODEL, pf["kv_list"], pf["key_mask"], pf["next_position"],
            pf["last_logits"], None, SamplingConfig(greedy=True,
                                                    eos_token_id=-1),
            t_spec.SpecConfig(**spec), done_init=t(done0), max_new=5,
            return_state=True, **oracle.get("port", {}))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert st["groups"] == int(ref_stats["groups"])
    np.testing.assert_array_equal(state["emitted"].numpy(),
                                  np.asarray(ref_st["emitted"]))
    np.testing.assert_array_equal(state["positions"].numpy(),
                                  np.asarray(ref_st["positions"]))
    np.testing.assert_array_equal(state["done"].numpy(),
                                  np.asarray(ref_st["done"]))
    ref_ll = np.asarray(ref_st["last_logits"])
    np.testing.assert_allclose(state["last_logits"][0].numpy(), ref_ll[0],
                               rtol=0, atol=1e-4 * np.abs(ref_ll).max())
    for pair, ref_pair in zip(state["suffix"], ref_st["suffix"]):
        for a, r in zip(pair, ref_pair):       # the live row's 5 tokens
            np.testing.assert_allclose(a[0, :5].numpy(),
                                       np.asarray(r)[0, :5], atol=1e-4)


@pytest.mark.parametrize("kv_bits,advance", [
    (16, "shared"), (8, "shared"), (16, "per_row"), (8, "per_row")])
def test_sampler_spec_greedy_token_exact(kv_bits, advance):
    """``Sampler(spec_k=3)`` greedy equals the JAX Sampler's output token
    for token, and the plain greedy Sampler's; its stats count the verify
    forwards, groups and accepted drafts JAX's loop reports."""
    ids, mask, images = inputs()
    n_new = 12
    jsamp = JaxSampling(greedy=True, max_new_tokens=n_new, eos_token_id=-1)
    ref = JaxSampler(JCFG32, jsamp, kv_bits=kv_bits, spec_k=3,
                     spec_advance=advance).generate(
        PARAMS, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(images),
        jax.random.PRNGKey(0))
    up, ref_pf, _ = _prefill(kv_bits == 8)
    _, ref_st = jax_spec.decode_loop_spec(
        up, JCFG32, list(ref_pf["kv_list"]), ref_pf["key_mask"],
        ref_pf["next_position"], ref_pf["last_logits"],
        jax.random.PRNGKey(0), jsamp,
        jax_spec.SpecConfig(k=3, advance=advance))
    samp = SamplingConfig(greedy=True, max_new_tokens=n_new, eos_token_id=-1)
    spec = Sampler(samp, kv_bits=kv_bits, spec_k=3, spec_advance=advance)
    with torch.inference_mode():
        args = (MODEL, t(ids, torch.int64), t(mask, torch.int64), t(images))
        out = spec.generate(*args)
        plain = Sampler(samp, kv_bits=kv_bits).generate(*args)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    st = spec.stats[-1]
    assert st["decode_steps"] == st["spec_groups"] == int(ref_st["groups"])
    assert st["accepted_drafts"] == int(ref_st["accepted_drafts"])
