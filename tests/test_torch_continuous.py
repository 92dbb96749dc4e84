"""The port's slot-pool engine (``opadpo_torch.engine.continuous``) against
the JAX package's on the CPU, on the tiny LLaVA in f32 with the JAX weights
carried across.

- The per-row folds at arbitrary, distinct offsets against JAX's
  ``fold_suffix_per_row`` / ``fold_suffix_per_row_int4``: every int8 code,
  packed int4 byte, scale and mask entry equal, including an int4 window
  that covers both nibbles of one byte.
- The engine against the JAX ``ContinuousEngine`` (three of them, greedy):
  the int8 pool with staggered admission, a queued request and a budget
  that is not a multiple of ``seg_len``; the int4 pool; speculative
  segments (k 2) with an EOS id.  Tokens equal, and the speculative counts.
- On the port alone: the pool against the port's plain full-forward
  greedy, slot isolation, EOS freeing a slot, grouped admission, the
  watermark, the oracle draft, the pool updated in place, and the
  constructor's refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.constants import IMAGE_TOKEN_INDEX
from opadpo_tpu.engine import continuous as jax_cont
from opadpo_tpu.engine.sampler import Sampler as JaxSampler
from opadpo_tpu.engine.sampling import SamplingConfig as JaxSampling
from opadpo_tpu.models import llama as jax_llama
from opadpo_torch.engine import continuous as t_cont
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.engine.serving_config import (
    ENGINE_GEOMETRY, make_continuous_engine, make_serving_sampling,
)
from opadpo_torch.models import llama as t_llama
from opadpo_torch.models import llava as t_llava
from tests.torch_parity import JCFG32, TCFG32, jax_params, t, torch_model

PARAMS = jax_params()
MODEL = torch_model(PARAMS)
QLEN = 10


def _request(seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, JCFG32.llama.vocab_size, QLEN).astype(np.int64)
    ids[2] = IMAGE_TOKEN_INDEX
    sz = JCFG32.vision.image_size
    return (ids, np.ones(QLEN, np.int64),
            rng.normal(size=(sz, sz, 3)).astype(np.float32))


def _run_all(eng, max_steps=200):
    done = {}
    for _ in range(max_steps):
        if not eng.has_work():
            break
        for rid, toks in eng.step():
            done[rid] = np.asarray(toks)
    assert not eng.has_work()
    return done


def _engine(max_batch, max_new, seg_len, eos=-1, **kw):
    return t_cont.ContinuousEngine(
        MODEL, SamplingConfig(greedy=True, max_new_tokens=max_new,
                              eos_token_id=eos, pad_token_id=0),
        max_batch=max_batch, qlen=QLEN, seg_len=seg_len, **kw)


def _jax_engine(max_batch, max_new, seg_len, eos=-1, kv_bits=8, **kw):
    sampling = JaxSampling(greedy=True, max_new_tokens=max_new,
                           eos_token_id=eos, pad_token_id=0)
    params, _ = JaxSampler(JCFG32, sampling,
                           kv_bits=kv_bits).prepare_params(PARAMS)
    return jax_cont.ContinuousEngine(JCFG32, sampling, params,
                                     max_batch=max_batch, qlen=QLEN,
                                     seg_len=seg_len, kv_bits=kv_bits, **kw)


# -- the folds ----------------------------------------------------------------

def _int8_cache(rng, b, h, s, hd):
    return {"q": rng.integers(-127, 128, (b, h, s, hd)).astype(np.int8),
            "scale": rng.uniform(0.1, 1.0, (b, h, s)).astype(np.float32)}


@pytest.mark.parametrize("row_len,n_valid", [
    ([130, 256], [60, 128]), ([0, 5], [1, 0]), ([383, 200], [1, 77])])
def test_per_row_fold_int8_matches_jax(row_len, n_valid):
    rng = np.random.default_rng(3)
    b, h, s, hd, nseg = 2, 3, 384, 8, 128
    cache = [(_int8_cache(rng, b, h, s, hd), _int8_cache(rng, b, h, s, hd))]
    sfx = [tuple(rng.normal(size=(b, nseg, h, hd)).astype(np.float32)
                 for _ in range(2))]
    pm = (np.arange(s)[None] < np.asarray(row_len)[:, None]).astype(np.int64)
    ref_kv, ref_pm = jax_cont.fold_suffix_per_row(
        [tuple({k: jnp.asarray(v) for k, v in c.items()}
               for c in cache[0])],
        [tuple(jnp.asarray(x) for x in sfx[0])], jnp.asarray(pm, jnp.int32),
        jnp.asarray(row_len, jnp.int32), jnp.asarray(n_valid, jnp.int32))
    kv = [tuple({k: t(v.copy()) for k, v in c.items()} for c in cache[0])]
    pm_t = t(pm.copy())
    ids = [id(kv[0][0]["q"]), id(pm_t)]
    out_kv, out_pm = t_cont.fold_suffix_per_row(
        kv, [tuple(t(x) for x in sfx[0])], pm_t, np.asarray(row_len),
        np.asarray(n_valid))
    assert [id(out_kv[0][0]["q"]), id(out_pm)] == ids      # in place
    np.testing.assert_array_equal(out_pm.numpy(), np.asarray(ref_pm))
    for got, ref in zip(out_kv[0], ref_kv[0]):
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(ref["scale"]))


@pytest.mark.parametrize("row_len,n_valid,nseg", [
    ([157, 300], [33, 70], 128),      # the JAX package's own case
    ([100, 511], [200, 256], 256),    # both nibbles of bytes 100 ... 171
    ([0, 768], [256, 1], 256)])
def test_per_row_fold_int4_matches_jax(row_len, n_valid, nseg):
    rng = np.random.default_rng(5)
    b, h, hd, s_total = 2, 3, 8, 1024
    prompt = rng.normal(size=(b, 300, h, hd)).astype(np.float32)
    pk = jax_llama.quantize_prompt_kv_int4(jnp.asarray(prompt),
                                           total_len=s_total)
    sfx = rng.normal(size=(b, nseg, h, hd)).astype(np.float32)
    pm = (np.arange(s_total)[None]
          < np.asarray(row_len)[:, None]).astype(np.int64)
    ref_kv, ref_pm = jax_cont.fold_suffix_per_row_int4(
        [(dict(pk), dict(pk))], [(jnp.asarray(sfx), jnp.asarray(sfx))],
        jnp.asarray(pm, jnp.int32), jnp.asarray(row_len, jnp.int32),
        jnp.asarray(n_valid, jnp.int32))
    tk = t_llama.quantize_prompt_kv_int4(t(prompt), total_len=s_total)
    np.testing.assert_array_equal(tk["q4"].numpy(), np.asarray(pk["q4"]))
    kv = [({k: v.clone() for k, v in tk.items()},
           {k: v.clone() for k, v in tk.items()})]
    out_kv, out_pm = t_cont.fold_suffix_per_row_int4(
        kv, [(t(sfx), t(sfx))], t(pm.copy()), np.asarray(row_len),
        np.asarray(n_valid))
    np.testing.assert_array_equal(out_pm.numpy(), np.asarray(ref_pm))
    for got, ref in zip(out_kv[0], ref_kv[0]):
        np.testing.assert_array_equal(got["q4"].numpy(),
                                      np.asarray(ref["q4"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(ref["scale"]))
    vals = t_llama.quantize_prompt_kv_int4_values(t(sfx))
    ref_vals = jax_llama.quantize_prompt_kv_int4_values(jnp.asarray(sfx))
    np.testing.assert_array_equal(vals["qv"].numpy(),
                                  np.asarray(ref_vals["qv"]))


# -- the engine against JAX's ----------------------------------------------------

def _staggered(eng, reqs, budgets):
    """The first request runs a segment alone; the rest are added then (the
    last queued behind a full pool)."""
    rids = [eng.add_request(*reqs[0], max_new=budgets[0])]
    first = {rid: np.asarray(toks) for rid, toks in eng.step()}
    rids += [eng.add_request(*r, max_new=b)
             for r, b in zip(reqs[1:], budgets[1:])]
    return rids, {**first, **_run_all(eng)}


@pytest.mark.parametrize("kv_bits,spec_k,eos", [(8, 0, -1), (4, 0, -1),
                                                (8, 2, 85)],
                         ids=["int8", "int4", "spec-k2-eos"])
def test_engine_matches_jax_engine(kv_bits, spec_k, eos):
    """Three requests through 2 slots, seg_len 3, cap 7: the first alone
    for a segment, one at a budget of 5 (not a multiple of seg_len), one
    queued until a slot frees.  Every request's tokens equal the JAX
    engine's; with speculative segments the groups, accepted drafts and
    verify-loop tokens too, and an EOS that ends a request early."""
    reqs = [_request(s) for s in (1, 2, 3)]
    budgets = [None, 5, None]
    jeng = _jax_engine(2, 7, 3, eos=eos, kv_bits=kv_bits, spec_k=spec_k,
                       collect_spec_stats=bool(spec_k))
    jr, jd = _staggered(jeng, reqs, budgets)
    eng = _engine(2, 7, 3, eos=eos, kv_bits=kv_bits, spec_k=spec_k,
                  collect_spec_stats=bool(spec_k))
    tr, td = _staggered(eng, reqs, budgets)
    for i, (a, b) in enumerate(zip(jr, tr)):
        np.testing.assert_array_equal(td[b], np.asarray(jd[a]),
                                      err_msg=f"request {i}")
    assert len(td[tr[1]]) <= 5
    assert eng.spec_stats == {k: int(v) for k, v in jeng.spec_stats.items()}
    if spec_k:
        assert eng.spec_stats["groups"] > 0
        assert any(len(td[r]) < 7 and td[r][-1] == eos for r in tr[::2])
    s = eng.stats
    assert s["tokens"] == sum(len(x) for x in td.values())
    assert s["folds"] == s["segments"] and sum(s["admit_groups"]) == 3
    assert set(s["sp_used"]) == {min(eng.s_total, eng.su_bucket)}


# -- the port alone ------------------------------------------------------------

def _naive_greedy(ids, mask, image, n_new):
    """The port's plain reference: the full forward again at every step,
    argmax."""
    cur, m = t(ids[None]), t(mask[None])
    out = []
    with torch.inference_mode():
        for _ in range(n_new):
            o = t_llava.forward(MODEL, cur, m, t(image[None]), remat=False)
            nxt = int(torch.argmax(o["logits"][0, -1]))
            out.append(nxt)
            cur = torch.cat([cur, torch.tensor([[nxt]])], dim=1)
            m = torch.cat([m, torch.ones(1, 1, dtype=m.dtype)], dim=1)
    return np.asarray(out)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_single_request_matches_plain_greedy(kv_bits):
    """One request through segments and folds (seg_len 2, 6 tokens) equals
    the port's full-forward greedy."""
    r = _request(7)
    eng = _engine(2, 6, 2, kv_bits=kv_bits)
    rid = eng.add_request(*r)
    np.testing.assert_array_equal(_run_all(eng)[rid], _naive_greedy(*r, 6))
    assert eng.stats["segments"] == 3 and eng.stats["forwards"] == 6


def test_slot_isolation_reuse_and_grouped_admission():
    """Five requests into a 4-slot pool: one group of 4, then one of 1 when
    a slot frees; every request equals its solo run, and the pool's
    tensors are the ones the first admission made (updated in place)."""
    reqs = [_request(s) for s in (51, 52, 53, 54, 55)]
    eng = _engine(4, 4, 2)
    rids = [eng.add_request(*r, max_new=3 if i == 0 else None)
            for i, r in enumerate(reqs)]
    assert eng.queue_length == 5
    eng.step()
    assert eng.queue_length == 1
    ptrs = [eng._state[0][0][0]["q"].data_ptr(), eng._state[1].data_ptr()]
    done = _run_all(eng)
    assert [eng._state[0][0][0]["q"].data_ptr(),
            eng._state[1].data_ptr()] == ptrs
    assert eng.stats["admit_groups"] == [4, 1]
    for i, rid in enumerate(rids):
        solo = _engine(1, 4, 2)
        srid = solo.add_request(*reqs[i], max_new=3 if i == 0 else None)
        np.testing.assert_array_equal(done[rid], _run_all(solo)[srid],
                                      err_msg=f"request {i}")


def test_eos_frees_a_slot_for_a_queued_request():
    r, other = _request(31), _request(32)
    probe = _engine(1, 3, 2)
    prid = probe.add_request(*r)
    eos = int(_run_all(probe)[prid][1])
    eng = _engine(1, 5, 2, eos=eos)
    rid1 = eng.add_request(*r)
    rid2 = eng.add_request(*other)
    done = _run_all(eng)
    assert len(done[rid1]) <= 2 and done[rid1][-1] == eos
    assert rid2 in done and eng.stats["admit_groups"] == [1, 1]


def test_watermark_follows_the_longest_active_row():
    """With a 128-position bucket the watermark moves up as the row fills:
    13 spliced prompt positions, then 100 and 200 tokens folded, read to
    128, 128 and 256."""
    eng = _engine(1, 300, 100, su_bucket=128)
    rid = eng.add_request(*_request(9))
    done = _run_all(eng)
    assert len(done[rid]) == 300
    assert eng.stats["sp_used"] == {128: 2, 256: 1}


def test_oracle_draft_accepts_and_keeps_the_tokens():
    """``spec_draft="oracle"`` fed each request's own greedy output accepts
    drafts and leaves the tokens as the plain pool's."""
    reqs = [_request(s) for s in (61, 62)]
    base = _engine(2, 8, 4)
    rb = [base.add_request(*r) for r in reqs]
    done_b = _run_all(base)
    spec = _engine(2, 8, 4, spec_k=2, spec_draft="oracle",
                   collect_spec_stats=True)
    rs = [spec.add_request(*r, oracle_tokens=np.concatenate(
        [done_b[b], np.zeros(2, np.int64)])) for r, b in zip(reqs, rb)]
    done_s = _run_all(spec)
    for b, s in zip(rb, rs):
        np.testing.assert_array_equal(done_b[b], done_s[s])
    st = spec.spec_stats
    assert st["accepted_drafts"] >= st["groups"] > 0, st


def test_make_continuous_engine_and_refusals():
    sampling = make_serving_sampling(max_new_tokens=8, eos_token_id=-1)
    eng = make_continuous_engine(MODEL, sampling, slots=2, qlen=QLEN,
                                 seg_len=4)
    assert (eng.b, eng.qlen, eng.seg_len) == (2, QLEN, 4)
    assert eng.su_bucket == ENGINE_GEOMETRY["su_bucket"]
    assert eng.max_admit_group == ENGINE_GEOMETRY["max_admit_group"]
    assert eng.s_total == 128 and eng.sp_splice == QLEN - 1 + 4
    assert make_continuous_engine(MODEL, sampling, kv_bits=4).s_total == 256
    greedy = SamplingConfig(greedy=True, max_new_tokens=8)
    for kw, match in ((dict(kv_bits=16), "kv_bits"),
                      (dict(max_admit_group=3), "max_admit_group"),
                      (dict(spec_k=2, kv_bits=4), "int8 pool"),
                      (dict(spec_k=8), "spec_k"),
                      (dict(spec_k=2, spec_draft="bigram"), "spec_draft")):
        with pytest.raises(ValueError, match=match):
            t_cont.ContinuousEngine(MODEL, greedy, **kw)
    with pytest.raises(ValueError, match="top_k > 0"):
        t_cont.ContinuousEngine(MODEL, SamplingConfig(temperature=0.7),
                                spec_k=2)
    gqa = t_llava.empty_model(dataclasses.replace(
        TCFG32, llama=dataclasses.replace(TCFG32.llama, num_kv_heads=1)),
        "cpu")
    with pytest.raises(ValueError, match="multi-head"):
        t_cont.ContinuousEngine(gqa, greedy, spec_k=2)


def test_continuous_worker_recovers_from_a_failed_segment(monkeypatch):
    """When a segment raises, every pending request gets an error response
    and the worker rebuilds its engine on the same device, then serves
    the next request as a fresh worker would."""
    from opadpo_torch import serve
    from tests.fake_tokenizer import FakeTokenizer

    worker = serve.ContinuousWorker(MODEL, TCFG32, FakeTokenizer(),
                                    max_batch=2, max_new_tokens=4,
                                    seg_len=2, device="cpu")
    fresh = serve.ContinuousWorker(MODEL, TCFG32, FakeTokenizer(),
                                   max_batch=2, max_new_tokens=4, seg_len=2,
                                   device="cpu")
    first = worker.engine

    def boom():
        raise RuntimeError("segment failed")

    try:
        monkeypatch.setattr(first, "step", boom)
        resp = worker.submit({"prompt": "hello"})
        assert resp == {"error": "segment failed"}
        assert worker.rebuilds == 1 and worker.engine is not first
        assert worker.engine.device == first.device
        req = {"prompt": "what is shown?", "max_new_tokens": 3}
        got, want = worker.submit(req), fresh.submit(req)
        assert "error" not in got and got["text"] == want["text"]
        assert got["new_tokens"] == want["new_tokens"] <= 3
    finally:
        worker.close()
        fresh.close()


def test_fold_refuses_a_window_outside_the_cache():
    """The per-row folds check their windows on the host: on the GPU an
    index past the cache would be a device fault."""
    kv = [tuple({"q": torch.zeros(1, 1, 128, 4, dtype=torch.int8),
                 "scale": torch.zeros(1, 1, 128)} for _ in range(2))]
    sfx = [(torch.zeros(1, 8, 1, 4), torch.zeros(1, 8, 1, 4))]
    pm = torch.zeros(1, 128, dtype=torch.int64)
    for row_len, n in (([125], [4]), ([0], [9]), ([-1], [2])):
        with pytest.raises(ValueError, match="fold window"):
            t_cont.fold_suffix_per_row(kv, sfx, pm, np.asarray(row_len),
                                       np.asarray(n))
    t_cont.fold_suffix_per_row(kv, sfx, pm, np.asarray([120]),
                               np.asarray([8]))
    assert int(pm.sum()) == 8
