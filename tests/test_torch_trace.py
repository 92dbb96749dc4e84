"""The spans and the counter inside the port's OPA-DPO step
(``opadpo_torch/utils/trace.py``), on the CPU: nothing is recorded without
a profiler; under one, a tiny step gives the span tree of the score, the
step, its forward, backward, recomputes and AdamW, on Kineto's clock; and
the store empties."""

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.engine import dpo as t_dpo
from opadpo_torch.engine import train_state as t_ts
from opadpo_torch.models import llava as t_llava
from opadpo_torch.models.lora import LoraConfig, make_trainable
from opadpo_torch.pipeline import runtime
from opadpo_torch.utils import trace

torch.set_num_threads(2)

# a vocabulary of three readout chunks (2,000 wide: 2,000, 2,000, 500)
VOCAB, CHUNKS = 4500, 3
_T = t_llava.LlavaConfig.tiny(VOCAB)
CFG = t_llava.LlavaConfig(
    dataclasses.replace(_T.llama, dtype=torch.float32),
    dataclasses.replace(_T.vision, dtype=torch.float32),
    dataclasses.replace(_T.projector, dtype=torch.float32))
LAYERS = CFG.llama.num_layers
DPO = t_dpo.DpoConfig(response_len=8, query_len=6, lora_scaling=2.0)
KEYS = t_dpo.RESPONSE_KEYS


def _batch(b=2, lq=6, r=8, seed=7) -> dict:
    g = torch.Generator().manual_seed(seed)
    queries = torch.randint(5, VOCAB, (b, lq), generator=g)
    queries[:, 1] = IMAGE_TOKEN_INDEX
    q_mask = torch.ones((b, lq), dtype=torch.long)
    q_mask[0, 0] = 0
    size = CFG.vision.image_size
    out = {"queries": queries * q_mask, "queries_attention_mask": q_mask,
           "images": torch.randn((b, size, size, 3), generator=g)}
    for i, key in enumerate(KEYS):
        ids = torch.randint(5, VOCAB, (b, r), generator=g)
        ids[:, r - 2 - i % 2:] = 0
        out[key] = ids
        out[key + "_attention_mask"] = (ids != 0).long()
    scores = torch.rand((b, r), generator=g) * 1.5 + 1.0
    scores = scores * out["AI_pseudo_response_attention_mask"]
    out["AI_pseudo_response_scores"] = scores
    out["original_generate_response_scores"] = scores.flip(0)
    out["AI_pseudo_response_image_relations"] = scores * 0.5 + 0.5
    return out


@pytest.fixture(scope="module")
def traced_step():
    """(snapshot, Kineto's raw events) of one rollout_score and one
    dpo_train_step (remat on) under a CPU profiler."""
    g = torch.Generator().manual_seed(0)
    model = t_llava.init_params(CFG, g, device="cpu")
    lcfg = LoraConfig(rank=4, alpha=8.0, dtype=torch.float32)
    ref = t_llava.init_lora(CFG, lcfg, g)
    pol = t_llava.init_lora(CFG, lcfg, g)
    opt = t_ts.AdamW(t_ts.OptimizerConfig(learning_rate=1e-3,
                                          warmup_steps=0, total_steps=10))
    state = t_ts.TrainState.create(make_trainable(pol), opt.cfg)
    batch = _batch()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = t_dpo.rollout_score(model, DPO, ref, batch,
                                  torch.Generator().manual_seed(3))
        t_dpo.dpo_train_step(state, model, {**batch, **out}, opt, DPO)
    snap = trace.snapshot(clear=True)
    return snap, list(prof.profiler.kineto_results.events())


def test_no_profiler_records_nothing(monkeypatch):
    """Without a profiler a span is the one shared do-nothing context: no
    event is made, nothing is kept, and the rerun wrapper is the function
    itself."""
    def no_event(*a, **k):
        raise AssertionError("a span made a CUDA event")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    trace.clear()
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        with trace.span("b"):
            trace.count("host_syncs")
    fn = lambda x: x            # noqa: E731
    assert trace.rerun_span(fn, "remat.layer") is fn
    assert trace.snapshot() == {"spans": [], "counters": {}}


def _by_name(snap) -> dict:
    out: dict = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_one_step_gives_the_span_tree(traced_step):
    snap, _ = traced_step
    by = _by_name(snap)
    ids = {s["id"]: s for s in snap["spans"]}
    (score,), (step,) = by["dpo.score"], by["dpo.step"]
    assert score["parent"] is None and score["root"] == score["id"]
    assert step["parent"] is None and step["root"] == step["id"]
    assert score["t1_ns"] <= step["t0_ns"]
    for name in ("dpo.forward", "dpo.backward", "adamw.apply"):
        (s,) = by[name]
        assert s["parent"] == step["id"] and s["root"] == step["id"], name
    (fwd,), (bwd,), (opt,) = (by[n] for n in ("dpo.forward", "dpo.backward",
                                              "adamw.apply"))
    assert fwd["t1_ns"] <= bwd["t0_ns"] <= bwd["t1_ns"] <= opt["t0_ns"]
    # the two policy forwards (full, CoPO) recompute each decoder layer
    # and each readout chunk once, inside the backward; the scoring
    # forwards, without gradients, recompute nothing
    assert len(by["remat.layer"]) == 2 * LAYERS
    assert len(by["remat.head"]) == 2 * CHUNKS
    for s in by["remat.layer"] + by["remat.head"]:
        assert s["parent"] == bwd["id"] and s["root"] == step["id"]
        assert bwd["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= bwd["t1_ns"]
    assert all(ids[s["root"]]["name"] != "dpo.score"
               for s in snap["spans"] if s["name"].startswith("remat."))
    # the f32 config's head products on the CPU: a chunk each in the two
    # scoring forwards, the two policy forwards, their recomputes and
    # their backwards
    assert snap["counters"] == {"host_syncs": 1,
                                "head.f32_products": 8 * CHUNKS}
    assert {s["name"] for s in snap["spans"]} == {
        "dpo.score", "dpo.step", "dpo.forward", "dpo.backward",
        "remat.layer", "remat.head", "adamw.apply"}
    assert all(s["device_ms"] is None for s in snap["spans"])


def test_span_stamps_lie_inside_kinetos_own_ranges(traced_step):
    """Each span's host stamps lie inside the profiler's range of the same
    ``record_function``: one clock, Unix-epoch nanoseconds."""
    snap, events = traced_step
    for name, spans in _by_name(snap).items():
        ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                        if e.name() == name)
        spans = sorted(spans, key=lambda s: s["t0_ns"])
        assert len(ranges) == len(spans), name
        for (k0, k1), s in zip(ranges, spans):
            assert k0 <= s["t0_ns"] <= s["t1_ns"] <= k1, name


def test_the_stack_is_one_per_process():
    """A span opened on another thread while the first waits (as the
    autograd engine's device thread runs the backward) nests under the
    first.  The engine hands the profiler's state to its threads and a
    plain thread has none, so the inner span is opened directly."""
    def inner():
        with trace._Span("inner"):
            pass

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            worker = threading.Thread(target=inner)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    spans = {s["name"]: s for s in trace.snapshot(clear=True)["spans"]}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["inner"]["root"] == spans["outer"]["id"]


def test_snapshot_clear_and_stop_profiler_empty_the_store(tmp_path):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a"):
            trace.count("host_syncs", 2)
    snap = trace.snapshot(clear=True)
    assert [s["name"] for s in snap["spans"]] == ["a"]
    assert snap["counters"] == {"host_syncs": 2}
    assert trace.snapshot() == {"spans": [], "counters": {}}
    out = str(tmp_path)
    assert runtime.maybe_start_profiler(out, 1, start_step=1, num_steps=1)
    with trace.span("b"):
        trace.count("host_syncs")
    assert len(trace.snapshot()["spans"]) == 1
    assert runtime.stop_profiler() is not None
    assert trace.snapshot() == {"spans": [], "counters": {}}
