"""The port's benches, profilers and stage recipes (``opadpo_torch/tools``)
on the CPU.

- Each tool runs ``--device cpu --model tiny`` in process into
  ``tmp_path``: its record has the JAX script's fields with finite
  numbers, and nothing is written outside ``--out`` / ``--outdir`` (no
  default record under ``build/tools/``, no record at the repository's
  root).
- ``bench_quality`` against ``scripts/bench_quality.py`` (loaded from its
  file): the metric helpers equal ``_logprob_metrics`` and ``_cosine`` to
  1e-12 on the same arrays; the batch equals ``_batch``'s array for array;
  on the tiny LLaVA in f32 with the JAX weights carried across
  (``bridge``), the int8 and int4 scoring metrics agree with the JAX
  ``_score``'s within 1e-5 absolute and the LoRA-gradient cosines with
  the JAX ``_grads``' within 1e-6.
- The traffic: ``bench_serve``'s budgets and prompts and its oracle
  corruption, and ``bench_spec``'s oracle drafts, equal draws made here
  with the JAX scripts' numpy calls, seeds 0 and 1.
- The refusals: ``bench_serve --spec-draft oracle`` without ``--spec-k``,
  ``bench_decode --chunk`` over a bf16 cache.
- ``summarize_trace`` on traces ``torch.profiler`` writes here: the newest
  of two, host rows skipped where device kernels are present.
- The six recipes call ``opadpo_torch`` modules only, and every
  ``training.*`` / ``model.*`` override is a key of the YAML they name as
  the port's config reader loads it.
"""

import glob
import importlib.util
import json
import math
import os
import re
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from opadpo_torch import bridge
from opadpo_torch.engine import dpo as t_dpo
from opadpo_torch.ops import quant as tq
from opadpo_torch.pipeline.config import load_config
from opadpo_torch.tools import (
    bench_decode, bench_image_pipeline, bench_quality, bench_serve,
    bench_spec, bench_train, common, profile_decode, profile_serving,
    profile_train, summarize_trace,
)
from tests.torch_parity import JCFG32, TCFG32, jax_params, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = os.path.join(REPO, "opadpo_torch", "tools", "recipes")


def _load_script(name):
    """A ``scripts/`` module from its file, the JAX compile-cache settings
    it sets restored after."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])
    return mod


def _numbers(node, path=""):
    """Every number of a record with its dotted path."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _numbers(v, f"{path}.{k}" if path else str(k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _numbers(v, f"{path}[{i}]")
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        yield path, node


def _get(rec, path):
    for key in path.split("/"):
        rec = rec[key]
    return rec


def _records_outside():
    """The files a tool may write by default: build/tools/ and the
    repository root's JSON records."""
    return (set(glob.glob(os.path.join(REPO, "build", "tools", "**"),
                          recursive=True))
            | {(p, os.path.getmtime(p))
               for p in glob.glob(os.path.join(REPO, "*.json"))})


# (tool, argv, fields of the record: the JAX script's, "/" for nesting)
TINY = {
    "bench_decode": (bench_decode, [
        "--bits", "8", "--kv-bits", "8", "--chunk", "128", "--steps", "130",
        "--batch", "2"], [
        "steps_per_sec", "tokens_per_sec", "ms_per_step", "prefill_ms"]),
    "bench_train_dpo": (bench_train, [
        "--mode", "dpo", "--bits", "8", "--bwd-int8", "--iters", "1",
        "--lora-rank", "4", "--batch", "1"], [
        "seconds_per_step", "first_iter_s"]),
    "bench_train_sft": (bench_train, [
        "--mode", "sft", "--bits", "16", "--iters", "1", "--lora-rank", "4",
        "--batch", "1"], ["seconds_per_step"]),
    "bench_serve": (bench_serve, [
        "--bits", "16", "--head-bits", "16", "--requests", "5", "--slots",
        "4", "--max-new", "8", "--seg-len", "4", "--spec-k", "2",
        "--spec-draft", "oracle", "--mode", "both"], [
        "continuous/tokens_per_sec", "continuous/latency_p50_s",
        "continuous/latency_p95_s", "batch_sync/tokens_per_sec",
        "batch_sync/latency_p50_s", "batch_sync/latency_p95_s",
        "continuous_speedup", "continuous/spec/groups",
        "continuous/spec/accepted_drafts"]),
    "bench_spec": (bench_spec, [
        "--steps", "16", "--accept-rates", "1.0,0.6"], [
        "baseline/steps_per_sec", "baseline/tokens_per_sec",
        "spec_oracle_a1.0/tokens_per_sec",
        "spec_oracle_a1.0/emitted_per_group",
        "spec_oracle_a0.6/accept_rate", "spec_ngram/groups",
        "spec_ngram/speedup_vs_baseline"]),
    "bench_quality": (bench_quality, [
        "--response-len", "16", "--modes", "int8,int4"], [
        "scoring/int8/logprob_mae", "scoring/int8/logprob_max_abs",
        "scoring/int8/pair_margin_abs_delta_std_gen",
        "scoring/int4/pair_margin_abs_delta_ai_gen",
        "scoring/int4/lora_grad_cosine_vs_bf16",
        "decode/kv8_first_step_logit_mae",
        "decode/kv4_first_step_logit_max_abs",
        "decode/head4_first_step_logit_mae"]),
    "bench_image_pipeline": (bench_image_pipeline, [
        "--images", "3", "--size", "64"], [
        "batch_preprocess/pil_ms_per_image",
        "rollout_rows/pil_rows_per_sec"]),
    "profile_decode": (profile_decode, [
        "--steps", "6", "--batch", "2", "--kv-bits", "4"], [
        "ms_per_step", "decode_forwards"]),
    "profile_serving": (profile_serving, [
        "--continuous", "--spec-k", "2", "--requests", "13",
        "--seg-len", "4"], [
        "pools/int8/phases/segment/host_ms_per_forward",
        "pools/spec k2/phases/segment/unprofiled_ms_per_forward",
        "pools/int8/phases/admission_group/host_ms",
        "verify_extra/host_ms"]),
    "profile_train": (profile_train, ["--mode", "sft"], [
        "phases/sft_train_step/host_ms",
        "phases/sft_train_step/unprofiled_ms"]),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_tool_rehearses_tiny_on_cpu(name, tmp_path):
    """The tool on the tiny model on the CPU: the JAX script's fields,
    finite numbers, nothing written but the record (and the trace)."""
    mod, argv, fields = TINY[name]
    out = tmp_path / "rec.json"
    before = _records_outside()
    if mod in (profile_serving, profile_train):
        argv = ["--device", "cpu", *argv, "--json", str(out)]
    else:
        argv = ["--out", str(out), *argv]
        if mod is not bench_image_pipeline:
            argv = ["--device", "cpu", "--model", "tiny", *argv]
        if mod is profile_decode:
            argv += ["--outdir", str(tmp_path / "trace")]
    assert mod.main(argv) == 0
    assert _records_outside() == before
    rec = json.loads(out.read_text())
    for f in fields:
        v = _get(rec, f)
        assert isinstance(v, (int, float)) and math.isfinite(v), (f, v)
    for path, v in _numbers(rec):
        assert math.isfinite(v), (path, v)
    if mod is profile_decode:
        assert os.path.isfile(rec["trace"])
        assert rec["trace"].startswith(str(tmp_path))


def test_bench_quality_metrics_equal_the_jax_helpers():
    jq = _load_script("bench_quality")
    rng = np.random.default_rng(0)
    masks = (rng.random((3, 2, 9)) > 0.3).astype(np.float64)
    lp, ref = rng.normal(size=(2, 3, 2, 9))
    got = bench_quality.logprob_metrics(lp, ref, masks)
    want = jq._logprob_metrics(lp, ref, masks)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, k
    a, b = rng.normal(size=(2, 50))
    assert abs(bench_quality.cosine(a, b) - jq._cosine(a, b)) <= 1e-12
    assert math.isnan(bench_quality.cosine(a * 0, b))


def test_bench_quality_matches_the_jax_script_on_the_tiny_model():
    """The batch array for array; on the tiny f32 model (JAX weights
    carried across) the int8 / int4 logprobs and scoring metrics within
    1e-5 of the JAX ``_score``'s and the gradient cosines within 1e-6 of
    the JAX ``_grads``'."""
    from opadpo_tpu.engine.dpo import DpoConfig as JDpo
    from opadpo_tpu.engine.dpo import rollout_score as j_rollout
    from opadpo_tpu.models.lora import LoraConfig as JLora
    from opadpo_tpu.ops import quant as jquant

    jq = _load_script("bench_quality")
    jquant.set_act_quant(False)
    lora_j = jq._lora(JCFG32, JLora(rank=4, alpha=8.0, dtype=jnp.float32))
    params = jax_params(3)
    kw = dict(response_len=12, query_len=8, lora_scaling=2.0)
    dpo_j, dpo_t = JDpo(**kw), t_dpo.DpoConfig(**kw)
    kw_g = dict(kw, response_len=10)
    dpo_gj, dpo_gt = JDpo(**kw_g), t_dpo.DpoConfig(**kw_g)
    jb = jq._batch(JCFG32, dpo_j, 2)
    tb_np = bench_quality.quality_batch(TCFG32, dpo_t, 2)
    assert jb.keys() == tb_np.keys()
    for k in jb:
        np.testing.assert_array_equal(
            tb_np[k], np.asarray(jb[k]).astype(tb_np[k].dtype), err_msg=k)
    tb = common.to_device(tb_np, "cpu")
    masks = bench_quality.masks_of(tb_np)

    model = bridge.llava_from_jax(to_np(params), TCFG32, device="cpu")
    lora_t = bridge.lora_from_jax(to_np(lora_j), device="cpu")
    ref_j = jq._score(params, JCFG32, dpo_j, jb, lora=lora_j)
    ref_t = bench_quality.score(model, dpo_t, tb, lora_t)
    np.testing.assert_allclose(ref_t, ref_j, atol=1e-5)

    gb = jq._batch(JCFG32, dpo_gj, 2, rng_seed=1)
    rolls = j_rollout(params, JCFG32, dpo_gj, None, gb,
                      jax.random.PRNGKey(9))
    full_j = {**gb, **rolls}
    full_t = bridge.tensors_from_jax(full_j, device="cpu")
    g_ref_j = jq._grads(params, JCFG32, dpo_gj, full_j, lora_j)
    g_ref_t = bench_quality.grads(model, dpo_gt, full_t, lora_t)
    assert np.linalg.norm(g_ref_t) == pytest.approx(
        np.linalg.norm(g_ref_j), rel=1e-5)
    for bits in (8, 4):
        qp = jquant.quantize_params(params, bits=bits)
        qm = bench_quality.quantized_copy(model, bits, tq.QuantMode())
        lp_j = jq._score(qp, JCFG32, dpo_j, jb, lora=lora_j)
        lp_t = bench_quality.score(qm, dpo_t, tb, lora_t)
        np.testing.assert_allclose(lp_t, lp_j, atol=1e-5)
        got = bench_quality.logprob_metrics(lp_t, ref_t, masks)
        want = jq._logprob_metrics(lp_j, ref_j, masks)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5, (bits, k, got, want)
        cos_j = jq._cosine(jq._grads(qp, JCFG32, dpo_gj, full_j, lora_j),
                           g_ref_j)
        cos_t = bench_quality.cosine(
            bench_quality.grads(qm, dpo_gt, full_t, lora_t), g_ref_t)
        assert abs(cos_t - cos_j) <= 1e-6, (bits, cos_t, cos_j)
    # the bf16 model is not changed by its quantized copies
    assert not any(isinstance(m, tq.QuantLinear) for m in model.modules())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mix", ["short", "long", "uniform"])
def test_bench_serve_traffic_is_the_jax_scripts(seed, mix):
    """``scripts/bench_serve.py:126-148`` and its oracle corruption
    (``:208-214``), drawn here with the same numpy calls."""
    requests, mn, qlen, vocab, sz = 9, 96, 12, 500, 7
    budgets, reqs, rng = bench_serve.traffic(seed, requests, mn, mix, qlen,
                                             vocab, sz)
    ref = np.random.default_rng(seed)
    if mix == "short":
        want = ref.choice(
            [max(1, mn // 16), max(1, mn // 8), max(1, mn // 4),
             max(1, mn // 2), mn], size=requests,
            p=[0.25, 0.25, 0.2, 0.15, 0.15]).astype(int)
    elif mix == "long":
        want = ref.choice(
            [max(1, mn // 4), max(1, mn // 2), max(1, 3 * mn // 4), mn],
            size=requests, p=[0.1, 0.2, 0.3, 0.4]).astype(int)
    else:
        want = np.full(requests, mn, dtype=int)
    np.testing.assert_array_equal(budgets, want)
    for i in range(requests):
        q = ref.integers(5, vocab, (qlen,)).astype(np.int32)
        q[1] = -200
        np.testing.assert_array_equal(reqs[i][0], q)
        np.testing.assert_array_equal(reqs[i][1], np.ones_like(q))
        assert reqs[i][2].shape == (sz, sz, 3) and not reqs[i][2].any()
        assert reqs[i][3] == int(want[i])
    outs = [np.arange(int(b)) + 7 for b in budgets]
    got = bench_serve.corrupt_oracles(rng, outs, 0.8, 4, vocab)
    for o, g in zip(outs, got):
        o = o.astype(np.int32).copy()
        corrupt = ref.random(o.shape) > 0.8
        o[corrupt] = ref.integers(5, vocab, int(corrupt.sum()))
        np.testing.assert_array_equal(g, np.pad(o, (0, 5)))


@pytest.mark.parametrize("seed", [0, 1])
def test_bench_spec_oracle_drafts_are_the_jax_scripts(seed):
    """``scripts/bench_spec.py:166-172``: each accept rate corrupts the
    baseline's tokens from the prompts' generator, in turn."""
    vocab, k = 300, 4
    rng = np.random.default_rng(seed)
    ref = np.random.default_rng(seed)
    base = rng.integers(0, vocab, (2, 20)).astype(np.int32)
    ref.integers(0, vocab, (2, 20))
    for a in (1.0, 0.8, 0.6):
        got = bench_spec.oracle_drafts(rng, base, a, k, vocab)
        orac = base.copy()
        mask = ref.random(orac.shape) > a
        orac[mask] = ref.integers(5, vocab, mask.sum())
        np.testing.assert_array_equal(got, np.pad(orac, ((0, 0),
                                                         (0, k + 1))))
    # the prompts: default_rng(0) ids, the image token second
    gen, q = bench_spec.prompts(TCFG32, 2, 10)
    want = np.random.default_rng(0).integers(
        5, TCFG32.llama.vocab_size, (2, 10)).astype(np.int32)
    want[:, 1] = -200
    np.testing.assert_array_equal(q, want)


def test_refusals():
    """An oracle without speculative segments, and chunked decode over a
    bf16 cache, are refused with an error."""
    with pytest.raises(SystemExit):
        bench_serve.parse_args(["--spec-draft", "oracle"])
    args = bench_serve.parse_args(["--spec-k", "2", "--spec-draft",
                                   "oracle"])
    args.spec_k = 0
    with pytest.raises(ValueError, match="--spec-k"):
        bench_serve.run(args)
    args = bench_decode.parse_args(["--chunk", "128", "--kv-bits", "16",
                                    "--device", "cpu", "--model", "tiny"])
    with pytest.raises(ValueError, match="quantized prompt cache"):
        bench_decode.run(args)
    with pytest.raises(ValueError, match="--model tiny"):
        common.device_of(bench_decode.parse_args(["--device", "cpu"]))


class _KinetoEvent:
    """The part of a raw Kineto event that ``common.device_kernels``
    reads."""

    def __init__(self, name, device, annotation, start_ns, end_ns):
        self._name, self._device, self._annotation = name, device, annotation
        self._start, self._end = start_ns, end_ns

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end


def test_device_kernels_leave_out_user_annotations():
    """A ``record_function`` range (a step's span) appears on the device
    as a user annotation: it is no work of the device, and only the
    kernels and copies count as device busy."""
    events = [
        _KinetoEvent("dpo.step", DeviceType.CUDA, True, 0, 10_000),
        _KinetoEvent("dpo.step", DeviceType.CPU, True, 0, 9_000),
        _KinetoEvent("aten::mm", DeviceType.CPU, False, 1_000, 2_000),
        _KinetoEvent("gemm_kernel", DeviceType.CUDA, False, 2_000, 5_000),
        _KinetoEvent("Memcpy HtoD", DeviceType.CUDA, False, 6_000, 7_000),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    kernels = common.device_kernels(prof)
    assert kernels == [("gemm_kernel", 2.0, 5.0), ("Memcpy HtoD", 6.0, 7.0)]
    assert common.busy_us([(s, e) for _, s, e in kernels]) == 4.0


def test_summarize_trace_reads_the_newest_torch_trace(tmp_path, capsys):
    """Two CPU traces from ``torch.profiler``: the newer is read (its
    host operators, there being no device kernel); a trace with device
    kernels keeps those and skips the host rows."""
    from torch.profiler import ProfilerActivity, profile

    paths = []
    for i, fn in enumerate((torch.mm, torch.add)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn(torch.ones(8, 8), torch.ones(8, 8))
        path = tmp_path / f"t{i}.json"
        prof.export_chrome_trace(str(path))
        os.utime(path, (time.time() + i, time.time() + i))
        paths.append(str(path))
    res = summarize_trace.summarize(str(tmp_path))
    assert res["path"] == paths[1] and not res["device"]
    names = [r["name"] for r in res["top"]]
    assert "aten::add" in names and "aten::mm" not in names
    dev = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "decode_attn_int4_kernel",
         "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "decode_attn_int4_kernel",
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 500.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 400.0},
        {"ph": "M", "name": "process_name"}]}
    sub = tmp_path / "dev"
    sub.mkdir()
    (sub / "d.json").write_text(json.dumps(dev))
    res = summarize_trace.summarize(str(sub), 5)
    assert res["device"] and res["total_us"] == 60.0
    assert [(r["name"], r["count"], r["us"]) for r in res["top"]] == [
        ("decode_attn_int4_kernel", 2, 40.0), ("gemm", 1, 20.0)]
    assert summarize_trace.main([str(sub), "1"]) == 0
    assert "decode_attn_int4_kernel" in capsys.readouterr().out


@pytest.mark.parametrize("recipe", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(RECIPES, "*.sh"))))
def test_recipes_call_the_port(recipe):
    """Each recipe's ``-m`` modules are ``opadpo_torch`` modules, its
    overrides keys of the YAML it names, and it never names the JAX
    package."""
    text = open(os.path.join(RECIPES, recipe)).read()
    assert "opadpo_tpu" not in text
    mods = re.findall(r"-m\s+(\S+)", text)
    assert mods, recipe
    for mod in mods:
        assert mod.startswith("opadpo_torch."), mod
        assert importlib.util.find_spec(mod) is not None, mod
    m = re.search(r"--config\s+(\S+)", text)
    keys = re.findall(r"\b((?:training|model)\.[A-Za-z_]+)=", text)
    if m:
        cfg = load_config(os.path.join(REPO, m.group(1)))
        for key in keys:
            assert cfg.get_path(key) is not None, (recipe, key)
    else:
        assert not keys, recipe
    if "train" in recipe or "generate" in recipe:
        assert 'torchrun --nproc-per-node "${NPROC:-1}"' in text
