#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``opadpo_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: both CUDA kernels from ``opadpo_torch/csrc`` with nvcc;
  3. the flash forward kernel against its plain version at the serving
     shapes (LLaMA prefill [8, 703, 32, 128] causal, CLIP [8, 577, 16, 64]
     bidirectional), left-padded key masks and one fully masked row;
  4. the int8 decode-attention kernel against its plain version at
     [8, 32, 768, 128], s_used 768 and 640;
  5. a small-input reference: the tiny LLaVA's prefill and one int8 decode
     step on the GPU (kernels) against the same weights on the CPU (plain);
  6. the main path: LLaVA-1.5-7B at full width (random bf16 weights from a
     seed) behind the HTTP server, 9 concurrent requests, greedy, int8 KV;
     the kernels' launch counters must show that every prefill and decode
     step went through them;
  7. one JSON line of the kernels' numbers, the card line, and last
     ``{"ok": true, "device": {...}}``.

It needs a CUDA GPU and the repository around it: anywhere else it exits
non-zero before printing any result.  Kernel times are CUDA-event medians
of 20 launches with the L2 cache flushed (by a read) before each.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.request
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
NEG_INF = -1e30
# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


class WordTokenizer:
    """Word-level stand-in for the LLaMA tokenizer, with the HF surface the
    server uses.  Like the real one it keeps these serving prompts under
    128 tokens (a character-level one would not), so a batch takes the
    shapes real traffic gives: qlen 128, 703 positions with the image.
    Ids lie in [3, 32000); BOS is 1, EOS 2, pad 0."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0

    def __call__(self, text: str):
        ids = [self.bos_token_id] + [3 + zlib.crc32(w.encode()) % 31997
                                     for w in text.split()]
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special = (self.bos_token_id, self.eos_token_id, self.pad_token_id)
        return " ".join(f"<{int(i)}>" for i in ids
                        if not (skip_special_tokens and i in special))


def time_ms(fn, flush, n=20, warmup=3):
    """Median CUDA-event time of ``fn`` over ``n`` launches, each after an
    L2 flush outside the timed window.  The flush reads ``flush`` (larger
    than L2) rather than writing it, so no dirty lines are left to be
    written back inside the timed window."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(f"[device] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name, card


def phase_build():
    from opadpo_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.1f} s wall, per source: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for src, info in _build.last_build.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")
    _build.load("flash_fwd.cu")
    _build.load("decode_attention.cu")
    return secs


def _flash_case(b, s, h, d, causal, g, flush):
    import torch
    import torch.nn.functional as F

    from opadpo_torch.ops import attention

    dev = "cuda"
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    for i in range(b - 1):
        mask[i, :17 * i] = 0                 # left padding, 0..102 rows
    mask[b - 1] = 0                          # one row masked everywhere
    o, lse = attention.flash_fwd_cuda(q, k, v, mask, causal)
    o_ref, lse_ref = attention.mha_reference_lse(q, k, v, mask, causal)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    check(torch.isfinite(o.float()).all().item(), "flash o not finite")
    check(err_o <= 3e-2, f"flash o error {err_o} > 3e-2 at {tuple(q.shape)}")
    check(err_lse <= 1e-3, f"flash lse error {err_lse} > 1e-3")
    ms = time_ms(lambda: attention.flash_fwd_cuda(q, k, v, mask, causal),
                 flush)
    plain_ms = time_ms(
        lambda: attention.mha_reference_lse(q, k, v, mask, causal), flush)
    keep = (mask != 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(s, s, dtype=torch.bool,
                                 device=dev).tril()[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep), flush)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d
    nbytes = 4 * b * s * h * d * 2 + b * h * s * 4 + b * s * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    res = {"shape": [b, s, h, d], "causal": causal, "err_o": err_o,
           "err_lse": err_lse, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops}
    log(f"[flash] {json.dumps(res)}")
    return res


def phase_flash(g, flush):
    return [_flash_case(8, 703, 32, 128, True, g, flush),
            _flash_case(8, 577, 16, 64, False, g, flush)]


def phase_decode(g, flush):
    import torch

    from opadpo_torch.ops import decode_attention as da

    dev = "cuda"
    b, h, sp, hd = 8, 32, 768, 128
    q = torch.randn(b, h, hd, generator=g, device=dev).to(torch.bfloat16)
    pk, pv = (torch.randint(-127, 128, (b, h, sp, hd), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, h, sp, generator=g, device=dev) * 0.02
              for _ in range(2))
    bias = torch.zeros(b, sp, device=dev)
    for i in range(b):
        bias[i, :13 * i] = NEG_INF           # left padding
    bias[:, 703:] = NEG_INF                  # quantizer padding...
    ks[:, :, 703:] = 0.0                     # ...with zero scales
    vs[:, :, 703:] = 0.0
    sm = hd ** -0.5
    results = []
    for su in (768, 640):
        out = da.decode_attention_cuda(q, pk, ks, pv, vs, bias, sm, su)
        ref = da.decode_attention_prompt_plain(q, pk, ks, pv, vs, bias, sm,
                                               su)
        torch.cuda.synchronize()
        errs = [(o - r).abs().max().item() for o, r in zip(out, ref)]
        scale = [max(r.abs().max().item(), 1.0) for r in ref]
        for name, e, sc in zip(("out", "m", "l"), errs, scale):
            check(e <= 1e-4 * sc,
                  f"decode {name} error {e} > 1e-4 x {sc} at s_used={su}")
        ms = time_ms(lambda: da.decode_attention_cuda(q, pk, ks, pv, vs,
                                                      bias, sm, su), flush)
        plain_ms = time_ms(lambda: da.decode_attention_prompt_plain(
            q, pk, ks, pv, vs, bias, sm, su), flush)
        nbytes = (2 * b * h * su * hd + 2 * b * h * su * 4 + b * su * 4
                  + b * h * hd * 2 + b * h * hd * 4 + 2 * b * h * 4)
        flops = 4 * b * h * su * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        res = {"shape": [b, h, sp, hd], "s_used": su, "err_out": errs[0],
               "err_m": errs[1], "err_l": errs[2], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes}
        log(f"[decode] {json.dumps(res)}")
        results.append(res)
    return results


def phase_reference():
    """Tiny LLaVA in bf16: prefill and one int8 decode step through the
    kernels on the GPU against the plain path on the CPU, same weights."""
    import torch

    from opadpo_torch.constants import IMAGE_TOKEN_INDEX
    from opadpo_torch.models import llava

    cfg = llava.LlavaConfig.tiny()
    g = torch.Generator(device="cpu").manual_seed(1)
    cpu_model = llava.init_params(cfg, g, device="cpu")
    gpu_model = llava.empty_model(cfg, "cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = torch.randint(5, cfg.llama.vocab_size, (4, 130), generator=g)
    ids[:, 3] = IMAGE_TOKEN_INDEX
    mask = torch.ones_like(ids)
    mask[1, :40] = 0
    images = torch.randn(4, 28, 28, 3, generator=g)
    outs = []
    with torch.inference_mode():
        for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
            pf = llava.prefill_unrolled(model, ids.to(dev), mask.to(dev),
                                        images.to(dev), quantize_kv=True)
            n = cfg.llama.num_layers
            shape = (4, 2, cfg.llama.num_kv_heads, cfg.llama.head_dim)
            sfx = [(torch.zeros(shape, dtype=cfg.llama.dtype, device=dev),
                    torch.zeros(shape, dtype=cfg.llama.dtype, device=dev))
                   for _ in range(n)]
            tok = torch.argmax(pf["last_logits"], dim=-1)
            logits, _ = llava.decode_step_unrolled(
                model, tok, pf["kv_list"], pf["key_mask"], sfx, 0,
                pf["next_position"])
            outs.append((pf["last_logits"].float().cpu(), tok.cpu(),
                         logits.float().cpu()))
    (g_pf, g_tok, g_dec), (c_pf, c_tok, c_dec) = outs
    check(torch.isfinite(g_pf).all() and torch.isfinite(g_dec).all(),
          "reference logits not finite")
    e_pf = (g_pf - c_pf).abs().max().item()
    e_dec = (g_dec - c_dec).abs().max().item()
    tol_pf = 0.05 * c_pf.abs().max().item()
    tol_dec = 0.05 * c_dec.abs().max().item()
    log(f"[reference] tiny bf16 GPU vs CPU: prefill logits err {e_pf:.3e} "
        f"(tol {tol_pf:.3e}), decode logits err {e_dec:.3e} "
        f"(tol {tol_dec:.3e}), first tokens equal "
        f"{bool((g_tok == c_tok).all())}")
    check(e_pf <= tol_pf, "prefill logits disagree with the CPU reference")
    check(e_dec <= tol_dec, "decode logits disagree with the CPU reference")


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def phase_main_path(card):
    import torch
    from http.server import ThreadingHTTPServer

    from opadpo_torch.constants import IMAGE_TOKEN_INDEX
    from opadpo_torch.models import llava
    from opadpo_torch.ops import attention, decode_attention
    from opadpo_torch.serve import InferenceWorker, make_handler

    cfg = llava.LlavaConfig.llava_7b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = llava.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main] LLaVA-1.5-7B random init: {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s")
    worker = InferenceWorker(model, cfg, WordTokenizer(), max_batch=8,
                             max_new_tokens=64, kv_bits=8)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            check(json.loads(r.read()).get("status") == "ok", "healthz")
        warm = _post(port, {"prompt": "warm up", "max_new_tokens": 2})
        check("error" not in warm, f"warm-up request failed: {warm}")

        prompts = [f"Describe object {i} in the image in detail."
                   for i in range(8)]
        reqs = [{"prompt": p} for p in prompts]
        reqs.append({"prompt": prompts[0], "max_new_tokens": 8})
        worker.sampler.stats.clear()
        attention.flash_fwd_cuda.launches = 0
        decode_attention.decode_attention_cuda.launches = 0
        results = [None] * len(reqs)

        def go(i):
            results[i] = _post(port, reqs[i])

        t_start = time.perf_counter()
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t_start
        launches_a = attention.flash_fwd_cuda.launches
        launches_b = decode_attention.decode_attention_cuda.launches
        stats = list(worker.sampler.stats)
    finally:
        server.shutdown()
        server.server_close()

    check(not any(th.is_alive() for th in threads), "a request hung")
    for i, r in enumerate(results):
        check(r is not None and "text" in r and "error" not in r,
              f"request {i} failed: {r}")
    short, twin = results[-1]["text"], results[0]["text"]
    check(twin.startswith(short),
          f"short answer {short!r} is not a prefix of {twin!r}")
    check(len(twin) > len(short), "the 64-token answer is not longer")
    n_prefill = len(stats)
    n_steps = sum(s["decode_steps"] for s in stats)
    per_prefill = cfg.vision.num_active_layers + cfg.llama.num_layers
    sizes = sorted(r["batch_size"] for r in results)
    log(f"[main] {n_prefill} batches (requests per batch, one entry per "
        f"request: {sizes}), decode steps "
        f"{[s['decode_steps'] for s in stats]}; launches "
        f"flash {launches_a} (expect {per_prefill} x {n_prefill}), decode "
        f"{launches_b} (expect {cfg.llama.num_layers} x {n_steps})")
    check(n_prefill >= 1 and n_steps >= 1, "no batch ran")
    positions = sorted({s["prompt_positions"] for s in stats})
    check(positions == [703], f"prompt positions {positions}: the kernels "
          "were checked and timed at 703")
    check(launches_a == per_prefill * n_prefill,
          "flash kernel launches do not match the prefills")
    check(launches_b == cfg.llama.num_layers * n_steps,
          "decode kernel launches do not match the decode steps")

    prefill_ms = 1e3 * sum(s["prefill_s"] for s in stats) / n_prefill
    decode_ms = 1e3 * sum(s["decode_s"] for s in stats) / n_steps
    gen_tokens = sum(8 * (s["decode_steps"] + 1) for s in stats)
    busy = sum(s["prefill_s"] + s["decode_s"] for s in stats)
    main = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "generated_tok_per_s": gen_tokens / busy,
            "requests": len(reqs), "wall_s": wall,
            "launches_flash": launches_a, "launches_decode": launches_b,
            "card": card}
    log(f"[main] prefill {prefill_ms:.1f} ms/batch of 8 (qlen 128, "
        f"{positions[0]} positions), decode {decode_ms:.2f} ms/step, "
        f"{main['generated_tok_per_s']:.1f} generated tok/s (8 batch rows), "
        f"{wall:.2f} s wall for {len(reqs)} requests; card: {card}")
    log(f"[main] {json.dumps(main)}")

    # the same path once more, directly: finite logits, int8 cache shapes
    with torch.inference_mode():
        ids = torch.randint(5, 32000, (8, 128), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(3))
        ids[:, 40] = IMAGE_TOKEN_INDEX
        pf = llava.prefill_unrolled(
            model, ids, torch.ones_like(ids),
            torch.zeros(8, 336, 336, 3, device="cuda"), quantize_kv=True)
        torch.cuda.synchronize()
    logits = pf["last_logits"]
    check(tuple(logits.shape) == (8, 32000)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    kq = pf["kv_list"][0][0]["q"]
    check(tuple(kq.shape) == (8, 32, 768, 128) and kq.dtype == torch.int8,
          f"int8 prompt cache shape {tuple(kq.shape)}")
    return main


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs on the GPU only",
              file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        import opadpo_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repository is not around this script: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, card = phase_device()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    flash = phase_flash(g, flush)
    decode = phase_decode(g, flush)
    del flush
    torch.cuda.empty_cache()
    phase_reference()
    main_res = phase_main_path(card)

    fl, dc = flash[0], decode[0]
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "opadpo_torch/csrc/flash_fwd.cu",
         "replaces": "opadpo_tpu/ops/attention.py:174",
         "launches": main_res["launches_flash"],
         "max_abs_err": max(f["err_o"] for f in flash),
         "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
         "library_ms": fl["library_ms"],
         "at": "[8,703,32,128] bf16 causal (LLaMA prefill)",
         "clip": {k: flash[1][k] for k in
                  ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}},
        {"name": "decode_attention_int8", "route": "cuda",
         "source": "opadpo_torch/csrc/decode_attention.cu",
         "replaces": "opadpo_tpu/ops/decode_attention.py:51",
         "launches": main_res["launches_decode"],
         "max_abs_err": max(d["err_out"] for d in decode),
         "ms": dc["ms"], "plain_ms": dc["plain_ms"],
         "bound_ms": dc["bound_ms"], "bound_by": dc["bound_by"],
         "library_ms": None,
         "at": "[8,32,768,128] int8, s_used 768 (7B decode step, one layer)",
         "s_used_640_ms": decode[1]["ms"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
