#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``opadpo_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the seven CUDA sources of ``opadpo_torch/csrc``, one nvcc
     each, all at once;
  3. the flash forward kernel (#1, TMA K/V ring and warp-specialised
     wgmma) against its plain version at the serving shapes (LLaMA prefill
     [8, 703, 32, 128] causal, CLIP [8, 577, 16, 64] bidirectional) and
     the training response stream (896 queries over 703 + 896 keys),
     left-padded key masks and one fully masked row; its ptxas report
     (registers, spills, C7508), shared memory, and each shape's share of
     its bound beside SDPA and the WMMA kernel's earlier time;
  4. the flash backward kernels, dQ (#2) and dK/dV (#3, both TMA rings
     and warp-specialised wgmma), against the plain backward at the
     training shapes ([2, 703, 32, 128] causal prefix, the response stream
     at [6, 896 over 1599, 32, 128]): each output and each of its rows, two
     launches bitwise equal; their ptxas report (a spill, C7508 or C7514
     fails), shared memory, and each kernel's share of its bound beside
     SDPA's backward and the WMMA kernels' earlier times;
  5. the head-layout kernels, scatter (#4, TMA tiles, RoPE) and gather
     (#5, inverse RoPE), against their plain versions at [2, 703, 4096]
     and [6, 896, 4096], and #4 over a stream's q, k and v in one launch
     beside three single-tensor launches and the per-head kernel's time,
     with heads_layout.cu's ptxas report (a spill, C7512, C7513 or C7514
     fails);
  6. the decode-attention kernels, one cluster of CTAs per head each,
     against their plain versions, two launches bitwise equal: int8 (#6)
     at [8, 32, 768, 128], s_used 768 and 640, and at 768 timed at 2, 3
     and 6 ranks a head; int4 (#7) over the packed cache of an 896-token
     chunk-256 rollout ([8, 32, 768, 128] packed, 1536 positions) at
     s_used 768, 512, 1536, 1024 and 1280, and its time weighted by path
     A's forwards at each watermark; multi-query (#8) at G 5 (s_used 768,
     640), 2 and 8, and beside five launches of #6; each launch's split
     and shared memory beside the one-CTA body's earlier time, and
     decode_attention.cu's ptxas report (a spill, C7512, C7513 or C7514
     fails);
  7. the quantized matmuls against their plain versions: int8 (#9, TMA
     and wgmma, ``int8_matmul.cu``) at the 7B decode (M 8), head (f32
     out), prefix (M 703) and CLIP (M 577) shapes, its transpose (#10,
     the same file) at M 703, int4 (#11, TMA and wgmma,
     ``int4_matmul.cu``) at the 13B decode (M 1, 8), prefix (M 703) and
     CLIP (M 577) shapes, the 13B head (M 1) and path A's head (M 8, 4096
     -> 32000, f32 out), each beside the mma.sync kernel's earlier time;
     all three also at the tile edges (M 1 ... 1024), two launches bitwise
     equal in every case, with int8_matmul.cu's ptxas report (a spill,
     C7508 or C7514 fails) and int4_matmul.cu's (C7512 and C7513 fail
     too); and #9 / #10 / #11 beside dequantize-then-matmul and the int8
     GEMM route at M 8 ... 2688;
  8. small-input references, the GPU (kernels) against the same weights on
     the CPU (plain), on the tiny LLaVA with a bf16, an int8 and an int4
     base (and a decode head of that width): prefill, two decode steps over
     the int8 and over the int4 cache, a G = 3 verify group over the int8
     cache, and one tiny OPA-DPO step (rollout, loss, LoRA gradients,
     AdamW); then, in f32, greedy speculative decode (k 3, kv 16 and 8,
     both advances) token-exact against plain greedy on the GPU, and
     greedy int4 chunk-256 decode over 300 tokens (one fold) token-exact
     against the CPU;
  9. the serving path: LLaVA-1.5-7B at full width (random bf16 weights
     from a seed) behind the HTTP server, 9 concurrent requests, greedy,
     int8 KV; the launch counters must show that every prefill and decode
     step went through the kernels;
  10. path A, the rollout recipe's decode served on the same weights
     (``configs/llava_online_generation.yaml``: int4 KV and head, chunk
     256, 896 tokens, batch 8, temperature 1, top-k 30, top-p 0.95): 8
     requests, three folds, chunks reading to 768 ... 1536 positions, #7
     once per layer per decode forward, #11 per prefill and forward;
  11. path B, speculative serving (k 4, int8 KV, greedy, 64 tokens): the 9
     requests with the per-row advance, then one alone with the shared
     one; #8 once per layer per verify forward, each row's tokens equal to
     1 + its advances, agreement with step 9's answers reported;
  12. the training path, on the same 7B weights: ``rollout_score`` once,
     then 2 ``dpo_train_step``s at the reference recipe (per-device batch
     2, K = 3 responses of 896 tokens after a 128-token query, LoRA r 256,
     CoPO random, AncPO, AdamW lr 1e-6 with 5 warmup steps, clip 1.0);
     every loss and stat finite, the adapter moved by the last step, and
     the launch counters of kernels #1-#5 equal to the counts derived from
     the configuration;
  13. the quantized paths: the same 7B model quantized to int8 in place
     serves the 9 requests with an int8 decode head, then trains at the
     single-chip recipe (``configs/llava_dpo_singlechip.yaml``: w8a8 with
     the int8 backward, LoRA r 64 / alpha 128) cut to per-device batch 1:
     at the recipe's batch 2 the 1406-row prefix crosses the 1024-row rule
     and no quantized kernel would run, as in the JAX package; then, the
     7B model freed, LLaVA-1.5-13B drawn straight into int4
     (``llava_dpo_13b_singlechip.yaml``, batch 1, r 64) serves 3 requests
     one at a time with an int4 head and trains; each run's counters of
     #1, #6 and #9-#11 (and of their kernel variants) equal to the counts
     derived from its batches, #9 / #10's odd-shape variant never launched
     (also in the tiny references of step 8), and the 13B run launching
     both of #11's kernels;
  14. one JSON line of the 11 kernels' numbers, the card line, and last
     ``{"ok": true, "device": {...}}``.

It needs a CUDA GPU and the repository around it: anywhere else it exits
non-zero before printing any result.  Kernel times are CUDA-event medians
of 20 launches with the L2 cache flushed (by a read) before each.
"""

from __future__ import annotations

import gc
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
    for src in _build.SOURCES:
        _build.load(src)
    return secs


def _bound(nbytes, flops):
    """(bound ms, what bounds it) on the data sheet's peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _pairs(sq, skv, causal):
    """Visible (query, key) pairs of one (b, h): col <= row + skv - sq."""
    return sq * (skv - sq) + sq * (sq + 1) // 2 if causal else sq * skv


def _keep(mask, sq, skv, causal):
    """The boolean [B, 1, Sq, Skv] mask of scaled_dot_product_attention."""
    import torch

    keep = (mask != 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(sq, skv, dtype=torch.bool,
                                 device=mask.device).tril(skv - sq)[None, None]
    return keep


# o of #1 against its plain version, per (b, q, h) row, relative to that
# row's largest |o_ref|: bf16 output rounding on both sides is about one
# unit in the last place (2^-7 = 7.8e-3 of the row's largest entry), and
# the H100 readings at the three shapes and in tests/test_torch_gpu.py
# were 7.8e-3 to 9.05e-3 (PERF.md), so the limit is 2.2 times the largest;
# an error in P V (a slab, a rescale) moves entries by their own size,
# which the absolute 3e-2 misses on rows that average over many keys
FLASH_O_ROW_TOL = 2e-2


def row_rel_err(o, o_ref):
    """max over rows [..., D] of max |o - o_ref| / max |o_ref|."""
    ref = o_ref.float()
    num = (o.float() - ref).abs().amax(-1)
    return (num / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def _flash_case(b, sq, skv, h, d, causal, g, flush):
    import torch
    import torch.nn.functional as F

    from opadpo_torch.ops import attention

    dev = "cuda"
    q = torch.randn(b, sq, h, d, generator=g, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(b, skv, h, d, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = torch.ones(b, skv, dtype=torch.int32, device=dev)
    for i in range(b - 1):
        mask[i, :17 * i] = 0                 # left padding, 0..102 rows
    mask[b - 1] = 0                          # one row masked everywhere
    o, lse = attention.flash_fwd_cuda(q, k, v, mask, causal)
    o_ref, lse_ref = attention.mha_reference_lse(q, k, v, mask, causal)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_o_row = row_rel_err(o, o_ref)
    err_lse = (lse - lse_ref).abs().max().item()
    check(torch.isfinite(o.float()).all().item(), "flash o not finite")
    check(err_o <= 3e-2, f"flash o error {err_o} > 3e-2 at {tuple(q.shape)}")
    check(err_o_row <= FLASH_O_ROW_TOL,
          f"flash o row error {err_o_row} > {FLASH_O_ROW_TOL} of the row's "
          f"largest entry at {tuple(q.shape)}")
    check(err_lse <= 1e-3, f"flash lse error {err_lse} > 1e-3")
    ms = time_ms(lambda: attention.flash_fwd_cuda(q, k, v, mask, causal),
                 flush)
    plain_ms = time_ms(
        lambda: attention.mha_reference_lse(q, k, v, mask, causal), flush)
    keep = _keep(mask, sq, skv, causal)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep), flush)
    flops = 4 * b * h * _pairs(sq, skv, causal) * d
    nbytes = (2 * b * sq + 2 * b * skv) * h * d * 2 + b * h * sq * 4 \
        + b * skv * 4
    bound_ms, bound_by = _bound(nbytes, flops)
    res = {"shape": [b, sq, skv, h, d], "causal": causal, "err_o": err_o,
           "err_o_row": err_o_row, "err_lse": err_lse, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "share_of_bound": bound_ms / ms,
           "bytes": nbytes, "flops": flops}
    log(f"[flash] {json.dumps(res)}")
    return res


# #1's times before its TMA/wgmma redesign (the WMMA kernel; chip run of
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, recorded in PERF.md)
FLASH_FWD_WAS_MS = {"llama": 1.329, "clip": 0.274, "response": 3.087}


def phase_flash(g, flush):
    from opadpo_torch.ops import _build, attention

    ptxas = _build.last_build.get("flash_fwd.cu", {}).get("ptxas", "")
    for line in ptxas.splitlines():
        if any(w in line for w in ("registers", "spill", "C7508", "warning")):
            log(f"[flash] ptxas: {line.strip()}")
    lib = attention._fwd_lib()
    log("[flash] dynamic shared memory: " + ", ".join(
        f"D {d}: {lib.opadpo_flash_fwd_smem_bytes(d)} B" for d in (64, 128)))
    res = {"llama": _flash_case(8, 703, 703, 32, 128, True, g, flush),
           "clip": _flash_case(8, 577, 577, 16, 64, False, g, flush),
           "response": _flash_case(6, 896, 1599, 32, 128, True, g, flush)}
    for name, r in res.items():
        log(f"[flash] {name}: {r['ms']:.4f} ms = {100 * r['share_of_bound']:.1f}"
            f" % of its {r['bound_ms']:.4f} ms bound ({r['bound_by']}); SDPA "
            f"{r['library_ms']:.4f} ms; before the redesign "
            f"{FLASH_FWD_WAS_MS[name]} ms (PERF.md); o row error "
            f"{r['err_o_row']:.3e} of the row's largest entry")
    return res


# dq per query row, dk and dv per key row, against that row's largest
# |ref|; a row whose largest entry is under BWD_ROW_FLOOR of the tensor's
# (a query that sees one key has dq ~ 0: its dS is dP - delta, which
# cancels) is held against BWD_ROW_FLOOR of it.  bf16 rounding of the
# output on both sides is about one unit in the last place (7.8e-3 of the
# row's largest entry), and P and dS are rounded to bf16 before their
# products on both sides; the H100 readings at the two shapes and in
# tests/test_torch_gpu.py were at most 7.75e-3 (PERF.md), so the limit is
# 2.6 times that; a fault in a tile (a slab, a stage, a walk) moves a
# row's entries by their own size.
BWD_ROW_FLOOR = 1e-2
BWD_ROW_TOL = 2e-2


def bwd_row_err(a, ref):
    """max over rows [..., D] of max |a - ref| / max(max |ref_row|,
    BWD_ROW_FLOOR max |ref|)."""
    r = ref.float()
    den = r.abs().amax(-1).clamp_min(BWD_ROW_FLOOR * r.abs().max().item())
    return ((a.float() - r).abs().amax(-1)
            / den.clamp_min(1e-30)).max().item()


def _bwd_case(b, sq, skv, h, d, g, flush):
    """Both backward kernels against the plain backward, causal, keys
    left-padded by 29 per row (so the square case has fully masked rows,
    as a left-padded prefix does, with a zero output gradient, as nothing
    on the training path reads them): each output within 2e-2 of its
    largest |ref|, each row within BWD_ROW_TOL (``bwd_row_err``), and a
    second launch bitwise equal to the first."""
    import torch
    import torch.nn.functional as F

    from opadpo_torch.ops import attention

    dev = "cuda"
    q, do = (torch.randn(b, sq, h, d, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = torch.ones(b, skv, dtype=torch.int32, device=dev)
    for i in range(b):
        mask[i, :29 * i] = 0
        do[i, :max(0, 29 * i - (skv - sq))] = 0
    scale = d ** -0.5
    o, lse = attention.flash_fwd_cuda(q, k, v, mask, True, scale)
    inputs = attention.flash_bwd_inputs(q, k, v, mask, True, o, lse, do)

    def kernels():
        dq = attention.flash_bwd_dq_cuda(q, k, v, mask, True, scale, o, lse,
                                         do, inputs)
        dk, dv = attention.flash_bwd_dkv_cuda(q, k, v, mask, True, scale, o,
                                              lse, do, inputs)
        return dq, dk, dv

    got, again = kernels(), kernels()
    ref = attention.flash_bwd_reference(q, k, v, mask, True, scale, o, lse,
                                        do)
    torch.cuda.synchronize()
    errs, row_errs = {}, {}
    for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
        check(torch.isfinite(a.float()).all().item(), f"{name} not finite")
        check(torch.equal(a, a2), f"flash bwd {name}: two launches differ "
              f"at {[b, sq, skv, h, d]}")
        err = (a.float() - r.float()).abs().max().item()
        top = r.float().abs().max().item()
        check(err <= 2e-2 * top, f"flash bwd {name} error {err} > 2e-2 x "
              f"{top} at {[b, sq, skv, h, d]}")
        row = bwd_row_err(a, r)
        check(row <= BWD_ROW_TOL, f"flash bwd {name} row error {row} > "
              f"{BWD_ROW_TOL} of the row's largest entry at "
              f"{[b, sq, skv, h, d]}")
        errs[name], row_errs[name] = err, row
    dq_ms = time_ms(lambda: attention.flash_bwd_dq_cuda(
        q, k, v, mask, True, scale, o, lse, do, inputs), flush)
    dkv_ms = time_ms(lambda: attention.flash_bwd_dkv_cuda(
        q, k, v, mask, True, scale, o, lse, do, inputs), flush)
    plain_ms = time_ms(lambda: attention.flash_bwd_reference(
        q, k, v, mask, True, scale, o, lse, do), flush)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt,
                                         attn_mask=_keep(mask, sq, skv, True))
    dot = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), flush)
    pairs = b * h * _pairs(sq, skv, True)
    q_bytes, kv_bytes = b * sq * h * d * 2, b * skv * h * d * 2
    stats = 2 * b * h * sq * 4 + b * skv * 4
    dq_bound = _bound(3 * q_bytes + 2 * kv_bytes + stats, 6 * d * pairs)
    dkv_bound = _bound(2 * q_bytes + 4 * kv_bytes + stats, 8 * d * pairs)
    res = {"shape": [b, sq, skv, h, d], "err": errs, "row_err": row_errs,
           "dq_ms": dq_ms, "dkv_ms": dkv_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
           "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
           "dq_share_of_bound": dq_bound[0] / dq_ms,
           "dkv_share_of_bound": dkv_bound[0] / dkv_ms}
    log(f"[flash_bwd] {json.dumps(res)}")
    return res


# #2 and #3 before their TMA/wgmma redesign (the WMMA kernels; chip runs of
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, recorded in PERF.md)
FLASH_BWD_WAS_MS = {"prefix": (0.348, 0.375), "response": (3.050, 3.188)}


def ptxas_findings(src, fatal=()):
    """The ptxas report of one source: (its register, shared memory and
    spill lines and its C7512 "wgmma serialized for register resources"
    lines, a finding recorded in PERF.md; the lines that are faults: a
    spill, a C7508 "setmaxnreg ignored", a C7514 "wgmma serialized" for
    accumulators read in flight, any other ptxas warning, and a line
    naming any code in ``fatal``)."""
    from opadpo_torch.ops import _build

    ptxas = _build.last_build.get(src, {}).get("ptxas", "")
    shown, faults = [], []
    for line in ptxas.splitlines():
        line = line.strip()
        if any(w in line for w in ("registers", "spill", "smem", "C7512",
                                   "C7513")):
            shown.append(line)
        spills = "spill stores" in line and not (
            "0 bytes spill stores, 0 bytes spill loads" in line)
        if spills or "C7508" in line or "C7514" in line \
                or line.startswith("ptxas warning") \
                or any(code in line for code in fatal):
            faults.append(line)
    return shown, faults


def phase_flash_bwd(g, flush):
    from opadpo_torch.ops import attention

    shown, faults = ptxas_findings("flash_bwd.cu")
    for line in shown + faults:
        log(f"[flash_bwd] ptxas: {line}")
    check(not faults, f"flash_bwd.cu: ptxas reports {faults}")
    lib = attention._bwd_lib()
    log("[flash_bwd] dynamic shared memory: " + ", ".join(
        f"{name} D {d}: {lib.opadpo_flash_bwd_smem_bytes(which, d)} B"
        for which, name in ((0, "dQ"), (1, "dK/dV")) for d in (64, 128)))
    res = {"prefix": _bwd_case(2, 703, 703, 32, 128, g, flush),
           "response": _bwd_case(6, 896, 1599, 32, 128, g, flush)}
    for name, r in res.items():
        was_dq, was_dkv = FLASH_BWD_WAS_MS[name]
        log(f"[flash_bwd] {name}: dQ {r['dq_ms']:.4f} ms = "
            f"{100 * r['dq_share_of_bound']:.1f} % of its "
            f"{r['dq_bound_ms']:.4f} ms bound ({r['dq_bound_by']}), dK/dV "
            f"{r['dkv_ms']:.4f} ms = {100 * r['dkv_share_of_bound']:.1f} % "
            f"of {r['dkv_bound_ms']:.4f} ({r['dkv_bound_by']}); pair "
            f"{r['dq_ms'] + r['dkv_ms']:.4f} ms, SDPA backward "
            f"{r['library_ms']:.4f} ms; the WMMA kernels {was_dq} + "
            f"{was_dkv} ms (PERF.md); row errors {r['row_err']}")
    return res


# #4 and #5 before their redesigns (the per-head kernels, one CTA per 64
# rows of one head, one launch a tensor), ms per tensor: chip runs of
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, recorded in PERF.md
HEADS_WAS_MS = {"prefix": 0.0153, "response": 0.0354}
GATHER_WAS_MS = {"prefix": 0.0153, "response": 0.0360}


def _heads_case(b, s, g, flush, kv_len=None):
    """scatter (RoPE) and gather (inverse RoPE, strided [B, S, H, hd]
    gradient, as the backward kernels write it) at 32 heads of 128, the
    scatter of a stream's q, k and v in one launch (q and k with RoPE, v
    without) and the gather of its dQ, dK and dV in one launch (dQ and dK
    rotated back, dV not; the layouts of ``tools/time_heads.heads_grads``),
    as the training path runs them, each beside three single-tensor
    launches on the same tensors.  Each against its plain version (1e-2
    of the largest entry), two launches bitwise equal."""
    import torch

    from opadpo_torch.ops import heads_layout
    from opadpo_torch.ops.rope import rope_frequencies
    from opadpo_torch.tools.time_heads import heads_grads

    dev = "cuda"
    h, hd = 32, 128
    cos, sin = rope_frequencies(hd, 4096, device=dev)
    mask = (torch.arange(s, device=dev)[None]
            >= (torch.arange(b, device=dev) * 21)[:, None]).long()
    pos = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    x = torch.randn(b, s, h * hd, generator=g, device=dev,
                    dtype=torch.bfloat16)
    gr = torch.randn(b, s, h, hd, generator=g, device=dev,
                     dtype=torch.bfloat16).permute(0, 2, 1, 3)
    qkv = [torch.randn(b, s, h * hd, generator=g, device=dev,
                       dtype=torch.bfloat16) for _ in range(3)]
    grads = heads_grads(b, s, h, hd, g, kv_len)
    ropes = heads_layout.QKV_ROPE

    three_single = {
        "scatter_qkv": lambda: [heads_layout.scatter_heads_cuda(
            t, cos, sin, pos, h, r) for t, r in zip(qkv, ropes)],
        "gather_qkv": lambda: [heads_layout.gather_heads_cuda(
            t, cos, sin, pos, r) for t, r in zip(grads, ropes)]}
    cases = {
        "scatter": (lambda: [heads_layout.scatter_heads_cuda(
            x, cos, sin, pos, h, True)], lambda: [heads_layout.
            scatter_heads_plain(x, cos, sin, pos, h, True)], 1, 1),
        "gather": (lambda: [heads_layout.gather_heads_cuda(
            gr, cos, sin, pos, True)], lambda: [heads_layout.
            gather_heads_plain(gr, cos, sin, pos, True)], 1, 1),
        "scatter_qkv": (lambda: heads_layout.scatter_heads_multi_cuda(
            qkv, cos, sin, pos, h, ropes, (1, 1, 1)), lambda: [
            heads_layout.scatter_heads_plain(t, cos, sin, pos, h, r)
            for t, r in zip(qkv, ropes)], 3, 2),
        "gather_qkv": (lambda: heads_layout.gather_heads_multi_cuda(
            grads, cos, sin, pos, ropes, (1, 1, 1)), lambda: [
            heads_layout.gather_heads_plain(t, cos, sin, pos, r)
            for t, r in zip(grads, ropes)], 3, 2),
    }
    res = {"shape": [b, s, h * hd],
           "grad_layouts": {"dq": "[B,S,H,hd] permuted", "dk, dv":
                            f"slice at {kv_len - s} of [{b},{kv_len},{h},"
                            f"{hd}] permuted" if kv_len else
                            "[B,H,S,hd] contiguous"}}
    for name, (kernel, plain, tensors, rotated) in cases.items():
        outs, again, refs = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        check(all(torch.equal(o, a) for o, a in zip(outs, again)),
              f"{name}_heads: two launches differ")
        err = max((o.float() - r.float()).abs().max().item()
                  for o, r in zip(outs, refs))
        top = max(r.float().abs().max().item() for r in refs)
        check(err <= 1e-2 * top, f"{name}_heads error {err} > 1e-2 x {top}")
        # one read and one write of each [b, s, 4096] bf16 tensor (no GQA:
        # a gather reads what it writes), the positions, and one cos and
        # one sin half-row per position
        nbytes = tensors * 2 * b * s * h * hd * 2 + b * s * 8 \
            + 2 * b * s * (hd // 2) * 4
        bound_ms, bound_by = _bound(nbytes, rotated * 6 * b * s * h * hd)
        res[name] = {"err": err, "ms": time_ms(kernel, flush),
                     "plain_ms": time_ms(plain, flush), "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes}
    for name, fn in three_single.items():
        res[name]["three_single_ms"] = time_ms(fn, flush)
    log(f"[heads] {json.dumps(res)}")
    return res


def phase_heads(g, flush):
    """#4 and #5 at the training streams' shapes (the response stream's
    dK / dV as slices of its [prefix ++ response] gradient), and
    heads_layout.cu's ptxas report (a spill, C7512, C7513 or C7514
    fails)."""
    import torch

    from opadpo_torch.ops import heads_layout

    shown, faults = ptxas_findings("heads_layout.cu", ("C7512", "C7513"))
    for line in shown + faults:
        log(f"[heads] ptxas heads_layout.cu: {line}")
    check(not faults, f"heads_layout.cu: ptxas reports {faults}")
    res = {"prefix": _heads_case(2, 703, g, flush),
           "response": _heads_case(6, 896, g, flush, kv_len=1599)}
    dev = torch.device("cuda", 0)
    for name, r in res.items():
        b, s = r["shape"][:2]
        for kernel, multi, one, slots, was in (
                (4, "scatter_qkv", "scatter",
                 heads_layout._scatter_slots(dev, 128), HEADS_WAS_MS),
                (5, "gather_qkv", "gather",
                 heads_layout._gather_slots(dev, 128, 1), GATHER_WAS_MS)):
            c, single = r[multi], r[one]
            blocks, groups = heads_layout.scatter_grid(b, s, 96, slots)
            log(f"[heads] #{kernel} {name} {r['shape']}: three tensors in "
                f"one launch {c['ms']:.4f} ms = "
                f"{100 * c['bound_ms'] / c['ms']:.1f} % of its "
                f"{c['bound_ms']:.4f} ms bound ({blocks} x {b} x {groups} "
                f"CTAs); three single launches {c['three_single_ms']:.4f} "
                f"ms; one tensor {single['ms']:.4f} ms = "
                f"{100 * single['bound_ms'] / single['ms']:.1f} % of "
                f"{single['bound_ms']:.4f}; the per-head kernel "
                f"{was[name]} ms a tensor (PERF.md)")
    return res


def _decode_bytes(b, h, su, hd, gq, packed):
    """Bytes a decode-attention call must move: K and V (int8, or half for
    packed int4), both scales and the bias to ``su``, q in bf16, out and
    (m, l) in f32."""
    kv = 2 * b * h * su * hd // (2 if packed else 1)
    return (kv + 2 * b * h * su * 4 + b * su * 4 + b * h * gq * hd * 2
            + b * h * gq * hd * 4 + 2 * b * h * gq * 4)


def _decode_case(kernel, plain, args, su, gq, packed, flush, label):
    """One decode kernel call against its plain version (out, m, l within
    1e-4 of each one's largest entry; a second launch bitwise equal), its
    time, the plain version's and the bound."""
    import torch

    out, again, ref = kernel(*args, su), kernel(*args, su), plain(*args, su)
    torch.cuda.synchronize()
    check(all(torch.equal(a, c) for a, c in zip(out, again)),
          f"{label}: two launches differ at s_used={su}, G={gq}")
    errs = [(o - r).abs().max().item() for o, r in zip(out, ref)]
    scale = [max(r.abs().max().item(), 1.0) for r in ref]
    for name, e, sc in zip(("out", "m", "l"), errs, scale):
        check(e <= 1e-4 * sc, f"{label} {name} error {e} > 1e-4 x {sc} at "
              f"s_used={su}, G={gq}")
    b, h, _, hd = args[1].shape
    bound_ms, bound_by = _bound(_decode_bytes(b, h, su, hd, gq, packed),
                                4 * b * h * gq * su * hd)
    res = {"kernel": label, "shape": list(args[1].shape), "s_used": su,
           "G": gq, "err_out": errs[0], "err_m": errs[1], "err_l": errs[2],
           "ms": time_ms(lambda: kernel(*args, su), flush),
           "plain_ms": time_ms(lambda: plain(*args, su), flush),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": _decode_bytes(b, h, su, hd, gq, packed)}
    log(f"[decode] {json.dumps(res)}")
    return res


# the decode kernels before the cluster body (one CTA per (b, h), two
# passes), by (kernel, G, s_used): #7 and #8 from `tools/time_decode.py` on
# the one-CTA body in turns with the cluster kernels (the mean of two
# runs), s_used 512 and #8's 640 from earlier chip_smoke.py runs; #6 from
# chip_smoke.py runs; NVIDIA H100 80GB HBM3 at 700 W, recorded in PERF.md
DECODE_WAS_MS = {("int4", 1, 768): 0.0315, ("int4", 1, 512): 0.0241,
                 ("int4", 1, 1536): 0.0545, ("int4", 1, 1024): 0.0392,
                 ("int4", 1, 1280): 0.0469, ("multi", 5, 768): 0.0543,
                 ("multi", 5, 640): 0.0476, ("multi", 2, 768): 0.0408,
                 ("multi", 8, 768): 0.0933, ("int8", 1, 768): 0.0393,
                 ("int8", 1, 640): 0.0339}
# ranks a (b, h) timed for #6 at the serving shape
INT8_SPLIT_RANKS = (2, 3, 6)
KERNEL_NUMBER = {"int8": 6, "int4": 7, "multi": 8}
# path A's watermarks: the cache read to 768 + 256 i by the decode forwards
# of chunk i (895 forwards of 896 tokens: 256, 256, 256, 127)
PATH_A_MARKS = (768, 1024, 1280, 1536)


def phase_decode(g, flush):
    """The int8 decode kernel (#6) at [8, 32, 768, 128], s_used 768 and 640
    (the 7B serving step); the int4 one (#7) over the packed cache of an
    896-token, chunk-256 rollout ([8, 32, 768, 128] packed = 1536
    positions) at s_used 768 (the prompt), 512, 1536, 1024 and 1280 (path
    A's watermarks, and their launch-weighted time); the multi-query one
    (#8) over the int8 cache at G = 5 (k = 4) with s_used 768 and 640, and
    at G = 2 and 8; #8 at G = 5 beside five launches of #6 on the same
    queries; and the ptxas report of decode_attention.cu (a spill, C7512,
    C7513 or C7514 fails), with each cluster launch's split and shared
    memory."""
    import torch

    from opadpo_torch.ops import _build
    from opadpo_torch.ops import decode_attention as da

    shown, faults = ptxas_findings("decode_attention.cu",
                                   ("C7512", "C7513"))
    for line in shown + faults:
        log(f"[decode] ptxas decode_attention.cu: {line}")
    check(not faults, f"decode_attention.cu: ptxas reports {faults}")
    smem = _build.load("decode_attention.cu").opadpo_decode_attn_smem_bytes

    dev = "cuda"
    b, h, hd = 8, 32, 128
    sm = hd ** -0.5

    def scales_and_bias(sp, filled):
        ks, vs = (torch.rand(b, h, sp, generator=g, device=dev) * 0.02
                  for _ in range(2))
        bias = torch.zeros(b, sp, device=dev)
        for i in range(b):
            bias[i, :13 * i] = NEG_INF       # left padding
        bias[:, filled:] = NEG_INF           # padding and unfilled tail...
        ks[:, :, filled:] = 0.0              # ...with zero scales
        vs[:, :, filled:] = 0.0
        return ks, vs, bias

    q = torch.randn(b, h, 8, hd, generator=g, device=dev).to(torch.bfloat16)
    q1 = q[:, :, 0].contiguous()        # one query: no copy in the timing
    ks, vs, bias = scales_and_bias(1536, 1500)
    pk4, pv4 = (torch.randint(-128, 128, (b, h, 768, hd), generator=g,
                              device=dev, dtype=torch.int8) for _ in range(2))
    int4 = [_decode_case(da.decode_attention4_cuda,
                         da.decode_attention_prompt4_plain,
                         (q1, pk4, ks, pv4, vs, bias, sm), su, 1,
                         True, flush, "decode_attention_int4")
            for su in (768, 512, 1536, 1024, 1280)]
    del pk4, pv4
    ks, vs, bias = scales_and_bias(768, 703)
    pk, pv = (torch.randint(-127, 128, (b, h, 768, hd), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    int8 = [_decode_case(da.decode_attention_cuda,
                         da.decode_attention_prompt_plain,
                         (q1, pk, ks, pv, vs, bias, sm), su, 1,
                         False, flush, "decode_attention_int8")
            for su in (768, 640)]
    multi = [_decode_case(da.decode_attention_multi_cuda,
                          da.decode_attention_prompt_multi_plain,
                          (q[:, :, :gq].contiguous(), pk, ks, pv, vs, bias,
                           sm), su, gq, False, flush,
                          "decode_attention_multi")
             for gq, su in ((5, 768), (5, 640), (2, 768), (8, 768))]
    for group, cases in (("int8", int8), ("int4", int4), ("multi", multi)):
        for c in cases:
            n, per = da.decode_split(c["s_used"], b * h, group == "int4",
                                     c["G"])
            c.update(ranks=n, per=per, smem=smem(hd, c["G"], per, n))
            was = DECODE_WAS_MS.get((group, c["G"], c["s_used"]))
            log(f"[decode] #{KERNEL_NUMBER[group]} G {c['G']} "
                f"s_used {c['s_used']}: {c['ms']:.4f} ms = "
                f"{100 * c['bound_ms'] / c['ms']:.1f} % of its "
                f"{c['bound_ms']:.4f} ms bound; {n} ranks of {per} "
                f"positions, {c['smem']} B shared; the "
                f"one-CTA body {was} ms")
    splits = _int8_split_times((q1, pk, ks, pv, vs, bias, sm), 768, flush)
    fwd = ROLLOUT_TOKENS - 1
    weights = [min(ROLLOUT_CHUNK, fwd - ROLLOUT_CHUNK * i)
               for i in range(len(PATH_A_MARKS))]
    by_su = {c["s_used"]: c for c in int4}
    path_a = {k: sum(w * by_su[su][k] for w, su in zip(weights, PATH_A_MARKS))
              / sum(weights) for k in ("ms", "bound_ms")}
    log(f"[decode] #7 weighted by path A's forwards {weights} at "
        f"watermarks {list(PATH_A_MARKS)}: {path_a['ms']:.4f} ms a launch "
        f"against {path_a['bound_ms']:.4f} ms of bound")
    q5 = [q[:, :, i].contiguous() for i in range(5)]
    ms6 = time_ms(lambda: da.decode_attention_cuda(
        q5[0], pk, ks, pv, vs, bias, sm, 768), flush)
    ms6x5 = time_ms(lambda: [da.decode_attention_cuda(
        qi, pk, ks, pv, vs, bias, sm, 768) for qi in q5], flush)
    versus = {"multi_g5_ms": multi[0]["ms"], "int8_one_ms": ms6,
              "int8_five_ms": ms6x5,
              "multi_over_one": multi[0]["ms"] / ms6,
              "multi_over_five": multi[0]["ms"] / ms6x5}
    log(f"[decode] #8 at G 5 beside #6: {json.dumps(versus)}")
    return {"int8": int8, "int4": int4, "multi": multi,
            "versus_int8": versus, "path_a_int4": path_a,
            "int8_splits": splits}


def _int8_split_times(args, su, flush):
    """#6 at ``su`` with each of ``INT8_SPLIT_RANKS`` ranks a (b, h) (whole
    128-position chunks, as ``decode_split`` cuts them), each checked
    against the plain version within 1e-4 of its largest entry ->
    ``{ranks: ms}``, and the split ``decode_split`` takes."""
    from opadpo_torch.ops import decode_attention as da

    q1, pk = args[:2]
    b, h = pk.shape[:2]
    units = su // da.ALIGN
    ref = da.decode_attention_prompt_plain(*args, su)
    times = {}
    for n in INT8_SPLIT_RANKS:
        split = (n, -(-units // n) * da.ALIGN)

        def launch():
            return da._one_query(da._launch, *args, su, 0, split)

        for o, r in zip(launch(), ref):
            e = (o - r).abs().max().item()
            top = max(r.abs().max().item(), 1.0)
            check(e <= 1e-4 * top, f"#6 at {n} ranks: error {e} > 1e-4 x "
                  f"{top}")
        times[n] = time_ms(launch, flush)
    chosen = da.decode_split(su, b * h, False)
    log(f"[decode] #6 s_used {su} by ranks a (b, h): "
        + ", ".join(f"{n}: {ms:.4f} ms" for n, ms in times.items())
        + f"; decode_split takes {chosen[0]} ranks of {chosen[1]}")
    return {"ms_by_ranks": times, "chosen": list(chosen)}


def _library_int8(x, q, scale, out_dtype, deq):
    """One PyTorch call for x @ int8 q^T * scale where this build has one
    on CUDA (``torch._weight_int8pack_mm``, bf16 out), else ``deq``
    (dequantize, then ``torch.matmul``): (fn, label)."""
    import torch

    if out_dtype == torch.bfloat16:
        try:
            sb = scale.to(torch.bfloat16)
            torch._weight_int8pack_mm(x, q, sb)
            torch.cuda.synchronize()
            return (lambda: torch._weight_int8pack_mm(x, q, sb),
                    "torch._weight_int8pack_mm")
        except (RuntimeError, NotImplementedError):
            pass
    return deq, "dequantize + torch.matmul (two calls)"


def _quant_case(kind, m, k, n, g, flush, out_f32=False, timed=True):
    """One kernel (#9 ``q8``, #10 ``q8t``, #11 ``q4``) at [M, K] x [K, N]
    (for #10 the gradient is [M, N] and dx [M, K]) against its plain
    version: f32 output within 1e-5 of the largest entry, bf16 within one
    bf16 step (2^-7) of it; two launches bitwise equal.  With ``timed``:
    its time, the plain version's, the library call's, dequantize-then-
    matmul's (the path above the 1024-row rule; for #10 with the scale
    folded into g outside the timed call, as the port's earlier yardstick
    did, while the library call folds inside it) and, from M 1024 on, the
    int8 GEMM route's (``w8a8_nd`` / ``int8_dx`` on ``torch._int_mm``), and
    the bound."""
    import torch

    from opadpo_torch.ops import quant

    dev = "cuda"
    od = torch.float32 if out_f32 else torch.bfloat16
    w = torch.randn(n, k, generator=g, device=dev) * 0.02
    if kind == "q4":
        q, s = quant.quantize_weight_int4(w)
    else:
        q, s = quant.quantize_weight(w)
    del w
    int8_route = None
    if kind == "q8t":
        a = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
        kernel = lambda: quant.quant_matmul_t_cuda(a, q, s)   # noqa: E731
        plain = lambda: quant.quant_matmul_t_plain(a, q, s)   # noqa: E731
        gs = (a.float() * s).to(torch.bfloat16)
        deq = lambda: torch.matmul(                           # noqa: E731
            gs, quant.dequantize_weight(q, s))
        library = (lambda: torch.matmul(                      # noqa: E731
            (a.float() * s).to(torch.bfloat16), q.to(torch.bfloat16)),
            "fold + widen + torch.matmul (three calls)")
        if m >= 1024:
            int8_route = lambda: quant.int8_dx(a, q, s)        # noqa: E731
        variant = quant.q8t_variant(m, n, k)
        out_elems, in_bytes = m * k, m * n * 2 + n * 4 + n * k
    else:
        a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        if kind == "q4":
            kernel = lambda: quant.quant_matmul4_cuda(a, q, s, od)  # noqa
            plain = lambda: quant.quant_matmul4_plain(a, q, s, od)  # noqa
            deq = lambda: torch.matmul(                       # noqa: E731
                a, quant.dequantize_weight4(q, s).t()).to(od)
            library = (deq, "dequantize + torch.matmul (two calls)")
            in_bytes = m * k * 2 + n * k // 2 + s.numel() * 4
            variant = quant.q4_variant(m, n, k)
        else:
            kernel = lambda: quant.quant_matmul_cuda(a, q, s, od)  # noqa
            plain = lambda: quant.quant_matmul_plain(a, q, s, od)  # noqa
            deq = lambda: torch.matmul(                       # noqa: E731
                a, quant.dequantize_weight(q, s).t()).to(od)
            library = _library_int8(a, q, s, od, deq)
            if m >= 1024:
                int8_route = lambda: quant.w8a8_nd(a, q, s)    # noqa: E731
            in_bytes = m * k * 2 + n * k + n * 4
            variant = quant.q8_variant(m, n, k)
        out_elems = m * n
    out, ref, again = kernel(), plain(), kernel()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), f"{kind} not finite")
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    tol = 1e-5 if out.dtype == torch.float32 else 2.0 ** -7
    check(out.dtype == ref.dtype and err <= tol * top,
          f"{kind} at M {m} K {k} N {n}: error {err} > {tol} x {top}")
    check(torch.equal(out, again),
          f"{kind} at M {m} K {k} N {n}: two launches differ")
    res = {"kernel": kind, "variant": variant, "m": m, "k": k, "n": n,
           "out": "f32" if out_f32 else "bf16", "err": err, "top": top}
    if not timed:
        return res
    nbytes = in_bytes + out_elems * out.element_size()
    bound_ms, bound_by = _bound(nbytes, 2 * m * n * k)
    res_lib = time_ms(library[0], flush)
    res.update({
        "ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
        "library_ms": res_lib, "library_call": library[1],
        "dequant_matmul_ms": (res_lib if library[0] is deq
                              else time_ms(deq, flush)),
        "int8_gemm_ms": time_ms(int8_route, flush) if int8_route else None,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes})
    log(f"[quant] {json.dumps(res)}")
    return res


# #9 / #10 / #11 before their TMA/wgmma redesign (quant_matmul.cu's
# mma.sync kernel; chip runs of chip_smoke.py on an NVIDIA H100 80GB HBM3
# at 700 W, recorded in PERF.md), by (kernel, M, K, N)
QUANT_WAS_MS = {("q8", 8, 4096, 4096): 0.0187, ("q8", 8, 4096, 32000): 0.0704,
                ("q8", 703, 4096, 4096): 0.1636,
                ("q8", 577, 1024, 1024): 0.0267,
                ("q8", 577, 1024, 4096): 0.0512,
                ("q8t", 703, 4096, 4096): 0.2154,
                ("q8t", 703, 4096, 11008): 0.5535,
                ("q8t", 703, 11008, 4096): 0.4921,
                ("q4", 1, 5120, 5120): 0.0196, ("q4", 8, 5120, 5120): 0.0209,
                ("q4", 703, 5120, 5120): 0.2391,
                ("q4", 1, 5120, 32000): 0.0686}
QUANT_EDGE_ROWS = (1, 8, 9, 16, 17, 64, 65, 128, 129, 577, 703, 1024)
# #11's decoder shapes at 13B (K, N): q, k, v, o; gate, up; down
Q4_DECODER = ((5120, 5120), (5120, 13824), (13824, 5120))
# CLIP ViT-L's block linears (K, N): attention; fc1; fc2
Q4_CLIP = ((1024, 1024), (1024, 4096), (4096, 1024))


def phase_quant(g, flush):
    """Kernels #9-#11 at the shapes of the quantized paths: 7B int8 decode
    (M 8) and its head, the 7B prefix (M 703), CLIP at B = 1 (M 577), the
    13B int4 decode (M 1, 8), prefix and CLIP, the 13B head (M 1) and path
    A's int4 head (M 8); all three at the tile edges (M 1 ... 1024)
    against their plain versions; and #9 / #10 / #11 beside
    dequantize-then-matmul and the int8 GEMM route at M 8 ... 2688, either
    side of the 1024-row rule.  The ptxas reports of int8_matmul.cu (a
    spill, C7508 or C7514 fails) and int4_matmul.cu (C7512 and C7513
    fail too)."""
    from opadpo_torch.ops import _build

    for src, fatal, names in (
            ("int8_matmul.cu", (), ("q8_tile 64", "q8_tile 256", "q8_decode",
                                    "q8t_tile")),
            ("int4_matmul.cu", ("C7512", "C7513"),
             ("q4_tile 64", "q4_tile 128", "q4_decode"))):
        shown, faults = ptxas_findings(src, fatal)
        for line in shown + faults:
            log(f"[quant] ptxas {src}: {line}")
        check(not faults, f"{src}: ptxas reports {faults}")
        smem = getattr(_build.load(src),
                       f"opadpo_{src.split('_')[0]}_matmul_smem_bytes")
        log(f"[quant] {src} dynamic shared memory: " + ", ".join(
            f"{name} {smem(i)} B" for i, name in enumerate(names)))
    q8 = [_quant_case("q8", 8, k, n, g, flush)
          for k, n in ((4096, 4096), (4096, 11008), (11008, 4096))]
    q8.append(_quant_case("q8", 8, 4096, 32000, g, flush, out_f32=True))
    q8 += [_quant_case("q8", 703, k, n, g, flush)
           for k, n in ((4096, 4096), (4096, 11008), (11008, 4096))]
    q8 += [_quant_case("q8", 577, 1024, n, g, flush) for n in (1024, 4096)]
    # the gradient is [M, n], dx [M, k]: q is [n, k]
    q8t = [_quant_case("q8t", 703, k, n, g, flush)
           for k, n in ((4096, 4096), (4096, 11008), (11008, 4096))]
    edges = [_quant_case(kind, m, 4096, 4096, g, flush, timed=False)
             for kind in ("q8", "q8t") for m in QUANT_EDGE_ROWS]
    edges += [_quant_case("q8", m, 4096, 32000, g, flush, out_f32=True,
                          timed=False) for m in (1, 9, 16)]
    edges += [_quant_case("q4", m, 5120, 5120, g, flush, timed=False)
              for m in QUANT_EDGE_ROWS]
    edges += [_quant_case("q4", m, 5120, 32000, g, flush, out_f32=True,
                          timed=False) for m in (9, 16)]
    log(f"[quant] #9 / #10 / #11 at the tile edges, bitwise repeatable: "
        + ", ".join(f"{c['kernel']} M {c['m']} N {c['n']} ({c['variant']}) "
                    f"{c['err']:.3g} of {c['top']:.3g}" for c in edges))
    q4 = [_quant_case("q4", m, k, n, g, flush)
          for m in (1, 8, 703) for k, n in Q4_DECODER]
    q4 += [_quant_case("q4", 577, k, n, g, flush) for k, n in Q4_CLIP]
    q4 += [_quant_case("q4", 1, 5120, 32000, g, flush, out_f32=True),
           _quant_case("q4", 8, 4096, 32000, g, flush, out_f32=True)]
    for c in q8 + q8t + q4:
        was = QUANT_WAS_MS.get((c["kernel"], c["m"], c["k"], c["n"]))
        log(f"[quant] {c['kernel']} M {c['m']} K {c['k']} N {c['n']} "
            f"({c['variant']}): {c['ms']:.4f} ms = "
            f"{100 * c['bound_ms'] / c['ms']:.1f} % of its {c['bound_ms']:.4f}"
            f" ms bound ({c['bound_by']}); {c['library_call']} "
            f"{c['library_ms']:.4f}, dequantize + matmul "
            f"{c['dequant_matmul_ms']:.4f}; the mma.sync kernel {was} ms")
    crossover = [_quant_case(kind, m, k, k, g, flush)
                 for kind, k, rows in (("q8", 4096, (8, 703, 1024, 1406,
                                                     2688)),
                                       ("q8t", 4096, (1024, 1406, 2688)),
                                       ("q4", 5120, (8, 703, 1024, 1406,
                                                     2688)))
                 for m in rows]
    return {"q8": q8, "q8t": q8t, "q4": q4, "crossover": crossover,
            "edges": edges}


def _tiny_pair(bits, seed):
    """The tiny LLaVA in bf16 on the CPU and the same weights on the GPU;
    with ``bits`` 8 / 4 its block linears quantized (the same codes on
    both)."""
    import copy

    import torch

    from opadpo_torch.models import llava
    from opadpo_torch.ops import quant

    cfg = llava.LlavaConfig.tiny()
    g = torch.Generator(device="cpu").manual_seed(seed)
    cpu_model = llava.init_params(cfg, g, device="cpu")
    if bits != 16:
        quant.quantize_params(cpu_model, bits=bits)
    return cfg, g, cpu_model, copy.deepcopy(cpu_model).to("cuda")


def phase_reference(bits=16):
    """Tiny LLaVA in bf16: prefill, two decode steps over the int8 cache
    (#6), two over the int4 cache (#7) and one speculative verify group of
    G = 3 over the int8 cache (#8) through the kernels on the GPU against
    the plain path on the CPU, same weights; with ``bits`` 8 / 4 on a
    quantized base and a quantized decode head of the same width."""
    import torch

    from opadpo_torch.constants import IMAGE_TOKEN_INDEX
    from opadpo_torch.models import llama, llava

    cfg, g, cpu_model, gpu_model = _tiny_pair(bits, 1)
    ids = torch.randint(5, cfg.llama.vocab_size, (4, 130), generator=g)
    ids[:, 3] = IMAGE_TOKEN_INDEX
    mask = torch.ones_like(ids)
    mask[1, :40] = 0
    images = torch.randn(4, 28, 28, 3, generator=g)
    verify = torch.randint(5, cfg.llama.vocab_size, (4, 3), generator=g)
    outs = []
    counters = _counters()
    _reset(counters)
    with torch.inference_mode():
        for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
            head = llama.quantize_head_for_decode(model.llama, bits)
            got = {}
            for kv_bits in (8, 4):
                pf = llava.prefill_unrolled(
                    model, ids.to(dev), mask.to(dev), images.to(dev),
                    quantize_kv=True, kv_bits=kv_bits, head=head)
                n = cfg.llama.num_layers
                shape = (4, 3, cfg.llama.num_kv_heads, cfg.llama.head_dim)
                sfx = [(torch.zeros(shape, dtype=cfg.llama.dtype, device=dev),
                        torch.zeros(shape, dtype=cfg.llama.dtype, device=dev))
                       for _ in range(n)]
                tok = torch.argmax(pf["last_logits"], dim=-1)
                logits = []
                for step in range(2):
                    lg, sfx = llava.decode_step_unrolled(
                        model, tok, pf["kv_list"], pf["key_mask"], sfx, step,
                        pf["next_position"] + step, head=head)
                    logits.append(lg.float().cpu())
                    tok = torch.argmax(lg, dim=-1)
                got[f"prefill kv{kv_bits}"] = pf["last_logits"].float().cpu()
                got[f"decode kv{kv_bits}"] = torch.cat(logits)
                if kv_bits == 8:
                    lg, _ = llava.decode_step_multi(
                        model, verify.to(dev), pf["kv_list"],
                        pf["key_mask"], [tuple(x.zero_() for x in p)
                                         for p in sfx], 0,
                        pf["next_position"], head=head)
                    got["verify G3 kv8"] = lg.float().cpu()
            outs.append(got)
    gpu, cpu = outs
    launches = _read(counters)
    _check_no_odd(launches, f"tiny bits {bits} prefill and decode")
    for call in ("quant_matmul", "quant_matmul_t"):
        by_variant = sum(v for k, v in launches.items()
                         if k.startswith(call + "."))
        check(by_variant == launches[call], f"{call}: variants {launches} "
              "do not add up to the calls")
    errs = {}
    for key, ref in cpu.items():
        check(torch.isfinite(gpu[key]).all(), f"reference {key} not finite")
        e = (gpu[key] - ref).abs().max().item()
        tol = 0.05 * ref.abs().max().item()
        errs[key] = (e, tol)
        check(e <= tol, f"{key} logits disagree with the CPU reference: "
              f"{e} > {tol}")
    log(f"[reference] tiny bf16 bits {bits} GPU vs CPU, logits max err "
        "(tol): " + ", ".join(f"{k} {e:.3e} ({t:.3e})"
                              for k, (e, t) in errs.items()))


def _tiny_f32(seed):
    """The tiny LLaVA in f32 on the CPU and the same weights on the GPU,
    with a batch of 2 prompts."""
    import copy
    import dataclasses

    import torch

    from opadpo_torch.constants import IMAGE_TOKEN_INDEX
    from opadpo_torch.models import llava

    tiny = llava.LlavaConfig.tiny()
    cfg = llava.LlavaConfig(*(dataclasses.replace(c, dtype=torch.float32)
                              for c in (tiny.llama, tiny.vision,
                                        tiny.projector)))
    g = torch.Generator(device="cpu").manual_seed(seed)
    cpu_model = llava.init_params(cfg, g, device="cpu")
    ids = torch.randint(5, cfg.llama.vocab_size, (2, 10), generator=g)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    mask = torch.ones_like(ids)
    mask[1, 0] = 0
    images = torch.randn(2, 28, 28, 3, generator=g)
    return cpu_model, copy.deepcopy(cpu_model).to("cuda"), (ids, mask, images)


def _to(tree, dev):
    """A copy of a prefill result (tensors, lists, tuples, dicts) on dev."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev, copy=True)


def phase_tiny_f32_decode():
    """Token-exact checks on the tiny LLaVA in f32, greedy.  The flash
    kernel takes bf16 only, so each prompt pass runs on the CPU
    (``Sampler.prefill``) and the decode (``Sampler.decode``) runs from a
    copy of its result on the GPU:

    - ``Sampler(spec_k=3)`` at kv 16 and kv 8 (#8), both advances, equals
      plain greedy (kv 8: #6) on the GPU;
    - ``Sampler(kv_bits=4, chunk=256)`` over 300 tokens (one fold; #7)
      equals the same decode on the CPU."""
    import torch

    from opadpo_torch.engine.sampler import Sampler
    from opadpo_torch.engine.sampling import SamplingConfig

    cpu_model, gpu_model, (ids, mask, images) = _tiny_f32(5)
    res = {}
    with torch.inference_mode():
        sampling = SamplingConfig(greedy=True, max_new_tokens=40,
                                  eos_token_id=-1)
        for kv_bits in (16, 8):
            plain = Sampler(sampling, kv_bits=kv_bits)
            pf = plain.prefill(cpu_model, ids, mask, images)
            want, _ = plain.decode(gpu_model, _to(pf, "cuda"))
            for advance in ("shared", "per_row"):
                spec = Sampler(sampling, kv_bits=kv_bits, spec_k=3,
                               spec_advance=advance)
                got, info = spec.decode(gpu_model, _to(pf, "cuda"))
                check(torch.equal(got, want), f"spec kv{kv_bits} {advance} "
                      "greedy differs from plain greedy on the GPU")
                res[f"spec kv{kv_bits} {advance}"] = {
                    k: info[k] for k in ("spec_groups", "accepted_drafts")}
        chunked = Sampler(SamplingConfig(greedy=True, max_new_tokens=300,
                                         eos_token_id=-1),
                          kv_bits=4, chunk=256)
        pf = chunked.prefill(cpu_model, ids, mask, images)
        want, info_c = chunked.decode(cpu_model, _to(pf, "cpu"))
        got, info_g = chunked.decode(gpu_model, _to(pf, "cuda"))
        check(info_g["folds"] == 1 and info_g["sp_used"] == [256, 512],
              f"kv4 chunked decode: {info_g}")
        check(torch.equal(got.cpu(), want), "kv4 chunk-256 greedy on the "
              "GPU differs from the CPU")
        res["kv4 chunk256 300 tokens"] = info_g
    log(f"[reference] tiny f32 token-exact: {json.dumps(res)}")
    return res


def _rel(a, b) -> float:
    """|a - b| / |b| over all entries (L2)."""
    import torch

    a = torch.cat([x.float().flatten().cpu() for x in a])
    b = torch.cat([x.float().flatten().cpu() for x in b])
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def phase_train_reference(bits=16):
    """One tiny OPA-DPO step in bf16 on the GPU (kernels) against the same
    weights, adapter and batch on the CPU (plain versions), on a bf16 base
    or (``bits`` 8 / 4) a quantized one: the rollout's reference logprobs
    and entropies, the loss and the adapter's gradients; then the GPU's
    AdamW step at lr 1e-2 against the CPU's from the same gradients.
    (Adam's first step moves each entry by about lr times the sign of its
    gradient, so entries whose gradient lies within bf16 noise of zero move
    opposite ways from gradients that agree to 1e-2.)  Each device draws
    its own CoPO masks in its rollout, so the loss and the step read the
    GPU rollout on both."""
    import torch

    from opadpo_torch.engine import dpo as dpo_engine
    from opadpo_torch.engine.train_state import AdamW, OptimizerConfig, \
        TrainState
    from opadpo_torch.models.lora import LoraConfig, make_trainable, \
        named_leaves, tree_map
    from opadpo_torch.tools.profile_train import make_adapters, make_batch

    dpo = dpo_engine.DpoConfig(response_len=8, query_len=6)
    cfg, g, cpu_model, gpu_model = _tiny_pair(bits, 2)
    ref, _ = make_adapters(cfg, LoraConfig(rank=4, alpha=8.0), g, b_std=0.05)
    batch = make_batch(cfg, dpo, 2, g)

    def to(tree, dev):
        return tree_map(lambda x: x.to(dev), tree)

    counters = _counters()
    _reset(counters)
    roll = {dev: dpo_engine.rollout_score(
        model, dpo, to(ref, dev), to(batch, dev),
        torch.Generator(device=dev).manual_seed(3))
        for dev, model in (("cuda", gpu_model), ("cpu", cpu_model))}
    launches = {"rollout": _read(counters)}
    keys = [k for k in roll["cpu"] if k.startswith("ref_base")]
    e_roll = max((roll["cuda"][k].cpu() - roll["cpu"][k]).abs().max().item()
                 / roll["cpu"][k].abs().max().item() for k in keys)
    full = {**to(batch, "cuda"), **roll["cuda"]}
    opt = AdamW(OptimizerConfig(learning_rate=1e-2, warmup_steps=0,
                                total_steps=10))
    out = {}
    _reset(counters)
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        state = TrainState.create(make_trainable(to(ref, dev)), opt.cfg)
        loss, stats, grads = dpo_engine.loss_and_grads(state, model, dpo,
                                                       to(full, dev))
        out[dev] = (loss.item(), grads, state, stats)
    launches["step"] = _read(counters)
    for key, train in (("rollout", False), ("step", True)):
        want = expected_quant_train(gpu_model, dpo, 2, train)
        got = {k: launches[key][k] for k in want}
        log(f"[reference] tiny bits {bits} {key} quant launches {got}")
        check(got == want, f"tiny bits {bits} {key}: quant launches {got} "
              f"differ from the derived {want}")
        _check_no_odd(launches[key], f"tiny bits {bits} {key}")
    (l_g, g_g, st_g, s_g), (l_c, g_c, st_c, _) = out["cuda"], out["cpu"]
    opt.apply_gradients(st_g, g_g)
    opt.apply_gradients(st_c, [x.cpu() for x in g_g])
    before = [t for _, t in named_leaves(ref)]
    e_loss = abs(l_g - l_c) / abs(l_c)
    e_grad = _rel(g_g, g_c)
    e_step = _rel([a.detach().cpu().float() - b.float() for (_, a), b
                   in zip(named_leaves(st_g.params), before)],
                  [a.detach().float() - b.float() for (_, a), b
                   in zip(named_leaves(st_c.params), before)])
    check(all(torch.isfinite(v).all() for v in s_g.values()),
          "tiny DPO stats not finite")
    log(f"[reference] tiny bf16 bits {bits} DPO step GPU vs CPU: rollout "
        f"logprobs and "
        f"entropies rel err {e_roll:.3e} (tol 5e-2), loss {l_g:.5f} vs "
        f"{l_c:.5f} rel {e_loss:.3e} (tol 2e-2), LoRA grads rel L2 "
        f"{e_grad:.3e} (tol 5e-2), AdamW update from the same gradients "
        f"rel L2 {e_step:.3e} (tol 1e-2)")
    check(e_roll <= 5e-2, "tiny rollout disagrees with the CPU reference")
    check(e_loss <= 2e-2, "tiny DPO loss disagrees with the CPU reference")
    check(e_grad <= 5e-2, "tiny LoRA grads disagree with the CPU reference")
    check(e_step <= 1e-2, "tiny AdamW step disagrees with the CPU reference")
    return {"rollout_rel": e_roll, "loss_rel": e_loss, "grad_rel": e_grad,
            "step_rel": e_step}


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _serve(model, cfg, reqs, warm=True, **worker_kw):
    """Serve ``reqs`` concurrently over HTTP, after one warm-up request
    (unless not ``warm``), with every kernel counter set to 0 just before
    them -> (responses, ``Sampler.stats`` of their batches, the counters
    just after, wall s)."""
    from http.server import ThreadingHTTPServer

    from opadpo_torch.serve import InferenceWorker, make_handler

    worker = InferenceWorker(model, cfg, WordTokenizer(), **worker_kw)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    counters = _counters()
    results = [None] * len(reqs)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            check(json.loads(r.read()).get("status") == "ok", "healthz")
        if warm:
            resp = _post(port, {"prompt": "warm up", "max_new_tokens": 2})
            check("error" not in resp, f"warm-up request failed: {resp}")
        worker.sampler.stats.clear()
        _reset(counters)

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
        launches = _read(counters)
        stats = list(worker.sampler.stats)
    finally:
        server.shutdown()
        server.server_close()
        worker.close()
    check(not any(th.is_alive() for th in threads), "a request hung")
    for i, r in enumerate(results):
        check(r is not None and "text" in r and "error" not in r,
              f"request {i} failed: {r}")
    return results, stats, launches, wall


def _serve_metrics(stats, wall, n_reqs):
    """Prefill ms per batch, decode ms per forward (a verify group with
    speculative decode), generated tokens per second of busy time (every
    batch row's tokens)."""
    n_prefill = len(stats)
    n_steps = sum(s["decode_steps"] for s in stats)
    check(n_prefill >= 1 and n_steps >= 1, "no batch ran")
    busy = sum(s["prefill_s"] + s["decode_s"] for s in stats)
    gen_tokens = sum(sum(s["row_tokens"]) if "row_tokens" in s
                     else s["batch_rows"] * (s["decode_steps"] + 1)
                     for s in stats)
    return {"prefill_ms": 1e3 * sum(s["prefill_s"] for s in stats)
            / n_prefill,
            "decode_ms_per_step": 1e3 * sum(s["decode_s"] for s in stats)
            / n_steps,
            "generated_tok_per_s": gen_tokens / busy, "requests": n_reqs,
            "wall_s": wall, "batches": n_prefill, "decode_steps": n_steps}


DECODE_KERNELS = ("decode_attention_int8", "decode_attention_int4",
                  "decode_attention_multi")


def _check_attention_launches(cfg, stats, launches,
                              decode="decode_attention_int8"):
    """Flash forward once per CLIP and decoder layer per prefill; the
    ``decode`` kernel (#6 over int8 KV, #7 over int4, #8 for verify
    groups) once per decoder layer per decode forward, the other two
    never."""
    n_prefill = len(stats)
    n_steps = sum(s["decode_steps"] for s in stats)
    per_prefill = cfg.vision.num_active_layers + cfg.llama.num_layers
    check(launches["flash_fwd"] == per_prefill * n_prefill,
          f"flash kernel launches {launches['flash_fwd']} do not match "
          f"{per_prefill} x {n_prefill} prefills")
    for key in DECODE_KERNELS:
        want = cfg.llama.num_layers * n_steps if key == decode else 0
        check(launches[key] == want,
              f"{key} launches {launches[key]} do not match {want} "
              f"({cfg.llama.num_layers} x {n_steps} decode forwards)")


def phase_main_path(card):
    import torch

    from opadpo_torch.constants import IMAGE_TOKEN_INDEX
    from opadpo_torch.models import llava

    cfg = llava.LlavaConfig.llava_7b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = llava.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main] LLaVA-1.5-7B random init: {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = [f"Describe object {i} in the image in detail."
               for i in range(8)]
    reqs = [{"prompt": p} for p in prompts]
    reqs.append({"prompt": prompts[0], "max_new_tokens": 8})
    results, stats, launches, wall = _serve(
        model, cfg, reqs, max_batch=8, max_new_tokens=64, kv_bits=8)
    short, twin = results[-1]["text"], results[0]["text"]
    check(twin.startswith(short),
          f"short answer {short!r} is not a prefix of {twin!r}")
    check(len(twin) > len(short), "the 64-token answer is not longer")
    sizes = sorted(r["batch_size"] for r in results)
    log(f"[main] {len(stats)} batches (requests per batch, one entry per "
        f"request: {sizes}), decode steps "
        f"{[s['decode_steps'] for s in stats]}; launches {launches}")
    positions = sorted({s["prompt_positions"] for s in stats})
    check(positions == [703], f"prompt positions {positions}: the kernels "
          "were checked and timed at 703")
    _check_attention_launches(cfg, stats, launches)
    main = {**_serve_metrics(stats, wall, len(reqs)),
            "launches_flash": launches["flash_fwd"],
            "launches_decode": launches["decode_attention_int8"],
            "card": card}
    log(f"[main] prefill {main['prefill_ms']:.1f} ms/batch of 8 (qlen 128, "
        f"{positions[0]} positions), decode {main['decode_ms_per_step']:.2f} "
        f"ms/step, {main['generated_tok_per_s']:.1f} generated tok/s (8 "
        f"batch rows), {wall:.2f} s wall for {len(reqs)} requests; card: "
        f"{card}")
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
    return main, model, [r["text"] for r in results]


ROLLOUT_TOKENS = 896                # configs/llava_online_generation.yaml
ROLLOUT_CHUNK = 256


def phase_rollout_decode(model, card):
    """Path A, the rollout recipe's decode served
    (``configs/llava_online_generation.yaml``: int4 prompt KV, int4 head,
    chunk 256, 896 new tokens at batch 8, temperature 1.0, top-k 30,
    top-p 0.95): 8 concurrent requests, one batch.  Prompts of qlen 128
    give 703 positions, an int4 cache preallocated at 768 + 3 x 256 = 1536,
    four chunks reading to 768, 1024, 1280 and 1536, three folds (fewer if
    every row ends early: derived from the decode forwards).  #7 must run
    once per layer per decode forward, #6 and #8 never, #11 (the int4
    head) once per prefill and per decode forward."""
    import torch

    cfg = model.cfg
    prompts = [f"Describe region {i} of the image and what it shows."
               for i in range(8)]
    torch.cuda.reset_peak_memory_stats()
    results, stats, launches, wall = _serve(
        model, cfg, [{"prompt": p} for p in prompts], warm=False,
        max_batch=8, max_new_tokens=ROLLOUT_TOKENS, kv_bits=4,
        decode_chunk=ROLLOUT_CHUNK, head_bits=4, temperature=1.0, top_k=30,
        top_p=0.95, batch_window_s=0.5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(r["text"] for r in results), "an empty answer")
    positions = sorted({s["prompt_positions"] for s in stats})
    want_pos = cfg.num_patches + 128 - 1          # qlen 128
    check(positions == [want_pos], f"prompt positions {positions}")
    _check_attention_launches(cfg, stats, launches, "decode_attention_int4")
    want = expected_quant_serving(model, stats, 4)
    q4 = {k: launches[k] for k in want if k.startswith("quant_matmul4")}
    check(q4 == {k: want[k] for k in q4} and q4["quant_matmul4.decode"] > 0,
          f"int4 head launches {q4} != {want}")
    n_chunks = -(-ROLLOUT_TOKENS // ROLLOUT_CHUNK)
    sp_pad0 = -(-want_pos // 256) * 256
    for s in stats:
        folds = min(s["decode_steps"] // ROLLOUT_CHUNK, n_chunks - 1)
        marks = [sp_pad0 + ROLLOUT_CHUNK * i for i in range(folds + 1)]
        check(s["folds"] == folds and s["sp_used"] == marks,
              f"folds {s['folds']} and watermarks {s['sp_used']}: derived "
              f"{folds} and {marks} from {s['decode_steps']} decode "
              "forwards")
    res = {**_serve_metrics(stats, wall, len(prompts)),
           "folds": [s["folds"] for s in stats],
           "sp_used": [s["sp_used"] for s in stats],
           "launches": launches, "peak_gb": peak_gb, "card": card}
    log(f"[rollout-decode] {len(stats)} batch(es), decode forwards "
        f"{[s['decode_steps'] for s in stats]}, folds {res['folds']}, "
        f"watermarks {res['sp_used']}; decode {res['decode_ms_per_step']:.2f}"
        f" ms/step, {res['generated_tok_per_s']:.1f} generated tok/s, peak "
        f"{peak_gb:.2f} GB; card: {card}")
    log(f"[rollout-decode] {json.dumps(res)}")
    return res


def _leading_agreement(a: str, b: str) -> int:
    n = 0
    for x, y in zip(a.split(), b.split()):
        if x != y:
            break
        n += 1
    return n


def _server_batch(cfg, prompts, rows, dev):
    """(ids, mask, images) as ``serve.InferenceWorker`` builds a batch of
    ``rows`` rows for these prompts: left-padded to qlen 128 (or the next
    multiple of 64), black images."""
    import numpy as np
    import torch

    from opadpo_torch.data.image_processing import black_image
    from opadpo_torch.data.tokenization import tokenizer_image_token
    from opadpo_torch.serve import build_prompt

    tok = [np.asarray(tokenizer_image_token(build_prompt(p),
                                            WordTokenizer()), np.int64)
           for p in prompts]
    qlen = max(128, -(-max(len(r) for r in tok) // 64) * 64)
    ids = np.zeros((rows, qlen), np.int64)
    mask = np.zeros((rows, qlen), np.int64)
    for i, r in enumerate(tok):
        ids[i, -len(r):] = r
        mask[i, -len(r):] = 1
    size = cfg.vision.image_size
    images = np.stack([black_image(size)] * rows).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (ids, mask, images))


def spec_departure(model, prompts, rows=8, max_new=64, k=4):
    """Where speculative greedy (k drafts, ngram, per-row advance, int8 KV:
    the verify kernel #8) first departs from plain greedy (#6) on one
    server-shaped batch of ``prompts``, decoded from one prefill, and the
    two numbers that tell rounding from a fault there: plain greedy's
    top-2 logit gap at that position, and the largest |logits(#8) -
    logits(#6)| over the vocabulary at it (both paths emitted the same
    tokens before it).  The departure is rounding only where the gap is
    the smaller.  Returns the first departure of each row that departs and
    the verdict."""
    import torch

    from opadpo_torch.engine import speculative
    from opadpo_torch.engine.sampler import Sampler, decode_loop_unrolled
    from opadpo_torch.engine.serving_config import make_serving_sampling
    from opadpo_torch.models import llava

    dev = next(model.parameters()).device
    sampling = make_serving_sampling(greedy=True, max_new_tokens=max_new,
                                     eos_token_id=2, pad_token_id=0)
    ids, mask, images = _server_batch(model.cfg, prompts, rows, dev)
    rec_plain, rec_spec = [], []
    step_fn, multi_fn = llava.decode_step_unrolled, llava.decode_step_multi_pr

    def plain_step(*a, **kw):
        logits, suffix = step_fn(*a, **kw)
        rec_plain.append(logits.float())
        return logits, suffix

    def multi_step(*a, **kw):
        logits, raw = multi_fn(*a, **kw)
        rec_spec.append(logits.float())
        return logits, raw

    with torch.inference_mode():
        pf = Sampler(sampling, kv_bits=8).prefill(model, ids, mask, images)
        args = (model, pf["kv_list"], pf["key_mask"], pf["next_position"],
                pf["last_logits"], None, sampling)
        try:
            llava.decode_step_unrolled = plain_step
            llava.decode_step_multi_pr = multi_step
            out_plain, _ = decode_loop_unrolled(*args)
            out_spec, st = speculative.decode_loop_spec(
                *args, speculative.SpecConfig(k=k, advance="per_row"))
        finally:
            llava.decode_step_unrolled = step_fn
            llava.decode_step_multi_pr = multi_fn
    departures = []
    for b in range(len(prompts)):
        differ = torch.nonzero(out_plain[b] != out_spec[b])
        if not len(differ):
            continue
        pos = int(differ[0])
        if pos == 0 or pos > len(rec_plain):
            continue            # from the shared prefill, or past plain's end
        lp = rec_plain[pos - 1][b]
        e = 1
        for gi, adv in enumerate(st["advances"]):
            if e <= pos < e + adv[b]:
                ls = rec_spec[gi][b, pos - e]
                break
            e += adv[b]
        top2 = lp.topk(2).values
        departures.append({
            "row": b, "position": pos,
            "tokens_plain_spec": [int(out_plain[b, pos]),
                                  int(out_spec[b, pos])],
            "plain_top2_gap": float(top2[0] - top2[1]),
            "max_abs_logit_diff": float((ls - lp).abs().max())})
    rounding = all(d["plain_top2_gap"] < d["max_abs_logit_diff"]
                   for d in departures)
    return {"rows_departing": len(departures), "of": len(prompts),
            "departures": departures,
            "verdict": ("no departure" if not departures else
                        "rounding" if rounding else "fault")}


def phase_spec_serve(model, card, plain_answers):
    """Path B, speculative serving: k = 4 ngram drafts verified per group
    (G = 5) over the int8 cache, greedy, 64 new tokens, per-row advance at
    batch 8 on ``phase_main_path``'s 9 requests, then one request alone
    with the shared advance.  #8 must run once per layer per verify
    forward, #6 and #7 never; each row's tokens equal 1 + the sum of its
    per-group advances.  How many leading tokens agree with the plain
    greedy answers is reported, not required: the verify forward's GEMMs
    have 5x the rows of a plain step's, so bf16 rounding may part them."""
    cfg = model.cfg
    prompts = [f"Describe object {i} in the image in detail."
               for i in range(8)]
    reqs = [{"prompt": p} for p in prompts]
    reqs.append({"prompt": prompts[0], "max_new_tokens": 8})
    runs = {}
    for advance, rq in (("per_row", reqs), ("shared", reqs[:1])):
        results, stats, launches, wall = _serve(
            model, cfg, rq, max_batch=8, max_new_tokens=64, kv_bits=8,
            spec_k=4, spec_advance=advance, batch_window_s=0.5)
        check(all(r["text"] for r in results), "an empty answer")
        _check_attention_launches(cfg, stats, launches,
                                  "decode_attention_multi")
        for s in stats:
            # the shared advance may run past the budget; the excess is cut
            sums = [min(64, 1 + a) for a in s["row_advances"]]
            check(s["row_tokens"] == sums, f"tokens per row "
                  f"{s['row_tokens']} != 1 + advances {sums}")
        groups = sum(s["spec_groups"] for s in stats)
        runs[advance] = {
            **_serve_metrics(stats, wall, len(rq)),
            "verify_groups": groups,
            "accepted_drafts_per_group":
                sum(s["accepted_drafts"] for s in stats) / groups,
            "ms_per_verify_group":
                1e3 * sum(s["decode_s"] for s in stats) / groups,
            "leading_tokens_agreeing_with_plain": [
                _leading_agreement(r["text"], a)
                for r, a in zip(results, plain_answers)],
            "launches_multi": launches["decode_attention_multi"],
            "card": card}
        log(f"[spec-serve] {advance}: {json.dumps(runs[advance])}")
    runs["departure"] = spec_departure(model, prompts)
    log(f"[spec-serve] where speculative greedy departs from plain greedy: "
        f"{json.dumps(runs['departure'])}")
    return runs


def phase_quant_serve(model, card, label, head_bits, max_batch, n_reqs,
                      max_new_tokens):
    """The serving path on a quantized base: ``n_reqs`` concurrent requests
    (greedy, int8 prompt KV, the lm_head quantized to ``head_bits`` for
    decode); the launch counters of #1, #6, #9 and #11 must equal the
    counts derived from the batches."""
    cfg = model.cfg
    prompts = [f"What is object {i} in the picture doing?"
               for i in range(n_reqs)]
    results, stats, launches, wall = _serve(
        model, cfg, [{"prompt": p} for p in prompts], max_batch=max_batch,
        max_new_tokens=max_new_tokens, kv_bits=8, head_bits=head_bits)
    check(all(r["text"] for r in results), "an empty answer")
    positions = sorted({s["prompt_positions"] for s in stats})
    check(positions == [703], f"prompt positions {positions}")
    _check_attention_launches(cfg, stats, launches)
    want = expected_quant_serving(model, stats, head_bits)
    got = {k: launches[k] for k in want}
    log(f"[{label}] {len(stats)} batches of {max_batch} rows, decode steps "
        f"{[s['decode_steps'] for s in stats]}; quant launches {got} "
        f"(expect {want})")
    check(got == want, "quant kernel launches differ from the batches'")
    _check_no_odd(launches, label)
    res = {**_serve_metrics(stats, wall, n_reqs), "batch_rows": max_batch,
           "head_bits": head_bits, "launches": launches, "card": card}
    log(f"[{label}] prefill {res['prefill_ms']:.1f} ms/batch, decode "
        f"{res['decode_ms_per_step']:.2f} ms/step, "
        f"{res['generated_tok_per_s']:.1f} generated tok/s; card: {card}")
    log(f"[{label}] {json.dumps(res)}")
    return res


def _counters():
    from opadpo_torch.ops import attention, decode_attention, heads_layout
    from opadpo_torch.ops import quant

    return {"flash_fwd": attention.flash_fwd_cuda,
            "flash_bwd_dq": attention.flash_bwd_dq_cuda,
            "flash_bwd_dkv": attention.flash_bwd_dkv_cuda,
            "scatter_heads": heads_layout.scatter_heads_cuda,
            "gather_heads": heads_layout.gather_heads_cuda,
            "decode_attention_int8": decode_attention.decode_attention_cuda,
            "decode_attention_int4": decode_attention.decode_attention4_cuda,
            "decode_attention_multi":
                decode_attention.decode_attention_multi_cuda,
            "quant_matmul": quant.quant_matmul_cuda,
            "quant_matmul_t": quant.quant_matmul_t_cuda,
            "quant_matmul4": quant.quant_matmul4_cuda,
            **{f"{VARIANT_OF[v.split('_')[0]]}.{v.split('_')[1]}": c
               for v, c in quant.variant_launches.items()}}


# the wrapper whose launches each prefix of quant.variant_launches splits
VARIANT_OF = {"q8": "quant_matmul", "q8t": "quant_matmul_t",
              "q4": "quant_matmul4"}


def _reset(counters):
    for fn in counters.values():
        fn.launches = 0


def _read(counters):
    return {k: fn.launches for k, fn in counters.items()}


def _quant_layers(model):
    """(the quantized CLIP block linears, the decoder's, the first decoder
    layer's q, k, v)."""
    from opadpo_torch.ops.quant import QuantLinear

    def lins(blocks):
        return [m for blk in blocks for m in blk.children()
                if isinstance(m, QuantLinear)]

    first = model.llama.layers[0]
    return (lins(model.vision.layers), lins(model.llama.layers),
            [m for m in (first.wq, first.wk, first.wv)
             if isinstance(m, QuantLinear)])


QUANT_KEYS = ("quant_matmul", "quant_matmul_t", "quant_matmul4",
              "quant_matmul.tile", "quant_matmul.decode", "quant_matmul.odd",
              "quant_matmul_t.tile", "quant_matmul_t.odd",
              "quant_matmul4.tile", "quant_matmul4.decode")


def _add(counts, lins, rows, times=1, dx=False):
    """Count the launches of ``lins`` (quantized linears) at ``rows`` rows,
    ``times`` over: #9 or #11 forward, or with ``dx`` #10 through the int8
    ones; each also under the variant ``quant.q8_variant`` /
    ``q8t_variant`` / ``q4_variant`` names for the shape."""
    from opadpo_torch.ops import quant

    for lin in lins:
        n, k = lin.out_features, lin.in_features
        if dx:
            if lin.bits == 8:
                counts["quant_matmul_t"] += times
                counts["quant_matmul_t." + quant.q8t_variant(rows, n, k)] \
                    += times
        elif lin.bits == 8:
            counts["quant_matmul"] += times
            counts["quant_matmul." + quant.q8_variant(rows, n, k)] += times
        else:
            counts["quant_matmul4"] += times
            counts["quant_matmul4." + quant.q4_variant(rows, n, k)] += times


def _check_no_odd(launches, label):
    """Every #9 / #10 call of a path takes the TMA/wgmma kernels: the
    mma.sync kernel for odd shapes is launched no time."""
    odd = {k: launches[k] for k in ("quant_matmul.odd", "quant_matmul_t.odd")}
    check(not any(odd.values()), f"{label}: odd-shape launches {odd}")


def expected_quant_serving(model, stats, head_bits) -> dict:
    """Launches of kernels #9 and #11 in the batches ``stats`` describe
    (``Sampler.stats``), derived from the model's quantized linears: a
    linear takes its kernel when its rows (the product of the leading
    dims) are at most ``_STREAMING_MAX_M``.  A prefill of B rows runs the
    CLIP tower on B x 577 rows and the decoder on B x 703, then the head on
    B rows; each decode step the decoder and the head on B rows."""
    from opadpo_torch.ops.quant import _STREAMING_MAX_M as max_m

    clip, dec, _ = _quant_layers(model)
    lm = model.cfg.llama
    head = [types.SimpleNamespace(bits=head_bits, out_features=lm.vocab_size,
                                  in_features=lm.hidden_size)]
    counts = dict.fromkeys(QUANT_KEYS, 0)
    for s in stats:
        b, steps = s["batch_rows"], s["decode_steps"]
        clip_rows = b * (model.cfg.num_patches + 1)
        if clip_rows <= max_m:
            _add(counts, clip, clip_rows)
        if b * s["prompt_positions"] <= max_m:
            _add(counts, dec, b * s["prompt_positions"])
        if b <= max_m:
            _add(counts, dec, b, steps)
        if head_bits != 16:
            _add(counts, head, b, 1 + steps)
    return counts


def expected_quant_train(model, dpo, b, train: bool) -> dict:
    """Launches of kernels #9-#11 in one rollout_score (train=False) or
    one dpo_train_step (train=True) at per-device batch b.  Each scoring
    forward runs CLIP on b x 577 rows, the decoder's prefix on b x 703 and
    its response stream on K x b x 896 (K = 3, and 2 in the CoPO forward);
    a train step reruns each decoder layer's forward once (remat) and runs
    dx (#10) through every int8 decoder linear whose input needs a
    gradient: all but the first layer's q, k, v, whose input is the
    embeddings.  The int4 backward dequantizes (no kernel)."""
    from opadpo_torch.engine.dpo import RESPONSE_KEYS
    from opadpo_torch.ops.quant import _STREAMING_MAX_M as max_m

    clip, dec, first_qkv = _quant_layers(model)
    counts = dict.fromkeys(QUANT_KEYS, 0)
    prefix = b * (model.cfg.num_patches + dpo.query_len - 1)
    streams = [(prefix, len(RESPONSE_KEYS) * b * dpo.response_len)]
    if dpo.CoPO:
        streams.append((prefix, 2 * b * dpo.response_len))
    for p_rows, r_rows in streams:
        clip_rows = b * (model.cfg.num_patches + 1)
        if clip_rows <= max_m:
            _add(counts, clip, clip_rows)
        for rows in (p_rows, r_rows):
            if rows > max_m:
                continue
            _add(counts, dec, rows, 2 if train else 1)
            if train:
                _add(counts, [m for m in dec
                              if not any(m is f for f in first_qkv)],
                     rows, dx=True)
    return counts


def expected_launches(cfg, dpo, train: bool) -> dict:
    """Launches of kernels #1-#5 in one rollout_score (train=False) or one
    dpo_train_step (train=True), derived from the configuration.  Each
    scoring forward runs the CLIP tower (one flash forward per active
    layer) and, per decoder layer, the prefix and the response stream's
    flash forwards and two scatter launches (one for q, k and v of each
    stream); a train step's backward recomputes each decoder layer once
    (remat), so its forward kernels run twice, and adds per layer two dQ
    and two dK/dV launches and six gather passes.  CoPO adds a second
    forward."""
    n_layers, n_clip = cfg.llama.num_layers, cfg.vision.num_active_layers
    per = {"flash_fwd": n_clip + 2 * n_layers, "scatter_heads": 2 * n_layers,
           "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "gather_heads": 0}
    if train:
        per["flash_fwd"] += 2 * n_layers
        per["scatter_heads"] += 2 * n_layers
        per.update(flash_bwd_dq=2 * n_layers, flash_bwd_dkv=2 * n_layers,
                   gather_heads=2 * n_layers)
    forwards = 2 if dpo.CoPO else 1
    return {k: forwards * v for k, v in per.items()}


def phase_train(model, card, label="train", n_steps: int = 2, b: int = 2,
                lora_cfg=None):
    """The OPA-DPO training path: ``rollout_score`` once, then ``n_steps``
    ``dpo_train_step``s at per-device batch ``b`` with adapters of
    ``lora_cfg`` (the reference recipe's r 256 by default)."""
    import torch

    from opadpo_torch.engine import dpo as dpo_engine
    from opadpo_torch.engine.train_state import AdamW, TrainState
    from opadpo_torch.models.lora import named_leaves
    from opadpo_torch.tools.profile_train import (
        RECIPE_LORA, RECIPE_OPT, make_adapters, make_batch,
    )

    cfg = model.cfg
    dpo = dpo_engine.DpoConfig()
    lora_cfg = lora_cfg or RECIPE_LORA
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    ref, policy = make_adapters(cfg, lora_cfg, gen)
    batch = make_batch(cfg, dpo, b, gen)
    opt = AdamW(RECIPE_OPT)
    state = TrainState.create(policy, opt.cfg)
    counters = _counters()
    n_lora = sum(t.numel() for _, t in named_leaves(policy))

    _reset(counters)
    t0 = time.perf_counter()
    rollout = dpo_engine.rollout_score(model, dpo, ref, batch, gen)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches_rollout = _read(counters)
    for key, val in rollout.items():
        check(bool(torch.isfinite(val.float()).all()), f"rollout {key}")
    prefix = cfg.num_patches + dpo.query_len - 1
    check(tuple(rollout["ref_base_standard_response_logprobs"].shape)
          == (b, dpo.response_len), "rollout logprob shape")
    full = {**batch, **rollout}

    _reset(counters)
    step_s, losses = [], []
    for i in range(n_steps):
        if i == n_steps - 1:
            before = [t.detach().clone() for _, t in named_leaves(state.params)]
        t0 = time.perf_counter()
        state, stats = dpo_engine.dpo_train_step(state, model, full, opt, dpo)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        bad = [k for k, v in stats.items() if not bool(torch.isfinite(v))]
        check(not bad, f"step {i}: non-finite stats {bad}")
        losses.append({k: stats[k].item() for k in
                       ("loss/total", "loss/grad_norm", "loss/stand_gen",
                        "loss/AncPO")})
    launches_train = _read(counters)
    moved = sum(int((t.detach() != p).sum()) for (_, t), p in
                zip(named_leaves(state.params), before))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want_roll = {**expected_launches(cfg, dpo, train=False),
                 **expected_quant_train(model, dpo, b, train=False),
                 **dict.fromkeys(DECODE_KERNELS, 0)}
    want_step = {**expected_launches(cfg, dpo, train=True),
                 **expected_quant_train(model, dpo, b, train=True),
                 **dict.fromkeys(DECODE_KERNELS, 0)}
    log(f"[{label}] launches rollout {launches_rollout} (expect "
        f"{want_roll}); {n_steps} steps {launches_train} (expect {n_steps} "
        f"x {want_step})")
    check(launches_rollout == want_roll,
          "rollout launch counts differ from the configuration's")
    check(launches_train == {k: n_steps * v for k, v in want_step.items()},
          "train step launch counts differ from the configuration's")
    _check_no_odd(launches_rollout, label)
    _check_no_odd(launches_train, label)
    check(moved > 0, "the adapter did not move in the last step")

    positions = (b * prefix + len(dpo_engine.RESPONSE_KEYS) * b
                 * dpo.response_len) + (b * prefix + 2 * b * dpo.response_len)
    step_med = statistics.median(step_s[1:])
    res = {"rollout_s": rollout_s, "step_s": step_s,
           "step_s_median_after_first": step_med, "batch": b,
           "lora_rank": lora_cfg.rank,
           "scored_positions_per_step": positions,
           "rollout_positions_per_s": positions / rollout_s,
           "train_positions_per_s": positions / step_med,
           "peak_gb": peak_gb, "lora_params": n_lora,
           "adapter_entries_moved_last_step": moved,
           "losses": losses,
           "launches_per_step": {k: v // n_steps
                                 for k, v in launches_train.items()},
           "launches_rollout": launches_rollout,
           "launches": {k: launches_rollout[k] + launches_train[k]
                        for k in launches_train},
           "prefix_positions": prefix, "card": card}
    log(f"[{label}] rollout_score {rollout_s:.3f} s, dpo_train_step "
        f"{[round(x, 3) for x in step_s]} s (median after the first "
        f"{step_med:.3f} s), {positions} scored positions per step: "
        f"{res['rollout_positions_per_s']:.0f} /s scoring, "
        f"{res['train_positions_per_s']:.0f} /s training; peak "
        f"{peak_gb:.2f} GB; LoRA {n_lora / 1e6:.1f} M params, {moved} "
        f"entries moved in the last step; card: {card}")
    log(f"[{label}] {json.dumps(res)}")
    return res


SINGLE_CHIP_STEPS = 2


def phase_7b_int8(model, card):
    """LLaVA-1.5-7B at bits 8 (the served and trained bf16 model,
    quantized in place) serving 9 requests with head_bits 8, then training
    at the single-chip recipe (``configs/llava_dpo_singlechip.yaml``: w8a8
    with the int8 backward, LoRA r 64 / alpha 128) cut to per-device batch
    1.  -> (serving result, training result)."""
    import torch

    from opadpo_torch.ops import quant
    from opadpo_torch.tools.profile_train import SINGLE_CHIP_LORA

    t0 = time.perf_counter()
    quant.quantize_params(model, bits=8)
    torch.cuda.synchronize()
    log(f"[7b-int8] quantized in place in {time.perf_counter() - t0:.1f} s:"
        f" {quant.quantized_bytes(model) / 1e9:.2f} GB of weights")
    serving = phase_quant_serve(model, card, "7b-int8", 8, 8, 9, 64)
    quant.set_quant_mode(model, quant.QuantMode(act_bits=8, bwd_int8=True))
    training = phase_train(model, card, "7b-int8-train", SINGLE_CHIP_STEPS,
                           1, SINGLE_CHIP_LORA)
    return serving, training


def phase_13b_int4(card):
    """LLaVA-1.5-13B at bits 4 (``llava_dpo_13b_singlechip.yaml``, random
    weights drawn straight into int4) serving 3 requests one at a time
    with head_bits 4, then training at batch 1, LoRA r 64 / alpha 128.
    -> (serving result, training result)."""
    import torch

    from opadpo_torch.models import llava
    from opadpo_torch.ops import quant
    from opadpo_torch.tools.profile_train import SINGLE_CHIP_LORA

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = llava.init_params_quantized(
        llava.LlavaConfig.llava_13b(),
        torch.Generator(device="cuda").manual_seed(0), bits=4)
    torch.cuda.synchronize()
    log(f"[13b-int4] random init in int4 in {time.perf_counter() - t0:.1f} "
        f"s: {quant.quantized_bytes(model) / 1e9:.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    serving = phase_quant_serve(model, card, "13b-int4", 4, 1, 3, 32)
    training = phase_train(model, card, "13b-int4-train", SINGLE_CHIP_STEPS,
                           1, SINGLE_CHIP_LORA)
    q4 = {v: serving["launches"][f"quant_matmul4.{v}"]
          + training["launches"][f"quant_matmul4.{v}"]
          for v in ("decode", "tile")}
    log(f"[13b-int4] #11 launches by kernel: {q4}")
    check(q4["decode"] > 0 and q4["tile"] > 0,
          f"13B int4: #11 did not run both kernels: {q4}")
    return serving, training


def quant_kernel_entries(qk, q_serve, q_train):
    """The kernels line's entries of #9-#11: launches over the quantized
    paths' runs (path A's int4 head among the serving runs), and by
    variant, numbers at a main-path shape, every shape beside."""
    def runs(kname):
        return sum(r["launches"][kname]
                   for r in list(q_serve.values()) + list(q_train.values()))

    keys = ("ms", "plain_ms", "library_ms", "library_call",
            "dequant_matmul_ms", "int8_gemm_ms", "bound_ms", "bound_by")
    out = []
    for kname, group, main_i, line, src in (
            ("quant_matmul", "q8", 0, "opadpo_tpu/ops/quant.py:60",
             "int8_matmul.cu"),
            ("quant_matmul_t", "q8t", 0, "opadpo_tpu/ops/quant.py:155",
             "int8_matmul.cu"),
            ("quant_matmul4", "q4", 0, "opadpo_tpu/ops/quant.py:495",
             "int4_matmul.cu")):
        cases = qk[group] + [c for c in qk["crossover"]
                             if c["kernel"] == group]
        checked = cases + [c for c in qk["edges"] if c["kernel"] == group]
        main = qk[group][main_i]
        variants = sorted(k for k in QUANT_KEYS if k.startswith(kname + "."))
        out.append({
            "name": kname, "route": "cuda",
            "source": f"opadpo_torch/csrc/{src}", "replaces": line,
            "launches": runs(kname),
            "launches_by_variant": {v: runs(v) for v in variants},
            "launches_by_run": {
                **{f"serve {k}": r["launches"][kname]
                   for k, r in q_serve.items()},
                **{f"train {k} (rollout + {SINGLE_CHIP_STEPS} steps)":
                   r["launches"][kname]
                   for k, r in q_train.items()}},
            "max_abs_err": max(c["err"] for c in checked),
            **{k: main[k] for k in keys},
            "at": f"M {main['m']} K {main['k']} N {main['n']} "
                  f"{main['out']} out",
            "shapes": [{k: c[k] for k in ("m", "k", "n", "out", "variant",
                                          "err", *keys)} for c in cases]})
    return out


def heads_kernel_entries(heads, train):
    """The kernels line's entries of #4 and #5: launches over the bf16
    training run; numbers of the launch over a stream's three tensors at
    the response stream's shape, as the path runs it, with the prefix's,
    three single launches' and one tensor's beside."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    out = []
    for kname, line, multi, one, what in (
            ("scatter_heads", "582", "scatter_qkv", "scatter",
             "q and k with RoPE and v in one launch"),
            ("gather_heads", "602", "gather_qkv", "gather",
             "dQ and dK with the inverse RoPE and dV in one launch, dK "
             "and dV slices of [6,1599,32,128] at 703")):
        r, p = heads["response"][multi], heads["prefix"][multi]
        out.append({
            "name": kname, "route": "cuda",
            "source": "opadpo_torch/csrc/heads_layout.cu",
            "replaces": f"opadpo_tpu/ops/attention.py:{line}",
            "launches": train["launches"][kname],
            "launches_per_train_step": train["launches_per_step"][kname],
            "max_abs_err": max(x[c]["err"] for x in heads.values()
                               for c in (multi, one)),
            **{k: r[k] for k in keys}, "library_ms": None,
            "at": f"[6,896,4096] bf16, 32 heads of 128 (response stream), "
                  f"{what}; no one PyTorch call computes it",
            "design": "tma-tiles+tables-in-registers+tma-store",
            "prefix": {k: p[k] for k in keys},
            "three_single_ms": {n: h[multi]["three_single_ms"]
                                for n, h in heads.items()},
            "one_tensor": {n: {k: h[one][k] for k in keys}
                           for n, h in heads.items()}})
    return out


def slice4_kernel_entries(decode, rollout, spec):
    """The kernels line's entries of #7 and #8: launches over path A / B,
    numbers at the main-path shape, the other shapes beside."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    out = []
    for kname, group, line, launches, at in (
            ("decode_attention_int4", "int4", "97",
             rollout["launches"]["decode_attention_int4"],
             "[8,32,768,128] packed int4 (1536 positions), s_used 768 (7B "
             "rollout decode step, one layer, first chunk)"),
            ("decode_attention_multi", "multi", "359",
             sum(spec[a]["launches_multi"] for a in ("per_row", "shared")),
             "[8,32,768,128] int8, G 5 (k 4), s_used 768 (7B verify "
             "group, one layer)")):
        cases = decode[group]
        main_case = cases[0]
        out.append({
            "name": kname, "route": "cuda",
            "source": "opadpo_torch/csrc/decode_attention.cu",
            "replaces": f"opadpo_tpu/ops/decode_attention.py:{line}",
            "launches": launches,
            "max_abs_err": max(c["err_out"] for c in cases),
            **{k: main_case[k] for k in keys}, "library_ms": None,
            "at": at + "; no one PyTorch call computes it",
            "design": "cluster+bulk-async+dsmem-merge",
            "shapes": [{k: c[k] for k in ("s_used", "G", "err_out", "ranks",
                                          "per", "smem", *keys)}
                       for c in cases]})
    out[0]["path_a_weighted"] = decode["path_a_int4"]
    out[-1]["versus_int8"] = decode["versus_int8"]
    return out


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
    bwd = phase_flash_bwd(g, flush)
    heads = phase_heads(g, flush)
    decode = phase_decode(g, flush)
    qk = phase_quant(g, flush)
    del flush
    torch.cuda.empty_cache()
    for bits in (16, 8, 4):
        phase_reference(bits)
        phase_train_reference(bits)
    phase_tiny_f32_decode()
    serve, model, plain_answers = phase_main_path(card)
    rollout = phase_rollout_decode(model, card)
    spec = phase_spec_serve(model, card, plain_answers)
    torch.cuda.empty_cache()
    train = phase_train(model, card)
    q_serve, q_train = {}, {}
    q_serve["7b-int8"], q_train["7b-int8"] = phase_7b_int8(model, card)
    del model                       # the 13B phase runs without the 7B
    gc.collect()
    torch.cuda.empty_cache()
    q_serve["13b-int4"], q_train["13b-int4"] = phase_13b_int4(card)

    def pick(res, *keys):
        return {k: res[k] for k in keys}

    fl, dc, steps = (flash["llama"], decode["int8"][0],
                     train["launches_per_step"])
    times = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "opadpo_torch/csrc/flash_fwd.cu",
         "replaces": "opadpo_tpu/ops/attention.py:174",
         "launches": train["launches"]["flash_fwd"],
         "launches_per_train_step": steps["flash_fwd"],
         "launches_serving": serve["launches_flash"],
         "max_abs_err": max(f["err_o"] for f in flash.values()),
         "max_row_rel_err": max(f["err_o_row"] for f in flash.values()),
         **pick(fl, *times),
         "at": "[8,703,32,128] bf16 causal (LLaMA prefill)",
         "design": "tma+wgmma",
         "clip": pick(flash["clip"], *times),
         "response": pick(flash["response"], *times)},
    ]
    for kname, key in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
        r, p = bwd["response"], bwd["prefix"]
        outs = (key,) if key == "dq" else ("dk", "dv")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "opadpo_torch/csrc/flash_bwd.cu",
            "replaces": "opadpo_tpu/ops/attention.py:"
                        + ("263" if key == "dq" else "302"),
            "launches": train["launches"][kname],
            "launches_per_train_step": steps[kname],
            "max_abs_err": max(x["err"][n] for x in (r, p) for n in outs),
            "max_row_rel_err": max(x["row_err"][n] for x in (r, p)
                                   for n in outs),
            "ms": r[key + "_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r[key + "_bound_ms"],
            "bound_by": r[key + "_bound_by"], "library_ms": r["library_ms"],
            "share_of_bound": r[key + "_share_of_bound"],
            "design": "tma+wgmma",
            "at": "[6,896 over 1599,32,128] bf16 causal offset 703 "
                  "(response stream); plain and library compute dq, dk, dv "
                  "together",
            "prefix": {"ms": p[key + "_ms"], "plain_ms": p["plain_ms"],
                       "library_ms": p["library_ms"],
                       "bound_ms": p[key + "_bound_ms"],
                       "bound_by": p[key + "_bound_by"],
                       "share_of_bound": p[key + "_share_of_bound"]}})
    kernels += heads_kernel_entries(heads, train)
    kernels.append(
        {"name": "decode_attention_int8", "route": "cuda",
         "source": "opadpo_torch/csrc/decode_attention.cu",
         "replaces": "opadpo_tpu/ops/decode_attention.py:51",
         "launches": serve["launches_decode"],
         "max_abs_err": max(d["err_out"] for d in decode["int8"]),
         "ms": dc["ms"], "plain_ms": dc["plain_ms"],
         "bound_ms": dc["bound_ms"], "bound_by": dc["bound_by"],
         "library_ms": None,
         "at": "[8,32,768,128] int8, s_used 768 (7B decode step, one "
               "layer); no one PyTorch call computes it",
         "design": "cluster+bulk-async+dsmem-merge (#8's body at G 1)",
         "ranks": dc["ranks"], "per": dc["per"], "smem": dc["smem"],
         "split_ms_by_ranks": decode["int8_splits"]["ms_by_ranks"],
         "s_used_640": pick(decode["int8"][1], "ms", "plain_ms", "bound_ms",
                            "ranks", "per")})
    kernels += slice4_kernel_entries(decode, rollout, spec)
    kernels += quant_kernel_entries(qk, {"path-a": rollout, **q_serve},
                                    q_train)
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
