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
     at [6, 896 over 1599, 32, 128]) and at the CLIP tower's shape on the
     stage-3 path ([4, 577, 16, 64] bidirectional, no key mask): each
     output and each of its rows, two launches bitwise equal; their ptxas
     report (a spill, C7508 or C7514 fails), shared memory, and each
     kernel's share of its bound beside SDPA's backward and the WMMA
     kernels' earlier times;
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
     AdamW); one tiny OPA-SFT step with the vision adapter and the
     entropy branch (attention masking, one mask on both sides); then, in
     f32, greedy speculative decode (k 3, kv 16 and 8,
     both advances) token-exact against plain greedy on the GPU, and
     greedy int4 chunk-256 decode over 300 tokens (one fold) token-exact
     against the CPU; and the continuous slot pool in f32 (2 slots,
     segments of 4, staggered admission, a budget of 7, an EOS that frees
     a slot for a queued request) through the kernels token-exact against
     the same pool on the CPU on the int8 pool (#6), the int4 pool (#7)
     and with speculative segments at k 3 (#8), each decode kernel once
     per decoder layer per segment forward;
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
  12. the continuous slot pool behind the serve CLI's ``--continuous``
     worker on the same weights (16 slots, segments of 64, qlen 128, a
     cap of 256): 16 requests in two bursts with seeded budgets of 16 to
     256 tokens, on the int8 pool, the int4 pool and with speculative
     segments at k 4; no error, no request over its budget, #1 once per
     CLIP and decoder layer per admission group and #6 / #7 / #8 once per
     decoder layer per segment forward; generated tok/s, latency p50 /
     p99, segments, folds, admission groups, watermarks and peak memory;
     then #1 at the admission groups' shapes (1, 2, 4 prompts of 703
     positions) and #6, #7, #8 over a 16-slot pool at the watermarks the
     runs visited, against their plain versions;
  13. the training path, on the same 7B weights: ``rollout_score`` once,
     then 2 ``dpo_train_step``s at the reference recipe (per-device batch
     2, K = 3 responses of 896 tokens after a 128-token query, LoRA r 256,
     CoPO random, AncPO, AdamW lr 1e-6 with 5 warmup steps, clip 1.0);
     every loss and stat finite, the adapter moved by the last step, and
     the launch counters of kernels #1-#5 equal to the counts derived from
     the configuration;
  14. a checkpoint on disk: the same 7B weights written in the layout
     users download (original LLaVA, two ``pytorch_model-*.bin`` shards
     with their index and ``config.json``; the CLIP tower apart as
     ``model.safetensors`` through the port's writer, its 24th layer and
     ``post_layernorm`` random, for the loader to skip) and an r 256 /
     alpha 512 PEFT adapter, read back by ``setup_model(model_dir,
     vision_dir=...)`` and ``load_peft_adapter``: every tensor bitwise
     equal, with the bytes read, the load time and GB/s and the peak host
     RSS (free disk checked first: ~24 GB for these five phases);
  15. the serve CLI on that checkpoint: ``serve.parse_args`` and
     ``build_worker``, served as ``serve.main`` serves (an ephemeral
     port): step 9's nine requests give step 9's answers string for
     string, then with ``--adapter-path`` those of an in-memory worker
     with the same adapter; #1 and #6 launched as every prefill and
     decode step needs;
  16. stage 4 from that checkpoint: ``configs/llava_dpo.yaml`` through the
     port's YAML reader and overrides (r 256 / alpha 512, 2 steps of batch
     2, checkpoint every 2), ``opadpo_train.train`` over 4 seeded rows of
     the port's ``DPODataset`` / ``DPOCollator`` (query 128, responses
     896; PNG images through PIL, or seeded pixels where PIL is missing):
     2 finite log lines, ``checkpoint-2`` with a moved adapter,
     ``completed``, a second call returning at once, and #1-#5 launched as
     2 rollouts and 2 steps derive; the temporary directories go in a
     ``finally``;
  17. stages 1-2 from that checkpoint: ``configs/llava_online_generation.
     yaml`` (batch 8, responses cut to 128 tokens, bf16 KV, top-k 30,
     top-p 0.95), ``online_generation.run`` over 16 seeded prompts given
     in memory, a stub in place of the GPT-4V service (no network) and a
     dummy ``API_KEY``, so the threaded correction path runs: 2 shards,
     a report and a corrected response in every record, a second run a
     no-op, #1 once per block and layer per prefill; ``merge_and_filter``
     keeps the 16 rows;
  18. stage 3 from that checkpoint on those rows: ``configs/llava_opa.yaml``
     (r 256 / alpha 512, the vision tower tuned, per-device batch 4,
     accumulation cut to 2, 1 epoch), ``opa_train.train`` through the
     port's ``SFTDataset`` / ``SFTCollator`` over the first 8 rows: 4
     micro-steps of 4 rows of 1599 spliced positions, finite losses,
     ``checkpoint-final`` with moved vision and projector adapters, a
     decoder-only PEFT directory,
     ``completed``, and #1-#5 launched as ``expected_sft_launches``
     derives; micro-step time, positions per second and peak memory;
  19. the eval suite from that checkpoint: ``eval.run_all --benchmarks
     pope`` over three seeded POPE splits of 8 questions (PNG images;
     PIL required) at batch 8 and at ``--continuous-slots 16``, then
     ``eval.model_vqa_logit`` on one split, no judge stage: scores, each
     split's time, the answers both modes share, #1 and #6 launched as
     the batches and the pool's schedule derive;
  20. the quantized paths: the same 7B model quantized to int8 in place
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
  21. the native JPEG pipeline (``opadpo_torch/data/native_image.py``,
     right after the build): ``jpeglib.h`` probed with a one-line
     compile; where it is there, the library built at first use and 32
     seeded 640 x 480 JPEGs through one batch call within a mean |diff|
     of 0.02 of PIL, both batch times; else the PIL path stated;
  22. visual-token pruning on the 7B from disk (after step 15): the serve
     CLI at ``--visual-tokens 144``, batch and ``--continuous``, prompts
     of qlen - 1 + 144 positions; the pruned bf16 Sampler's greedy tokens
     against a greedy loop over the pruned full forward, every first
     departure a near-tie and the first token's logits within a bf16
     limit of the forward's, beside the unpruned model's same reading;
     the prefill's time at 144 and 576 patches;
  23. after the multi-GPU phase: the slot pool and speculative decode at
     tensor parallelism 2 on the 13B int4 (one process first, then the
     split-K control in it, then two ranks, over gloo on one card): the
     rollout through the int4 pool, the int8 pool with speculative
     segments at k 4 and the speculative Sampler with both advances;
     tokens equal on both ranks, budgets kept, every first departure from
     one process a near-tie, |logits(TP) - logits(one)| within twice the
     control's and the first-token logits within 1e-3 of the control's,
     #7 / #8 launches per rank as derived; then #6, #7 and #8 at the TP
     pool's shapes against their plain versions;
  24. after the eval suite, the port's tools (``opadpo_torch/tools/``) on
     the same 7B at short depths, each through its ``run(args, model=)``:
     bench_decode, bench_train (dpo, sft), bench_serve (both modes, then
     oracle drafts at k 4), bench_spec, bench_quality (int8, int4),
     profile_decode with summarize_trace on its trace, profile_serving
     --continuous (int8, spec k 4), profile_train --mode sft, e2e_rehearsal
     (the four stages and POPE) and bench_image_pipeline; every record's
     fields finite and positive, the quality and acceptance orderings, and
     each tool's launches as its shapes derive;
  25. after the serve CLI, the port's last counterparts of the JAX
     package: ``ops/image_ops.preprocess_images_device`` on 8 seeded 640
     x 480 uint8 frames on the card against the same function on the CPU
     and against PIL's ``clip_preprocess`` (the JAX test's bounds), timed;
     ``models/lora.merge_lora`` of the r 256 adapter into the 7B read from
     disk, the prefill logits of 2 prompts after the merge against the
     adapter's before it (#1 in each forward); and stage 4 at the 7B's
     widths cut to 2 decoder layers (batch 1, 2 steps) with
     ``profile_start_step`` 1, whose Chrome trace must hold #1-#5's CUDA
     kernels, beside a ``fused_attention: false`` config that must raise;
  26. one JSON line of the 11 kernels' numbers (with the slot pool's and
     the eval suite's launches and the pool-shape times of #1, #6, #7 and
     #8, the TP-2 and TP-pool shapes', and each tool's launches), the card
     line, and last ``{"ok": true, "device": {...}}``.

It needs a CUDA GPU and the repository around it: anywhere else it exits
non-zero before printing any result.  Kernel times are CUDA-event medians
of 20 launches with the L2 cache flushed (by a read) before each.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
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
    server, the collators and the rollout stage use.  Like the real one it
    keeps these serving prompts under 128 tokens (a character-level one
    would not), so a batch takes the shapes real traffic gives: qlen 128,
    703 positions with the image.  Ids lie in [3, 32000); BOS is 1, EOS 2,
    pad 0; "</s>" is EOS wherever it stands, as sentencepiece reads it, so
    the SFT labels' masking walk counts the templated turns as it does
    with the real tokenizer."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0
    padding_side = "right"
    model_max_length = 2048
    GLYPH = 30861        # '图', which the DPO collator turns into <image>

    def _id(self, w: str) -> int:
        if w == "</s>":
            return self.eos_token_id
        return self.GLYPH if w == "图" else 3 + zlib.crc32(w.encode()) % 31997

    def _ids(self, text: str):
        return [self.bos_token_id] + [
            self._id(w) for w in text.replace("</s>", " </s> ").split()]

    def __call__(self, text, padding=None, truncation=False,
                 max_length=None):
        """One text -> its ids; a list -> padded rows (``padding``
        "max_length" or longest, on ``padding_side``) with their
        attention masks, as the DPO collator calls it."""
        if isinstance(text, str):
            ids = self._ids(text)
            if truncation and max_length:
                ids = ids[:max_length]
            return types.SimpleNamespace(input_ids=ids,
                                         attention_mask=[1] * len(ids))
        import numpy as np

        rows = [self._ids(x)[:max_length] if truncation and max_length
                else self._ids(x) for x in text]
        width = (max_length if padding == "max_length"
                 else max(len(r) for r in rows))
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            r = r[:width]
            if self.padding_side == "left":
                ids[i, width - len(r):], mask[i, width - len(r):] = r, 1
            else:
                ids[i, :len(r)], mask[i, :len(r)] = r, 1
        return types.SimpleNamespace(input_ids=ids, attention_mask=mask)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special = (self.bos_token_id, self.eos_token_id, self.pad_token_id)
        return " ".join(f"<{int(i)}>" for i in ids
                        if not (skip_special_tokens and i in special))

    def batch_decode(self, rows, skip_special_tokens: bool = True) -> list:
        return [self.decode(r, skip_special_tokens) for r in rows]


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


def _flash_case(b, sq, skv, h, d, causal, g, flush, mask_last=True):
    import torch
    import torch.nn.functional as F

    from opadpo_torch.ops import attention

    dev = "cuda"
    q = torch.randn(b, sq, h, d, generator=g, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(b, skv, h, d, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = torch.ones(b, skv, dtype=torch.int32, device=dev)
    for i in range(b - 1 if mask_last else b):
        mask[i, :17 * i] = 0                 # left padding, 0..102 rows
    if mask_last:
        mask[b - 1] = 0                      # one row masked everywhere
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


def _bwd_case(b, sq, skv, h, d, g, flush, causal=True):
    """Both backward kernels against the plain backward: causal, with keys
    left-padded by 29 per row (so the square case has fully masked rows,
    as a left-padded prefix does, with a zero output gradient, as nothing
    on the training path reads them), or, with ``causal`` False,
    bidirectional with no key mask (the CLIP tower's attention): each
    output within 2e-2 of its largest |ref|, each row within BWD_ROW_TOL
    (``bwd_row_err``), and a second launch bitwise equal to the first."""
    import torch
    import torch.nn.functional as F

    from opadpo_torch.ops import attention

    dev = "cuda"
    q, do = (torch.randn(b, sq, h, d, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = None
    if causal:
        mask = torch.ones(b, skv, dtype=torch.int32, device=dev)
        for i in range(b):
            mask[i, :29 * i] = 0
            do[i, :max(0, 29 * i - (skv - sq))] = 0
    scale = d ** -0.5
    o, lse = attention.flash_fwd_cuda(q, k, v, mask, causal, scale)
    inputs = attention.flash_bwd_inputs(q, k, v, mask, causal, o, lse, do)

    def kernels():
        dq = attention.flash_bwd_dq_cuda(q, k, v, mask, causal, scale, o,
                                         lse, do, inputs)
        dk, dv = attention.flash_bwd_dkv_cuda(q, k, v, mask, causal, scale,
                                              o, lse, do, inputs)
        return dq, dk, dv

    got, again = kernels(), kernels()
    ref = attention.flash_bwd_reference(q, k, v, mask, causal, scale, o, lse,
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
        q, k, v, mask, causal, scale, o, lse, do, inputs), flush)
    dkv_ms = time_ms(lambda: attention.flash_bwd_dkv_cuda(
        q, k, v, mask, causal, scale, o, lse, do, inputs), flush)
    plain_ms = time_ms(lambda: attention.flash_bwd_reference(
        q, k, v, mask, causal, scale, o, lse, do), flush)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=(_keep(mask, sq, skv, True) if causal
                               else None))
    dot = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), flush)
    pairs = b * h * _pairs(sq, skv, causal)
    q_bytes, kv_bytes = b * sq * h * d * 2, b * skv * h * d * 2
    # lse and delta [B, H, Sq] f32, and the key bias [B, Skv] f32 if masked
    stats = 2 * b * h * sq * 4 + (b * skv * 4 if causal else 0)
    dq_bound = _bound(3 * q_bytes + 2 * kv_bytes + stats, 6 * d * pairs)
    dkv_bound = _bound(2 * q_bytes + 4 * kv_bytes + stats, 8 * d * pairs)
    res = {"shape": [b, sq, skv, h, d], "causal": causal, "err": errs,
           "row_err": row_errs,
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
           "response": _bwd_case(6, 896, 1599, 32, 128, g, flush),
           # the CLIP tower's backward on the stage-3 path (vision adapter):
           # hd 64, bidirectional, no key mask, 577 = 9 x 64 + 1 rows
           "clip": _bwd_case(4, 577, 577, 16, 64, g, flush, causal=False)}
    for name, r in res.items():
        was = (" the WMMA kernels {} + {} ms (PERF.md);".format(
            *FLASH_BWD_WAS_MS[name]) if name in FLASH_BWD_WAS_MS else "")
        log(f"[flash_bwd] {name}: dQ {r['dq_ms']:.4f} ms = "
            f"{100 * r['dq_share_of_bound']:.1f} % of its "
            f"{r['dq_bound_ms']:.4f} ms bound ({r['dq_bound_by']}), dK/dV "
            f"{r['dkv_ms']:.4f} ms = {100 * r['dkv_share_of_bound']:.1f} % "
            f"of {r['dkv_bound_ms']:.4f} ({r['dkv_bound_by']}); pair "
            f"{r['dq_ms'] + r['dkv_ms']:.4f} ms, SDPA backward "
            f"{r['library_ms']:.4f} ms;{was} row errors {r['row_err']}")
    return res


# #4 and #5 before their redesigns (the per-head kernels, one CTA per 64
# rows of one head, one launch a tensor), ms per tensor: chip runs of
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, recorded in PERF.md
HEADS_WAS_MS = {"prefix": 0.0153, "response": 0.0354}
GATHER_WAS_MS = {"prefix": 0.0153, "response": 0.0360}


def _heads_case(b, s, g, flush, kv_len=None, h=32):
    """scatter (RoPE) and gather (inverse RoPE, strided [B, S, H, hd]
    gradient, as the backward kernels write it) at ``h`` heads of 128, the
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
    hd = 128
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
        # one read and one write of each [b, s, h x 128] bf16 tensor (no GQA:
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
    _head_routes(reset=True)
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
    # a chunk each: two scoring forwards, two policy forwards, their
    # recomputes and backwards
    heads = _check_head_routes(f"reference bits {bits}", 8 * -(
        -cfg.llama.vocab_size // 2000))
    return {"rollout_rel": e_roll, "loss_rel": e_loss, "grad_rel": e_grad,
            "step_rel": e_step, "head_products": heads}


def phase_sft_reference():
    """One tiny OPA-SFT step in bf16 on the GPU (kernels) against the same
    weights, adapter and batch on the CPU (plain versions): the vision and
    projector adapters on (B drawn non-zero), the entropy branch on with
    ``attention`` masking (each device draws the patch mask from a CPU
    generator of one seed, so both read one mask), right-padded rows.  The
    loss and stats, the adapter's gradients (all of it, and its vision and
    projector parts alone), the GPU's AdamW update against the CPU's from
    the same gradients, and #1-#5's launches against
    ``expected_sft_launches``.  The tiny CLIP runs 1 head of 64 instead of
    2 of 32: the backward kernels take head dims 64 and 128 only."""
    import copy
    import dataclasses

    import torch

    from opadpo_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from opadpo_torch.engine import sft as sft_engine
    from opadpo_torch.engine.train_state import AdamW, OptimizerConfig, \
        TrainState
    from opadpo_torch.models import llava
    from opadpo_torch.models.lora import LoraConfig, make_trainable, \
        named_leaves, tree_map

    tiny = llava.LlavaConfig.tiny()
    cfg = dataclasses.replace(tiny, vision=dataclasses.replace(
        tiny.vision, num_heads=1))
    g = torch.Generator(device="cpu").manual_seed(4)
    cpu_model = llava.init_params(cfg, g, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    lora = llava.init_lora(cfg, LoraConfig(rank=4, alpha=8.0), g,
                           include_vision=True)
    for path, t in named_leaves(lora):
        if path.endswith("/b"):
            t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    b, lq, lr = 2, 40, 88
    ids = torch.randint(5, cfg.llama.vocab_size, (b, lq + lr), generator=g)
    ids[:, 3] = IMAGE_TOKEN_INDEX
    labels = torch.where(torch.arange(lq + lr) >= lq, ids, IGNORE_INDEX)
    ids[1, -17:] = 0
    labels[1, -17:] = IGNORE_INDEX
    batch = {"input_ids": ids, "labels": labels,
             "attention_mask": ((ids != 0) | (labels != IGNORE_INDEX)).long(),
             "images": torch.randn(b, 28, 28, 3, generator=g)}
    sft = sft_engine.SftConfig(entropy_loss=True,
                               entropy_mask_method="attention",
                               entropy_mask_ratio=0.5, entropy_loss_coef=0.5)
    opt = AdamW(OptimizerConfig(learning_rate=1e-2, warmup_steps=0,
                                total_steps=10))

    def to(tree, dev):
        return tree_map(lambda x: x.to(dev), tree)

    counters = _counters()
    out = {}
    _head_routes(reset=True)
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        _reset(counters)
        state = TrainState.create(make_trainable(to(lora, dev)), opt.cfg)
        loss, stats = sft_engine.sft_loss(
            state.params, model, sft, to(batch, dev),
            torch.Generator(device="cpu").manual_seed(7))
        leaves = named_leaves(state.params)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out[dev] = (loss.item(), {k: v.item() for k, v in stats.items()},
                    dict(zip([p for p, _ in leaves], grads)), state)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _read(counters)
    want = {**expected_sft_launches(cfg, sft, vision=True),
            **{k: 0 for k in launches if k not in (
                "flash_fwd", "scatter_heads", "flash_bwd_dq",
                "flash_bwd_dkv", "gather_heads")}}
    check(launches == want, f"tiny SFT step launches {launches}, expected "
          f"{want}")
    (l_g, s_g, g_g, st_g), (l_c, s_c, g_c, st_c) = out["cuda"], out["cpu"]
    e_stats = {k: abs(s_g[k] - s_c[k]) / max(abs(s_c[k]), 1.0) for k in s_c}
    check(set(s_g) == set(s_c) == {"loss/base_sft", "loss/mask_sft",
                                   "loss/entropy", "loss/total"},
          f"SFT stats {sorted(s_g)}")
    check(all(math.isfinite(v) for v in s_g.values()),
          f"tiny SFT stats not finite: {s_g}")
    e_grad = {part: _rel([g_g[p] for p in g_g if p.startswith(part)],
                         [g_c[p] for p in g_c if p.startswith(part)])
              for part in ("/", "/vision/", "/projector/")}
    grads_g = [g_g[p] for p, _ in named_leaves(st_g.params)]
    before = [t.detach().clone() for _, t in named_leaves(st_g.params)]
    opt.apply_gradients(st_g, grads_g)
    opt.apply_gradients(st_c, [x.cpu() for x in grads_g])
    e_step = _rel([a.detach().cpu().float() - b0.cpu().float() for (_, a), b0
                   in zip(named_leaves(st_g.params), before)],
                  [a.detach().float() - b0.cpu().float() for (_, a), b0
                   in zip(named_leaves(st_c.params), before)])
    moved = {part: sum(int((a.detach() != b0).sum()) for (p, a), b0 in
                       zip(named_leaves(st_g.params), before)
                       if p.startswith(part))
             for part in ("/vision/", "/projector/")}
    log(f"[sft-reference] tiny bf16 SFT step (vision adapter, entropy "
        f"branch with attention masking) GPU vs CPU: loss {l_g:.5f} vs "
        f"{l_c:.5f}; stats rel err {e_stats} (tol 2e-2 of max(|cpu|, 1)); "
        f"LoRA grads rel L2 all / vision / projector "
        f"{[round(x, 5) for x in e_grad.values()]} (tol 5e-2); AdamW "
        f"update from the same gradients rel L2 {e_step:.3e} (tol 1e-2); "
        f"entries moved {moved}; launches {want}")
    check(max(e_stats.values()) <= 2e-2,
          "tiny SFT loss or stats disagree with the CPU reference")
    check(max(e_grad.values()) <= 5e-2,
          "tiny SFT gradients disagree with the CPU reference")
    check(e_step <= 1e-2, "tiny SFT AdamW step disagrees with the CPU")
    check(min(moved.values()) > 0, f"vision / projector adapter did not "
          f"move: {moved}")
    # a chunk each: the base and the masked readout, forward, recompute
    # and backward
    heads = _check_head_routes("sft-reference", 6 * -(
        -cfg.llama.vocab_size // 2000))
    return {"stats_rel": e_stats, "grad_rel": e_grad, "step_rel": e_step,
            "launches": launches, "head_products": heads}


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
    from opadpo_torch.serve import InferenceWorker

    return _serve_worker(InferenceWorker(model, cfg, WordTokenizer(),
                                         **worker_kw), reqs, warm)


def _serve_worker(worker, reqs, warm=True, args=None):
    """``_serve`` for a worker already built, behind the server that
    ``serve.main`` starts for ``args`` (a server on an ephemeral local port
    without them); the worker is closed at the end."""
    from http.server import ThreadingHTTPServer

    from opadpo_torch.serve import make_handler, make_server

    server = (make_server(args, worker) if args is not None else
              ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker)))
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
PATH_A_NEW = 384        # the smoke's path-A run: 1.5 chunks, one fold


def phase_rollout_decode(model, card):
    """Path A, the rollout recipe's decode served
    (``configs/llava_online_generation.yaml``: int4 prompt KV, int4 head,
    chunk 256, temperature 1.0, top-k 30, top-p 0.95; PATH_A_NEW new
    tokens of the recipe's 896) at batch 8: 8 concurrent requests, one
    batch.  Prompts of qlen 128 give 703 positions, an int4 cache
    preallocated at 768 + 256 = 1024, two chunks reading to 768 and 1024,
    one fold (fewer if every row ends early: derived from the decode
    forwards).  #7 must run
    once per layer per decode forward, #6 and #8 never, #11 (the int4
    head) once per prefill and per decode forward."""
    import torch

    cfg = model.cfg
    prompts = [f"Describe region {i} of the image and what it shows."
               for i in range(8)]
    torch.cuda.reset_peak_memory_stats()
    results, stats, launches, wall = _serve(
        model, cfg, [{"prompt": p} for p in prompts], warm=False,
        max_batch=8, max_new_tokens=PATH_A_NEW, kv_bits=4,
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
    n_chunks = -(-PATH_A_NEW // ROLLOUT_CHUNK)
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
    server-shaped batch of ``prompts``, decoded from one prefill, judged by
    ``tools/bench_spec``'s recorder and rule (``LogitRecorder``,
    ``first_departures``): plain greedy's top-2 logit gap at that position
    against the largest |logits(#8) - logits(#6)| over the vocabulary at it
    (both paths emitted the same tokens before it); rounding only where
    the gap is the smaller.  Returns the first departure of each row that
    departs and the verdict."""
    import torch

    from opadpo_torch.engine import speculative
    from opadpo_torch.engine.sampler import Sampler, decode_loop_unrolled
    from opadpo_torch.engine.serving_config import make_serving_sampling
    from opadpo_torch.tools.bench_spec import LogitRecorder, first_departures

    dev = next(model.parameters()).device
    sampling = make_serving_sampling(greedy=True, max_new_tokens=max_new,
                                     eos_token_id=2, pad_token_id=0)
    ids, mask, images = _server_batch(model.cfg, prompts, rows, dev)
    with torch.inference_mode():
        pf = Sampler(sampling, kv_bits=8).prefill(model, ids, mask, images)
        args = (model, pf["kv_list"], pf["key_mask"], pf["next_position"],
                pf["last_logits"], None, sampling)
        with LogitRecorder() as rec:
            out_plain, _ = decode_loop_unrolled(*args)
            out_spec, st = speculative.decode_loop_spec(
                *args, speculative.SpecConfig(k=k, advance="per_row"))
    n = len(prompts)
    departures = first_departures(out_plain[:n].cpu(), out_spec[:n].cpu(),
                                  rec.plain, rec.verify, st["advances"])
    fault = [d for d in departures if not d.get("near_tie")]
    return {"rows_departing": len(departures), "of": n,
            "departures": departures,
            "verdict": ("no departure" if not departures else
                        "fault" if fault else "rounding")}


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


def _head_routes(reset: bool = False) -> dict:
    """The head's chunk products by route (``ops/logprobs.head_products``:
    ``tc`` the tensor cores, ``f32`` the upcast products)."""
    from opadpo_torch.ops import logprobs

    if reset:
        for c in logprobs.head_products.values():
            c.launches = 0
    return {k: c.launches for k, c in logprobs.head_products.items()}


def _check_head_routes(label: str, per_device: int) -> dict:
    """The same calls on both devices: the card's bf16 head products all
    on the tensor cores, the CPU's all upcast, ``per_device`` each."""
    heads = _head_routes()
    log(f"[{label}] head chunk products by route {heads}")
    check(heads == {"tc": per_device, "f32": per_device},
          f"{label}: head chunk products {heads}, expected {per_device} "
          f"on each route")
    return heads


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
    v, d = model.llama.lm_head.weight.shape     # this rank's vocabulary
    head = [types.SimpleNamespace(bits=head_bits, out_features=v,
                                  in_features=d)]
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


def expected_sft_launches(cfg, sft, vision: bool) -> dict:
    """Launches of kernels #1-#5 in one ``sft_train_step``, derived from
    the configuration.  Each forward runs the CLIP tower (one flash
    forward per active block) and the decoder over the whole spliced
    sequence (per layer one flash forward and one scatter launch for q, k
    and v); the backward recomputes each decoder layer (remat), and with
    the vision adapter each CLIP block too, so their forward kernels run
    twice, and adds one dQ and one dK/dV launch per recomputed layer or
    block and one gather launch per decoder layer.  Without the vision
    adapter nothing in the tower needs a gradient: it runs once and is not
    differentiated.  The entropy branch adds a second forward, which is
    differentiated too."""
    n_layers, n_clip = cfg.llama.num_layers, cfg.vision.num_active_layers
    clip_bwd = n_clip if vision else 0
    per = {"flash_fwd": n_clip + clip_bwd + 2 * n_layers,
           "scatter_heads": 2 * n_layers,
           "flash_bwd_dq": clip_bwd + n_layers,
           "flash_bwd_dkv": clip_bwd + n_layers,
           "gather_heads": n_layers}
    forwards = 2 if sft.entropy_loss else 1
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


def _gb(nbytes):
    return nbytes / 1e9


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _empty_cache(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _peak_rss_gb():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def phase_checkpoint(model, card, root):
    """The served and trained 7B bf16 weights written to disk in the
    layout users download (original LLaVA: two ``pytorch_model-*.bin``
    shards, their index and ``config.json``; the CLIP tower apart as
    ``model.safetensors`` through the port's writer, with a 24th layer and
    ``post_layernorm`` drawn at random, which the loader must skip) and an
    r 256 / alpha 512 PEFT adapter, then read back through
    ``setup_model(model_dir, vision_dir=...)`` and ``load_peft_adapter``:
    every tensor bitwise equal to the one in memory.  -> (result, the
    in-memory adapter, the directories)."""
    import torch

    from opadpo_torch.models import loader
    from opadpo_torch.models import safetensors_io as sio
    from opadpo_torch.models.lora import named_leaves
    from opadpo_torch.pipeline.runtime import setup_model
    from opadpo_torch.tools.profile_train import RECIPE_LORA, make_adapters

    cfg, dev = model.cfg, next(model.parameters()).device
    dirs = {k: os.path.join(root, k) for k in ("llava", "clip", "opa",
                                                "stage4", "stage12",
                                                "stage3")}
    adapter, _ = make_adapters(cfg, RECIPE_LORA,
                               torch.Generator(device=dev).manual_seed(5))
    n_lora = sum(t.numel() for _, t in named_leaves(adapter))
    model_bytes = sum(t.numel() * t.element_size()
                      for t in model.parameters())
    # base + CLIP, the f32 PEFT adapter, and stage 4's checkpoint-2 (f32
    # PEFT adapter, bf16 full adapter and two bf16 moments), deleted before
    # stage 3 writes checkpoint-final (about as large, with the vision
    # tower's and projector's few percent more and a bf16 accumulator)
    need = model_bytes + n_lora * (4 + 4 + 3 * 2) + n_lora * 2
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    log(f"[ckpt] {_gb(free):.1f} GB free at {root}; the five phases need "
        f"about {_gb(need):.1f} GB")
    check(free > 1.1 * need, f"only {_gb(free):.1f} GB free at {root}, "
          f"need {_gb(1.1 * need):.1f} GB for the checkpoint phases")

    rss = {"before": _peak_rss_gb()}
    t0 = time.perf_counter()
    shards = loader.save_llava_checkpoint(model, dirs["llava"], num_shards=2)
    clip = loader.clip_state_dict(model.vision)
    g = torch.Generator(device=dev).manual_seed(6)
    top = cfg.vision.num_layers - 1
    for name, w in loader.clip_state_dict(model.vision, "x.").items():
        if name.startswith("x.encoder.layers.0."):
            key = name.replace("x.encoder.layers.0.",
                               f"vision_model.encoder.layers.{top}.")
            clip[key] = (torch.randn(w.shape, generator=g, device=dev)
                         * 0.02).to(w.dtype)
    for part in ("weight", "bias"):
        clip[f"vision_model.post_layernorm.{part}"] = torch.randn(
            cfg.vision.hidden_size, generator=g, device=dev)
    os.makedirs(dirs["clip"])
    sio.save_file(clip, os.path.join(dirs["clip"], "model.safetensors"))
    loader.save_peft_adapter(adapter, dirs["opa"], RECIPE_LORA)
    write_s = time.perf_counter() - t0
    rss["written"] = _peak_rss_gb()
    sizes = {k: _dir_bytes(dirs[k]) for k in ("llava", "clip", "opa")}
    log(f"[ckpt] wrote {shards} ({_gb(sizes['llava']):.2f} GB), CLIP "
        f"{_gb(sizes['clip']):.3f} GB ({top + 1} layers + post_layernorm), "
        f"adapter {_gb(sizes['opa']):.3f} GB (f32, r {RECIPE_LORA.rank}) in "
        f"{write_s:.1f} s")

    _sync(dev)
    t0 = time.perf_counter()
    cfg2, loaded, _ = setup_model(dirs["llava"], vision_dir=dirs["clip"],
                                  device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lora = loader.load_peft_adapter(dirs["opa"], cfg.llama, device=dev)
    _sync(dev)
    adapter_s = time.perf_counter() - t0
    rss["loaded"] = _peak_rss_gb()
    check(cfg2 == cfg, f"config.json gave {cfg2}, not the 7B's {cfg}")
    want, got = model.state_dict(), loaded.state_dict()
    check(set(got) == set(want), "loaded parameter names differ")
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or not torch.equal(got[k], want[k])]
    check(not bad, f"{len(bad)} loaded tensors differ, e.g. {bad[:3]}")
    a, b = named_leaves(adapter), named_leaves(lora)
    check([p for p, _ in a] == [p for p, _ in b], "adapter entries differ")
    bad = [p for (p, x), (_, y) in zip(a, b)
           if x.dtype != y.dtype or not torch.equal(x, y)]
    check(not bad, f"{len(bad)} adapter tensors differ, e.g. {bad[:3]}")
    del loaded, lora, got
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    read = sizes["llava"] + sizes["clip"]
    res = {"model_gb": _gb(sizes["llava"]), "clip_gb": _gb(sizes["clip"]),
           "adapter_gb": _gb(sizes["opa"]), "write_s": write_s,
           "load_s": load_s, "load_gb_per_s": _gb(read) / load_s,
           "adapter_load_s": adapter_s,
           "adapter_gb_per_s": _gb(sizes["opa"]) / adapter_s,
           "peak_host_rss_gb": rss, "tensors_checked": len(want) + len(a),
           "card": card}
    log(f"[ckpt] setup_model read {_gb(read):.2f} GB in {load_s:.2f} s "
        f"({res['load_gb_per_s']:.2f} GB/s, file dtype to the card, cast "
        f"there); adapter {adapter_s:.2f} s ({res['adapter_gb_per_s']:.2f} "
        f"GB/s); peak host RSS (the process's, ru_maxrss) {rss['before']:.2f}"
        f" GB before this phase, {rss['written']:.2f} after writing, "
        f"{rss['loaded']:.2f} after loading; {res['tensors_checked']} "
        f"tensors bitwise equal; card: {card}")
    log(f"[ckpt] {json.dumps(res)}")
    return res, adapter, dirs


def phase_serve_cli(model, card, dirs, adapter, plain_answers):
    """``serve.parse_args`` / ``build_worker`` on the checkpoint written
    by ``phase_checkpoint``, served as ``serve.main`` serves it (its
    ``make_server``, on an ephemeral port): phase 9's nine requests
    give phase 9's answers, string for string, with every prefill and
    decode step on #1 and #6; then with ``--adapter-path`` the answers of
    an in-memory worker given the same adapter."""
    import torch

    from opadpo_torch import serve

    cfg, dev = model.cfg, next(model.parameters()).device
    prompts = [f"Describe object {i} in the image in detail."
               for i in range(8)]
    reqs = [{"prompt": p} for p in prompts]
    reqs.append({"prompt": prompts[0], "max_new_tokens": 8})
    argv = ["--model-path", dirs["llava"], "--vision-path", dirs["clip"],
            "--kv-bits", "8", "--max-new-tokens", "64", "--max-batch", "8",
            "--port", "0", "--device", dev.type]
    res = {"card": card}
    for label, extra in (("base", []), ("adapter",
                                        ["--adapter-path", dirs["opa"]])):
        args = serve.parse_args(argv + extra)
        t0 = time.perf_counter()
        worker = serve.build_worker(args, tokenizer=WordTokenizer())
        _sync(dev)
        build_s = time.perf_counter() - t0
        scaling = worker.sampler.lora_scaling
        results, stats, launches, wall = _serve_worker(worker, reqs,
                                                       args=args)
        del worker
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        texts = [r["text"] for r in results]
        _check_attention_launches(cfg, stats, launches)
        if label == "base":
            want = plain_answers
        else:
            check(scaling == 2.0, f"adapter scaling {scaling}, not 512 / 256")
            want = [r["text"] for r in _serve(
                model, cfg, reqs, lora=adapter, lora_scaling=2.0,
                max_batch=8, max_new_tokens=64, kv_bits=8,
                device=dev.type)[0]]
            check(want != plain_answers, "the adapter changed no answer")
        diff = [i for i, (a, b) in enumerate(zip(texts, want)) if a != b]
        check(not diff, f"CLI server ({label}) answers {diff} differ: "
              f"{[texts[i][:60] for i in diff]} vs "
              f"{[want[i][:60] for i in diff]}")
        res[label] = {"build_worker_s": build_s,
                      **_serve_metrics(stats, wall, len(reqs)),
                      "launches_flash": launches["flash_fwd"],
                      "launches_decode": launches["decode_attention_int8"]}
        log(f"[serve-cli] {label}: build_worker {build_s:.1f} s; "
            f"{len(reqs)} answers equal to the "
            f"{'phase-9' if label == 'base' else 'in-memory adapter'} "
            f"server's; launches flash {launches['flash_fwd']}, int8 decode "
            f"{launches['decode_attention_int8']}; card: {card}")
    log(f"[serve-cli] {json.dumps(res)}")
    return res


# the last counterparts of the JAX package (``phase_port_gaps``): the device
# preprocess on 8 seeded frames, on the card against the CPU (f32 products,
# TF32 off; the CPU test's bound against JAX) and against PIL at the JAX
# test's bounds; the merged 7B's prefill logits against the adapter's (a
# bf16 limit: the merged weights are rounded to bf16 once, the adapter
# path adds its f32 delta before each cast; the CPU test's f32 bound is
# 1e-5); the stage-4 trace's kernels
GAPS_SEED = 19
GAPS_FRAMES = 8
GAPS_PREPROCESS_ABS = 1e-4
GAPS_HOST_MEAN, GAPS_HOST_P95 = 0.05, 0.2
GAPS_MERGE_ABS = 0.5
GAPS_LAYERS = 2
GAPS_TRACE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                      "flash_bwd_dkv_kernel", "scatter_heads_kernel",
                      "gather_heads_kernel")


def _gaps_frames():
    """8 seeded 640 x 480 uint8 frames: a coarse random grid upsampled,
    with a little noise (as ``phase_native_image``'s)."""
    import numpy as np

    rng = np.random.default_rng(GAPS_SEED)
    frames = []
    for _ in range(GAPS_FRAMES):
        base = rng.normal(size=(48, 64, 3))
        arr = np.kron(base, np.ones((10, 10, 1))) + rng.normal(
            0, 0.05, (480, 640, 3))
        frames.append(((arr - arr.min()) / (arr.max() - arr.min())
                       * 255).astype(np.uint8))
    return np.stack(frames)


def _gaps_preprocess(dev, flush):
    """``preprocess_images_device`` on the card against the CPU and PIL."""
    import numpy as np
    import torch

    from opadpo_torch.data.image_processing import clip_preprocess
    from opadpo_torch.ops.image_ops import preprocess_images_device

    frames = _gaps_frames()
    x = torch.from_numpy(frames)
    xd = x.to(dev)
    gpu = preprocess_images_device(xd)
    cpu = preprocess_images_device(x)
    err = float((gpu.cpu() - cpu).abs().max())
    check(gpu.dtype == torch.float32 and tuple(gpu.shape) == (
        GAPS_FRAMES, 336, 336, 3), f"preprocess gave {gpu.dtype} "
        f"{tuple(gpu.shape)}")
    check(err <= GAPS_PREPROCESS_ABS, f"preprocess on the card against the "
          f"CPU: max |diff| {err} > {GAPS_PREPROCESS_ABS}")
    res = {"frames": f"{GAPS_FRAMES} x 640x480 uint8", "max_abs_gpu_cpu": err,
           "ms": time_ms(lambda: preprocess_images_device(xd), flush)
           if dev.type == "cuda" else None}
    check(_have_pil(), "PIL is needed to hold the device preprocess "
          "against the host path")
    from PIL import Image

    host = np.stack([clip_preprocess(Image.fromarray(f)) for f in frames])
    diff = np.abs(host - gpu.cpu().numpy())
    res.update(host_mean_abs=float(diff.mean()),
               host_p95_abs=float(np.quantile(diff, 0.95)))
    check(res["host_mean_abs"] < GAPS_HOST_MEAN
          and res["host_p95_abs"] < GAPS_HOST_P95,
          f"preprocess against PIL: mean {res['host_mean_abs']}, p95 "
          f"{res['host_p95_abs']} (limits {GAPS_HOST_MEAN}, {GAPS_HOST_P95})")
    return res


def _gaps_merge(cfg, dirs, adapter, dev, counters):
    """``merge_lora`` of the r 256 adapter into the 7B read from disk: the
    prefill logits of 2 prompts with the adapter, then merged without it."""
    import torch

    from opadpo_torch.models import llava
    from opadpo_torch.models.lora import merge_lora
    from opadpo_torch.pipeline.runtime import setup_model
    from opadpo_torch.tools.profile_train import RECIPE_LORA

    _, model, _ = setup_model(dirs["llava"], vision_dir=dirs["clip"],
                              device=dev)
    ids, mask, images = _server_batch(cfg, list(TP_PROMPTS[:2]), 2, dev)
    scaling = RECIPE_LORA.scaling
    _reset(counters)
    with torch.inference_mode():
        out = llava.forward(model, ids, mask, images)
        base = out["logits"]
        valid = out["key_mask"].bool()
        adapted = llava.forward(model, ids, mask, images, lora=adapter,
                                lora_scaling=scaling)["logits"]
    _sync(dev)
    t0 = time.perf_counter()
    merge_lora(model, adapter, scaling)
    _sync(dev)
    merge_s = time.perf_counter() - t0
    with torch.inference_mode():
        merged = llava.forward(model, ids, mask, images)["logits"]
    launches = _read(counters)["flash_fwd"]
    err = float((merged - adapted).abs()[valid].max())
    effect = float((adapted - base).abs()[valid].max())
    del model, out, base, adapted, merged
    gc.collect()
    _empty_cache(dev)
    per = cfg.vision.num_active_layers + cfg.llama.num_layers
    check(launches == 3 * per, f"#1 launched {launches} times in 3 "
          f"forwards, expected {3 * per}")
    check(err <= GAPS_MERGE_ABS and err < effect,
          f"merged against adapter logits: max |diff| {err} (limit "
          f"{GAPS_MERGE_ABS}; the adapter moves them by {effect})")
    return {"merge_s": merge_s, "max_abs_logit_merged_vs_adapter": err,
            "max_abs_logit_adapter_vs_base": effect,
            "positions": int(valid.sum()), "launches_flash_fwd": launches}


def _gaps_model_dir(root) -> str:
    """A directory holding LLaVA-1.5-7B's ``config.json`` with its decoder
    cut to ``GAPS_LAYERS`` layers (random weights drawn at it)."""
    path = os.path.join(root, "llava7b_cut_config")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"hidden_size": 4096, "intermediate_size": 11008,
                   "num_hidden_layers": GAPS_LAYERS,
                   "num_attention_heads": 32, "num_key_value_heads": 32,
                   "vocab_size": 32000, "max_position_embeddings": 4096,
                   "rms_norm_eps": 1e-5, "mm_vision_select_layer": -2}, f)
    return path


def _gaps_profile(root, dev, counters):
    """Stage 4 at the 7B's widths, 2 decoder layers, batch 1, 2 steps, with
    ``profile_start_step`` 1: step 2 traced, the trace written when the
    run ends inside the window; its CUDA kernels hold #1-#5.  The same
    config with ``fused_attention: false`` raises."""
    import dataclasses

    from opadpo_torch.engine.dpo import DpoConfig
    from opadpo_torch.models.llava import LlavaConfig
    from opadpo_torch.pipeline import opadpo_train
    from opadpo_torch.pipeline.config import apply_overrides, load_config

    out = os.path.join(root, "stage4_profile")
    model_dir = _gaps_model_dir(root)

    def config(*extra):
        return apply_overrides(load_config(os.path.join(
            ROOT, "configs", "llava_dpo.yaml")), [
            f"base_model={model_dir}", "image_checkpoint=null",
            "policy_lora_dir=null", "model.skip_loading_weights=true",
            "training.max_step=2", "training.rollout_batch_size=1",
            "training.step_batch_size=1",
            "training.rollout_per_device_batch_size=1",
            "training.step_per_device_batch_size=1",
            "training.save_steps=100", "training.profile_start_step=1",
            f"training.output_dir={out}", f"training.device={dev.type}",
            *extra])

    l7 = LlavaConfig.llava_7b()
    cfg = dataclasses.replace(l7, llama=dataclasses.replace(
        l7.llama, num_layers=GAPS_LAYERS))
    module, tok, _ = _stage4_module(cfg)
    saved_env = {k: os.environ.pop(k) for k in _STAGE_ENV if k in os.environ}
    try:
        try:
            opadpo_train.train(config("training.fused_attention=false",
                                      f"training.output_dir={out}_unfused"),
                               tokenizer=tok, data_module=module)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None and "fused_attention" in raised,
              f"fused_attention: false on CUDA did not raise ({raised})")
        _reset(counters)
        t0 = time.perf_counter()
        timer = opadpo_train.train(config(), tokenizer=tok,
                                   data_module=module)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = _read(counters)
    finally:
        os.environ.update(saved_env)
    check(timer is not None and timer.summary()["train"]["count"] == 2,
          "the profiled stage-4 run did not take 2 steps")
    traces = os.listdir(os.path.join(out, "profile"))
    check(len(traces) == 1, f"profile/ holds {traces}")
    path = os.path.join(out, "profile", traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels)
             for k in GAPS_TRACE_KERNELS}
    check(all(found.values()), f"the trace's CUDA kernels lack "
          f"{[k for k, n in found.items() if not n]}")
    dpo = DpoConfig()
    per = {k: expected_launches(cfg, dpo, False)[k]
           + expected_launches(cfg, dpo, True)[k]
           for k in expected_launches(cfg, dpo, True)}
    want = {k: 2 * per.get(k, 0) for k in launches}
    check(launches == want, f"profiled stage-4 launches {launches}, "
          f"expected {want}")
    return {"train_s": wall, "trace": traces[0],
            "trace_mb": os.path.getsize(path) / 2 ** 20,
            "trace_kernel_events": len(kernels), "trace_kernels": found,
            "launches": launches}


def phase_port_gaps(cfg, card, dirs, adapter, root, device="cuda"):
    """The port's last counterparts of the JAX package on the card:
    ``preprocess_images_device``, ``merge_lora`` on the 7B from disk, and
    stage 4's ``profile_start_step`` trace (#1-#5 named in it) with the
    ``fused_attention: false`` refusal."""
    import torch

    from opadpo_torch.device import resolve_device

    dev = resolve_device(device)
    counters = _counters()
    t0 = time.perf_counter()
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    res = {"preprocess": _gaps_preprocess(dev, flush), "card": card}
    del flush
    res["merge"] = _gaps_merge(cfg, dirs, adapter, dev, counters)
    res["profile"] = _gaps_profile(root, dev, counters)
    res["launches"] = res["profile"]["launches"]
    res["seconds"] = time.perf_counter() - t0
    p, m, pr = res["preprocess"], res["merge"], res["profile"]
    log(f"[port-gaps] preprocess_images_device, {p['frames']}: "
        f"{p['ms']} ms on the card, max |GPU - CPU| "
        f"{p['max_abs_gpu_cpu']:.2e} (limit {GAPS_PREPROCESS_ABS}), against "
        f"PIL mean {p['host_mean_abs']:.4f} / p95 {p['host_p95_abs']:.4f}; "
        f"merge_lora (r 256 into the 7B from disk) {m['merge_s']:.3f} s, "
        f"max |merged - adapter| logit "
        f"{m['max_abs_logit_merged_vs_adapter']:.4f} (limit "
        f"{GAPS_MERGE_ABS}; the adapter moves them by "
        f"{m['max_abs_logit_adapter_vs_base']:.4f}); profiled stage 4 "
        f"({GAPS_LAYERS} layers) {pr['train_s']:.1f} s, trace "
        f"{pr['trace_mb']:.1f} MB, #1-#5 in it {pr['trace_kernels']}; phase "
        f"{res['seconds']:.1f} s; card: {card}")
    log(f"[port-gaps] {json.dumps(res)}")
    return res


# the pruned 7B: the patches kept (``--visual-tokens``), the greedy tokens
# held against the pruned full forward, and the prefill timing repeats;
# the largest |logits(Sampler) - logits(forward)| the first token may be
# drawn from: one prefill against one full forward of the same rows, the
# bf16 rounding of two schedules (twice the reading on an H100 80GB HBM3
# at 700 W, 0.1771, PERF.md)
PRUNE_K = 144
PRUNE_NEW = 32
PRUNE_TIMED = 5
PRUNE_PREFILL_ABS = 0.35


def phase_pruned_serve(model, card, dirs):
    """Visual-token pruning on the 7B from disk: the serve CLI's
    ``build_worker`` with ``--visual-tokens 144`` over the checkpoint, as a
    batch worker (kv 8, 8 requests: every prompt ``qlen - 1 + 144``
    positions, #1 and #6 as the batches derive) and as ``--continuous``
    (16 slots: ``sp_splice`` ``qlen - 1 + 144``, no request over its
    budget, #1 and #6 as the pool's schedule derives); on the in-memory
    model (the same weights) made pruned, the bf16 Sampler's greedy tokens
    against a greedy loop over the pruned full forward, every row's first
    departure a near-tie (the forward's top-2 gap smaller than the largest
    |logits(Sampler) - logits(forward)| there) and the first token's
    logits within PRUNE_PREFILL_ABS of the forward's (a limit the
    departures do not set), beside the same reading on the unpruned model
    (576 patches, the same rows: bf16 rounding of the two schedules sets
    both); and the prefill's time at 144 and at 576 patches."""
    import dataclasses

    import torch

    from opadpo_torch import serve
    from opadpo_torch.engine.sampler import Sampler
    from opadpo_torch.engine.serving_config import make_serving_sampling
    from opadpo_torch.models import llava

    t_phase = time.perf_counter()
    cfg, dev = model.cfg, next(model.parameters()).device
    prompts = [f"Describe object {i} in the image in detail."
               for i in range(8)]
    reqs = [{"prompt": p} for p in prompts]
    argv = ["--model-path", dirs["llava"], "--vision-path", dirs["clip"],
            "--kv-bits", "8", "--max-new-tokens", "64", "--max-batch", "8",
            "--port", "0", "--device", dev.type, "--visual-tokens",
            str(PRUNE_K)]
    res = {"card": card, "visual_tokens": PRUNE_K}
    pruned_cfg = dataclasses.replace(cfg, visual_tokens=PRUNE_K)

    # the batch worker
    args = serve.parse_args(argv)
    worker = serve.build_worker(args, tokenizer=WordTokenizer())
    check(worker.model.cfg.num_patches == PRUNE_K,
          f"--visual-tokens {PRUNE_K}: the worker's model keeps "
          f"{worker.model.cfg.num_patches} patches")
    results, stats, launches, wall = _serve_worker(worker, reqs, args=args)
    del worker
    gc.collect()
    torch.cuda.empty_cache()
    qlen = _server_batch(cfg, prompts, 8, dev)[0].shape[1]
    positions = sorted({s["prompt_positions"] for s in stats})
    check(positions == [qlen - 1 + PRUNE_K],
          f"pruned batches' prompt positions {positions}, not "
          f"{qlen} - 1 + {PRUNE_K}")
    _check_attention_launches(pruned_cfg, stats, launches)
    res["batch"] = {"prompt_positions": positions, "wall_s": wall,
                    **_serve_metrics(stats, wall, len(reqs)),
                    "launches_flash": launches["flash_fwd"],
                    "launches_decode": launches["decode_attention_int8"]}

    # the continuous worker
    args = serve.parse_args(argv[:argv.index("--max-batch")] + [
        "--continuous", "--max-batch", "16", "--port", "0", "--device",
        dev.type, "--visual-tokens", str(PRUNE_K)])
    worker = serve.build_worker(args, tokenizer=WordTokenizer())
    sp = worker.engine.sp_splice
    check(sp == args.query_len - 1 + PRUNE_K,
          f"pruned pool splice {sp}, not {args.query_len} - 1 + {PRUNE_K}")
    creqs = [{"prompt": p, "max_new_tokens": 16 + 6 * i}
             for i, p in enumerate(prompts + prompts)]
    results, secs, delta, launches, wall, peak = _serve_continuous(
        worker, creqs, "pruned continuous")
    _check_pool_launches(pruned_cfg, delta, launches,
                         "decode_attention_int8", "pruned continuous")
    del worker
    gc.collect()
    torch.cuda.empty_cache()
    res["continuous"] = {"sp_splice": sp, "wall_s": wall, "peak_gb": peak,
                         "tokens": delta["tokens"],
                         "generated_tok_per_s": delta["tokens"] / wall,
                         "launches_flash": launches["flash_fwd"],
                         "launches_decode": launches["decode_attention_int8"]}

    # the pruned Sampler against the pruned full forward, and the prefill
    sampling = make_serving_sampling(greedy=True, max_new_tokens=PRUNE_NEW,
                                     eos_token_id=-1, pad_token_id=0)
    ids, mask, images = _server_batch(cfg, prompts, 8, dev)
    full_cfg = model.cfg
    model.cfg = pruned_cfg
    try:
        with torch.inference_mode(), _DecisionLogits() as rec:
            toks = Sampler(sampling).generate(model, ids, mask, images)
        rec.place([(b, 0) for b in range(8)])
        cur_ids, cur_mask, naive, fwd = ids, mask, [], {}
        with torch.inference_mode():
            for p in range(PRUNE_NEW):
                lg = llava.forward(model, cur_ids, cur_mask, images,
                                   remat=False)["logits"][:, -1].float()
                fwd.update(((b, p), x) for b, x in enumerate(lg.cpu()))
                nxt = lg.argmax(-1)
                naive.append(nxt)
                cur_ids = torch.cat([cur_ids, nxt[:, None]], 1)
                cur_mask = torch.cat([cur_mask, torch.ones_like(
                    nxt)[:, None]], 1)
        naive = torch.stack(naive, 1).cpu()
        toks = toks.cpu()
        deps, _ = _first_departures(toks.tolist(), naive.tolist(),
                                    rec.store, fwd)
        # the first token's logits: one prefill against one full forward
        prefill_err = max(float((rec.store[(b, 0)] - fwd[(b, 0)]).abs()
                                .max()) for b in range(8))
        # the same reading on the unpruned model: 576 patches, same rows
        model.cfg = full_cfg
        one = make_serving_sampling(greedy=True, max_new_tokens=1,
                                    eos_token_id=-1, pad_token_id=0)
        with torch.inference_mode(), _DecisionLogits() as rec_full:
            Sampler(one).generate(model, ids, mask, images)
            lg_full = llava.forward(model, ids, mask, images,
                                    remat=False)["logits"][:, -1]
        rec_full.place([(b, 0) for b in range(8)])
        lg_full = lg_full.float().cpu()
        full_err = max(float((rec_full.store[(b, 0)] - lg_full[b]).abs()
                             .max()) for b in range(8))
        times = {}
        s = Sampler(make_serving_sampling(max_new_tokens=1), kv_bits=8)
        for label, c in ((str(PRUNE_K), pruned_cfg),
                         (str(full_cfg.num_patches), full_cfg)):
            model.cfg = c
            with torch.inference_mode():
                s.prefill(model, ids, mask, images)
                times[label] = time_ms(lambda: s.prefill(model, ids, mask,
                                                         images),
                                       torch.empty(0, device=dev),
                                       n=PRUNE_TIMED, warmup=1)
    finally:
        model.cfg = full_cfg
    near = sum(1 for d in deps if d.get("near_tie"))
    res["greedy"] = {"rows_equal": int((toks == naive).all(1).sum()),
                     "of": toks.shape[0], "tokens": PRUNE_NEW,
                     "first_departures": deps, "near_ties": near,
                     "prefill_logits_max_abs_diff": prefill_err,
                     "prefill_logits_max_abs_diff_unpruned": full_err,
                     "pruned_over_unpruned": prefill_err / max(full_err,
                                                               1e-30)}
    res["prefill_ms"] = times
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[pruned] --visual-tokens {PRUNE_K}: batch prompts {positions} "
        f"positions (qlen {qlen}); pool splice {sp}; continuous "
        f"{delta['tokens']} tokens in {wall:.2f} s; Sampler greedy "
        f"{res['greedy']['rows_equal']} of {toks.shape[0]} rows equal to "
        f"the pruned full forward's over {PRUNE_NEW} tokens, {len(deps)} "
        f"first departures, {near} near-ties; first-token logits max "
        f"|Sampler - forward| {prefill_err:.4g} (limit {PRUNE_PREFILL_ABS}), "
        f"{full_err:.4g} unpruned at {full_cfg.num_patches} patches; "
        f"prefill [8, {qlen}] (ms by patches kept) {times}; phase "
        f"{res['seconds']:.1f} s; card: {card}")
    check(near == len(deps), f"pruned Sampler: first departures from the "
          f"full forward that are not near-ties: {deps}")
    check(prefill_err <= PRUNE_PREFILL_ABS, f"pruned Sampler: first-token "
          f"logits max |Sampler - forward| {prefill_err} over "
          f"{PRUNE_PREFILL_ABS}")
    log(f"[pruned] {json.dumps(res)}")
    return res


# the native JPEG pipeline's batch: seeded 640 x 480 JPEGs
NATIVE_IMAGES = 32
NATIVE_TOL = 0.02           # mean |native - PIL|, the JAX package's bound


def phase_native_image(card):
    """The native JPEG pipeline (``opadpo_torch/data/native_image.py``):
    probed for ``jpeglib.h`` with a one-line compile; where the header is
    there, built at first use (a failed build fails the smoke), then 32
    seeded 640 x 480 JPEGs (PIL's encoder) through one batch call against
    PIL's ``clip_preprocess`` (mean |diff| < 0.02 each) and through
    ``preprocess_images``' dispatch, with both batch times (best of 3);
    without the header, the port answers through PIL, as the JAX package
    does."""
    import io

    import numpy as np

    from opadpo_torch.data import image_processing as ip
    from opadpo_torch.data import native_image

    t0 = time.perf_counter()
    cxx = shutil.which("g++")
    probe = None if cxx is None else subprocess.run(
        [cxx, "-x", "c++", "-fsyntax-only", "-"],
        input="#include <cstdio>\n#include <jpeglib.h>\n", text=True,
        capture_output=True, timeout=60)
    header = probe is not None and probe.returncode == 0
    res = {"card": card, "g++": cxx, "jpeglib_h": header,
           "cpus": os.cpu_count()}
    if not header:
        res["native"] = native_image.native_available()
        res["seconds"] = time.perf_counter() - t0
        log(f"[native-image] no jpeglib.h on this machine ({cxx or 'no g++'}"
            f"): the port preprocesses every image through PIL, as the JAX "
            f"package does; library loaded: {res['native']}; phase "
            f"{res['seconds']:.1f} s; card: {card}")
        return res
    ok = native_image.native_available()
    res["build_s"] = time.perf_counter() - t0
    check(ok, f"native image pipeline failed to build: "
          f"{native_image.build_error}")
    res["library"] = str(native_image.library_path().relative_to(ROOT))
    if not _have_pil():
        log(f"[native-image] built in {res['build_s']:.1f} s; no PIL, so no "
            "JPEG is made and nothing is compared")
        return res
    from PIL import Image

    rng = np.random.default_rng(17)
    jpegs = []
    for _ in range(NATIVE_IMAGES):
        base = rng.normal(size=(48, 64, 3))
        arr = np.kron(base, np.ones((10, 10, 1))) + rng.normal(
            0, 0.05, (480, 640, 3))
        arr = ((arr - arr.min()) / (arr.max() - arr.min()) * 255).astype(
            np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=90)
        jpegs.append(buf.getvalue())

    def best(fn, n=3):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t)
        return min(out) * 1e3

    nat = native_image.preprocess_jpeg_batch(jpegs)
    pil = np.stack([ip.clip_preprocess(Image.open(io.BytesIO(j)))
                    for j in jpegs])
    diffs = np.abs(nat - pil).mean(axis=(1, 2, 3))
    saved = ip._PIL_ONLY
    ip.set_pil_preprocess(False)
    try:
        dispatched = ip.preprocess_images(jpegs)
    finally:
        ip.set_pil_preprocess(saved)
    res.update(
        images=NATIVE_IMAGES, size="640x480",
        mean_abs_diff_max=float(diffs.max()),
        mean_abs_diff_mean=float(diffs.mean()),
        max_abs_diff=float(np.abs(nat - pil).max()),
        native_batch_ms=best(lambda: native_image.preprocess_jpeg_batch(
            jpegs)),
        pil_batch_ms=best(lambda: [ip.clip_preprocess(
            Image.open(io.BytesIO(j))) for j in jpegs]),
        seconds=time.perf_counter() - t0)
    log(f"[native-image] built {res['library']} in {res['build_s']:.1f} s; "
        f"{NATIVE_IMAGES} JPEGs 640x480: mean |native - PIL| per image at "
        f"most {res['mean_abs_diff_max']:.4f} (limit {NATIVE_TOL}); batch "
        f"{res['native_batch_ms']:.1f} ms native against "
        f"{res['pil_batch_ms']:.1f} ms PIL on {res['cpus']} CPUs; phase "
        f"{res['seconds']:.1f} s; card: {card}")
    check(bool(np.array_equal(dispatched, nat)),
          "preprocess_images did not send the JPEGs through the native batch")
    check(res["mean_abs_diff_max"] < NATIVE_TOL,
          f"native against PIL: mean |diff| {res['mean_abs_diff_max']} >= "
          f"{NATIVE_TOL}")
    return res


_STAGE_ENV = ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR", "IMAGE_DIR",
              "POLICY_LORA_DIR", "API_KEY", "API_KEY0", "API_NUM", "RANK",
              "WORLD_SIZE")


def _have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def _pixel_class(cls, have_pil):
    """``cls`` (a dataset of the port) as it is where PIL imports; else
    with the image decode alone replaced by seeded pixels through the CLIP
    normalisation, seeded from the row's ``image_bytes``."""
    if have_pil:
        return cls
    import numpy as np

    from opadpo_torch.data.image_processing import _normalise

    class SeededPixels(cls):
        def pixels(self, item):
            seed = zlib.crc32(str(item["image_bytes"]).encode())
            arr = np.random.default_rng(seed).integers(
                0, 256, (self.image_size, self.image_size, 3))
            return _normalise(arr.astype(np.float32))

    return SeededPixels


STAGE4_ROWS = 4


def _stage4_rows(have_pil):
    """Seeded stage-4 rows at the reference geometry: a query, three
    responses of 600-890 words (896 tokens after padding) and a GPT-4V
    report that splits the generated response into sentences and rewrites
    each; an image as PNG bytes when PIL imports, else a seed string."""
    import base64
    import io

    import numpy as np

    rng = np.random.default_rng(12)
    vocab = [f"w{i}" for i in range(5000)]

    def words(n):
        return " ".join(vocab[j] for j in rng.integers(0, len(vocab), n))

    rows = []
    for i in range(STAGE4_ROWS):
        sentences = [words(int(rng.integers(30, 60))) + "."
                     for _ in range(int(rng.integers(12, 16)))]
        rewritten = [words(int(rng.integers(30, 60))) + "."
                     for _ in sentences]
        report = {f"sentence {j + 1}": {
            "copied content": c, "score": int(rng.integers(1, 5)),
            "error type": ["image_recognition_error", "correct",
                           "language_comprehension_error"][j % 3],
            "rewritten content": r}
            for j, (c, r) in enumerate(zip(sentences, rewritten))}
        report["Added"] = {"rewritten content": words(12) + "."}
        row = {"queries": f"<image>\nDescribe image {i} in detail.",
               "standard_response": words(int(rng.integers(600, 890))),
               "original_generate_response": " ".join(sentences),
               "AI_pseudo_response": " ".join(rewritten),
               "AI_json_report": json.dumps(report),
               "image_bytes": f"seed {i}"}
        if have_pil:
            from PIL import Image

            arr = rng.integers(0, 256, (300, 400, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            row["image_bytes"] = base64.b64encode(buf.getvalue()).decode()
        rows.append(row)
    return rows


def _stage4_module(cfg):
    """(the in-memory data module of the smoke's stage-4 rows, its
    tokenizer, whether PIL made the images): the port's ``DPODataset`` and
    ``DPOCollator`` at query 128 / response 896."""
    from opadpo_torch.data.collators import DPOCollator
    from opadpo_torch.data.datasets import DPODataset

    have_pil = _have_pil()
    dataset = _pixel_class(DPODataset, have_pil)(
        _stage4_rows(have_pil), image_size=cfg.vision.image_size)
    tok = WordTokenizer()
    collator = DPOCollator(tok, query_len=128, response_len=896)
    probe = collator([dataset[0], dataset[1]])
    check(probe["queries"].shape == (2, 128)
          and probe["AI_pseudo_response"].shape == (2, 896),
          f"collated shapes {probe['queries'].shape}")
    check(all(int((q == -200).sum()) == 1 for q in probe["queries"]),
          "each query must hold one image token")
    return ({"train_dataset": dataset, "eval_dataset": None,
             "data_collator": collator}, tok, have_pil)


def _stage4_config(dirs, out, dev_type, per_dev=2, extra=()):
    """``configs/llava_dpo.yaml`` through the port's reader with the
    smoke's overrides: the checkpoint, the CLIP directory and the OPA
    adapter, r 256 / alpha 512, 2 steps of a global batch of 2
    (``per_dev`` rows a data rank), a checkpoint every 2."""
    from opadpo_torch.pipeline.config import apply_overrides, load_config

    return apply_overrides(load_config(os.path.join(ROOT, "configs",
                                                    "llava_dpo.yaml")), [
        f"base_model={dirs['llava']}", f"image_checkpoint={dirs['clip']}",
        f"policy_lora_dir={dirs['opa']}", "training.lora_r=256",
        "training.lora_alpha=512", "training.max_step=2",
        "training.rollout_batch_size=2", "training.step_batch_size=2",
        f"training.rollout_per_device_batch_size={per_dev}",
        f"training.step_per_device_batch_size={per_dev}",
        "training.save_steps=2", f"training.output_dir={out}",
        f"training.device={dev_type}", *extra])


def phase_stage4(cfg, card, dirs, train_res, device="cuda"):
    """Stage 4 from the checkpoint: ``configs/llava_dpo.yaml`` through the
    port's reader with overrides (the checkpoint, the CLIP directory and
    the OPA adapter; r 256 / alpha 512; 2 steps of batch 2, checkpoint
    every 2), ``opadpo_train.train`` over 4 seeded rows built by the
    port's ``DPODataset`` and ``DPOCollator``: 2 finite log lines,
    ``checkpoint-2`` with a moved adapter, ``completed``, a second call
    that returns at once, and #1-#5 launched as 2 rollouts and 2 train
    steps derive."""
    import numpy as np

    from opadpo_torch.device import resolve_device
    from opadpo_torch.engine.dpo import DpoConfig
    from opadpo_torch.models.loader import load_peft_adapter
    from opadpo_torch.models.lora import named_leaves
    from opadpo_torch.pipeline import opadpo_train

    module, tok, have_pil = _stage4_module(cfg)
    log("[stage4] images: " + ("PNG bytes through PIL" if have_pil
                                else "seeded pixel arrays (no PIL here)"))
    out, dev = dirs["stage4"], resolve_device(device)
    tcfg = _stage4_config(dirs, out, dev.type)
    saved_env = {k: os.environ.pop(k) for k in _STAGE_ENV if k in os.environ}
    counters = _counters()
    try:
        _reset(counters)
        t0 = time.perf_counter()
        timer = opadpo_train.train(tcfg, tokenizer=tok, data_module=module)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = _read(counters)
        t0 = time.perf_counter()
        again = opadpo_train.train(tcfg, tokenizer=tok, data_module=module)
        again_s = time.perf_counter() - t0
    finally:
        os.environ.update(saved_env)
    check(timer is not None and again is None and again_s < 30,
          f"the completed run did not return at once ({again_s:.1f} s)")
    with open(os.path.join(out, "train_log.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    check(len(lines) == 2 and all(np.isfinite(x["loss/total"])
                                  for x in lines),
          f"train_log.jsonl: {lines}")
    ckpt = os.path.join(out, "checkpoint-2", "adapter_model", "lora_policy")
    check(os.path.exists(os.path.join(out, "completed")), "no completed")
    start = load_peft_adapter(dirs["opa"], cfg.llama, device=dev)
    end = load_peft_adapter(ckpt, cfg.llama, device=dev)
    moved = sum(int((x != y).sum()) for (_, x), (_, y) in
                zip(named_leaves(start), named_leaves(end)))
    del start, end
    check(moved > 0, "checkpoint-2's adapter equals the starting one")
    dpo = DpoConfig()
    per = {k: expected_launches(cfg, dpo, False)[k]
           + expected_launches(cfg, dpo, True)[k]
           for k in expected_launches(cfg, dpo, True)}
    want = {k: 2 * per.get(k, 0) for k in launches}
    check(launches == want, f"stage-4 launches {launches}, expected {want}")
    step_s = [x["objective/train_seconds"] for x in lines]
    res = {"train_s": wall, "rollout_s": [x["objective/rollout_seconds"]
                                          for x in lines],
           "step_s": step_s, "losses": [x["loss/total"] for x in lines],
           "phase12_step_s": train_res["step_s"],
           "adapter_entries_moved": moved,
           "checkpoint_gb": _gb(_dir_bytes(os.path.join(out,
                                                        "checkpoint-2"))),
           "launches": launches, "images": "pil" if have_pil else "seeded",
           "timers": timer.summary(), "card": card}
    log(f"[stage4] train() {wall:.1f} s (load, 2 rollouts, 2 steps, "
        f"checkpoint-2 {res['checkpoint_gb']:.2f} GB); dpo step "
        f"{[round(x, 3) for x in step_s]} s beside the training phase's "
        f"{[round(x, 3) for x in train_res['step_s']]} s; losses "
        f"{res['losses']}; {moved} adapter entries moved; a second call "
        f"returned in {again_s:.2f} s; card: {card}")
    log(f"[stage4] {json.dumps(res)}")
    return res


STAGE12_ROWS = 16
STAGE12_NEW = 128           # the sampled responses' length in tokens
# the stage-3 rows' length in tokens: llava_opa.yaml's query_len 128 plus
# response_len 896, so the spliced sequence holds 1024 - 1 + 576 = 1599
SFT_TOKENS = 1024


def _sft_response_words(tok, query):
    """The number of words of a response that brings an SFT row of
    ``query`` to SFT_TOKENS tokens under ``tok`` (the template's turns
    around it counted by the port's own preprocessing)."""
    from opadpo_torch.data.tokenization import preprocess

    def length(n):
        source = [{"from": "human", "value": query},
                  {"from": "gpt", "value": " ".join(["w"] * n)}]
        return preprocess([source], tok, has_image=True)["input_ids"].shape[1]

    n = 900
    n += SFT_TOKENS - length(n)
    check(length(n) == SFT_TOKENS, "SFT row length is not linear in words")
    return n


def _stage12_rows(have_pil, n_words):
    """Seeded rollout prompts at the reference geometry: a question with
    one image, a ground-truth answer of ``n_words`` words, and an image
    as PNG bytes when PIL imports, else a seed string."""
    import base64
    import io

    import numpy as np

    rng = np.random.default_rng(14)
    vocab = [f"w{i}" for i in range(5000)]
    rows = []
    for i in range(STAGE12_ROWS):
        row = {"queries": f"<image>\nDescribe image {i} in detail.",
               "standard_response": " ".join(
                   vocab[j] for j in rng.integers(0, len(vocab), n_words)),
               "image_id": f"smoke{i}.png", "image_bytes": f"seed {i}"}
        if have_pil:
            from PIL import Image

            arr = rng.integers(0, 256, (300, 400, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            row["image_bytes"] = base64.b64encode(buf.getvalue()).decode()
        rows.append(row)
    return rows


class CorrectorStub:
    """Stands in for the GPT-4V service: no network.  Every call returns
    a sentence-level report in a JSON fence, as the correction prompt asks
    for: the audited answer's first words copied with a score, and a
    rewrite of ``n_words`` words split between the sentence and the
    "Added" entry (so the corrected response fills stage 3's rows)."""

    model = "smoke-stub"

    def __init__(self, n_words: int):
        self.n_words = n_words
        self.calls = []

    def call_llm_with_messages(self, messages, **kw):
        text = messages[1]["content"][1]["text"]
        answer = text.split("Answer to audit: ")[1].split("\n")[0]
        self.calls.append(answer)
        words = [f"fix{j}" for j in range(self.n_words)]
        half = self.n_words // 2
        report = {
            "sentence_1": {"copied_content": " ".join(answer.split()[:20]),
                           "score": 2, "error_type": "image_recognition_error",
                           "object": "image",
                           "rewritten_content": " ".join(words[:half]),
                           "reason": "stub"},
            "Added": {"rewritten_content": " ".join(words[half:]),
                      "reason": "stub"}}
        return "```json\n" + json.dumps(report) + "\n```"


def phase_stages12(cfg, card, dirs, device="cuda"):
    """Stages 1-2 from the checkpoint: ``configs/llava_online_generation.
    yaml`` through the port's reader with overrides (the checkpoint and
    the CLIP directory, batch 8, ``response_len`` STAGE12_NEW; the rest the
    recipe: bf16 KV, temperature 1, top-k 30, top-p 0.95), and
    ``online_generation.run`` over 16 seeded prompt rows given in memory
    (``QueryDataset`` / ``QueryCollator``), with ``CorrectorStub`` in place
    of the module's ``get_api_service`` and a dummy ``API_KEY``, so the
    threaded correction path runs: 2 shards of 8 records, each with a
    report and a corrected response, a second run that samples nothing,
    #1 launched once per CLIP block and decoder layer per prefill and no
    other kernel (the bf16 cache decodes without one); then
    ``merge_and_filter`` keeps all 16 rows.  -> (result, merged records,
    the corrected response's word count)."""
    from opadpo_torch.data.collators import QueryCollator
    from opadpo_torch.data.datasets import QueryDataset
    from opadpo_torch.device import resolve_device
    from opadpo_torch.pipeline import dataset_ops, online_generation
    from opadpo_torch.pipeline.config import apply_overrides, load_config

    have_pil = _have_pil()
    tok = WordTokenizer()
    n_words = _sft_response_words(tok, "<image>\nDescribe image 0 in detail.")
    rows = _stage12_rows(have_pil, n_words)
    dataset = _pixel_class(QueryDataset, have_pil)(
        rows, tok, query_len=128, image_size=cfg.vision.image_size)
    module = {"train_dataset": dataset, "eval_dataset": None,
              "data_collator": QueryCollator()}
    out, dev = dirs["stage12"], resolve_device(device)
    gcfg = apply_overrides(load_config(os.path.join(
        ROOT, "configs", "llava_online_generation.yaml")), [
        f"base_model={dirs['llava']}", f"image_checkpoint={dirs['clip']}",
        "training.rollout_per_device_batch_size=8",
        f"training.response_len={STAGE12_NEW}",
        f"training.output_dir={out}",
        f"training.device={dev.type}"])
    stub = CorrectorStub(n_words)
    saved_env = {k: os.environ.pop(k) for k in _STAGE_ENV if k in os.environ}
    saved_service = online_generation.get_api_service
    counters = _counters()
    try:
        os.environ["API_KEY"] = "smoke-dummy"
        online_generation.get_api_service = (
            lambda rank=0, cache_path="": stub)
        _reset(counters)
        t0 = time.perf_counter()
        timer = online_generation.run(gcfg, tokenizer=tok,
                                      data_module=module)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = _read(counters)
        rollouts = os.path.join(out, "rollouts")
        shards = sorted(os.listdir(rollouts))
        mtimes = [os.path.getmtime(os.path.join(rollouts, n)) for n in shards]
        t0 = time.perf_counter()
        again = online_generation.run(gcfg, tokenizer=tok,
                                      data_module=module)
        again_s = time.perf_counter() - t0
    finally:
        online_generation.get_api_service = saved_service
        os.environ.pop("API_KEY", None)
        os.environ.update(saved_env)
    gc.collect()
    _empty_cache(dev)
    check(shards == ["step1_rank0.json", "step2_rank0.json"],
          f"rollout shards {shards}")
    records = []
    for name in shards:
        with open(os.path.join(rollouts, name)) as f:
            records.extend(json.load(f))
    check(len(records) == STAGE12_ROWS and len(stub.calls) == STAGE12_ROWS,
          f"{len(records)} records, {len(stub.calls)} correction calls")
    bad = [r["image_id"] for r in records
           if not (r["API_success"] and r["AI_json_report"]
                   and len(r["AI_pseudo_response"].split()) == n_words)]
    check(not bad, f"records without a report or correction: {bad}")
    check(again.history == [] and mtimes == [
        os.path.getmtime(os.path.join(rollouts, n)) for n in shards],
        "the second run was not a no-op")
    n_prefill = len(timer.history)
    want = {k: 0 for k in launches}
    want["flash_fwd"] = n_prefill * (cfg.vision.num_active_layers
                                     + cfg.llama.num_layers)
    check(launches == want, f"stage 1-2 launches {launches}, expected {want}")
    merged = dataset_ops.merge_and_filter([rollouts])
    resp_words = [len(r["original_generate_response"].split())
                  for r in records]
    check(len(merged) == STAGE12_ROWS, f"merge_and_filter kept "
          f"{len(merged)} of {STAGE12_ROWS} rows; response words "
          f"{resp_words}")
    sample_s = [e["seconds"] for e in timer.history]
    res = {"run_s": wall, "sample_s": sample_s, "steps": n_prefill,
           "rows": len(records), "response_words": resp_words,
           "corrected_words": n_words, "second_run_s": again_s,
           "kept_rows": len(merged), "launches": launches,
           "images": "pil" if have_pil else "seeded", "card": card}
    log(f"[stages12] run() {wall:.1f} s (load, 2 steps of 8 rows sampled to "
        f"{STAGE12_NEW} tokens at {[round(x, 2) for x in sample_s]} s, 16 "
        f"stubbed corrections); response words {resp_words}; a second run returned "
        f"in {again_s:.2f} s; merge_and_filter kept {len(merged)}; card: "
        f"{card}")
    log(f"[stages12] {json.dumps(res)}")
    return res, merged, n_words


# the OPA rows stage 3 trains on: 2 examples a row, 4 micro-steps of 4
STAGE3_ROWS = 8


def phase_stage3(cfg, card, dirs, merged, n_words, device="cuda"):
    """Stage 3 from the checkpoint: ``configs/llava_opa.yaml`` through the
    port's reader with overrides (the checkpoint and the CLIP directory,
    r 256 / alpha 512, 1 epoch, logging every micro-step; the recipe's
    per-device batch 4 and ``tune_vision_tower``, accumulation cut from 8
    to 2), ``opa_train.train`` over the first STAGE3_ROWS of
    ``merge_and_filter``'s 16 rows as the OPA dataset's columns hold them,
    through the port's ``SFTDataset`` / ``SFTCollator`` (16 examples: 4
    micro-steps of 4 rows of 1024 tokens, 1599 spliced positions, 2
    optimizer steps): a finite log line per
    micro-step; ``checkpoint-final`` whose ``adapter_full.pt`` holds vision
    and projector adapters whose B factors moved from zero, a PEFT
    directory with the decoder's entries only, ``completed``; #1-#5
    launched as ``expected_sft_launches`` says per micro-step."""
    import numpy as np
    import torch

    from opadpo_torch.data.collators import SFTCollator
    from opadpo_torch.data.datasets import SFTDataset
    from opadpo_torch.device import resolve_device
    from opadpo_torch.engine.sft import SftConfig
    from opadpo_torch.pipeline import dataset_ops, opa_train
    from opadpo_torch.pipeline.config import apply_overrides, load_config

    have_pil = _have_pil()
    tok = WordTokenizer()
    cols = dataset_ops.opa_columns(merged)
    rows = [dict(zip(cols, v)) for v in zip(*cols.values())][:STAGE3_ROWS]
    dataset = _pixel_class(SFTDataset, have_pil)(
        rows, tok, query_len=128, response_len=896,
        image_size=cfg.vision.image_size)
    collator = SFTCollator(tok)
    probe = collator([dataset[0], dataset[1], dataset[2], dataset[3]])
    check(probe["input_ids"].shape == (4, SFT_TOKENS),
          f"SFT rows {probe['input_ids'].shape}, not 4 x {SFT_TOKENS}")
    labelled = int((probe["labels"] != -100).sum())
    check(labelled > 4 * n_words, f"only {labelled} labelled tokens")
    module = {"train_dataset": dataset, "eval_dataset": None,
              "data_collator": collator}
    out, dev = dirs["stage3"], resolve_device(device)
    ocfg = apply_overrides(load_config(os.path.join(ROOT, "configs",
                                                   "llava_opa.yaml")), [
        f"base_model={dirs['llava']}", f"image_checkpoint={dirs['clip']}",
        "training.lora_r=256", "training.lora_alpha=512",
        "training.num_train_epochs=1",
        "training.gradient_accumulation_steps=2",
        "training.logging_steps=1", f"training.output_dir={out}",
        f"training.device={dev.type}"])
    t = ocfg.training
    check(int(t["per_device_train_batch_size"]) == 4
          and bool(t["tune_vision_tower"]) and not bool(t["entropy_loss"]),
          "llava_opa.yaml no longer holds the recipe's batch 4 with the "
          "vision tower tuned and the entropy branch off")
    saved_env = {k: os.environ.pop(k) for k in _STAGE_ENV if k in os.environ}
    counters = _counters()
    cuda = dev.type == "cuda"
    base_gb = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        _reset(counters)
        t0 = time.perf_counter()
        timer = opa_train.train(ocfg, tokenizer=tok, data_module=module)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = _read(counters)
    finally:
        os.environ.update(saved_env)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    gc.collect()
    _empty_cache(dev)
    micro = len(dataset) // 4
    check(len(timer.history) == micro == STAGE3_ROWS // 2,
          f"{len(timer.history)} micro-steps, expected {micro}")
    with open(os.path.join(out, "train_log.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    check(len(lines) == micro and all(
        np.isfinite(x["loss/total"]) and np.isfinite(x["loss/grad_norm"])
        for x in lines), f"train_log.jsonl: {lines}")
    final = os.path.join(out, "checkpoint-final")
    check(os.path.exists(os.path.join(out, "completed")), "no completed")
    full = torch.load(os.path.join(final, "adapter_full.pt"),
                      map_location="cpu", weights_only=True)
    moved = {part: sum(int((v != 0).sum()) for k, v in full.items()
                       if k.startswith(part) and k.endswith("/b"))
             for part in ("/vision/", "/projector/", "/llama/")}
    check(min(moved.values()) > 0, f"B entries moved from zero: {moved}")
    peft = torch.load(os.path.join(final, "adapter_model", "lora_policy",
                                   "adapter_model.bin"), map_location="cpu",
                      weights_only=True)
    check(len(peft) == 2 * 7 * cfg.llama.num_layers and all(
        k.startswith("base_model.model.model.layers.") for k in peft),
        f"the PEFT directory holds {len(peft)} entries beyond the decoder's")
    del full, peft
    per = expected_sft_launches(cfg, SftConfig(), vision=True)
    want = {k: micro * per.get(k, 0) for k in launches}
    check(launches == want, f"stage-3 launches {launches}, expected {want}")
    step_s = [e["seconds"] for e in timer.history]
    med = statistics.median(step_s[1:])
    positions = 4 * (SFT_TOKENS - 1 + cfg.num_patches)
    res = {"train_s": wall, "micro_step_s": step_s,
           "micro_step_s_median_after_first": med,
           "spliced_positions_per_micro_step": positions,
           "positions_per_s": positions / med,
           "peak_gb": peak_gb, "allocated_before_gb": base_gb,
           "losses": [x["loss/total"] for x in lines],
           "grad_norms": [x["loss/grad_norm"] for x in lines],
           "b_entries_nonzero": moved,
           "checkpoint_gb": _gb(_dir_bytes(final)),
           "launches_per_micro_step": per, "launches": launches,
           "images": "pil" if have_pil else "seeded", "card": card}
    log(f"[stage3] train() {wall:.1f} s (load, {micro} micro-steps of 4 x "
        f"1599 spliced positions, checkpoint-final {res['checkpoint_gb']:.2f} "
        f"GB); micro-step {[round(x, 3) for x in step_s]} s (median after "
        f"the first {med:.3f} s, {positions / med:.0f} positions/s); peak "
        f"{peak_gb:.2f} GB ({base_gb:.2f} GB held before train()); losses "
        f"{[round(x, 4) for x in res['losses']]}; launches {launches}; "
        f"card: {card}")
    log(f"[stage3] {json.dumps(res)}")
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


# -- multi-GPU: parallel/ under torch.distributed ----------------------------

# the 13B tensor-parallel rollout: rows and new tokens (greedy, int4 KV and
# head), and its prompts (the serving phase's shape: qlen 128, black images)
TP_ROWS = 8
TP_NEW = 16
TP_PROMPTS = tuple(f"Describe object {i} in the image in detail, with its "
                   f"colour, shape and place." for i in range(TP_ROWS))
# the bf16 tolerance the one-rank NCCL run is held to against phase_stage4
# (bitwise is expected: a one-rank all_reduce is a copy)
BF16_REL = 2.0 ** -7
# the 13B TP-2 run against one process, each limit set from readings on an
# H100 80GB HBM3 at 700 W (PERF.md, phase_multi_gpu; the reading in brackets):
# - the prefill logits against a control that does not depend on the TP
#   run: one process whose wo and w_down products are each split into the
#   two halves of K, rounded to bf16 and added in f32, as TP 2's partial
#   sums are, by plain PyTorch (``_split_row_products``): max |TP -
#   control| at most TP_CONTROL_ABS [1.4e-6], and max |TP - one| at most
#   TP_LOGIT_FACTOR times max |control - one| [both 0.3315]; the TP pool
#   (phase_tp_pool) is held to the same two limits against its own control
#   run, at every request's first token and over the decision logits;
# - the second step's loss movement (loss2 - loss1: the first step's loss
#   is the reference's, whatever the numerics) within TP_MOVE_REL of one
#   process's [0.031];
# - the first step's gradient norm (summed over the model group, each
#   replicated leaf once) within TP_GNORM_REL of one process's [0.0016];
# - the checkpoint-2 adapters' lora_B factors (zero before training, so
#   all of them is what the two steps moved) within TP_ADAPTER_REL of one
#   process's in relative Frobenius norm [0.285: Adam's first update is
#   +-lr an element, its sign flips where |g| is under the rounding; an
#   adapter that never moved gives 1].
TP_CONTROL_ABS = 1e-3
TP_LOGIT_FACTOR = 2.0
TP_MOVE_REL = 0.1
TP_GNORM_REL = 0.02
TP_ADAPTER_REL = 0.5
# the most device memory a rank may take reading the 7B checkpoint at TP 2,
# as a share of the checkpoint files' bytes: a rank holds half the decoder's
# linears and head (about 0.48 of the files), the embedding, the vision
# tower and one whole weight in flight
CKPT_TP_PEAK_SHARE = 0.7
# a rank's time limit (the two 13B ranks sharing one card over gloo)
RANK_TIMEOUT_S = 420


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(job: dict, world: int, local_ranks, label: str) -> list:
    """``job`` on ``world`` rank processes (``chip_smoke.py --rank-job``),
    each with the launcher's variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` from ``local_ranks``, ``MASTER_ADDR``, ``MASTER_PORT``)
    -> each rank's result.  A rank that fails or outlasts
    ``RANK_TIMEOUT_S`` fails the smoke; every process is stopped."""
    path = os.path.join(ROOT, "build", f"rank_job_{os.getpid()}_{label}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "job.json"), "w") as f:
        json.dump(job, f)
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k not in _STAGE_ENV}
        env.update(RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(local_ranks[r]), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=ROOT)
        logs.append(open(os.path.join(path, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--rank-job", path], env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT, cwd=ROOT))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, RANK_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(path, f"rank{r}.log")) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith("["):
                log(f"[multi_gpu {label} rank {r}] {line}")
        check(p.returncode == 0, f"multi_gpu {label}: rank {r} exited "
              f"{p.returncode}:\n{text[-3000:]}")
    out = []
    for r in range(world):
        with open(os.path.join(path, f"rank{r}.json")) as f:
            out.append(json.load(f))
    shutil.rmtree(path, ignore_errors=True)
    return out


def _peft(path):
    import torch

    return torch.load(os.path.join(path, "adapter_model", "lora_policy",
                                   "adapter_model.bin"), weights_only=True)


def _adapter_diff(a: dict, b: dict):
    """(largest |a - b| over the adapter, largest |b|, bitwise equal)."""
    check(set(a) == set(b), "adapter keys differ")
    diff = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    top = max(float(b[k].float().abs().max()) for k in b)
    return diff, top, all(bool((a[k] == b[k]).all()) for k in a)


class _DecisionLogits:
    """While installed (``with``), the logits each emitted token was chosen
    from, on the host in f32, keyed by (request, offset): the plain decode
    loop's ``sample_tokens`` calls or, in speculative decode, the first
    token's and each verify group's logits (``_accept_and_correct``),
    placed by the groups' advances.  The pool's steps place their own
    slots; after a Sampler's ``generate``, ``place`` files them with the
    batch row as the request.  Keeps each finished pool request's tokens
    and the last engine stepped."""

    def __init__(self):
        self.store, self.tokens, self.engine = {}, {}, None
        self.reset()

    def reset(self):
        self._steps, self._first, self._groups, self._spec = [], [], [], []
        self._slots = None

    def __enter__(self):
        from opadpo_torch.engine import continuous, sampler, speculative

        eng = continuous.ContinuousEngine
        self._saved = [(sampler, "sample_tokens"),
                       (speculative, "sample_tokens"),
                       (speculative, "_accept_and_correct"),
                       (speculative, "decode_loop_spec"),
                       (eng, "_admit_pending"), (eng, "step")]
        orig = self._orig = [getattr(o, n) for o, n in self._saved]
        rec = self

        def plain_tok(logits, cfg, gen=None):
            rec._steps.append(logits.float().cpu())
            return orig[0](logits, cfg, gen)

        def first_tok(logits, cfg, gen=None):
            rec._first.append(logits.float().cpu())
            return orig[1](logits, cfg, gen)

        def accept(logits_g, drafts, cfg, gen):
            rec._groups.append(logits_g.float().cpu())
            return orig[2](logits_g, drafts, cfg, gen)

        def spec_loop(*a, **kw):
            res = orig[3](*a, **kw)
            rec._spec.append(res[1])
            return res

        def admit(engine):
            orig[4](engine)
            rec._slots = [None if s is None or s.finished
                          else (s.request_id, s.emitted)
                          for s in engine._slots]

        def step(engine):
            rec.reset()
            out = orig[5](engine)
            rec.engine = engine
            if rec._slots is not None:
                rec.place(rec._slots)
            for rid, toks in out:
                rec.tokens[rid] = [int(x) for x in toks]
            return out

        for (o, n), fn in zip(self._saved, (plain_tok, first_tok, accept,
                                            spec_loop, admit, step)):
            setattr(o, n, fn)
        return self

    def __exit__(self, *exc):
        for (o, n), fn in zip(self._saved, self._orig):
            setattr(o, n, fn)

    def place(self, rows):
        """File what the last decode call recorded: ``rows`` [(request,
        offset of the call's first token) or None], by batch row."""
        for i, row in enumerate(rows):
            if row is None:
                continue
            key, e0 = row
            if not self._spec:
                for s, lg in enumerate(self._steps):
                    self.store[(key, e0 + s)] = lg[i].clone()
                continue
            self.store[(key, e0)] = self._first[-1][i].clone()
            e = 1
            for gi, adv in enumerate(self._spec[-1]["advances"]):
                for j in range(adv[i]):
                    self.store[(key, e0 + e + j)] = \
                        self._groups[gi][i, j].clone()
                e += adv[i]

    def rows(self, offset: int, n: int):
        """The logits at ``offset`` of requests 0 .. n - 1, stacked."""
        import torch

        return torch.stack([self.store[(i, offset)] for i in range(n)])


def _prefill_logits(model):
    """The logits the first token of ``_tp_rollout``'s rows is drawn from
    (the prefill alone), on the host in f32."""
    import torch

    from opadpo_torch.engine.sampler import Sampler
    from opadpo_torch.engine.serving_config import make_serving_sampling

    dev = next(model.parameters()).device
    sampling = make_serving_sampling(greedy=True, max_new_tokens=1,
                                     eos_token_id=2, pad_token_id=0)
    ids, mask, images = _server_batch(model.cfg, list(TP_PROMPTS), TP_ROWS,
                                      dev)
    with torch.inference_mode(), _DecisionLogits() as rec:
        Sampler(sampling, kv_bits=4, head_bits=4).generate(
            model, ids, mask, images)
    rec.place([(b, 0) for b in range(TP_ROWS)])
    return rec.rows(0, TP_ROWS)


def _dequantize_decoder(model) -> None:
    """Each quantized decoder linear of ``model`` replaced, in place and
    one at a time, by an ``nn.Linear`` in the model's dtype holding its
    dequantized weight (the plain ``dequantize_weight4``; products then go
    through ``torch.matmul``)."""
    import torch

    from opadpo_torch.ops.quant import (
        QuantLinear, dequantize_weight, dequantize_weight4,
    )

    dtype = model.llama.embed.dtype
    with torch.no_grad():
        for layer in model.llama.layers:
            for name, lin in list(layer.named_children()):
                if not isinstance(lin, QuantLinear):
                    continue
                w = (dequantize_weight4 if lin.bits == 4
                     else dequantize_weight)(lin.q, lin.scale, dtype)
                dense = torch.nn.Linear(lin.in_features, lin.out_features,
                                        bias=False, device="meta")
                dense.weight = torch.nn.Parameter(w, requires_grad=False)
                setattr(layer, name, dense)


def _split_row_products(model) -> None:
    """Each decoder layer's ``wo`` and ``w_down`` product computed, in this
    one process, as two model ranks compute it: each half of K through its
    own rank's shard (``shard_weight`` of an ``nn.Linear``, by plain
    PyTorch, or ``shard_quant`` of a ``QuantLinear``, by its kernel),
    rounded to the model dtype, the two added in f32 and rounded again (no
    adapter)."""
    import types

    from opadpo_torch.models.lora import lora_dense
    from opadpo_torch.ops.quant import QuantLinear
    from opadpo_torch.parallel.sharding import ROW, shard_quant, shard_weight

    def dense(layer, x, name, ll, scaling):
        if name not in layer.row_halves:
            return type(layer).dense(layer, x, name, ll, scaling)
        k = x.shape[-1] // 2
        lo, hi = (lora_dense(x[..., r * k:(r + 1) * k].contiguous(), w)
                  for r, w in enumerate(layer.row_halves[name]))
        return (lo.float() + hi.float()).to(x.dtype)

    for layer in model.llama.layers:
        layer.row_halves = {}
        for name in ("wo", "w_down"):
            lin = getattr(layer, name)
            layer.row_halves[name] = [
                shard_quant(lin, ROW, r, 2) if isinstance(lin, QuantLinear)
                else shard_weight(lin.weight, ROW, r, 2) for r in range(2)]
        layer.dense = types.MethodType(dense, layer)


def _lora_b_rel(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over the adapters' ``lora_B`` factors
    (zero before training, so ``want`` is what training moved)."""
    keys = [k for k in want if "lora_B" in k]
    check(keys and set(got) == set(want), "adapter keys differ")
    num = sum(float(((got[k].float() - want[k].float()) ** 2).sum())
              for k in keys)
    den = sum(float((want[k].float() ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def _tp_rollout(model, record=None):
    """Greedy rollout of ``TP_ROWS`` server-shaped rows x ``TP_NEW`` tokens
    over the int4 KV cache and the int4 head (#1 in the prefill, #7 every
    decode step, #11 in every decoder linear and the head), the launches
    checked against the Sampler's own schedule; the logits recorded into
    ``record`` (a ``_DecisionLogits``) when given."""
    import torch

    from opadpo_torch.engine.sampler import Sampler
    from opadpo_torch.engine.serving_config import make_serving_sampling
    from opadpo_torch.parallel import comm

    dev = next(model.parameters()).device
    sampling = make_serving_sampling(greedy=True, max_new_tokens=TP_NEW,
                                     eos_token_id=2, pad_token_id=0)
    ids, mask, images = _server_batch(model.cfg, list(TP_PROMPTS), TP_ROWS,
                                      dev)
    sampler = Sampler(sampling, kv_bits=4, head_bits=4)
    counters = _counters()
    with record or contextlib.nullcontext():
        _reset(counters)
        comm.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            tokens = sampler.generate(model, ids, mask, images)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read(counters)
    if record is not None:
        record.place([(b, 0) for b in range(TP_ROWS)])
    stats = list(sampler.stats)
    _check_attention_launches(model.cfg, stats, launches,
                              "decode_attention_int4")
    want = expected_quant_serving(model, stats, 4)
    got = {k: launches[k] for k in want}
    check(got == want, f"13B int4 rollout #11 launches {got}, expected "
          f"{want}")
    new = int((tokens != 0).sum())
    return {"tokens": tokens.cpu().tolist(), "wall_s": wall,
            "generated_tok_per_s": new / wall,
            "decode_steps": stats[-1]["decode_steps"],
            "launches": {k: v for k, v in launches.items() if v},
            "collectives": comm.counts()}


def _model_13b_dir(root) -> str:
    """A directory holding only LLaVA-1.5-13B's ``config.json`` (the port
    draws random weights at it with ``model.skip_loading_weights``)."""
    path = os.path.join(root, "llava13b_config")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"hidden_size": 5120, "intermediate_size": 13824,
                   "num_hidden_layers": 40, "num_attention_heads": 40,
                   "num_key_value_heads": 40, "vocab_size": 32000,
                   "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
                   "mm_vision_select_layer": -2}, f)
    return path


def _stage4_13b_config(model_dir, out, model: int):
    """Stage 4 on the 13B drawn into int4 from seed 0, its adapter fresh
    (r 64 / alpha 128, ``llava_dpo_13b_singlechip.yaml``'s), 2 steps of
    one row (``step_per_device_batch_size`` 1), ``mesh.model`` ``model``;
    no warmup and lr 1e-4, so that the first update moves the adapter off
    the reference (whose loss the first step's is, whatever the
    numerics) and the second step's loss tells the two runs apart."""
    from opadpo_torch.pipeline.config import apply_overrides, load_config

    return apply_overrides(load_config(os.path.join(ROOT, "configs",
                                                    "llava_dpo.yaml")), [
        f"base_model={model_dir}", "image_checkpoint=null",
        "policy_lora_dir=null", "model.skip_loading_weights=true",
        "training.bits=4", "training.lora_r=64", "training.lora_alpha=128",
        "training.max_step=2", "training.rollout_batch_size=1",
        "training.step_batch_size=1",
        "training.rollout_per_device_batch_size=1",
        "training.step_per_device_batch_size=1", "training.save_steps=2",
        "training.warmup_steps=0", "training.learning_rate=1e-4",
        "training.seed=0", f"training.output_dir={out}",
        "training.device=cuda", f"mesh.model={model}"])


def _stage4_13b(model_dir, out, model, exp):
    """Two stage-4 steps through ``opadpo_train.train`` (each rank's #1-#5
    against ``expected_launches``: every rank runs every layer on its own
    heads; #11 against ``exp``, worked out on the rank's shard) -> losses
    (rank 0), wall time, peak memory, collectives."""
    import torch

    from opadpo_torch.engine.dpo import DpoConfig
    from opadpo_torch.parallel import comm
    from opadpo_torch.pipeline import opadpo_train

    cfg13 = _llava_13b_cfg()
    module, tok, _ = _stage4_module(cfg13)
    tcfg = _stage4_13b_config(model_dir, out, model)
    counters = _counters()
    _reset(counters)
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timer = opadpo_train.train(tcfg, tokenizer=tok, data_module=module)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    dpo = DpoConfig()
    per = {k: expected_launches(cfg13, dpo, False)[k]
           + expected_launches(cfg13, dpo, True)[k]
           for k in expected_launches(cfg13, dpo, True)}
    want = {k: 2 * per[k] for k in per}
    got = {k: launches[k] for k in per}
    check(got == want, f"13B stage-4 launches {got}, expected {want}")
    want_q = {k: 2 * v for k, v in exp.items()}
    got_q = {k: launches[k] for k in exp}
    check(got_q == want_q, f"13B stage-4 #11 launches {got_q}, expected "
          f"{want_q}")
    res = {"wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: v for k, v in launches.items() if v},
           "collectives": comm.counts(), "timers": timer.summary()}
    log_path = os.path.join(out, "train_log.jsonl")
    if os.path.exists(log_path):
        with open(log_path) as f:
            lines = [json.loads(x) for x in f]
        res["losses"] = [x["loss/total"] for x in lines]
        res["grad_norms"] = [x["loss/grad_norm"] for x in lines]
        res["step_s"] = [x["objective/train_seconds"] for x in lines]
    return res


def _llava_13b_cfg():
    from opadpo_torch.models.llava import LlavaConfig

    return LlavaConfig.llava_13b()


def _expected_q4_train(model):
    """#11's launches in one 13B rollout_score plus one dpo_train_step at
    batch 1 on ``model`` (a rank's shard: its own linears' shapes)."""
    from opadpo_torch.engine.dpo import DpoConfig

    dpo = DpoConfig()
    a = expected_quant_train(model, dpo, 1, False)
    b = expected_quant_train(model, dpo, 1, True)
    return {k: a[k] + b[k] for k in a if a[k] + b[k]}


def _job_tp13b(job, rank):
    """A rank of the 13B tensor-parallel phase: the rollout on its shard
    (``setup_model`` over a ``1 x 2`` mesh), then two stage-4 steps."""
    import torch

    from opadpo_torch.parallel.mesh import MeshConfig, make_mesh
    from opadpo_torch.pipeline import runtime

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, model, mesh = runtime.setup_model(
        job["model_dir"], skip_loading_weights=True, bits=4, seed=0,
        mesh=make_mesh(MeshConfig(model=2), "cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(mesh.model == 2 and mesh.model_rank == rank,
          f"rank {rank}: mesh {mesh.data}x{mesh.model}")
    record = _DecisionLogits() if rank == 0 else None
    roll = _tp_rollout(model, record)
    roll["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if record is not None:
        torch.save(record.store, job["logits"])
    exp = _expected_q4_train(model)
    shapes = sorted({(m.out_features, m.in_features)
                     for m in _quant_layers(model)[1]})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train = _stage4_13b(job["model_dir"], job["out"], 2, exp)
    log(f"[tp13b] rank {rank}: setup {load_s:.1f} s; rollout "
        f"{roll['wall_s']:.2f} s; stage 4 {train['wall_s']:.1f} s, peak "
        f"{train['peak_gb']:.2f} GB; decoder shard shapes {shapes}")
    return {"load_s": load_s, "rollout": roll, "train": train,
            "shard_shapes": shapes, "device": torch.cuda.current_device()}


def _job_stage4(job, rank):
    """A rank of the 7B stage 4 from the smoke's checkpoint (``mesh.model``
    1): ``opadpo_train.train`` over the smoke's rows, ``per_dev`` rows a
    data rank."""
    import torch

    from opadpo_torch.models.llava import LlavaConfig
    from opadpo_torch.parallel import comm
    from opadpo_torch.pipeline import opadpo_train

    module, tok, _ = _stage4_module(LlavaConfig.llava_7b())
    tcfg = _stage4_config(job["dirs"], job["out"], "cuda", job["per_dev"])
    counters = _counters()
    _reset(counters)
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timer = opadpo_train.train(tcfg, tokenizer=tok, data_module=module)
    torch.cuda.synchronize()
    res = {"wall_s": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": _read(counters), "collectives": comm.counts(),
           "timers": timer.summary(),
           "device": torch.cuda.current_device(),
           "backend": torch.distributed.get_backend()}
    if rank == 0:
        with open(os.path.join(job["out"], "train_log.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        res["losses"] = [x["loss/total"] for x in lines]
        res["step_s"] = [x["objective/train_seconds"] for x in lines]
    return res


def _job_ckpt_tp(job, rank):
    """A rank of the 7B checkpoint read at tensor parallelism 2:
    ``setup_model`` of the smoke's checkpoint directory over a ``1 x 2``
    mesh (each decoder weight read from the mapped files, moved and cut
    before the next), every decoder tensor then held bitwise against its
    slice of the file, and the peak device memory against the files'
    bytes."""
    import torch

    from opadpo_torch.models import loader
    from opadpo_torch.parallel import sharding
    from opadpo_torch.parallel.mesh import MeshConfig, make_mesh
    from opadpo_torch.pipeline import runtime

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, model, mesh = runtime.setup_model(
        job["llava"], vision_dir=job["clip"],
        mesh=make_mesh(MeshConfig(model=2), "cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lm = model.llama
    rule = {id(lm.lm_head.weight): "lm_head"}
    for layer in lm.layers:
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            rule[id(getattr(layer, name).weight)] = name
    state = loader.load_state_dict(job["llava"])
    file_bytes = sum(t.numel() * t.element_size() for t in state.values())
    checked, differ = 0, []
    for name, slot in loader._llama_names(lm, "model."):
        want = state[name].to(slot.device).to(slot.dtype)
        if id(slot) in rule:
            want = sharding.shard_weight(
                want, sharding.split_of(rule[id(slot)]), mesh.model_rank,
                mesh.model)
        checked += 1
        if not torch.equal(slot, want):
            differ.append(name)
    log(f"[ckpt_tp] rank {rank}: setup_model {load_s:.1f} s, peak "
        f"{peak / 1e9:.2f} GB against {file_bytes / 1e9:.2f} GB of files; "
        f"{checked} decoder tensors checked, {len(differ)} differ")
    return {"load_s": load_s, "peak_gb": peak / 1e9,
            "file_gb": file_bytes / 1e9, "checked": checked,
            "differ": differ[:8], "n_differ": len(differ)}


def rank_job(path: str) -> int:
    """One rank of a multi-GPU phase (``python chip_smoke.py --rank-job
    DIR``): ``DIR/job.json`` says which; the result goes to
    ``DIR/rank{R}.json``.  With ``gloo`` in the job the rank first joins a
    gloo group, which the port's entry points then use (two ranks sharing
    one card)."""
    import torch
    import torch.distributed as dist

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(path, "job.json")) as f:
        job = json.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if job.get("gloo"):
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world)
    job["path"] = path
    try:
        res = {"tp13b": _job_tp13b, "stage4": _job_stage4,
               "ckpt_tp": _job_ckpt_tp,
               "tp_pool": _job_tp_pool}[job["kind"]](job, rank)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _first_departures(got, ref, got_logits, ref_logits):
    """Each row's first departure of token lists ``got`` from ``ref``,
    judged as ``spec_departure`` judges one: a near-tie (rounding) where
    ``ref``'s top-2 logit gap there is smaller than the largest |logits(got)
    - logits(ref)| over the vocabulary (logits looked up by (row,
    offset)).  -> (the departures, the largest such |diff| at any offset
    where both rows still agree or first depart: an error the judgement
    does not set)."""
    out, err = [], 0.0
    for row, (a, b) in enumerate(zip(got, ref)):
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   None if len(a) == len(b) else min(len(a), len(b)))
        for p in range(len(a) if pos is None else pos + 1):
            lg, lr = got_logits.get((row, p)), ref_logits.get((row, p))
            if lg is not None and lr is not None:
                err = max(err, float((lg - lr).abs().max()))
        if pos is None:
            continue
        lg, lr = got_logits.get((row, pos)), ref_logits.get((row, pos))
        dep = {"row": row, "position": pos, "judged": False}
        if lg is not None and lr is not None:
            top2 = lr.topk(2).values
            dep.update(judged=True,
                       tokens_ref_got=[b[pos] if pos < len(b) else None,
                                       a[pos] if pos < len(a) else None],
                       top2_gap=float(top2[0] - top2[1]),
                       max_abs_logit_diff=float((lg - lr).abs().max()))
            dep["near_tie"] = dep["top2_gap"] < dep["max_abs_logit_diff"]
        out.append(dep)
    return out, err


def _tp_kernel_cases(g, flush):
    """#1-#5, #7 and #11 against their plain versions at the 13B TP-2
    shard shapes (20 of the 40 heads; the split linears): the prefill's
    flash forward, the stage-4 backward's streams, the heads layout of a
    response stream, the int4 decode step over the prompt cache and every
    int4 product a rank runs in decode (M 8) and prefill (M 703), its head
    half included."""
    import torch

    from opadpo_torch.ops import decode_attention as da

    h = 20
    res = {"flash": _flash_case(8, 703, 703, h, 128, True, g, flush),
           "bwd_prefix": _bwd_case(1, 703, 703, h, 128, g, flush),
           "bwd_response": _bwd_case(3, 896, 1599, h, 128, g, flush),
           "heads": _heads_case(3, 896, g, flush, kv_len=1599, h=h)}
    b, hd, sp = 8, 128, 768
    q1 = torch.randn(b, h, hd, generator=g, device="cuda").to(torch.bfloat16)
    pk4, pv4 = (torch.randint(-128, 128, (b, h, sp // 2, hd), generator=g,
                              device="cuda", dtype=torch.int8)
                for _ in range(2))
    ks, vs = (torch.rand(b, h, sp, generator=g, device="cuda") * 0.02
              for _ in range(2))
    bias = torch.zeros(b, sp, device="cuda")
    bias[:, 703:] = NEG_INF
    ks[:, :, 703:] = 0.0
    vs[:, :, 703:] = 0.0
    res["decode_int4"] = _decode_case(
        da.decode_attention4_cuda, da.decode_attention_prompt4_plain,
        (q1, pk4, ks, pv4, vs, bias, hd ** -0.5), sp, 1, True, flush,
        "decode_attention_int4")
    res["q4"] = [_quant_case("q4", m, k, n, g, flush)
                 for m in (8, 703) for k, n in Q4_DECODER_TP2]
    res["q4"].append(_quant_case("q4", 8, 5120, 16000, g, flush,
                                 out_f32=True))
    return res


# the 13B decoder's int4 products on one of two model ranks, (K, N): q, k,
# v and the MLP's gate and up split on N, o and down split on K
Q4_DECODER_TP2 = ((5120, 2560), (5120, 6912), (2560, 5120), (6912, 5120))


def tp2_kernel_entries(kernels, multi) -> None:
    """Each kernel that the 13B TP-2 path runs gets, under ``tp2``, its
    check and times at the shard shapes (``_tp_kernel_cases``) and rank
    0's launches on that path (rollout and two stage-4 steps)."""
    kc, tp = multi["kernels"], multi["tp13b"]
    roll, train = tp["launches_rollout_rank0"], tp["launches_train_rank0"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    fl, br, bp = kc["flash"], kc["bwd_response"], kc["bwd_prefix"]

    def bwd(key, outs):
        return {"at": "[3,896 over 1599,20,128] bf16 causal (response "
                      "stream), prefix [1,703,20,128]",
                "ms": br[key + "_ms"], "plain_ms": br["plain_ms"],
                "library_ms": br["library_ms"],
                "bound_ms": br[key + "_bound_ms"],
                "bound_by": br[key + "_bound_by"],
                "max_abs_err": max(x["err"][n] for x in (br, bp)
                                   for n in outs),
                "prefix": {"ms": bp[key + "_ms"],
                           "bound_ms": bp[key + "_bound_ms"]}}

    def heads(name):
        h = kc["heads"][name]
        return {"at": "[3,896,20x128] q, k, v in one launch",
                **{k: h[k] for k in keys}, "library_ms": None,
                "max_abs_err": h["err"]}

    dc = kc["decode_int4"]
    q4 = kc["q4"]
    by_name = {
        "flash_fwd": {"at": "[8,703,20,128] bf16 causal (13B TP-2 prefill)",
                      **{k: fl[k] for k in keys + ("library_ms",)},
                      "max_abs_err": fl["err_o"]},
        "flash_bwd_dq": bwd("dq", ("dq",)),
        "flash_bwd_dkv": bwd("dkv", ("dk", "dv")),
        "scatter_heads": heads("scatter_qkv"),
        "gather_heads": heads("gather_qkv"),
        "decode_attention_int4": {
            "at": "[8,20,768,128] int4, s_used 768 (13B TP-2 decode step)",
            **{k: dc[k] for k in keys}, "library_ms": None,
            "max_abs_err": dc["err_out"]},
        "quant_matmul4": {
            "at": "M 8 (the first listed) and 703 at (K, N) "
                  f"{list(Q4_DECODER_TP2)}, and the head half M 8 x 5120 "
                  "-> 16000 f32",
            **{k: q4[0][k] for k in keys + ("library_ms",)},
            "max_abs_err": max(c["err"] for c in q4),
            "cases": [{k: c[k] for k in ("m", "k", "n", "variant", "err",
                                         "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}
                      for c in q4]}}
    for entry in kernels:
        name = entry["name"]
        if name in by_name:
            entry["tp2"] = {**by_name[name],
                            "launches_rollout_rank0": roll.get(name, 0),
                            "launches_train_rank0": train.get(name, 0)}


def phase_multi_gpu(card, dirs, root, stage4, g):
    """The port's ``parallel/`` on the card(s): (a) stage 4 under a
    world-size-1 NCCL group (``RANK=0 WORLD_SIZE=1 LOCAL_RANK=0``, a
    subprocess) against ``phase_stage4``'s run of the same rows and
    checkpoint; (b) LLaVA-1.5-13B int4 at tensor parallelism 2, full
    width: a one-process rollout and two stage-4 steps first, freed, then
    the same on two ranks (NCCL with a card each where two are visible,
    else two processes sharing the one card over a gloo group the smoke
    starts), tokens equal on both ranks, greedy agreement with one process
    and every first departure a near-tie, the prefill logits against one
    process within a factor of a control's (one process rounding the
    row-parallel products as two ranks do), the second step's loss
    movement, the first step's gradient norm and the checkpoint-2 adapter
    against one process's, launches at the shard shapes and peak memory
    per rank; (c) with two or more cards, data parallelism 2 of the 7B
    stage 4; (d) the 7B checkpoint
    read from disk at TP 2 through ``setup_model``, every decoder tensor
    against its slice of the file; and #1-#5, #7 and #11 against their
    plain versions at the TP-2 shard shapes."""
    import torch

    from opadpo_torch.pipeline import runtime

    n_gpu = torch.cuda.device_count()
    res = {"gpus": n_gpu, "card": card}
    gc.collect()
    torch.cuda.empty_cache()

    # (a) one rank over NCCL
    out = os.path.join(root, "stage4_nccl1")
    (a,) = _run_ranks({"kind": "stage4", "dirs": dirs, "out": out,
                       "per_dev": 2}, 1, [0], "nccl1")
    diff, top, bitwise = _adapter_diff(
        _peft(os.path.join(out, "checkpoint-2")),
        _peft(os.path.join(dirs["stage4"], "checkpoint-2")))
    rel = [abs(x - y) / max(abs(y), 1e-9)
           for x, y in zip(a["losses"], stage4["losses"])]
    check(a["backend"] == "nccl", f"world-size-1 backend {a['backend']}")
    check(len(rel) == 2 and max(rel) <= BF16_REL and diff <= BF16_REL * top,
          f"world-size-1 NCCL stage 4: losses {a['losses']} against "
          f"{stage4['losses']}, adapter |diff| {diff} of {top}")
    check(a["launches"] == {k: stage4["launches"].get(k, 0)
                            for k in a["launches"]},
          f"world-size-1 launches {a['launches']} against "
          f"{stage4['launches']}")
    check(a["collectives"].get("all_reduce", {}).get("calls", 0) > 0,
          f"world-size-1: no collective ran {a['collectives']}")
    res["nccl1"] = {"losses": a["losses"], "losses_stage4": stage4["losses"],
                    "adapter_max_abs_diff": diff, "bitwise": bitwise,
                    "collectives": a["collectives"], "wall_s": a["wall_s"],
                    "step_s": a["step_s"], "peak_gb": a["peak_gb"]}
    log(f"[multi_gpu] (a) world size 1 over NCCL: losses {a['losses']} "
        f"(stage 4's {stage4['losses']}), adapter max |diff| {diff:.3g}, "
        f"bitwise {bitwise}; collectives {a['collectives']}; card: {card}")
    shutil.rmtree(out, ignore_errors=True)

    # (b) 13B int4, TP 2: one process first, then two ranks
    model_dir = _model_13b_dir(root)
    one_rec = _DecisionLogits()
    torch.cuda.reset_peak_memory_stats()
    _, model, _ = runtime.setup_model(model_dir, skip_loading_weights=True,
                                      bits=4, seed=0, device="cuda")
    one_roll = _tp_rollout(model, one_rec)
    one_logits = one_rec.store
    one0 = one_rec.rows(0, TP_ROWS)
    one_exp = _expected_q4_train(model)
    # the control: TP 2's rounding of the row-parallel products, here
    _dequantize_decoder(model)
    check(bool(torch.equal(_prefill_logits(model), one0)),
          "13B: the dequantized decoder's prefill logits differ from the "
          "int4 model's (its prefill rows take dequantize + matmul)")
    _split_row_products(model)
    ctrl_logits = _prefill_logits(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    one_out = os.path.join(root, "tp13b_one")
    one_train = _stage4_13b(model_dir, one_out, 1, one_exp)
    gc.collect()
    torch.cuda.empty_cache()
    shared = n_gpu < 2
    tp_out = os.path.join(root, "tp13b_tp2")
    logits_path = os.path.join(root, "tp13b_logits.pt")
    job = {"kind": "tp13b", "model_dir": model_dir, "out": tp_out,
           "gloo": shared, "logits": logits_path}
    ranks = _run_ranks(job, 2, [0, 0] if shared else [0, 1], "tp13b")
    tp_logits = torch.load(logits_path)
    os.remove(logits_path)
    r0, r1 = ranks
    tp_tokens, one_tokens = r0["rollout"]["tokens"], one_roll["tokens"]
    equal_rows = sum(a == b for a, b in zip(tp_tokens, one_tokens))
    deps, _ = _first_departures(tp_tokens, one_tokens, tp_logits,
                                one_logits)
    near = sum(1 for d in deps if d.get("near_tie"))
    # the prefill logits against one process, beside the control's
    tp0 = torch.stack([tp_logits[(b, 0)] for b in range(TP_ROWS)])
    logit_err = float((tp0 - one0).abs().max())
    ctrl_err = float((ctrl_logits - one0).abs().max())
    logit_rel = float((tp0 - one0).norm() / one0.norm())
    ctrl_rel = float((ctrl_logits - one0).norm() / one0.norm())
    sim_err = float((tp0 - ctrl_logits).abs().max())
    losses_tp, losses_one = r0["train"]["losses"], one_train["losses"]
    move_tp = losses_tp[1] - losses_tp[0]
    move_one = losses_one[1] - losses_one[0]
    move_rel = abs(move_tp - move_one) / max(abs(move_one), 1e-12)
    gn_tp, gn_one = r0["train"]["grad_norms"], one_train["grad_norms"]
    gnorm_rel = abs(gn_tp[0] - gn_one[0]) / max(abs(gn_one[0]), 1e-12)
    adapter_rel = _lora_b_rel(_peft(os.path.join(tp_out, "checkpoint-2")),
                              _peft(os.path.join(one_out, "checkpoint-2")))
    res["tp13b"] = {
        "ranks_share_one_card": shared,
        "backend": "gloo (two processes on one card)" if shared else "nccl",
        "rows_equal_to_one_process": equal_rows, "of": TP_ROWS,
        "first_departures": deps, "near_ties": near,
        "prefill_logits_max_abs_diff": logit_err,
        "prefill_logits_rel_diff": logit_rel,
        "control_prefill_logits_max_abs_diff": ctrl_err,
        "control_prefill_logits_rel_diff": ctrl_rel,
        "prefill_logits_max_abs_diff_to_control": sim_err,
        "losses": losses_tp, "losses_one_process": losses_one,
        "loss_move_rel_err": move_rel,
        "grad_norms": gn_tp, "grad_norms_one_process": gn_one,
        "grad_norm_rel_err": gnorm_rel,
        "adapter_lora_b_rel_diff": adapter_rel,
        "rollout_s": [r["rollout"]["wall_s"] for r in ranks],
        "rollout_s_one_process": one_roll["wall_s"],
        "generated_tok_per_s": r0["rollout"]["generated_tok_per_s"],
        "generated_tok_per_s_one_process": one_roll["generated_tok_per_s"],
        "step_s": r0["train"].get("step_s"),
        "step_s_one_process": one_train.get("step_s"),
        "peak_gb_per_rank": [max(r["rollout"]["peak_gb"],
                                 r["train"]["peak_gb"]) for r in ranks],
        "peak_gb_one_process": one_train["peak_gb"],
        "launches_rollout_rank0": r0["rollout"]["launches"],
        "launches_train_rank0": r0["train"]["launches"],
        "collectives_rollout_rank0": r0["rollout"]["collectives"],
        "collectives_train_rank0": r0["train"]["collectives"],
        "shard_shapes": r0["shard_shapes"]}
    log(f"[multi_gpu] (b) 13B int4 TP 2 on "
        f"{'one shared card over gloo' if shared else 'two cards, NCCL'}: "
        f"{equal_rows} of {TP_ROWS} rows equal to one process's greedy; "
        f"first departures {len(deps)}, of which {near} near-ties; prefill "
        f"logits max |TP - one| {logit_err:.4g} (relative {logit_rel:.4g}) "
        f"against the split-K control's {ctrl_err:.4g} (relative "
        f"{ctrl_rel:.4g}), max |TP - control| {sim_err:.4g}; losses "
        f"{losses_tp} against {losses_one} (loss "
        f"movement relative error {move_rel:.4g}); grad norms {gn_tp} "
        f"against {gn_one} (step 1 relative error {gnorm_rel:.4g}); "
        f"checkpoint-2 lora_B relative difference {adapter_rel:.4g}; "
        f"rollout {res['tp13b']['rollout_s']} s against "
        f"{one_roll['wall_s']:.2f} s; peak {res['tp13b']['peak_gb_per_rank']}"
        f" GB a rank; card: {card}")
    check(r0["rollout"]["tokens"] == r1["rollout"]["tokens"],
          "13B TP 2: the model ranks sampled different tokens")
    check(near == len(deps), f"13B TP 2: {len(deps) - near} of {len(deps)} "
          f"first departures from one process are not near-ties: {deps}")
    check(sim_err <= TP_CONTROL_ABS
          and logit_err <= TP_LOGIT_FACTOR * ctrl_err,
          f"13B TP 2 prefill logits: max |TP - control| {sim_err} (limit "
          f"{TP_CONTROL_ABS}), max |TP - one| {logit_err} against "
          f"{TP_LOGIT_FACTOR} x the control's {ctrl_err}")
    check(len(losses_tp) == 2 and losses_tp[0] == losses_one[0]
          and move_rel <= TP_MOVE_REL,
          f"13B TP 2 losses {losses_tp} against one process {losses_one}: "
          f"movement relative error {move_rel} (limit {TP_MOVE_REL})")
    check(gnorm_rel <= TP_GNORM_REL,
          f"13B TP 2 step-1 grad norm {gn_tp[0]} against {gn_one[0]}")
    check(adapter_rel <= TP_ADAPTER_REL,
          f"13B TP 2 checkpoint-2 lora_B relative difference {adapter_rel} "
          f"(limit {TP_ADAPTER_REL})")
    shutil.rmtree(one_out, ignore_errors=True)
    shutil.rmtree(tp_out, ignore_errors=True)

    # (c) DP 2 of the 7B stage 4, a card each
    if n_gpu >= 2:
        out = os.path.join(root, "stage4_dp2")
        c = _run_ranks({"kind": "stage4", "dirs": dirs, "out": out,
                        "per_dev": 1}, 2, [0, 1], "dp2")
        rel = [abs(x - y) / max(abs(y), 1e-9)
               for x, y in zip(c[0]["losses"], stage4["losses"])]
        check(max(rel) <= BF16_REL, f"DP 2 losses {c[0]['losses']} against "
              f"{stage4['losses']}")
        res["dp2"] = {"losses": c[0]["losses"], "loss_rel_err": rel,
                      "step_s": c[0]["step_s"],
                      "peak_gb": [x["peak_gb"] for x in c]}
        log(f"[multi_gpu] (c) 7B stage 4 at DP 2 over NCCL: "
            f"{json.dumps(res['dp2'])}; card: {card}")
        shutil.rmtree(out, ignore_errors=True)
    else:
        log(f"[multi_gpu] (c) DP 2 of the 7B stage 4 skipped: {n_gpu} card "
            "visible")

    # (d) the 7B checkpoint read from disk at TP 2
    d = _run_ranks({"kind": "ckpt_tp", "llava": dirs["llava"],
                    "clip": dirs["clip"], "gloo": shared}, 2,
                   [0, 0] if shared else [0, 1], "ckpt_tp")
    for r, x in enumerate(d):
        check(x["checked"] > 0 and x["n_differ"] == 0,
              f"7B checkpoint at TP 2, rank {r}: {x['n_differ']} of "
              f"{x['checked']} decoder tensors differ from the file's "
              f"slices: {x['differ']}")
        check(x["peak_gb"] < CKPT_TP_PEAK_SHARE * x["file_gb"],
              f"7B checkpoint at TP 2, rank {r}: peak {x['peak_gb']} GB "
              f"against {x['file_gb']} GB of files")
    res["ckpt_tp"] = {k: [x[k] for x in d]
                      for k in ("load_s", "peak_gb", "file_gb", "checked")}
    log(f"[multi_gpu] (d) 7B checkpoint read at TP 2 through setup_model: "
        f"{json.dumps(res['ckpt_tp'])}; every decoder tensor equal to its "
        f"slice of the file; card: {card}")

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    res["kernels"] = _tp_kernel_cases(g, flush)
    del flush
    torch.cuda.empty_cache()
    log(f"[multi_gpu] {json.dumps({k: v for k, v in res.items() if k != 'kernels'})}")
    return res


# -- tensor parallelism of the slot pool and of speculative decode -----------

# the 13B TP-2 pool runs (greedy, qlen 128): the rollout's first 8 prompt
# rows through an int4 pool of 4 slots in two waves, responses cut to 16
# tokens, segments of 8 (each row decodes across a fold); 4 requests with
# budgets of 16 tokens through an int8 pool of 16 slots with speculative
# segments at k 4, segments of 32; the Sampler at k 4 on the first 2
# TP_PROMPTS rows, 16 tokens, with each advance (an admission prefill of
# 4 rows moves ~4.6 GB through gloo all_reduce)
# (few and short: the ranks may share one card over gloo, so the part
# checks correctness, not speed, inside the smoke's time limit)
TPP_SLOTS = 4
TPP_NEW = 16
TPP_SEG = 8
TPP_SPEC_REQUESTS = 4
TPP_ROLLOUT_ROWS = 8    # two waves through the TPP_SLOTS slots
TPP_SAMPLER_ROWS = 2
TPP_SPEC_SLOTS = 16
TPP_SPEC_SEG = 32
TPP_K = 4
TPP_QLEN = 128
TPP_PARTS = ("rollout", "spec_pool", "sampler_shared", "sampler_per_row")


def _tpp_requests(cfg):
    """The speculative pool's requests: (ids, mask, black image, budget),
    prompts of 8 to 40 words, budgets from a seed in [16, TPP_NEW]."""
    import random

    import numpy as np

    from opadpo_torch.data.image_processing import black_image
    from opadpo_torch.data.tokenization import tokenizer_image_token
    from opadpo_torch.serve import build_prompt

    rng = random.Random(17)
    out = []
    for i in range(TPP_SPEC_REQUESTS):
        words = " ".join(f"detail{j}" for j in range(rng.randint(0, 32)))
        ids = np.asarray(tokenizer_image_token(build_prompt(
            f"Describe object {i} in the image. {words}"), WordTokenizer()),
            np.int64)
        out.append((ids, np.ones_like(ids),
                    black_image(cfg.vision.image_size),
                    rng.randint(16, TPP_NEW)))
    return out


def _tpp_rollout_config(model_dir, out, model: int):
    """``configs/llava_online_generation.yaml`` on the 13B config directory
    drawn into int4 from seed 0: the int4 pool of TPP_SLOTS slots, greedy
    (top-k 1), responses of TPP_NEW tokens, TPP_ROLLOUT_ROWS rows in one
    loader batch, ``mesh.model`` ``model``."""
    from opadpo_torch.pipeline.config import apply_overrides, load_config

    return apply_overrides(load_config(os.path.join(
        ROOT, "configs", "llava_online_generation.yaml")), [
        f"base_model={model_dir}", "image_checkpoint=null",
        "model.skip_loading_weights=true", "training.bits=4",
        "training.kv_bits=4", f"training.continuous_slots={TPP_SLOTS}",
        f"training.continuous_seg_len={TPP_SEG}",
        f"training.response_len={TPP_NEW}",
        f"training.query_len={TPP_QLEN}",
        f"training.rollout_per_device_batch_size={STAGE12_ROWS}",
        "training.top_k=1", "training.seed=0", f"training.output_dir={out}",
        "training.device=cuda", f"mesh.model={model}"])


def _tpp_runs(model, mesh, model_dir, out):
    """The TP pool parts on ``model`` (one process, or a rank's shard over
    ``mesh``), each with its kernel counters and collectives counted from
    0: (i) the rollout through ``online_generation.run`` over the int4
    pool (its ``setup_model`` answered with ``model`` once its arguments
    are checked); (ii) the int8 pool with speculative segments at k 4;
    (iii) the speculative Sampler at k 4 with the shared and the per-row
    advance.  Launches are checked against each run's schedule.  ->
    (results, {part: its _DecisionLogits})."""
    import torch

    from opadpo_torch.data.collators import QueryCollator
    from opadpo_torch.data.datasets import QueryDataset
    from opadpo_torch.engine.sampler import Sampler
    from opadpo_torch.engine.serving_config import (
        make_continuous_engine, make_serving_sampling,
    )
    from opadpo_torch.parallel import comm
    from opadpo_torch.pipeline import online_generation, runtime

    cfg, dev = model.cfg, next(model.parameters()).device
    counters = _counters()
    res, recs = {}, {}

    def start():
        _reset(counters)
        comm.reset_counts()
        torch.cuda.synchronize()
        return time.perf_counter()

    def finish(label, t0, rec):
        torch.cuda.synchronize()
        launches = _read(counters)
        recs[label] = rec
        res[label] = {"wall_s": time.perf_counter() - t0,
                      "collectives": comm.counts(),
                      "launches": {k: v for k, v in launches.items() if v}}
        return launches

    # (i) the rollout over the int4 pool
    have_pil = _have_pil()
    tok = WordTokenizer()
    dataset = _pixel_class(QueryDataset, have_pil)(
        _stage12_rows(have_pil, 8)[:TPP_ROLLOUT_ROWS], tok,
        query_len=TPP_QLEN, image_size=cfg.vision.image_size)
    module = {"train_dataset": dataset, "eval_dataset": None,
              "data_collator": QueryCollator()}
    stub = CorrectorStub(8)

    def cached_setup(path, **kw):
        check(path == model_dir and kw.get("bits") == 4
              and kw.get("seed") == 0 and kw.get("skip_loading_weights")
              and kw["mesh"].model == mesh.model,
              f"rollout set-up arguments {path} {kw}")
        return cfg, model, mesh

    saved_env = {k: os.environ.pop(k) for k in _STAGE_ENV if k in os.environ}
    saved = runtime.setup_model, online_generation.get_api_service
    try:
        os.environ["API_KEY"] = "smoke-dummy"
        runtime.setup_model = cached_setup
        online_generation.get_api_service = (
            lambda rank=0, cache_path="": stub)
        with _DecisionLogits() as rec:
            t0 = start()
            online_generation.run(
                _tpp_rollout_config(model_dir, out, mesh.model),
                tokenizer=tok, data_module=module)
            launches = finish("rollout", t0, rec)
    finally:
        runtime.setup_model, online_generation.get_api_service = saved
        os.environ.pop("API_KEY", None)
        os.environ.update(saved_env)
    eng = rec.engine
    check(eng is not None and eng.kv_bits == 4 and eng.b == TPP_SLOTS,
          "the rollout did not run the int4 pool")
    check(sum(eng.stats["admit_groups"]) == TPP_ROLLOUT_ROWS > TPP_SLOTS,
          f"the rollout's {TPP_ROLLOUT_ROWS} rows did not reuse the "
          f"{TPP_SLOTS} slots (admission groups {eng.stats['admit_groups']})")
    _check_pool_launches(cfg, eng.stats, launches, "decode_attention_int4",
                         "TP pool rollout")
    res["rollout"].update(
        tokens=[rec.tokens[r] for r in range(len(rec.tokens))],
        budgets=[TPP_NEW] * len(rec.tokens), forwards=eng.stats["forwards"],
        segments=eng.stats["segments"], sp_used=eng.stats["sp_used"],
        admit_groups=eng.stats["admit_groups"], s_total=eng.s_total,
        corrections=len(stub.calls))

    # (ii) the int8 pool with speculative segments
    sampling = make_serving_sampling(greedy=True, max_new_tokens=TPP_NEW,
                                     eos_token_id=2, pad_token_id=0)
    reqs = _tpp_requests(cfg)
    with torch.inference_mode(), _DecisionLogits() as rec:
        eng = make_continuous_engine(
            model, sampling, slots=TPP_SPEC_SLOTS, kv_bits=8, spec_k=TPP_K,
            seg_len=TPP_SPEC_SEG, qlen=TPP_QLEN, collect_spec_stats=True,
            generator=torch.Generator(device=dev).manual_seed(0))
        t0 = start()
        rids = [eng.add_request(ids, m, img, max_new=b)
                for ids, m, img, b in reqs]
        while eng.has_work():
            eng.step()
        launches = finish("spec_pool", t0, rec)
    _check_pool_launches(cfg, eng.stats, launches, "decode_attention_multi",
                         "TP spec pool")
    res["spec_pool"].update(
        tokens=[rec.tokens[r] for r in rids], budgets=[b for *_, b in reqs],
        forwards=eng.stats["forwards"], segments=eng.stats["segments"],
        sp_used=eng.stats["sp_used"], admit_groups=eng.stats["admit_groups"],
        spec=dict(eng.spec_stats), s_total=eng.s_total)

    # (iii) the speculative Sampler, each advance
    ids, mask, images = _server_batch(cfg, list(TP_PROMPTS[:TPP_SAMPLER_ROWS]),
                                      TPP_SAMPLER_ROWS, dev)
    for adv in ("shared", "per_row"):
        sampler = Sampler(sampling, kv_bits=8, spec_k=TPP_K,
                          spec_advance=adv)
        with torch.inference_mode(), _DecisionLogits() as rec:
            t0 = start()
            toks = sampler.generate(model, ids, mask, images)
            rec.place([(b, 0) for b in range(TPP_SAMPLER_ROWS)])
            launches = finish(f"sampler_{adv}", t0, rec)
        stats = list(sampler.stats)
        _check_attention_launches(cfg, stats, launches,
                                  "decode_attention_multi")
        res[f"sampler_{adv}"].update(
            tokens=toks.cpu().tolist(),
            budgets=[TPP_NEW] * TPP_SAMPLER_ROWS,
            forwards=stats[-1]["decode_steps"],
            accepted_drafts=stats[-1]["accepted_drafts"])
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res, recs


def _job_tp_pool(job, rank):
    """A rank of the TP pool phase: the 13B int4 shard over a ``1 x 2``
    mesh through ``_tpp_runs``; rank 0 also saves every part's decision
    logits, keyed by (request, offset) (``job["logits"]``)."""
    import torch

    from opadpo_torch.parallel.mesh import MeshConfig, make_mesh
    from opadpo_torch.pipeline import runtime

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, model, mesh = runtime.setup_model(
        job["model_dir"], skip_loading_weights=True, bits=4, seed=0,
        mesh=make_mesh(MeshConfig(model=2), "cuda"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(mesh.model == 2 and mesh.model_rank == rank,
          f"rank {rank}: mesh {mesh.data}x{mesh.model}")
    res, recs = _tpp_runs(model, mesh, job["model_dir"], job["out"])
    if rank == 0:
        torch.save({p: recs[p].store for p in TPP_PARTS}, job["logits"])
    log(f"[tp_pool] rank {rank}: setup {load_s:.1f} s; "
        + "; ".join(f"{p} {res[p]['wall_s']:.2f} s" for p in TPP_PARTS)
        + f"; peak {res['peak_gb']:.2f} GB")
    res["load_s"] = load_s
    return res


def _tpp_kernel_cases(g, flush, runs):
    """#8 at the TP Sampler's verify shape ([8, 20, 768, 128], G 5) and
    over the TP spec pool ([16, 20, s_total, 128], G 5) at the watermarks
    it visited, #6 over the same pool, and #7 over the TP rollout's packed
    int4 pool ([TPP_SLOTS, 20, s_total / 2, 128]) at its watermarks, each
    against its plain version (``runs``: a rank's ``_tpp_runs``
    results)."""
    import torch

    from opadpo_torch.ops import decode_attention as da

    h, hd = 20, 128
    sm = hd ** -0.5

    def tensors(b, s_total):
        q = torch.randn(b, h, TPP_K + 1, hd, generator=g,
                        device="cuda").to(torch.bfloat16)
        ks, vs = (torch.rand(b, h, s_total, generator=g, device="cuda")
                  * 0.02 for _ in range(2))
        bias = torch.zeros(b, s_total, device="cuda")
        for i in range(b):
            bias[i, 703 + 3 * i:] = NEG_INF     # rows at their own fill
        pk, pv = (torch.randint(-127, 128, (b, h, s_total, hd), generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        return q, pk, ks, pv, vs, bias

    def marks(part):
        return sorted(int(s) for s in runs[part]["sp_used"])

    multi = (da.decode_attention_multi_cuda,
             da.decode_attention_prompt_multi_plain)
    q, pk, ks, pv, vs, bias = tensors(TP_ROWS, 768)
    out = {"multi_sampler": [_decode_case(
        *multi, (q, pk, ks, pv, vs, bias, sm), 768, TPP_K + 1, False, flush,
        "decode_attention_multi")]}
    q, pk, ks, pv, vs, bias = tensors(TPP_SPEC_SLOTS,
                                      runs["spec_pool"]["s_total"])
    out["multi_pool"] = [_decode_case(
        *multi, (q, pk, ks, pv, vs, bias, sm), su, TPP_K + 1, False, flush,
        "decode_attention_multi") for su in marks("spec_pool")]
    out["int8_pool"] = [_decode_case(
        da.decode_attention_cuda, da.decode_attention_prompt_plain,
        (q[:, :, 0].contiguous(), pk, ks, pv, vs, bias, sm), su, 1, False,
        flush, "decode_attention_int8") for su in marks("spec_pool")]
    st = runs["rollout"]["s_total"]
    q, pk, ks, pv, vs, bias = tensors(TPP_SLOTS, st)
    pk4, pv4 = (x[:, :, :st // 2].contiguous() for x in (pk, pv))
    out["int4_pool"] = [_decode_case(
        da.decode_attention4_cuda, da.decode_attention_prompt4_plain,
        (q[:, :, 0].contiguous(), pk4, ks, pv4, vs, bias, sm), su, 1, True,
        flush, "decode_attention_int4") for su in marks("rollout")]
    for group, cases in out.items():
        for c in cases:
            c["ranks"], c["per"] = da.decode_split(
                c["s_used"], c["shape"][0] * h, group == "int4_pool",
                c["G"])
            log(f"[tp_pool] {group} {c['shape']} G {c['G']} s_used "
                f"{c['s_used']}: {c['ms']:.4f} ms (plain "
                f"{c['plain_ms']:.4f}) against {c['bound_ms']:.4f} ms of "
                f"bound, {c['ranks']} ranks of {c['per']}, max |err| "
                f"{c['err_out']:.3g}")
    return out


def phase_tp_pool(card, root, g):
    """The slot pool and speculative decode at tensor parallelism 2 on
    LLaVA-1.5-13B int4 (random, from the config-only directory), full
    width.  One process first on the same weights (``_tpp_runs``), then
    the control: that process with each ``wo`` / ``w_down`` product split
    into the two ranks' shards (``_split_row_products``), freed; then two
    rank processes (``python chip_smoke.py --rank-job``: NCCL with a card
    each where two are visible, else sharing the one card over a gloo
    group the smoke starts).  Tokens equal on both ranks, no request over
    its budget, model rank 0 alone correcting the rollout's rows, #7 / #8
    launches per rank as each run's schedule derives.  Against one
    process: the rows equal counted and every first departure judged a
    near-tie (``_first_departures``); the largest |logits(TP) -
    logits(one)| where the rows agree or first depart at most
    TP_LOGIT_FACTOR times the control's own, and every request's
    first-token logits (its admission prefill) within TP_CONTROL_ABS of
    the control's: limits the TP run does not set.  Peak memory per rank
    and wall times; then #6, #7 and #8 at the TP pool's shapes against
    their plain versions."""
    import torch

    from opadpo_torch.parallel.mesh import single_mesh
    from opadpo_torch.pipeline import runtime

    t_phase = time.perf_counter()
    n_gpu = torch.cuda.device_count()
    model_dir = _model_13b_dir(root)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, model, _ = runtime.setup_model(model_dir, skip_loading_weights=True,
                                      bits=4, seed=0, device="cuda")
    one, one_recs = _tpp_runs(model, single_mesh("cuda"), model_dir,
                              os.path.join(root, "tpp_one"))
    _split_row_products(model)
    ctrl, ctrl_recs = _tpp_runs(model, single_mesh("cuda"), model_dir,
                                os.path.join(root, "tpp_control"))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    shared = n_gpu < 2
    logits_path = os.path.join(root, "tpp_logits.pt")
    ranks = _run_ranks({"kind": "tp_pool", "model_dir": model_dir,
                        "out": os.path.join(root, "tpp_tp"), "gloo": shared,
                        "logits": logits_path},
                       2, [0, 0] if shared else [0, 1], "tp_pool")
    tp_logits = torch.load(logits_path)
    os.remove(logits_path)
    r0, r1 = ranks
    res = {"card": card, "ranks_share_one_card": shared,
           "backend": "gloo (two processes on one card)" if shared
           else "nccl", "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
           "peak_gb_one_process": one["peak_gb"],
           "load_s_per_rank": [r["load_s"] for r in ranks]}
    bad, over = [], []
    for part in TPP_PARTS:
        a0, a1, o, c = (r0[part]["tokens"], r1[part]["tokens"],
                        one[part]["tokens"], ctrl[part]["tokens"])
        check(a0 == a1, f"TP pool {part}: the model ranks emitted different "
              "tokens")
        for toks, who in ((a0, "TP"), (o, "one process"), (c, "control")):
            budgets = r0[part]["budgets"]
            over_budget = [i for i, (x, b) in enumerate(zip(toks, budgets))
                           if len(x) > b]
            check(len(toks) == len(budgets) and not over_budget,
                  f"TP pool {part} ({who}): requests {over_budget} over "
                  "budget")
        one_l, tp_l, ctrl_l = (one_recs[part].store, tp_logits[part],
                               ctrl_recs[part].store)
        deps, tp_err = _first_departures(a0, o, tp_l, one_l)
        _, ctrl_err = _first_departures(c, o, ctrl_l, one_l)
        first_err = max(float((tp_l[(i, 0)] - ctrl_l[(i, 0)]).abs().max())
                        for i in range(len(o)))
        bad += [(part, d) for d in deps if not d.get("near_tie")]
        if tp_err > TP_LOGIT_FACTOR * ctrl_err or first_err > TP_CONTROL_ABS:
            over.append((part, tp_err, ctrl_err, first_err))
        res[part] = {
            "requests": len(o),
            "rows_equal_to_one_process": sum(a == b for a, b in zip(a0, o)),
            "rows_equal_to_control": sum(a == b for a, b in zip(a0, c)),
            "first_departures": deps,
            "near_ties": sum(1 for d in deps if d.get("near_tie")),
            "max_abs_logit_diff": tp_err,
            "control_max_abs_logit_diff": ctrl_err,
            "first_token_max_abs_diff_to_control": first_err,
            "tokens": sum(len(x) for x in a0),
            "wall_s_per_rank": [r[part]["wall_s"] for r in ranks],
            "wall_s_one_process": one[part]["wall_s"],
            "forwards": r0[part]["forwards"],
            "launches_rank0": r0[part]["launches"],
            "launches_rank1": r1[part]["launches"],
            "collectives_rank0": r0[part]["collectives"],
            **{k: r0[part][k] for k in ("sp_used", "admit_groups", "spec",
                                        "accepted_drafts", "corrections")
               if k in r0[part]}}
        log(f"[tp_pool] {part}: tokens equal on both ranks; "
            f"{res[part]['rows_equal_to_one_process']} of {len(o)} equal to "
            f"one process's ({res[part]['rows_equal_to_control']} to the "
            f"control's), {len(deps)} first departures, "
            f"{res[part]['near_ties']} near-ties; max |TP - one| {tp_err:.4g}"
            f" against the control's {ctrl_err:.4g} (limit "
            f"{TP_LOGIT_FACTOR} x); first-token logits max |TP - control| "
            f"{first_err:.4g} (limit {TP_CONTROL_ABS}); wall "
            f"{res[part]['wall_s_per_rank']} s a rank against "
            f"{one[part]['wall_s']:.2f} s in one process; "
            f"{r0[part]['forwards']} forwards; launches rank 0 "
            f"{r0[part]['launches']}; collectives rank 0 "
            f"{r0[part]['collectives']}; card: {card}")
    check(r0["rollout"]["corrections"] == TPP_ROLLOUT_ROWS
          and r1["rollout"]["corrections"] == 0,
          f"TP rollout corrections {r0['rollout']['corrections']} / "
          f"{r1['rollout']['corrections']}: model rank 0 corrects every row")
    check(not bad, f"TP pool: first departures from one process that are "
          f"not near-ties: {bad}")
    check(not over, f"TP pool logits (part, max |TP - one|, the control's, "
          f"first-token max |TP - control|) over their limits "
          f"({TP_LOGIT_FACTOR} x the control's, {TP_CONTROL_ABS}): {over}")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    res["kernels"] = _tpp_kernel_cases(g, flush, r0)
    del flush
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[tp_pool] peak {res['peak_gb_per_rank']} GB a rank (one process "
        f"{one['peak_gb']:.2f} GB); phase {res['seconds']:.1f} s; card: "
        f"{card}")
    log(f"[tp_pool] {json.dumps({k: v for k, v in res.items() if k != 'kernels'})}")
    return res


# -- the continuous slot pool and the eval suite ------------------------------

POOL_SLOTS = 16
POOL_SEG = 64
POOL_QLEN = 128
POOL_MAX_NEW = 96
POOL_REQUESTS = 24
POOL_BURST = 20             # the first burst overfills the pool by 4


def _per_prefill(cfg) -> int:
    """Flash forward launches of one prefill: one per CLIP and decoder
    layer."""
    return cfg.vision.num_active_layers + cfg.llama.num_layers


def _stats_delta(after: dict, before: dict) -> dict:
    """What a ContinuousEngine ran between two copies of its ``stats``."""
    return {"segments": after["segments"] - before["segments"],
            "folds": after["folds"] - before["folds"],
            "forwards": after["forwards"] - before["forwards"],
            "tokens": after["tokens"] - before["tokens"],
            "admit_groups": after["admit_groups"][len(before["admit_groups"]):],
            "full_queued": after["full_queued"] - before["full_queued"],
            "sp_used": {su: n - before["sp_used"].get(su, 0)
                        for su, n in after["sp_used"].items()
                        if n > before["sp_used"].get(su, 0)}}


def _copy_stats(stats: dict) -> dict:
    return {**stats, "admit_groups": list(stats["admit_groups"]),
            "sp_used": dict(stats["sp_used"])}


def _check_pool_launches(cfg, delta, launches, decode, label,
                         prefill_on_gpu=True):
    """#1 once per CLIP and decoder layer per admission group (0 where the
    prefill runs on the CPU); the ``decode`` kernel once per decoder layer
    per segment forward; the other decode kernels never.  -> the derived
    counts."""
    want = {"flash_fwd": (len(delta["admit_groups"]) * _per_prefill(cfg)
                          if prefill_on_gpu else 0)}
    for key in DECODE_KERNELS:
        want[key] = (cfg.llama.num_layers * delta["forwards"]
                     if key == decode else 0)
    for key, n in want.items():
        check(launches[key] == n, f"{label}: {key} launches {launches[key]}"
              f" do not match the {n} the schedule derives ({delta})")
    return want


def phase_continuous_reference():
    """The slot pool on the tiny LLaVA in f32, greedy, through the kernels
    against the same pool on the CPU (the plain versions): the int8 pool
    (#6), the packed int4 pool (#7) and speculative segments at k 3 (#8),
    the last also against the int8 pool on the GPU.  Two slots, segments
    of 4 tokens, a cap of 10: one request decodes a segment alone, then
    four more arrive (one at a budget of 7, three queued), and an EOS id
    taken from the third request's greedy output ends it early and frees
    its slot for the fifth, still queued then.  The flash kernel takes bf16 only, so the
    engine's admission prefill runs on the CPU (its ``prefill`` hook) and
    the pool on the GPU; #1 is then launched never, and #6, #7 and #8 once
    per decoder layer per segment forward."""
    import numpy as np
    import torch

    from opadpo_torch.constants import IMAGE_TOKEN_INDEX
    from opadpo_torch.engine.continuous import ContinuousEngine
    from opadpo_torch.engine.sampling import SamplingConfig
    from opadpo_torch.models import llava

    cpu_model, gpu_model, _ = _tiny_f32(9)
    cfg = cpu_model.cfg
    g = torch.Generator(device="cpu").manual_seed(15)
    reqs = []
    for _ in range(5):
        ids = torch.randint(5, cfg.llama.vocab_size, (10,), generator=g)
        ids[2] = IMAGE_TOKEN_INDEX
        reqs.append((ids.numpy(), torch.ones(10, dtype=torch.int64).numpy(),
                     torch.randn(28, 28, 3, generator=g).numpy()))
    budgets = [None, 7, None, None, None]

    def cpu_prefill(kv_bits):
        def prefill(ids, mask, images):
            return _to(llava.prefill_unrolled(
                cpu_model, ids.cpu(), mask.cpu(), images.cpu(),
                quantize_kv=True, kv_bits=kv_bits), "cuda")
        return prefill

    def run(model, kv_bits, spec_k, eos, prefill=None):
        eng = ContinuousEngine(
            model, SamplingConfig(greedy=True, max_new_tokens=10,
                                  eos_token_id=eos),
            max_batch=2, qlen=10, seg_len=4, kv_bits=kv_bits, spec_k=spec_k,
            collect_spec_stats=bool(spec_k), prefill=prefill)
        rids = [eng.add_request(*reqs[0])]
        done = dict(eng.step())
        rids += [eng.add_request(*r, max_new=b)
                 for r, b in zip(reqs[1:], budgets[1:])]
        queued_at_eos = None         # queue length when request 2 ended
        while eng.has_work():
            done.update(eng.step())
            if queued_at_eos is None and rids[2] in done:
                queued_at_eos = eng.queue_length
        return [done[r] for r in rids], eng, queued_at_eos

    probe = run(cpu_model, 8, 0, -1)[0]
    eos = int(probe[2][2])
    counters = _counters()
    res, gpu_tokens = {}, {}
    for label, kv_bits, spec_k, kernel in (
            ("int8", 8, 0, "decode_attention_int8"),
            ("int4", 4, 0, "decode_attention_int4"),
            ("spec k3", 8, 3, "decode_attention_multi")):
        want = run(cpu_model, kv_bits, spec_k, eos)[0]
        _reset(counters)
        got, eng, queued = run(gpu_model, kv_bits, spec_k, eos,
                               prefill=cpu_prefill(kv_bits))
        torch.cuda.synchronize()
        launches = _read(counters)
        for i, (a, b) in enumerate(zip(got, want)):
            check(np.array_equal(a, b), f"pool {label}: request {i} on the "
                  f"GPU {a.tolist()} differs from the CPU's {b.tolist()}")
        check(len(got[1]) <= 7, f"pool {label}: budget 7 exceeded")
        check(len(got[2]) < 10 and got[2][-1] == eos,
              f"pool {label}: the EOS id {eos} did not end request 2 early")
        check(queued == 1 and eng.stats["admit_groups"][-1] == 1 and
              sum(eng.stats["admit_groups"]) == 5,
              f"pool {label}: request 2's EOS did not free its slot for the "
              f"queued request 4 (queue {queued}, admissions "
              f"{eng.stats['admit_groups']})")
        derived = _check_pool_launches(cfg, eng.stats, launches, kernel,
                                       f"pool {label}", prefill_on_gpu=False)
        gpu_tokens[label] = got
        res[label] = {"tokens": [len(x) for x in got],
                      "segments": eng.stats["segments"],
                      "forwards": eng.stats["forwards"],
                      "admit_groups": eng.stats["admit_groups"],
                      "launches": {k: launches[k] for k in derived},
                      **({"spec": dict(eng.spec_stats)} if spec_k else {})}
    for a, b in zip(gpu_tokens["spec k3"], gpu_tokens["int8"]):
        check(np.array_equal(a, b), "pool spec k3 greedy differs from the "
              "int8 pool on the GPU")
    log(f"[continuous-ref] tiny f32 pool token-exact, EOS id {eos}: "
        f"{json.dumps(res)}")
    return res


def _continuous_requests():
    """The POOL_REQUESTS requests: prompts of 8 to 40 words, budgets
    drawn from a seed between POOL_SEG + 1 and POOL_MAX_NEW tokens: no
    request ends within its first segment (an EOS aside), so the first
    burst leaves the pool full with requests queued, whenever they
    arrive in the first segment."""
    import random

    rng = random.Random(15)
    reqs = []
    for i in range(POOL_REQUESTS):
        words = " ".join(f"detail{j}" for j in range(rng.randint(0, 32)))
        reqs.append({"prompt": f"Describe object {i} in the image. {words}",
                     "max_new_tokens": rng.randint(POOL_SEG + 1,
                                                   POOL_MAX_NEW)})
    return reqs


def _serve_continuous(worker, reqs, label, burst=None):
    """``reqs`` over HTTP to a ContinuousWorker, after one warm-up request:
    the first ``burst`` (by default half) at once, the rest as soon as the
    first answer comes back.  -> (responses, per-request seconds, the engine's stats
    over these requests, the kernel counters, wall s, peak GB)."""
    import torch
    from http.server import ThreadingHTTPServer

    from opadpo_torch.serve import make_handler

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    counters = _counters()
    n = len(reqs)
    results, secs = [None] * n, [None] * n
    first = threading.Event()
    try:
        resp = _post(port, {"prompt": "warm up", "max_new_tokens": 2})
        check("error" not in resp, f"{label}: warm-up failed: {resp}")
        torch.cuda.synchronize()
        before = _copy_stats(worker.engine.stats)
        spec_before = dict(worker.engine.spec_stats)
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)

        def go(i):
            t0 = time.perf_counter()
            results[i] = _post(port, reqs[i])
            secs[i] = time.perf_counter() - t0
            first.set()

        t_start = time.perf_counter()
        threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
        burst = n // 2 if burst is None else burst
        for th in threads[:burst]:
            th.start()
        first.wait(timeout=600)
        for th in threads[burst:]:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t_start
        torch.cuda.synchronize()
        launches = _read(counters)
        peak = torch.cuda.max_memory_allocated() / 1e9
        delta = _stats_delta(worker.engine.stats, before)
        delta["spec"] = {k: v - spec_before[k]
                         for k, v in worker.engine.spec_stats.items()}
    finally:
        server.shutdown()
        server.server_close()
        worker.close()
    check(not any(th.is_alive() for th in threads), f"{label}: a request "
          "hung")
    check(worker.rebuilds == 0, f"{label}: the engine was rebuilt")
    for i, r in enumerate(results):
        check(r is not None and "text" in r and "error" not in r,
              f"{label}: request {i} failed: {r}")
        check(1 <= r["new_tokens"] <= reqs[i]["max_new_tokens"],
              f"{label}: request {i} gave {r['new_tokens']} tokens for a "
              f"budget of {reqs[i]['max_new_tokens']}")
    check(delta["tokens"] == sum(r["new_tokens"] for r in results),
          f"{label}: the engine kept {delta['tokens']} tokens")
    return results, secs, delta, launches, wall, peak


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def phase_continuous(model, card):
    """The serve CLI's ``--continuous`` worker (``serve.parse_args`` and
    ``make_worker`` over the in-memory 7B, greedy): 16 slots, segments of
    64, qlen 128, a cap of POOL_MAX_NEW, behind the HTTP server,
    POOL_REQUESTS requests with budgets from a seed in [POOL_SEG + 1,
    POOL_MAX_NEW],
    POOL_BURST at once and the rest when the first answer comes back, so
    requests queue behind a full pool, three times: the int8
    pool (#1, #6), the packed int4 pool (#7) and speculative segments at
    k 4 (#8).  Each run: no error response, no request over its budget,
    #1 once per CLIP and decoder layer per admission group, the decode
    kernel once per decoder layer per segment forward, and at least one
    segment run with every slot live and requests queued; generated tokens/s,
    per-request latency p50 / p99, segments, folds, admission groups,
    watermarks and peak memory."""
    import collections

    import torch

    from opadpo_torch import serve

    cfg = model.cfg
    reqs = _continuous_requests()
    base = ["--model-path", "(in memory)", "--continuous", "--max-batch",
            str(POOL_SLOTS), "--seg-len", str(POOL_SEG), "--query-len",
            str(POOL_QLEN), "--max-new-tokens", str(POOL_MAX_NEW)]
    res, texts = {}, {}
    for label, extra, kernel in (
            ("int8", ["--kv-bits", "8"], "decode_attention_int8"),
            ("int4", ["--kv-bits", "4"], "decode_attention_int4"),
            ("spec k4", ["--kv-bits", "8", "--spec-k", "4"],
             "decode_attention_multi")):
        args = serve.parse_args(base + extra)
        worker = serve.make_worker(args, model, cfg, WordTokenizer())
        results, secs, delta, launches, wall, peak = _serve_continuous(
            worker, reqs, f"continuous {label}", burst=POOL_BURST)
        derived = _check_pool_launches(cfg, delta, launches, kernel,
                                       f"continuous {label}")
        check(delta["full_queued"] >= 1, f"continuous {label}: no segment "
              f"ran with every slot live and requests queued ({delta})")
        tokens = sum(r["new_tokens"] for r in results)
        texts[label] = [r["text"] for r in results]
        res[label] = {
            "generated_tok_per_s": tokens / wall, "tokens": tokens,
            "wall_s": wall, "latency_p50_s": _pct(secs, 50),
            "latency_p99_s": _pct(secs, 99), "segments": delta["segments"],
            "folds": delta["folds"], "forwards": delta["forwards"],
            "full_queued": delta["full_queued"],
            "admit_groups": dict(collections.Counter(delta["admit_groups"])),
            "sp_used": delta["sp_used"], "peak_gb": peak,
            "launches": {k: launches[k] for k in derived}, "card": card,
            **({"spec": delta["spec"]} if args.spec_k else {})}
        del worker
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[continuous] {label}: {tokens} tokens in {wall:.2f} s = "
            f"{res[label]['generated_tok_per_s']:.1f} generated tok/s, "
            f"latency p50 {res[label]['latency_p50_s']:.2f} s p99 "
            f"{res[label]['latency_p99_s']:.2f} s, {delta['segments']} "
            f"segments ({delta['full_queued']} full with requests queued), "
            f"{delta['folds']} folds, admission groups "
            f"{res[label]['admit_groups']}, watermarks {delta['sp_used']}, "
            f"peak {peak:.2f} GB; launches {res[label]['launches']}; card: "
            f"{card}")
    res["agreement"] = {
        label: sum(a == b for a, b in zip(texts["int8"], texts[label]))
        for label in ("int4", "spec k4")}
    log(f"[continuous] answers equal to the int8 pool's (of "
        f"{POOL_REQUESTS}): {res['agreement']}")
    res["queue3"] = _judge_spec_departures(model, reqs, texts)
    q3 = res["queue3"]
    log(f"[continuous] Queue 3 check: {q3['near_ties']} near-ties out of "
        f"{q3['departures_judged']} departures ({q3['requests_departing']} "
        f"spec k4 answers differ from the int8 pool's; each such request "
        f"re-decoded plain and speculative by spec_departure)")
    log(f"[continuous] {json.dumps(res)}")
    return res


def _judge_spec_departures(model, reqs, texts):
    """Queue 3's check on the pool's spec-against-int8 comparison: the
    requests whose spec k 4 answer differs from the int8 pool's, re-decoded
    in one server batch (their prompts, the largest of their budgets) by
    ``spec_departure``, each first departure judged there: a near-tie
    where plain greedy's top-2 logit gap is smaller than the largest
    |logits(#8) - logits(#6)| at it (unjudged counts as no near-tie)."""
    departing = [i for i, (a, b) in enumerate(zip(texts["int8"],
                                                  texts["spec k4"]))
                 if a != b]
    judged = []
    if departing:
        d = spec_departure(model, [reqs[j]["prompt"] for j in departing],
                           rows=len(departing),
                           max_new=max(reqs[j]["max_new_tokens"]
                                       for j in departing))
        judged = [{**dep, "request": departing[dep["row"]],
                   "near_tie": bool(dep.get("near_tie"))}
                  for dep in d["departures"]]
    return {"requests_departing": len(departing),
            "departures_judged": len(judged),
            "near_ties": sum(d["near_tie"] for d in judged),
            "departures": judged}


def phase_pool_kernels(g, res):
    """#1 at the admission prefill's groups ([k, 703, 32, 128], k 1, 2, 4)
    and #6, #7, #8 (G 5) over a pool of 16 slots at the watermarks the
    continuous runs visited, each against its plain version."""
    import torch

    from opadpo_torch.ops import decode_attention as da

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    out = {"flash": [_flash_case(k, 703, 703, 32, 128, True, g, flush,
                                 mask_last=False) for k in (1, 2, 4)]}
    b, h, hd = POOL_SLOTS, 32, 128
    sm = hd ** -0.5
    s_total = -(-(POOL_QLEN - 1 + 576 + POOL_MAX_NEW) // 256) * 256
    q = torch.randn(b, h, 5, hd, generator=g, device="cuda").to(
        torch.bfloat16)
    q1 = q[:, :, 0].contiguous()
    ks, vs = (torch.rand(b, h, s_total, generator=g, device="cuda") * 0.02
              for _ in range(2))
    bias = torch.zeros(b, s_total, device="cuda")
    for i in range(b):
        bias[i, 703 + 16 * i:] = NEG_INF      # rows at their own fill
    pk, pv = (torch.randint(-127, 128, (b, h, s_total, hd), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    marks = {k: sorted(int(su) for su in res[k]["sp_used"])
             for k in ("int8", "int4", "spec k4")}
    out["int8"] = [_decode_case(da.decode_attention_cuda,
                                da.decode_attention_prompt_plain,
                                (q1, pk, ks, pv, vs, bias, sm), su, 1, False,
                                flush, "decode_attention_int8")
                   for su in marks["int8"]]
    out["multi"] = [_decode_case(da.decode_attention_multi_cuda,
                                 da.decode_attention_prompt_multi_plain,
                                 (q, pk, ks, pv, vs, bias, sm), su, 5, False,
                                 flush, "decode_attention_multi")
                    for su in marks["spec k4"]]
    pk4, pv4 = pk[:, :, :s_total // 2].contiguous(), \
        pv[:, :, :s_total // 2].contiguous()
    out["int4"] = [_decode_case(da.decode_attention4_cuda,
                                da.decode_attention_prompt4_plain,
                                (q1, pk4, ks, pv4, vs, bias, sm), su, 1, True,
                                flush, "decode_attention_int4")
                   for su in marks["int4"]]
    for group in ("int8", "int4", "multi"):
        for c in out[group]:
            c["ranks"], c["per"] = da.decode_split(
                c["s_used"], b * h, group == "int4", c["G"])
            log(f"[pool] #{KERNEL_NUMBER[group]} B {b} G {c['G']} s_used "
                f"{c['s_used']}: {c['ms']:.4f} ms (plain {c['plain_ms']:.4f})"
                f" against {c['bound_ms']:.4f} ms of bound, {c['ranks']} "
                f"ranks of {c['per']}")
    for c in out["flash"]:
        log(f"[pool] #1 admission group {c['shape'][0]}: {c['ms']:.4f} ms "
            f"(plain {c['plain_ms']:.4f}, SDPA {c['library_ms']:.4f}) "
            f"against {c['bound_ms']:.4f} ms of bound")
    del flush
    torch.cuda.empty_cache()
    return out


POPE_SPLITS = ("random", "popular", "adversarial")
POPE_QUESTIONS = 8


def _pope_data(root):
    """Three seeded POPE splits of POPE_QUESTIONS questions with their PNG
    images."""
    import random

    import numpy as np
    from PIL import Image

    rng = random.Random(21)
    imgs = os.path.join(root, "images")
    os.makedirs(os.path.join(root, "pope"), exist_ok=True)
    os.makedirs(imgs, exist_ok=True)
    objects = ("dog", "cat", "car", "person", "chair", "bottle", "bus")
    for k, split in enumerate(POPE_SPLITS):
        with open(os.path.join(root, "pope", f"coco_pope_{split}.jsonl"),
                  "w") as f:
            for i in range(POPE_QUESTIONS):
                name = f"COCO_val2014_{k:02d}{i:04d}.png"
                px = np.random.default_rng(100 * k + i).integers(
                    0, 256, (rng.randint(240, 480), rng.randint(240, 640), 3),
                    dtype=np.uint8)
                Image.fromarray(px).save(os.path.join(imgs, name))
                f.write(json.dumps({
                    "question_id": i, "image": name,
                    "text": f"Is there a {rng.choice(objects)} in the "
                            "image?",
                    "label": rng.choice(("yes", "no"))}) + "\n")
    return imgs


def phase_eval(cfg, card, dirs, root):
    """The eval suite from the 7B checkpoint on disk:
    ``eval.run_all --benchmarks pope`` over three seeded POPE splits of 8
    questions (PNG images through PIL), at batch 8 (bf16 cache: #1 per
    prefill, no decode kernel) and again at ``--continuous-slots 16`` (#1
    per admission group, #6 per decoder layer per segment forward), then
    ``model_vqa_logit`` on one split (#1 per prefill); no judge stage.
    Scores, each split's time, and how many answers the two modes share."""
    import torch

    from opadpo_torch.eval import model_vqa_logit, run_all

    check(_have_pil(), "the eval phase needs PIL (the port's load_image)")
    data = os.path.join(root, "eval")
    imgs = _pope_data(data)
    common = ["--model-path", dirs["llava"], "--vision-path", dirs["clip"],
              "--data-root", data, "--image-root", imgs, "--benchmarks",
              "pope", "--batch-size", "8"]
    counters = _counters()
    res = {"card": card}
    per = _per_prefill(cfg)
    for mode, extra in (("batch", []),
                        ("continuous", ["--continuous-slots", "16"])):
        _reset(counters)
        t0 = time.perf_counter()
        results, runs = run_all.main(
            common + ["--output-dir", os.path.join(data, mode)] + extra,
            tokenizer=WordTokenizer())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _read(counters)
        gc.collect()
        torch.cuda.empty_cache()
        if mode == "batch":
            n_pf = sum(len(r["batches"]) for r in runs.values())
            check(n_pf == 3 * -(-POPE_QUESTIONS // 8),
                  f"eval batch: {n_pf} prefills")
            want = {"flash_fwd": n_pf * per,
                    **{k: 0 for k in DECODE_KERNELS}}
        else:
            delta = {"admit_groups": [g for r in runs.values()
                                      for g in r["engine"]["admit_groups"]],
                     "forwards": sum(r["engine"]["forwards"]
                                     for r in runs.values())}
            want = _check_pool_launches(cfg, delta, launches,
                                        "decode_attention_int8",
                                        "eval continuous")
        for k, n in want.items():
            check(launches[k] == n, f"eval {mode}: {k} launches "
                  f"{launches[k]}, derived {n}")
        for split in POPE_SPLITS:
            r = results[f"pope_{split}"]
            check(r["num_examples"] == POPE_QUESTIONS, f"pope {split}: {r}")
        res[mode] = {"scores": {s: {k: results[f"pope_{s}"][k]
                                    for k in ("accuracy", "f1", "yes_ratio")}
                                for s in POPE_SPLITS},
                     "split_s": {s: runs[f"pope_{s}"]["seconds"]
                                 for s in POPE_SPLITS},
                     "total_s": secs,
                     "launches": {k: launches[k] for k in want}}
        log(f"[eval] run_all pope {mode}: {json.dumps(res[mode])}")
    agree = 0
    for split in POPE_SPLITS:
        a, b = ([json.loads(line)["text"] for line in open(os.path.join(
            data, mode, f"pope_{split}.jsonl"))]
            for mode in ("batch", "continuous"))
        check(len(a) == len(b) == POPE_QUESTIONS, f"pope {split} answers")
        agree += sum(x == y for x, y in zip(a, b))
    res["agreement"] = agree
    _reset(counters)
    t0 = time.perf_counter()
    logit_file = os.path.join(data, "logit_random.jsonl")
    model_vqa_logit.main(
        ["--model-path", dirs["llava"], "--vision-path", dirs["clip"],
         "--question-file", os.path.join(data, "pope",
                                         "coco_pope_random.jsonl"),
         "--image-folder", imgs, "--answers-file", logit_file,
         "--batch-size", "8"], tokenizer=WordTokenizer())
    torch.cuda.synchronize()
    launches = _read(counters)
    gc.collect()
    torch.cuda.empty_cache()
    n_pf = -(-POPE_QUESTIONS // 8)
    check(launches["flash_fwd"] == n_pf * per and not any(
        launches[k] for k in DECODE_KERNELS),
        f"logit readout launches {launches}")
    lines = [json.loads(line) for line in open(logit_file)]
    check(len(lines) == POPE_QUESTIONS and all(
        math.isfinite(x["p_yes"]) and math.isfinite(x["p_no"])
        and x["text"] in ("Yes", "No") for x in lines), "logit answers")
    res["logit"] = {"seconds": time.perf_counter() - t0,
                    "yes": sum(x["text"] == "Yes" for x in lines),
                    "launches_flash": launches["flash_fwd"]}
    log(f"[eval] {POPE_QUESTIONS * 3} POPE answers, {agree} equal in both "
        f"modes; logit readout {json.dumps(res['logit'])}; card: {card}")
    return res


# the tools' phase: opadpo_torch/tools/ on the 7B the smoke holds
TOOLS_DECODE_STEPS = 32
TOOLS_SERVE_REQUESTS = 8
TOOLS_SERVE_NEW = 32
TOOLS_SPEC_STEPS = 32
TOOLS_QUALITY_LEN = 64
TOOLS_PROFILE_STEPS = 16
TOOLS_POOL_REQUESTS = 16
TOOLS_POOL_SEG = 16
TOOLS_COSINE_INT8 = 0.999
TOOL_NAMES = ("bench_decode", "bench_train_dpo", "bench_train_sft",
              "bench_serve", "bench_serve_spec", "bench_spec",
              "bench_quality", "profile_decode", "profile_serving",
              "profile_train", "e2e_rehearsal", "bench_image_pipeline")


def _positive(rec, label, *paths):
    """Every number at the dotted ``paths`` of ``rec`` finite and > 0."""
    for path in paths:
        node = rec
        for key in path.split("."):
            node = node.get(key) if isinstance(node, dict) else None
        check(isinstance(node, (int, float)) and math.isfinite(node)
              and node > 0, f"{label}: {path} = {node!r}")


def _check_want(launches, want, label):
    for key, n in want.items():
        check(launches[key] == n, f"{label}: {key} launches {launches[key]}"
              f", derived {n}")


def _attention_want(cfg, prefills, forwards, decode=None) -> dict:
    """#1 once per CLIP and decoder layer per prefill; the ``decode``
    kernel once per decoder layer per decode forward, the others never."""
    want = {"flash_fwd": prefills * _per_prefill(cfg)}
    for key in DECODE_KERNELS:
        want[key] = cfg.llama.num_layers * forwards if key == decode else 0
    return want


def _train_want(cfg, rollouts=0, dpo_steps=0, sft_steps=0, dpo=None):
    """#1-#5 over ``rollouts`` rollout_score calls, ``dpo_steps``
    dpo_train_steps (the loss and its backward) and ``sft_steps``
    sft_train_steps with the vision adapter."""
    from opadpo_torch.engine.dpo import DpoConfig
    from opadpo_torch.engine.sft import SftConfig

    dpo = dpo or DpoConfig()
    want = dict.fromkeys(("flash_fwd", "scatter_heads", "flash_bwd_dq",
                          "flash_bwd_dkv", "gather_heads"), 0)
    for n, per in ((rollouts, expected_launches(cfg, dpo, False)),
                   (dpo_steps, expected_launches(cfg, dpo, True)),
                   (sft_steps, expected_sft_launches(cfg, SftConfig(),
                                                     True))):
        for k, v in per.items():
            want[k] += n * v
    return want


def _meta_quantized(cfg, bits):
    """``cfg``'s model quantized to ``bits`` on the meta device (no
    memory): the block linears' widths and shapes, for derived counts."""
    import torch

    from opadpo_torch.models import llava
    from opadpo_torch.ops import quant

    with torch.device("meta"):
        model = llava.Llava(cfg)
    return quant.quantize_params(model, bits)


def _quality_want(model, rec) -> dict:
    """The launches of ``bench_quality`` on the bf16 ``model``: the bf16
    scoring pass twice, one rollout_score and one loss-and-gradient pass at
    the gradient length; each quantized mode's scoring pass (#9 / #11 on
    every block linear: CLIP at 577 rows, the decoder's prefix and its
    response stream) and loss-and-gradient pass (``expected_quant_train``);
    then the decode section on the int8 weights: one prefill (#9 on the
    CLIP and decoder rows), four first decode steps (#9 at one row each;
    #6 over the int8 cache, #7 over the int4 one, #11 in the int4 head)."""
    import dataclasses

    from opadpo_torch.engine.dpo import DpoConfig

    cfg, b = model.cfg, rec["batch"]
    r = rec["response_len"]
    g_len = rec["scoring"]["bf16"]["grad_response_len"]
    dpo_g = DpoConfig(response_len=g_len)
    score = dataclasses.replace(DpoConfig(response_len=r), CoPO=False)
    modes = rec["modes"]
    want = dict.fromkeys(("flash_fwd", "scatter_heads", "flash_bwd_dq",
                          "flash_bwd_dkv", "gather_heads"), 0)
    for n, per in ((2 + len(modes), expected_launches(cfg, score, False)),
                   (1, expected_launches(cfg, dpo_g, False)),
                   (1 + len(modes), expected_launches(cfg, dpo_g, True))):
        for k, v in per.items():
            want[k] += n * v
    counts = dict.fromkeys(QUANT_KEYS, 0)
    prefix = b * (cfg.num_patches + 127)
    for name in modes:
        qm = _meta_quantized(cfg, 4 if name == "int4" else 8)
        clip, dec, _ = _quant_layers(qm)
        _add(counts, clip, b * (cfg.num_patches + 1))
        _add(counts, dec, prefix)
        _add(counts, dec, 3 * b * r)
        for k, v in expected_quant_train(qm, dpo_g, b, True).items():
            counts[k] += v
    clip, dec, _ = _quant_layers(_meta_quantized(cfg, 8))
    _add(counts, clip, cfg.num_patches + 1)
    _add(counts, dec, rec["decode"]["prompt_positions"])
    _add(counts, dec, 1, 4)
    v, d = model.llama.lm_head.weight.shape
    _add(counts, [types.SimpleNamespace(bits=4, out_features=v,
                                        in_features=d)], 1)
    want["flash_fwd"] += _per_prefill(cfg)
    want.update(decode_attention_int8=cfg.llama.num_layers,
                decode_attention_int4=cfg.llama.num_layers,
                decode_attention_multi=0)
    return {**want, **counts}


def phase_tools(model, card, root):
    """``opadpo_torch/tools/`` on the 7B bf16 model the smoke holds, each
    tool's ``run(args, model=...)`` at a short depth, its launches counted
    from 0: bench_decode (kv 8, 32 steps), bench_train (dpo, then sft: one
    warm-up and one timed iteration), bench_serve (8 requests, max-new
    32, both modes, then the pool with oracle drafts at k 4), bench_spec
    (32 steps, accept rates 1.0 and 0.6, int4 head), bench_quality
    (responses of 64, int8 and int4), profile_decode (int4 cache and
    head, 32 steps) and summarize_trace on its trace, profile_serving
    --continuous (the int8 pool, then spec k 4, 16 requests),
    profile_train --mode sft, e2e_rehearsal at 7B width (4 prompts, 32
    tokens, 1 DPO step, 4 POPE questions) and bench_image_pipeline.  Every
    record's times finite and positive; bf16 against itself 0, int8 nearer
    bf16 than int4 and its gradient cosine >= TOOLS_COSINE_INT8;
    bench_spec at accept 1.0 emitting more a group than at 0.6, and greedy
    speculative decode equal to plain greedy, or each first departure a
    near-tie (the Queue 3 judgement); the oracle pool accepting drafts;
    the profiled decode kernel among summarize_trace's top kernels; each
    tool's launches as its shapes derive."""
    import torch

    from opadpo_torch.engine.dpo import DpoConfig
    from opadpo_torch.tools import (
        bench_decode, bench_image_pipeline, bench_quality, bench_serve,
        bench_spec, bench_train, e2e_rehearsal, profile_decode,
        profile_serving, profile_train, summarize_trace,
    )

    t_phase = time.perf_counter()
    cfg, layers = model.cfg, model.cfg.llama.num_layers
    per = _per_prefill(cfg)
    out = os.path.join(root, "tools")
    os.makedirs(out, exist_ok=True)
    counters = _counters()
    res = {"card": card, "seconds": {}, "launches": {}}

    def tool(name, mod, argv):
        args = mod.parse_args(argv)
        _reset(counters)
        t0 = time.perf_counter()
        rec = mod.run(args, model=model)
        torch.cuda.synchronize()
        res["seconds"][name] = time.perf_counter() - t0
        launches = _read(counters)
        res["launches"][name] = {k: v for k, v in launches.items() if v}
        gc.collect()
        torch.cuda.empty_cache()
        return rec, launches

    def no_quant(launches, label):
        _check_want(launches, dict.fromkeys(QUANT_KEYS, 0), label)

    # bench_decode: one warm-up and one timed prefill + 32 steps, kv 8
    rec, ln = tool("bench_decode", bench_decode, [
        "--bits", "16", "--kv-bits", "8", "--head-bits", "16",
        "--steps", str(TOOLS_DECODE_STEPS), "--batch", "4"])
    _positive(rec, "bench_decode", "steps_per_sec", "tokens_per_sec",
              "ms_per_step", "prefill_ms", "peak_gb")
    _check_attention_launches(cfg, rec["runs"], ln)
    no_quant(ln, "bench_decode")
    res["bench_decode"] = {k: rec[k] for k in (
        "steps_per_sec", "tokens_per_sec", "ms_per_step", "prefill_ms",
        "peak_gb")}

    # bench_train: dpo then sft, 1 warm-up + 1 timed iteration each
    for mode in ("dpo", "sft"):
        name = f"bench_train_{mode}"
        rec, ln = tool(name, bench_train, [
            "--mode", mode, "--bits", "16", "--act-bits", "16",
            "--batch", "2", "--lora-rank", "64", "--iters", "1"])
        _positive(rec, name, "seconds_per_step", "first_iter_s", "peak_gb")
        check(rec["finite"], f"{name}: loss {rec['loss']}")
        ran = rec["ran"]
        _check_want(ln, _train_want(cfg, ran.get("rollouts", 0),
                                    ran.get("dpo_steps", 0),
                                    ran.get("sft_steps", 0)), name)
        no_quant(ln, name)
        res[name] = {k: rec[k] for k in ("seconds_per_step", "first_iter_s",
                                         "peak_gb", "loss")}

    # bench_serve: both modes, then the pool with oracle drafts
    serve_argv = ["--bits", "16", "--head-bits", "16", "--kv-bits", "8",
                  "--slots", "16", "--requests", str(TOOLS_SERVE_REQUESTS),
                  "--max-new", str(TOOLS_SERVE_NEW)]
    rec, ln = tool("bench_serve", bench_serve,
                   serve_argv + ["--mode", "both"])
    _positive(rec, "bench_serve", "continuous.tokens_per_sec",
              "continuous.latency_p50_s", "continuous.latency_p95_s",
              "batch_sync.tokens_per_sec", "batch_sync.latency_p50_s",
              "continuous_speedup")
    pool, batches = rec["ran"]["pool"], rec["ran"]["prefills"]
    _check_want(ln, _attention_want(
        cfg, sum(len(p["admit_groups"]) for p in pool) + len(batches),
        sum(p["forwards"] for p in pool)
        + sum(s["decode_steps"] for s in batches),
        "decode_attention_int8"), "bench_serve")
    no_quant(ln, "bench_serve")
    res["bench_serve"] = {m: {k: rec[m][k] for k in (
        "tokens_per_sec", "latency_mean_s", "latency_p50_s",
        "latency_p95_s")} for m in ("continuous", "batch_sync")}
    res["bench_serve"]["continuous_speedup"] = rec["continuous_speedup"]
    rec, ln = tool("bench_serve_spec", bench_serve, serve_argv + [
        "--mode", "continuous", "--spec-k", "4", "--spec-draft", "oracle"])
    _positive(rec, "bench_serve_spec", "continuous.tokens_per_sec",
              "continuous.latency_p50_s")
    spec = rec["continuous"]["spec"]
    check(spec["accepted_drafts"] > 0, f"bench_serve oracle: {spec}")
    pool = rec["ran"]["pool"]
    _check_want(ln, _attention_want(
        cfg, sum(len(p["admit_groups"]) for p in pool),
        sum(p["forwards"] for p in pool), "decode_attention_multi"),
        "bench_serve_spec")
    no_quant(ln, "bench_serve_spec")
    res["bench_serve_spec"] = {"tokens_per_sec":
                               rec["continuous"]["tokens_per_sec"], **spec}

    # bench_spec: the baseline, oracle at 1.0 and 0.6, ngram; int4 head
    rec, ln = tool("bench_spec", bench_spec, [
        "--steps", str(TOOLS_SPEC_STEPS), "--accept-rates", "1.0,0.6",
        "--head-bits", "4", "--batch", "1"])
    runs = {k: v for k, v in rec.items() if k.startswith("spec_")}
    _positive(rec, "bench_spec", "baseline.tokens_per_sec")
    for k, v in runs.items():
        _positive(v, f"bench_spec {k}", "tokens_per_sec")
    a10, a06 = rec["spec_oracle_a1.0"], rec["spec_oracle_a0.6"]
    check(a10["emitted_per_group"] > a06["emitted_per_group"],
          f"bench_spec: accept 1.0 emits {a10['emitted_per_group']} a "
          f"group, 0.6 {a06['emitted_per_group']}")
    for k, v in runs.items():
        deps = v.get("first_departures", [])
        check(v["exact_match_baseline"] or (deps and all(
            d.get("near_tie") for d in deps)),
            f"bench_spec {k}: greedy speculative decode departs from plain "
            f"greedy other than at a near-tie: {deps}")
    ran = rec["ran"]
    want = _attention_want(cfg, ran["prefills"], ran["decode_forwards"],
                           "decode_attention_int8")
    want["decode_attention_multi"] = layers * ran["verify_groups"]
    want.update(quant_matmul4=(ran["prefills"] + ran["decode_forwards"]
                               + ran["verify_groups"]),
                quant_matmul=0, quant_matmul_t=0)
    _check_want(ln, want, "bench_spec")
    res["bench_spec"] = {"baseline": rec["baseline"], **runs}

    # bench_quality: int8 and int4 against bf16, responses of 64
    rec, ln = tool("bench_quality", bench_quality, [
        "--response-len", str(TOOLS_QUALITY_LEN), "--modes", "int8,int4"])
    sc, dq = rec["scoring"], rec["decode"]
    check(sc["bf16"]["logprob_mae"] == 0
          and sc["bf16"]["logprob_max_abs"] == 0,
          f"bench_quality: bf16 against itself {sc['bf16']}")
    _positive(rec, "bench_quality", "scoring.int8.logprob_mae",
              "scoring.int4.logprob_mae",
              "decode.kv8_first_step_logit_mae",
              "decode.kv4_first_step_logit_mae",
              "decode.head4_first_step_logit_mae")
    check(sc["int8"]["logprob_mae"] < sc["int4"]["logprob_mae"],
          f"bench_quality: int8 MAE {sc['int8']['logprob_mae']} not below "
          f"int4's {sc['int4']['logprob_mae']}")
    check(sc["int8"]["lora_grad_cosine_vs_bf16"] >= TOOLS_COSINE_INT8,
          f"bench_quality: int8 gradient cosine "
          f"{sc['int8']['lora_grad_cosine_vs_bf16']}")
    _check_want(ln, _quality_want(model, rec), "bench_quality")
    res["bench_quality"] = {"scoring": sc, "decode": dq}

    # profile_decode, then summarize_trace on its trace
    trace_dir = os.path.join(out, "profile_decode")
    rec, ln = tool("profile_decode", profile_decode, [
        "--bits", "16", "--kv-bits", "4", "--head-bits", "4",
        "--steps", str(TOOLS_PROFILE_STEPS), "--outdir", trace_dir])
    _positive(rec, "profile_decode", "ms_per_step",
              "profile.device_busy_ms")
    fwd = 2 * rec["decode_forwards"]
    want = _attention_want(cfg, 1, fwd, "decode_attention_int4")
    want.update(quant_matmul4=1 + fwd, quant_matmul=0, quant_matmul_t=0)
    _check_want(ln, want, "profile_decode")
    top = summarize_trace.summarize(trace_dir, 10)
    check(top["device"] and any("decode_attn_int4_kernel" in r["name"]
                                for r in top["top"]),
          f"summarize_trace: the profiled chunk's #7 is not among its top "
          f"kernels: {[r['name'][:60] for r in top['top']]}")
    res["profile_decode"] = {"ms_per_step": rec["ms_per_step"],
                             "busy_ms": rec["profile"]["device_busy_ms"],
                             "groups_ms": rec["profile"]["groups_ms"],
                             "summarize_trace_top": [
                                 (r["name"][:80], r["count"], r["us"])
                                 for r in top["top"][:5]]}

    # profile_serving --continuous: the int8 pool, then spec k 4
    rec, ln = tool("profile_serving", profile_serving, [
        "--continuous", "--spec-k", "4", "--requests",
        str(TOOLS_POOL_REQUESTS), "--seg-len", str(TOOLS_POOL_SEG)])
    want = _attention_want(cfg, 0, 0)
    for name, pool in rec["pools"].items():
        decode = ("decode_attention_multi" if pool["spec_k"]
                  else "decode_attention_int8")
        for st in (pool["stats"], pool["warm_stats"]):
            want["flash_fwd"] += len(st["admit_groups"]) * per
            want[decode] += layers * st["forwards"]
        _positive(pool, f"profile_serving {name}",
                  "phases.segment.unprofiled_ms_per_forward",
                  "phases.segment.device_busy_ms_per_forward",
                  "phases.admission_group.device_busy_ms")
    _check_want(ln, want, "profile_serving")
    no_quant(ln, "profile_serving")
    res["profile_serving"] = {
        "pools": {n: {ph: {k: p["phases"][ph].get(k) for k in (
            "unprofiled_ms", "host_ms", "device_busy_ms",
            "unprofiled_ms_per_forward", "device_busy_ms_per_forward",
            "forwards", "groups_ms", "groups_ms_per_forward")}
            for ph in p["phases"]} for n, p in rec["pools"].items()},
        "verify_extra": rec["verify_extra"]}

    # profile_train --mode sft: one stage-3 micro-step (and its warm-up
    # and unprofiled twin)
    rec, ln = tool("profile_train", profile_train, ["--mode", "sft"])
    check(rec["positions"] == 1599,
          f"profile_train sft: {rec['positions']} positions")
    _positive(rec, "profile_train", "phases.sft_train_step.unprofiled_ms",
              "phases.sft_train_step.device_busy_ms",
              "phases.sft_train_step.peak_gb")
    _check_want(ln, _train_want(cfg, sft_steps=3), "profile_train")
    no_quant(ln, "profile_train")
    ph = rec["phases"]["sft_train_step"]
    res["profile_train"] = {k: ph.get(k) for k in (
        "unprofiled_ms", "host_ms", "device_busy_ms",
        "device_busy_share_unprofiled", "groups_ms", "peak_gb")}
    res["profile_train"]["top_kernels"] = ph["top_kernels"][:8]

    # e2e_rehearsal at 7B width, the smallest counts
    work = os.path.join(out, "e2e")
    rec, ln = tool("e2e_rehearsal", e2e_rehearsal, [
        "--model", "7b", "--n-prompts", "4", "--response-len", "32",
        "--dpo-steps", "1", "--pope-questions", "4", "--rollout-batch", "4",
        "--workdir", work])
    check(set(rec["stage_seconds"]) == {
        "rollout_generation", "dataset_build", "opa_sft", "opa_dpo",
        "pope_eval"}, f"e2e stages {rec['stage_seconds']}")
    _positive(rec, "e2e_rehearsal", "total_seconds",
              *(f"stage_seconds.{k}" for k in rec["stage_seconds"]))
    check(rec["pope_num_examples_by_split"] == [4, 4, 4],
          f"e2e POPE examples {rec['pope_num_examples_by_split']}")
    check(os.path.isdir(os.path.join(work, rec["stage4_adapter"])),
          "e2e: no stage-4 adapter")
    ran = rec["ran"]
    want = _train_want(cfg, ran["dpo_rollout_scores"],
                       ran["dpo_train_steps"], ran["sft_micro_steps"],
                       DpoConfig())
    roll = ran["rollout_samples"]
    want["flash_fwd"] += per * (len(roll) + len(ran["pope_batches"]))
    want.update(dict.fromkeys(DECODE_KERNELS, 0))
    want["decode_attention_int8"] = layers * sum(s["decode_steps"]
                                                 for s in roll)
    want["quant_matmul4"] = sum(1 + s["decode_steps"] for s in roll)
    _check_want(ln, want, "e2e_rehearsal")
    res["e2e_rehearsal"] = {k: rec[k] for k in (
        "stage_seconds", "steady_state", "total_seconds",
        "pope_num_examples")}
    shutil.rmtree(work, ignore_errors=True)

    # bench_image_pipeline: host only
    rec, ln = tool("bench_image_pipeline", bench_image_pipeline,
                   ["--images", "16"])
    _positive(rec, "bench_image_pipeline",
              "batch_preprocess.pil_ms_per_image",
              "rollout_rows.pil_rows_per_sec")
    check(rec["native"] is not None or rec.get("native_reason"),
          "bench_image_pipeline: no native library and no reason")
    check(not any(ln.values()), f"bench_image_pipeline launched {ln}")
    res["bench_image_pipeline"] = {k: rec.get(k) for k in (
        "native", "native_reason", "batch_preprocess", "rollout_rows")}

    res["phase_s"] = time.perf_counter() - t_phase
    for name in TOOL_NAMES:
        log(f"[tools] {name}: {res['seconds'][name]:.1f} s; "
            f"{json.dumps(res.get(name, {}))}")
    log(f"[tools] phase {res['phase_s']:.1f} s; launches by tool "
        f"{json.dumps(res['launches'])}; card: {card}")
    return res


def tools_kernel_entries(kernels, tools) -> None:
    """Each kernel entry's launches in each tool's run (0 where the tool
    did not launch it)."""
    for entry in kernels:
        entry["launches_tools"] = {
            name: ln.get(entry["name"], 0)
            for name, ln in tools["launches"].items()}


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


def tp_pool_kernel_entries(kernels, tpp) -> None:
    """The decode kernels' entries get, under ``tp_pool``, their checks and
    times at the TP pool's shapes (``_tpp_kernel_cases``) and rank 0's
    launches in each TP pool run; #1 its launches there."""
    kc = tpp["kernels"]
    keys = ("s_used", "G", "shape", "err_out", "ms", "plain_ms",
            "bound_ms", "bound_by", "ranks", "per")
    groups = {"decode_attention_multi": ("multi_sampler", "multi_pool"),
              "decode_attention_int8": ("int8_pool",),
              "decode_attention_int4": ("int4_pool",), "flash_fwd": ()}
    for entry in kernels:
        name = entry["name"]
        if name not in groups:
            continue
        entry["tp_pool"] = {
            "launches_rank0": {p: tpp[p]["launches_rank0"].get(name, 0)
                               for p in TPP_PARTS},
            "cases": [{"group": grp, **{k: c[k] for k in keys}}
                      for grp in groups[name] for c in kc[grp]]}


_PHASE_S: dict = {}
_MARK = [0.0, 0.0]           # [start, last mark]


def mark(label: str) -> None:
    """Log the wall seconds since the last mark (the phase just run) and
    since the first, so the smoke's time against its limit shows by
    phase."""
    now = time.perf_counter()
    if not _MARK[0]:
        _MARK[:] = [now, now]
        return
    _PHASE_S[label] = round(now - _MARK[1], 1)
    _MARK[1] = now
    log(f"[time] {label}: {_PHASE_S[label]} s, {now - _MARK[0]:.1f} s in "
        "all")


def main() -> int:
    mark("start")
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
    mark("device")
    phase_build()
    mark("build")
    native = phase_native_image(card)
    mark("native_image")
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    flash = phase_flash(g, flush)
    mark("flash")
    bwd = phase_flash_bwd(g, flush)
    mark("flash_bwd")
    heads = phase_heads(g, flush)
    mark("heads")
    decode = phase_decode(g, flush)
    mark("decode")
    qk = phase_quant(g, flush)
    mark("quant")
    del flush
    torch.cuda.empty_cache()
    for bits in (16, 8, 4):
        phase_reference(bits)
        phase_train_reference(bits)
        mark(f"references_bits{bits}")
    phase_sft_reference()
    mark("sft_reference")
    phase_tiny_f32_decode()
    mark("tiny_f32_decode")
    cont_ref = phase_continuous_reference()
    mark("continuous_reference")
    serve, model, plain_answers = phase_main_path(card)
    mark("main_path")
    rollout = phase_rollout_decode(model, card)
    mark("rollout_decode")
    spec = phase_spec_serve(model, card, plain_answers)
    mark("spec_serve")
    torch.cuda.empty_cache()
    cont = phase_continuous(model, card)
    mark("continuous")
    pool = phase_pool_kernels(g, cont)
    mark("pool_kernels")
    train = phase_train(model, card)
    mark("train")
    root = os.path.join(ROOT, "build", f"smoke_checkpoints_{os.getpid()}")
    try:
        ckpt, adapter, dirs = phase_checkpoint(model, card, root)
        mark("checkpoint")
        cli = phase_serve_cli(model, card, dirs, adapter, plain_answers)
        mark("serve_cli")
        gaps = phase_port_gaps(model.cfg, card, dirs, adapter, root)
        mark("port_gaps")
        del adapter
        gc.collect()
        torch.cuda.empty_cache()
        pruned = phase_pruned_serve(model, card, dirs)
        mark("pruned_serve")
        stage4 = phase_stage4(model.cfg, card, dirs, train)
        mark("stage4")
        multi = phase_multi_gpu(card, dirs, root, stage4, g)
        mark("multi_gpu")
        tpp = phase_tp_pool(card, root, g)
        mark("tp_pool")
        shutil.rmtree(dirs["stage4"], ignore_errors=True)
        stage12, merged, n_words = phase_stages12(model.cfg, card, dirs)
        mark("stages12")
        stage3 = phase_stage3(model.cfg, card, dirs, merged, n_words)
        mark("stage3")
        gc.collect()
        torch.cuda.empty_cache()
        ev = phase_eval(model.cfg, card, dirs, root)
        mark("eval")
        gc.collect()
        torch.cuda.empty_cache()
        tools = phase_tools(model, card, root)
        mark("tools")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    q_serve, q_train = {}, {}
    q_serve["7b-int8"], q_train["7b-int8"] = phase_7b_int8(model, card)
    mark("7b_int8")
    del model                       # the 13B phase runs without the 7B
    gc.collect()
    torch.cuda.empty_cache()
    q_serve["13b-int4"], q_train["13b-int4"] = phase_13b_int4(card)
    mark("13b_int4")

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
        r, p, c = bwd["response"], bwd["prefix"], bwd["clip"]
        outs = (key,) if key == "dq" else ("dk", "dv")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "opadpo_torch/csrc/flash_bwd.cu",
            "replaces": "opadpo_tpu/ops/attention.py:"
                        + ("263" if key == "dq" else "302"),
            "launches": train["launches"][kname],
            "launches_per_train_step": steps[kname],
            "max_abs_err": max(x["err"][n] for x in (r, p, c) for n in outs),
            "max_row_rel_err": max(x["row_err"][n] for x in (r, p, c)
                                   for n in outs),
            "ms": r[key + "_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r[key + "_bound_ms"],
            "bound_by": r[key + "_bound_by"], "library_ms": r["library_ms"],
            "share_of_bound": r[key + "_share_of_bound"],
            "design": "tma+wgmma",
            "at": "[6,896 over 1599,32,128] bf16 causal offset 703 "
                  "(response stream); plain and library compute dq, dk, dv "
                  "together",
            **{name: {"ms": x[key + "_ms"], "plain_ms": x["plain_ms"],
                      "library_ms": x["library_ms"],
                      "bound_ms": x[key + "_bound_ms"],
                      "bound_by": x[key + "_bound_by"],
                      "share_of_bound": x[key + "_share_of_bound"]}
               for name, x in (("prefix", p), ("clip", c))},
            "clip_at": "[4,577,16,64] bf16 bidirectional, no key mask "
                       "(CLIP tower, stage 3)"})
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
    for entry in kernels:
        # the checkpoint paths' own runs, each counted from 0
        for label, res in (("stage4", stage4), ("stages12", stage12),
                           ("stage3", stage3), ("profiled_stage4", gaps)):
            if entry["name"] in res["launches"]:
                entry[f"launches_{label}"] = res["launches"][entry["name"]]
        if entry["name"] in stage3["launches_per_micro_step"]:
            entry["launches_per_stage3_micro_step"] = \
                stage3["launches_per_micro_step"][entry["name"]]
        key = {"flash_fwd": "launches_flash",
               "decode_attention_int8": "launches_decode"}.get(entry["name"])
        if key:
            entry["launches_serve_cli"] = (cli["base"][key]
                                           + cli["adapter"][key])
    tp2_kernel_entries(kernels, multi)
    tp_pool_kernel_entries(kernels, tpp)
    tools_kernel_entries(kernels, tools)
    pool_keys = ("s_used", "G", "err_out", "ms", "plain_ms", "bound_ms",
                 "bound_by", "ranks", "per")
    for entry in kernels:
        # the slot pool's runs (tiny reference, 7B serving, eval), each
        # counted from 0, and the kernel's times at the pool's shapes
        kname = entry["name"]
        if kname == "flash_fwd":
            entry["launches_continuous"] = {
                k: cont[k]["launches"][kname] for k in ("int8", "int4",
                                                       "spec k4")}
            entry["launches_eval"] = {
                "batch": ev["batch"]["launches"][kname],
                "continuous": ev["continuous"]["launches"][kname],
                "logit": ev["logit"]["launches_flash"]}
            entry["pool"] = [
                {"admit_group": c["shape"][0],
                 **{k: c[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "err_o")}}
                for c in pool["flash"]]
        group, run = {"decode_attention_int8": ("int8", "int8"),
                      "decode_attention_int4": ("int4", "int4"),
                      "decode_attention_multi": ("multi", "spec k4")
                      }.get(kname, (None, None))
        if group:
            entry["launches_continuous"] = cont[run]["launches"][kname]
            entry["launches_continuous_reference"] = \
                cont_ref[{"int8": "int8", "int4": "int4",
                          "multi": "spec k3"}[group]]["launches"][kname]
            if kname == "decode_attention_int8":
                entry["launches_eval_continuous"] = \
                    ev["continuous"]["launches"][kname]
            entry["pool"] = [{k: c[k] for k in pool_keys}
                             for c in pool[group]]
            entry["pool_at"] = (f"[{POOL_SLOTS},32,s_total,128] slot pool, "
                                "the watermarks its run visited")
    summary = {k: {m: cont[k][m] for m in ("generated_tok_per_s",
                                          "latency_p50_s", "latency_p99_s",
                                          "peak_gb")}
               for k in ("int8", "int4", "spec k4")}
    log(f"[continuous] {json.dumps(summary)}")
    log(f"[ckpt] load {ckpt['load_s']:.2f} s ({ckpt['load_gb_per_s']:.2f} "
        f"GB/s), peak host RSS {ckpt['peak_host_rss_gb']} GB; stage-4 "
        f"steps {stage4['step_s']} s; stage 1-2 sampling "
        f"{stage12['sample_s']} s; stage-3 micro-steps "
        f"{stage3['micro_step_s']} s, peak {stage3['peak_gb']:.2f} GB")
    log(f"[tp-pool, pruning, jpeg] seconds: TP pool {tpp['seconds']:.1f}, "
        f"pruned serve {pruned['seconds']:.1f}, native image "
        f"{native.get('seconds', 0.0):.1f}; card: {card}")
    mark("summary")
    log(f"[time] seconds by phase {json.dumps(_PHASE_S)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if len(sys.argv) == 3 and sys.argv[1] == "--rank-job":
            rc = rank_job(sys.argv[2])
        else:
            rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
