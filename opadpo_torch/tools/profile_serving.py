"""Where the serving path's time goes: ``torch.profiler`` over one prefill
and the decode after it (16 tokens by default), on LLaVA-1.5-7B (or
``--model 13b``) at full width (random weights from a seed: bf16, or with
``--bits 8`` / ``4`` an int8 / int4 base, and with ``--head-bits`` a
quantized decode head), a batch of 8 left-padded prompts of 128 tokens
with one image each, greedy, through the ``Sampler``: an int8 prompt
cache by default (``--kv-bits 4`` packed int4, 16 bf16), with
``--chunk N`` chunked decode folding every N steps (set ``--steps`` past
N to see a fold), with ``--spec-k K`` speculative decode (K drafts per
verify, ``--spec-advance``).  The defaults are the shapes of
``chip_smoke.py``'s serving paths.

    python -m opadpo_torch.tools.profile_serving [--model 7b|13b]
        [--bits 16|8|4] [--head-bits 16|8|4] [--kv-bits 16|8|4]
        [--chunk N] [--spec-k K] [--spec-advance shared|per_row]
        [--steps N] [--json PATH]

For each phase it prints the host time (ending in a device synchronise)
with and without the profiler, the device's busy time (the union of the
kernels' intervals) and its share of either host time, and the device
time by kernel group and by kernel, largest first.  The card's name and
power limit come from ``nvidia-smi``.  ``--device cpu`` rehearses the
control flow on the tiny model on the CPU, where there are no device
times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from opadpo_torch.constants import IMAGE_TOKEN_INDEX
from opadpo_torch.device import resolve_device
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import llava

BATCH = 8
QLEN = 128
DECODE_STEPS = 16


def kernel_group(name: str) -> str:
    n = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "scatter_heads", "gather_heads"):
        if kernel + "_kernel" in n:
            return kernel + " (csrc)"
    # #6 is the int8 kernel at one query; #8 runs it at G 2..8 on the paths
    for kernel, group in (("decode_attn_multi_kernel<128, 1>", "int8"),
                          ("decode_attn_multi_kernel<64, 1>", "int8"),
                          ("decode_attn_int4_kernel", "int4"),
                          ("decode_attn_multi_kernel", "multi")):
        if kernel in n:
            return f"decode_attention_{group} (csrc)"
    if any(k in n for k in ("quant_mm_kernel", "splitk_reduce",
                            "q8_tile_kernel", "q8_decode_kernel",
                            "q8t_tile_kernel", "q4_tile_kernel",
                            "q4_decode_kernel")):
        return "quant_matmul (csrc)"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                            "splitk")):
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copy / set"
    return "other (elementwise, reductions, indexing)"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarise(kernels, host_s: float, top: int = 12) -> dict:
    """kernels: [(name, start_us, end_us)] of one phase."""
    by_name: dict = defaultdict(lambda: [0, 0.0])
    by_group: dict = defaultdict(float)
    for name, s, e in kernels:
        by_name[name][0] += 1
        by_name[name][1] += e - s
        by_group[kernel_group(name)] += e - s
    busy = busy_us([(s, e) for _, s, e in kernels])
    return {
        "host_ms": host_s * 1e3,
        "kernels": len(kernels),
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / (host_s * 1e6),
        "groups_ms": {g: t / 1e3 for g, t in
                      sorted(by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:100], "count": c, "ms": t / 1e3}
                        for n, (c, t) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][1])
                        [:top]],
    }


def make_inputs(cfg, batch: int, qlen: int, dev, seed: int = 0):
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(5, cfg.llama.vocab_size, (batch, qlen), generator=g,
                        device=dev)
    pos = torch.arange(qlen, device=dev)[None, :]
    pad = (torch.arange(batch, device=dev) * (qlen // 16))[:, None]
    mask = (pos >= pad).to(torch.int64)              # left padding per row
    ids = torch.where(mask != 0, ids, 0)
    ids[torch.arange(batch, device=dev), pad[:, 0] + 1] = IMAGE_TOKEN_INDEX
    sz = cfg.vision.image_size
    images = torch.randn(batch, sz, sz, 3, generator=g, device=dev)
    return ids, mask, images


def make_model(name: str, bits: int, dev, cuda: bool, seed: int = 0,
               mode=None):
    """(cfg, random model): LLaVA-1.5-7B or -13B on the GPU, the tiny one
    on the CPU; bf16 weights, or drawn straight into an int8 / int4 base."""
    cfg = ({"7b": llava.LlavaConfig.llava_7b,
            "13b": llava.LlavaConfig.llava_13b}[name]() if cuda
           else llava.LlavaConfig.tiny())
    gen = torch.Generator(device=dev).manual_seed(seed)
    if bits == 16:
        return cfg, llava.init_params(cfg, gen, device=dev), gen
    kw = {} if mode is None else {"mode": mode}
    return cfg, llava.init_params_quantized(cfg, gen, bits, dev, **kw), gen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cpu runs the tiny model instead of the 7B / 13B")
    ap.add_argument("--model", choices=("7b", "13b"), default="7b")
    ap.add_argument("--bits", type=int, choices=(16, 8, 4), default=16,
                    help="the base's block linears: bf16, int8 or int4")
    ap.add_argument("--head-bits", type=int, choices=(16, 8, 4), default=16,
                    help="the decode head: bf16, int8 or int4")
    ap.add_argument("--kv-bits", type=int, choices=(16, 8, 4), default=8,
                    help="the prompt cache: bf16, int8 or packed int4")
    ap.add_argument("--chunk", type=int, default=0,
                    help="chunked decode: fold the suffix every N steps")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode: K drafts per verify")
    ap.add_argument("--spec-advance", choices=("shared", "per_row"),
                    default="shared")
    ap.add_argument("--steps", type=int, default=DECODE_STEPS,
                    help="decode steps (tokens after the first)")
    ap.add_argument("--json", help="also write the summary here")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, model, _ = make_model(args.model, args.bits, dev, cuda)
    ids, mask, images = make_inputs(cfg, BATCH, QLEN, dev)
    sampler = Sampler(
        SamplingConfig(greedy=True, max_new_tokens=args.steps + 1,
                       eos_token_id=-1),
        kv_bits=args.kv_bits, head_bits=args.head_bits, chunk=args.chunk,
        spec_k=args.spec_k, spec_advance=args.spec_advance)
    head = sampler.decode_head(model)

    def prefill():
        return sampler.prefill(model, ids, mask, images, head=head)

    def decode(pf):
        return sampler.decode(model, pf, head=head)

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        return out, time.perf_counter() - t0

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0] if cuda else "cpu"
    result = {"card": card,
              "model": f"llava_{args.model}" if cuda else "tiny",
              "bits": args.bits, "head_bits": args.head_bits,
              "kv_bits": args.kv_bits, "chunk": args.chunk,
              "spec_k": args.spec_k, "spec_advance": args.spec_advance,
              "batch": BATCH, "qlen": QLEN}
    with torch.inference_mode():
        decode(timed(prefill)[0])                     # warm-up
        pf, pf_s = timed(prefill)
        (_, info), dec_s = timed(decode, pf)
        n_fwd = info["decode_steps"]
        result["decode"] = info
        phases = {}
        for name, fn, a, plain_s in (("prefill", prefill, (), pf_s),
                                     ("decode", decode, (pf,), dec_s)):
            with profile(activities=acts) as prof:
                _, host_s = timed(fn, *a)
            kernels = [(e.name, e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            if cuda and not kernels:
                raise RuntimeError("the profiler recorded no device events")
            summary = summarise(kernels, host_s)
            summary["device_busy_share_unprofiled"] = \
                summary["device_busy_ms"] / (plain_s * 1e3)
            phases[name] = {"unprofiled_ms": plain_s * 1e3, **summary}
    for key in ("unprofiled_ms", "host_ms", "kernels", "device_busy_ms"):
        phases["decode"][key + "_per_step"] = phases["decode"][key] / n_fwd
    result["phases"] = phases
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
