"""What the port's benches and profilers share: the card's line, the
timers, the device-busy union and the kernel grouping of a profile, the
build of a full-width LLaVA from a seed, and where a tool writes its
record.

Every tool runs on the card by default (``--device cuda``); ``--device
cpu --model tiny`` rehearses it on the tiny model with the kernels' plain
versions.  On a CUDA tensor a kernel is launched or the tool raises: no
tool falls back to a plain version there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict
from typing import Callable, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from opadpo_torch.device import resolve_device
from opadpo_torch.models import llava
from opadpo_torch.ops.quant import QuantMode

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS = ("7b", "13b", "tiny")


def default_out(tool: str) -> str:
    """``build/tools/<tool>.json`` under the repository (``build/`` is
    git-ignored)."""
    return os.path.join(REPO, "build", "tools", f"{tool}.json")


def write_record(record: dict, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def add_device_args(ap: argparse.ArgumentParser, tool: str,
                    model_default: str = "7b",
                    models=MODELS) -> None:
    """``--device``, ``--model`` and ``--out``, as every tool has them."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which takes --model tiny")
    ap.add_argument("--model", choices=models, default=model_default)
    ap.add_argument("--out", default=None,
                    help=f"the JSON record (default build/tools/{tool}.json)")


def device_of(args) -> torch.device:
    """The tool's device; the CPU runs the tiny model only."""
    dev = resolve_device(args.device)
    if dev.type == "cpu" and args.model != "tiny":
        raise ValueError("--device cpu rehearses the tool on --model tiny")
    return dev


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable, dev: torch.device, *a, **kw):
    """(fn's result, host seconds ending in a device synchronise)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    sync(dev)
    return out, time.perf_counter() - t0


def to_device(batch: dict, dev) -> dict:
    """A numpy batch -> tensors on ``dev``, int32 ids widened to int64."""
    import numpy as np

    return {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.int64) if v.dtype == np.int32 else v)).to(dev)
        for k, v in batch.items()}


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gb(dev: torch.device) -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` in GB (None on the CPU)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------

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


def activities(dev: torch.device) -> list:
    return [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])


def device_kernels(prof) -> list:
    """[(name, start_us, end_us)] of a finished profile's device events,
    read from its raw Kineto events (building ``prof.events()``' operator
    tree takes minutes for a decode segment's hundred thousand events).
    A ``record_function`` range's projection on the device (a user
    annotation, such as the steps' spans) is not work of the device and is
    left out."""
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def profile_phase(fn: Callable, dev: torch.device, plain_s: float,
                  top: int = 12, trace: Optional[str] = None):
    """(fn's result, ``summarise`` of one profiled call of ``fn`` beside
    ``plain_s``, the same call's host seconds without the profiler);
    ``trace``: also write the Chrome trace there."""
    with profile(activities=activities(dev)) as prof:
        out, host_s = timed(fn, dev)
    kernels = device_kernels(prof)
    if dev.type == "cuda" and not kernels:
        raise RuntimeError("the profiler recorded no device events")
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    summary = summarise(kernels, host_s, top=top)
    summary["unprofiled_ms"] = plain_s * 1e3
    summary["device_busy_share_unprofiled"] = \
        summary["device_busy_ms"] / max(plain_s * 1e3, 1e-9)
    return out, summary


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def llava_config(name: str) -> llava.LlavaConfig:
    return {"7b": llava.LlavaConfig.llava_7b,
            "13b": llava.LlavaConfig.llava_13b,
            "tiny": llava.LlavaConfig.tiny}[name]()


def make_model(name: str, bits: int, dev: torch.device, seed: int = 0,
               mode: Optional[QuantMode] = None):
    """(cfg, random model, its generator): LLaVA-1.5-7B, -13B or the tiny
    one, on ``dev``, drawn from ``seed`` (weights N(0, 0.02)); bf16 weights,
    or drawn straight into an int8 / int4 base (``bits`` 8 / 4, with the
    w8a8 switches of ``mode``)."""
    cfg = llava_config(name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if bits == 16:
        return cfg, llava.init_params(cfg, gen, device=dev), gen
    kw = {} if mode is None else {"mode": mode}
    return cfg, llava.init_params_quantized(cfg, gen, bits, dev, **kw), gen


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def base_bits(model) -> int:
    """16, or the bits of the model's quantized block linears."""
    from opadpo_torch.ops.quant import QuantLinear

    for m in model.llama.layers[0].children():
        if isinstance(m, QuantLinear):
            return m.bits
    return 16
