"""The measured window, and what a traced run reads from it.

``Window`` times the window on the host clock, ending in a device
synchronise.  With tracing on it also runs ``torch.profiler`` over the
window, reads the device's operations from the profiler's raw Kineto
events (building ``prof.events()`` takes minutes for a window's hundred
thousand events), and records a CUDA event pair around each span the
traffic module names, so a span's length is device time.

``classify`` sorts a device operation into a class by the work it does,
whatever implements it: the port's flash and head-layout kernels and a
library's fused attention alike are ``attention``.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict
from typing import Optional

import torch

ATTENTION = ("flash_fwd", "flash_bwd", "scatter_heads", "gather_heads",
             "fmha", "flash_attn", "flash::", "attention", "sdpa", "_mha")
DECODE_ATTENTION = ("decode_attn",)
QUANT_KERNELS = ("quant_mm_kernel", "q8_tile", "q8_decode", "q8t_tile",
                 "q4_tile", "q4_decode", "splitk_reduce")
INT8_GEMM = re.compile(r"(^|[^a-z0-9])(i8|s8|int8|imma|s8s8|i8i8)"
                       r"([^a-z0-9]|$)|_s8_|s8s8|i8i8|int8_gemm|imma")
GEMM = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "matmul")


def classify(name: str) -> str:
    n = name.lower()
    if any(k in n for k in DECODE_ATTENTION):
        return "decode_attn"
    if any(k in n for k in QUANT_KERNELS):
        return "quant_mm"
    if any(k in n for k in ATTENTION):
        return "attention"
    if any(k in n for k in GEMM):
        return "quant_mm" if INT8_GEMM.search(n) else "matmul"
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(hosts: list, starts: list, t: float, depth: int = 2000) -> str:
    """The innermost host operation running at ``t``: of those that
    contain it, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for h in reversed(hosts[max(0, i - depth):i]):
        if h[2] >= t:
            return h[0]
    return "(no host op)"


class Window:
    def __init__(self, sync, trace: bool):
        self.sync = sync
        self.trace = trace
        self.seconds: Optional[float] = None
        self.kernels: list = []          # (name, start_us, end_us)
        self.host: list = []             # (name, start_us, end_us)
        self.span_ms: dict = defaultdict(float)
        self._events: list = []
        self._prof = None
        self.read_s = 0.0

    @contextlib.contextmanager
    def spans(self, name: str):
        if not self.trace:
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(name):
            a.record()
            yield
            b.record()
        self._events.append((name, a, b))

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        self.sync()
        self.seconds = time.perf_counter() - self.t0
        if self._prof is not None:
            t = time.perf_counter()
            self._prof.__exit__(*exc)
            self._read(self._prof)
            self._prof = None
            self.read_s = time.perf_counter() - t
        return False

    def _read(self, prof) -> None:
        from torch.autograd import DeviceType

        for e in prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            if e.is_user_annotation():
                continue        # a span's range, not work of the device
            if e.device_type() == DeviceType.CUDA:
                self.kernels.append(item)
            else:
                self.host.append(item)
        for name, a, b in self._events:
            self.span_ms[name] += a.elapsed_time(b)
        self._events = []

    # -- what the readers and the result line take --------------------------

    def busy_s(self) -> float:
        return busy_us((s, e) for _, s, e in self.kernels) / 1e6

    def class_seconds(self, cls: str) -> float:
        return sum(e - s for n, s, e in self.kernels
                   if classify(n) == cls) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = defaultdict(float)
        for n, s, e in self.kernels:
            by_name[n] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged((s, e) for _, s, e in self.kernels)
        gaps = sorted(((busy[i][1], busy[i + 1][0])
                       for i in range(len(busy) - 1)),
                      key=lambda g: g[0] - g[1])[:2000]
        hosts = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        by_host: dict = defaultdict(float)
        for g0, g1 in gaps:
            by_host[_host_at(hosts, starts, (g0 + g1) / 2)] += (g1 - g0) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}
