"""The per-layer metrics that read what the port records inside its steps
in a traced run: the spans and counters of ``opadpo_torch.utils.trace``,
which record while the window's profiler runs.  A span's host stamps are
on the clock of the window's device operations (Unix-epoch, Kineto's), and
its ``device_ms`` is a CUDA event pair's time.  A reader returns None where
the run has nothing for it to read, never 0: an untraced run, a traffic of
another kind, or a program that records no spans."""

from __future__ import annotations

from typing import Optional

from bench_h100 import trace


def recorded() -> Optional[dict]:
    """The port's spans and counters (``trace.snapshot()``), or None where
    it recorded no span or has no such module."""
    try:
        from opadpo_torch.utils import trace as program_trace
    except ImportError:
        return None
    snap = program_trace.snapshot()
    return snap if snap["spans"] else None


def overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint
    [start, end) intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_share(kind: str, names: tuple):
    """The spans named ``names``: their device time (``device_ms``),
    summed, over the window's length, in %."""
    def read(run):
        snap = recorded() if run.kind == kind else None
        if snap is None:
            return None
        ms = [s["device_ms"] for s in snap["spans"] if s["name"] in names]
        if not ms or None in ms:
            return None
        return 100.0 * sum(ms) / 1e3 / run.window.seconds
    return read


def idle_within(kind: str, roots: tuple):
    """The gaps between the window's merged device operations that fall
    inside the host intervals of the spans named ``roots``, every gap
    counted, over the window's length, in %."""
    def read(run):
        snap = recorded() if run.kind == kind else None
        if snap is None or not run.window.kernels:
            return None
        spans = trace.merged((s["t0_ns"] / 1e3, s["t1_ns"] / 1e3)
                             for s in snap["spans"] if s["name"] in roots)
        if not spans:
            return None
        busy = trace.merged((s, e) for _, s, e in run.window.kernels)
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        return 100.0 * overlap_us(gaps, spans) / 1e6 / run.window.seconds
    return read


def per_span(kind: str, counter: str, name: str):
    """The counter ``counter`` over the number of spans named ``name``."""
    def read(run):
        snap = recorded() if run.kind == kind else None
        if snap is None:
            return None
        n = sum(s["name"] == name for s in snap["spans"])
        if not n:
            return None
        return snap["counters"].get(counter, 0) / n
    return read
