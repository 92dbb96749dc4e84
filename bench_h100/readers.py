"""The arithmetic of the per-layer metrics, one function per kind of
reading; each file under ``metrics/`` binds one of them to the traffic it
reads (``kind``: the cell's traffic ``generator``).  A reader returns
None where the run has nothing for it to read, never 0."""

from __future__ import annotations

from bench_h100 import work


def span_share(kind: str, span: str):
    """A span's share of the window: the device time between the CUDA
    events around each call, summed, over the window's length, in %."""
    def read(run):
        ms = run.window.span_ms.get(span)
        if run.kind != kind or not ms:
            return None
        return 100.0 * ms / 1e3 / run.window.seconds
    return read


def mfu(kind: str):
    """The step's share of the card's peak: the least time the window's
    required work could take (``work.least_seconds``) over the window's
    length, in %."""
    def read(run):
        if run.kind != kind or not run.work:
            return None
        return 100.0 * work.least_seconds(run.work) / run.window.seconds
    return read


def roofline(kind: str, cls: str, precision: str):
    """A class of kernels' share of its roofline: the least time of the
    work of that class the window needs (``work.least_seconds_of``) over
    the device time of the operations that do it
    (``trace.classify``), in %."""
    def read(run):
        if run.kind != kind or not run.work.get(cls + ".flops"):
            return None
        busy = run.window.class_seconds(cls)
        if busy <= 0:
            return None
        return 100.0 * work.least_seconds_of(run.work, cls, precision) / busy
    return read


def idle_share(kind: str):
    """1 - the union of the device operations' intervals over the
    window's length, in %."""
    def read(run):
        if run.kind != kind:
            return None
        return 100.0 * (1.0 - run.window.busy_s() / run.window.seconds)
    return read


def peak_gb(kind: str):
    """``torch.cuda.max_memory_allocated`` from the weights' arrival
    through the window, in GB."""
    def read(run):
        if run.kind != kind or not run.peak_bytes:
            return None
        return run.peak_bytes / 1e9
    return read
