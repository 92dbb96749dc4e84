"""Spans and counters inside the port's steps, on the profiler's clock.

``span(name)`` marks a region of a step; ``count(name, n)`` adds to a
counter.  Both record only while a ``torch.profiler`` is running
(``torch.autograd._profiler_enabled()``), so a traced window of the
benchmark or an operator's ``profile_start_step`` trace turns them on and
nothing else does.  With no profiler running a span is one check and a
shared do-nothing context: no allocation, no launch, no synchronise.

While recording, a span

- opens ``torch.profiler.record_function(name)``, so it shows in the
  Chrome trace;
- stamps its host start and end with ``time.time_ns()`` inside that range,
  on the clock of Kineto's ``start_ns()`` (Unix-epoch nanoseconds), so a
  span can be set against the trace's device operations directly;
- where CUDA is in use, records a ``torch.cuda.Event`` pair on the current
  stream, read only by ``snapshot``, never during the step;
- keeps ``(name, id, parent, root, t0_ns, t1_ns)`` in memory.

The stack of open spans is one per process, not one per thread: on CUDA
the backward (and ``torch.utils.checkpoint``'s recompute inside it) runs
on the autograd engine's device thread while the caller waits in
``torch.autograd.grad``, and its spans still nest under the caller's.
``snapshot`` returns what was kept; ``pipeline.runtime.stop_profiler``
clears it after writing its trace.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Optional

import torch

_OFF = contextlib.nullcontext()


class _Store:
    """The process's spans, counters and stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.open: list = []            # [(id, root id)], outermost first
        self.spans: list = []           # finished _Span objects
        self.counters: dict = {}


_STORE = _Store()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "t0_ns", "t1_ns", "events",
                 "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        with _STORE.lock:
            self.id = next(_STORE.ids)
            self.parent, self.root = (_STORE.open[-1] if _STORE.open
                                      else (None, self.id))
            _STORE.open.append((self.id, self.root))
        self.t0_ns = time.time_ns()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.t1_ns = time.time_ns()
        with _STORE.lock:
            _STORE.open.remove((self.id, self.root))
            _STORE.spans.append(self)
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context marking a region named ``name`` (see the module
    docstring); a shared do-nothing context when no profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, while a profiler runs."""
    if not torch.autograd._profiler_enabled():
        return
    with _STORE.lock:
        _STORE.counters[name] = _STORE.counters.get(name, 0) + n


def rerun_span(fn, name: str):
    """``fn`` with every call after its first under ``span(name)``: handed
    to ``torch.utils.checkpoint``, the second call is the recompute in the
    backward.  ``fn`` itself when no profiler runs."""
    if not torch.autograd._profiler_enabled():
        return fn
    calls = 0

    def counted(*args):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*args)
        with span(name):
            return fn(*args)
    return counted


def _device_ms(s: _Span) -> Optional[float]:
    if s.events is None:
        return None
    s.events[1].synchronize()
    return s.events[0].elapsed_time(s.events[1])


def snapshot(clear: bool = False) -> dict:
    """``{"spans": [{name, id, parent, root, t0_ns, t1_ns, device_ms}],
    "counters": {name: n}}`` of what was recorded, spans in the order they
    ended; ``device_ms`` is the CUDA event pair's time (None without CUDA).
    ``clear``: forget it afterwards."""
    with _STORE.lock:
        spans, counters = list(_STORE.spans), dict(_STORE.counters)
        if clear:
            _STORE.spans, _STORE.counters = [], {}
    return {"spans": [{"name": s.name, "id": s.id, "parent": s.parent,
                       "root": s.root, "t0_ns": s.t0_ns, "t1_ns": s.t1_ns,
                       "device_ms": _device_ms(s)} for s in spans],
            "counters": counters}


def clear() -> None:
    """Forget every finished span and every counter."""
    with _STORE.lock:
        _STORE.spans, _STORE.counters = [], {}
