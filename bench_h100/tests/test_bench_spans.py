"""The readers of the port's own spans and counter (``program_spans``) on
made-up spans and device operations: the shares, the idle gaps inside the
steps, the syncs per step, and None where there is nothing to read."""

import pytest

from bench_h100 import program_spans, trace
from bench_h100.run import reader

SIX = ("forward_share.dpo", "backward_share.dpo", "recompute_share.dpo",
       "optimizer_share.dpo", "step_idle_share.dpo", "host_syncs.dpo")


class _Run:
    def __init__(self, window, kind="dpo"):
        self.window, self.kind = window, kind
        self.work, self.peak_bytes = {}, 0


def _span(name, i, parent, root, t0_us, t1_us, ms):
    return {"name": name, "id": i, "parent": parent, "root": root,
            "t0_ns": int(t0_us * 1e3), "t1_ns": int(t1_us * 1e3),
            "device_ms": ms}


def _spans():
    """Two steps in a window of 1 s (times in us): a score [0, 1e5), a
    step [1e5, 3.5e5) with its forward, backward (two recomputes in it)
    and AdamW; the second pair of roots likewise from 5e5."""
    out = []
    for k, base in enumerate((0.0, 5e5)):
        i = 10 * k
        out += [
            _span("dpo.score", i + 1, None, i + 1, base, base + 1e5, 100.0),
            _span("dpo.forward", i + 3, i + 2, i + 2, base + 1e5,
                  base + 2e5, 80.0),
            _span("remat.layer", i + 5, i + 4, i + 2, base + 2.2e5,
                  base + 2.4e5, 20.0),
            _span("remat.head", i + 6, i + 4, i + 2, base + 2.5e5,
                  base + 2.6e5, 10.0),
            _span("dpo.backward", i + 4, i + 2, i + 2, base + 2e5,
                  base + 3e5, 150.0),
            _span("adamw.apply", i + 7, i + 2, i + 2, base + 3e5,
                  base + 3.5e5, 5.0),
            _span("dpo.step", i + 2, None, i + 2, base + 1e5, base + 3.5e5,
                  240.0),
        ]
    return out


def _window(kernels):
    w = trace.Window(lambda: None, True)
    w.seconds = 1.0
    w.kernels = kernels
    return w


@pytest.fixture
def recorded(monkeypatch):
    snap = {"spans": _spans(), "counters": {"host_syncs": 2}}
    monkeypatch.setattr(program_spans, "recorded", lambda: snap)
    return snap


def test_nested_shares(recorded):
    run = _Run(_window([("k", 0.0, 1e6)]))
    assert reader("forward_share.dpo")(run) == pytest.approx(16.0)
    assert reader("backward_share.dpo")(run) == pytest.approx(30.0)
    assert reader("recompute_share.dpo")(run) == pytest.approx(6.0)
    assert reader("optimizer_share.dpo")(run) == pytest.approx(1.0)
    assert (reader("recompute_share.dpo")(run)
            <= reader("backward_share.dpo")(run))


def test_host_syncs_per_step(recorded):
    run = _Run(_window([("k", 0.0, 1e6)]))
    assert reader("host_syncs.dpo")(run) == pytest.approx(1.0)
    recorded["counters"] = {}
    assert reader("host_syncs.dpo")(run) == 0.0


def test_idle_gaps_inside_the_roots_only(recorded):
    """Roots cover [0, 3.5e5) and [5e5, 8.5e5).  Gaps between the merged
    operations: [1e5, 1.5e5) inside the first root, [3e5, 6e5) in part
    inside each ([3e5, 3.5e5) and [5e5, 6e5)), [9e5, 9.5e5) outside every
    root: 5e4 + 5e4 + 1e5 = 2e5 us of a 1 s window, 20 %."""
    kernels = [("a", 0.0, 5e4), ("b", 4e4, 1e5), ("c", 1.5e5, 3e5),
               ("e", 6e5, 9e5), ("f", 9.5e5, 1e6)]
    run = _Run(_window(kernels))
    idle = reader("step_idle_share.dpo")(run)
    assert idle == pytest.approx(20.0)
    whole = reader("idle_share.dpo")(run)
    assert whole == pytest.approx(40.0) and idle <= whole


def test_overlap_of_interval_lists():
    a = [(0, 10), (20, 30), (40, 50)]
    b = [(5, 25), (45, 60)]
    assert program_spans.overlap_us(a, b) == 15
    assert program_spans.overlap_us(a, []) == 0


@pytest.mark.parametrize("metric", SIX)
def test_none_without_spans(metric, monkeypatch):
    run = _Run(_window([("k", 0.0, 1e6)]))
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert reader(metric)(run) is None


@pytest.mark.parametrize("metric", SIX)
def test_none_for_another_kind(metric, recorded):
    assert reader(metric)(_Run(_window([("k", 0.0, 1e6)]), "sft")) is None


def test_none_without_device_times(recorded):
    """A span of a run without CUDA has no device time: no share."""
    for s in recorded["spans"]:
        s["device_ms"] = None
    run = _Run(_window([("k", 0.0, 1e6)]))
    assert reader("forward_share.dpo")(run) is None
    assert reader("step_idle_share.dpo")(run) == 0.0


def test_the_port_records_nothing_untraced():
    """Outside a profiler the port's store holds no span, so the readers
    find nothing (as in an untraced run or a program without spans)."""
    from opadpo_torch.utils import trace as program_trace

    program_trace.clear()
    assert program_spans.recorded() is None
