"""``BENCHMARK.json`` and the files it names: every cell, configuration,
traffic, limit and metric resolves, and the file keeps to the contract's
shapes."""

import importlib
import json
import math
import re

import pytest

from bench_h100.run import HERE, Spec, reader
from bench_h100.tests.common import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert b["paths"] == ["bench_h100"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32
    cells = len(b["workloads"])
    budget = 2 + 14 * 24
    assert (budget * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200), "run_seconds must fit the full 24 cells"
    assert 1 <= cells <= 24


def test_names_units_and_entry_keys():
    b = bench()
    seen = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench_h100/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves(cell):
    spec = Spec.load(bench(), cell, ROOT)
    assert spec.traffic_module().run
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(spec.limits)
    assert all(0 < v < math.inf for v in spec.limits.values())
    names = {m["name"] for m in spec.end_to_end()}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer(), "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(reader(metric))


def test_every_configuration_is_used_and_states_its_precision():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        for group in ("training", "control"):
            assert {"bits", "act_bits", "act_bwd_int8"} <= set(cfg[group])
        assert cfg["reduced"] == c["reduced"]


def test_every_traffic_names_its_module():
    for path in (HERE / "traffic").glob("*.json"):
        tp = json.loads(path.read_text())
        mod = importlib.import_module(f"bench_h100.traffic.{tp['generator']}")
        assert hasattr(mod, "run") and hasattr(mod, "program_side")
