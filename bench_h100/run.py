"""One run of one cell of the port's benchmark.

    python3 -m bench_h100.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout:

- the cell (``workloads``) names its configuration and its traffic;
- ``bench_h100/configs/<config>.json``: the model's sizes and precision;
- ``bench_h100/traffic/<traffic>.json``: the traffic's parameters, whose
  ``generator`` names its module ``bench_h100/traffic/<generator>.py``;
- ``bench_h100/workloads/<cell>.json``: the limits of the cell's check;
- ``bench_h100/metrics/<metric>.py``: each per-layer metric's reader,
  ``read(run) -> value or None``.

The traffic module makes the inputs from the seed, builds the port, warms it up
(set-up), measures a window of whole steps of ``--seconds`` or more, and
checks what the timed path produced against the plain reference.  The
last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; last comes
``check``, each number compared beside its limit, which also ends
standard error.

No result is printed, and the exit code is not 0, where the card is
missing or fewer cards are visible than the cell asks for, or where the
process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "opadpo_tpu")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """A cell and everything named for it."""

    def __init__(self, bench: dict, cell: dict, cfg: dict, traffic: dict,
                 limits: dict):
        self.bench, self.cell, self.cfg = bench, cell, cfg
        self.traffic, self.limits = traffic, limits

    @staticmethod
    def load(bench: dict, cell: str, root: Path) -> "Spec":
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
        w = cells[cell]
        configs = {c["name"]: c for c in bench["configs"]}
        return Spec(bench, w,
                    load_json(root / configs[w["config"]]["file"]),
                    load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                    load_json(HERE / "workloads" / f"{cell}.json")["limits"])

    def traffic_module(self):
        return importlib.import_module(
            f"bench_h100.traffic.{self.traffic['generator']}")

    def end_to_end(self) -> list:
        name = self.cell["name"]
        return [m for m in self.bench["end_to_end"]
                if name in m.get("workloads", [name])]

    def per_layer(self) -> list:
        name = self.cell["name"]
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_h100.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a traffic module gets: the cell's files, the run's arguments,
    and the device's clock, memory and window."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool,
                 device, faults=(), control: bool = False):
        import torch

        self.torch = torch
        self.cell = spec.cell
        self.cfg, self.traffic = spec.cfg, spec.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.faults = tuple(faults)
        t = self.cfg["control" if control else "training"]
        self.program_precision = {k: t[k] for k in
                                  ("bits", "act_bits", "act_bwd_int8")}

    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda():
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda():
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if self.cuda():
            return int(self.torch.cuda.max_memory_allocated(self.device))
        return 0

    def release(self) -> None:
        import gc
        gc.collect()
        if self.cuda():
            self.torch.cuda.empty_cache()

    def window(self):
        from bench_h100.trace import Window
        return Window(self.sync, self.trace)

    def log(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)


class RunView:
    """What a per-layer metric's reader sees of a traced run."""

    def __init__(self, spec: Spec, rec: dict):
        self.kind = spec.traffic["generator"]
        self.window = rec["window"]
        self.work = rec.get("work") or {}
        self.peak_bytes = rec["peak_bytes"]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device="cuda", faults=(), control: bool = False) -> dict:
    """The traffic module's record of one run, with ``correct`` and the
    rows of the check (the harness's look for a card is the caller's)."""
    from bench_h100 import check

    ctx = Context(spec, seed, seconds, trace, device, faults, control)
    rec = spec.traffic_module().run(ctx)
    rec["correct"], rec["check_rows"] = check.judge(rec["checks"],
                                                    spec.limits)
    return rec


def result_line(spec: Spec, rec: dict, trace: bool, device_kind: str,
                count: int) -> dict:
    metrics = {}
    units = {m["name"]: m["unit"] for m in
             spec.bench["end_to_end"] + spec.bench["per_layer"]}
    if trace:
        view = RunView(spec, rec)
        for m in spec.per_layer():
            value: Optional[float] = reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = dict(rec["metrics"], setup_s=rec["setup_s"])
        for m in spec.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": rec["peak_bytes"]}
    line = {"correct": bool(rec["correct"]), "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace:
        w = rec["window"]
        device.update(busy_s=w.busy_s(), window_s=w.seconds)
        line["breakdown"] = w.breakdown()
    line["check"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rec["check_rows"]}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path.cwd()
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    bench = load_json(root / "BENCHMARK.json")
    spec = Spec.load(bench, args.workload, root)

    import torch

    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    rec = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(spec, rec, bool(args.trace),
                       torch.cuda.get_device_name(0), chips)
    for name, v, lim in rec["check_rows"]:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
