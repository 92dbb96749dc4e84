"""What the harness's CPU tests share: the tiny configuration and a tiny
DPO traffic, as a ``Spec`` that ``run.run_cell`` drives on the CPU."""

from __future__ import annotations

from pathlib import Path

from bench_h100.run import Spec, load_json

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
TINY_LIMITS = {"loss_gap": 2e-4, "grad_gap": 0.02, "change_gap": 0.02,
               "score_gap": 0.05, "grad_mean_gap": 0.01}


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


TINY_TRAFFIC = {"dpo": {"query_len": 8, "query_min": 4, "response_len": 16,
                        "response_min": 6},
                "sft": {"text_len": 24, "text_min": 12, "unlabelled": 6}}


def tiny_spec(traffic: str = "dpo-copo-b2", limits=None,
              **precision) -> Spec:
    """The tiny model under a traffic file's own parameters, its lengths
    cut to the tiny sizes; ``precision`` overrides the configuration's."""
    cfg = load_json(HERE / "tiny.json")
    cfg["training"].update(precision)
    tp = load_json(ROOT / "bench_h100/traffic" / f"{traffic}.json")
    tp.update(TINY_TRAFFIC[tp["generator"]])
    cells = {w["traffic"]: w for w in bench()["workloads"]}
    w = cells.get(traffic, {"name": traffic, "traffic": traffic, "chips": 1})
    return Spec(bench(), dict(w, config="tiny"), cfg, tp,
                dict(limits or TINY_LIMITS))
