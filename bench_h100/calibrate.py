"""The readings that a cell's limits are set from, on the card.

    python3 -m bench_h100.calibrate --workload <cell> --seeds 11 12 ...
        [--variants sound control half_batch ...] [--out PATH]

For each seed the program runs once per variant (``sound``: as the
configuration states; ``control``: in the configuration's ``control``
precision; any other name: that fault planted in the timed path, as
``traffic/<generator>.py`` knows them) through set-up and its checked
steps, and the reference once; each variant's numbers are its gaps to
that reference (with the three worst leaves of each leaf number).
One JSON line per seed goes to standard output and to
``--out``.  The lower reading of a number is the largest over the sound
seeds, the upper the smallest of the control and the faults (step 4 of
the check's rule, in ``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from bench_h100.run import Context, Spec, forbidden_modules, load_json


def worst(program: dict, reference: dict, n: int = 3) -> list:
    """The ``n`` leaves with the largest gaps: (name, program, reference)."""
    import statistics

    med = statistics.median(reference.values())
    gap = {k: abs(program[k] - reference[k]) / max(reference[k], med)
           for k in reference}
    return [(k, program[k], reference[k]) for k in
            sorted(gap, key=gap.get, reverse=True)[:n]]


def readings(spec: Spec, seed: int, variants: list, device="cuda") -> dict:
    mod = spec.traffic_module()
    progs = {}
    for v in variants:
        ctx = Context(spec, seed, 0.0, False, device,
                      faults=() if v in ("sound", "control") else (v,),
                      control=v == "control")
        t = time.perf_counter()
        rec = mod.program_side(ctx, window=False)
        progs[v] = {"rec": rec, "seconds": time.perf_counter() - t}
    ctx = Context(spec, seed, 0.0, False, device)
    t = time.perf_counter()
    ref = mod.reference_side(ctx)
    out = {"seed": seed, "reference_s": time.perf_counter() - t}
    for v, p in progs.items():
        out[v] = dict(mod.compare(p["rec"], ref),
                      setup_s=p["rec"]["setup_s"], program_s=p["seconds"],
                      peak_bytes=p["rec"]["peak_bytes"],
                      losses=p["rec"]["losses"],
                      worst_grads=worst(p["rec"]["grads"], ref["grads"]),
                      worst_changes=worst(p["rec"]["changes"],
                                          ref["changes"]))
    out["ref_losses"] = ref["losses"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["sound"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = Path.cwd()
    spec = Spec.load(load_json(root / "BENCHMARK.json"), args.workload, root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line = json.dumps(readings(spec, seed, args.variants))
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    if forbidden_modules():
        print(f"loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
