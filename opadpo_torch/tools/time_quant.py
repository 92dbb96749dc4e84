"""The int8 matmuls #9 and #10 at ``chip_smoke.py``'s path shapes (7B int8
decode M 8 and its f32 head, the prefix M 703, CLIP M 577; #10's dx at M
703), and the int4 matmul #11 at the 13B int4 paths' shapes (decode M 1
and 8 and the prefix M 703 at the three decoder widths, CLIP M 577 at its
three, the 13B head at M 1 and path A's head at M 8, both f32 out),
checked against their plain versions and timed as the smoke times them
(CUDA-event medians, the L2 flushed before each launch), beside the
library route and the bound.  Prints the card and one JSON line ``{"card":
..., "ms": {shape: ms}, "cases": [...]}``.

    python -m opadpo_torch.tools.time_quant [--crossover] [--bn 64|256]
        [--bn4 64|128]

``--crossover`` adds M 1024, 1406 and 2688 (#9 and #10 at 4096 x 4096,
#11 at 5120 x 5120), beside dequantize + matmul and the int8 GEMM route;
``--bn`` runs every #9 call above 16 rows at that many weight rows a CTA
in place of ``quant.tile_bn``'s choice, ``--bn4`` every #11 call (this
checkout's kernels only).  It measures the
checkout it runs in (its ``chip_smoke.py`` and ``opadpo_torch``), so two
commits compare in one call by running this file from each checkout's
root, with that root on ``PYTHONPATH``, in turns (``python
path/to/time_quant.py`` runs these shapes against an older checkout too).
Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys

# (kernel, M, K, N, f32 out); for #10 the gradient is [M, N], dx [M, K]
SHAPES = (("q8", 8, 4096, 4096, False), ("q8", 8, 4096, 11008, False),
          ("q8", 8, 11008, 4096, False), ("q8", 8, 4096, 32000, True),
          ("q8", 703, 4096, 4096, False), ("q8", 703, 4096, 11008, False),
          ("q8", 703, 11008, 4096, False), ("q8", 577, 1024, 1024, False),
          ("q8", 577, 1024, 4096, False), ("q8t", 703, 4096, 4096, False),
          ("q8t", 703, 4096, 11008, False), ("q8t", 703, 11008, 4096, False),
          *(("q4", m, k, n, False) for m in (1, 8, 703)
            for k, n in ((5120, 5120), (5120, 13824), (13824, 5120))),
          *(("q4", 577, k, n, False)
            for k, n in ((1024, 1024), (1024, 4096), (4096, 1024))),
          ("q4", 1, 5120, 32000, True), ("q4", 8, 4096, 32000, True))
CROSSOVER = tuple((kind, m, k, k, False)
                  for kind, k in (("q8", 4096), ("q8t", 4096), ("q4", 5120))
                  for m in (1024, 1406, 2688))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--bn", type=int, choices=(64, 256))
    ap.add_argument("--bn4", type=int, choices=(64, 128))
    args = ap.parse_args()
    sys.path.insert(0, ".")
    import chip_smoke
    from opadpo_torch.ops import quant

    rule = quant.tile_bn

    def pinned(m, n, sms, wide=256):
        return (args.bn if wide == 256 else args.bn4) or rule(m, n, sms,
                                                               wide)

    if args.bn or args.bn4:
        quant.tile_bn = pinned

    if not torch.cuda.is_available():
        print("time_quant needs a GPU", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    shapes = SHAPES + (CROSSOVER if args.crossover else ())
    cases = [chip_smoke._quant_case(kind, m, k, n, g, flush, f32)
             for kind, m, k, n, f32 in shapes]
    print(json.dumps({"card": card, "bn": args.bn, "bn4": args.bn4,
                      "ms": {f"{c['kernel']} M {c['m']} K {c['k']} N "
                             f"{c['n']}": c["ms"] for c in cases},
                      "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
