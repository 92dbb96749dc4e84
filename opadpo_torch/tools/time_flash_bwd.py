"""The flash backward kernels, dQ (#2) and dK/dV (#3), at ``chip_smoke.py``'s
two shapes (the causal prefix [2, 703, 32, 128] and the response stream
[6, 896 over 1599, 32, 128], left-padded keys): checked against the plain
backward and timed as the smoke times them (CUDA-event medians, the L2
flushed before each launch), beside SDPA's backward and the bounds.  Prints
the card and one JSON line ``{"card": ..., "ms": {shape: {"dq": ms, "dkv":
ms}}, "cases": {...}}``.

    python -m opadpo_torch.tools.time_flash_bwd

It measures the checkout it runs in (its ``chip_smoke.py`` and
``opadpo_torch``), so two commits compare in one call by running this file
from each checkout's root, with that root on ``PYTHONPATH``, in turns
(A, B, B, A).  Needs a GPU.
"""

from __future__ import annotations

import json
import sys

SHAPES = (("prefix", (2, 703, 703, 32, 128)),
          ("response", (6, 896, 1599, 32, 128)))


def main() -> int:
    import torch

    sys.path.insert(0, ".")
    import chip_smoke

    if not torch.cuda.is_available():
        print("time_flash_bwd needs a GPU", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    cases = {name: chip_smoke._bwd_case(*args, g, flush)
             for name, args in SHAPES}
    print(json.dumps({"card": card,
                      "ms": {n: {"dq": c["dq_ms"], "dkv": c["dkv_ms"]}
                             for n, c in cases.items()},
                      "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
