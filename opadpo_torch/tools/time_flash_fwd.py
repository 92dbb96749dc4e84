"""The flash forward kernel (#1) at ``chip_smoke.py``'s three shapes (LLaMA
prefill [8, 703, 32, 128] causal, CLIP [8, 577, 16, 64] bidirectional, the
response stream [6, 896 over 1599, 32, 128]): checked against its plain
version and timed as the smoke times it (CUDA-event medians, the L2 flushed
before each launch), beside SDPA and the bound.  Prints the card and one
JSON line ``{"card": ..., "ms": {shape: ms}, "cases": {...}}``.

    python -m opadpo_torch.tools.time_flash_fwd

It measures the checkout it runs in (its ``chip_smoke.py`` and
``opadpo_torch``), so two commits compare in one call by running this file
from each checkout's root, with that root on ``PYTHONPATH``, in turns.
Needs a GPU.
"""

from __future__ import annotations

import json
import sys

SHAPES = (("llama", (8, 703, 703, 32, 128, True)),
          ("clip", (8, 577, 577, 16, 64, False)),
          ("response", (6, 896, 1599, 32, 128, True)))


def main() -> int:
    import torch

    sys.path.insert(0, ".")
    import chip_smoke

    if not torch.cuda.is_available():
        print("time_flash_fwd needs a GPU", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    cases = {name: chip_smoke._flash_case(*args, g, flush)
             for name, args in SHAPES}
    print(json.dumps({"card": card,
                      "ms": {n: c["ms"] for n, c in cases.items()},
                      "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
