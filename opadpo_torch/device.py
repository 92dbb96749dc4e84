"""Device selection for the port's entry points.

Entry points default to ``"cuda"``.  Without a GPU they raise instead of
carrying on quietly on the CPU: the CPU runs only when a caller asks for it
(the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
