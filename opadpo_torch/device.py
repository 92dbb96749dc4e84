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


def on_cuda(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper launches its kernel for ``t`` (a CUDA
    tensor) or runs its plain version (a CPU tensor); anything else
    raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"
