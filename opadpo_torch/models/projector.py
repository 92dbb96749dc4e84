"""mm_projector ``mlp2x_gelu``: port of ``opadpo_tpu/models/projector.py``.

Linear(1024 -> D) -> exact GELU in f32 -> Linear(D -> D), both with bias."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from opadpo_torch.models.lora import lora_dense, tree_get


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    in_dim: int = 1024
    out_dim: int = 4096
    dtype: torch.dtype = torch.bfloat16


class Projector(nn.Module):
    def __init__(self, cfg: ProjectorConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.in_dim, cfg.out_dim, dtype=cfg.dtype)
        self.fc2 = nn.Linear(cfg.out_dim, cfg.out_dim, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor, lora=None,
                lora_scaling: float = 1.0) -> torch.Tensor:
        h = lora_dense(x, self.fc1.weight, tree_get(lora, "fc1"),
                       lora_scaling) + self.fc1.bias
        h = F.gelu(h.float()).to(x.dtype)
        h = lora_dense(h, self.fc2.weight, tree_get(lora, "fc2"),
                       lora_scaling)
        return h + self.fc2.bias
