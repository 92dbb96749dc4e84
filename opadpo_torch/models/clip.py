"""CLIP ViT-L/14-336 vision tower: port of ``opadpo_tpu/models/clip.py``.

Numerics follow HF ``CLIPVisionModel`` as the JAX tower does: the 14x14
stride-14 patch convolution is patchify + matmul (a matmul keeps f32 runs
in full f32, where cuDNN's convolution would default to TF32); CLS and
position embeddings, ``pre_norm``; pre-LN blocks with quick_gelu in f32
and bidirectional attention.  Layer -2 is selected, so only the first 23 of
24 blocks exist, and CLS is dropped at the end.  With ``remat`` each block
runs under ``torch.utils.checkpoint`` while grad is enabled (the JAX tower
scans its blocks under ``jax.checkpoint``), so a backward through the
tower (the OPA-SFT recipe's vision adapter) keeps one activation a block
and recomputes the rest.  The block linears may be
quantized (``ops/quant.QuantLinear``, their biases kept in the model
dtype); the patch embedding stays in the model dtype.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from opadpo_torch.models.llama import maybe_remat
from opadpo_torch.models.lora import lora_dense, tree_get
from opadpo_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    num_layers: int = 24
    select_layer: int = -2
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_active_layers(self) -> int:
        return self.num_layers + self.select_layer + 1

    @staticmethod
    def tiny() -> "ClipVisionConfig":
        return ClipVisionConfig(image_size=28, patch_size=14, hidden_size=64,
                                intermediate_size=128, num_heads=2,
                                num_layers=3)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in f32 with f32 parameters, cast back to x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.sigmoid(1.702 * x32)).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, (H/p)*(W/p), 3*p*p], each patch in (c, ph, pw)
    order, the order of HF's conv weight [out, 3, p, p] flattened."""
    b, hgt, wid, c = images.shape
    gh, gw = hgt // patch, wid // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch * patch)


class ClipBlock(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        d, i, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        f32 = torch.float32
        self.cfg = cfg
        self.ln1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, dtype=f32)
        self.ln2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, dtype=f32)
        self.wq = nn.Linear(d, d, dtype=dt)
        self.wk = nn.Linear(d, d, dtype=dt)
        self.wv = nn.Linear(d, d, dtype=dt)
        self.wo = nn.Linear(d, d, dtype=dt)
        self.fc1 = nn.Linear(d, i, dtype=dt)
        self.fc2 = nn.Linear(i, d, dtype=dt)

    def _dense(self, x, name, ll, scaling):
        lin = getattr(self, name)        # nn.Linear or QuantLinear
        return lora_dense(x, lin, tree_get(ll, name), scaling) + lin.bias

    def forward(self, x, ll=None, scaling: float = 1.0):
        b, seq, d = x.shape
        nh, hd = self.cfg.num_heads, self.cfg.head_dim
        h = layer_norm(x, self.ln1)
        q = self._dense(h, "wq", ll, scaling).view(b, seq, nh, hd)
        k = self._dense(h, "wk", ll, scaling).view(b, seq, nh, hd)
        v = self._dense(h, "wv", ll, scaling).view(b, seq, nh, hd)
        attn = multi_head_attention(q, k, v, key_mask=None, causal=False)
        x = x + self._dense(attn.reshape(b, seq, d), "wo", ll, scaling)
        h = layer_norm(x, self.ln2)
        h = quick_gelu(self._dense(h, "fc1", ll, scaling))
        return x + self._dense(h, "fc2", ll, scaling)


class ClipVisionTower(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.dtype
        self.cfg = cfg
        self.patch_embed = nn.Linear(3 * cfg.patch_size ** 2, d, bias=False,
                                     dtype=dt)
        self.class_embed = nn.Parameter(torch.empty(d, dtype=dt))
        self.pos_embed = nn.Parameter(torch.empty(cfg.num_patches + 1, d,
                                                  dtype=dt))
        self.pre_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps,
                                     dtype=torch.float32)
        self.layers = nn.ModuleList(ClipBlock(cfg)
                                    for _ in range(cfg.num_active_layers))

    def forward(self, images: torch.Tensor, lora=None,
                lora_scaling: float = 1.0, remat: bool = True
                ) -> torch.Tensor:
        """[B, H, W, 3] normalised images -> patch features [B, P, D]."""
        cfg = self.cfg
        b = images.shape[0]
        patches = patchify(images.to(cfg.dtype), cfg.patch_size)
        x = lora_dense(patches, self.patch_embed.weight,
                       tree_get(lora, "patch_embed"), lora_scaling)
        cls = self.class_embed.to(x.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)[None]
        x = layer_norm(x, self.pre_norm)
        for i, blk in enumerate(self.layers):
            x = maybe_remat(blk, remat, x, tree_get(lora, "layers", i),
                             lora_scaling)
        return x[:, 1:, :]
