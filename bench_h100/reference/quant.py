"""The quantization rules that a configuration states, in plain PyTorch,
worked out again from the bf16 weights (never taken from the program).

- int8 weights: symmetric per output channel, absmax / 127, rounded half
  to even, codes in [-127, 127];
- int4 weights: symmetric per group of 128 along the input, absmax / 7,
  codes in [-8, 7];
- w8a8: each token's activations rounded to int8 on its own absmax / 127
  before the product with the int8 weight; with the int8 dx, the output
  gradient times the weight scale is rounded the same way per token before
  the product with the codes.
"""

from __future__ import annotations

import torch

GROUP = 128


def int8_codes(w: torch.Tensor):
    """[N, K] -> (f32 codes [N, K], f32 scale [N, 1])."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    return torch.clamp(torch.round(w32 / scale), -127, 127), scale


def int4_values(w: torch.Tensor) -> torch.Tensor:
    """[N, K] -> the f32 values of its int4 codes times their scales."""
    n, k = w.shape
    w32 = w.float().reshape(n, k // GROUP, GROUP)
    amax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 7.0)
    return (torch.clamp(torch.round(w32 / scale), -8, 7) * scale).reshape(n, k)


def rows_int8(x: torch.Tensor, floor: float) -> torch.Tensor:
    """Each row of ``x`` rounded to 255 levels of its own absmax (f32)."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=floor)
    return torch.clamp(torch.round(x * (127.0 / amax)), -127, 127) * (
        amax / 127.0)


class W8A8(torch.autograd.Function):
    """``rows_int8(x) @ (codes * scale)^T``, differentiable in x; the dx is
    exact or, with ``int8_dx``, ``rows_int8(g * scale^T) @ codes``."""

    @staticmethod
    def forward(ctx, x, codes, scale, int8_dx: bool):
        ctx.save_for_backward(codes, scale)
        ctx.int8_dx = int8_dx
        return rows_int8(x, 1e-8) @ (codes * scale).t()

    @staticmethod
    def backward(ctx, g):
        codes, scale = ctx.saved_tensors
        if ctx.int8_dx:
            return rows_int8(g * scale.t(), 1e-20) @ codes, None, None, None
        return g @ (codes * scale), None, None, None


def base_product(x: torch.Tensor, w: torch.Tensor, precision: dict):
    """``x @ W^T`` in f32 for a quantizable linear's bf16 weight ``w`` under
    the configuration's precision."""
    bits = precision["bits"]
    if bits == 16:
        return x @ w.float().t()
    if bits == 4:
        return x @ int4_values(w).t()
    codes, scale = int8_codes(w)
    if precision["act_bits"] == 8:
        return W8A8.apply(x, codes, scale, bool(precision["act_bwd_int8"]))
    return x @ (codes * scale).t()
