"""Decode attention over the int8 prompt-KV cache: port of
``opadpo_tpu/ops/decode_attention.py`` (``decode_attention_prompt``).

One query token per (batch, head) against the head-major int8 prompt cache
``[B, H, Sp_pad, hd]`` with per-(b, h, s) f32 scales and an additive prompt
bias ``[B, Sp_pad]`` (0 valid / -1e30 masked or padding).  Returns the
UNNORMALISED output and the softmax state (m, l), so the caller merges the
bf16 suffix by logsumexp (``models/llama._decode_layer``).

- On a CUDA tensor it launches ``csrc/decode_attention.cu`` (replacing the
  Pallas ``_kernel``); it never falls back.
- On a CPU tensor it runs ``decode_attention_prompt_plain``.

Both follow the TPU kernel's numerics: the query is rounded to bf16, the K
scale is folded into the score and the V scale into the probability, and
``p * v_scale`` is rounded to bf16 before the value product; m starts at
-1e30.  Both normalise against the global max in one pass, which the TPU
kernel also does whenever ``s_used`` fits one of its sequence blocks
(<= 1024).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from opadpo_torch.device import on_cuda
from opadpo_torch.ops import _build

NEG_INF = -1e30
ALIGN = 128


def _s_used(k_scale, s_used):
    sp = k_scale.shape[2]
    if s_used is None:
        return sp
    if not (0 < s_used <= sp and s_used % ALIGN == 0):
        raise ValueError(f"s_used={s_used} must be a positive multiple of "
                         f"{ALIGN} and <= {sp}")
    return s_used


def decode_attention_prompt_plain(q, pk_q, k_scale, pv_q, v_scale, bias,
                                  sm_scale, s_used=None):
    sp = _s_used(k_scale, s_used)
    qf = q.to(torch.bfloat16).float()
    s = torch.einsum("bhd,bhsd->bhs", qf, pk_q[:, :, :sp].float())
    s = s * (k_scale[:, :, :sp] * sm_scale) + bias[:, None, :sp]
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pw = (p * v_scale[:, :, :sp]).to(torch.bfloat16).float()
    out = torch.einsum("bhs,bhsd->bhd", pw, pv_q[:, :, :sp].float())
    return out, m, l


def decode_attention_cuda(q, pk_q, k_scale, pv_q, v_scale, bias, sm_scale,
                          s_used=None):
    b, h, sp, hd = pk_q.shape
    su = _s_used(k_scale, s_used)
    if hd not in (64, 128):
        raise ValueError(f"head dim {hd} not supported (64 or 128)")
    expect = {"q": (q, (b, h, hd), torch.bfloat16),
              "pk_q": (pk_q, (b, h, sp, hd), torch.int8),
              "pv_q": (pv_q, (b, h, sp, hd), torch.int8),
              "k_scale": (k_scale, (b, h, sp), torch.float32),
              "v_scale": (v_scale, (b, h, sp), torch.float32),
              "bias": (bias, (b, sp), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if not t.is_cuda or tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: expected contiguous CUDA {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    fn = _fn()
    err = fn(q.data_ptr(), pk_q.data_ptr(), k_scale.data_ptr(),
             pv_q.data_ptr(), v_scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, sp, hd, su,
             float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out, m, l


decode_attention_cuda.launches = 0


def _fn():
    fn = _build.load("decode_attention.cu").opadpo_decode_attn_int8
    if not fn.argtypes:
        vp = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_prompt(q: torch.Tensor, pk_q: torch.Tensor,
                            k_scale: torch.Tensor, pv_q: torch.Tensor,
                            v_scale: torch.Tensor, bias: torch.Tensor,
                            sm_scale: float, s_used: Optional[int] = None):
    """→ (out_unnormalised [B, H, hd] f32, m [B, H] f32, l [B, H] f32).

    ``s_used`` (a 128-multiple) limits the read to the first ``s_used``
    cache positions."""
    fn = decode_attention_cuda if on_cuda(q) else \
        decode_attention_prompt_plain
    return fn(q, pk_q, k_scale, pv_q, v_scale, bias, sm_scale, s_used)
