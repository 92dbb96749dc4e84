"""Attention, forward only: port of ``opadpo_tpu/ops/attention.py``.

``multi_head_attention`` is the entry point both the CLIP tower
(bidirectional) and the LLaMA prefill (causal) call.  The mask model is the
JAX one: a per-row key validity mask ``[B, S]`` plus an optional causal
rule ``col <= row``.

- On a CUDA tensor it launches the hand-written flash forward kernel
  (``csrc/flash_fwd.cu``, replacing the Pallas ``_fwd_kernel``).  It never
  falls back: a shape or dtype the kernel does not take raises.
- On a CPU tensor it runs ``mha_reference``, the plain version.

A fully masked query row comes out uniform over all keys, in both versions
(masked scores are the finite -1e30, as in JAX).  The backward kernels come
with the training slice; until then a call that needs gradients raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from opadpo_torch.ops import _build

NEG_INF = -1e30


def _check_no_grad(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash attention is forward-only in this port so far (the "
            "backward kernels come with the training slice); call it under "
            "torch.no_grad() or torch.inference_mode()")


def mha_reference_lse(q, k, v, key_mask=None, causal=True, scale=None):
    """Plain version: (o [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32).

    Scores in f32, masked with the finite -1e30, softmax in f32, the
    probabilities cast to v's dtype before the value product (as
    ``opadpo_tpu.ops.attention.mha_reference``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, sk = q.shape[1], k.shape[1]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        offset = sk - sq
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        mask = col <= row + offset
    mask = mask[None, None]
    if key_mask is not None:
        mask = mask & (key_mask != 0)[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return o.to(q.dtype), lse


def mha_reference(q, k, v, key_mask=None, causal=True, scale=None):
    return mha_reference_lse(q, k, v, key_mask, causal, scale)[0]


def flash_fwd_cuda(q, k, v, key_mask=None, causal=True, scale=None):
    """Launch the flash forward kernel → (o [B, S, H, D] bf16, lse
    [B, H, S] f32).  q, k, v: bf16 CUDA tensors [B, S, H, D], unit stride
    on D; any strides on B, S and H."""
    b, s, h, d = q.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd_cuda takes CUDA tensors")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"self-attention shapes only: q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("the flash kernel takes bf16 q, k, v")
    if d not in (32, 64, 128):
        raise ValueError(f"head dim {d} not supported (32, 64 or 128)")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("q/k/v need unit stride on D and 16-byte "
                             "aligned rows")
    if scale is None:
        scale = d ** -0.5
    kbias = None
    if key_mask is not None:
        if key_mask.shape != (b, s):
            raise ValueError(f"key_mask shape {tuple(key_mask.shape)}")
        kbias = torch.where(key_mask.to(q.device) != 0, 0.0,
                            NEG_INF).to(torch.float32).contiguous()
    o = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _lib()
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    err = lib.opadpo_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kbias.data_ptr() if kbias is not None else None,
        o.data_ptr(), lse.data_ptr(), b, s, h, d, strides, int(causal),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def _lib():
    lib = _build.load("flash_fwd.cu")
    fn = lib.opadpo_flash_fwd_bf16
    if not fn.argtypes:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [B, S, H, D] (the JAX public layout).

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    _check_no_grad(q, k, v)
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, key_mask, causal, scale)[0]
    if q.device.type == "cpu":
        return mha_reference(q, k, v, key_mask, causal, scale)
    raise ValueError(f"unsupported device {q.device}")


# the models' entry point; it dispatches on the device alone
multi_head_attention = flash_attention
