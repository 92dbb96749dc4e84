"""Decode attention over the quantized prompt-KV cache: port of
``opadpo_tpu/ops/decode_attention.py`` (``decode_attention_prompt``,
``decode_attention_prompt4`` and ``decode_attention_prompt_multi``).

Queries against the head-major prompt cache with per-(b, h, s) f32 scales
and an additive prompt bias ``[B, Sp_pad]`` (0 valid / -1e30 masked or
padding).  Each returns the UNNORMALISED output and the softmax state
(m, l), so the caller merges the bf16 suffix by logsumexp
(``models/llama._attend``):

- ``decode_attention_prompt``: one query per (b, h), int8 cache
  ``[B, H, Sp_pad, hd]``;
- ``decode_attention_prompt4``: the same over the int4 cache packed
  group-local half-split ``[B, H, Sp_pad/2, hd]`` (256-position groups:
  byte ``g*128 + r`` holds position ``g*256 + r`` in its low nibble and
  ``g*256 + 128 + r`` in its high one); lengths are 256-multiples;
- ``decode_attention_prompt_multi``: G queries per (b, h) ``[B, H, G, hd]``
  over the int8 cache in one pass (speculative verify), G <= 8.

On a CUDA tensor each launches its kernel in ``csrc/decode_attention.cu``
(replacing the Pallas ``_kernel``, ``_kernel4`` and ``_kernel_multi``) and
never falls back; on a CPU tensor it runs its ``*_plain`` version.  The
three share one kernel body: each (b, h)'s prefix is split over a cluster
of up to 8 CTAs, as ``decode_split`` fixes, and the softmax is merged at
the global max in distributed shared memory.  ``decode_attention_prompt``
(#6) is the int8 kernel of ``decode_attention_prompt_multi`` (#8) at one
query; it keeps its own launch counter.

All follow the TPU kernels' numerics: the query is rounded to bf16, the K
scale is folded into the score and the V scale into the probability, and
``p * v_scale`` is rounded to bf16 before the value product; m starts at
-1e30.  They normalise against the global max, which the TPU kernels also
do whenever ``s_used`` fits one of their sequence blocks (<= 1024 for the
int8 kernels, 128 for ``_kernel4``); elsewhere m is the same and (out / l,
m + log l) differ by where ``p * v_scale`` was rounded.  The scores equal
the plain versions' bit for bit; the kernels sum the value products in
another f32 order (within each rank, then the ranks in order), the same
in every launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from opadpo_torch.device import on_cuda
from opadpo_torch.ops import _build

NEG_INF = -1e30
ALIGN = 128            # int8 cache: lengths and s_used are multiples of it
ALIGN4 = 256           # int4 cache: the packed group
MAX_G = 8              # queries per (b, h) the multi-query kernel takes
MAX_RANKS = 8          # CTAs of a (b, h)'s cluster: the portable maximum
MAX_SLICE = 2048       # positions a rank holds (scores, scales, bias in its
                       # shared memory); so s_used <= 8 * 2048
TARGET_CTAS = 600      # CTAs a launch keeps within, so that all are
                       # resident at once (4 an SM at G > 1); 1024 ran
                       # slower at most path shapes on an H100 (PERF.md)
TARGET_CTAS_INT8_1 = 768  # the same for the int8 cache at one query (#6,
                          # 8 an SM): at B * H 256 and s_used 768, 3 ranks
                          # ran 2 % faster than 2, and 6 (two waves) 17 %
                          # slower, on an H100 (PERF.md)


def _s_used(k_scale, s_used, align=ALIGN):
    sp = k_scale.shape[2]
    if s_used is None:
        return sp
    if not (0 < s_used <= sp and s_used % align == 0):
        raise ValueError(f"s_used={s_used} must be a positive multiple of "
                         f"{align} and <= {sp}")
    return s_used


def decode_split(s_used: int, bh: int, packed: bool, queries: int = 1):
    """The cluster of a decode launch of ``queries`` queries over ``bh`` =
    B * H heads reading ``s_used`` positions -> ``(n, per)``: ``n`` <= 8
    ranks a (b, h), rank r owning positions [r * per, min(s_used, (r + 1)
    * per)), each at least one position, ``per`` whole chunks of 128 cache
    rows (128 positions int8, 256 packed).  Ranks are added while the
    launch stays within its target of CTAs (all resident at once:
    ``TARGET_CTAS_INT8_1`` for the int8 cache at one query, else
    ``TARGET_CTAS``), one more where that splits the chunks evenly, and
    past that only as far as a slice must shrink to ``MAX_SLICE``."""
    unit = ALIGN4 if packed else ALIGN
    if s_used <= 0 or s_used % unit:
        raise ValueError(f"s_used={s_used} must be a positive multiple of "
                         f"{unit}")
    units = s_used // unit
    target = TARGET_CTAS_INT8_1 if queries == 1 and not packed \
        else TARGET_CTAS
    n = min(MAX_RANKS, units, max(1, target // bh))
    if units % n and n < MAX_RANKS and units % (n + 1) == 0:
        n += 1
    n = max(n, min(MAX_RANKS, -(-units // (MAX_SLICE // unit))))
    per_units = -(-units // n)
    if per_units * unit > MAX_SLICE:
        raise ValueError(f"s_used={s_used}: the decode kernels read at "
                         f"most {MAX_RANKS * MAX_SLICE} positions")
    return -(-units // per_units), per_units * unit


def unpack_int4_kv(packed: torch.Tensor) -> torch.Tensor:
    """Packed int4 cache ``[B, H, S/2, hd]`` -> int8 codes ``[B, H, S, hd]``
    in [-8, 7] (S a multiple of 256)."""
    b, h, s2, hd = packed.shape
    p = packed.reshape(b, h, s2 // 128, 128, hd).to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=3).reshape(b, h, 2 * s2, hd).to(
        torch.int8)


def _dots(qf, k):
    """q . k for every query [B, H, G, hd] and cache row [B, H, S, hd] ->
    [B, H, G, S] f32, summed in the kernel's order: 16 products in
    sequence per 16-wide part, then the parts halved pairwise (the lanes'
    butterfly).  The products of a bf16 query and an int8 code are exact
    in f32, so the kernel's fused multiply-adds round as these do: the
    scores, and so the bf16-rounded ``p * v_scale``, match it bit for
    bit."""
    b, h, g, hd = qf.shape
    qv = qf.reshape(b, h, g, 1, hd // 16, 16)
    kv = k.float().reshape(b, h, 1, k.shape[2], hd // 16, 16)
    d = qv[..., 0] * kv[..., 0]
    for i in range(1, 16):
        d = d + qv[..., i] * kv[..., i]
    while d.shape[-1] > 1:
        half = d.shape[-1] // 2
        d = d[..., :half] + d[..., half:]
    return d[..., 0]


def decode_attention_prompt_multi_plain(q, pk_q, k_scale, pv_q, v_scale,
                                        bias, sm_scale, s_used=None):
    sp = _s_used(k_scale, s_used)
    qf = q.to(torch.bfloat16).float()
    s = _dots(qf, pk_q[:, :, :sp])
    s = s * (k_scale[:, :, None, :sp] * sm_scale) + bias[:, None, None, :sp]
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pw = (p * v_scale[:, :, None, :sp]).to(torch.bfloat16).float()
    out = torch.einsum("bhgs,bhsd->bhgd", pw, pv_q[:, :, :sp].float())
    return out, m, l


def _one_query(fn, q, *args):
    out, m, l = fn(q[:, :, None], *args)
    return out[:, :, 0], m[..., 0], l[..., 0]


def decode_attention_prompt_plain(q, pk_q, k_scale, pv_q, v_scale, bias,
                                  sm_scale, s_used=None):
    return _one_query(decode_attention_prompt_multi_plain, q, pk_q, k_scale,
                      pv_q, v_scale, bias, sm_scale, s_used)


def decode_attention_prompt4_plain(q, pk_q4, k_scale, pv_q4, v_scale, bias,
                                   sm_scale, s_used=None):
    sp = _s_used(k_scale, s_used, ALIGN4)
    return decode_attention_prompt_plain(
        q, unpack_int4_kv(pk_q4[:, :, :sp // 2]), k_scale,
        unpack_int4_kv(pv_q4[:, :, :sp // 2]), v_scale, bias, sm_scale, sp)


def _launch(q, pk, k_scale, pv, v_scale, bias, sm_scale, s_used, kind,
            split=None):
    """One launch of ``opadpo_decode_attn`` for q ``[B, H, G, hd]`` ->
    (out [B, H, G, hd], m [B, H, G], l [B, H, G]), all f32.  ``kind``: 0
    is #6, 1 #7 (packed cache), 2 #8.  ``split`` ``(n, per)`` replaces
    ``decode_split``'s cluster (``chip_smoke.py`` times the choices)."""
    packed = kind == 1
    b, h, sp = k_scale.shape
    gq, hd = q.shape[2], q.shape[3]
    su = _s_used(k_scale, s_used, ALIGN4 if packed else ALIGN)
    if hd not in (64, 128):
        raise ValueError(f"head dim {hd} not supported (64 or 128)")
    if not 1 <= gq <= (MAX_G if kind == 2 else 1):
        raise ValueError(f"{gq} queries per head: the kernel takes 1..."
                         f"{MAX_G if kind == 2 else 1}")
    n, per = split or decode_split(su, b * h, packed, gq)
    if sp % 4:
        raise ValueError(f"cache length {sp}: the decode kernels take a "
                         "multiple of 4 (16-byte rows of scales and bias)")
    q = q.to(torch.bfloat16).contiguous()
    rows = sp // 2 if packed else sp
    expect = {"q": (q, (b, h, gq, hd), torch.bfloat16),
              "pk": (pk, (b, h, rows, hd), torch.int8),
              "pv": (pv, (b, h, rows, hd), torch.int8),
              "k_scale": (k_scale, (b, h, sp), torch.float32),
              "v_scale": (v_scale, (b, h, sp), torch.float32),
              "bias": (bias, (b, sp), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if not t.is_cuda or tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: expected contiguous CUDA {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((b, h, gq, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, gq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, gq), dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), pk.data_ptr(), k_scale.data_ptr(),
                pv.data_ptr(), v_scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, gq, sp, hd,
                su, kind, n, per, float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    return out, m, l


def decode_attention_cuda(q, pk_q, k_scale, pv_q, v_scale, bias, sm_scale,
                          s_used=None):
    """Kernel #6: one query [B, H, hd] over the int8 cache."""
    res = _one_query(_launch, q, pk_q, k_scale, pv_q, v_scale, bias,
                     sm_scale, s_used, 0)
    decode_attention_cuda.launches += 1
    return res


def decode_attention4_cuda(q, pk_q4, k_scale, pv_q4, v_scale, bias,
                           sm_scale, s_used=None):
    """Kernel #7: one query [B, H, hd] over the packed int4 cache."""
    res = _one_query(_launch, q, pk_q4, k_scale, pv_q4, v_scale, bias,
                     sm_scale, s_used, 1)
    decode_attention4_cuda.launches += 1
    return res


def decode_attention_multi_cuda(q, pk_q, k_scale, pv_q, v_scale, bias,
                                sm_scale, s_used=None):
    """Kernel #8: G queries [B, H, G, hd] over the int8 cache."""
    res = _launch(q, pk_q, k_scale, pv_q, v_scale, bias, sm_scale, s_used,
                  2)
    decode_attention_multi_cuda.launches += 1
    return res


decode_attention_cuda.launches = 0
decode_attention4_cuda.launches = 0
decode_attention_multi_cuda.launches = 0


def _fn():
    fn = _build.load("decode_attention.cu").opadpo_decode_attn
    if not fn.argtypes:
        vp = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                       i, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_prompt(q: torch.Tensor, pk_q: torch.Tensor,
                            k_scale: torch.Tensor, pv_q: torch.Tensor,
                            v_scale: torch.Tensor, bias: torch.Tensor,
                            sm_scale: float, s_used: Optional[int] = None):
    """-> (out_unnormalised [B, H, hd] f32, m [B, H] f32, l [B, H] f32).

    ``s_used`` (a 128-multiple) limits the read to the first ``s_used``
    cache positions."""
    fn = decode_attention_cuda if on_cuda(q) else \
        decode_attention_prompt_plain
    return fn(q, pk_q, k_scale, pv_q, v_scale, bias, sm_scale, s_used)


def decode_attention_prompt4(q: torch.Tensor, pk_q4: torch.Tensor,
                             k_scale: torch.Tensor, pv_q4: torch.Tensor,
                             v_scale: torch.Tensor, bias: torch.Tensor,
                             sm_scale: float, s_used: Optional[int] = None):
    """``decode_attention_prompt`` over the packed int4 cache
    ``[B, H, Sp_pad/2, hd]``; ``s_used`` a 256-multiple."""
    fn = decode_attention4_cuda if on_cuda(q) else \
        decode_attention_prompt4_plain
    return fn(q, pk_q4, k_scale, pv_q4, v_scale, bias, sm_scale, s_used)


def decode_attention_prompt_multi(q: torch.Tensor, pk_q: torch.Tensor,
                                  k_scale: torch.Tensor, pv_q: torch.Tensor,
                                  v_scale: torch.Tensor, bias: torch.Tensor,
                                  sm_scale: float,
                                  s_used: Optional[int] = None):
    """G queries ``[B, H, G, hd]`` over the int8 cache in one pass ->
    (out_unnormalised [B, H, G, hd], m [B, H, G], l [B, H, G]), f32.  No
    causal mask: every prompt position precedes every query."""
    fn = decode_attention_multi_cuda if on_cuda(q) else \
        decode_attention_prompt_multi_plain
    return fn(q, pk_q, k_scale, pv_q, v_scale, bias, sm_scale, s_used)
