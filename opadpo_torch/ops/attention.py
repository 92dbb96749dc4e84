"""Attention: port of ``opadpo_tpu/ops/attention.py``.

The mask model is the JAX one: a per-row key validity mask ``[B, Skv]``
plus an optional causal rule ``col <= row + offset``.  ``Sq`` queries may
attend ``Skv >= Sq`` keys; the queries are aligned to the end of the keys,
so ``offset = Skv - Sq`` (0 for self-attention, the prefix length for the
shared-prefix response stream, whose keys are ``[prefix ++ response]``).

- ``flash_attention`` (and ``multi_head_attention``, the models' entry
  point) runs forward and backward: on CUDA tensors the hand-written
  kernels (``csrc/flash_fwd.cu`` replacing the Pallas ``_fwd_kernel``,
  ``csrc/flash_bwd.cu`` replacing ``_dq_kernel`` and ``_dkv_kernel``), on
  CPU tensors the plain versions ``mha_reference_lse`` and
  ``flash_bwd_reference``.  A CUDA tensor never falls back: a shape or
  dtype the kernels do not take raises.
- ``flash_attention_fused`` and ``flash_attention_fused_shared`` run
  attention straight from the projection outputs ``[B, S, H*hd]``, with the
  head split and RoPE in the ``heads_layout`` kernels.

A fully masked query row comes out uniform over all keys in both versions
(masked scores are the finite -1e30, as in JAX); its log-sum-exp is -1e30
in f32, so the backward's P for it is exp(0) = 1 on every key: finite,
never NaN.  Nothing downstream reads such rows, so their output gradient
is zero on the training path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from opadpo_torch.device import on_cuda
from opadpo_torch.ops import _build
from opadpo_torch.ops.heads_layout import to_heads

NEG_INF = -1e30


def _visible(sq, sk, key_mask, causal, device):
    """Boolean [B or 1, 1, Sq, Sk]: col <= row + (Sk - Sq) and a valid key."""
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        row = torch.arange(sq, device=device)[:, None]
        col = torch.arange(sk, device=device)[None, :]
        mask = col <= row + (sk - sq)
    mask = mask[None, None]
    if key_mask is not None:
        mask = mask & (key_mask != 0)[:, None, None, :]
    return mask


def _scores(q, k, key_mask, causal, scale):
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _visible(q.shape[1], k.shape[1], key_mask, causal, q.device)
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def mha_reference_lse(q, k, v, key_mask=None, causal=True, scale=None):
    """Plain version: (o [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32).

    Scores in f32, masked with the finite -1e30, softmax in f32, the
    probabilities cast to v's dtype before the value product (as
    ``opadpo_tpu.ops.attention.mha_reference``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _scores(q, k, key_mask, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return o.to(q.dtype), lse


def mha_reference(q, k, v, key_mask=None, causal=True, scale=None):
    return mha_reference_lse(q, k, v, key_mask, causal, scale)[0]


def flash_bwd_reference(q, k, v, key_mask, causal, scale, o, lse, do):
    """Plain backward, the math of the JAX ``_flash_bwd``: P rebuilt from
    the saved ``lse``, delta = rowsum(dO * O), dS = P (dP - delta) scale;
    dS is cast to k's (q's) dtype before dQ (dK), P to dO's before dV.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    p = torch.exp(_scores(q, k, key_mask, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # [B, H, Sq]
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda_qkv(q, k, v, d_allowed):
    b, sq, h, d = q.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the flash kernels take CUDA tensors")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d) \
            or k.shape[1] < sq:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: need [B, Sq, H, D] queries "
                         "over [B, Skv >= Sq, H, D] keys")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("the flash kernels take bf16 q, k, v")
    if d not in d_allowed:
        raise ValueError(f"head dim {d} not supported {d_allowed}")
    _check_rows(q, k, v)


def _check_rows(*tensors):
    for t in tensors:
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("[B, S, H, D] inputs need unit stride on D and "
                             "16-byte aligned rows")


def _key_valid(key_mask, b, skv, device):
    """The key mask as a boolean [B, Skv] on ``device``, or None."""
    if key_mask is None:
        return None
    if key_mask.shape != (b, skv):
        raise ValueError(f"key_mask shape {tuple(key_mask.shape)}")
    return key_mask.to(device) != 0


def _bias_of(valid):
    """f32 additive key bias: 0 on valid keys, -1e30 on masked ones."""
    if valid is None:
        return None
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32).contiguous()


# the forward kernel's tiles: query rows per CTA, keys per K/V tile
FWD_BQ = 128
FWD_BK = 128
# the backward kernels' tiles: each CTA owns 128 rows (queries in dQ, keys
# in dK/dV) and walks tiles of 64 of the others
BWD_OWN = 128
BWD_WALK = 64


@functools.lru_cache(maxsize=64)
def _steps(n: int, step: int, shift: int, device) -> torch.Tensor:
    """int32 [n]: shift, shift + step, ..., shift + (n - 1) step."""
    return torch.arange(shift, shift + n * step, step, dtype=torch.int32,
                        device=device)


def blind_rows(valid, sq: int, skv: int,
               causal: bool) -> Optional[torch.Tensor]:
    """The query rows of each batch row that see no valid key, int32 [B],
    for a boolean key mask ``valid`` [B, Skv] (None when ``valid`` is None:
    then every row sees key 0).  They always lead: causal, row r sees keys
    [0, r + offset] (offset Skv - Sq), so with its first valid key at f
    (Skv if none) it is blind iff f > r + offset, and the blind rows are
    [0, clamp(f - offset, 0, Sq)); without causal masking, all Sq rows or
    none.  Such a row comes out uniform over every key, and the backward's
    P for it is 1 on every key.  The forward's and both backward kernels'
    walks follow from it (``kv_tile_count``, ``q_tile_walk``)."""
    if valid is None:
        return None
    if not causal:
        return torch.full((valid.shape[0],), sq, dtype=torch.int32,
                          device=valid.device).masked_fill_(valid.any(1), 0)
    # min over valid keys c of clamp(c - offset, 0, Sq), Sq if none: no key
    # index exceeds Skv - 1 - offset = Sq - 1, so the cached index needs
    # only its lower clamp, and a row with no valid key takes Sq
    return torch.where(valid, _key_rows(skv, skv - sq, valid.device),
                       sq).amin(1)


@functools.lru_cache(maxsize=64)
def _key_rows(skv: int, offset: int, device) -> torch.Tensor:
    """int32 [Skv]: max(c - offset, 0), the query rows a valid key c
    leaves blind."""
    return _steps(skv, 1, -offset, device).clamp(min=0)


@functools.lru_cache(maxsize=64)
def _diagonal_tiles(sq: int, skv: int, causal: bool, bq: int, bk: int,
                    device) -> torch.Tensor:
    """int32 [1, ceil(Sq / bq)]: the key tiles up to each query tile's
    diagonal, ``min(nkv, ceil((q0 + bq + offset) / bk))``, or all ``nkv``
    of them when not causal."""
    nkv = -(-skv // bk)
    nq = -(-sq // bq)
    if not causal:
        return torch.full((1, nq), nkv, dtype=torch.int32, device=device)
    ends = _steps(nq, bq, bq + (skv - sq) + bk - 1, device)   # q0 = 0, bq, ...
    return ends.div(bk, rounding_mode="floor").clamp_(max=nkv)[None]


def kv_tile_count(blind, sq: int, skv: int, causal: bool, device=None,
                  bq: int = FWD_BQ, bk: int = FWD_BK) -> torch.Tensor:
    """The key tiles (of ``bk``) a query tile (of ``bq`` rows) walks, int32
    [B, ceil(Sq / bq)] for the blind rows ``blind`` [B] of ``blind_rows``
    ([1, ...] for every batch row when ``blind`` is None).  Not causal: all
    of them.  Causal: those up to the tile's diagonal, unless the tile's
    first row is blind; then a row of the tile averages over every key (as
    ``mha_reference_lse`` gives it), and the tile walks them all.  The
    forward kernel reads it at its 128 x 128 tiles and the dQ kernel at
    128 x 64 (``BWD_OWN`` x ``BWD_WALK``), so their producers and consumers
    agree on it before the loop."""
    diag = _diagonal_tiles(sq, skv, causal, bq, bk,
                           torch.device(device or blind.device))
    if blind is None or not causal:
        return diag
    q0 = _steps(diag.shape[1], bq, 0, blind.device)
    return torch.where(q0 < blind[:, None], -(-skv // bk), diag)


@functools.lru_cache(maxsize=64)
def _walk_starts(sq: int, skv: int, causal: bool, bq: int, bk: int,
                 device) -> torch.Tensor:
    """int32 [ceil(Skv / bk)]: the first query tile (of ``bq``) that key
    tile t (of ``bk``) is visible to, ``max(0, t bk - offset) // bq``, or 0
    when not causal."""
    k0 = _steps(-(-skv // bk), bk, -(skv - sq), device)
    if not causal:
        return torch.zeros_like(k0)
    return k0.clamp(min=0).div_(bq, rounding_mode="floor")


def q_tile_walk(blind, sq: int, skv: int, causal: bool, device=None,
                bq: int = BWD_WALK, bk: int = BWD_OWN) -> torch.Tensor:
    """The query tiles (of ``bq`` rows) the dK/dV kernel's key tile (of
    ``bk``) visits, int32 [B, ceil(Skv / bk), 2] of pairs (lead, start):
    the tiles [0, lead) and then [start, ceil(Sq / bq)).  ``start`` is the
    first tile the key tile is visible to (causal; 0 otherwise); before it,
    the tiles that hold blind rows (``blind_rows``: [0, ceil(blind / bq)))
    see it too, through their P = 1.  [1, ...] for every batch row when
    ``blind`` is None."""
    start = _walk_starts(sq, skv, causal, bq, bk,
                         torch.device(device or blind.device))
    if blind is None or not causal:
        return torch.stack([torch.zeros_like(start), start], -1)[None]
    lead = torch.minimum(
        torch.div(blind + (bq - 1), bq, rounding_mode="floor")[:, None],
        start)
    return torch.stack([lead, start.expand_as(lead)], -1)


def _ld(counts: torch.Tensor) -> int:
    """The row stride a kernel reads ``counts`` [B or 1, ...] with: 0 for
    one row shared by every batch row."""
    return counts[0].numel() if counts.shape[0] > 1 else 0


def _tma_check(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"{what}: libcuda.so.1 has no "
                           "cuTensorMapEncodeTiled")
    if err >= 100000:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - 100000}")
    _build.check(err, what)


def flash_fwd_cuda(q, k, v, key_mask=None, causal=True, scale=None):
    """Launch the flash forward kernel -> (o [B, Sq, H, D] bf16 contiguous,
    lse [B, H, Sq] f32).  q: bf16 CUDA [B, Sq, H, D], k, v: [B, Skv, H, D],
    unit stride on D, any strides on B, S and H (multiples of 8 elements),
    read by TMA through tensor maps the C launcher encodes.  The kernel
    reads the key mask as an additive f32 bias [B, Skv] and its tile counts
    from ``kv_tile_count``."""
    _check_cuda_qkv(q, k, v, (32, 64, 128))
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    valid = _key_valid(key_mask, b, skv, q.device)
    kbias = _bias_of(valid)
    # without causal masking every tile is walked: no blind rows needed
    blind = blind_rows(valid, sq, skv, causal) if causal else None
    ntiles = kv_tile_count(blind, sq, skv, causal, q.device)
    o = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    err = _fwd_lib().opadpo_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kbias.data_ptr() if kbias is not None else None,
        ntiles.data_ptr(), _ld(ntiles),
        o.data_ptr(), lse.data_ptr(), b, sq, skv, h, d, strides, int(causal),
        skv - sq, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _tma_check(err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_bwd_inputs(q, k, v, key_mask, causal, o, lse, do):
    """What both backward kernels read besides q, k, v and dO: (key bias,
    lse, delta = rowsum(dO * O) as f32 [B, H, Sq], the strides, the dQ
    kernel's tile counts, the dK/dV kernel's walks), the walks from one
    ``blind_rows``."""
    _check_cuda_qkv(q, k, v, (64, 128))
    if do.shape != q.shape or do.dtype != torch.bfloat16:
        raise ValueError("dO must be bf16 and shaped like q")
    _check_rows(do)
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError("lse must be f32 [B, H, Sq]")
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *do.stride()[:3])
    valid = _key_valid(key_mask, b, skv, q.device)
    blind = blind_rows(valid, sq, skv, causal)
    dq_tiles = kv_tile_count(blind, sq, skv, causal, q.device, BWD_OWN,
                             BWD_WALK)
    dkv_walk = q_tile_walk(blind, sq, skv, causal, q.device)
    return (_bias_of(valid), lse.contiguous(), delta, strides, dq_tiles,
            dkv_walk)


def flash_bwd_dq_cuda(q, k, v, key_mask, causal, scale, o, lse, do,
                      inputs=None):
    """Launch the dQ kernel -> dq bf16 [B, Sq, H, D] contiguous;
    ``inputs`` from ``flash_bwd_inputs``, made here when None."""
    kbias, lse, delta, strides, dq_tiles, _ = inputs or flash_bwd_inputs(
        q, k, v, key_mask, causal, o, lse, do)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dq = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q.device)
    err = _bwd_lib().opadpo_flash_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        kbias.data_ptr() if kbias is not None else None, lse.data_ptr(),
        delta.data_ptr(), dq_tiles.data_ptr(), _ld(dq_tiles), dq.data_ptr(),
        b, sq, skv, h, d, strides, int(causal), skv - sq, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _tma_check(err, "flash_bwd_dq")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, key_mask, causal, scale, o, lse, do,
                       inputs=None):
    """Launch the dK/dV kernel -> (dk, dv) bf16 [B, Skv, H, D] contiguous;
    ``inputs`` as for ``flash_bwd_dq_cuda``."""
    kbias, lse, delta, strides, _, dkv_walk = inputs or flash_bwd_inputs(
        q, k, v, key_mask, causal, o, lse, do)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dk = torch.empty((b, skv, h, d), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    err = _bwd_lib().opadpo_flash_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        kbias.data_ptr() if kbias is not None else None, lse.data_ptr(),
        delta.data_ptr(), dkv_walk.data_ptr(), _ld(dkv_walk), dk.data_ptr(),
        dv.data_ptr(), b, sq, skv, h, d, strides, int(causal), skv - sq,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _tma_check(err, "flash_bwd_dkv")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_bwd_cuda(q, k, v, key_mask, causal, scale, o, lse, do):
    """Both backward kernels, sharing delta, the key bias and the walks ->
    (dq, dk, dv)."""
    inputs = flash_bwd_inputs(q, k, v, key_mask, causal, o, lse, do)
    dq = flash_bwd_dq_cuda(q, k, v, key_mask, causal, scale, o, lse, do,
                           inputs)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, key_mask, causal, scale, o, lse, do,
                                inputs)
    return dq, dk, dv


def _fwd_lib():
    lib = _build.load("flash_fwd.cu")
    fn = lib.opadpo_flash_fwd_bf16
    if not fn.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, vp, vp, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_int64), i, i, ctypes.c_float,
                       vp]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load("flash_bwd.cu")
    if not lib.opadpo_flash_bwd_dq_bf16.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        common = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int64), i, i,
                  ctypes.c_float, vp]
        # q, k, v, dO, bias, lse, delta, counts / walk, their ld, outputs
        lib.opadpo_flash_bwd_dq_bf16.argtypes = [vp] * 8 + [i, vp] + common
        lib.opadpo_flash_bwd_dkv_bf16.argtypes = [vp] * 8 + [i, vp, vp] \
            + common
        lib.opadpo_flash_bwd_smem_bytes.argtypes = [i, i]
        lib.opadpo_flash_bwd_smem_bytes.restype = ctypes.c_int
        lib.opadpo_flash_bwd_dq_bf16.restype = ctypes.c_int
        lib.opadpo_flash_bwd_dkv_bf16.restype = ctypes.c_int
    return lib


class _FlashAttention(torch.autograd.Function):
    """Flash forward and backward, in place of the JAX package's custom VJP
    ``_flash_attention_padded``: the forward saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale):
        fwd = flash_fwd_cuda if on_cuda(q) else mha_reference_lse
        o, lse = fwd(q, k, v, key_mask, causal, scale)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        bwd = flash_bwd_cuda if on_cuda(q) else flash_bwd_reference
        dq, dk, dv = bwd(q, k, v, key_mask, ctx.causal, ctx.scale, o, lse,
                         do.contiguous())
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [B, S, H, D] (the JAX public layout), Sq <= Skv
    with the queries aligned to the end of the keys; differentiable in q,
    k, v.  CUDA tensors launch the kernels; CPU tensors run the plain
    versions."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, key_mask, causal, scale)


# the models' entry point; it dispatches on the device alone
multi_head_attention = flash_attention


def flash_attention_prefix(q, k, v, key_mask=None, scale=None):
    """Rectangular causal attention: query row r attends key col c iff
    ``c <= r + Skv - Sq`` (the shared-prefix layout, KV = [prefix ++
    response]).  The JAX kernel pads both lengths and takes the padded
    prefix length as its offset; the port pads nothing, so the offset is
    the prefix length itself."""
    return flash_attention(q, k, v, key_mask=key_mask, causal=True,
                           scale=scale)


def _kernel_view(t_heads: torch.Tensor) -> torch.Tensor:
    """[B, H, S, hd] -> the [B, S, H, hd] view the flash kernels read."""
    return t_heads.permute(0, 2, 1, 3)


def flash_attention_fused(q2, k2, v2, cos_table, sin_table, positions,
                          num_heads: int, key_mask=None, causal: bool = True,
                          scale=None, num_kv_heads: Optional[int] = None):
    """Self-attention straight from projection outputs ``[B, S, H*hd]``
    (k2, v2 ``[B, S, Hkv*hd]``): RoPE and the head split (with the GQA
    repeat) in one ``to_heads`` pass per tensor, then flash attention.
    Returns ``[B, S, H*hd]`` in q2's dtype."""
    b, s, d = q2.shape
    rep = num_heads // (num_kv_heads or num_heads)
    q_t = to_heads(q2, cos_table, sin_table, positions, num_heads, True)
    k_t = to_heads(k2, cos_table, sin_table, positions, num_heads, True, rep)
    v_t = to_heads(v2, cos_table, sin_table, positions, num_heads, False, rep)
    o = flash_attention(_kernel_view(q_t), _kernel_view(k_t),
                        _kernel_view(v_t), key_mask, causal, scale)
    return o.reshape(b, s, d)


def flash_attention_fused_shared(qp2, kp2, vp2, qr2, kr2, vr2, cos_table,
                                 sin_table, pos_p, pos_r, num_heads: int,
                                 mask_p, mask_r, scale=None,
                                 num_kv_heads: Optional[int] = None):
    """Shared-prefix attention from projection outputs: one prefix stream
    ``[B, Sp, *]`` and a response stream ``[K*B, Sr, *]`` stacked B-major
    (row ``b*K + t`` is response type t of example b).  The prefix runs
    square causal attention once; each response row attends ``[its
    example's prefix ++ itself]`` with the rectangular rule (offset Sp).
    Returns ``(op2 [B, Sp, H*hd], or2 [K*B, Sr, H*hd])``."""
    b, sp, d = qp2.shape
    kb, sr, _ = qr2.shape
    kk = kb // b
    rep = num_heads // (num_kv_heads or num_heads)

    def heads(x, pos, rope, r):
        return to_heads(x, cos_table, sin_table, pos, num_heads, rope, r)

    qp_t, kp_t, vp_t = (heads(qp2, pos_p, True, 1), heads(kp2, pos_p, True, rep),
                        heads(vp2, pos_p, False, rep))
    qr_t, kr_t, vr_t = (heads(qr2, pos_r, True, 1), heads(kr2, pos_r, True, rep),
                        heads(vr2, pos_r, False, rep))
    op = flash_attention(_kernel_view(qp_t), _kernel_view(kp_t),
                         _kernel_view(vp_t), mask_p, True, scale)
    # responses attend to [prefix ++ self]: the per-row repeat keeps the
    # B-major alignment, and autograd sums the K replicas' gradients back
    kcat = torch.cat([torch.repeat_interleave(kp_t, kk, dim=0), kr_t], dim=2)
    vcat = torch.cat([torch.repeat_interleave(vp_t, kk, dim=0), vr_t], dim=2)
    mcat = torch.cat([torch.repeat_interleave(mask_p, kk, dim=0), mask_r],
                     dim=1)
    orr = flash_attention_prefix(_kernel_view(qr_t), _kernel_view(kcat),
                                 _kernel_view(vcat), mcat, scale)
    return op.reshape(b, sp, d), orr.reshape(kb, sr, d)
