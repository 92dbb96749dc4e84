"""Head layout with RoPE folded in: port of the prologue kernels of
``opadpo_tpu/ops/attention.py`` (``_scatter_heads_kernel``,
``_gather_heads_kernel`` and ``_to_heads``).

- ``scatter_heads``: a projection output ``x [B, S, Hkv*hd]`` -> head-major
  ``[B, H, S, hd]``, each output head ``h`` reading source head
  ``h // rep`` (GQA, ``H = rep * Hkv``), rotated by the rotate-half RoPE in
  f32 at each row's position (``rope=True``), cast back to x's dtype.
- ``gather_heads``: the inverse layout ``[B, H, S, hd] -> [B, S,
  (H/group)*hd]``, each output head the sum of its ``group`` repeated heads
  after the inverse rotation R(-theta); this is the VJP of
  ``scatter_heads``.
- ``to_heads``: ``scatter_heads`` as an autograd function whose backward
  is ``gather_heads``.

On a CUDA tensor each wrapper launches its kernel in ``csrc/heads_layout.cu``
(bf16 only) or raises; on a CPU tensor it runs the plain version beside it.
The JAX package's epilogue ``_from_heads`` has no counterpart: the port's
flash kernels write ``[B, S, H, hd]``, which is ``[B, S, H*hd]`` as it is.
"""

from __future__ import annotations

import ctypes

import torch

from opadpo_torch.device import on_cuda
from opadpo_torch.ops import _build


def _tables(cos_table, sin_table, positions, half):
    """cos/sin gathered at ``positions`` [B, S], first half: [B, S, 1,
    half] f32."""
    return (cos_table[positions][:, :, None, :half].float(),
            sin_table[positions][:, :, None, :half].float())


def _rotate(x32, cos, sin, inverse):
    half = x32.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    if inverse:
        return torch.cat([x1 * cos + x2 * sin, x2 * cos - x1 * sin], dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def scatter_heads_plain(x, cos_table, sin_table, positions, num_heads: int,
                        rope: bool, rep: int = 1):
    """Plain version of ``scatter_heads``."""
    b, s, dkv = x.shape
    hd = dkv * rep // num_heads
    xh = x.reshape(b, s, num_heads // rep, hd)
    if rep > 1:
        xh = torch.repeat_interleave(xh, rep, dim=2)
    out = xh.float()
    if rope:
        out = _rotate(out, *_tables(cos_table, sin_table, positions, hd // 2),
                      inverse=False)
    return out.to(x.dtype).permute(0, 2, 1, 3).contiguous()


def gather_heads_plain(g, cos_table, sin_table, positions, rope: bool,
                       group: int = 1):
    """Plain version of ``gather_heads``."""
    b, h, s, hd = g.shape
    out = g.float().permute(0, 2, 1, 3)                     # [B, S, H, hd]
    if rope:
        out = _rotate(out, *_tables(cos_table, sin_table, positions, hd // 2),
                      inverse=True)
    out = out.reshape(b, s, h // group, group, hd).sum(dim=3)
    return out.reshape(b, s, (h // group) * hd).to(g.dtype)


def _check_rope_inputs(cos_table, sin_table, positions, hd):
    for tab in (cos_table, sin_table):
        if tab.dtype != torch.float32 or not tab.is_contiguous() \
                or tab.shape[-1] != hd or tab.data_ptr() % 16:
            raise ValueError("RoPE tables must be contiguous f32 "
                             f"[max_len, {hd}]")
    return positions.to(torch.int32).contiguous()


def _check_hd(hd):
    if hd <= 0 or hd % 16 or 128 % (hd // 16):
        raise ValueError(f"head dim {hd} not supported (16 to 256, a power "
                         "of two)")


def scatter_heads_cuda(x, cos_table, sin_table, positions, num_heads: int,
                       rope: bool, rep: int = 1):
    """Launch the scatter-heads kernel: bf16 CUDA ``x [B, S, Hkv*hd]`` (unit
    stride on the last axis) -> contiguous bf16 ``[B, H, S, hd]``."""
    b, s, dkv = x.shape
    hkv = num_heads // rep
    hd = dkv // hkv
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError("scatter_heads_cuda takes a bf16 CUDA tensor")
    if num_heads % rep or dkv % hkv:
        raise ValueError(f"{num_heads} heads, rep {rep}, width {dkv}")
    _check_hd(hd)
    if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 \
            or x.data_ptr() % 16:
        raise ValueError("x needs unit inner stride and 16-byte aligned rows")
    pos = None
    if rope:
        pos = _check_rope_inputs(cos_table, sin_table, positions, hd)
    out = torch.empty((b, num_heads, s, hd), dtype=torch.bfloat16,
                      device=x.device)
    err = _lib().opadpo_scatter_heads_bf16(
        x.data_ptr(), cos_table.data_ptr() if rope else None,
        sin_table.data_ptr() if rope else None,
        pos.data_ptr() if rope else None, out.data_ptr(), b, s, num_heads, hd,
        rep, x.stride(0), x.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "scatter_heads")
    scatter_heads_cuda.launches += 1
    return out


scatter_heads_cuda.launches = 0


def gather_heads_cuda(g, cos_table, sin_table, positions, rope: bool,
                      group: int = 1):
    """Launch the gather-heads kernel: bf16 CUDA ``g``, logically ``[B, H, S,
    hd]`` with any strides and unit stride on hd -> contiguous bf16 ``[B, S,
    (H/group)*hd]``."""
    b, h, s, hd = g.shape
    if not g.is_cuda or g.dtype != torch.bfloat16:
        raise ValueError("gather_heads_cuda takes a bf16 CUDA tensor")
    if h % group:
        raise ValueError(f"{h} heads do not split into groups of {group}")
    _check_hd(hd)
    if g.stride(3) != 1 or any(st % 8 for st in g.stride()[:3]) \
            or g.data_ptr() % 16:
        raise ValueError("g needs unit stride on hd and 16-byte aligned rows")
    pos = None
    if rope:
        pos = _check_rope_inputs(cos_table, sin_table, positions, hd)
    out = torch.empty((b, s, (h // group) * hd), dtype=torch.bfloat16,
                      device=g.device)
    err = _lib().opadpo_gather_heads_bf16(
        g.data_ptr(), cos_table.data_ptr() if rope else None,
        sin_table.data_ptr() if rope else None,
        pos.data_ptr() if rope else None, out.data_ptr(), b, s, h // group,
        hd, group, g.stride(0), g.stride(1), g.stride(2),
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "gather_heads")
    gather_heads_cuda.launches += 1
    return out


gather_heads_cuda.launches = 0


def _lib():
    lib = _build.load("heads_layout.cu")
    if not lib.opadpo_scatter_heads_bf16.argtypes:
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.opadpo_scatter_heads_bf16.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, i64, i64, vp]
        lib.opadpo_gather_heads_bf16.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, i64, i64, i64, vp]
        lib.opadpo_scatter_heads_bf16.restype = ctypes.c_int
        lib.opadpo_gather_heads_bf16.restype = ctypes.c_int
    return lib


def scatter_heads(x, cos_table, sin_table, positions, num_heads: int,
                  rope: bool, rep: int = 1):
    """[B, S, Hkv*hd] -> [B, H, S, hd] (+RoPE); CUDA launches the kernel."""
    fn = scatter_heads_cuda if on_cuda(x) else scatter_heads_plain
    return fn(x, cos_table, sin_table, positions, num_heads, rope, rep)


def gather_heads(g, cos_table, sin_table, positions, rope: bool,
                 group: int = 1):
    """[B, H, S, hd] -> [B, S, (H/group)*hd] (inverse RoPE, sum over each
    group of heads); CUDA launches the kernel."""
    if on_cuda(g):
        return gather_heads_cuda(g, cos_table, sin_table, positions, rope,
                                 group)
    return gather_heads_plain(g, cos_table, sin_table, positions, rope, group)


class _ToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos_table, sin_table, positions, num_heads, rope,
                rep):
        ctx.save_for_backward(cos_table, sin_table, positions)
        ctx.rope, ctx.rep = rope, rep
        return scatter_heads(x, cos_table, sin_table, positions, num_heads,
                             rope, rep)

    @staticmethod
    def backward(ctx, g):
        cos_table, sin_table, positions = ctx.saved_tensors
        dx = gather_heads(g, cos_table, sin_table, positions, ctx.rope,
                          ctx.rep)
        return dx, None, None, None, None, None, None


def to_heads(x, cos_table, sin_table, positions, num_heads: int, rope: bool,
             rep: int = 1):
    """``scatter_heads`` with its VJP (``gather_heads`` with the inverse
    rotation, summing the ``rep`` repeated heads back into their kv head)."""
    return _ToHeads.apply(x, cos_table, sin_table, positions, num_heads,
                          rope, rep)
