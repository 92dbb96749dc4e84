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
  is ``gather_heads``;
- ``to_heads_qkv``: q, k and v of one stream in one ``scatter_heads_multi``
  launch (q and k rotated, k and v repeated ``rep`` times), its backward
  dQ, dK and dV in one ``gather_heads_multi`` launch.

On a CUDA tensor each wrapper launches its kernel in ``csrc/heads_layout.cu``
(bf16 only) or raises; on a CPU tensor it runs the plain version beside it
(the multi-tensor forms: one plain call per tensor).  ``scatter_grid``
fixes both kernels' grids from the shape (``gather_grid`` is the same
rule).
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


SCATTER_ROWS = 64      # rows of one tile of either kernel
MAX_TENSORS = 3        # tensors one launch of either kernel takes
HEAD_DIMS = (64, 128)  # the kernels' instances
# a block's shared memory (bytes, opt-in), of which the gather kernel
# needs two stages of the launch's largest group of heads
SMEM_MAX = 232448


def scatter_grid(b: int, s: int, tiles: int, slots: int):
    """The scatter kernel's grid for ``b`` batches of ``s`` rows and
    ``tiles`` source heads over the launch's tensors -> ``(row_blocks,
    groups)``: a CTA per (block of 64 rows, batch, group), group g taking
    the tiles [g * tiles // groups, (g + 1) * tiles // groups) of q's
    source heads, then k's, then v's.  As many groups (at most ``tiles``)
    as keep the grid within ``slots``, the CTAs the card holds at once, so
    that the launch is one wave; one group when the row blocks alone pass
    ``slots``."""
    blocks = -(-s // SCATTER_ROWS)
    return blocks, max(1, min(tiles, slots // (b * blocks)))


# The gather kernel's grid: the same rule, over the launch's output (kv)
# heads, its CTAs resident at once by its own occupancy.
gather_grid = scatter_grid

_slots: dict = {}


def _arr(ctype, vals):
    return (ctype * len(vals))(*vals)


def _resident(device, key, query) -> int:
    """CTAs of one kernel the card holds at once: the SMs times
    ``query()``, its CTAs an SM, cached by ``key``."""
    key = (device.index, *key)
    if key not in _slots:
        per_sm = query()
        if per_sm < 1:
            raise RuntimeError(f"{key[1]}: occupancy query gave {per_sm}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _slots[key] = sms * per_sm
    return _slots[key]


def _scatter_slots(device, hd) -> int:
    """CTAs of the scatter kernel the card holds at once."""
    return _resident(device, ("scatter_heads", hd),
                     lambda: _lib().opadpo_scatter_heads_ctas_per_sm(hd))


def _gather_slots(device, hd, gmax) -> int:
    """CTAs of the gather kernel the card holds at once, its largest group
    of heads ``gmax``."""
    return _resident(device, ("gather_heads", hd, gmax),
                     lambda: _lib().opadpo_gather_heads_ctas_per_sm(hd, gmax))


def scatter_heads_multi_cuda(xs, cos_table, sin_table, positions,
                             num_heads: int, ropes, reps):
    """One launch of the scatter kernel over up to three bf16 CUDA tensors
    ``xs[t] [B, S, (H/reps[t])*hd]`` (each with unit stride on the last
    axis and its own batch and row strides), rotated where ``ropes[t]``
    -> a list of contiguous bf16 ``[B, H, S, hd]``.  hd is 64 or 128."""
    n = len(xs)
    b, s, _ = xs[0].shape
    hd = xs[0].shape[2] * reps[0] // num_heads
    if not 1 <= n <= MAX_TENSORS or len(ropes) != n or len(reps) != n:
        raise ValueError(f"{n} tensors: one launch takes 1 to {MAX_TENSORS}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (64 or 128)")
    nsrc = []
    for x, rep in zip(xs, reps):
        if not x.is_cuda or x.dtype != torch.bfloat16 \
                or x.device != xs[0].device:
            raise ValueError("scatter_heads_cuda takes bf16 CUDA tensors on "
                             "one device")
        if num_heads % rep or x.shape != (b, s, (num_heads // rep) * hd):
            raise ValueError(f"{num_heads} heads of {hd}, rep {rep}: x "
                             f"{tuple(x.shape)}")
        if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 \
                or x.data_ptr() % 16:
            raise ValueError("x needs unit inner stride and 16-byte aligned "
                             "rows")
        nsrc.append(num_heads // rep)
    rope = any(ropes)
    pos = _check_rope_inputs(cos_table, sin_table, positions, hd) if rope \
        else None
    outs = [torch.empty((b, num_heads, s, hd), dtype=torch.bfloat16,
                        device=x.device) for x in xs]
    _, groups = scatter_grid(b, s, sum(nsrc),
                             _scatter_slots(xs[0].device, hd))
    err = _lib().opadpo_scatter_heads_bf16(
        n, _arr(ctypes.c_void_p, [x.data_ptr() for x in xs]),
        _arr(ctypes.c_int64, [st for x in xs for st in x.stride()[:2]]),
        _arr(ctypes.c_void_p, [o.data_ptr() for o in outs]),
        _arr(ctypes.c_int, [int(r) for r in ropes]),
        _arr(ctypes.c_int, reps), _arr(ctypes.c_int, nsrc),
        cos_table.data_ptr() if rope else None,
        sin_table.data_ptr() if rope else None,
        pos.data_ptr() if rope else None, b, s, hd, groups,
        torch.cuda.current_stream(xs[0].device).cuda_stream)
    _build.check(err, "scatter_heads")
    scatter_heads_cuda.launches += 1       # the scatter kernel's, any form
    return outs


def scatter_heads_cuda(x, cos_table, sin_table, positions, num_heads: int,
                       rope: bool, rep: int = 1):
    """Launch the scatter-heads kernel on one tensor: bf16 CUDA ``x [B, S,
    Hkv*hd]`` (unit stride on the last axis) -> contiguous bf16 ``[B, H,
    S, hd]``."""
    return scatter_heads_multi_cuda([x], cos_table, sin_table, positions,
                                    num_heads, [rope], [rep])[0]


scatter_heads_cuda.launches = 0


def gather_heads_multi_cuda(gs, cos_table, sin_table, positions, ropes,
                            groups):
    """One launch of the gather kernel over up to three bf16 CUDA gradients
    ``gs[t]``, logically ``[B, H, S, hd]`` with any strides (multiples of 8
    elements, unit stride on hd, 16-byte aligned base), rotated back where
    ``ropes[t]``, each group of ``groups[t]`` heads summed -> a list of
    contiguous bf16 ``[B, S, (H/groups[t])*hd]``.  hd is 64 or 128."""
    n = len(gs)
    if not 1 <= n <= MAX_TENSORS or len(ropes) != n or len(groups) != n:
        raise ValueError(f"{n} tensors: one launch takes 1 to {MAX_TENSORS}")
    b, h, s, hd = gs[0].shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (64 or 128)")
    for g, group in zip(gs, groups):
        if not g.is_cuda or g.dtype != torch.bfloat16 \
                or g.device != gs[0].device:
            raise ValueError("gather_heads_cuda takes bf16 CUDA tensors on "
                             "one device")
        if g.shape != (b, h, s, hd) or group < 1 or h % group:
            raise ValueError(f"g {tuple(g.shape)} does not split into groups "
                             f"of {group} heads like {(b, h, s, hd)}")
        if g.stride(3) != 1 or any(st % 8 for st in g.stride()[:3]) \
                or g.data_ptr() % 16:
            raise ValueError("g needs unit stride on hd, strides of 16 bytes "
                             "and a 16-byte aligned base")
    gmax = max(groups)
    if 2 * gmax * SCATTER_ROWS * hd * 2 > SMEM_MAX - 1024 - 32:
        raise ValueError(f"groups of {gmax} heads of {hd}: two tiles do not "
                         "fit in a block's shared memory")
    rope = any(ropes)
    pos = _check_rope_inputs(cos_table, sin_table, positions, hd) if rope \
        else None
    outs = [torch.empty((b, s, (h // group) * hd), dtype=torch.bfloat16,
                        device=g.device) for g, group in zip(gs, groups)]
    _, grid_groups = gather_grid(b, s, sum(h // group for group in groups),
                                 _gather_slots(gs[0].device, hd, gmax))
    err = _lib().opadpo_gather_heads_bf16(
        n, _arr(ctypes.c_void_p, [g.data_ptr() for g in gs]),
        _arr(ctypes.c_int64, [st for g in gs for st in g.stride()[:3]]),
        _arr(ctypes.c_void_p, [o.data_ptr() for o in outs]),
        _arr(ctypes.c_int, [int(r) for r in ropes]),
        _arr(ctypes.c_int, groups),
        cos_table.data_ptr() if rope else None,
        sin_table.data_ptr() if rope else None,
        pos.data_ptr() if rope else None, b, s, h, hd, grid_groups,
        torch.cuda.current_stream(gs[0].device).cuda_stream)
    _build.check(err, "gather_heads")
    gather_heads_cuda.launches += 1        # the gather kernel's, any form
    return outs


def gather_heads_cuda(g, cos_table, sin_table, positions, rope: bool,
                      group: int = 1):
    """Launch the gather-heads kernel on one tensor: bf16 CUDA ``g``,
    logically ``[B, H, S, hd]`` with any strides and unit stride on hd ->
    contiguous bf16 ``[B, S, (H/group)*hd]``."""
    return gather_heads_multi_cuda([g], cos_table, sin_table, positions,
                                   [rope], [group])[0]


gather_heads_cuda.launches = 0


def _lib():
    lib = _build.load("heads_layout.cu")
    if not lib.opadpo_scatter_heads_bf16.argtypes:
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        ip = ctypes.POINTER(i)
        lib.opadpo_scatter_heads_bf16.argtypes = [
            i, ctypes.POINTER(vp), ctypes.POINTER(i64), ctypes.POINTER(vp),
            ip, ip, ip, vp, vp, vp, i, i, i, i, vp]
        lib.opadpo_scatter_heads_ctas_per_sm.argtypes = [i]
        lib.opadpo_gather_heads_bf16.argtypes = [
            i, ctypes.POINTER(vp), ctypes.POINTER(i64), ctypes.POINTER(vp),
            ip, ip, vp, vp, vp, i, i, i, i, i, vp]
        lib.opadpo_gather_heads_ctas_per_sm.argtypes = [i, i]
        for fn in (lib.opadpo_scatter_heads_bf16,
                   lib.opadpo_scatter_heads_ctas_per_sm,
                   lib.opadpo_gather_heads_bf16,
                   lib.opadpo_gather_heads_ctas_per_sm):
            fn.restype = ctypes.c_int
    return lib


def scatter_heads(x, cos_table, sin_table, positions, num_heads: int,
                  rope: bool, rep: int = 1):
    """[B, S, Hkv*hd] -> [B, H, S, hd] (+RoPE); CUDA launches the kernel."""
    fn = scatter_heads_cuda if on_cuda(x) else scatter_heads_plain
    return fn(x, cos_table, sin_table, positions, num_heads, rope, rep)


def scatter_heads_multi(xs, cos_table, sin_table, positions,
                        num_heads: int, ropes, reps):
    """``scatter_heads`` of up to three tensors sharing B, S, hd and the
    positions, tensor t with ``ropes[t]`` and ``reps[t]``; CUDA launches
    the kernel once."""
    if on_cuda(xs[0]):
        return scatter_heads_multi_cuda(xs, cos_table, sin_table, positions,
                                        num_heads, ropes, reps)
    return [scatter_heads_plain(x, cos_table, sin_table, positions,
                                num_heads, rope, rep)
            for x, rope, rep in zip(xs, ropes, reps)]


def gather_heads(g, cos_table, sin_table, positions, rope: bool,
                 group: int = 1):
    """[B, H, S, hd] -> [B, S, (H/group)*hd] (inverse RoPE, sum over each
    group of heads); CUDA launches the kernel."""
    if on_cuda(g):
        return gather_heads_cuda(g, cos_table, sin_table, positions, rope,
                                 group)
    return gather_heads_plain(g, cos_table, sin_table, positions, rope, group)


def gather_heads_multi(gs, cos_table, sin_table, positions, ropes, groups):
    """``gather_heads`` of up to three gradients sharing B, H, S, hd and the
    positions, tensor t with ``ropes[t]`` and ``groups[t]``; CUDA launches
    the kernel once."""
    if on_cuda(gs[0]):
        return gather_heads_multi_cuda(gs, cos_table, sin_table, positions,
                                       ropes, groups)
    return [gather_heads_plain(g, cos_table, sin_table, positions, rope,
                               group)
            for g, rope, group in zip(gs, ropes, groups)]


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


# q and k rotated; k and v repeated rep times
QKV_ROPE = (True, True, False)


class _ToHeadsQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q2, k2, v2, cos_table, sin_table, positions, num_heads,
                rep):
        ctx.save_for_backward(cos_table, sin_table, positions)
        ctx.rep = rep
        return tuple(scatter_heads_multi((q2, k2, v2), cos_table, sin_table,
                                         positions, num_heads, QKV_ROPE,
                                         (1, rep, rep)))

    @staticmethod
    def backward(ctx, gq, gk, gv):
        cos_table, sin_table, positions = ctx.saved_tensors
        need = [t for t in range(3) if ctx.needs_input_grad[t]]
        grads = [None] * 3
        if need:
            gs, groups = (gq, gk, gv), (1, ctx.rep, ctx.rep)
            outs = gather_heads_multi([gs[t] for t in need], cos_table,
                                      sin_table, positions,
                                      [QKV_ROPE[t] for t in need],
                                      [groups[t] for t in need])
            for t, out in zip(need, outs):
                grads[t] = out
        return (*grads, None, None, None, None, None)


def to_heads_qkv(q2, k2, v2, cos_table, sin_table, positions,
                 num_heads: int, rep: int = 1):
    """q ``[B, S, H*hd]``, k and v ``[B, S, (H/rep)*hd]`` -> ``(q, k, v)``
    each ``[B, H, S, hd]``: RoPE on q and k, the GQA repeat on k and v, in
    one scatter launch on CUDA; the VJP, ``gather_heads`` of each gradient
    (as three ``to_heads`` calls would give), is one gather launch over
    the gradients asked for."""
    return _ToHeadsQKV.apply(q2, k2, v2, cos_table, sin_table, positions,
                             num_heads, rep)
