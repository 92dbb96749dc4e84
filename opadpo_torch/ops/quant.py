"""Quantized base weights (QLoRA): port of ``opadpo_tpu/ops/quant.py``.

Frozen decoder and vision-tower weights are stored int8 per output
channel (symmetric, absmax / 127) or int4 in groups of 128 along the
contraction (symmetric, absmax / 7), under bf16 LoRA adapters.  The port
keeps the weights in ``nn.Linear``'s ``[out, in]`` layout, K contiguous:

- int8: ``q`` int8 ``[N, K]``, ``scale`` f32 ``[N]``;
- int4: ``q`` int8 ``[N, K/2]``, packed as the JAX package packs it along
  K: within each group of g (128) byte r holds k = r in its low nibble and
  k = r + g/2 in its high nibble, both signed; ``scale`` f32 ``[N, K/g]``.

Hand-written kernels replace the three Pallas ones, each behind a wrapper
that launches it for CUDA tensors and runs its plain version for CPU
tensors (never a fallback on CUDA):

- ``quant_matmul`` (#9, ``_q8_matmul_kernel``): ``(x @ bf16(q)^T) *
  scale``;
- ``quant_matmul_transposed`` (#10, ``_q8_matmul_t_kernel``): ``bf16(g *
  scale) @ bf16(q)``, the dx through the frozen int8 weight;
- ``quant_matmul4`` (#11, ``_q4_matmul_kernel``): per group, ``x_g @
  q4_g^T`` in f32 times that group's scale, summed over groups.

#9 and #10 run on ``csrc/int8_matmul.cu`` (TMA, wgmma) where every matrix
row is a multiple of 16 bytes long: #9 on its ``tile`` kernel above 16
rows and its ``decode`` kernel at or below, #10 on its ``tile`` kernel.
Other int8 shapes run on ``csrc/quant_matmul.cu`` (``mma.sync``).  #11
runs on ``csrc/int4_matmul.cu`` (TMA, wgmma), ``tile`` above 16 rows and
``decode`` at or below, at every K it takes.  ``q8_variant`` /
``q8t_variant`` / ``q4_variant`` choose by shape before the launch, and
``variant_launches`` counts each variant's launches.

``q8_dense`` / ``q4_dense`` dispatch on the rows (product of the leading
dims) as the JAX package does: at most ``_STREAMING_MAX_M`` rows take the
kernels; above it the weight is dequantized once to x's dtype and
``torch.matmul`` runs the product (the JAX package leaves that product to
XLA), or, in w8a8 mode, an int8 GEMM (``torch._int_mm``, exact int32
sums) on per-token int8 activations.  The w8a8 switches are a
``QuantMode`` carried by each ``QuantLinear``, in place of the JAX
package's process-global ``set_act_quant``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn

from opadpo_torch.device import on_cuda
from opadpo_torch.ops import _build

GROUP = 128
# Rows at or below which the products run in the streaming kernels; above
# it the weight is dequantized once per call (or w8a8 runs).  The JAX
# package's constant; PERF.md records where the H100's crossover lies.
_STREAMING_MAX_M = 1024


@dataclasses.dataclass(frozen=True)
class QuantMode:
    """The w8a8 switches of an int8 base (the JAX ``set_act_quant``):
    ``act_bits`` 8 runs the linears of more than ``_STREAMING_MAX_M`` rows
    on int8 products with per-token activation quantization, keeping the
    ``outlier_cols`` largest-amplitude feature columns in bf16 (static
    top-k LLM.int8 decomposition); ``bwd_int8`` also runs their dx on int8
    products, the weight scale folded into the gradient first."""

    act_bits: int = 16
    outlier_cols: int = 0
    bwd_int8: bool = False

    def __post_init__(self):
        if self.act_bits not in (16, 8):
            raise ValueError(f"act_bits={self.act_bits} (16 or 8)")
        if self.outlier_cols < 0:
            raise ValueError(f"outlier_cols={self.outlier_cols}")

    @property
    def w8a8(self) -> bool:
        return self.act_bits == 8


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def exact_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d``, correctly rounded on every device.  PyTorch computes a
    CUDA tensor divided by a Python number as ``a * (1 / d)``, which can
    differ from the quotient in the last bit and so move a rounded code
    away from the JAX package's."""
    return a / a.new_tensor(d)


def quantize_weight(w: torch.Tensor):
    """``[.., N, K]`` -> (int8 q ``[.., N, K]``, f32 scale ``[.., N]``):
    symmetric per output channel, round half to even (as ``jnp.round``),
    so the codes equal the JAX package's."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, 1.0, exact_div(absmax, 127.0))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def quantize_weight_int4(w: torch.Tensor, group: int = GROUP):
    """``[.., N, K]`` -> (packed int8 ``[.., N, K/2]``, f32 scale
    ``[.., N, K/group]``), symmetric per group, the JAX package's codes
    and packing (transposed to the port's layout)."""
    *lead, n, k = w.shape
    if k % group or group % 2:
        raise ValueError(f"K={k} is not a multiple of the group {group}")
    w32 = w.float().reshape(*lead, n, k // group, group)
    absmax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, 1.0, exact_div(absmax, 7.0))
    q = torch.clamp(torch.round(w32 / scale), -8, 7).to(torch.int32)
    lo, hi = q[..., :group // 2], q[..., group // 2:]
    packed = (hi * 16 + (lo & 0xF)).to(torch.int8)
    return packed.reshape(*lead, n, k // 2), scale[..., 0]


def unpack_nibbles(p32: torch.Tensor):
    """int32 packed bytes -> (lo, hi) signed nibble values in [-8, 7]."""
    return ((p32 & 0xF) ^ 8) - 8, p32 >> 4


def _unpack_groups(q4: torch.Tensor, groups: int) -> torch.Tensor:
    """packed ``[.., N, K/2]`` -> int32 codes ``[.., N, groups, g]``."""
    *lead, n, kp = q4.shape
    p32 = q4.reshape(*lead, n, groups, 2 * kp // groups // 2).to(torch.int32)
    lo, hi = unpack_nibbles(p32)
    return torch.cat([lo, hi], dim=-1)


def dequantize_weight4(q4: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    *lead, n, kp = q4.shape
    w = _unpack_groups(q4, scale.shape[-1]).float() * scale[..., None]
    return w.reshape(*lead, n, 2 * kp).to(dtype)


# ---------------------------------------------------------------------------
# The three products: plain versions
# ---------------------------------------------------------------------------

def quant_matmul_plain(x, q, scale, out_dtype=None):
    """``(x [M, K] @ q [N, K]^T, f32 sums) * scale [N]`` in ``out_dtype``
    (x's dtype by default)."""
    y = (x.float() @ q.float().t()) * scale
    return y.to(out_dtype or x.dtype)


def quant_matmul_t_plain(g, q, scale):
    """``gs @ q`` with ``gs = (g [M, N] * scale [N])`` rounded to g's dtype,
    f32 sums, in g's dtype: ``[M, K]``."""
    gs = (g.float() * scale).to(g.dtype)
    return (gs.float() @ q.float()).to(g.dtype)


def quant_matmul4_plain(x, q4, scale, out_dtype=None):
    """Per group G of the contraction, ``(x[:, G] @ w4_G^T) * scale[:, G]``
    in f32, summed over the groups in order."""
    m, k = x.shape
    groups = scale.shape[1]
    g = k // groups
    w = _unpack_groups(q4, groups).float()                # [N, G, g]
    xg = x.float().reshape(m, groups, g)
    acc = torch.zeros((m, q4.shape[0]), dtype=torch.float32, device=x.device)
    for gi in range(groups):
        acc += (xg[:, gi] @ w[:, gi].t()) * scale[:, gi]
    return acc.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_Q8, _Q8T = 0, 1                # modes of quant_matmul.cu
_BN, _BK = 64, 128              # its output and contraction tiles
TILE_M, TILE_K = 128, 64        # int8_matmul.cu: rows per CTA, tile depth
Q4_TILE_N = 128                 # int4_matmul.cu: weight rows per CTA
DECODE_ROWS = 16                # #9 / #11 at or below: the transposed kernel
DECODE_N = 128                  # weight rows per decode CTA
DECODE_CTAS_PER_SM = 2          # decode CTAs resident on one SM


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def q8_variant(m: int, n: int, k: int) -> str:
    """The kernel #9 takes at x [M, K], q [N, K]: ``"decode"`` (M <= 16)
    or ``"tile"`` on ``int8_matmul.cu``, whose TMA loads need rows a
    multiple of 16 bytes long (K % 16 == 0); else ``"odd"``, the
    ``mma.sync`` kernel of ``quant_matmul.cu``."""
    if k % 16:
        return "odd"
    return "decode" if m <= DECODE_ROWS else "tile"


def q8t_variant(m: int, n: int, k: int) -> str:
    """The kernel #10 takes at g [M, N], q [N, K]: ``"tile"`` on
    ``int8_matmul.cu`` when K % 16 == 0 and N % 8 == 0 (g's rows), else
    ``"odd"``."""
    return "odd" if k % 16 or n % 8 else "tile"


def tile_bn(m: int, n: int, sms: int, wide: int = 256) -> int:
    """Weight rows per CTA of a tile kernel (128 x rows each): ``wide``
    (#9: 256; #11: 128, as its per-group partial and accumulator take 128
    registers a thread at 128 rows), or 64 where ``wide`` would give fewer
    than one CTA per two SMs.  On an H100 at M 703 the kernels are bound by
    their tiles' L2 traffic: #9 at 256 rows a CTA, which read each x tile
    for four times the work of 64, ran 18-39 % faster, #11 at 128 25-26 %;
    at CLIP's 577 x 1024 -> 1024, 64 rows took half (#9) and three
    quarters (#11) of the wide tile's time (``tools/time_quant.py --bn /
    --bn4``, PERF.md)."""
    return wide if -(-m // TILE_M) * -(-n // wide) * 2 >= sms else 64


def q4_variant(m: int, n: int, k: int) -> str:
    """The kernel #11 takes at x [M, K], q4 [N, K/2]: ``"decode"`` (M <=
    16) or ``"tile"`` on ``int4_matmul.cu``.  Every K it takes (a multiple
    of 128) gives rows a multiple of 16 bytes, and the kernels read the
    scales without TMA, so no shape needs another kernel."""
    return "decode" if m <= DECODE_ROWS else "tile"


def decode_splits(n: int, k: int, sms: int, depth: int = TILE_K) -> int:
    """Contraction splits of a decode kernel (#9: 64-deep tiles; #11:
    ``depth`` 128, one group): as many as fit ``DECODE_CTAS_PER_SM`` CTAs
    of ``DECODE_N`` weight rows on each SM (1 when the weight tiles alone
    fill them); split z walks the contraction tiles ``[z * per, min(nk,
    (z + 1) * per))``, ``nk = ceil(k / depth)``, ``per = ceil(nk /
    splits)``, and none is empty."""
    tiles = -(-n // DECODE_N)
    nk = -(-k // depth)
    splits = max(1, min(nk, DECODE_CTAS_PER_SM * sms // tiles))
    per = -(-nk // splits)
    return -(-nk // per)


class LaunchCount:
    """Launches of one kernel variant (``chip_smoke.py`` resets and reads
    ``launches``)."""

    def __init__(self):
        self.launches = 0


variant_launches = {name: LaunchCount() for name in (
    "q8_tile", "q8_decode", "q8_odd", "q8t_tile", "q8t_odd", "q4_tile",
    "q4_decode")}


def _splits(m: int, n: int, k: int, device) -> int:
    """Contraction splits of quant_matmul.cu so that about four CTAs per
    SM are in flight (its 16- or 64-row by 64-column output tiles)."""
    bm = 16 if m <= 16 else 64
    ctas = -(-m // bm) * -(-n // _BN)
    target = 4 * _sm_count(device.index)
    nk = -(-k // _BK)
    if ctas >= target:
        return 1
    splits = min(nk, -(-target // ctas))
    per = -(-nk // splits)
    return -(-nk // per)


def _check(name, t, dtype, shape):
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous 16-byte aligned "
                         f"CUDA {dtype} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch(mode, a, w, scale, n_out, out_dtype):
    m, k = a.shape
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} (bf16 or f32)")
    out = torch.empty((m, n_out), dtype=out_dtype, device=a.device)
    if m == 0:
        return out
    splits = _splits(m, n_out, k, a.device)
    ws = (torch.empty((splits, m, n_out), dtype=torch.float32,
                      device=a.device) if splits > 1 else None)
    err = _fn()(mode, a.data_ptr(), w.data_ptr(),
                scale.data_ptr() if scale is not None else None,
                out.data_ptr(), int(out_dtype == torch.float32),
                ws.data_ptr() if ws is not None else None, m, n_out, k,
                splits, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "quant_matmul")
    return out


# decode tickets, zero between launches, per (device, stream)
_tickets: dict = {}


def _tickets_for(device, stream: int, tiles: int) -> torch.Tensor:
    t = _tickets.get((device.index, stream))
    if t is None or t.numel() < tiles:
        t = torch.zeros(max(tiles, 256), dtype=torch.int32, device=device)
        _tickets[(device.index, stream)] = t
    return t


def _matmul_lib(src, tile, decode, *more):
    """The library of ``src`` with the argument types of its tile and
    decode launchers (and of ``more``: (name, argtypes))."""
    lib = _build.load(src)
    fn = getattr(lib, tile)
    if not fn.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
        getattr(lib, decode).argtypes = [vp, vp, vp, vp, i, vp, vp, i, i, i,
                                         i, vp]
        for name, types in more:
            getattr(lib, name).argtypes = types
        for name in (tile, decode, *(name for name, _ in more)):
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _int8_lib():
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _matmul_lib("int8_matmul.cu", "opadpo_q8_tile", "opadpo_q8_decode",
                       ("opadpo_q8t_tile", [vp, vp, vp, vp, i, i, i, vp]))


def _weight_matmul(lib, kind, variant, x, q, scale, out, n, k, bn, splits):
    """#9 (``kind`` "q8") or #11 ("q4") on its TMA/wgmma library into
    ``out``: the tile kernel at ``bn`` weight rows a CTA, or the decode
    kernel split ``splits`` ways (with a workspace and the stream's
    tickets when more than one)."""
    m = x.shape[0]
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = int(out.dtype == torch.float32)
    args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), f32)
    if variant == "tile":
        err = getattr(lib, f"opadpo_{kind}_tile")(*args, m, n, k, bn, stream)
    else:
        ws = tickets = None
        if splits > 1:
            tiles = -(-n // DECODE_N)
            ws = torch.empty(splits * tiles * DECODE_ROWS * DECODE_N,
                             dtype=torch.float32, device=dev)
            tickets = _tickets_for(dev, stream, tiles)
        err = getattr(lib, f"opadpo_{kind}_decode")(
            *args, ws.data_ptr() if ws is not None else None,
            tickets.data_ptr() if tickets is not None else None, m, n, k,
            splits, stream)
    name = "quant_matmul" if kind == "q8" else "quant_matmul4"
    _build.check(err, f"{name} ({variant})")


def _q8_int8(variant, x, q, scale, out):
    """#9 on int8_matmul.cu into ``out``."""
    (m, k), n = x.shape, q.shape[0]
    sms = _sm_count(x.device.index)
    _weight_matmul(_int8_lib(), "q8", variant, x, q, scale, out, n, k,
                   tile_bn(m, n, sms), decode_splits(n, k, sms))


def quant_matmul_cuda(x, q, scale, out_dtype=None):
    """Launch #9: x bf16 [M, K], q int8 [N, K], scale f32 [N] -> [M, N]
    bf16 (or ``out_dtype`` f32), on the kernel ``q8_variant`` names."""
    n, k = q.shape
    _check("x", x, torch.bfloat16, (x.shape[0], k))
    _check("q", q, torch.int8, (n, k))
    _check("scale", scale, torch.float32, (n,))
    od = out_dtype or torch.bfloat16
    m = x.shape[0]
    variant = q8_variant(m, n, k)
    if variant == "odd" or m == 0:
        out = _launch(_Q8, x, q, scale, n, od)
    else:
        if od not in (torch.bfloat16, torch.float32):
            raise ValueError(f"out_dtype {od} (bf16 or f32)")
        out = torch.empty((m, n), dtype=od, device=x.device)
        _q8_int8(variant, x, q, scale, out)
    if m:
        variant_launches["q8_" + variant].launches += 1
    quant_matmul_cuda.launches += 1
    return out


quant_matmul_cuda.launches = 0


def quant_matmul_t_cuda(g, q, scale):
    """Launch #10: g bf16 [M, N], q int8 [N, K], scale f32 [N] -> dx bf16
    [M, K].  The tile kernel folds the scale into g itself (f32 product,
    rounded to bf16, as the JAX wrapper folds it); for the odd kernel one
    op folds it first."""
    n, k = q.shape
    _check("g", g, torch.bfloat16, (g.shape[0], n))
    _check("q", q, torch.int8, (n, k))
    _check("scale", scale, torch.float32, (n,))
    m = g.shape[0]
    variant = q8t_variant(m, n, k)
    if variant == "odd" or m == 0:
        gs = (g.float() * scale).to(torch.bfloat16)
        out = _launch(_Q8T, gs, q, None, k, torch.bfloat16)
    else:
        out = torch.empty((m, k), dtype=torch.bfloat16, device=g.device)
        err = _int8_lib().opadpo_q8t_tile(
            g.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m,
            n, k, torch.cuda.current_stream(g.device).cuda_stream)
        _build.check(err, "quant_matmul_t (tile)")
    if m:
        variant_launches["q8t_" + variant].launches += 1
    quant_matmul_t_cuda.launches += 1
    return out


quant_matmul_t_cuda.launches = 0


def quant_matmul4_cuda(x, q4, scale, out_dtype=None):
    """Launch #11: x bf16 [M, K], q4 packed int8 [N, K/2], scale f32
    [N, K/128] -> [M, N] bf16 (or ``out_dtype`` f32), on the
    ``int4_matmul.cu`` kernel ``q4_variant`` names."""
    n, kp = q4.shape
    k = 2 * kp
    if k % GROUP or scale.shape != (n, k // GROUP):
        raise ValueError(f"the int4 kernel takes groups of {GROUP}: K {k}, "
                         f"scale {tuple(scale.shape)}")
    _check("x", x, torch.bfloat16, (x.shape[0], k))
    _check("q4", q4, torch.int8, (n, kp))
    _check("scale", scale, torch.float32, (n, k // GROUP))
    od = out_dtype or torch.bfloat16
    if od not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {od} (bf16 or f32)")
    m = x.shape[0]
    out = torch.empty((m, n), dtype=od, device=x.device)
    if m:
        variant = q4_variant(m, n, k)
        sms = _sm_count(x.device.index)
        _weight_matmul(_int4_lib(), "q4", variant, x, q4, scale, out, n, k,
                       tile_bn(m, n, sms, Q4_TILE_N),
                       decode_splits(n, k, sms, GROUP))
        variant_launches["q4_" + variant].launches += 1
        quant_matmul4_cuda.launches += 1
    return out


quant_matmul4_cuda.launches = 0


def _int4_lib():
    return _matmul_lib("int4_matmul.cu", "opadpo_q4_tile", "opadpo_q4_decode")


def _fn():
    fn = _build.load("quant_matmul.cu").opadpo_quant_matmul
    if not fn.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, vp, vp, vp, vp, i, vp, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def quant_matmul(x, q, scale, out_dtype=None):
    """#9 on CUDA tensors, its plain version on CPU tensors."""
    fn = quant_matmul_cuda if on_cuda(x) else quant_matmul_plain
    return fn(x, q, scale, out_dtype)


def quant_matmul_transposed(g, q, scale):
    """#10 on CUDA tensors, its plain version on CPU tensors."""
    fn = quant_matmul_t_cuda if on_cuda(g) else quant_matmul_t_plain
    return fn(g, q, scale)


def quant_matmul4(x, q4, scale, out_dtype=None):
    """#11 on CUDA tensors, its plain version on CPU tensors."""
    fn = quant_matmul4_cuda if on_cuda(x) else quant_matmul4_plain
    return fn(x, q4, scale, out_dtype)


# ---------------------------------------------------------------------------
# w8a8: int8 products on per-token int8 activations
# ---------------------------------------------------------------------------

def _int8_rows(v32: torch.Tensor, floor: float):
    """Per-row symmetric int8 of f32 ``[.., C]`` -> (int8 codes, amax
    ``[.., 1]`` clamped at ``floor``)."""
    ax = v32.abs().amax(dim=-1, keepdim=True).clamp(min=floor)
    vq = torch.clamp(torch.round(v32 * (ax.new_tensor(127.0) / ax)), -127,
                     127)
    return vq.to(torch.int8), ax


def w8a8_nd(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            outlier_cols: int = 0) -> torch.Tensor:
    """``x [.., K] @ int8 q [N, K]^T`` on an int8 GEMM (exact int32 sums):
    per-token activation quantization (JAX ``_w8a8_nd``), with the
    ``outlier_cols`` largest-amplitude columns (over all rows) carried in
    bf16 through a side product and zeroed out of the int8 part."""
    lead, k = x.shape[:-1], x.shape[-1]
    x32 = x.float()
    y_out = None
    if outlier_cols > 0:
        idx = torch.topk(x32.abs().reshape(-1, k).amax(dim=0),
                         outlier_cols).indices
        x_o = x[..., idx].to(torch.bfloat16).float()
        w_o = (q[:, idx].float() * scale[:, None]).to(torch.bfloat16).float()
        y_out = (x_o @ w_o.t()).to(x.dtype)
        keep = torch.ones(k, dtype=torch.float32, device=x.device)
        keep[idx] = 0.0
        x32 = x32 * keep
    xq, ax = _int8_rows(x32, 1e-8)
    acc = torch._int_mm(xq.reshape(-1, k), q.t()).reshape(*lead, -1)
    y = (acc.float() * (ax / 127.0) * scale).to(x.dtype)
    return y if y_out is None else y + y_out


def int8_dx(g: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    """dx of ``x @ dequant(q)^T`` on an int8 GEMM: the weight scale rides
    the contraction, so it is folded into g before the per-token int8
    quantization (JAX ``_q8_dense_bwd``'s ``int8_dx``)."""
    lead, n = g.shape[:-1], g.shape[-1]
    gq, ax = _int8_rows(g.float() * scale, 1e-20)
    acc = torch._int_mm(gq.reshape(-1, n), q).reshape(*lead, -1)
    return (acc.float() * (ax / 127.0)).to(g.dtype)


# ---------------------------------------------------------------------------
# Dense layers through a frozen quantized weight
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


class _Q8Dense(torch.autograd.Function):
    """``x @ dequant(q)^T``, differentiable in x only: the weight is frozen
    and gets no gradient (the JAX ``_q8_dense_vjp``)."""

    @staticmethod
    def forward(ctx, x, q, scale, mode: QuantMode):
        ctx.save_for_backward(q, scale)
        ctx.mode = mode
        m = _rows(x)
        if m > _STREAMING_MAX_M:
            if mode.w8a8:
                return w8a8_nd(x, q, scale, mode.outlier_cols)
            return torch.matmul(x, dequantize_weight(q, scale, x.dtype).t())
        return quant_matmul(_flat(x), q, scale).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        mode = ctx.mode
        m = _rows(g)
        if m > _STREAMING_MAX_M:
            if mode.w8a8 and mode.bwd_int8:
                dx = int8_dx(g, q, scale)
            else:
                dx = torch.matmul(g, dequantize_weight(q, scale, g.dtype))
        else:
            dx = quant_matmul_transposed(_flat(g), q, scale).reshape(
                *g.shape[:-1], -1)
        return dx, None, None, None


class _Q4Dense(torch.autograd.Function):
    """``x @ dequant4(q4)^T``, differentiable in x only (the JAX
    ``_q4_dense_vjp``); the backward always dequantizes, as there."""

    @staticmethod
    def forward(ctx, x, q4, scale):
        ctx.save_for_backward(q4, scale)
        if _rows(x) > _STREAMING_MAX_M:
            return torch.matmul(x, dequantize_weight4(q4, scale, x.dtype).t())
        return quant_matmul4(_flat(x), q4, scale).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        q4, scale = ctx.saved_tensors
        return (torch.matmul(g, dequantize_weight4(q4, scale, g.dtype)),
                None, None)


class QuantLinear(nn.Module):
    """A frozen int8 (``bits`` 8) or int4 (``bits`` 4) linear layer ``[out,
    in]`` with its f32 scales, an optional bias (not applied by
    ``forward``: the models add it after the LoRA sum, as for ``nn.Linear``
    weights) and the ``QuantMode`` its products run in."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int,
                 bias: Optional[torch.Tensor] = None,
                 mode: QuantMode = QuantMode()):
        super().__init__()
        if bits not in (8, 4):
            raise ValueError(f"bits={bits}")
        self.bits = bits
        self.mode = mode
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @staticmethod
    def from_weight(w: torch.Tensor, bits: int, bias=None,
                    mode: QuantMode = QuantMode()) -> "QuantLinear":
        """Quantize ``w`` [out, in]: int4 when ``bits`` is 4 and ``in`` is
        a multiple of ``GROUP``, else int8 (the JAX fallback)."""
        if bits == 4 and w.shape[-1] % GROUP == 0:
            return QuantLinear(*quantize_weight_int4(w), 4, bias, mode)
        return QuantLinear(*quantize_weight(w), 8, bias, mode)

    @property
    def in_features(self) -> int:
        return self.q.shape[1] * (2 if self.bits == 4 else 1)

    @property
    def out_features(self) -> int:
        return self.q.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W^T`` in x's dtype, without the bias."""
        return (q4_dense if self.bits == 4 else q8_dense)(x, self)

    def matmul_f32(self, x2: torch.Tensor) -> torch.Tensor:
        """``x2 [M, in] @ W^T`` with f32 output, through the kernel at any
        M (the quantized decode head)."""
        fn = quant_matmul4 if self.bits == 4 else quant_matmul
        return fn(x2.contiguous(), self.q, self.scale, torch.float32)


def q8_dense(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    return _Q8Dense.apply(x, lin.q, lin.scale, lin.mode)


def q4_dense(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    return _Q4Dense.apply(x, lin.q, lin.scale)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def quantizable_linears(model: nn.Module):
    """``(parent, name, module)`` of every linear that the QLoRA
    configuration quantizes: the vision tower's and the decoder's block
    linears.  The patch embedding, the projector, the embeddings, the
    lm_head, norms and biases stay in their own dtypes (the JAX skip list,
    after the reference's ``llm_int8_skip_modules``)."""
    out = []
    for stack in (model.vision.layers, model.llama.layers):
        for block in stack:
            for name, child in block.named_children():
                if isinstance(child, (nn.Linear, QuantLinear)):
                    out.append((block, name, child))
    return out


@torch.no_grad()
def quantize_params(model: nn.Module, bits: int = 8,
                    mode: QuantMode = QuantMode()) -> nn.Module:
    """Replace the quantizable ``nn.Linear``s of a ``Llava`` with
    ``QuantLinear``s, in place, one at a time (each bf16 weight is freed as
    its codes are made), and return the model.  ``bits`` 8: int8 per
    output channel; 4: int4 in groups of ``GROUP``, int8 where the input
    width is not a multiple of it."""
    if bits not in (8, 4):
        raise ValueError(f"bits={bits} (8 or 4)")
    for parent, name, lin in quantizable_linears(model):
        if isinstance(lin, nn.Linear):
            setattr(parent, name, QuantLinear.from_weight(
                lin.weight, bits, lin.bias, mode))
    return model


def set_quant_mode(model: nn.Module, mode: QuantMode) -> None:
    """Set the w8a8 switches of every ``QuantLinear`` of ``model``."""
    for module in model.modules():
        if isinstance(module, QuantLinear):
            module.mode = mode


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, QuantLinear) for m in model.modules())


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer of ``model``."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
