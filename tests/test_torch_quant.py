"""Parity of the port's quantized base weights (``opadpo_torch.ops.quant``)
with the JAX package's ``opadpo_tpu/ops/quant.py``: the codes, the plain
versions of the three kernels against the interpret-mode Pallas calls,
the dense layers' outputs and gradients on both sides of the 1024-row
rule, w8a8 and its int8 backward, and which leaves ``quantize_params``
quantizes.

Tolerances: codes equal exactly; f32 products within 1e-5 of the largest
entry (the same exact products summed in another order); bf16 outputs
within one bf16 step of each other (both round the same f32 sum)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.ops import quant as jq
from opadpo_torch.models import llava as t_llava
from opadpo_torch.ops import quant as tq

torch.set_num_threads(2)


def _weight(rng, k, n, lead=()):
    """[.., K, N] in the JAX layout, with an all-zero output column and
    values that land on .5 after scaling (round half to even)."""
    w = rng.normal(0, 0.05, lead + (k, n)).astype(np.float32)
    w[..., :, 0] = 0.0
    w[..., :4, 1] = (1.0, 2.5 / 127, -0.5 / 127, 3.5 / 127)
    w[..., 4:, 1] = 0.0
    return w


def _jax_t(w):
    return np.swapaxes(np.asarray(w), -1, -2)


@pytest.mark.parametrize("bits", [8, 4])
def test_codes_and_scales_equal_jax(bits):
    """int8 per channel and int4 group-128 codes, packed bytes and scales
    equal the JAX package's bit for bit, transposed to [N, K], for a single
    weight and a stacked one."""
    rng = np.random.default_rng(0)
    for lead in ((), (2,)):
        w = _weight(rng, 256, 48, lead)
        wt = torch.from_numpy(_jax_t(w).copy())
        if bits == 8:
            ref = jq.quantize_weight(jnp.asarray(w))
            q, s = tq.quantize_weight(wt)
            np.testing.assert_array_equal(q.numpy(), _jax_t(ref["q"]))
            np.testing.assert_array_equal(s.numpy(),
                                          np.asarray(ref["scale"])[..., 0, :])
            deq = jq.dequantize_weight(ref, jnp.float32)
            np.testing.assert_array_equal(
                tq.dequantize_weight(q, s, torch.float32).numpy(),
                _jax_t(deq))
        else:
            ref = jq.quantize_weight_int4(jnp.asarray(w))
            q, s = tq.quantize_weight_int4(wt)
            np.testing.assert_array_equal(q.numpy(), _jax_t(ref["q4"]))
            np.testing.assert_array_equal(s.numpy(), _jax_t(ref["scale"]))
            deq = jq.dequantize_weight4(ref, jnp.float32)
            np.testing.assert_array_equal(
                tq.dequantize_weight4(q, s, torch.float32).numpy(),
                _jax_t(deq))


def _assert_bf16_step(out, ref):
    """Within one bf16 step: the two differ by at most 2^-7 of the larger
    magnitude (one unit in the last place of an 8-bit significand)."""
    a = np.asarray(out, np.float32)
    r = np.asarray(ref, np.float32)
    bound = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(r)) + 1e-30
    assert np.all(np.abs(a - r) <= bound), np.abs(a - r).max()


def _assert_f32(out, ref):
    r = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), r, rtol=0,
                               atol=1e-5 * np.abs(r).max())


def _jnp_bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


@pytest.mark.parametrize("kernel,dtype", [
    ("q8", "f32"), ("q8", "bf16"), ("q8", "bf16_to_f32"), ("q8t", "bf16"),
    ("q4", "f32"), ("q4", "bf16"), ("q4", "bf16_to_f32")])
def test_plain_kernels_match_pallas(kernel, dtype):
    """Each kernel's plain version against the Pallas kernel in interpret
    mode, at M 1, 8 and 37, K 256 and 384 (2 and 3 int4 groups), N 200
    (not a multiple of 128), several K blocks on the JAX side.  #10 takes
    bf16 gradients only (its wrapper rounds g * scale to bf16 as the
    kernel does; an f32 g is covered by the dense tests)."""
    rng = np.random.default_rng(1)
    n = 200
    for m in (1, 8, 37):
        for k in (256, 384):
            w = _weight(rng, k, n)
            x = rng.normal(size=(m, k if kernel != "q8t" else n)).astype(
                np.float32)
            xj = _jnp_bf16(x) if dtype != "f32" else jnp.asarray(x)
            xt = torch.tensor(np.asarray(xj.astype(jnp.float32)))
            xt = xt.to(torch.bfloat16) if dtype != "f32" else xt
            out_j = jnp.float32 if dtype == "bf16_to_f32" else None
            out_t = torch.float32 if dtype == "bf16_to_f32" else None
            wt = torch.from_numpy(_jax_t(w).copy())
            if kernel == "q8":
                wq = jq.quantize_weight(jnp.asarray(w))
                ref = jq.quant_matmul(xj, wq, block_k=128, out_dtype=out_j)
                out = tq.quant_matmul(xt, *tq.quantize_weight(wt), out_t)
            elif kernel == "q4":
                wq = jq.quantize_weight_int4(jnp.asarray(w))
                ref = jq.quant_matmul4(xj, wq, out_dtype=out_j)
                out = tq.quant_matmul4(xt, *tq.quantize_weight_int4(wt),
                                       out_t)
            else:
                wq = jq.quantize_weight(jnp.asarray(w))
                ref = jq.quant_matmul_transposed(xj, wq, block_k=128)
                out = tq.quant_matmul_transposed(xt, *tq.quantize_weight(wt))
            assert out.shape == ref.shape
            assert str(out.dtype).endswith(str(ref.dtype)), (out.dtype,
                                                             ref.dtype)
            got = out.float().numpy()
            want = np.asarray(ref.astype(jnp.float32))
            if ref.dtype == jnp.bfloat16:
                _assert_bf16_step(got, want)
            else:
                _assert_f32(got, want)


def _dense_case(bits, rows_shape, k=128, n=48, seed=2):
    rng = np.random.default_rng(seed)
    w = _weight(rng, k, n)
    x = rng.normal(size=rows_shape + (k,)).astype(np.float32)
    c = rng.normal(size=rows_shape + (n,)).astype(np.float32)
    if bits == 8:
        wq, dense = jq.quantize_weight(jnp.asarray(w)), jq.q8_dense
    else:
        wq, dense = jq.quantize_weight_int4(jnp.asarray(w)), jq.q4_dense
    lin = tq.QuantLinear.from_weight(torch.from_numpy(_jax_t(w).copy()), bits)
    assert lin.bits == bits
    return x, c, wq, dense, lin


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows_shape", [(2, 5), (3, 350)],
                         ids=["10_rows", "1050_rows"])
def test_dense_forward_and_dx_match_jax(bits, rows_shape):
    """``q8_dense`` / ``q4_dense`` outputs and dx (weight frozen: no
    gradient for its codes or scales) against the JAX package's under
    ``jax.grad``, at 10 rows (the kernels' plain versions) and 1050 (above
    the 1024-row rule: dequantize, then a plain product): 1e-5."""
    x, c, wq, dense, lin = _dense_case(bits, rows_shape)
    y_ref, vjp = jax.vjp(lambda xx: dense(xx, wq), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(c))
    xt = torch.from_numpy(x).requires_grad_(True)
    fn = tq.q8_dense if bits == 8 else tq.q4_dense
    y = fn(xt, lin)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(c))
    _assert_f32(y.detach().numpy(), y_ref)
    _assert_f32(dx.numpy(), dx_ref)
    assert lin.q.grad is None and not lin.q.requires_grad


@pytest.mark.parametrize("outlier_cols", [0, 4])
def test_w8a8_and_int8_dx_match_jax(outlier_cols, monkeypatch):
    """Above 1024 rows with act_bits 8: the w8a8 forward (per-token int8
    activations, top-k outlier columns in bf16) and the int8 dx
    (``act_bwd_int8``) against the JAX package with its global switches
    set for the test (monkeypatch restores them): 1e-5.  Below the rule
    the switches change nothing."""
    monkeypatch.setattr(jq, "_ACT_QUANT", True)
    monkeypatch.setattr(jq, "_ACT_OUTLIER_COLS", outlier_cols)
    monkeypatch.setattr(jq, "_ACT_BWD_INT8", True)
    mode = tq.QuantMode(8, outlier_cols, True)
    for rows_shape in ((2, 520), (2, 5)):
        x, c, wq, dense, lin = _dense_case(8, rows_shape, k=64, seed=3)
        x[..., 7] *= 20.0                  # an outlier feature column
        lin.mode = mode
        y_ref, vjp = jax.vjp(lambda xx: dense(xx, wq), jnp.asarray(x))
        (dx_ref,) = vjp(jnp.asarray(c))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = tq.q8_dense(xt, lin)
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(c))
        _assert_f32(y.detach().numpy(), y_ref)
        _assert_f32(dx.numpy(), dx_ref)
    big = np.asarray(jq._w8a8_nd(jnp.asarray(x), wq["q"], wq["scale"]))
    _assert_f32(tq.w8a8_nd(torch.from_numpy(x), lin.q, lin.scale,
                           outlier_cols).numpy(), big)


def _jax_quantized_paths(params, bits):
    """{(tower, leaf name): "q" or "q4"} of the JAX package's quantized
    leaves."""
    q = jq.quantize_params(params, bits=bits)
    out = {}
    for top in ("vision", "llama", "projector"):
        for name, leaf in q[top].get("layers", {}).items():
            if isinstance(leaf, dict):
                out[(top, name)] = "q4" if "q4" in leaf else "q"
        for name, leaf in q[top].items():
            assert not jq.is_quantized(leaf) and not jq.is_quantized4(leaf)
    return out, q


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_same_leaves_as_jax(bits):
    """On the tiny LLaVA: the same block linears are quantized, each to
    the same width (at bits 4 the tiny CLIP's K = 64 linears and
    ``w_down``'s K = 352 fall back to int8), the rest stays; and the whole
    quantized model holds as many bytes as the JAX tree."""
    cfg = jax_llava.LlavaConfig.tiny()
    ref, jq_params = _jax_quantized_paths(
        jax_llava.init_params(jax.random.PRNGKey(0), cfg), bits)
    model = t_llava.init_params(t_llava.LlavaConfig.tiny(),
                                torch.Generator().manual_seed(0), "cpu")
    tq.quantize_params(model, bits=bits)
    got = {}
    for name, mod in model.named_modules():
        if isinstance(mod, tq.QuantLinear):
            parts = name.split(".")
            key = (parts[0], parts[-1])
            kind = "q4" if mod.bits == 4 else "q"
            assert got.setdefault(key, kind) == kind, name
    assert got == ref
    if bits == 4:
        assert ref[("vision", "wq")] == "q" and ref[("llama", "w_down")] == "q"
        assert ref[("llama", "wq")] == "q4"
    assert tq.quantized_bytes(model) == jq.quantized_bytes(jq_params)


# ---------------------------------------------------------------------------
# The Hopper int8 kernels (csrc/int8_matmul.cu): their arithmetic and rules,
# emulated on the CPU
# ---------------------------------------------------------------------------

def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: result byte i is
    byte ``(sel >> 4i) & 7`` of the eight bytes of (y:x), x the low four."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        byte = (both >> np.uint64(8 * src)) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def _widen4(words):
    """The kernel's ``widen4``: four int8 codes per uint32 -> two uint32 of
    bf16 pairs, by byte_perm into 2^23 + 128 + b, an f32 subtract and the
    high halves (the selectors and constants of int8_matmul.cu)."""
    u = np.asarray(words, np.uint32) ^ np.uint32(0x80808080)
    magic = np.float32(8388736.0)
    f = [(_byte_perm(u, 0x4B000000, sel).view(np.float32) - magic)
         .view(np.uint32) for sel in (0x7540, 0x7541, 0x7542, 0x7543)]
    return (_byte_perm(f[0], f[1], 0x7632), _byte_perm(f[2], f[3], 0x7632))


def test_int8_widening_exact_for_all_256_codes():
    """The kernels' int8 -> bf16 widening (no int-to-float convert) gives
    ``q.to(torch.bfloat16)`` bit for bit for every code, -128 included;
    the emulation's constants are the ones ``widen4`` uses."""
    src = (pathlib.Path(tq.__file__).parent.parent / "csrc"
           / "int8_matmul.cu").read_text()
    body = src[src.index("uint2 widen4("):src.index("void widen16(")]
    for const in ("0x80808080u", "8388736.f", "0x4B000000u", "0x7540",
                  "0x7541", "0x7542", "0x7543", "0x7632"):
        assert const in body, const
    codes = np.arange(-128, 128, dtype=np.int8)
    words = codes.view(np.uint8).reshape(-1, 4).copy().view(np.uint32)[:, 0]
    lo, hi = _widen4(words)
    got = np.stack([lo, hi], axis=1).reshape(-1).view(np.uint16)
    want = torch.from_numpy(codes).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint16))


def _decode_walk(k, splits):
    """The contraction tiles split z of #9's decode kernel walks, by the
    kernel's rule: ``range(z * per, min(nk, (z + 1) * per))``, ``per =
    ceil(nk / splits)``."""
    nk = -(-k // tq.TILE_K)
    per = -(-nk // splits)
    return [range(z * per, min(nk, (z + 1) * per)) for z in range(splits)]


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_decode_split_rule_and_walk_against_brute_force(sms):
    """#9's decode kernel: the split count is the fewest splits of the
    smallest equal share that fits ``DECODE_CTAS_PER_SM`` CTAs on each SM
    (found by trying every share), every split walks a non-empty run of
    the contraction tiles by the kernel's rule, and the runs cover each
    tile once in order."""
    for n in (64, 128, 352, 1024, 4096, 11008, 13824, 32000):
        for k in (16, 64, 128, 352, 1024, 4096, 5120, 11008, 13824):
            nk = -(-k // tq.TILE_K)
            tiles = -(-n // tq.DECODE_N)
            cap = max(1, min(nk, tq.DECODE_CTAS_PER_SM * sms // tiles))
            share = next(p for p in range(1, nk + 1) if -(-nk // p) <= cap)
            splits = tq.decode_splits(n, k, sms)
            assert splits == -(-nk // share), (n, k)
            walk = _decode_walk(k, splits)
            assert len(walk) == splits and all(len(r) for r in walk)
            assert [t for r in walk for t in r] == list(range(nk))
            assert (splits - 1) * -(-nk // splits) < nk   # the kernel's check
            assert tiles * splits <= max(tiles, tq.DECODE_CTAS_PER_SM * sms)


def test_kernel_choice_and_tile_width_rules():
    """Which kernel each shape takes: the TMA kernels wherever every row
    (x or g bf16, q int8) is a multiple of 16 bytes long, the decode
    kernel at M <= 16; and #9's tile width is 256 where its grid gives at
    least one CTA per two SMs, else 64, checked by counting CTAs.  Every
    shape of the 7B / 13B / CLIP and tiny int8 paths takes a TMA kernel."""
    for m in (1, 8, 16, 17, 577, 703, 1024):
        for k in (8, 16, 64, 72, 100, 128, 352, 4096, 11008):
            for n in (4, 8, 100, 128, 300, 1024, 4096, 32000):
                tma9 = (2 * k) % 16 == 0 and k % 16 == 0
                want9 = "odd" if not tma9 else (
                    "decode" if m <= 16 else "tile")
                assert tq.q8_variant(m, n, k) == want9
                tma10 = (2 * n) % 16 == 0 and k % 16 == 0
                assert tq.q8t_variant(m, n, k) == ("tile" if tma10
                                                   else "odd")
                ctas = len(range(0, m, 128)) * len(range(0, n, 256))
                assert tq.tile_bn(m, n, 132) == (256 if 2 * ctas >= 132
                                                 else 64)
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
                 (1024, 1024), (1024, 4096), (4096, 1024), (64, 128),
                 (128, 64), (128, 352), (352, 128), (128, 512)):
        for m in (1, 8, 577, 703):
            assert tq.q8_variant(m, n, k) != "odd"
            assert tq.q8t_variant(m, n, k) == "tile"


def _tiled_q8(x, q, scale, splits=1):
    """#9 in the kernels' order: f32 products of 64-deep tiles summed in
    tile order, per split; the splits' partials summed in split order;
    then the scale."""
    k = x.shape[1]
    xf, wf = x.float(), q.float()
    parts = []
    for run in _decode_walk(k, splits):
        acc = torch.zeros(x.shape[0], q.shape[0])
        for t in run:
            sl = slice(t * tq.TILE_K, (t + 1) * tq.TILE_K)
            acc += xf[:, sl] @ wf[:, sl].t()
        parts.append(acc)
    total = torch.zeros_like(parts[0])
    for p in parts:
        total += p
    return total * scale


def _tiled_q8t(g, q, scale):
    """#10 in the kernel's order: gs = bf16(f32(g) * scale) folded per
    tile, then f32 products of 64-deep contraction tiles in order."""
    n = g.shape[1]
    gs = (g.float() * scale).to(torch.bfloat16).float()
    acc = torch.zeros(g.shape[0], q.shape[1])
    for t in range(-(-n // 64)):
        sl = slice(t * 64, (t + 1) * 64)
        acc += gs[:, sl] @ q[sl].float()
    return acc.to(torch.bfloat16)


def test_tiled_sum_order_matches_plain_and_pallas():
    """The kernels' sum order (#9 tile, #9 decode split two and three
    ways, #10 with its in-kernel scale fold) against the plain versions
    and the interpret-mode Pallas kernels: f32 within 1e-5 of the largest
    entry, bf16 within one bf16 step."""
    rng = np.random.default_rng(7)
    n = 200
    for m, k in ((1, 256), (9, 384), (37, 384)):
        w = _weight(rng, k, n)
        wt = torch.from_numpy(_jax_t(w).copy())
        q, s = tq.quantize_weight(wt)
        wq = jq.quantize_weight(jnp.asarray(w))
        x = _jnp_bf16(rng.normal(size=(m, k)).astype(np.float32))
        xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16)
        ref_j = np.asarray(jq.quant_matmul(x, wq, block_k=128,
                                           out_dtype=jnp.float32))
        plain = tq.quant_matmul_plain(xt, q, s, torch.float32)
        for splits in (1, 2, 3):
            got = _tiled_q8(xt, q, s, splits)
            _assert_f32(got.numpy(), ref_j)
            _assert_f32(got.numpy(), plain.numpy())
            _assert_bf16_step(got.to(torch.bfloat16).float().numpy(),
                              plain.to(torch.bfloat16).float().numpy())
        gj = _jnp_bf16(rng.normal(size=(m, n)).astype(np.float32))
        gt = torch.tensor(np.asarray(gj.astype(jnp.float32))).to(
            torch.bfloat16)
        got = _tiled_q8t(gt, q, s).float().numpy()
        _assert_bf16_step(got, tq.quant_matmul_t_plain(gt, q, s).float())
        _assert_bf16_step(got, np.asarray(jq.quant_matmul_transposed(
            gj, wq, block_k=128).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# The Hopper int4 kernels (csrc/int4_matmul.cu): their arithmetic and rules,
# emulated on the CPU
# ---------------------------------------------------------------------------

def _int4_source():
    return (pathlib.Path(tq.__file__).parent.parent / "csrc"
            / "int4_matmul.cu").read_text()


def _bf16_fma(a, b, c):
    """``fma.rn.bf16x2``: per 16-bit half, a * b + c rounded once to bf16
    (the halves' products and sums here are exact in f32, so rounding the
    f32 result to bf16 is that one rounding)."""
    def halves(x):
        x = torch.as_tensor(np.asarray(x, np.uint32).astype(np.int64))
        return [((x >> s) & 0xFFFF).to(torch.int32) for s in (0, 16)]

    def as_f32(h):
        return (h << 16).view(torch.float32)

    out = []
    for ha, hb, hc in zip(halves(a), halves(b), halves(c)):
        v = (as_f32(ha) * as_f32(hb) + as_f32(hc)).to(torch.bfloat16)
        out.append(v.view(torch.int16).to(torch.int64) & 0xFFFF)
    return (out[0] | (out[1] << 16)).numpy().astype(np.uint32)


def _widen_nib4(words):
    """The kernel's ``widen_nib4``: four packed bytes per uint32 -> the
    bf16 pairs of their low nibbles (bytes 0-1, 2-3) and of their high
    nibbles: each nibble placed in the low bits of a 16-bit half
    (byte_perm, AND), its sign bit flipped and the exponent of the bf16
    128.0 set (XOR), then one bf16x2 FMA that subtracts 136 (the constants
    of int4_matmul.cu)."""
    w = np.asarray(words, np.uint32)
    v = w >> np.uint32(4)

    def pair(x, sel):
        t = (_byte_perm(x, 0, sel) & np.uint32(0x000F000F)) \
            ^ np.uint32(0x43084308)
        return _bf16_fma(t, 0x3F803F80, 0xC308C308)

    return ((pair(w, 0x4140), pair(w, 0x4342)),
            (pair(v, 0x4140), pair(v, 0x4342)))


def test_int4_widening_exact_for_all_256_codes():
    """The int4 kernels' nibble -> bf16 widening (no convert instruction)
    gives both signed nibbles of every byte value exactly, as
    ``unpack_nibbles`` reads them; the emulation's constants are the ones
    ``widen_nib4`` and ``minus136`` use."""
    src = _int4_source()
    body = src[src.index("uint32_t minus136("):src.index("// raw packed tile")]
    for const in ("0x4140", "0x4342", "0x000F000Fu", "0x43084308u",
                  "0x3F803F80u", "0xC308C308u", "fma.rn.bf16x2", "w >> 4",
                  "(__byte_perm(w, 0, sel)", "(__byte_perm(v, 0, sel)"):
        assert const in body, const
    codes = np.arange(256, dtype=np.uint8)
    words = codes.reshape(-1, 4).copy().view(np.uint32)[:, 0]
    (lo01, lo23), (hi01, hi23) = _widen_nib4(words)

    def values(p01, p23):
        bits = np.stack([p01, p23], axis=1).reshape(-1).view(np.uint16)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)

    lo, hi = tq.unpack_nibbles(torch.from_numpy(codes.view(np.int8))
                               .to(torch.int32))
    assert torch.equal(values(lo01, lo23), lo.to(torch.bfloat16))
    assert torch.equal(values(hi01, hi23), hi.to(torch.bfloat16))
    assert int(lo.min()) == int(hi.min()) == -8
    assert int(lo.max()) == int(hi.max()) == 7


def _group_walk(groups, splits):
    """The groups split z of #11's decode kernel walks, by the kernel's
    rule: ``range(z * per, min(groups, (z + 1) * per))``, ``per =
    ceil(groups / splits)``."""
    per = -(-groups // splits)
    return [range(z * per, min(groups, (z + 1) * per))
            for z in range(splits)]


@pytest.mark.parametrize("sms", [132, 114])
def test_q4_kernel_choice_and_decode_split_rule_against_brute_force(sms):
    """#11's kernel choice (the decode kernel at M <= 16, else the tile
    kernel, at every K a multiple of 128), its tile width (128 weight rows
    where the grid gives at least one CTA per two SMs, else 64, by counting
    CTAs) and its decode split count: the fewest splits of the smallest
    equal share of the groups that fits ``DECODE_CTAS_PER_SM`` CTAs on
    each SM (found by trying every share), each split a non-empty run of
    groups by the kernel's rule, the runs covering every group once in
    order."""
    for m in (1, 8, 16, 17, 129, 577, 703, 1024, 2688):
        for n in (100, 128, 300, 1024, 4096, 5120, 13824, 32000):
            for k in (128, 384, 5120, 13824):
                assert tq.q4_variant(m, n, k) == ("decode" if m <= 16
                                                  else "tile")
            ctas = len(range(0, m, 128)) * len(range(0, n, 128))
            assert tq.tile_bn(m, n, sms, tq.Q4_TILE_N) == (
                128 if 2 * ctas >= sms else 64)
    for n in (64, 128, 300, 1024, 4096, 5120, 13824, 32000):
        for k in (128, 256, 384, 1024, 4096, 5120, 13824):
            groups = k // tq.GROUP
            tiles = -(-n // tq.DECODE_N)
            cap = max(1, min(groups, tq.DECODE_CTAS_PER_SM * sms // tiles))
            share = next(p for p in range(1, groups + 1)
                         if -(-groups // p) <= cap)
            splits = tq.decode_splits(n, k, sms, tq.GROUP)
            assert splits == -(-groups // share), (n, k)
            walk = _group_walk(groups, splits)
            assert len(walk) == splits and all(len(r) for r in walk)
            assert [g for r in walk for g in r] == list(range(groups))
            assert (splits - 1) * -(-groups // splits) < groups
            assert tiles * splits <= max(tiles, tq.DECODE_CTAS_PER_SM * sms)


def _grouped_q4(x, q4, scale, walk):
    """#11 in the kernels' order: per group, the f32 product of the 128-deep
    slice times that group's scale of each weight row, added into the
    accumulator (one FMA each) in group order, per split of ``walk``; the
    splits' partials summed in split order."""
    groups = scale.shape[1]
    xg = x.float().reshape(x.shape[0], groups, -1)
    w = tq._unpack_groups(q4, groups).float()
    parts = []
    for run in walk:
        acc = torch.zeros(x.shape[0], q4.shape[0])
        for gi in run:
            acc = torch.addcmul(acc, xg[:, gi] @ w[:, gi].t(), scale[:, gi])
        parts.append(acc)
    total = torch.zeros_like(parts[0])
    for p in parts:
        total += p
    return total


def test_int4_kernel_sum_order_matches_plain_and_pallas():
    """The int4 kernels' sum order (the tile kernel: every group in order;
    the decode kernel split one, two and three ways, the splits summed in
    order) against the plain version and the interpret-mode Pallas kernel,
    at M 1, 9, 37 and K 256, 384 (2 and 3 groups), N 200: f32 within 1e-5
    of the largest entry, bf16 within one bf16 step."""
    rng = np.random.default_rng(11)
    n = 200
    for m in (1, 9, 37):
        for k in (256, 384):
            groups = k // tq.GROUP
            w = _weight(rng, k, n)
            wt = torch.from_numpy(_jax_t(w).copy())
            q4, s = tq.quantize_weight_int4(wt)
            wq = jq.quantize_weight_int4(jnp.asarray(w))
            x = _jnp_bf16(rng.normal(size=(m, k)).astype(np.float32))
            xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(
                torch.bfloat16)
            ref_j = np.asarray(jq.quant_matmul4(x, wq, out_dtype=jnp.float32))
            ref_jb = np.asarray(jq.quant_matmul4(x, wq).astype(jnp.float32))
            plain = tq.quant_matmul4_plain(xt, q4, s, torch.float32)
            plain_b = tq.quant_matmul4_plain(xt, q4, s).float()
            walks = [[range(groups)]] + [_group_walk(groups, z)
                                         for z in (1, 2, 3) if z <= groups]
            for walk in walks:
                got = _grouped_q4(xt, q4, s, walk)
                _assert_f32(got.numpy(), ref_j)
                _assert_f32(got.numpy(), plain.numpy())
                got_b = got.to(torch.bfloat16).float().numpy()
                _assert_bf16_step(got_b, plain_b.numpy())
                _assert_bf16_step(got_b, ref_jb)
