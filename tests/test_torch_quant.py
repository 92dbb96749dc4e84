"""Parity of the port's quantized base weights (``opadpo_torch.ops.quant``)
with the JAX package's ``opadpo_tpu/ops/quant.py``: the codes, the plain
versions of the three kernels against the interpret-mode Pallas calls,
the dense layers' outputs and gradients on both sides of the 1024-row
rule, w8a8 and its int8 backward, and which leaves ``quantize_params``
quantizes.

Tolerances: codes equal exactly; f32 products within 1e-5 of the largest
entry (the same exact products summed in another order); bf16 outputs
within one bf16 step of each other (both round the same f32 sum)."""

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
