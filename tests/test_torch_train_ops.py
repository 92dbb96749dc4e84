"""Parity of the port's training ops with the JAX package on the CPU: the
attention backward and the fused composites (Pallas in interpret mode), the
head-layout passes, the chunked logprob readout, the CoPO masks and the
optimizer (against optax).  The kernels themselves are held against these
plain versions on the GPU by ``tests/test_torch_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import opadpo_tpu.ops.attention as jax_attention
from opadpo_tpu.engine import train_state as jax_ts
from opadpo_tpu.ops import image_ops as jax_image_ops
from opadpo_tpu.ops import logprobs as jax_logprobs
from opadpo_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from opadpo_torch.engine import train_state as t_ts
from opadpo_torch.ops import attention as t_attention
from opadpo_torch.ops import heads_layout as t_heads
from opadpo_torch.ops import image_ops as t_image_ops
from opadpo_torch.ops import logprobs as t_logprobs
from opadpo_torch.ops.rope import rope_frequencies
from tests.torch_parity import t


def _grads_np(fn, args, keep=None):
    """Values and input gradients of sum(fn(*args) * w), numpy in/out, on
    the port's side; w is random, times ``keep`` (one array per output)
    where given."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.default_rng(99)
    ws = [torch.tensor(rng.normal(size=o.shape).astype(np.float32))
          for o in outs]
    if keep is not None:
        ws = [w * torch.tensor(k, dtype=torch.float32)
              for w, k in zip(ws, keep)]
    loss = sum((o.float() * w).sum() for o, w in zip(outs, ws))
    grads = torch.autograd.grad(loss, ts)
    return ([o.detach().float().numpy() for o in outs],
            [g.float().numpy() for g in grads], [w.numpy() for w in ws])


def _jax_grads(fn, args, ws):
    def loss(*a):
        out = fn(*a)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o.astype(jnp.float32) * w)
                   for o, w in zip(outs, ws))
    vals = fn(*(jnp.asarray(a) for a in args))
    vals = vals if isinstance(vals, tuple) else (vals,)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    return [np.asarray(v, np.float32) for v in vals], \
        [np.asarray(g) for g in grads]


def _close(port, ref, rel, what):
    for i, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(p, r, atol=rel * max(np.abs(r).max(), 1.0),
                                   rtol=0, err_msg=f"{what} {i}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax_kernel(causal):
    """Values and q/k/v gradients against the Pallas forward and backward
    kernels (interpret mode), f32, S = 128 (one Pallas tile, where the JAX
    kernel's fully masked rows average over all keys as the port's do):
    one row unmasked, one left-padded, one masked everywhere with a
    nonzero output gradient.  1e-5 on values, 1e-4 of the largest entry
    on gradients."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(3, 128, 2, 64)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((3, 128), np.int32)
    mask[1, :37] = 0
    mask[2] = 0
    vals, grads, ws = _grads_np(
        lambda a, b, c: t_attention.flash_attention(a, b, c, t(mask),
                                                    causal), (q, k, v))
    j_vals, j_grads = _jax_grads(
        lambda a, b, c: jax_attention.flash_attention(
            a, b, c, key_mask=jnp.asarray(mask), causal=causal),
        (q, k, v), ws)
    _close(vals, j_vals, 1e-5, "o")
    _close(grads, j_grads, 1e-4, "dq/dk/dv")
    assert all(np.isfinite(g).all() for g in grads)


def test_fully_masked_rows_no_nan_in_grads():
    """All keys masked (the JAX suite's test_fully_masked_rows_no_nan) with
    gradients: finite everywhere, causal and not."""
    q = torch.ones(1, 70, 1, 64, requires_grad=True)
    mask = torch.zeros(1, 70, dtype=torch.int32)
    for causal in (True, False):
        out = t_attention.flash_attention(q, q, q, mask, causal)
        (g,) = torch.autograd.grad(out.sum(), q)
        assert torch.isfinite(out).all() and torch.isfinite(g).all()


def test_flash_attention_prefix_unaligned_matches_jax():
    """The rectangular rule at Sp = 37, Sr = 50 (no tile multiple; the JAX
    kernel pads both and offsets by its padded prefix), values and
    gradients against ``flash_attention_prefix`` in interpret mode:
    1e-5 and 1e-4."""
    rng = np.random.default_rng(4)
    sq, skv = 50, 87
    q = rng.normal(size=(2, sq, 2, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, skv, 2, 64)).astype(np.float32)
            for _ in range(2))
    mask = np.ones((2, skv), np.int32)
    mask[1, 3:9] = 0
    mask[0, 60:62] = 0
    vals, grads, ws = _grads_np(
        lambda a, b, c: t_attention.flash_attention_prefix(a, b, c, t(mask)),
        (q, k, v))
    j_vals, j_grads = _jax_grads(
        lambda a, b, c: jax_attention.flash_attention_prefix(
            a, b, c, key_mask=jnp.asarray(mask)), (q, k, v), ws)
    _close(vals, j_vals, 1e-5, "o")
    _close(grads, j_grads, 1e-4, "dq/dk/dv")


def _rope_inputs(b, s, hd, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 200, (b, s)).astype(np.int32)
    jc, js = jax_rope_frequencies(hd, 256)
    half = hd // 2
    return pos, (jnp.asarray(np.asarray(jc)[pos][..., :half]),
                 jnp.asarray(np.asarray(js)[pos][..., :half]))


@pytest.mark.parametrize("rep", [1, 2])
def test_to_heads_and_from_heads_match_jax(rep):
    """``to_heads`` (RoPE, GQA repeat) and its VJP against the JAX
    ``_to_heads`` custom VJP; ``gather_heads`` / ``scatter_heads`` without
    RoPE against ``_from_heads`` and its VJP.  bf16 in both packages
    (rotation in f32, one rounding at the end): 1e-2 of the largest
    entry, one bf16 step."""
    b, s, h, hd = 2, 27, 4, 64
    pos, (cos_g, sin_g) = _rope_inputs(b, s, hd, seed=rep)
    rng = np.random.default_rng(rep)
    x = rng.normal(size=(b, s, (h // rep) * hd)).astype(np.float32)
    g = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    cos, sin = rope_frequencies(hd, 256)
    tpos = t(pos, torch.int64)

    xt = t(x).to(torch.bfloat16).requires_grad_(True)
    out = t_heads.to_heads(xt, cos, sin, tpos, h, True, rep)
    (dx,) = torch.autograd.grad(out, xt, t(g).to(torch.bfloat16))
    j_out, vjp = jax.vjp(
        lambda a: jax_attention._to_heads(a, cos_g, sin_g, h, s, True, s,
                                          jnp.bfloat16, rep),
        jnp.asarray(x, jnp.bfloat16))
    (j_dx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    _close([out.detach().float().numpy(), dx.float().numpy()],
           [np.asarray(j_out, np.float32), np.asarray(j_dx, np.float32)],
           1e-2, "to_heads")

    gt = t(g).to(torch.bfloat16)
    merged = t_heads.gather_heads(gt, None, None, None, False)
    split = t_heads.scatter_heads(merged, None, None, None, h, False)
    j_merged, vjp = jax.vjp(
        lambda a: jax_attention._from_heads(a, jnp.bfloat16, jnp.bfloat16, h),
        jnp.asarray(g, jnp.bfloat16))
    (j_split,) = vjp(j_merged)
    _close([merged.float().numpy(), split.float().numpy()],
           [np.asarray(j_merged, np.float32), np.asarray(j_split, np.float32)],
           1e-2, "from_heads")


def _grad_in_layout(g, layout, rng, offset=5):
    """numpy ``[B, H, S, hd]`` -> a bf16 tensor of its values, laid out as
    a gradient reaches ``to_heads_qkv``'s backward: ``bshd`` the permuted
    view of a contiguous ``[B, S, H, hd]`` (the flash backward's output),
    ``slice`` that view of a longer ``[B, offset + S, H, hd]`` at
    ``offset`` along S (the response stream's dK / dV out of the
    ``[prefix ++ response]`` gradient), ``bhsd`` contiguous head-major."""
    gt = t(g).to(torch.bfloat16)
    if layout == "bhsd":
        return gt
    if layout == "bshd":
        return gt.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    b, h, s, hd = g.shape
    big = t(rng.normal(size=(b, offset + s, h, hd)).astype(np.float32))
    big = big.to(torch.bfloat16)
    big[:, offset:] = gt.permute(0, 2, 1, 3)
    return big.permute(0, 2, 1, 3)[:, :, offset:]


@pytest.mark.parametrize("layout", ["bshd", "slice", "bhsd"])
@pytest.mark.parametrize("rep", [1, 2])
def test_to_heads_qkv_matches_jax(rep, layout, monkeypatch):
    """``to_heads_qkv`` (q and k rotated, k and v repeated ``rep`` times,
    one scatter launch on the card) and its VJP against three calls of the
    JAX ``_to_heads`` custom VJP: q with RoPE, k with RoPE and the repeat,
    v with the repeat only.  The backward makes one ``gather_heads_multi``
    call (one gather launch on the card) over the gradients asked for,
    here in each ``layout`` the training path hands it, strides unchanged;
    with k frozen, over dQ and dV alone.  bf16 in both packages: 1e-2 of
    the largest entry, one bf16 step."""
    b, s, h, hd = 2, 27, 4, 64
    pos, (cos_g, sin_g) = _rope_inputs(b, s, hd, seed=10 + rep)
    rng = np.random.default_rng(10 + rep)
    widths = (h * hd, (h // rep) * hd, (h // rep) * hd)
    xs = [rng.normal(size=(b, s, w)).astype(np.float32) for w in widths]
    gs = [rng.normal(size=(b, h, s, hd)).astype(np.float32)
          for _ in range(3)]
    cos, sin = rope_frequencies(hd, 256)
    calls = []
    multi = t_heads.gather_heads_multi

    def spy(grads, *args):
        calls.append([(tuple(g.shape), g.stride()) for g in grads])
        return multi(grads, *args)

    monkeypatch.setattr(t_heads, "gather_heads_multi", spy)
    gts = [_grad_in_layout(g, layout, rng) for g in gs]
    xts = [t(x).to(torch.bfloat16).requires_grad_(True) for x in xs]
    outs = t_heads.to_heads_qkv(*xts, cos, sin, t(pos, torch.int64), h, rep)
    dxs = torch.autograd.grad(outs, xts, gts)
    assert calls == [[(tuple(g.shape), g.stride()) for g in gts]]
    for name, x, g, out, dx, rope, r in zip(
            "qkv", xs, gs, outs, dxs, (True, True, False), (1, rep, rep)):
        j_out, vjp = jax.vjp(
            lambda a: jax_attention._to_heads(a, cos_g, sin_g, h, s, rope, s,
                                              jnp.bfloat16, r),
            jnp.asarray(x, jnp.bfloat16))
        (j_dx,) = vjp(jnp.asarray(g, jnp.bfloat16))
        assert out.shape == (b, h, s, hd) and dx.shape == x.shape
        _close([out.detach().float().numpy(), dx.float().numpy()],
               [np.asarray(j_out, np.float32), np.asarray(j_dx, np.float32)],
               1e-2, f"to_heads_qkv {name} {layout}")

    xts[1] = xts[1].detach()
    outs = t_heads.to_heads_qkv(*xts, cos, sin, t(pos, torch.int64), h, rep)
    dq, dv = torch.autograd.grad(outs, [xts[0], xts[2]], gts)
    assert len(calls) == 2 and len(calls[1]) == 2
    assert torch.equal(dq, dxs[0]) and torch.equal(dv, dxs[2])


def test_flash_attention_fused_shared_matches_jax():
    """Both outputs and all six input gradients of the shared-prefix
    composite against the JAX package's (interpret mode, hd 128, its
    prefix padded to the tile), with GQA (one kv head for two query heads;
    the tiny model's tests take the composite through MHA).  The JAX composite rounds
    its head-major tensors and outputs to bf16, the port's plain path
    stays in f32, so this holds them to the JAX suite's own tolerances
    for these composites: 2e-2 on values, 5e-2 on gradients.  The left
    padding of example 1 leaves its first prefix rows with no valid key;
    the JAX kernel averages them over its padded tile, the port over the
    prefix, and nothing reads them on the training path, so they are left
    out of the values and get a zero output gradient, as there."""
    b, kk, sp, sr, h, hd, nkv = 2, 3, 40, 24, 2, 128, 1
    rng = np.random.default_rng(21)
    args = [rng.normal(0, 0.3, (n, s, (h if i % 3 == 0 else nkv) * hd))
            .astype(np.float32)
            for i, (n, s) in enumerate([(b, sp)] * 3 + [(b * kk, sr)] * 3)]
    mask_p = np.ones((b, sp), np.int32)
    mask_p[1, :6] = 0
    mask_r = np.ones((b * kk, sr), np.int32)
    mask_r[:, -4:] = 0
    pos_p = np.maximum(np.cumsum(mask_p, 1) - 1, 0).astype(np.int32)
    pos_r = (mask_p.sum(1).repeat(kk)[:, None]
             + np.cumsum(mask_r, 1) - 1).astype(np.int32)
    cos, sin = rope_frequencies(hd, 256)
    jc, js = jax_rope_frequencies(hd, 256)

    def port(*a):
        return t_attention.flash_attention_fused_shared(
            *a, cos, sin, t(pos_p, torch.int64), t(pos_r, torch.int64), h,
            t(mask_p), t(mask_r), num_kv_heads=nkv)

    def ref(*a):
        return jax_attention.flash_attention_fused_shared(
            *a, jc, js, jnp.asarray(pos_p), jnp.asarray(pos_r), h,
            jnp.asarray(mask_p), jnp.asarray(mask_r), num_kv_heads=nkv)

    seen = np.ones((b, sp, 1), np.float32)
    seen[1, :6] = 0
    vals, grads, ws = _grads_np(port, args, keep=(seen, 1.0))
    j_vals, j_grads = _jax_grads(ref, args, ws)
    for p, r, k in zip(vals, j_vals, (seen, 1.0)):
        np.testing.assert_allclose(p * k, r * k, atol=2e-2, rtol=2e-2)
    for p, r in zip(grads, j_grads):
        np.testing.assert_allclose(p, r, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("with_lora", [False, True])
def test_chunked_logprobs_matches_jax(with_lora):
    """Logprobs and entropies of a vocabulary walked in 4 chunks, the last
    one short, at temperature 0.7 with ignore-index labels, and their
    gradients to the hidden states and the head adapter: f32, 1e-5 on
    values, 1e-4 of the largest entry on gradients."""
    rng = np.random.default_rng(8)
    n, s, d, v, r = 3, 5, 16, 50, 4
    hidden = rng.normal(size=(n, s, d)).astype(np.float32)
    w = rng.normal(0, 0.3, (d, v)).astype(np.float32)
    labels = rng.integers(1, v, (n, s)).astype(np.int32)
    labels[:, -1] = 0
    a = rng.normal(0, 0.3, (d, r)).astype(np.float32)
    bb = rng.normal(0, 0.3, (r, v)).astype(np.float32)
    args = (hidden, a, bb) if with_lora else (hidden,)

    def port(hd_, *ab):
        lora = {"a": ab[0].T, "b": ab[1].T} if ab else None
        return t_logprobs.chunked_logprobs(
            hd_, t(w.T), t(labels), 0, temperature=0.7, with_entropy=True,
            head_lora=lora, lora_scaling=2.0, chunk_size=16)

    def ref(hd_, *ab):
        lora = {"a": ab[0], "b": ab[1]} if ab else None
        return jax_logprobs.chunked_logprobs(
            hd_, jnp.asarray(w), jnp.asarray(labels), 0, temperature=0.7,
            with_entropy=True, head_lora=lora, lora_scaling=2.0,
            chunk_size=16)

    vals, grads, ws = _grads_np(port, args)
    j_vals, j_grads = _jax_grads(ref, args, ws)
    _close(vals, j_vals, 1e-5, "logprobs/entropy")
    _close(grads, j_grads, 1e-4, "grads")
    assert (vals[0][:, -1] == 0).all()

    logits = rng.normal(size=(n, s, v)).astype(np.float32)
    np.testing.assert_allclose(
        t_logprobs.per_token_logprobs(t(logits), t(labels), 0).numpy(),
        np.asarray(jax_logprobs.per_token_logprobs(logits, labels, 0)),
        atol=1e-5)
    np.testing.assert_allclose(
        t_logprobs.per_token_entropy(t(logits)).numpy(),
        np.asarray(jax_logprobs.per_token_entropy(logits)), atol=1e-5)
    m = (labels != 0).astype(np.float32)
    np.testing.assert_allclose(
        t_logprobs.masked_mean(t(logits[..., 0]), t(m)).item(),
        float(jax_logprobs.masked_mean(logits[..., 0], m)), atol=1e-6)


def test_image_ops_counts_and_normalize():
    """The port's own CoPO masks, drawn from a torch generator, hit their
    exact counts: int(H*W*0.3) pixels per image (all channels) to the
    image's mean, int(blocks*0.3) 14x14 blocks, int(P*0.3) patches per
    row; normalisation equals the JAX package's to 1e-6."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(3, 56, 42, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_image_ops.normalize_images(t(images)).numpy(),
        np.asarray(jax_image_ops.normalize_images(jnp.asarray(images))),
        atol=1e-6)
    g = torch.Generator().manual_seed(0)
    out = t_image_ops.mask_images_random(g, t(images), 0.3).numpy()
    changed = (out != images)
    assert (changed.all(axis=3) == changed.any(axis=3)).all()
    assert (changed[..., 0].sum(axis=(1, 2)) == int(56 * 42 * 0.3)).all()
    means = images.mean(axis=(1, 2, 3))
    for i in range(3):
        np.testing.assert_allclose(out[i][changed[i]], means[i], rtol=1e-6)
    out = t_image_ops.mask_images_blockwise(g, t(images), 0.3).numpy()
    blocks = (out != images).reshape(3, 4, 14, 3, 14, 3).all(axis=(2, 4, 5))
    assert (blocks.sum(axis=(1, 2)) == int(12 * 0.3)).all()
    pm = t_image_ops.mask_patches_per_row(g, 4, 576, 0.3).numpy()
    assert pm.dtype == np.int32 and pm.shape == (4, 576)
    assert ((pm == 0).sum(axis=1) == int(576 * 0.3)).all()


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_optax(kind):
    """Warmup from lr 0 then decay, counts 0..12 (past the end): 1e-12
    relative to lr (optax's f32 arithmetic aside, 1e-7)."""
    cfg = dict(learning_rate=1e-3, lr_scheduler_type=kind, warmup_steps=3,
               total_steps=10)
    ref = jax_ts.make_schedule(jax_ts.OptimizerConfig(**cfg))
    mine = t_ts.make_schedule(t_ts.OptimizerConfig(**cfg))
    for n in range(13):
        np.testing.assert_allclose(mine(n), float(ref(n)), rtol=1e-6,
                                   atol=1e-10, err_msg=str(n))
    assert mine(0) == 0.0


def test_adamw_multisteps_update_matches_optax():
    """Clipped AdamW with weight decay (masked off the norm and bias
    leaves) inside MultiSteps over 2 micro-steps, three updates, against
    optax in f32: the first micro-step leaves the parameters as they were,
    and after each applied update they agree to 3e-7 (one f32 step at the
    parameters' magnitude of up to 2.5)."""
    cfg = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10,
               weight_decay=0.1, max_grad_norm=1.0, grad_accum_steps=2)
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(4, 3)), "norm_scale": rng.normal(size=3),
              "bias": rng.normal(size=3), "v": rng.normal(size=(2, 5))}
    params = {k: x.astype(np.float32) for k, x in params.items()}
    tx = jax_ts.make_optimizer(jax_ts.OptimizerConfig(**cfg))
    j_params = {k: jnp.asarray(x) for k, x in params.items()}
    j_opt = tx.init(j_params)
    opt = t_ts.AdamW(t_ts.OptimizerConfig(**cfg))
    state = t_ts.TrainState.create({k: t(x) for k, x in params.items()},
                                   opt.cfg)
    names = [name for name, _ in t_ts.named_leaves(state.params)]
    for step in range(6):
        grads = {k: (rng.normal(size=x.shape) * 3).astype(np.float32)
                 for k, x in params.items()}
        upd, j_opt = tx.update({k: jnp.asarray(x) for k, x in grads.items()},
                               j_opt, j_params)
        j_params = optax.apply_updates(j_params, upd)
        state = opt.apply_gradients(
            state, [t(grads[n.lstrip("/")]) for n in names])
        for k, x in state.params.items():
            np.testing.assert_allclose(x.numpy(), np.asarray(j_params[k]),
                                       atol=3e-7, rtol=0, err_msg=f"{k} {step}")
        if step == 0:
            np.testing.assert_array_equal(state.params["w"].numpy(),
                                          params["w"])
    assert state.count == 3 and state.step == 6
