"""The CUDA kernels against their plain versions, on a GPU only.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with the GPU and no JAX (without the repository's conftest, which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a GPU each test skips.
"""

import pytest
import torch

from opadpo_torch.ops import attention as t_attention
from opadpo_torch.ops import decode_attention as t_decode
from opadpo_torch.ops import heads_layout as t_heads
from opadpo_torch.ops import quant as t_quant
from opadpo_torch.ops.rope import rope_frequencies


def _gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """On the card: the flash forward kernel and the int8 decode kernel
    against their plain versions, bf16, at small shapes."""
    g = _gen()
    dev = "cuda"
    for causal, d, s in ((True, 128, 203), (False, 64, 77), (True, 32, 33)):
        q, k, v = (torch.randn(2, s, 4, d, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        mask = torch.ones(2, s, dtype=torch.int32, device=dev)
        mask[1, :50] = 0
        o, lse = t_attention.flash_fwd_cuda(q, k, v, mask, causal)
        o_ref, lse_ref = t_attention.mha_reference_lse(q, k, v, mask, causal)
        assert (o.float() - o_ref.float()).abs().max().item() < 2e-2
        assert (lse - lse_ref).abs().max().item() < 1e-3
    b, h, sp, hd = 2, 4, 256, 128
    qd = torch.randn(b, h, hd, generator=g, device=dev).to(torch.bfloat16)
    pk, pv = (torch.randint(-127, 128, (b, h, sp, hd), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, h, sp, generator=g, device=dev) * 0.02
              for _ in range(2))
    bias = torch.zeros(b, sp, device=dev)
    bias[1, :30] = -1e30
    for su in (256, 128):
        out = t_decode.decode_attention_cuda(qd, pk, ks, pv, vs, bias,
                                             hd ** -0.5, s_used=su)
        ref = t_decode.decode_attention_prompt_plain(qd, pk, ks, pv, vs,
                                                     bias, hd ** -0.5, su)
        for o, r in zip(out, ref):
            assert torch.allclose(o, r, rtol=1e-4,
                                  atol=1e-4 * r.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [128, 64])
def test_int4_and_multi_decode_kernels_match_plain_on_gpu(hd):
    """The int4 decode kernel (#7) at s_used 512 and 256, and the
    multi-query kernel (#8) at G 2, 5 and 8, s_used 384 and 512, against
    their plain versions: (out, m, l) within 1e-4 of each one's largest
    entry, as for #6."""
    g = _gen()
    dev = "cuda"
    b, h, sp = 2, 4, 512
    bias = torch.zeros(b, sp, device=dev)
    bias[1, :30] = -1e30
    bias[:, 450:] = -1e30
    ks, vs = (torch.rand(b, h, sp, generator=g, device=dev) * 0.02
              for _ in range(2))
    p4k, p4v = (torch.randint(-128, 128, (b, h, sp // 2, hd), generator=g,
                              device=dev, dtype=torch.int8) for _ in range(2))
    pk, pv = (torch.randint(-127, 128, (b, h, sp, hd), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    q = torch.randn(b, h, 8, hd, generator=g, device=dev).to(torch.bfloat16)
    cases = []
    for su in (512, 256):
        cases.append((t_decode.decode_attention4_cuda(
            q[:, :, 0], p4k, ks, p4v, vs, bias, hd ** -0.5, su),
            t_decode.decode_attention_prompt4_plain(
                q[:, :, 0], p4k, ks, p4v, vs, bias, hd ** -0.5, su)))
    for gq, su in ((2, 384), (5, 512), (8, 512)):
        qg = q[:, :, :gq]
        cases.append((t_decode.decode_attention_multi_cuda(
            qg, pk, ks, pv, vs, bias, hd ** -0.5, su),
            t_decode.decode_attention_prompt_multi_plain(
                qg, pk, ks, pv, vs, bias, hd ** -0.5, su)))
    for out, ref in cases:
        for o, r in zip(out, ref):
            assert o.shape == r.shape
            assert torch.allclose(o, r, rtol=1e-4,
                                  atol=1e-4 * r.abs().max().item())
    with pytest.raises(ValueError, match="queries per head"):
        t_decode.decode_attention_multi_cuda(
            torch.zeros(b, h, 9, hd, device=dev), pk, ks, pv, vs, bias, 1.0)


def _cluster_cache(g, sp, hd, packed, b=2, h=4):
    """A cache of ``sp`` positions (packed int4 pairs or int8 codes) with
    scales, zero in the last 100 positions, and a bias that left-pads row
    0, masks row 1 everywhere and every row's last 100 positions."""
    dev = "cuda"
    lo = -128 if packed else -127
    pk, pv = (torch.randint(lo, 128, (b, h, sp // 2 if packed else sp, hd),
                            generator=g, device=dev, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand(b, h, sp, generator=g, device=dev) * 0.02
              for _ in range(2))
    ks[:, :, sp - 100:] = 0.0
    vs[:, :, sp - 100:] = 0.0
    bias = torch.zeros(b, sp, device=dev)
    bias[0, :37] = -1e30
    bias[1] = -1e30
    bias[:, sp - 100:] = -1e30
    return pk, ks, pv, vs, bias


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [128, 64])
def test_cluster_decode_kernels_match_plain_on_gpu(hd):
    """The cluster kernels: #7 at every multiple of 256 up to 1536 and at
    4608 (6 ranks of 3 groups, each warp streaming 6 pieces through its
    ring slot), #8 at G 1 ... 8 and s_used 128 ... 768 and at G 5, s_used
    2304 (likewise streamed), with row 1 masked everywhere and zero scales
    in the tail: (out, m, l) within 1e-4 of each one's largest entry of the
    plain version, as above, and two launches bitwise equal."""
    g = _gen()
    q = torch.randn(2, 4, 8, hd, generator=g, device="cuda").to(
        torch.bfloat16)
    sm = hd ** -0.5
    cases = []
    for sp, sus in ((1536, range(256, 1537, 256)), (4608, (4608,))):
        cache = _cluster_cache(g, sp, hd, True)
        for su in sus:
            cases.append((t_decode.decode_attention4_cuda,
                          t_decode.decode_attention_prompt4_plain,
                          (q[:, :, 0].contiguous(), *cache, sm, su)))
    cache = _cluster_cache(g, 768, hd, False)
    for gq in range(1, 9):
        for su in range(128, 769, 128):
            cases.append((t_decode.decode_attention_multi_cuda,
                          t_decode.decode_attention_prompt_multi_plain,
                          (q[:, :, :gq].contiguous(), *cache, sm, su)))
    cache = _cluster_cache(g, 2304, hd, False)
    cases.append((t_decode.decode_attention_multi_cuda,
                  t_decode.decode_attention_prompt_multi_plain,
                  (q[:, :, :5].contiguous(), *cache, sm, 2304)))
    for kernel, plain, args in cases:
        out, again, ref = kernel(*args), kernel(*args), plain(*args)
        assert all(torch.equal(a, c) for a, c in zip(out, again))
        for o, r in zip(out, ref):
            assert o.shape == r.shape
            assert torch.allclose(o, r, rtol=1e-4,
                                  atol=1e-4 * r.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [128, 64])
def test_int8_decode_on_the_cluster_matches_plain_on_gpu(hd):
    """#6 on the cluster body (``decode_attention_cuda``, one query, the
    split of ``decode_split``) at s_used 128 ... 768 and 2304 (streamed
    through the ring), with row 1 masked everywhere and zero scales in
    the tail: (out, m, l) within 1e-4 of each one's largest entry of the
    plain version, and two launches bitwise equal."""
    g = _gen()
    q = torch.randn(2, 4, hd, generator=g, device="cuda").to(torch.bfloat16)
    sm = hd ** -0.5
    cases = [(_cluster_cache(g, 768, hd, False), su)
             for su in range(128, 769, 128)]
    cases.append((_cluster_cache(g, 2304, hd, False), 2304))
    for cache, su in cases:
        args = (q, *cache, sm, su)
        out = t_decode.decode_attention_cuda(*args)
        again = t_decode.decode_attention_cuda(*args)
        ref = t_decode.decode_attention_prompt_plain(*args)
        assert all(torch.equal(a, c) for a, c in zip(out, again)), su
        for o, r in zip(out, ref):
            assert o.shape == r.shape
            assert torch.allclose(o, r, rtol=1e-4,
                                  atol=1e-4 * r.abs().max().item()), su


def _flash_inputs(g, sq, skv, d, head_major):
    """q [3, sq, 2, d] over k, v [3, skv, 2, d], bf16; head-major tensors
    are passed as the permuted [B, S, H, D] view ``_kernel_view`` gives.
    Keys: row 0 loses a block in the middle (CoPO-style), row 1 is
    left-padded by 50, row 2 is masked everywhere."""
    def make(s):
        if head_major:
            return torch.randn(3, 2, s, d, generator=g, device="cuda",
                               dtype=torch.bfloat16).permute(0, 2, 1, 3)
        return torch.randn(3, s, 2, d, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    q, k, v = make(sq), make(skv), make(skv)
    mask = torch.ones(3, skv, dtype=torch.int32, device="cuda")
    mask[0, skv // 3: skv // 3 + skv // 4 + 1] = 0
    mask[1, :min(50, skv - 1)] = 0
    mask[2] = 0
    return q, k, v, mask


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,skv", [(1, 1), (1, 129), (65, 65), (129, 129),
                                    (129, 300), (703, 703), (896, 1599)])
def test_flash_fwd_shapes_match_plain_on_gpu(d, sq, skv):
    """The TMA/wgmma forward at head widths 32, 64 and 128, lengths around
    its 128-row tiles, the response stream's 896 over 1599 keys, causal
    (offset Skv - Sq) and bidirectional, contiguous and head-major views,
    with middle-masked keys, left padding and a fully masked row: o within
    2e-2 and lse within 1e-3 of the plain version, as above, and each
    (b, q, h) row of o within 2e-2 of that row's largest |o_ref| (bf16
    rounding of o on both sides is about 7.8e-3 of it, and the H100's
    readings were at most 9.05e-3; a fault in P V moves entries by their
    own size, which the absolute bound misses on rows that average over
    many keys)."""
    g = _gen()
    for head_major in (False, True):
        q, k, v, mask = _flash_inputs(g, sq, skv, d, head_major)
        for causal in (True, False):
            o, lse = t_attention.flash_fwd_cuda(q, k, v, mask, causal)
            o_ref, lse_ref = t_attention.mha_reference_lse(q, k, v, mask,
                                                           causal)
            assert o.shape == o_ref.shape and lse.shape == lse_ref.shape
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            ref = o_ref.float()
            err_row = ((o.float() - ref).abs().amax(-1)
                       / ref.abs().amax(-1).clamp_min(1e-30)).max().item()
            print(f"flash d {d} sq {sq} skv {skv} head_major {head_major} "
                  f"causal {causal}: o {err_o:.3e} row {err_row:.3e} "
                  f"lse {err_lse:.3e}")
            assert err_o < 2e-2, (head_major, causal, err_o)
            assert err_row < 2e-2, (head_major, causal, err_row)
            assert err_lse < 1e-3, (head_major, causal, err_lse)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,d,sq,skv", [
    (True, 128, 203, 203), (False, 64, 77, 77), (True, 128, 96, 250),
    (True, 64, 130, 130), (True, 64, 65, 65),
    (True, 128, 129, 300)])
def test_flash_rect_and_backward_match_plain_on_gpu(causal, d, sq, skv):
    """The forward at Sq < Skv (offset Skv - Sq) and both backward kernels
    against the plain backward, bf16, with left padding and one fully
    masked row (its dO nonzero too).  Tolerances: o 2e-2 and lse 1e-3 as
    above; gradients 3e-2 relative to their largest entry (bf16 inputs and
    outputs, and dS rounded to bf16 before its products in both)."""
    g = _gen()
    dev = "cuda"
    q, do = (torch.randn(3, sq, 4, d, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(3, skv, 4, d, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = torch.ones(3, skv, dtype=torch.int32, device=dev)
    mask[1, :50] = 0
    mask[2] = 0
    scale = d ** -0.5
    o, lse = t_attention.flash_fwd_cuda(q, k, v, mask, causal, scale)
    o_ref, lse_ref = t_attention.mha_reference_lse(q, k, v, mask, causal,
                                                   scale)
    assert (o.float() - o_ref.float()).abs().max().item() < 2e-2
    assert (lse - lse_ref).abs().max().item() < 1e-3
    got = t_attention.flash_bwd_cuda(q, k, v, mask, causal, scale, o, lse, do)
    ref = t_attention.flash_bwd_reference(q, k, v, mask, causal, scale, o,
                                          lse, do)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a.float()).all(), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= 3e-2 * max(r.float().abs().max().item(), 1.0), \
            (name, err)


# the backward's outputs per row (dq per query row, dk and dv per key row,
# each [.., D]) against that row's largest |ref|; a row whose largest entry
# is under ROW_FLOOR of the tensor's (a query that sees one key has dq ~ 0:
# its dS is dP - delta, which cancels) is held against ROW_FLOOR of it.
# The limit is 2.6 times the largest H100 reading (7.75e-3, about one bf16
# unit in the last place; chip_smoke.BWD_ROW_TOL, PERF.md)
ROW_FLOOR = 1e-2
BWD_ROW_TOL = 2e-2


def _bwd_row_err(a, ref):
    r = ref.float()
    den = r.abs().amax(-1).clamp_min(ROW_FLOOR * r.abs().max().item())
    den = den.clamp_min(1e-30)
    return ((a.float() - r).abs().amax(-1) / den).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(63, 63), (64, 64), (65, 65),
                                    (127, 127), (129, 129), (64, 129),
                                    (127, 300), (703, 703), (896, 1599)])
def test_flash_bwd_shapes_match_plain_on_gpu(d, sq, skv):
    """The TMA/wgmma dQ and dK/dV kernels at head widths 64 and 128,
    lengths around their 64- and 128-row tiles and the DPO shapes, causal
    (offset Skv - Sq) and bidirectional, contiguous and head-major views,
    keys with a middle block masked, left padding and a batch row masked
    everywhere (its dO nonzero): each of dq, dk, dv within 2e-2 of its
    largest |ref| (as ``chip_smoke._bwd_case``), each row within
    ``BWD_ROW_TOL`` of its own largest |ref| (``_bwd_row_err``), and a
    second launch bitwise equal to the first (no atomics: each output is
    summed by one CTA in a fixed order)."""
    g = _gen()
    scale = d ** -0.5
    for head_major in (False, True):
        q, k, v, mask = _flash_inputs(g, sq, skv, d, head_major)
        do = torch.randn(q.shape, generator=g, device="cuda",
                         dtype=torch.bfloat16)
        for causal in (True, False):
            o, lse = t_attention.flash_fwd_cuda(q, k, v, mask, causal, scale)
            got = t_attention.flash_bwd_cuda(q, k, v, mask, causal, scale, o,
                                             lse, do)
            again = t_attention.flash_bwd_cuda(q, k, v, mask, causal, scale,
                                               o, lse, do)
            ref = t_attention.flash_bwd_reference(q, k, v, mask, causal,
                                                  scale, o, lse, do)
            line = []
            for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
                assert a.shape == r.shape and torch.isfinite(a.float()).all()
                assert torch.equal(a, a2), (name, "not deterministic")
                top = r.float().abs().max().item()
                err = (a.float() - r.float()).abs().max().item()
                row = _bwd_row_err(a, r)
                line.append(f"{name} {err / max(top, 1e-30):.3e} row "
                            f"{row:.3e}")
                assert err <= 2e-2 * top, (name, head_major, causal, err, top)
                assert row <= BWD_ROW_TOL, (name, head_major, causal, row)
            print(f"flash bwd d {d} sq {sq} skv {skv} head_major "
                  f"{head_major} causal {causal}: " + ", ".join(line))


@pytest.mark.gpu
@pytest.mark.parametrize("rep,hd", [(1, 128), (2, 64)])
def test_heads_layout_match_plain_on_gpu(rep, hd):
    """scatter_heads (RoPE and plain, GQA repeat) and gather_heads (inverse
    RoPE, group sum, strided input) against their plain versions: equal to
    one bf16 rounding of the f32 result."""
    g = _gen()
    dev = "cuda"
    b, s, h = 2, 75, 4
    cos, sin = rope_frequencies(hd, 256, device=dev)
    pos = torch.randint(0, 256, (b, s), generator=g, device=dev)
    x = torch.randn(b, s, (h // rep) * hd, generator=g, device=dev,
                    dtype=torch.bfloat16)
    for rope in (True, False):
        out = t_heads.scatter_heads_cuda(x, cos, sin, pos, h, rope, rep)
        ref = t_heads.scatter_heads_plain(x, cos, sin, pos, h, rope, rep)
        assert out.shape == (b, h, s, hd)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    gr = torch.randn(b, s, h, hd, generator=g, device=dev,
                     dtype=torch.bfloat16).permute(0, 2, 1, 3)
    for rope in (True, False):
        out = t_heads.gather_heads_cuda(gr, cos, sin, pos, rope, rep)
        ref = t_heads.gather_heads_plain(gr, cos, sin, pos, rope, rep)
        assert out.shape == (b, s, (h // rep) * hd)
        assert (out.float() - ref.float()).abs().max().item() <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("s", [27, 703])
@pytest.mark.parametrize("rep,hd", [(1, 128), (2, 128), (1, 64), (2, 64)])
def test_scatter_heads_qkv_matches_plain_on_gpu(rep, hd, s):
    """q, k and v in one scatter launch (``scatter_heads_multi_cuda``: q
    and k rotated, k and v repeated ``rep`` times), each a strided view of
    one wider buffer, against three calls of the plain version: within one
    bf16 rounding of the f32 result (1e-2 of the largest entry); the tail
    block writes nothing past S (the output is checked in full)."""
    g = _gen()
    dev = "cuda"
    b, h = 2, 8
    cos, sin = rope_frequencies(hd, 1024, device=dev)
    pos = torch.randint(0, 1024, (b, s), generator=g, device=dev)
    widths = (h * hd, (h // rep) * hd, (h // rep) * hd)
    buf = torch.randn(b, s, sum(widths) + 8, generator=g, device=dev,
                      dtype=torch.bfloat16)
    xs, at = [], 8
    for w in widths:
        xs.append(buf[:, :, at:at + w])
        at += w
    before = t_heads.scatter_heads_cuda.launches
    outs = t_heads.scatter_heads_multi_cuda(xs, cos, sin, pos, h,
                                            (True, True, False),
                                            (1, rep, rep))
    assert t_heads.scatter_heads_cuda.launches == before + 1
    for x, out, rope, r in zip(xs, outs, (True, True, False), (1, rep, rep)):
        ref = t_heads.scatter_heads_plain(x, cos, sin, pos, h, rope, r)
        assert out.shape == (b, h, s, hd) and out.is_contiguous()
        top = ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * top


def _grads_on_gpu(b, h, s, hd, layout, g, offset=24):
    """A bf16 gradient, logically ``[B, H, S, hd]``, laid out as the
    training path hands it to the gather: ``bshd`` the permuted view of
    the flash backward's ``[B, S, H, hd]``, ``slice`` that view of a
    longer ``[B, offset + S, H, hd]`` at ``offset`` along S (the response
    stream's dK / dV), ``bhsd`` contiguous."""
    if layout == "bhsd":
        return torch.randn(b, h, s, hd, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    full = torch.randn(b, s + (offset if layout == "slice" else 0), h, hd,
                       generator=g, device="cuda", dtype=torch.bfloat16)
    return full.permute(0, 2, 1, 3)[:, :, full.shape[1] - s:]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [27, 703])
@pytest.mark.parametrize("rep,hd", [(1, 128), (2, 128), (1, 64), (2, 64)])
def test_gather_heads_qkv_matches_plain_on_gpu(rep, hd, s):
    """dQ, dK and dV in one gather launch (``gather_heads_multi_cuda``: dQ
    and dK rotated back, dK and dV summed over groups of ``rep`` heads),
    in each of the three layouts the training path hands it, against
    three calls of the plain version: within one bf16 rounding of the f32
    result (1e-2 of the largest entry); two launches bitwise equal; one
    launch counted per call; the tail block writes nothing past S (the
    output is checked in full)."""
    g = _gen()
    dev = "cuda"
    b, h = 2, 8
    cos, sin = rope_frequencies(hd, 1024, device=dev)
    pos = torch.randint(0, 1024, (b, s), generator=g, device=dev)
    ropes, groups = (True, True, False), (1, rep, rep)
    for layout in ("bshd", "slice", "bhsd"):
        gs = [_grads_on_gpu(b, h, s, hd, layout, g) for _ in range(3)]
        before = t_heads.gather_heads_cuda.launches
        outs = t_heads.gather_heads_multi_cuda(gs, cos, sin, pos, ropes,
                                               groups)
        again = t_heads.gather_heads_multi_cuda(gs, cos, sin, pos, ropes,
                                                groups)
        assert t_heads.gather_heads_cuda.launches == before + 2
        for gr, out, twice, rope, r in zip(gs, outs, again, ropes, groups):
            ref = t_heads.gather_heads_plain(gr, cos, sin, pos, rope, r)
            assert out.shape == (b, s, (h // r) * hd) and out.is_contiguous()
            assert torch.equal(out, twice), layout
            top = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= 1e-2 * top, (layout, rope, r, err, top)


@pytest.mark.gpu
def test_gather_heads_refuses_what_it_cannot_take_on_gpu():
    """A gradient whose base is not 16-byte aligned, or whose row stride is
    not a multiple of 8 elements, raises before any launch (no fallback),
    as does a head dim without a kernel instance."""
    g = _gen()
    cos, sin = rope_frequencies(128, 256, device="cuda")
    pos = torch.zeros(2, 32, dtype=torch.int64, device="cuda")
    flat = torch.randn(2 * 4 * 32 * 128 + 8, generator=g, device="cuda",
                       dtype=torch.bfloat16)
    before = t_heads.gather_heads_cuda.launches
    misaligned = flat[4:4 + 2 * 4 * 32 * 128].view(2, 4, 32, 128)
    with pytest.raises(ValueError, match="aligned"):
        t_heads.gather_heads_multi_cuda([misaligned], cos, sin, pos, [True],
                                        [1])
    wide = torch.randn(2, 4, 32, 132, generator=g, device="cuda",
                       dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="strides"):
        t_heads.gather_heads_multi_cuda([wide], cos, sin, pos, [True], [1])
    with pytest.raises(ValueError, match="head dim"):
        t_heads.gather_heads_cuda(torch.zeros(2, 4, 32, 32, device="cuda",
                                              dtype=torch.bfloat16),
                                  None, None, None, False)
    assert t_heads.gather_heads_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(1, 200, 256), (8, 4096, 4096),
                                   (37, 300, 384), (577, 1024, 1024),
                                   (20, 100, 72)])
def test_quant_kernels_match_plain_on_gpu(m, n, k):
    """The int8 matmul (#9, bf16 and f32 output), its transpose (#10) and
    the int4 matmul (#11, K a multiple of 128) against their plain
    versions: f32 output within 1e-5 of the largest entry (the same exact
    products summed in another order, split-K included), bf16 output within
    one bf16 step (2^-7) of it."""
    g = _gen()
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    gr = torch.randn(m, n, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(n, k, generator=g, device="cuda") * 0.02
    q, s = t_quant.quantize_weight(w)
    cases = [(t_quant.quant_matmul_cuda(x, q, s, od),
              t_quant.quant_matmul_plain(x, q, s, od))
             for od in (torch.bfloat16, torch.float32)]
    cases.append((t_quant.quant_matmul_t_cuda(gr, q, s),
                  t_quant.quant_matmul_t_plain(gr, q, s)))
    if k % 128 == 0:
        q4, s4 = t_quant.quantize_weight_int4(w)
        cases += [(t_quant.quant_matmul4_cuda(x, q4, s4, od),
                   t_quant.quant_matmul4_plain(x, q4, s4, od))
                  for od in (torch.bfloat16, torch.float32)]
    for out, ref in cases:
        assert out.dtype == ref.dtype and out.shape == ref.shape
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        tol = 1e-5 if out.dtype == torch.float32 else 2.0 ** -7
        assert err <= tol * top, (out.dtype, err, top)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 64, 65, 128, 129, 577, 703,
                               1024])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (1024, 1024),
                                 (128, 352)])
def test_int8_kernels_tile_edges_on_gpu(m, k, n):
    """#9 and #10 on the TMA/wgmma kernels (int8_matmul.cu) at the tile
    edges of M and at path widths: against their plain versions (f32
    within 1e-5 of the largest entry, bf16 within one bf16 step), two
    launches bitwise equal, each call counted on the variant
    ``q8_variant`` / ``q8t_variant`` names (never the odd-shape one)."""
    g = _gen()
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    gr = torch.randn(m, n, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(n, k, generator=g, device="cuda") * 0.02
    q, s = t_quant.quantize_weight(w)
    counts = t_quant.variant_launches
    before = {v: c.launches for v, c in counts.items()}
    runs = [(lambda od=od: t_quant.quant_matmul_cuda(x, q, s, od),
             t_quant.quant_matmul_plain(x, q, s, od))
            for od in (torch.bfloat16, torch.float32)]
    runs.append((lambda: t_quant.quant_matmul_t_cuda(gr, q, s),
                 t_quant.quant_matmul_t_plain(gr, q, s)))
    for kernel, ref in runs:
        out, again = kernel(), kernel()
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out, again)
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        tol = 1e-5 if out.dtype == torch.float32 else 2.0 ** -7
        assert err <= tol * top, (out.dtype, err, top)
    got = {v: c.launches - before[v] for v, c in counts.items()}
    want = dict.fromkeys(counts, 0)
    want["q8_" + t_quant.q8_variant(m, n, k)] += 4
    want["q8t_" + t_quant.q8t_variant(m, n, k)] += 2
    assert got == want and not got["q8_odd"] and not got["q8t_odd"]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 64, 65, 128, 129, 577, 703,
                               1024])
@pytest.mark.parametrize("k,n", [(5120, 5120), (5120, 13824), (13824, 5120),
                                 (1024, 1024), (384, 300)])
def test_int4_kernel_tile_edges_on_gpu(m, k, n):
    """#11 on the TMA/wgmma kernels (int4_matmul.cu) at the tile edges of
    M and at the 13B, CLIP and a ragged width: against its plain version
    (f32 within 1e-5 of the largest entry, bf16 within one bf16 step), two
    launches bitwise equal, each call counted on the variant
    ``q4_variant`` names."""
    g = _gen()
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(n, k, generator=g, device="cuda") * 0.02
    q4, s = t_quant.quantize_weight_int4(w)
    counts = t_quant.variant_launches
    before = {v: c.launches for v, c in counts.items()}
    for od in (torch.bfloat16, torch.float32):
        ref = t_quant.quant_matmul4_plain(x, q4, s, od)
        out = t_quant.quant_matmul4_cuda(x, q4, s, od)
        again = t_quant.quant_matmul4_cuda(x, q4, s, od)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out, again)
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        tol = 1e-5 if od == torch.float32 else 2.0 ** -7
        assert err <= tol * top, (od, err, top)
    got = {v: c.launches - before[v] for v, c in counts.items()}
    want = dict.fromkeys(counts, 0)
    want["q4_" + t_quant.q4_variant(m, n, k)] += 4
    assert got == want


@pytest.mark.gpu
def test_quantizers_give_the_cpu_codes_on_gpu():
    """Weight codes and scales (int8 and int4) and the int8 and int4
    prompt-KV caches made on the GPU equal the CPU's bit for bit (the CPU's
    equal the JAX package's): a division by a Python number would run as a
    product by its reciprocal on the GPU and move some codes."""
    from opadpo_torch.models import llama as t_llama

    _gen()                                   # skips without a GPU
    g = torch.Generator().manual_seed(3)     # the inputs are made on the CPU
    w = (torch.randn(512, 256, generator=g) * 0.02).to(torch.bfloat16)
    kv = torch.randn(2, 300, 4, 64, generator=g).to(torch.bfloat16)
    for fn in (t_quant.quantize_weight, t_quant.quantize_weight_int4):
        for c, gpu in zip(fn(w), fn(w.cuda())):
            assert torch.equal(c, gpu.cpu()), fn.__name__
    for fn, keys in ((t_llama.quantize_prompt_kv, ("q", "scale")),
                     (t_llama.quantize_prompt_kv_int4, ("q4", "scale"))):
        c, gpu = fn(kv, 512), fn(kv.cuda(), 512)
        for key in keys:
            assert torch.equal(c[key], gpu[key].cpu()), (fn.__name__, key)
