"""The cluster split of the decode kernels #7 and #8
(``ops/decode_attention.decode_split``) against brute force, and a model
of their cluster merge against the plain versions, on the CPU.

The kernels split each (b, h)'s prefix over the ranks of a cluster, take
the global max from the ranks' maxima, and sum each rank's l and value
products at that max, then the ranks in order.  The model does the same
in PyTorch; it differs from one pass over the prefix only in the f32
order of the value sums and of l."""

import numpy as np
import pytest
import torch

from opadpo_torch.ops import decode_attention as da


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bh", [1, 8, 256])
def test_decode_split_owns_every_position_once(packed, bh):
    """Every admitted s_used up to 4096: at most 8 ranks, each owning a
    non-empty run of whole chunks (128 positions, or 256-position packed
    groups), and every position owned by exactly one rank."""
    unit = 256 if packed else 128
    for s_used in range(unit, 4097, unit):
        n, per = da.decode_split(s_used, bh, packed)
        assert 1 <= n <= da.MAX_RANKS
        assert per % unit == 0 and per <= da.MAX_SLICE
        owners = np.zeros(s_used, np.int64)
        for r in range(n):
            lo, hi = r * per, min(s_used, (r + 1) * per)
            assert lo < hi and (hi - lo) % unit == 0, (s_used, r)
            owners[lo:hi] += 1
        assert (owners == 1).all(), s_used


@pytest.mark.parametrize("s_used,ranks", [(128, 1), (256, 2), (384, 3),
                                          (512, 4), (640, 3), (768, 3)])
def test_int8_one_query_split_at_the_serving_batch(s_used, ranks):
    """#6 (the int8 cache, one query) at B * H 256, the 7B serving batch:
    3 ranks at s_used 640 and 768 (the split timed fastest), every
    position owned once, and the launch within the CTAs an H100 holds at
    once at 8 an SM (132 x 8), so it runs as one wave; #8 at G 2 keeps
    ``TARGET_CTAS``'s 2 ranks at 768."""
    n, per = da.decode_split(s_used, 256, False, 1)
    assert n == ranks and n * 256 <= 132 * 8
    assert (n - 1) * per < s_used <= n * per and per % da.ALIGN == 0
    assert da.decode_split(768, 256, False, 2) == (2, 384)


def test_decode_split_refuses_what_the_kernels_do_not_take():
    """s_used past 8 slices of ``MAX_SLICE`` positions, or not a positive
    multiple of the chunk, raises."""
    for packed, unit in ((False, 128), (True, 256)):
        top = da.MAX_RANKS * da.MAX_SLICE
        assert da.decode_split(top, 8, packed) == (8, da.MAX_SLICE)
        for bad in (top + unit, 0, unit + unit // 2):
            with pytest.raises(ValueError):
                da.decode_split(bad, 8, packed)


def _cluster_model(q, k, ks, v, vs, bias, sm, su, packed):
    """The kernels' arithmetic over int8 codes k, v [B, H, S, hd]: scores a
    rank's slice at a time, the global max from the ranks' maxima, then
    each rank's l and bf16(p * v_scale) . V at that max, summed in rank
    order."""
    b, h, gq = q.shape[:3]
    n, per = da.decode_split(su, b * h, packed, gq)
    qf = q.to(torch.bfloat16).float()
    cuts = [(r * per, min(su, (r + 1) * per)) for r in range(n)]
    scores = [da._dots(qf, k[:, :, lo:hi])
              * (ks[:, :, None, lo:hi] * sm) + bias[:, None, None, lo:hi]
              for lo, hi in cuts]
    m = torch.stack([s.amax(-1) for s in scores]).amax(0).clamp(
        min=da.NEG_INF)
    out, l = 0.0, 0.0
    for (lo, hi), s in zip(cuts, scores):
        p = torch.exp(s - m[..., None])
        pw = (p * vs[:, :, None, lo:hi]).to(torch.bfloat16).float()
        out = out + torch.einsum("bhgs,bhsd->bhgd", pw,
                                 v[:, :, lo:hi].float())
        l = l + p.sum(-1)
    return n, (out, m, l)


def _inputs(rng, b, h, gq, sp, hd, filled, packed):
    """q [B, H, G, hd], the cache (packed int4 pairs or int8), scales zero
    past ``filled``, a bias that left-pads row 0 and masks row 1
    everywhere and every row past ``filled``."""
    q = torch.from_numpy(rng.standard_normal((b, h, gq, hd)).astype(
        np.float32))
    lo = -128 if packed else -127
    k, v = (torch.from_numpy(rng.integers(
        lo, 128, (b, h, sp // 2 if packed else sp, hd)).astype(np.int8))
        for _ in range(2))
    ks, vs = (torch.from_numpy(rng.random((b, h, sp)).astype(np.float32)
                               * 0.02) for _ in range(2))
    ks[:, :, filled:] = 0.0
    vs[:, :, filled:] = 0.0
    bias = torch.zeros(b, sp)
    bias[0, :37] = da.NEG_INF
    bias[1] = da.NEG_INF
    bias[:, filled:] = da.NEG_INF
    return q, k, ks, v, vs, bias


@pytest.mark.parametrize("gq,su,bh", [(1, 768, 8), (5, 768, 8),
                                      (8, 640, 8), (8, 2304, 8),
                                      (5, 768, 256), (1, 640, 256),
                                      (1, 768, 256)])
def test_cluster_merge_model_matches_multi_plain(gq, su, bh):
    """The int8 kernel's merge, G 1, 5 and 8, over 1 to 8 ranks (2304
    streams its slices through the ring; G 1 at B * H 256 is #6's serving
    split), against the plain version: (out, m, l) within 1e-6 of each
    one's largest entry; row 1 is masked everywhere (m -1e30, p
    uniform)."""
    rng = np.random.default_rng(gq * 1000 + su)
    hd = 64
    b, h = 2, bh // 2
    q, k, ks, v, vs, bias = _inputs(rng, b, h, gq, su, hd, su - 50, False)
    sm = hd ** -0.5
    n, got = _cluster_model(q, k, ks, v, vs, bias, sm, su, False)
    assert n > 1
    ref = da.decode_attention_prompt_multi_plain(q, k, ks, v, vs, bias, sm,
                                                 su)
    for name, o, r in zip(("out", "m", "l"), got, ref):
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-6 * r.abs().max().item(),
                                   msg=name)
    assert (got[1][1] == da.NEG_INF).all() and (got[2][1] == su).all()


@pytest.mark.parametrize("su,bh,ranks", [(768, 8, 3), (1536, 8, 6),
                                         (1536, 256, 2)])
def test_cluster_merge_model_matches_int4_plain(su, bh, ranks):
    """#7's merge over whole 256-position packed groups (one group a rank,
    or three at B * H 256), against the plain version over the packed
    cache, within 1e-6 of each one's largest entry."""
    rng = np.random.default_rng(su + bh)
    b, h, hd = 2, bh // 2, 64
    q, p4k, ks, p4v, vs, bias = _inputs(rng, b, h, 1, su, hd, su - 50, True)
    sm = hd ** -0.5
    k, v = da.unpack_int4_kv(p4k), da.unpack_int4_kv(p4v)
    n, got = _cluster_model(q, k, ks, v, vs, bias, sm, su, True)
    assert n == ranks
    ref = da.decode_attention_prompt4_plain(q[:, :, 0], p4k, ks, p4v, vs,
                                            bias, sm, su)
    for name, o, r in zip(("out", "m", "l"), got, ref):
        o = o[:, :, 0]
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-6 * r.abs().max().item(),
                                   msg=name)
