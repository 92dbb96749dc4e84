"""The flash backward kernels' walks and arithmetic, on the CPU.  The
kernels (``opadpo_torch/csrc/flash_bwd.cu``: dQ, and dK/dV) run only on the
GPU (``tests/test_torch_gpu.py``); what they decide before and inside their
loops is held here against brute force, against the plain backward
``flash_bwd_reference`` and against the JAX package's Pallas ``_flash_bwd``
(interpret mode):

- ``blind_rows``, the leading query rows of each batch row that see no
  valid key, from which every walk follows;
- the dQ kernel's key-tile counts (``kv_tile_count`` at 128 query rows x
  64 keys) and the dK/dV kernel's query-tile walks (``q_tile_walk``: 128
  keys x 64 query rows, the tiles [0, lead) then [start, end)): each covers
  every (row, key) pair to which the plain backward gives a non-zero P;
- both kernels' loops in f32: scores in log2 units, a row's lse as lse2 =
  lse * log2 e except -1e30 for a blind row (so its P is 1 on every key),
  the key bias -inf past Skv, query rows past Sq at lse2 = +inf, the
  causal test only on the tiles that cross the diagonal."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opadpo_tpu.ops.attention as jax_attention
from opadpo_torch.ops import attention as t_attention
from tests.torch_parity import t

OWN, WALK = t_attention.BWD_OWN, t_attention.BWD_WALK
NEG = t_attention.NEG_INF


def _masks(skv):
    """[4, skv] int32 key masks: all valid; left-padded by 37 (or all but
    the last key); a CoPO-style block masked in the middle; none valid."""
    mask = np.ones((4, skv), np.int32)
    mask[1, :min(37, skv - 1)] = 0
    mask[2, skv // 3: skv // 3 + skv // 4 + 1] = 0
    mask[3] = 0
    return torch.from_numpy(mask)


def _weighted(mask, sq, skv, causal):
    """Brute force, bool [B, Sq, Skv]: the pairs to which the plain
    backward gives a non-zero P (a visible valid key, or any key of a row
    that sees none), and bool [B, Sq]: the rows that see none."""
    b = 4 if mask is not None else 1
    vis = t_attention._visible(sq, skv, mask, causal, "cpu")[:, 0]
    vis = vis.expand(b, sq, skv)
    blind = ~vis.any(-1)
    return vis | blind[..., None], blind


LENGTHS = [(1, 1), (63, 63), (64, 64), (65, 65), (127, 127), (128, 128),
           (129, 129), (703, 703), (896, 1599), (1, 129), (65, 200),
           (63, 64), (64, 129), (127, 300)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", LENGTHS)
def test_blind_rows_lead_and_match_brute_force(sq, skv, causal):
    """Left padding, a middle block, no valid key, offsets 0 and > 0: the
    blind rows are exactly the rows with no visible valid key, and they
    lead."""
    mask = _masks(skv)
    got = t_attention.blind_rows(mask != 0, sq, skv, causal)
    assert got.dtype == torch.int32 and got.shape == (4,)
    _, blind = _weighted(mask, sq, skv, causal)
    for b in range(4):
        n = int(got[b])
        assert bool(blind[b, :n].all()) and not bool(blind[b, n:].any()), \
            (b, n)
    assert t_attention.blind_rows(None, sq, skv, causal) is None


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", LENGTHS)
def test_dq_tile_count_covers_every_weighted_pair(sq, skv, causal):
    """The dQ kernel's count per (batch row, 128-row query tile): every key
    with a non-zero P lies in its first ``count`` 64-key tiles, a tile
    whose first row is blind walks all of them, and the rest walk up to
    their diagonal (all when not causal)."""
    offset = skv - sq
    nkv = -(-skv // WALK)
    for mask in (_masks(skv), None):
        valid = None if mask is None else mask != 0
        counts = t_attention.kv_tile_count(
            t_attention.blind_rows(valid, sq, skv, causal), sq, skv, causal,
            "cpu", OWN, WALK)
        assert counts.dtype == torch.int32
        assert counts.shape[1] == -(-sq // OWN)
        weighted, blind = _weighted(mask, sq, skv, causal)
        counts = counts.expand(weighted.shape[0], -1)
        for b in range(weighted.shape[0]):
            for i, q0 in enumerate(range(0, sq, OWN)):
                n = counts[b, i].item()
                last = int(torch.nonzero(
                    weighted[b, q0:q0 + OWN].any(0)).max())
                assert last < n * WALK <= nkv * WALK, (b, q0, n)
                expect = nkv if not causal or bool(blind[b, q0]) else \
                    min(nkv, -(-(q0 + OWN + offset) // WALK))
                assert n == expect, (b, q0, n, expect)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", LENGTHS)
def test_dkv_walk_covers_every_weighted_pair(sq, skv, causal):
    """The dK/dV kernel's walk per (batch row, 128-key tile): the 64-row
    query tiles [0, lead) and [start, end) hold every row that gives one of
    the tile's keys a non-zero P, visit no tile twice, and are exactly the
    tiles from max(0, k0 - offset) / 64 on plus the earlier ones that hold
    blind rows."""
    offset = skv - sq
    nq = -(-sq // WALK)
    for mask in (_masks(skv), None):
        valid = None if mask is None else mask != 0
        blind_n = t_attention.blind_rows(valid, sq, skv, causal)
        walk = t_attention.q_tile_walk(blind_n, sq, skv, causal, "cpu")
        assert walk.dtype == torch.int32
        assert walk.shape[1:] == (-(-skv // OWN), 2)
        weighted, blind = _weighted(mask, sq, skv, causal)
        walk = walk.expand(weighted.shape[0], -1, -1)
        for b in range(weighted.shape[0]):
            n_blind = 0 if blind_n is None else int(blind_n[b])
            for kt, k0 in enumerate(range(0, skv, OWN)):
                lead, start = walk[b, kt].tolist()
                assert 0 <= lead <= start < nq, (b, k0, lead, start)
                visited = set(range(lead)) | set(range(start, nq))
                rows = weighted[b, :, k0:k0 + OWN].any(1)
                needed = {int(r) // WALK for r in torch.nonzero(rows)[:, 0]}
                assert needed <= visited, (b, k0, needed - visited)
                first = max(0, k0 - offset) // WALK if causal else 0
                assert start == first
                assert lead == min(first, -(-n_blind // WALK))


def _pad(x, n):
    """Zero rows past x.shape[1] up to n, as TMA's out-of-bounds fill."""
    out = torch.zeros(x.shape[0], n, *x.shape[2:])
    out[:, :x.shape[1]] = x
    return out


def _heads(x, rows):
    """Rows of one batch row's [S, H, D] as [H, R, D]."""
    return x[rows].transpose(0, 1)


def _tiled_backward(q, k, v, mask, causal, scale, o, lse, do):
    """Both kernels' loops in f32, on [B, S, H, D] inputs -> (dq, dk, dv).
    Each consumer warpgroup's 64 rows are a half of the CTA's 128."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    offset = skv - sq
    valid = None if mask is None else mask != 0
    blind = t_attention.blind_rows(valid, sq, skv, causal)
    counts = t_attention.kv_tile_count(blind, sq, skv, causal, "cpu", OWN,
                                       WALK).expand(b, -1)
    walk = t_attention.q_tile_walk(blind, sq, skv, causal,
                                   "cpu").expand(b, -1, -1)
    sl2 = scale * math.log2(math.e)
    delta = (do * o).sum(-1).permute(0, 2, 1)                  # [B, H, Sq]
    lse2 = torch.where(lse <= 0.5 * NEG, torch.tensor(NEG),
                       lse * math.log2(math.e))
    npad_k = -(-skv // OWN) * OWN
    npad_q = -(-sq // OWN) * OWN
    kp, vp = _pad(k, npad_k), _pad(v, npad_k)
    qp, dop = _pad(q, npad_q), _pad(do, npad_q)
    bias = torch.full((b, npad_k), -math.inf)
    bias[:, :skv] = 0.0 if valid is None else \
        torch.where(valid, 0.0, NEG)
    lse2p = torch.full((b, h, npad_q), math.inf)
    lse2p[..., :sq] = lse2
    deltap = torch.zeros(b, h, npad_q)
    deltap[..., :sq] = delta
    dq = torch.zeros(b, npad_q, h, d)
    dk = torch.zeros(b, npad_k, h, d)
    dv = torch.zeros(b, npad_k, h, d)
    for bi in range(b):
        # dQ: per query tile, 64-key tiles j < count; per warpgroup the
        # causal test from its first row's diagonal on
        for qt, q0 in enumerate(range(0, sq, OWN)):
            for w in range(2):
                rows = torch.arange(q0 + 64 * w, q0 + 64 * w + 64)
                qw, dow = _heads(qp[bi], rows), _heads(dop[bi], rows)
                inner = (q0 + 64 * w + offset + 1) // WALK if causal \
                    else 10 ** 9
                acc = torch.zeros(h, 64, d)
                for j in range(counts[bi, qt].item()):
                    cols = torch.arange(j * WALK, (j + 1) * WALK)
                    kt, vt = _heads(kp[bi], cols), _heads(vp[bi], cols)
                    bb = bias[bi, cols][None, None]
                    x = qw @ kt.transpose(1, 2) * sl2 + bb
                    if j >= inner:
                        hidden = cols[None, :] > rows[:, None] + offset
                        x = torch.where(hidden[None],
                                        torch.minimum(torch.tensor(NEG), bb),
                                        x)
                    p = torch.exp2(x - lse2p[bi][:, rows, None])
                    dp = dow @ vt.transpose(1, 2)
                    ds = p * (dp - deltap[bi][:, rows, None]) * scale
                    acc = acc + ds @ kt
                dq[bi, rows] = acc.transpose(0, 1)
        # dK/dV: per key tile, the walked 64-row query tiles
        for kti, k0 in enumerate(range(0, skv, OWN)):
            lead, start = walk[bi, kti].tolist()
            tiles = list(range(lead)) + list(range(start, -(-sq // WALK)))
            for w in range(2):
                keys = torch.arange(k0 + 64 * w, k0 + 64 * w + 64)
                kw_, vw = _heads(kp[bi], keys), _heads(vp[bi], keys)
                kb = bias[bi, keys][None, :, None]
                dka = torch.zeros(h, 64, d)
                dva = torch.zeros(h, 64, d)
                for i in tiles:
                    rows = torch.arange(i * WALK, (i + 1) * WALK)
                    qt_, dot_ = _heads(qp[bi], rows), _heads(dop[bi], rows)
                    x = kw_ @ qt_.transpose(1, 2) * sl2 + kb    # S^T
                    if causal and i * WALK + offset < k0 + 64 * w + 63:
                        hidden = keys[:, None] > rows[None, :] + offset
                        x = torch.where(hidden[None],
                                        torch.minimum(torch.tensor(NEG), kb),
                                        x)
                    pt = torch.exp2(x - lse2p[bi][:, None, rows])
                    dpt = vw @ dot_.transpose(1, 2)
                    dst = pt * (dpt - deltap[bi][:, None, rows]) * scale
                    dva = dva + pt @ dot_
                    dka = dka + dst @ qt_
                dk[bi, keys] = dka.transpose(0, 1)
                dv[bi, keys] = dva.transpose(0, 1)
    return dq[:, :sq], dk[:, :skv], dv[:, :skv]


def _inputs(sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (t(rng.normal(size=(4, sq, 2, d)).astype(np.float32))
             for _ in range(2))
    k, v = (t(rng.normal(size=(4, skv, 2, d)).astype(np.float32))
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(1, 1), (63, 63), (65, 65), (129, 129),
                                    (64, 129), (65, 200), (130, 300)])
def test_tiled_backward_matches_plain(sq, skv, causal):
    """Every row, blind ones included (P = 1 on every key, with a nonzero
    output gradient): dq, dk, dv within 1e-5 of the plain backward's
    largest entry (f32 both sides; the sums run in another order and P
    comes from exp2 in log2 units, a few f32 units apart)."""
    q, k, v, do = _inputs(sq, skv, 32, sq + skv + causal)
    mask = _masks(skv)
    scale = 32 ** -0.5
    o, lse = t_attention.mha_reference_lse(q, k, v, mask, causal, scale)
    got = _tiled_backward(q, k, v, mask, causal, scale, o, lse, do)
    ref = t_attention.flash_bwd_reference(q, k, v, mask, causal, scale, o,
                                          lse, do)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        top = max(r.abs().max().item(), 1.0)
        err = (a - r).abs().max().item()
        assert err <= 1e-5 * top, (name, err, top)


@pytest.mark.parametrize("causal,sq,skv", [(True, 128, 128),
                                           (False, 128, 128),
                                           (True, 128, 256)])
def test_tiled_backward_matches_jax_kernel(causal, sq, skv):
    """Against the Pallas ``_flash_bwd`` (interpret mode, 128-tiles, offset
    Skv - Sq) with masks under which every row sees a valid key (all keys
    valid; a middle block masked), where both define the same gradients:
    within 1e-5 of the largest entry."""
    d = 64
    q, k, v, do = _inputs(sq, skv, d, 7 + sq + skv + causal)
    mask = _masks(skv)[[0, 2]]
    q, k, v, do = (x[:2] for x in (q, k, v, do))
    scale = d ** -0.5
    o, lse = t_attention.mha_reference_lse(q, k, v, mask, causal, scale)
    got = _tiled_backward(q, k, v, mask, causal, scale, o, lse, do)
    kbias = np.where(mask.numpy() != 0, 0.0, NEG).astype(np.float32)
    lse8 = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None],
                            (*lse.shape, 8))
    hm = [jnp.asarray(x.numpy().transpose(0, 2, 1, 3))
          for x in (q, k, v, o, do)]
    ref = jax_attention._flash_bwd(*hm[:3], jnp.asarray(kbias[:, None, :]),
                                   hm[3], lse8, hm[4], causal, scale, 128,
                                   128, offset=skv - sq)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        r = np.asarray(r).transpose(0, 2, 1, 3)
        top = max(np.abs(r).max(), 1.0)
        np.testing.assert_allclose(a.numpy(), r, atol=1e-5 * top,
                                   err_msg=name)
