"""The flash forward kernel's tiling rules and its online softmax, on the
CPU.  The kernel (``opadpo_torch/csrc/flash_fwd.cu``) runs only on the GPU
(``tests/test_torch_gpu.py``); what it decides before and inside its loop is
held here against brute force and against the plain version and the JAX
package's Pallas ``_flash_fwd`` (interpret mode):

- ``kv_tile_count``, which the wrapper computes and the kernel reads: the
  KV tiles a 128-row query tile walks cover every (row, key) pair with a
  non-zero weight in ``mha_reference_lse``, a tile holding a row with no
  valid key walks every tile, and the rule is exactly "some row of the
  tile sees no valid key";
- the kernel's arithmetic in f32: scores in log2 units (scale times log2 e,
  exp2), the bias -inf from Skv to the end of the last tile, the causal
  rule only on tiles past the first row's diagonal, a masked score of
  -1e30, and lse -1e30 for a row that sees no valid key."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opadpo_tpu.ops.attention as jax_attention
from opadpo_torch.ops import attention as t_attention
from tests.torch_parity import t

BQ, BK = t_attention.FWD_BQ, t_attention.FWD_BK
NEG = t_attention.NEG_INF


def _masks(skv):
    """[4, skv] int32 key masks: all valid; left-padded by 37 (or all but
    the last key); a CoPO-style block masked in the middle; none valid."""
    mask = np.ones((4, skv), np.int32)
    mask[1, :min(37, skv - 1)] = 0
    mask[2, skv // 3: skv // 3 + skv // 4 + 1] = 0
    mask[3] = 0
    return torch.from_numpy(mask)


def _first_valid(mask, skv):
    """Brute force: each row's first valid key, Skv where it has none."""
    out = []
    for row in mask.numpy():
        valid = np.flatnonzero(row)
        out.append(int(valid[0]) if valid.size else skv)
    return out


@pytest.mark.parametrize("skv", [1, 2, 63, 129, 1599])
def test_kv_tile_count_walks_all_iff_first_row_sees_no_key(skv):
    """Causal square attention: query tile q0 walks all tiles iff q0 <
    the row's first valid key."""
    mask = _masks(skv)
    nkv = -(-skv // BK)
    got = t_attention.kv_tile_count(mask != 0, skv, skv, True)
    assert got.dtype == torch.int32 and got.shape == (4, -(-skv // BQ))
    for b, first in enumerate(_first_valid(mask, skv)):
        for i, q0 in enumerate(range(0, skv, BQ)):
            diag = min(nkv, -(-(q0 + BQ) // BK))
            assert got[b, i].item() == (nkv if q0 < first else diag)


def test_kv_tile_count_without_mask_is_one_row():
    """No mask: one row of counts for every batch row; bidirectional walks
    every tile, causal up to the diagonal."""
    got = t_attention.kv_tile_count(None, 200, 450, True, "cpu")
    assert got.tolist() == [[min(4, -(-(q0 + BQ + 250) // BK))
                             for q0 in (0, 128)]]
    got = t_attention.kv_tile_count(None, 200, 450, False, "cpu")
    assert got.tolist() == [[4, 4]]
    mask = _masks(450) != 0
    assert torch.equal(t_attention.kv_tile_count(mask, 200, 450, False),
                       torch.tensor([[4, 4]], dtype=torch.int32))


LENGTHS = [(1, 1), (63, 63), (64, 64), (65, 65), (127, 127), (128, 128),
           (129, 129), (703, 703), (896, 1599), (1, 129), (65, 200)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", LENGTHS)
def test_kv_tile_count_covers_every_weighted_pair(sq, skv, causal):
    """Offsets 0 (square) and Skv - Sq > 0; masks as ``_masks`` and none."""
    offset = skv - sq
    nkv = -(-skv // BK)
    for mask in (_masks(skv), None):
        vis = t_attention._visible(sq, skv, mask, causal, "cpu")[:, 0]
        vis = vis.expand(4, sq, skv)
        counts = t_attention.kv_tile_count(
            None if mask is None else mask != 0, sq, skv, causal, "cpu")
        counts = counts.expand(4, -1)
        for b in range(4):
            for i, q0 in enumerate(range(0, sq, BQ)):
                rows = vis[b, q0:q0 + BQ]
                seen = rows.any(1)
                # a row with no visible key weighs every key alike
                weighted = rows | ~seen[:, None]
                last = int(torch.nonzero(weighted.any(0)).max())
                n = counts[b, i].item()
                assert last < n * BK <= nkv * BK, (b, q0, n)
                if not bool(seen.all()):
                    assert n == nkv
                expect = nkv if not causal or not bool(seen.all()) else \
                    min(nkv, -(-(q0 + BQ + offset) // BK))
                assert n == expect, (b, q0, n, expect)


def _tiled_forward(q, k, v, mask, causal, scale):
    """The kernel's loop in f32: q [B, Sq, H, D], k, v [B, Skv, H, D] ->
    (o, lse [B, H, Sq])."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    offset = skv - sq
    nkv = -(-skv // BK)
    # the producer's bias tiles: -inf from Skv on
    bias = torch.full((b, nkv * BK), -math.inf)
    bias[:, :skv] = t_attention._key_bias(mask, b, skv, "cpu")
    counts = t_attention.kv_tile_count(mask != 0, sq, skv, causal)
    counts = counts.expand(b, -1)
    scale_log2 = scale * math.log2(math.e)
    o = torch.zeros(b, sq, h, d)
    lse = torch.zeros(b, h, sq)
    kp = torch.zeros(b, nkv * BK, h, d)
    vp = torch.zeros_like(kp)
    kp[:, :skv], vp[:, :skv] = k, v          # TMA's zero fill past Skv
    for bi in range(b):
        for qi, q0 in enumerate(range(0, sq, BQ)):
            rows = torch.arange(q0, min(q0 + BQ, sq))
            qt = q[bi, rows].transpose(0, 1)                 # [H, R, D]
            m = torch.full((h, len(rows), 1), -math.inf)
            l = torch.zeros(h, len(rows), 1)
            acc = torch.zeros(h, len(rows), d)
            inner = (q0 + offset + 1) // BK if causal else 10 ** 9
            ntiles = counts[bi, qi].item()
            for j in range(ntiles):
                cols = torch.arange(j * BK, (j + 1) * BK)
                kt = kp[bi, cols].transpose(0, 1)            # [H, BK, D]
                vt = vp[bi, cols].transpose(0, 1)
                bb = bias[bi, cols][None, None, :]
                x = (qt @ kt.transpose(1, 2)) * scale_log2 + bb
                if j >= inner:
                    hidden = cols[None, :] > rows[:, None] + offset
                    x = torch.where(hidden[None],
                                    torch.minimum(torch.tensor(NEG), bb), x)
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p @ vt
                m = m_new
            o[bi, rows] = (acc / torch.where(l == 0, 1.0, l)).transpose(0, 1)
            row_lse = torch.where((l == 0) | (m <= 0.5 * NEG),
                                  torch.tensor(NEG),
                                  m * math.log(2.0) + torch.log(l))
            lse[bi, :, rows] = row_lse[..., 0]
    return o, lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,d", [(1, 129, 32), (65, 65, 64),
                                      (129, 129, 32), (130, 300, 32)])
def test_tiled_online_softmax_matches_plain(sq, skv, d, causal):
    """Every row, fully masked ones included (uniform over all Skv keys, lse
    -1e30): o within 1e-5 and lse within 1e-5 (f32 both sides; the sums
    run in another order)."""
    rng = np.random.default_rng(sq + skv + d + causal)
    q = rng.normal(size=(4, sq, 2, d)).astype(np.float32)
    k, v = (rng.normal(size=(4, skv, 2, d)).astype(np.float32)
            for _ in range(2))
    mask = _masks(skv)
    scale = d ** -0.5
    o, lse = _tiled_forward(t(q), t(k), t(v), mask, causal, scale)
    o_ref, lse_ref = t_attention.mha_reference_lse(t(q), t(k), t(v), mask,
                                                   causal, scale)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("causal,sq,skv", [(True, 128, 128),
                                           (False, 128, 128),
                                           (True, 128, 256)])
def test_tiled_online_softmax_matches_jax_kernel(causal, sq, skv):
    """Against the Pallas ``_flash_fwd`` (interpret mode, 128-tiles, offset
    Skv - Sq) on the rows that see a valid key, where both define the same
    output (the Pallas kernel's rows with none stop at their causal bound):
    o and lse within 1e-5."""
    rng = np.random.default_rng(sq + skv + causal)
    d = 64
    q = rng.normal(size=(4, sq, 2, d)).astype(np.float32)
    k, v = (rng.normal(size=(4, skv, 2, d)).astype(np.float32)
            for _ in range(2))
    mask = _masks(skv)
    scale = d ** -0.5
    kbias = np.where(mask.numpy() != 0, 0.0, NEG).astype(np.float32)
    o_j, lse_j = jax_attention._flash_fwd(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
        jnp.asarray(kbias[:, None, :]), causal, scale, 128, 128,
        offset=skv - sq)
    o_j = np.asarray(o_j).transpose(0, 2, 1, 3)
    lse_j = np.asarray(lse_j)[..., 0]
    o, lse = _tiled_forward(t(q), t(k), t(v), mask, causal, scale)
    seen = t_attention._visible(sq, skv, mask, causal, "cpu")[:, 0] \
        .any(-1).numpy()                                      # [B, Sq]
    assert seen.any() and not seen.all()
    np.testing.assert_allclose(o.numpy()[seen], o_j[seen], atol=1e-5)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[seen],
                               lse_j.transpose(0, 2, 1)[seen], rtol=1e-6,
                               atol=1e-5)
