"""The scatter kernel's grid (``ops/heads_layout.scatter_grid``) against
brute force, on the CPU.

A CTA of the kernel (``csrc/heads_layout.cu``) owns 64 rows of one batch
and a run of the launch's tiles (one source head of one tensor each: q's
heads, then k's, then v's), group g the tiles [g * tiles // groups,
(g + 1) * tiles // groups); it reads each tile's [64, hd] box of x and
writes it to each of the tile's ``rep`` output heads, clipped at S.  The
test walks the grid as the kernel does and counts what each CTA reads and
writes."""

import numpy as np
import pytest

from opadpo_torch.ops import heads_layout as hl

H = 32


def _walk(b, s, hd, reps, slots):
    """(reads [T, B, S, width / 8], writes [T, B, H, S], CTAs, groups) of
    one launch over tensors with ``reps`` (q 1, k and v rep): the reads
    count each 16-byte column block of x."""
    nsrc = [H // r for r in reps]
    tiles = sum(nsrc)
    blocks, groups = hl.scatter_grid(b, s, tiles, slots)
    reads = np.zeros((len(reps), b, s, H * hd // 8), np.int32)
    writes = np.zeros((len(reps), b, H, s), np.int32)
    for blk in range(blocks):
        rows = slice(blk * hl.SCATTER_ROWS,
                     min(s, (blk + 1) * hl.SCATTER_ROWS))
        for bb in range(b):
            for g in range(groups):
                run = range(g * tiles // groups, (g + 1) * tiles // groups)
                assert len(run) > 0
                for k in run:
                    t, j = 0, k                 # the kernel's locate()
                    while j >= nsrc[t]:
                        j -= nsrc[t]
                        t += 1
                    reads[t, bb, rows, j * hd // 8:(j + 1) * hd // 8] += 1
                    for r in range(reps[t]):
                        writes[t, bb, j * reps[t] + r, rows] += 1
    return reads, writes, blocks * b * groups, groups


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("b", [1, 2, 6])
@pytest.mark.parametrize("s", [27, 703, 896])
def test_scatter_grid_writes_every_row_of_every_head_once(s, b, rep, hd):
    """q, k and v of one stream in one launch (q rep 1, k and v rep):
    every (tensor, b, h, s) of the outputs written exactly once, every
    input column of every row read exactly once, no group empty, and the
    grid within the card's resident CTAs (one wave) at 3 and 6 CTAs an SM
    on 132 SMs, and at a small card."""
    reps = (1, rep, rep)
    for slots in (132 * 3, 132 * 6, 40):
        reads, writes, ctas, groups = _walk(b, s, hd, reps, slots)
        for t, r in enumerate(reps):
            width = (H // r) * hd // 8
            assert (reads[t, :, :, :width] == 1).all(), (t, slots)
            assert (reads[t, :, :, width:] == 0).all(), (t, slots)
        assert (writes == 1).all(), slots
        per_group = b * -(-s // hl.SCATTER_ROWS)
        assert ctas <= slots or groups == 1, (ctas, slots)
        assert groups == H + 2 * H // rep or ctas + per_group > slots


@pytest.mark.parametrize("s,b,groups", [(703, 2, 18), (896, 6, 4)])
def test_scatter_grid_at_the_training_shapes(s, b, groups):
    """The two training streams of the 7B (32 heads of 128, q, k and v in
    one launch, 96 tiles) at 3 CTAs an SM on 132 SMs: the prefix
    [2, 703] takes 18 groups (396 CTAs, 5 or 6 tiles each), the response
    stream [6, 896] 4 (336 CTAs, 24 tiles each)."""
    blocks, got = hl.scatter_grid(b, s, 3 * H, 132 * 3)
    assert got == groups and blocks * b * got <= 132 * 3
