"""The head-layout kernels' grid (``ops/heads_layout.scatter_grid``, and
``gather_grid``, the same rule) against brute force, on the CPU.

A CTA of the scatter kernel (``csrc/heads_layout.cu``) owns 64 rows of one
batch and a run of the launch's tiles (one source head of one tensor each:
q's heads, then k's, then v's), group g the tiles [g * tiles // groups,
(g + 1) * tiles // groups); it reads each tile's [64, hd] box of x and
writes it to each of the tile's ``rep`` output heads, clipped at S.  A CTA
of the gather kernel owns the same rows and a run of tiles of one output
(kv) head each (dQ's, then dK's, then dV's); it reads the tile's box of
``group`` gradient heads and writes one [64, hd] block of out, clipped at
S.  The tests walk each grid as its kernel does and count what each CTA
reads and writes."""

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


def _walk_gather(b, s, hd, groups, slots):
    """(reads [T, B, H, S], writes [T, B, S, width / 8], CTAs, grid
    groups) of one gather launch over gradients with ``groups`` (dQ 1, dK
    and dV the GQA group): the reads count each gradient head's rows and
    check that the tile reading them is their own kv head's, the writes
    each 16-byte column block of out."""
    nout = [H // g for g in groups]
    tiles = sum(nout)
    blocks, grid_groups = hl.gather_grid(b, s, tiles, slots)
    reads = np.zeros((len(groups), b, H, s), np.int32)
    writes = np.zeros((len(groups), b, s, H * hd // 8), np.int32)
    for blk in range(blocks):
        rows = slice(blk * hl.SCATTER_ROWS,
                     min(s, (blk + 1) * hl.SCATTER_ROWS))
        for bb in range(b):
            for g in range(grid_groups):
                run = range(g * tiles // grid_groups,
                            (g + 1) * tiles // grid_groups)
                assert len(run) > 0
                for k in run:
                    t, j = 0, k                 # the kernel's locate()
                    while j >= nout[t]:
                        j -= nout[t]
                        t += 1
                    # the box (hd, 64, group, 1) at head j * group
                    for head in range(j * groups[t], (j + 1) * groups[t]):
                        assert head // groups[t] == j
                        reads[t, bb, head, rows] += 1
                    writes[t, bb, rows, j * hd // 8:(j + 1) * hd // 8] += 1
    return reads, writes, blocks * b * grid_groups, grid_groups


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("b", [1, 2, 6])
@pytest.mark.parametrize("s", [27, 703, 896])
def test_gather_grid_writes_every_output_once(s, b, group, hd):
    """dQ, dK and dV of one stream in one gather launch (dQ group 1, dK and
    dV ``group``): every element of every output written exactly once and
    nothing past its width, every gradient head's every row read exactly
    once, by its own kv head's tile, no run empty, and the grid within the
    card's resident CTAs at 3 and 1 CTAs an SM on 132 SMs, and at a small
    card."""
    groups = (1, group, group)
    for slots in (132 * 3, 132, 40):
        reads, writes, ctas, grid_groups = _walk_gather(b, s, hd, groups,
                                                        slots)
        assert (reads == 1).all(), slots
        for t, g in enumerate(groups):
            width = (H // g) * hd // 8
            assert (writes[t, :, :, :width] == 1).all(), (t, slots)
            assert (writes[t, :, :, width:] == 0).all(), (t, slots)
        per_group = b * -(-s // hl.SCATTER_ROWS)
        assert ctas <= slots or grid_groups == 1, (ctas, slots)
        assert grid_groups == H + 2 * H // group \
            or ctas + per_group > slots


@pytest.mark.parametrize("s,b,groups", [(703, 2, 18), (896, 6, 4)])
def test_gather_grid_at_the_training_shapes(s, b, groups):
    """dQ, dK and dV of the 7B's two training streams in one gather launch
    (32 heads of 128, no GQA: 96 tiles) at 3 CTAs an SM on 132 SMs: the
    scatter's grids, 396 and 336 CTAs, within the card's resident CTAs."""
    blocks, got = hl.gather_grid(b, s, 3 * H, 132 * 3)
    assert got == groups and blocks * b * got <= 132 * 3
