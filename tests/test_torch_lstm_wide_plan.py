"""The recurrence forward's launch plan (``ops/lstm_seq.py:
fwd_wide_plan``) and the wide backward sweep's (``ops/lstm_seq_train.py:
bwd_wide_plan``) on the CPU, for every H the wide sweep takes (600 < H <=
1024; the forward's plan below it too) and B = 1 .. 128, on one and two
directions.

The forward (csrc/lstm_seq_fwd.cuh, Fwd: one tile for every H) runs one
CTA of 512 threads an SM, 16 hidden units each, all of a direction's row group
co-resident; each step it brings the direction's bf16 h in 32-row chunks
through a ring of shared memory slots by 16-byte copies whose completion
each slot's mbarrier counts. The plan mirrors the launcher's choice of row
groups and slices and picks the ring; these tests hold it to the H100's 132
SMs and 227 KB a CTA, to covering every unit and row once, and to the ring
being as deep as fits.
The kernel itself is held to its plain version on the card by chip_smoke.py
and compare_lstm.py."""

import pytest

from video_captioning_tpu_torch.ops.lstm_seq import (
    CARD_SMS,
    NARROW_MAX_HIDDEN,
    SMEM_LIMIT,
    WIDE_MAX_RING,
    WIDE_MIN_ROWS,
    WIDE_ROWS,
    WIDE_THREADS,
    WIDE_UNITS,
    fwd_ring,
    fwd_wide_plan,
    fwd_wide_smem,
)
from video_captioning_tpu_torch.ops.lstm_seq_train import (
    BWD_CLUSTER,
    BWD_COL_TILES,
    BWD_MAX_RING,
    BWD_ROWS,
    BWD_WIDE_THREADS,
    bwd_wide_plan,
    bwd_wide_ring,
    bwd_wide_smem,
)

WIDE_HIDDEN = range(NARROW_MAX_HIDDEN + 1, 1025)


def _check(H, B, ND):
    plan = fwd_wide_plan(H, B, ND)
    where = (H, B, ND, plan)
    ug, groups, nb, ring = plan["unit_groups"], plan["row_groups"], plan["nb"], plan["ring"]
    # Every unit once: 16 units a CTA, the last group partly masked.
    assert (ug - 1) * WIDE_UNITS < H <= ug * WIDE_UNITS, where
    # One CTA an SM (W_hh in registers), every CTA that meets co-resident.
    assert plan["ctas"] == ND * groups * ug <= CARD_SMS, where
    # Every row once: slices of `slice` rows, each over `groups` row groups
    # of at most nb rows, none empty.
    assert plan["launches"] * plan["slice"] >= B > (plan["launches"] - 1) * plan["slice"], where
    assert groups * nb >= plan["slice"] > (groups - 1) * nb, where
    assert groups == 1 or nb >= WIDE_MIN_ROWS, where
    # The launcher's row groups: the most that are co-resident.
    if plan["slice"] == B and groups < max(1, B // WIDE_MIN_ROWS):
        assert ND * (groups + 1) * ug > CARD_SMS, where
    # Shared memory and the ring: as deep as fits, at most a step's chunks.
    chunks = -(-nb // WIDE_ROWS)
    assert plan["chunks"] == chunks, where
    assert 1 <= ring <= min(chunks, WIDE_MAX_RING), where
    assert plan["smem"] == fwd_wide_smem(H, nb, ring) <= SMEM_LIMIT, where
    assert ring in (chunks, WIDE_MAX_RING) or fwd_wide_smem(H, nb, ring + 1) > SMEM_LIMIT, where
    assert fwd_ring(H, B, ND) == ring
    return plan


@pytest.mark.parametrize("ND", [2, 1])
@pytest.mark.parametrize("B0", list(range(1, 129, 16)))
def test_fwd_wide_plan_fits_and_covers_every_unit_and_row(B0, ND):
    for B in range(B0, B0 + 16):
        for H in WIDE_HIDDEN:
            _check(H, B, ND)


def test_fwd_wide_plan_main_shapes():
    """The H = 1024 encoder: 2 x 64 CTAs of one epilogue item a thread; at
    B = 128 two of a step's four chunks in flight, at B = 32 (training) the
    step's one chunk."""
    assert WIDE_UNITS * WIDE_ROWS == WIDE_THREADS
    plan = _check(1024, 128, 2)
    assert plan["ctas"] == 128 and plan["row_groups"] == 1
    assert plan["chunks"] == 4 and plan["ring"] == 2
    plan = _check(1024, 32, 2)
    assert plan["ring"] == plan["chunks"] == 1


@pytest.mark.parametrize("B", [700, 2000, 5000])
def test_fwd_wide_plan_slices_large_batches(B):
    """Rows whose carried state does not fit one launch run as sequential
    slices, halved until they fit, as the launcher does."""
    plan = _check(1024, B, 2)
    slice_rows = B
    while fwd_wide_smem(1024, slice_rows, 1) > SMEM_LIMIT:
        slice_rows = -(-slice_rows // 2)
    assert plan["slice"] == slice_rows


def test_narrow_widths_take_the_plan_ring():
    """The forward runs one tile for every H, so H <= 600 takes the same
    plan's ring: every chunk of a step at the main path's shapes (two at
    B = 128, one at B = 32), and at H = 600, B = 128 the three that fit of
    four."""
    assert fwd_ring(512, 128, 2) == fwd_wide_plan(512, 128, 2)["chunks"] == 2
    assert fwd_ring(512, 32, 2) == 1
    assert fwd_ring(600, 37, 1) == fwd_wide_plan(600, 37, 1)["ring"] >= 1
    assert fwd_ring(600, 128, 2) == 3
    for H in (8, 40, 512, 600):
        for B in (1, 32, 37, 128):
            _check(H, B, 2)


# The wide backward sweep (csrc/lstm_seq_train.cu, lstm_seq_bwd_wide_kernel):
# 16 units and 16 warps a CTA, one CTA an SM, CTAs in clusters of two that
# share their rows and split K (half of the 4H dgates columns each, for the
# pair's 32 units), dgates in 16-row x 1024-column stages through a ring of
# mbarrier slots, the next step's phase-A inputs staged beside them.


def _check_bwd(H, B, ND):
    plan = bwd_wide_plan(H, B, ND)
    where = (H, B, ND, plan)
    ug, groups, nb, ring = plan["unit_groups"], plan["row_groups"], plan["nb"], plan["ring"]
    # Every unit once: 16 units a CTA, the unit groups padded to whole
    # clusters (pairs that share their rows; a padding CTA's units lie past H).
    assert ug % BWD_CLUSTER == 0 and (ug - BWD_CLUSTER) * WIDE_UNITS < H <= ug * WIDE_UNITS, where
    assert plan["ctas"] == ND * groups * ug <= CARD_SMS, where
    assert plan["launches"] * plan["slice"] >= B > (plan["launches"] - 1) * plan["slice"], where
    assert groups * nb >= plan["slice"] > (groups - 1) * nb, where
    assert groups == 1 or nb >= WIDE_MIN_ROWS, where
    if plan["slice"] == B and groups < max(1, B // WIDE_MIN_ROWS):
        assert ND * (groups + 1) * ug > CARD_SMS, where
    # Every k-tile of the CTA's half of 4H once: the column chunks of
    # BWD_COL_TILES k-tiles, at most two (16 warps x 4 k-tiles x 4 n-tiles
    # of the pair's 32 units x 2 = 64 registers of W_hh a thread).
    kt = 4 * H // BWD_CLUSTER // 16
    assert (plan["col_chunks"] - 1) * BWD_COL_TILES < kt <= plan["col_chunks"] * BWD_COL_TILES
    assert plan["col_chunks"] <= 2
    assert (plan["col_chunks"] * BWD_COL_TILES // (BWD_WIDE_THREADS // 32)
            * (BWD_CLUSTER * WIDE_UNITS // 8) * 2) <= 64
    # Every row of the CTA once: its row chunks of BWD_ROWS.
    assert (plan["chunks"] - 1) * BWD_ROWS < nb <= plan["chunks"] * BWD_ROWS, where
    assert plan["stages"] == plan["chunks"] * plan["col_chunks"], where
    # The ring: as deep as fits, at most a step's stages.
    assert 1 <= ring <= min(plan["stages"], BWD_MAX_RING), where
    assert plan["smem"] == bwd_wide_smem(nb, ring) <= SMEM_LIMIT, where
    assert (ring in (plan["stages"], BWD_MAX_RING)
            or bwd_wide_smem(nb, ring + 1) > SMEM_LIMIT), where
    return plan


@pytest.mark.parametrize("ND", [2, 1])
@pytest.mark.parametrize("B0", list(range(1, 129, 16)))
def test_bwd_wide_plan_fits_and_covers_every_unit_and_row(B0, ND):
    for B in range(B0, B0 + 16):
        for H in WIDE_HIDDEN:
            _check_bwd(H, B, ND)


def test_bwd_wide_plan_main_shapes():
    """The H = 1024 encoder's training step (B = 32): 2 x 64 CTAs in 64
    clusters of 2, each CTA's step 4 stages (2 row chunks x 2 column chunks
    of its 2048 columns), all in flight; at B = 128, 16 stages with 3 in
    flight; H = 1000 pads 63 unit groups to 64."""
    plan = _check_bwd(1024, 32, 2)
    assert (plan["ctas"], plan["row_groups"], plan["stages"], plan["ring"]) == (128, 1, 4, 4)
    assert plan["smem"] == 195888
    plan = _check_bwd(1024, 128, 2)
    assert (plan["stages"], plan["ring"]) == (16, 3)
    assert _check_bwd(1000, 32, 2)["unit_groups"] == 64
    assert _check_bwd(608, 32, 2)["col_chunks"] == 2


@pytest.mark.parametrize("B", [400, 2000, 5000])
def test_bwd_wide_plan_slices_large_batches(B):
    plan = _check_bwd(1024, B, 2)
    slice_rows = B
    while bwd_wide_smem(slice_rows, 1) > SMEM_LIMIT:
        slice_rows = -(-slice_rows // 2)
    assert plan["slice"] == slice_rows < B


@pytest.mark.parametrize("H", [608, 1000, 1024])
def test_bwd_wide_ring_is_the_deepest_that_fits(H):
    """The launcher sizes shared memory by bwd_wide_ring for every row count
    it tries: the most slots that fit, at most a step's stages and
    BWD_MAX_RING, and 1 where none fits (those row counts are refused)."""
    for nb in range(1, 400):
        ring = bwd_wide_ring(nb, H)
        stages = -(-nb // BWD_ROWS) * -(-(4 * H // BWD_CLUSTER // 16) // BWD_COL_TILES)
        assert 1 <= ring <= min(stages, BWD_MAX_RING), (nb, H)
        if ring > 1:
            assert bwd_wide_smem(nb, ring) <= SMEM_LIMIT, (nb, H)
        if ring < min(stages, BWD_MAX_RING):
            assert bwd_wide_smem(nb, ring + 1) > SMEM_LIMIT, (nb, H)
