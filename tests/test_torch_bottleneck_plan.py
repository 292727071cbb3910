"""``fused_bottleneck``'s launch plan (``ops/bottleneck.py:kernel_plan``) on
the CPU, and a plain model of the kernel's decomposition against the plain
version.

The kernel (csrc/fused_bottleneck.cu) splits Cm over a thread block
cluster of ceil(Cm / slice) CTAs that share a work item (whole images, or
a pixel tile with its one-pixel halo): each CTA computes y1 for its
channels over the item's x box (the halo window kept inside the image),
stores it into Y of every CTA at the item's halo-grid positions, then y2
for its channels from Y at the nine shifted positions, then its output
channels. These tests hold every plan at ResNet50's stages (B = 32) and at
``chip_smoke.BOTTLENECK_EDGE_SHAPES`` to the H100's shared memory and to
the clusters the card runs at once (the counts passed in), its items and
slices to covering every pixel and channel exactly once, and a plain model
of that decomposition to the plain version. The C entry validates the plan
it is given; the kernel itself is held to its plain version on the card by
chip_smoke.py and compare_bottleneck.py.
"""

import math

import pytest
import torch

from chip_smoke import BOTTLENECK_EDGE_SHAPES, RESNET_STAGES, bottleneck_inputs
from video_captioning_tpu_torch.ops.bottleneck import (
    CHANNEL_ALIGN,
    _kernel_operands,
    INSTANCES,
    MAX_CLUSTER,
    MAX_STAGES,
    SMEM_LIMIT,
    fused_bottleneck_reference,
    geometry,
    kernel_plan,
)

# cudaOccupancyMaxActiveClusters of the kernel on an NVIDIA H100 80GB HBM3
# (700 W) by cluster size, one CTA an SM, as the kernel's C entry reported it.
H100_ACTIVE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
DTYPES = (torch.float32, torch.bfloat16)


def _align(n):
    return -(-n // CHANNEL_ALIGN) * CHANNEL_ALIGN


def _checked_plan(B, H, W, C, Cm, dtype, sms=132, active=H100_ACTIVE):
    C, Cm = _align(C), _align(Cm)
    plan = kernel_plan(B, H, W, C, Cm, dtype, sms, active)
    cs, ns, ni, ty, tx = (plan[k] for k in ("cluster", "slice", "images", "tile_h", "tile_w"))
    g = geometry(B, H, W, C, Cm, dtype, cs, ns, ni, ty, tx, plan["mb1"], plan["stages"])
    where = (B, H, W, C, Cm, dtype, plan)
    # Fits a CTA and the kernel's instances; the cluster is the least that
    # holds Cm in slices.
    assert plan["smem_bytes"] == g["smem"] <= SMEM_LIMIT, where
    assert (ns, plan["mb1"], plan["mb2"]) in INSTANCES[dtype], where
    assert g["M1"] <= 64 * plan["mb1"] and g["M2"] <= 64 * plan["mb2"], where
    assert 2 <= plan["stages"] <= MAX_STAGES, where
    assert cs == -(-Cm // ns) <= MAX_CLUSTER, where
    assert ni == 1 or (ty, tx) == (H, W), where
    # Its clusters are counted in waves of what the card runs at once.
    assert active[cs] >= 1 and plan["active_clusters"] == active[cs], where
    assert plan["clusters"] == g["items"] and plan["ctas"] == g["items"] * cs, where
    assert plan["waves"] == -(-g["items"] // active[cs]), where
    return plan, g


def _items(B, H, W, plan, g):
    """Each work item's (first image, tile row, tile column) in launch order."""
    for item in range(g["items"]):
        tile = item % g["tiles"]
        yield (item // g["tiles"] * plan["images"], tile // g["tiles_x"] * plan["tile_h"],
               tile % g["tiles_x"] * plan["tile_w"])


def _check_cover(B, H, W, C, Cm, dtype):
    plan, g = _checked_plan(B, H, W, C, Cm, dtype)
    C, Cm = _align(C), _align(Cm)
    ni, ty, tx, cs, ns = (plan[k] for k in ("images", "tile_h", "tile_w", "cluster", "slice"))
    seen = torch.zeros((B, H, W), dtype=torch.int32)
    for img0, oy, ox in _items(B, H, W, plan, g):
        seen[img0:img0 + ni, oy:oy + ty, ox:ox + tx] += 1
        # The x box lies in the image and holds the item's halo window.
        by0, bx0 = min(max(oy - 1, 0), H - g["by"]), min(max(ox - 1, 0), W - g["bx"])
        assert by0 >= 0 and bx0 >= 0 and by0 + g["by"] <= H and bx0 + g["bx"] <= W
        assert by0 <= max(oy - 1, 0) and min(oy + ty + 1, H) <= by0 + g["by"]
        assert bx0 <= max(ox - 1, 0) and min(ox + tx + 1, W) <= bx0 + g["bx"]
    assert bool((seen == 1).all()), (B, H, W, plan)
    # y channels: slices of ns; output channels: nc a CTA (whole 128-byte rows).
    y = torch.zeros(Cm, dtype=torch.int32)
    o = torch.zeros(C, dtype=torch.int32)
    for q in range(cs):
        y[q * ns:min(Cm, (q + 1) * ns)] += 1
        o[q * g["nc"]:min(C, (q + 1) * g["nc"])] += 1
    assert bool((y == 1).all()) and bool((o == 1).all()), (C, Cm, plan)
    assert g["nc"] % (32 if dtype == torch.float32 else 64) == 0
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("stage", range(1, 5))
def test_stage_plans_fit_and_cover_every_pixel_and_channel(stage, dtype):
    H, C, Cm = RESNET_STAGES[stage - 1]
    _check_cover(32, H, H, C, Cm, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", BOTTLENECK_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_edge_shape_plans_fit_and_cover_every_pixel_and_channel(shape, dtype):
    _check_cover(*shape, dtype)


@pytest.mark.parametrize("active", [{1: 132, 2: 66, 4: 33, 8: 16}, {1: 8, 2: 4, 4: 2, 8: 1}])
def test_plans_count_waves_of_the_clusters_passed_in(active):
    """Other cards: every plan's cluster size has a count, and the waves
    follow from it."""
    for H, C, Cm in RESNET_STAGES:
        for dtype in DTYPES:
            for B in (1, 32):
                _checked_plan(B, H, H, C, Cm, dtype, sms=active[1], active=active)


def test_main_plans_run_in_one_wave_where_bf16_cluster_of_two_fits():
    """bfloat16 stages 2-4 at B = 32 on an H100 take clusters of at most two
    CTAs and one wave: the parent's clusters of 4 and 8 fit only 30 and 15
    at once and ran two waves."""
    for H, C, Cm in RESNET_STAGES[1:]:
        plan, _ = _checked_plan(32, H, H, C, Cm, torch.bfloat16)
        assert plan["cluster"] <= 2 and plan["waves"] == 1, plan


def _kernel_model(x, w1, b1, w2, b2, w3, b3, plan):
    """The kernel's decomposition in float64: per item, y1 over the x box
    rows, stored by halo position into Y (zeros elsewhere), y2 from Y at the
    nine shifted positions of each pixel, y2 into Y by pixel row, and the
    output channels of each rank (the ranks' channel slices side by side);
    rounded where the kernel rounds."""
    dt = x.dtype
    B, H, W, C = x.shape
    Cm = w1.shape[0]
    cs, ns, ni, ty, tx = (plan[k] for k in ("cluster", "slice", "images", "tile_h", "tile_w"))
    g = geometry(B, H, W, C, Cm, dt, cs, ns, ni, ty, tx, plan["mb1"], plan["stages"])
    f = lambda t: t.double()  # noqa: E731
    w2r = f(w2).permute(0, 2, 3, 1).reshape(Cm, 9 * Cm)  # channels_last row order
    out = torch.full(x.shape, float("nan"), dtype=torch.float64)
    HY, HX, P = g["HY"], g["HX"], ty * tx
    for img0, oy, ox in _items(B, H, W, plan, g):
        by0, bx0 = min(max(oy - 1, 0), H - g["by"]), min(max(ox - 1, 0), W - g["bx"])
        # Phase 1: the box rows (bi images x by x bx), images past B zeros;
        # row r to its halo position, if the kernel stores it.
        box = torch.zeros((g["bi"], g["by"], g["bx"], C), dtype=torch.float64)
        n_img = min(g["bi"], B - img0)
        box[:n_img] = f(x[img0:img0 + n_img, by0:by0 + g["by"], bx0:bx0 + g["bx"]])
        r = torch.arange(g["M1"])
        i, rr = r // (g["by"] * g["bx"]), r % (g["by"] * g["bx"])
        hy, hx = by0 + rr // g["bx"] - oy + 1, bx0 + rr % g["bx"] - ox + 1
        keep = (img0 + i < B) & (hy >= 0) & (hy < HY) & (hx >= 0) & (hx < HX)
        y1 = torch.relu(box.reshape(-1, C) @ f(w1).T + f(b1)).to(dt).double()
        Y = torch.zeros((g["npos"], Cm), dtype=torch.float64)
        Y[((i * HY + hy) * HX + hx)[keep]] = y1[keep]
        # Phase 2: pixel r's window from Y at its nine taps.
        r = torch.arange(g["M2"])
        pos = (r // P * HY + r % P // tx) * HX + r % P % tx
        taps = torch.tensor([(t // 3) * HX + t % 3 for t in range(9)])
        cols = Y[pos[:, None] + taps[None, :]].reshape(g["M2"], 9 * Cm)
        y2 = torch.relu(cols @ w2r.T + f(b2)).to(dt).double()
        # Phase 3: the pixels inside the image, every rank's output slice.
        i, rr = r // P, r % P
        gy, gx = oy + rr // tx, ox + rr % tx
        ok = (img0 + i < B) & (gy < H) & (gx < W)
        for q in range(cs):
            co = slice(q * g["nc"], min(C, (q + 1) * g["nc"]))
            res = f(x[(img0 + i)[ok], gy[ok], gx[ok], co])
            out[(img0 + i)[ok], gy[ok], gx[ok], co] = torch.relu(
                y2[ok] @ f(w3[co]).T + f(b3[co]) + res)
    return out.to(dt)


# (B, H, W, C, Cm, cluster, slice, images, tile_h, tile_w): whole images, two
# a cluster past B; tiles that divide and that do not, a box clamped at both
# edges, clusters of 2 and 3 with a part-filled last slice.
MODEL_CASES = ((3, 5, 7, 24, 16, 1, 64, 2, 5, 7), (2, 9, 9, 32, 8, 1, 64, 1, 4, 4),
               (1, 9, 11, 16, 136, 3, 64, 1, 3, 5), (2, 6, 6, 40, 72, 2, 64, 1, 6, 2),
               (1, 7, 7, 64, 160, 2, 128, 1, 7, 7))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda s: "x".join(map(str, s)))
def test_plain_model_of_the_decomposition_matches_the_plain_version(case, dtype):
    B, H, W, C, Cm, cs, ns, ni, ty, tx = case
    x, ws = bottleneck_inputs("cpu", B, H, W, C, Cm, dtype, seed=5)
    plan = dict(cluster=cs, slice=ns, images=ni, tile_h=ty, tile_w=tx, mb1=4, stages=2)
    got = _kernel_model(x, *ws, plan).float()
    want = fused_bottleneck_reference(x, *ws).float()
    assert bool(torch.isfinite(got).all())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def test_kernel_plan_refuses_unaligned_channels():
    with pytest.raises(ValueError, match="multiples"):
        kernel_plan(1, 4, 4, 20, 8, torch.float32, 132, H100_ACTIVE)
    plan = kernel_plan(1, 4, 4, 24, 8, torch.float32, 132, H100_ACTIVE)
    assert math.isfinite(plan["cost_clocks"])


def test_kernel_operands_pad_channels_and_realign():
    """The operands the wrapper hands the kernel: C and Cm padded with zeros
    to multiples of CHANNEL_ALIGN give the same outputs in the original
    channels, and a misaligned w2 is copied to a 16-byte boundary in
    channels_last memory."""
    x, ws = bottleneck_inputs("cpu", 2, 5, 7, 22, 6, torch.float32, seed=1)
    ops = _kernel_operands(x, *ws)
    assert [t.shape[-1] for t in (ops[0], ops[1])] == [24, 24] and ops[1].shape[0] == 8
    assert ops[3].is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(fused_bottleneck_reference(*ops)[..., :22],
                       fused_bottleneck_reference(x, *ws))
    x, ws = bottleneck_inputs("cpu", 1, 4, 4, 16, 8, torch.float32, seed=2)
    buf = torch.empty(ws[2].numel() + 1)
    w2 = buf[1:].view(8, 3, 3, 8).permute(0, 3, 1, 2)  # channels_last, 4 bytes off
    w2.copy_(ws[2])
    assert w2.data_ptr() % 16 != 0
    ops = _kernel_operands(x, ws[0], ws[1], w2, *ws[3:])
    assert ops[3].data_ptr() % 16 == 0 and torch.equal(ops[3], ws[2])
    assert ops[3].is_contiguous(memory_format=torch.channels_last)
