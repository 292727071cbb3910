"""The dW_hh launch's plan (``ops/lstm_seq_train.py:dw_plan``) on the CPU,
and a plain model of the kernel's decomposition against the plain backward.

The dW_hh launch (csrc/lstm_seq_train.cu, lstm_seq_dw_kernel) runs one CTA
of two warpgroups an SM on a DW_M x DW_N tile of one direction's (H, 4H)
product; the reduction's rows (t - 1, b), t >= 1, arrive by the TMA in
stages of tbox steps x bbox rows (at most DW_K), split over the ``parts``
CTAs of a thread block cluster, and each rank adds the parts of the tile
rows it owns in rank order. These tests hold the plan to the H100's SMs
and shared memory, to covering every row, column and reduction row once,
and the decomposition (boxes zero-filled past B and T, parts added in rank
order) to the plain version's dW_hh on ragged masks. The wrapper passes
this plan to the C entry, which validates it; the kernel itself is held to
its plain version on the card by chip_smoke.py and compare_lstm.py.
"""

import numpy as np
import pytest
import torch

from video_captioning_tpu_torch.ops.lstm_seq import CARD_SMS, SMEM_LIMIT
from video_captioning_tpu_torch.ops.lstm_seq_train import (
    DW_K,
    DW_M,
    DW_MAX_PARTS,
    DW_MIN_STEPS,
    DW_N,
    dw_plan,
    lstm_seq_train_bwd_reference,
    lstm_seq_train_fwd_reference,
)


def _check(T, B, H, ND, sms=CARD_SMS):
    plan = dw_plan(T, B, H, ND, sms)
    where = (T, B, H, ND, plan)
    tiles, steps, parts = plan["tiles"], plan["steps"], plan["parts"]
    bbox, tbox, nbc = plan["bbox"], plan["tbox"], plan["nbc"]
    # Every output element once: tiles of DW_M x DW_N over (H, 4H), a set a
    # direction.
    assert tiles == -(-H // DW_M) * -(-4 * H // DW_N) * ND, where
    # Every reduction row once: a stage's box of tbox steps x bbox rows fits
    # DW_K, nbc boxes cover a step's B rows, the stages cover T - 1 steps.
    assert 1 <= bbox * tbox <= DW_K and (tbox == 1 or bbox == B), where
    assert nbc * bbox >= B > (nbc - 1) * bbox, where
    assert steps == -(-(T - 1) // tbox) * nbc, where
    assert steps * tbox * bbox >= (T - 1) * B, where
    # The parts take part_steps stages each, the last possibly short or empty.
    assert parts * plan["part_steps"] >= steps, where
    assert parts == 1 or (parts - 1) * plan["part_steps"] < steps, where
    # A power of two up to the cluster limit, one wave at one CTA an SM,
    # each part long enough, and the most that satisfies all three.
    assert parts in (1, 2, 4, 8) and parts <= DW_MAX_PARTS, where
    assert parts == 1 or (plan["ctas"] == tiles * parts <= sms
                          and steps >= parts * DW_MIN_STEPS), where
    if parts < DW_MAX_PARTS:
        assert tiles * parts * 2 > sms or steps < parts * 2 * DW_MIN_STEPS, where
    # The ranks' rows of a tile: whole, and every row owned once.
    assert plan["own"] * parts == DW_M, where
    assert plan["smem"] <= SMEM_LIMIT, where
    return plan


@pytest.mark.parametrize("T", [1, 2, 80])
@pytest.mark.parametrize("B", [1, 32, 128])
@pytest.mark.parametrize("H", [8, 512, 600, 1024])
@pytest.mark.parametrize("ND", [1, 2])
def test_dw_plan_fits_and_covers_every_row(T, B, H, ND):
    _check(T, B, H, ND)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
@pytest.mark.parametrize("H", [8, 40, 128, 264, 512, 1000])
def test_dw_plan_on_other_cards(sms, H):
    for B in (1, 3, 32, 37, 128):
        _check(80, B, H, 2, sms)


def test_dw_plan_main_shapes():
    """H = 512: 64 tiles, two parts a cluster (128 CTAs in one wave); the
    wide form's H = 1024: 256 tiles, one part; T = 1: no rows, one part."""
    assert (_check(80, 32, 512, 2)["parts"], _check(80, 128, 512, 2)["parts"]) == (2, 2)
    assert _check(80, 32, 512, 2)["ctas"] == 128
    assert _check(80, 32, 1024, 2)["parts"] == 1
    assert _check(1, 128, 512, 2)["parts"] == _check(1, 128, 512, 2)["steps"] + 1 == 1
    small = _check(80, 32, 40, 2)
    assert small["parts"] == DW_MAX_PARTS and small["ctas"] == 2 * DW_MAX_PARTS


def dw_by_plan(h_keep, dg, plan):
    """The launch's decomposition in plain PyTorch: for each tile and part,
    float32 sums of exact bf16 products over the part's stages, a stage the
    rows (t - 1, b) of its box (steps and rows past T and B zero, as the
    TMA fills them), then the parts added in rank order."""
    T, ND, B, H = h_keep.shape
    bbox, tbox, nbc = plan["bbox"], plan["tbox"], plan["nbc"]
    a = h_keep.to(torch.bfloat16).float()
    b = dg.to(torch.bfloat16).float()

    def box(x, t0, b0):  # (ND, tbox * bbox, C): steps t0 .., rows b0 .., zeros outside
        out = x.new_zeros((tbox, ND, bbox, x.shape[-1]))
        tt, bb = min(tbox, T - t0), min(bbox, B - b0)
        if tt > 0 and bb > 0:
            out[:tt, :, :bb] = x[t0:t0 + tt, :, b0:b0 + bb]
        return out.transpose(0, 1).reshape(ND, tbox * bbox, x.shape[-1])

    dw = torch.zeros((ND, H, 4 * H))
    for m0 in range(0, H, DW_M):
        for n0 in range(0, 4 * H, DW_N):
            total = None
            for r in range(plan["parts"]):
                part = torch.zeros((ND, min(DW_M, H - m0), min(DW_N, 4 * H - n0)))
                for s in range(r * plan["part_steps"], min((r + 1) * plan["part_steps"],
                                                           plan["steps"])):
                    t0, b0 = 1 + s // nbc * tbox, s % nbc * bbox
                    ha = box(a, t0 - 1, b0)[:, :, m0:m0 + DW_M]
                    gb = box(b, t0, b0)[:, :, n0:n0 + DW_N]
                    part += torch.bmm(ha.transpose(1, 2), gb)
                total = part if total is None else total + part
            dw[:, m0:m0 + DW_M, n0:n0 + DW_N] = total
    return dw


@pytest.mark.parametrize("T,B,H", [(1, 3, 40), (2, 1, 8), (5, 37, 40), (9, 32, 264),
                                   (80, 3, 40), (7, 70, 16)])
def test_dw_decomposition_matches_the_plain_backward(T, B, H):
    """The plan's tiles, stages and parts, summed as the kernel sums them,
    give the plain backward's dW_hh on a ragged mask (row 0 full, the last
    row of length 1), within float32 rounding of the sums' order."""
    rng = np.random.default_rng(T * 1000 + B * 10 + H)
    ND = 2
    xproj = torch.from_numpy(rng.standard_normal((T, ND, B, 4 * H)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (ND, H, 4 * H)) / H ** 0.5).astype(np.float32))
    w = w.to(torch.bfloat16)
    lengths = rng.integers(1, T + 1, B)
    lengths[0], lengths[-1] = T, 1
    mask = torch.from_numpy((np.arange(T)[None, :] < lengths[:, None]).astype(np.float32))
    gact, h_keep, c_keep = lstm_seq_train_fwd_reference(xproj, w, mask)[3:]
    douts = torch.from_numpy(rng.standard_normal((T, ND, B, H)).astype(np.float32))
    dxproj, dw = lstm_seq_train_bwd_reference(gact, h_keep, c_keep, w, mask, douts)
    plan = dw_plan(T, B, H, ND)
    got = dw_by_plan(h_keep, dxproj, plan)
    scale = max(dw.abs().max().item(), 1e-30)
    assert (got - dw).abs().max().item() <= 1e-5 * scale
    if T == 1:
        assert not got.any() and not dw.any()
