"""Operations and bytes of one launch of each of the port's kernels, from
its shapes, and the least time the card could take for them.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; intermediates a kernel keeps to itself are
not counted. ``bound_s`` is the larger of operations over the floating-point
peak and bytes over the memory rate (``peaks.json``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
F32 = 4
BF16 = 2


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAKS["flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def lstm_seq(T: int, ND: int, B: int, H: int) -> Tuple[float, float]:
    """The encoder's recurrence over T steps, ND directions: xproj (T, ND, B,
    4H) float32 and W_hh (ND, H, 4H) bfloat16 in; outputs (T, ND, B, H) and
    the last h and c out."""
    ops = 2.0 * T * ND * B * H * 4 * H + 10.0 * T * ND * B * H
    nbytes = (T * ND * B * 4 * H * F32 + ND * H * 4 * H * BF16
              + T * ND * B * H * F32 + 2 * ND * B * H * F32)
    return ops, nbytes


def topk2d_lse(N: int, V: int, k: int) -> Tuple[float, float]:
    """Top-k and logsumexp of each of N rows of V float32 logits."""
    return 3.0 * N * V, N * V * F32 + N * k * 8 + N * F32


def beam_cross_attention(B: int, K: int, S: int, D: int, heads: int) -> Tuple[float, float]:
    """B*K float32 queries against a clip's S frames of keys and values
    (shared by its K beams), a float32 mask; context and head-mean weights
    out."""
    ops = 4.0 * B * K * S * D + 5.0 * B * K * heads * S
    nbytes = (B * K * D + 2 * B * S * D + B * S) * F32 + (B * K * D + B * K * S) * F32
    return ops, nbytes


def fused_bottleneck(B: int, H: int, W: int, C: int, Cm: int) -> Tuple[float, float]:
    """One stride-1 identity bottleneck (1x1 C->Cm, 3x3 Cm->Cm, 1x1 Cm->C,
    the residual, three ReLUs), float32 NHWC: x in (also the residual), y
    out, the folded weights and biases in."""
    M = B * H * W
    ops = 2.0 * M * (C * Cm + 9 * Cm * Cm + Cm * C) + 4.0 * M * C
    nbytes = (2 * M * C + C * Cm + 9 * Cm * Cm + Cm * C + 2 * Cm + C) * F32
    return ops, nbytes


# ResNet-50's stride-1 identity blocks a B-frame forward sends through
# fused_bottleneck at 224 x 224: (H = W, C, Cm, blocks).
RESNET50_IDENTITY_BLOCKS = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 5),
                            (7, 2048, 512, 2))


def resnet50_fused_forward(B: int) -> Tuple[float, float, int]:
    """Operations, bytes and launches of fused_bottleneck in one B-frame
    forward (224 x 224)."""
    ops = nbytes = 0.0
    launches = 0
    for hw, C, Cm, n in RESNET50_IDENTITY_BLOCKS:
        o, b = fused_bottleneck(B, hw, hw, C, Cm)
        ops, nbytes, launches = ops + n * o, nbytes + n * b, launches + n
    return ops, nbytes, launches
