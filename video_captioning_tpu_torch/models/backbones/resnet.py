"""ResNet50 feature extractor (2048-d pooled): the eval-mode model, BN
folding, the space-to-depth stem and the folded / fused forward.

Counterpart of video_captioning_tpu/models/backbones/resnet.py. ``ResNet50``
carries torchvision's parameter names (``conv1``, ``bn1``,
``layerS.B.convK``, ``downsample.0/1``) with explicit symmetric padding, and
its forward is the JAX package's ``apply_resnet50`` (BN on frozen
statistics). Activations are NCHW in ``torch.channels_last`` memory, so the
kernels see NHWC, as the TPU kernels do, and cuDNN runs NHWC convs.

``fold_bn`` returns the JAX package's folded tree with torch layouts: a
1x1 conv is a ``w`` matrix (Cout, Cin) (the matmul kernels' layout), a
larger conv a ``kernel`` (Cout, Cin, kh, kw) in channels_last memory, each
with its bias ``b``. ``apply_resnet50_folded`` with ``use_pallas`` runs the
stride-1 identity blocks through the fused-bottleneck kernel
(ops/bottleneck.py).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.bottleneck import fused_bottleneck

Tensor = torch.Tensor

BLOCKS_PER_STAGE = [3, 4, 6, 3]
STAGE_WIDTH = [64, 128, 256, 512]
EXPANSION = 4
BN_EPS = 1e-5


def block_stride(stage: int, block: int) -> int:
    return 2 if (stage > 0 and block == 0) else 1


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        cout = width * EXPANSION
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                         nn.BatchNorm2d(cout, eps=BN_EPS))
                           if downsample else None)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(y + identity)


class ResNet50(nn.Module):
    """torchvision's resnet50 without its fc: the [3, 4, 6, 3] bottleneck
    stack and the global average pool."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        cin = 64
        for s, (n, width) in enumerate(zip(BLOCKS_PER_STAGE, STAGE_WIDTH)):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, width, block_stride(s, b), b == 0))
                cin = width * EXPANSION
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def stages(self):
        return [getattr(self, f"layer{s + 1}") for s in range(len(BLOCKS_PER_STAGE))]

    def forward(self, x: Tensor) -> Tensor:
        """x: (B, 3, H, W) normalized -> (B, 2048)."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage in self.stages():
            x = stage(x)
        return x.mean(dim=(2, 3))


def apply_resnet50(model: ResNet50, images: Tensor) -> Tensor:
    """images: (B, H, W, 3) normalized float -> (B, 2048)."""
    return model(images.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# Folded / fused inference path: every frozen BN is an affine folded into
# the conv before it, g = scale * rsqrt(var + eps); kernel' = kernel * g;
# bias' = bias - mean * g.


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Dict[str, Tensor]:
    g = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    kernel = conv.weight * g[:, None, None, None]
    bias = bn.bias - bn.running_mean * g
    if kernel.shape[2:] == (1, 1):
        return {"w": kernel.flatten(1).contiguous(), "b": bias}
    return {"kernel": kernel.contiguous(memory_format=torch.channels_last), "b": bias}


@torch.no_grad()
def fold_bn(model: ResNet50) -> Dict:
    """Fold the frozen BN statistics into the convs -> the folded tree
    (``conv1``, ``conv1_s2d``, ``stages`` of blocks with ``conv1``,
    ``conv2``, ``conv3`` and, in a stage's first block, ``downsample``)."""
    stem = _fold(model.conv1, model.bn1)
    folded: Dict = {"conv1": stem,
                    "conv1_s2d": {"kernel": _s2d_stem_kernel(stem["kernel"]), "b": stem["b"]},
                    "stages": []}
    for stage in model.stages():
        blocks = []
        for blk in stage:
            fb = {"conv1": _fold(blk.conv1, blk.bn1), "conv2": _fold(blk.conv2, blk.bn2),
                  "conv3": _fold(blk.conv3, blk.bn3)}
            if blk.downsample is not None:
                fb["downsample"] = _fold(blk.downsample[0], blk.downsample[1])
            blocks.append(fb)
        folded["stages"].append(blocks)
    return folded


def _s2d_stem_kernel(kernel: Tensor) -> Tensor:
    """(cout, cin, 7, 7) stride-2 stem kernel -> (cout, 4*cin, 4, 4) for a
    stride-1 VALID conv over the 2x2 space-to-depth input: the 7x7 kernel
    padded to 8x8 with a zero top row and left column, its taps regrouped by
    cell. Exact: the added taps are zeros."""
    cout, cin, kh, kw = kernel.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"the s2d stem takes a 7x7 kernel, got {kh}x{kw}")
    hwio = F.pad(kernel.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))  # (8, 8, cin, cout)
    hwio = (hwio.reshape(4, 2, 4, 2, cin, cout)    # (cy, py, cx, px, cin, cout)
            .permute(0, 2, 1, 3, 4, 5)             # (cy, cx, py, px, cin, cout)
            .reshape(4, 4, 4 * cin, cout))
    return hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _s2d_stem_input(images: Tensor) -> Tensor:
    """(B, H, W, C) -> the (B, (H+6)/2, (W+6)/2, 4C) padded space-to-depth
    view, channels ordered (py, px, c) as the s2d kernel's."""
    xq = F.pad(images, (0, 0, 4, 2, 4, 2))
    B, H, W, C = xq.shape
    return (xq.reshape(B, H // 2, 2, W // 2, 2, C)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(B, H // 2, W // 2, 4 * C))


def conv_folded(p: Dict[str, Tensor], x: Tensor, stride: int = 1) -> Tensor:
    """A folded conv with its bias: a 1x1 ``w`` matrix or a ``kernel``,
    padded (k - 1) / 2 on each side as torch's convs are."""
    if "w" in p:
        return F.conv2d(x, p["w"][:, :, None, None], p["b"], stride=stride)
    pad = (p["kernel"].shape[-1] - 1) // 2
    return F.conv2d(x, p["kernel"], p["b"], stride=stride, padding=pad)


def _bottleneck_folded(block: Dict, x: Tensor, stride: int, fuse: bool) -> Tensor:
    if fuse and stride == 1 and "downsample" not in block:
        # Every stride-1 identity block (12 of ResNet50's 16) runs as one
        # kernel; it tiles space, so unlike the TPU kernel it takes every
        # shape and needs no batch-tile rule.
        out = fused_bottleneck(
            x.permute(0, 2, 3, 1),
            block["conv1"]["w"], block["conv1"]["b"],
            block["conv2"]["kernel"], block["conv2"]["b"],
            block["conv3"]["w"], block["conv3"]["b"],
        )
        return out.permute(0, 3, 1, 2)
    y = F.relu(conv_folded(block["conv1"], x))
    y = F.relu(conv_folded(block["conv2"], y, stride))
    identity = conv_folded(block["downsample"], x, stride) if "downsample" in block else x
    return F.relu(conv_folded(block["conv3"], y) + identity)


def stem_folded(folded: Dict, images: Tensor, stem_s2d: bool = False) -> Tensor:
    """The folded stem (conv + bias + ReLU, 3x3/2 max-pool): (B, H, W, 3)
    -> (B, 64, H/4, W/4) channels_last."""
    if stem_s2d:
        p = folded["conv1_s2d"]
        x = F.conv2d(_s2d_stem_input(images).permute(0, 3, 1, 2), p["kernel"], p["b"])
    else:
        p = folded["conv1"]
        x = F.conv2d(images.permute(0, 3, 1, 2), p["kernel"], p["b"], stride=2, padding=3)
    return F.max_pool2d(F.relu(x), 3, 2, 1)


def apply_resnet50_folded(folded: Dict, images: Tensor, *, use_pallas: bool = True,
                          stem_s2d: bool = False, fuse_stages: tuple = (0, 1, 2, 3)) -> Tensor:
    """BN-folded inference forward: (B, H, W, 3) normalized -> (B, 2048).
    ``use_pallas`` runs the stride-1 identity blocks of ``fuse_stages``
    through the fused-bottleneck kernel (its plain version on the CPU)."""
    x = stem_folded(folded, images, stem_s2d)
    for s, blocks in enumerate(folded["stages"]):
        for b, block in enumerate(blocks):
            x = _bottleneck_folded(block, x, block_stride(s, b),
                                   use_pallas and s in fuse_stages)
    return x.mean(dim=(2, 3))
