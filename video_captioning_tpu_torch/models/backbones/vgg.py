"""VGG16 feature extractor (ReLU(fc7), 4096-d) as an nn.Module.

Counterpart of video_captioning_tpu/models/backbones/vgg.py. The module
carries torchvision's parameter names (``features.N.weight``,
``classifier.0`` / ``classifier.3``), so a torchvision state dict loads as
it is (its ``classifier.6`` fc8 is not part of the extractor). The conv
stack runs in NCHW kept in ``torch.channels_last`` memory; there is no
kernel here: ``F.conv2d`` / ``F.linear`` stand where the JAX package uses
XLA. ``apply_vgg16`` takes NHWC images, as the JAX function does.
"""

from __future__ import annotations

import torch
from torch import nn

Tensor = torch.Tensor

# Conv plan "D": (out_channels per conv, 'M' = 2x2 maxpool)
VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]


def conv_feature_indices():
    """Index in torchvision's ``features`` Sequential of each conv (pools and
    ReLUs take indices too)."""
    idx, li = [], 0
    for item in VGG16_PLAN:
        if item == "M":
            li += 1
        else:
            idx.append(li)
            li += 2  # conv + relu
    return idx


class VGG16(nn.Module):
    """torchvision's vgg16 up to ReLU(fc7), in eval semantics."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in VGG16_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(),
        )

    def forward(self, x: Tensor) -> Tensor:
        """x: (B, 3, H, W) normalized -> (B, 4096). Any H, W >= 32: the map is
        adaptively pooled to 7x7 (identity at 224x224), as torchvision does."""
        x = self.avgpool(self.features(x))
        # Flatten in (C, H, W) order, as torch does; reshape copies a
        # channels_last map into that order.
        return self.classifier(torch.flatten(x, 1))


def apply_vgg16(model: VGG16, images: Tensor) -> Tensor:
    """images: (B, H, W, 3) normalized float -> (B, 4096) ReLU(fc7)."""
    return model(images.permute(0, 3, 1, 2))
