"""Plain PyTorch ResNet-50 feature extractor: uint8 frames -> the 2048-d
global average pool, with BN on its frozen statistics (not folded).

torchvision's architecture (stride on the 3x3 conv, a projection shortcut in
each stage's first block), the ImageNet normalisation of the uint8 frames
(/255, mean, std) and float32 throughout; whether convs run in TF32 is the
caller's choice (``torch.backends.cudnn.allow_tf32``). Weights are the
benchmark's torchvision-named state dict; nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

BLOCKS = (3, 4, 6, 3)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
EPS = 1e-5


def _bn(w: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
    scale = w[f"{name}.weight"] / torch.sqrt(w[f"{name}.running_var"] + EPS)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def forward(w: Dict[str, Tensor], frames: Tensor) -> Tensor:
    """frames (N, H, W, 3) uint8 -> (N, 2048) float32."""
    mean = torch.tensor(MEAN, device=frames.device)
    std = torch.tensor(STD, device=frames.device)
    x = ((frames.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    x = F.relu(_bn(w, "bn1", F.conv2d(x, w["conv1.weight"], stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for s, n in enumerate(BLOCKS):
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            stride = 2 if s > 0 and b == 0 else 1
            y = F.relu(_bn(w, f"{p}.bn1", F.conv2d(x, w[f"{p}.conv1.weight"])))
            y = F.relu(_bn(w, f"{p}.bn2", F.conv2d(y, w[f"{p}.conv2.weight"], stride=stride,
                                                   padding=1)))
            y = _bn(w, f"{p}.bn3", F.conv2d(y, w[f"{p}.conv3.weight"]))
            if b == 0:
                x = _bn(w, f"{p}.downsample.1",
                        F.conv2d(x, w[f"{p}.downsample.0.weight"], stride=stride))
            x = F.relu(y + x)
    return x.mean(dim=(2, 3))


def features(w: Dict[str, Tensor], frames: Tensor, block: int = 32) -> Tensor:
    """``forward`` over blocks of ``block`` frames."""
    return torch.cat([forward(w, frames[i:i + block]) for i in range(0, frames.shape[0], block)])


def judge(w: Dict[str, Tensor], frames: Tensor, served: Tensor) -> Dict[str, Tensor]:
    """Per frame, ||served - reference|| / ||reference||."""
    ref = features(w, frames)
    return {"feature_rel_err": (served - ref).norm(dim=1) / ref.norm(dim=1)}
