"""W8A8 static post-training quantization of the VGG16 extractor.

Counterpart of video_captioning_tpu/models/backbones/vgg_int8.py: the same
scheme and helpers as :mod:`resnet_int8`. One activation scale per conv
input (13) and the fc6 and fc7 inputs; the 2x2 max-pools run on int8
values; the adaptive average pool (identity at 224x224) runs in float32
between the conv stack and fc6. No kernel: the convs and both fc layers
are exact int32 products (im2col + ``torch._int_mm``), as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F

from .resnet_int8 import (
    _QMAX,
    _maxpool_i8,
    _scalar,
    aggregate_scales,
    conv_i8,
    int_matmul,
    quant_w,
    quantile_amax,
    requant,
)
from .vgg import VGG16, VGG16_PLAN

Tensor = torch.Tensor


def _convs(model: VGG16):
    return [m for m in model.features if isinstance(m, torch.nn.Conv2d)]


def _quant_fc(kernel: Tensor) -> Dict[str, Tensor]:
    """(Cin, Cout) fc kernel -> int8 + per-cout scale."""
    amax = kernel.abs().amax(dim=0)
    scale = amax.clamp_min(1e-8) / _QMAX
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "scale": scale.float()}


@torch.no_grad()
def _collect_forward(model: VGG16, images: Tensor, q: float) -> Dict[str, Tensor]:
    """fp32 forward -> {site: amax quantile}."""
    amax: Dict[str, Tensor] = {}
    x = images.permute(0, 3, 1, 2)
    convs = iter(_convs(model))
    ci = 0
    for item in VGG16_PLAN:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            amax[f"c{ci}_in"] = quantile_amax(x, q)
            x = F.relu(next(convs)(x))
            ci += 1
    x = torch.flatten(model.avgpool(x), 1)
    amax["fc6_in"] = quantile_amax(x, q)
    amax["fc7_in"] = quantile_amax(F.relu(model.classifier[0](x)), q)
    return amax


def calibrate_vgg16_int8(model: VGG16, calib_images: Tensor, *, batch_size: int = 32,
                         quantile: float = 0.9995) -> Dict[str, float]:
    """Per-site activation scales from fp32 forwards (see resnet_int8)."""
    return aggregate_scales(lambda imgs: _collect_forward(model, imgs, quantile),
                            calib_images, batch_size)


@torch.no_grad()
def quantize_vgg16_int8(model: VGG16, act_scales: Mapping[str, float]) -> Dict:
    """fp32 model + activation scales -> the quantized tree in the JAX
    package's layout (HWIO conv kernels, (Cin, Cout) fc kernels), on the CPU."""
    convs: List[dict] = [
        {**quant_w(c.weight.detach().float().cpu().permute(2, 3, 1, 0)),
         "b": c.bias.detach().float().cpu(), "s_in": _scalar(act_scales[f"c{i}_in"])}
        for i, c in enumerate(_convs(model))
    ]

    def fc(layer, site):
        return {**_quant_fc(layer.weight.detach().float().cpu().t()),
                "b": layer.bias.detach().float().cpu(), "s_in": _scalar(act_scales[site])}

    return {"convs": convs, "fc6": fc(model.classifier[0], "fc6_in"),
            "fc7": fc(model.classifier[3], "fc7_in")}


def _fc_i8(x: Tensor, fc: Dict, relu: bool = True) -> Tensor:
    acc = int_matmul(requant(x, fc["s_in"]), fc["m"])
    y = acc.float() * (fc["scale"] * fc["s_in"]) + fc["b"]
    return F.relu(y) if relu else y


@torch.no_grad()
def apply_vgg16_int8(run: Dict, images: Tensor) -> Tensor:
    """(B, H, W, 3) normalized float -> (B, 4096) ReLU(fc7), W8A8. ``run``:
    ``int8_run_params`` of the quantized tree."""
    convs = run["convs"]
    xq = requant(images.float(), convs[0]["s_in"])
    x_last = None  # the final conv's float ReLU output
    ci = 0
    for item in VGG16_PLAN:
        if item == "M":
            if x_last is not None:
                # The plan's final pool follows the last conv, outside the
                # int8 domain.
                x_last = F.max_pool2d(x_last, 2, 2)
            else:
                xq = _maxpool_i8(xq, 2, 2, 0)
        else:
            c = convs[ci]
            y = F.relu(conv_i8(xq, c).float() * (c["scale"] * c["s_in"]) + c["b"])
            ci += 1
            if ci < len(convs):
                # Requant straight to the next conv's input scale: a pool in
                # between commutes with the monotone quantization.
                xq = requant(y, convs[ci]["s_in"])
            else:
                x_last = y.permute(0, 3, 1, 2)
    x = torch.flatten(F.adaptive_avg_pool2d(x_last, (7, 7)), 1)
    return _fc_i8(_fc_i8(x, run["fc6"]), run["fc7"])
