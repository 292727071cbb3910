"""W8A8 static post-training quantization of the ResNet50 extractor.

Counterpart of video_captioning_tpu/models/backbones/resnet_int8.py, the
same scheme: per-output-channel symmetric int8 weights from the BN-folded
kernels, per-site per-tensor activation scales calibrated as a high
quantile of |x| over fp32 folded forwards, int8 x int8 convs with exact
int32 accumulation, dequant / bias / residual / ReLU / requant epilogues,
int8 activations between the convs, max-pools on int8 values.

``quantize_resnet50_int8`` returns the JAX package's quantized tree (HWIO
int8 kernels, scalar scales), which is what a ``vcw-int8-v1`` file holds;
``int8_run_params`` turns it into the layout the forward runs on. Convs
outside the kernels (the stem, the 3x3s, the downsamples) run as im2col
plus ``torch._int_mm`` (ops/int8_matmul.py:int_matmul), exact where a
float32 accumulation would not be (K * 127^2 reaches 7.4e7 > 2^24). With
``use_pallas_1x1`` the 1x1 convs of every block run through the int8
kernels (ops/int8_matmul.py).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.int8_matmul import (
    int8_matmul_requant,
    int8_matmul_residual_requant,
    int_matmul,
    requant,
)
from ..weights import tree_map
from .resnet import block_stride, conv_folded, stem_folded

Tensor = torch.Tensor

_QMAX = 127.0


# ---------------------------------------------------------------------------
# Calibration.


def quantile_amax(x: Tensor, q: float) -> Tensor:
    """jnp.quantile(|x|, q) with its linear interpolation, the position
    q * (n - 1) taken in float32 as jnp.quantile takes it. torch.quantile
    refuses inputs above 2^24 elements, so the two order statistics come
    from a top-k of the tail."""
    a = x.detach().abs().reshape(-1).float()
    n = a.numel()
    pos = np.float32(q) * np.float32(n - 1)
    lo = int(np.floor(pos))
    hi = min(int(np.ceil(pos)), n - 1)
    w_hi = np.float32(pos - np.float32(lo))
    top = torch.topk(a, n - lo).values  # descending: sorted[lo] is the last
    return top[-1] * float(np.float32(1) - w_hi) + top[n - 1 - hi] * float(w_hi)


@torch.no_grad()
def _collect_forward(folded: Dict, images: Tensor, q: float) -> Dict[str, Tensor]:
    """fp32 folded forward -> {site: amax quantile}: the input of every
    quantized conv and the block outputs."""
    amax: Dict[str, Tensor] = {"stem_in": quantile_amax(images, q)}
    x = stem_folded(folded, images)
    for si, blocks in enumerate(folded["stages"]):
        for bi, block in enumerate(blocks):
            stride, p = block_stride(si, bi), f"s{si}b{bi}"
            amax[f"{p}_in"] = quantile_amax(x, q)
            y = F.relu(conv_folded(block["conv1"], x))
            amax[f"{p}_y1"] = quantile_amax(y, q)
            y = F.relu(conv_folded(block["conv2"], y, stride))
            amax[f"{p}_y2"] = quantile_amax(y, q)
            identity = conv_folded(block["downsample"], x, stride) if "downsample" in block else x
            x = F.relu(conv_folded(block["conv3"], y) + identity)
    amax["out"] = quantile_amax(x, q)
    return amax


def aggregate_scales(collect, calib_images: Tensor, batch_size: int) -> Dict[str, float]:
    """Run ``collect`` over ``batch_size`` chunks, keep each site's largest
    quantile (the quantile of each chunk, not of their union, as the JAX
    package takes it) -> {site: max(amax, 1e-8) / 127}."""
    agg: Dict[str, float] = {}
    for i in range(0, calib_images.shape[0], batch_size):
        amax = collect(calib_images[i:i + batch_size])
        for site, v in zip(amax, torch.stack(list(amax.values())).tolist()):
            agg[site] = max(agg.get(site, 0.0), v)
    return {site: max(v, 1e-8) / _QMAX for site, v in agg.items()}


def calibrate_resnet50_int8(folded: Dict, calib_images: Tensor, *, batch_size: int = 32,
                            quantile: float = 0.9995) -> Dict[str, float]:
    """Per-site activation scales from fp32 folded forwards over
    (N, H, W, 3) ImageNet-normalized float32 frames."""
    return aggregate_scales(lambda imgs: _collect_forward(folded, imgs, quantile),
                            calib_images, batch_size)


# ---------------------------------------------------------------------------
# Weight quantization (per-output-channel symmetric, from folded kernels).


def quant_w(kernel: Tensor) -> Dict[str, Tensor]:
    """HWIO kernel (or a (Cin, Cout) matrix) -> int8 + per-cout scale."""
    if kernel.dim() == 2:
        kernel = kernel.reshape(1, 1, *kernel.shape)
    amax = kernel.abs().amax(dim=(0, 1, 2))
    scale = amax.clamp_min(1e-8) / _QMAX
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "scale": scale.float()}


def _hwio(p: Dict[str, Tensor]) -> Tensor:
    """A folded conv in the JAX layout: HWIO, or (Cin, Cout) for a 1x1."""
    return p["w"].t() if "w" in p else p["kernel"].permute(2, 3, 1, 0)


def _scalar(v: float) -> Tensor:
    return torch.tensor(v, dtype=torch.float32)


def quantize_resnet50_int8(folded: Dict, act_scales: Mapping[str, float]) -> Dict:
    """Folded fp32 tree + activation scales -> the quantized tree in the JAX
    package's layout (what ``save_int8`` writes), on the CPU."""
    folded = tree_map(lambda t: t.detach().cpu(), folded)

    def conv(p):
        return {**quant_w(_hwio(p).float()), "b": p["b"].float()}

    qp: Dict = {"conv1": conv(folded["conv1"]), "s_stem_in": _scalar(act_scales["stem_in"]),
                "stages": [], "act_scales": {k: _scalar(v) for k, v in act_scales.items()}}
    for si, blocks in enumerate(folded["stages"]):
        qblocks: List[dict] = []
        for bi, block in enumerate(blocks):
            p = f"s{si}b{bi}"
            qb = {"conv1": conv(block["conv1"]), "conv2": conv(block["conv2"]),
                  "conv3": conv(block["conv3"]), "s_in": _scalar(act_scales[f"{p}_in"]),
                  "s_y1": _scalar(act_scales[f"{p}_y1"]), "s_y2": _scalar(act_scales[f"{p}_y2"])}
            if "downsample" in block:
                qb["downsample"] = conv(block["downsample"])
            qblocks.append(qb)
        qp["stages"].append(qblocks)
    return qp


def int8_run_params(qp, device) -> Dict:
    """The quantized tree (JAX layout; numpy or torch leaves) -> the tree
    the forward runs on: each ``q`` becomes ``m``, the (Cout, kh*kw*Cin)
    int8 matrix in (dy, dx, ci) order (a fc's (Cin, Cout) its transpose),
    with its kernel size ``k``; scales and biases float32 on ``device``;
    scalar scales (``s_in`` beside a VGG16 layer's ``q`` too) Python floats.
    Each ResNet50 block's conv1 and conv3 also keep ``scale_x``, their
    ``scale`` times their input's scale (``s_in``, ``s_y2``): the dequant
    scale the int8 kernels take, made once here by the float32 product a
    call would make, on the same device, so with the same bits."""
    run = _run_tree(qp, device)
    if isinstance(run, dict):
        for blocks in run.get("stages", ()):
            for block in blocks:
                for conv, s_x in (("conv1", "s_in"), ("conv3", "s_y2")):
                    block[conv]["scale_x"] = block[conv]["scale"] * block[s_x]
    return run


def _run_tree(qp, device):
    if isinstance(qp, dict):
        if "q" in qp:
            q = torch.from_numpy(np.array(qp["q"]))
            if q.dim() == 4:
                k, m = q.shape[0], q.permute(3, 0, 1, 2).reshape(q.shape[3], -1)
            else:
                k, m = None, q.t()
            rest = {name: _run_tree(v, device) for name, v in qp.items()
                    if name not in ("q", "scale", "b")}
            vec = {name: torch.from_numpy(np.array(qp[name], np.float32)).to(device)
                   for name in ("scale", "b")}
            return {**rest, **vec, "m": m.contiguous().to(device), "k": k}
        return {k: _run_tree(v, device) for k, v in qp.items()}
    if isinstance(qp, (list, tuple)):
        return [_run_tree(v, device) for v in qp]
    return float(np.asarray(qp))


# ---------------------------------------------------------------------------
# int8 forward. Activations are NHWC int8 (B, H, W, C).


def conv_i8(xq: Tensor, w: Dict, stride: int = 1) -> Tensor:
    """int8 NHWC conv with ``w``'s kernel (padding (k - 1) / 2, as torch's
    convs) -> exact int32 (B, H', W', Cout), as im2col + ``int_matmul``."""
    k = w["k"]
    pad = (k - 1) // 2
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    B = xq.shape[0]
    if k == 1:
        cols = xq[:, ::stride, ::stride, :] if stride != 1 else xq
        Ho, Wo = cols.shape[1:3]
        cols = cols.reshape(B * Ho * Wo, -1)
    else:
        patches = xq.unfold(1, k, stride).unfold(2, k, stride)  # (B, Ho, Wo, C, k, k)
        Ho, Wo = patches.shape[1:3]
        cols = patches.permute(0, 1, 2, 4, 5, 3).reshape(B * Ho * Wo, -1)
    return int_matmul(cols, w["m"]).reshape(B, Ho, Wo, -1)


def _deq(acc: Tensor, s_x: float, w: Dict) -> Tensor:
    """int32 accumulator -> float32 with the bias applied."""
    return acc.float() * (w["scale"] * s_x) + w["b"]


def _maxpool_i8(xq: Tensor, k: int, stride: int, pad: int) -> Tensor:
    """Max-pool on int8 values, exactly, through float (the JAX package pads
    with -128; every window holds a real value, so padding never wins)."""
    y = F.max_pool2d(xq.permute(0, 3, 1, 2).float(), k, stride, pad)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _mm1x1(xq: Tensor, w: Dict, s_out: Optional[float], relu: bool) -> Tensor:
    B, H, W, _ = xq.shape
    out = int8_matmul_requant(xq.reshape(B * H * W, -1), w["m"], w["scale_x"], w["b"],
                              s_out=s_out, relu=relu)
    return out.reshape(B, H, W, -1)


def _mm1x1_res(xq: Tensor, w: Dict, idq: Tensor, s_id: float, s_out: Optional[float]) -> Tensor:
    B, H, W, _ = xq.shape
    out = int8_matmul_residual_requant(xq.reshape(B * H * W, -1), w["m"], w["scale_x"],
                                       w["b"], idq.reshape(B * H * W, -1), s_id, s_out=s_out)
    return out.reshape(B, H, W, -1)


@torch.no_grad()
def apply_resnet50_int8(run: Dict, images: Tensor, *, use_pallas_1x1: bool = False) -> Tensor:
    """(B, H, W, 3) normalized float32 / bfloat16 -> (B, 2048) float32.
    ``run``: :func:`int8_run_params` of the quantized tree."""
    s_stem = run["s_stem_in"]
    xq = requant(images.float(), s_stem)
    x = F.relu(_deq(conv_i8(xq, run["conv1"], 2), s_stem, run["conv1"]))
    # Requant to the stage-1 input scale before the max-pool: max commutes
    # with the monotone quantization.
    s_x = run["stages"][0][0]["s_in"]
    xq = _maxpool_i8(requant(x, s_x), 3, 2, 1)
    stages = run["stages"]
    for si, blocks in enumerate(stages):
        for bi, block in enumerate(blocks):
            stride = block_stride(si, bi)
            last = bi + 1 == len(blocks) and si + 1 == len(stages)
            if bi + 1 < len(blocks):
                s_next = blocks[bi + 1]["s_in"]
            elif not last:
                s_next = stages[si + 1][0]["s_in"]
            else:
                s_next = None  # the final block feeds the float pool directly
            if use_pallas_1x1:
                yq = _mm1x1(xq, block["conv1"], block["s_y1"], relu=True)
            else:
                y = _deq(conv_i8(xq, block["conv1"]), s_x, block["conv1"])
                yq = requant(F.relu(y), block["s_y1"])
            y = _deq(conv_i8(yq, block["conv2"], stride), block["s_y1"], block["conv2"])
            yq = requant(F.relu(y), block["s_y2"])
            if use_pallas_1x1 and "downsample" not in block:
                # conv3 + the int8 identity join + ReLU + requant in one pass.
                out = _mm1x1_res(yq, block["conv3"], xq, s_x, s_next)
                if last:
                    return out.mean(dim=(1, 2))
                s_x, xq = s_next, out
                continue
            if use_pallas_1x1:
                # Downsample block: conv3 in the kernel with float32 out; the
                # join is float32 because the downsampled identity is.
                y = _mm1x1(yq, block["conv3"], None, relu=False)
            else:
                y = _deq(conv_i8(yq, block["conv3"]), block["s_y2"], block["conv3"])
            if "downsample" in block:
                identity = _deq(conv_i8(xq, block["downsample"], stride), s_x,
                                block["downsample"])
            else:
                identity = xq.float() * s_x
            out = F.relu(y + identity)
            if last:
                return out.mean(dim=(1, 2))
            s_x, xq = s_next, requant(out, s_next)
    raise AssertionError("unreachable: empty stage list")


def feature_error(ref, test) -> Dict[str, float]:
    """Relative L2 and mean cosine similarity of pooled feature batches."""
    ref, test = (torch.as_tensor(np.array(a, np.float32)) for a in (ref, test))
    rel = torch.linalg.norm(test - ref) / torch.linalg.norm(ref).clamp_min(1e-8)
    cos = (ref * test).sum(-1) / (torch.linalg.norm(ref, dim=-1)
                                  * torch.linalg.norm(test, dim=-1)).clamp_min(1e-8)
    return {"rel_l2": float(rel), "mean_cosine": float(cos.mean())}
