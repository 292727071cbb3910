"""One stride-1 identity-residual ResNet bottleneck block, fully fused.

Counterpart of video_captioning_tpu/ops/bottleneck_pallas.py
(fused_bottleneck):

    out = relu(relu(conv3x3(relu(x @ W1^T + b1)) + b2) @ W3^T + b3 + x)

with BN folded into the weights (models/backbones/resnet.py:fold_bn). x is
NHWC (B, H, W, C), float32 or bfloat16; the weights are in torch's (out,
in) layout: ``w1`` (Cm, C), ``w2`` (Cm, Cm, 3, 3) in channels_last memory,
``w3`` (C, Cm); biases (Cm,) / (C,); all of x's dtype. Products accumulate
in float32, and in bfloat16 y1 and y2 are rounded to bfloat16 before the
next product, as the TPU kernel does.

On a CUDA tensor ``fused_bottleneck`` launches the kernel in
``csrc/fused_bottleneck.cu``; on a CPU tensor it runs
``fused_bottleneck_reference``, the plain version (float32 products). The
kernel takes float32 products on the tensor cores by a 3xTF32 split
(``csrc/tf32x3.cuh``, each product within about 2^-21 of the float32 one,
float32 sums) and bfloat16 products on them directly. It splits the Cm
channels over a thread block cluster of ceil(Cm / 64) CTAs, so on the card
Cm is at most 512 (ResNet50's largest); work items are whole images or
pixel tiles, so every B, H, W and C is taken: the TPU kernel's
``batch_tile`` VMEM rule has no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import check_launch, load_library, tracing

Tensor = torch.Tensor

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def fused_bottleneck_reference(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                               w3: Tensor, b3: Tensor) -> Tensor:
    """The plain version: float32 products and sums of the operands' values,
    y1 and y2 rounded to x's dtype, output in x's dtype."""
    dt = x.dtype
    xf = x.float()
    y1 = F.relu(F.linear(xf, w1.float(), b1.float())).to(dt)          # (B, H, W, Cm)
    y2 = F.conv2d(y1.float().permute(0, 3, 1, 2), w2.float(), b2.float(), padding=1)
    y2 = F.relu(y2).to(dt).permute(0, 2, 3, 1)                        # (B, H, W, Cm)
    out = F.linear(y2.float(), w3.float(), b3.float()) + xf
    return F.relu(out).to(dt)


def _check(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, w3: Tensor,
           b3: Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"fused_bottleneck takes x (B, H, W, C) float32 or bfloat16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    C, Cm = x.shape[3], w1.shape[0]
    want = {"w1": (Cm, C), "b1": (Cm,), "w2": (Cm, Cm, 3, 3), "b2": (Cm,), "w3": (C, Cm),
            "b3": (C,)}
    tensors = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, t in tensors.items():
        if tuple(t.shape) != want[name] or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_bottleneck takes {name} {want[name]} {x.dtype} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    fmt = {"w2": torch.channels_last}
    for name, t in (("x", x),) + tuple(tensors.items()):
        if not t.is_contiguous(memory_format=fmt.get(name, torch.contiguous_format)):
            raise ValueError(f"fused_bottleneck takes a contiguous {name}"
                             + (" in channels_last memory" if name in fmt else ""))


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("fused_bottleneck")
    for dt in _DTYPES.values():
        fn = getattr(lib, f"vct_fused_bottleneck_{dt}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"vct_fused_bottleneck_plan_{dt}")
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


MAX_CM = 512  # 64 channels a CTA, at most 8 CTAs a cluster


def kernel_plan(x: Tensor, Cm: int) -> dict:
    """The work item the launcher picks for x (B, H, W, C) on the card:
    cluster size, images a cluster, tile rows and columns, shared memory
    bytes a CTA."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 5)()
    rc = getattr(lib, f"vct_fused_bottleneck_plan_{_DTYPES[x.dtype]}")(*x.shape, Cm, out)
    check_launch(lib, rc, "fused_bottleneck plan")
    return dict(zip(("cluster", "images", "tile_h", "tile_w", "smem_bytes"), out))


def fused_bottleneck(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, w3: Tensor,
                     b3: Tensor) -> Tensor:
    """One identity bottleneck block. CUDA: the kernel, on the current
    stream, no sync. CPU: the plain version."""
    if tracing():
        return torch.ops.vct.fused_bottleneck(x, w1, b1, w2, b2, w3, b3)
    _check(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cpu or cuda, got {x.device}")
    if w1.shape[0] > MAX_CM:
        raise ValueError(f"fused_bottleneck on the card takes Cm <= {MAX_CM}, got {w1.shape[0]}")
    lib = _kernel_lib()
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"vct_fused_bottleneck_{_DTYPES[x.dtype]}")(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), out.data_ptr(), B, H, W, C, w1.shape[0], stream)
    check_launch(lib, rc, "fused_bottleneck")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
