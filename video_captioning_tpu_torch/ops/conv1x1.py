"""A 1x1 conv as a matmul with a fused bias / residual / ReLU epilogue.

Counterpart of video_captioning_tpu/ops/conv1x1_pallas.py
(matmul_bias_act and conv1x1): ``relu?(x @ w^T + b [+ r])`` with float32
accumulation and the output in x's dtype (float32 or bfloat16); ``w`` is in
torch's (out, in) layout, (N, K). On a CUDA tensor the kernel in
``csrc/conv1x1.cu`` runs; on a CPU tensor the plain version. Neither package
calls it on a model path (every JAX call site passes ``use_pallas=False``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .build import check_launch, load_library, tracing

Tensor = torch.Tensor

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def matmul_bias_act_reference(x: Tensor, w: Tensor, b: Tensor, residual: Optional[Tensor] = None,
                              *, relu: bool = True) -> Tensor:
    """The plain version: float32 products and sums, then the epilogue in
    float32, rounded once to x's dtype."""
    acc = F.linear(x.float(), w.float(), b.float())
    if residual is not None:
        acc = acc + residual.float()
    return (F.relu(acc) if relu else acc).to(x.dtype)


def _check(x: Tensor, w: Tensor, b: Tensor, residual: Optional[Tensor]) -> None:
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"matmul_bias_act takes x (M, K) float32 or bfloat16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    N = w.shape[0]
    want = {"w": (N, K), "b": (N,), "residual": (M, N)}
    for name, t in (("w", w), ("b", b), ("residual", residual)):
        if t is None:
            continue
        if tuple(t.shape) != want[name] or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"matmul_bias_act takes {name} {want[name]} {x.dtype} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("x", x), ("w", w), ("b", b), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"matmul_bias_act takes a contiguous {name}")


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("conv1x1")
    for dt in _DTYPES.values():
        fn = getattr(lib, f"vct_matmul_bias_act_{dt}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def matmul_bias_act(x: Tensor, w: Tensor, b: Tensor, residual: Optional[Tensor] = None, *,
                    relu: bool = True) -> Tensor:
    """``relu?(x @ w^T + b [+ residual])``, x (M, K), w (N, K), b (N,),
    residual (M, N). CUDA: the kernel, any M, K and N, on the current
    stream, no sync. CPU: the plain version."""
    if tracing():
        return torch.ops.vct.matmul_bias_act(x, w, b, residual, relu)
    _check(x, w, b, residual)
    if x.device.type == "cpu":
        return matmul_bias_act_reference(x, w, b, residual, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_bias_act runs on cpu or cuda, got {x.device}")
    lib = _kernel_lib()
    M, K = x.shape
    N = w.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"vct_matmul_bias_act_{_DTYPES[x.dtype]}")(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            residual.data_ptr() if residual is not None else None, out.data_ptr(),
            M, K, N, int(relu), stream)
    check_launch(lib, rc, "matmul_bias_act")
    matmul_bias_act.launches += 1
    return out


matmul_bias_act.launches = 0


def conv1x1(x: Tensor, w: Tensor, b: Tensor, residual: Optional[Tensor] = None, *,
            stride: int = 1, relu: bool = True) -> Tensor:
    """1x1 conv over NHWC ``x`` (B, H, W, Cin) with ``w`` (Cout, Cin) and the
    fused epilogue; ``residual`` is (B, H', W', Cout) at the strided output.
    A stride-2 1x1 conv with zero padding reads every other pixel, so it is
    a slice and a matmul. Unlike the TPU version it takes every shape (the
    kernel masks ragged tiles), so it never returns None."""
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    B, H, W, Cin = x.shape
    Cout = w.shape[0]
    r2 = residual.reshape(B * H * W, Cout) if residual is not None else None
    out = matmul_bias_act(x.reshape(B * H * W, Cin), w, b, r2, relu=relu)
    return out.reshape(B, H, W, Cout)
