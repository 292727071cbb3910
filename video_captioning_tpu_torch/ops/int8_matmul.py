"""int8 1x1 conv (matmul) with a fused requant epilogue.

Counterpart of video_captioning_tpu/ops/int8_matmul_pallas.py
(int8_matmul_requant, int8_matmul_residual_requant): int8 x int8 with int32
accumulation, then in the TPU kernel's order ``float(acc) * scale[c] +
bias[c]``, in the residual form ``+ float(id) * s_id``, ReLU, and
``round(y / s_out)`` half to even, clamped to +-127 (or float32 out when
``s_out`` is None). ``wq`` is in torch's (out, in) layout, (Cout, Cin).

Every float operation rounds once, on both sides (the kernel uses
``__fmul_rn`` / ``__fadd_rn`` / ``__fdiv_rn``, so nvcc contracts nothing into
an FMA), so the kernel in ``csrc/int8_matmul.cu`` equals the plain version
exactly. XLA fuses an FMA into the JAX epilogue, so against the JAX package
an entry can differ by one int8 step.

The kernel runs its products on the int8 tensor cores, which take K in
16-byte steps from 16-byte aligned rows; the wrapper zero-pads K where a
shape or pointer does not allow that (``pad_k16``), which is exact.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import check_launch, load_library, tracing

Tensor = torch.Tensor


def int_matmul(xq: Tensor, wq: Tensor) -> Tensor:
    """Exact int8 (M, K) x int8 (N, K)^T -> int32 (M, N) through
    ``torch._int_mm`` (cuBLASLt on the card), with K and N padded to
    multiples of 8 and, on the card, N to a multiple of 64 and M to at
    least 17, as cuBLASLt asks. The N rule rests on one case: an H100
    refused N = 1032 (1030 padded to 8) at M = 8191, K = 96."""
    M, K = xq.shape
    N = wq.shape[0]
    pad_k, pad_n = -K % 8, -N % (64 if xq.is_cuda else 8)
    if pad_k:
        xq = torch.nn.functional.pad(xq, (0, pad_k))
    if pad_k or pad_n:
        wq = torch.nn.functional.pad(wq, (0, pad_k, 0, pad_n))
    pad_m = max(0, 17 - M) if xq.is_cuda else 0
    if pad_m:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, pad_m))
    return torch._int_mm(xq, wq.t())[:M, :N]


def requant(y: Tensor, s_out: float) -> Tensor:
    """round(y / s_out) half to even, clamped to +-127, as int8. The divisor
    is a 0-d tensor on y's device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds differently."""
    s = torch.full((), s_out, dtype=torch.float32, device=y.device)
    return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)


def _epilogue(acc: Tensor, scale: Tensor, bias: Tensor, relu: bool,
              s_out: Optional[float]) -> Tensor:
    y = acc.float() * scale + bias
    if relu:
        y = torch.relu(y)
    return y if s_out is None else requant(y, s_out)


def int8_matmul_requant_reference(xq: Tensor, wq: Tensor, scale: Tensor, bias: Tensor,
                                  s_out: Optional[float] = None, relu: bool = True) -> Tensor:
    return _epilogue(int_matmul(xq, wq), scale, bias, relu, s_out)


def int8_matmul_residual_requant_reference(xq: Tensor, wq: Tensor, scale: Tensor, bias: Tensor,
                                           idq: Tensor, s_id: float,
                                           s_out: Optional[float] = None) -> Tensor:
    y = int_matmul(xq, wq).float() * scale + bias
    y = torch.relu(y + idq.float() * s_id)  # residual joins are always followed by ReLU
    return y if s_out is None else requant(y, s_out)


def _check(xq: Tensor, wq: Tensor, scale: Tensor, bias: Tensor, idq: Optional[Tensor]) -> None:
    if xq.dim() != 2 or xq.dtype != torch.int8:
        raise ValueError(f"int8 matmul takes xq (M, Cin) int8, got {xq.dtype} "
                         f"{tuple(xq.shape)}")
    M, K = xq.shape
    N = wq.shape[0]
    want = {"wq": ((N, K), torch.int8), "scale": ((N,), torch.float32),
            "bias": ((N,), torch.float32), "idq": ((M, N), torch.int8)}
    for name, t in (("wq", wq), ("scale", scale), ("bias", bias), ("idq", idq)):
        if t is None:
            continue
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != xq.device:
            raise ValueError(f"int8 matmul takes {name} {shape} {dtype} on {xq.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8 matmul takes a contiguous {name}")
    if not xq.is_contiguous():
        raise ValueError("int8 matmul takes a contiguous xq")


def pad_k16(xq: Tensor, wq: Tensor) -> tuple:
    """(xq, wq) as the kernel takes them: K a multiple of 16 and both start
    16-byte aligned. Otherwise both are copied into zero-filled (M, Kp) and
    (N, Kp) tensors, Kp = K rounded up to 16; the zero columns add nothing
    to any product."""
    K = xq.shape[1]
    if K % 16 == 0 and xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0:
        return xq, wq
    Kp = K + (-K % 16)
    padded = []
    for t in (xq, wq):
        p = t.new_zeros((t.shape[0], Kp))
        p[:, :K] = t
        padded.append(p)
    return tuple(padded)


def _kernel_lib(defines: tuple = ()) -> ctypes.CDLL:
    lib = load_library("int8_matmul", defines)
    fn = lib.vct_int8_matmul_requant
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _launch(xq, wq, scale, bias, idq, s_id, s_out, relu, tile: int = -1,
            defines: tuple = ()) -> Tensor:
    """One kernel launch. ``tile`` -1 lets the C launcher pick the tile
    shape, 0 or 1 forces 64 x 64 or 128 x 64, and ``defines`` picks a
    variant build, to time them against each other."""
    lib = _kernel_lib(defines)
    xq, wq = pad_k16(xq, wq)
    M, K = xq.shape
    N = wq.shape[0]
    out = torch.empty((M, N), dtype=torch.float32 if s_out is None else torch.int8,
                      device=xq.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = lib.vct_int8_matmul_requant(
            xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            idq.data_ptr() if idq is not None else None, float(s_id),
            1.0 if s_out is None else float(s_out), out.data_ptr(),
            M, K, N, int(relu), int(s_out is not None), tile, stream)
    check_launch(lib, rc, "int8 matmul")
    return out


def _device(t: Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, got {t.device}")
    return t.device.type


def int8_matmul_requant(xq: Tensor, wq: Tensor, scale: Tensor, bias: Tensor,
                        s_out: Optional[float] = None, relu: bool = True) -> Tensor:
    """relu?(xq @ wq^T * scale + bias), requantized to int8 at ``s_out`` (a
    float) or float32 when ``s_out`` is None. CUDA: the kernel, on the
    current stream, no sync. CPU: the plain version."""
    if tracing():
        return torch.ops.vct.int8_matmul_requant(xq, wq, scale, bias, s_out, relu)
    _check(xq, wq, scale, bias, None)
    if _device(xq, "int8_matmul_requant") == "cpu":
        return int8_matmul_requant_reference(xq, wq, scale, bias, s_out, relu)
    out = _launch(xq, wq, scale, bias, None, 0.0, s_out, relu)
    int8_matmul_requant.launches += 1
    return out


int8_matmul_requant.launches = 0


def int8_matmul_residual_requant(xq: Tensor, wq: Tensor, scale: Tensor, bias: Tensor,
                                 idq: Tensor, s_id: float,
                                 s_out: Optional[float] = None) -> Tensor:
    """relu(xq @ wq^T * scale + bias + idq * s_id), requantized to int8 (or
    float32 for the block that feeds the float pool). CUDA: the kernel; CPU:
    the plain version."""
    if tracing():
        return torch.ops.vct.int8_matmul_residual_requant(xq, wq, scale, bias, idq, s_id, s_out)
    _check(xq, wq, scale, bias, idq)
    if _device(xq, "int8_matmul_residual_requant") == "cpu":
        return int8_matmul_residual_requant_reference(xq, wq, scale, bias, idq, s_id, s_out)
    out = _launch(xq, wq, scale, bias, idq, s_id, s_out, True)
    int8_matmul_residual_requant.launches += 1
    return out


int8_matmul_residual_requant.launches = 0
