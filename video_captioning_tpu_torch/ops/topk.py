"""Row top-k plus logsumexp in one pass: the beam step's expansion.

Counterpart of video_captioning_tpu/ops/topk_pallas.py (topk2d_lse). On a
CUDA tensor ``topk2d_lse`` launches the hand-written kernel in
``csrc/topk_lse.cu``; on a CPU tensor it runs ``topk2d_lse_reference``, the
plain PyTorch version of the same contract. Nothing falls back: a CUDA
tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import check_launch, load_library

Tensor = torch.Tensor

MAX_K = 16


def topk_stable(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Top-k over the last axis in ``lax.top_k``'s order: larger values
    first, equal values in ascending index order (a stable descending
    sort; ``torch.topk`` does not promise that tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk2d_lse_reference(x: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version: (values (N, k), indices (N, k) int32, lse (N,)).
    lse = m + log(sum(exp(x - m))) with m the row max; a row that is all
    -inf gives -inf."""
    vals, idx = topk_stable(x, k)
    m = vals[:, 0]
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = shift + torch.log(torch.sum(torch.exp(x - shift[:, None]), dim=-1))
    return vals, idx.to(torch.int32), lse


def _check(x: Tensor, k: int) -> None:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"topk2d_lse takes a 2-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("topk2d_lse takes a contiguous tensor")
    if not 1 <= k <= min(MAX_K, x.shape[1]):
        raise ValueError(f"topk2d_lse needs 1 <= k <= min(16, V), got k={k}, V={x.shape[1]}")


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("topk_lse")
    fn = lib.vct_topk2d_lse_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def topk2d_lse(x: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(values, indices int32, logsumexp) over the last axis of a (N, V)
    float32 tensor. CUDA: the kernel, on the current stream, no sync. CPU:
    the plain version."""
    _check(x, k)
    if x.device.type == "cpu":
        return topk2d_lse_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk2d_lse runs on cpu or cuda, got {x.device}")
    lib = _kernel_lib()
    N, V = x.shape
    vals = torch.empty((N, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((N, k), dtype=torch.int32, device=x.device)
    lse = torch.empty((N,), dtype=torch.float32, device=x.device)
    if N == 0:
        return vals, idx, lse
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vct_topk2d_lse_f32(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
            N, V, k, stream,
        )
    check_launch(lib, rc, "topk2d_lse")
    topk2d_lse.launches += 1
    return vals, idx, lse


topk2d_lse.launches = 0
