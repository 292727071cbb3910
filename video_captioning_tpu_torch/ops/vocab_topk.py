"""Fused vocabulary projection + exact top-k + logsumexp: the beam step's
expansion under ``kernels.use_fused_vocab_topk``.

Counterpart of video_captioning_tpu/ops/vocab_topk_pallas.py
(pad_vocab_weights, vocab_topk_lse), with its layouts: the kernel (H, V),
the bias (V,). ``pad_vocab_weights`` runs once per generation call; on a
CUDA tensor ``vocab_topk_lse`` launches the kernels in
``csrc/vocab_topk.cu``, on a CPU tensor it runs
``vocab_topk_lse_reference``, the plain version of the same contract:
x rounded to bf16, exact bf16 products summed in float32, plus the
float32 bias; top-k values and indices in ``lax.top_k``'s order, exact
given the logits; the lse to float32 rounding. (The kernel's tensor cores
round their float32 sums their own way: its logits match the plain
version's to about 1e-6 of their scale.)
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import check_launch, load_library
from .topk import MAX_K, topk_stable

Tensor = torch.Tensor

PAD_FILL = torch.finfo(torch.float32).min


def pad_vocab_weights(kernel: Tensor, bias: Tensor, vt: int = 128) -> Tuple[Tensor, Tensor, int]:
    """Pad (H, V) weights and the (V,) bias to a multiple of ``vt`` columns
    and cast the weights to bf16. The pad bias is float32-min, so padded
    tokens are never selected and add exp() = 0 to the logsumexp. Call it
    outside the decode loop. ``vt`` must be a multiple of 8 (the kernel
    reads the weights 8 columns at a time)."""
    if vt % 8:
        raise ValueError(f"pad_vocab_weights needs vt a multiple of 8, got {vt}")
    H, V = kernel.shape
    v_padded = -(-V // vt) * vt
    w = torch.zeros((H, v_padded), dtype=torch.bfloat16, device=kernel.device)
    w[:, :V] = kernel.detach()
    b = torch.full((v_padded,), PAD_FILL, dtype=torch.float32, device=bias.device)
    b[:V] = bias.detach()
    return w, b, v_padded


def vocab_topk_lse_reference(x: Tensor, w_padded: Tensor, b_padded: Tensor,
                             k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version: ((N, k) f32 values, (N, k) int32 indices, (N,) f32
    lse) of ``bf16(x) @ W + b``."""
    logits = x.to(torch.bfloat16).float() @ w_padded.float() + b_padded
    vals, idx = topk_stable(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=-1)


def _check(x: Tensor, w_padded: Tensor, b_padded: Tensor, k: int) -> None:
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"vocab_topk_lse takes a contiguous (N, H) float32 x, got "
                         f"{x.dtype} {tuple(x.shape)}")
    N, H = x.shape
    if (w_padded.dtype != torch.bfloat16 or w_padded.ndim != 2 or w_padded.shape[0] != H
            or w_padded.shape[1] % 8 or not w_padded.is_contiguous()):
        raise ValueError(f"vocab_topk_lse takes a contiguous ({H}, Vp) bfloat16 weight with "
                         f"Vp % 8 == 0 (pad_vocab_weights), got {w_padded.dtype} "
                         f"{tuple(w_padded.shape)}")
    Vp = w_padded.shape[1]
    if b_padded.dtype != torch.float32 or tuple(b_padded.shape) != (Vp,):
        raise ValueError(f"vocab_topk_lse takes a ({Vp},) float32 bias, got {b_padded.dtype} "
                         f"{tuple(b_padded.shape)}")
    for name, t in (("w_padded", w_padded), ("b_padded", b_padded)):
        if t.device != x.device:
            raise ValueError(f"vocab_topk_lse: {name} is on {t.device}, x on {x.device}")
    if not 1 <= k <= min(MAX_K, Vp):
        raise ValueError(f"vocab_topk_lse needs 1 <= k <= min(16, Vp), got k={k}, Vp={Vp}")


def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("vocab_topk")
    fn = lib.vct_vocab_topk_lse
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vct_vocab_topk_tile_cols.argtypes = []
    lib.vct_vocab_topk_tile_cols.restype = ctypes.c_int
    return lib


def vocab_topk_lse(x: Tensor, w_padded: Tensor, b_padded: Tensor,
                   k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(top-k values, top-k indices int32, logsumexp) of ``bf16(x) @ W + b``
    rows. CUDA: the kernels, on the current stream, no sync. CPU: the plain
    version."""
    _check(x, w_padded, b_padded, k)
    if x.device.type == "cpu":
        return vocab_topk_lse_reference(x, w_padded, b_padded, k)
    if x.device.type != "cuda":
        raise ValueError(f"vocab_topk_lse runs on cpu or cuda, got {x.device}")
    lib = _kernel_lib()
    N, H = x.shape
    Vp = w_padded.shape[1]
    dev = x.device
    vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    idx = torch.empty((N, k), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return vals, idx, lse
    n_tiles = -(-Vp // lib.vct_vocab_topk_tile_cols())
    part_v = torch.empty((N, n_tiles, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((N, n_tiles, k), dtype=torch.int32, device=dev)
    part_ms = torch.empty((2, N, n_tiles), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vct_vocab_topk_lse(
            x.data_ptr(), w_padded.data_ptr(), b_padded.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), part_ms[0].data_ptr(), part_ms[1].data_ptr(),
            vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), N, H, Vp, k, stream,
        )
    check_launch(lib, rc, "vocab_topk_lse")
    vocab_topk_lse.launches += 1
    return vals, idx, lse


vocab_topk_lse.launches = 0
